"""``compact_kernel_share.session``: ``compact_kernel_share`` in the cells
that report the ``.session`` end-to-end metrics (``Session.sql``)."""

from qbench.metrics.compact_kernel_share import read  # noqa: F401
