"""``join_kernel_share.session``: ``join_kernel_share`` in the cells that
report the ``.session`` end-to-end metrics (``Session.sql``)."""

from qbench.metrics.join_kernel_share import read  # noqa: F401
