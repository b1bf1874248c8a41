"""``device_idle_share.session``: ``device_idle_share`` in the cells that report
the ``.session`` end-to-end metrics (host-bound cells through
``Session.sql``)."""

from qbench.metrics.device_idle_share import read  # noqa: F401
