"""``scan_roofline.session``: ``scan_roofline`` in the cells that report
the ``.session`` end-to-end metrics (host-bound cells through
``Session.sql``)."""

from qbench.metrics.scan_roofline import read  # noqa: F401
