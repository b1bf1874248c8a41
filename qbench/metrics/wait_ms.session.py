"""``wait_ms.session``: ``wait_ms`` in the cells that report
the ``.session`` end-to-end metrics (host-bound cells through
``Session.sql``)."""

from qbench.metrics.wait_ms import read  # noqa: F401
