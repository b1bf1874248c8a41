"""``dispatch_ms.session``: ``dispatch_ms`` in the cells that report
the ``.session`` end-to-end metrics (host-bound cells through
``Session.sql``)."""

from qbench.metrics.dispatch_ms import read  # noqa: F401
