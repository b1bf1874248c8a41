"""``launches_per_query.session``: ``launches_per_query`` in the cells that report
the ``.session`` end-to-end metrics (host-bound cells through
``Session.sql``)."""

from qbench.metrics.launches_per_query import read  # noqa: F401
