"""``host_reads_per_query.session``: ``host_reads_per_query`` in the cells that report
the ``.session`` end-to-end metrics (host-bound cells through
``Session.sql``)."""

from qbench.metrics.host_reads_per_query import read  # noqa: F401
