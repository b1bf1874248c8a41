"""``decode_span_ms.session``: ``decode_span_ms`` in the cells that report
the ``.session`` end-to-end metrics (host-bound cells through
``Session.sql``)."""

from qbench.metrics.decode_span_ms import read  # noqa: F401
