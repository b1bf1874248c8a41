"""``decode_span_ms``: mean milliseconds a query of the window spent in the
program's ``result.decode`` spans (rows into Python tuples, ``decode_ns``):
the program's own reading of what ``decode_ms`` times from outside."""

from qbench.metrics.dispatch_ms import per_query


def read(run):
    return per_query(run, "decode_ns")
