"""``front_ms.session``: mean milliseconds a query of the window spent in
the Session's front end: the self time of the program's ``sql`` root span
(the statement queue, dispatch to the engine, the result's assembly), of
``sql.parse`` and of ``sql.bind`` (catalog snapshot, plan cache, binder):
``sql_ns + parse_ns + bind_ns``."""

from qbench.metrics.dispatch_ms import per_query


def read(run):
    return per_query(run, "sql_ns", "parse_ns", "bind_ns")
