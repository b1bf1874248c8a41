"""``subquery_ms.session``: mean milliseconds a query of the window spent
running scalar subqueries at plan time, lowering, run and read included:
the program's ``lower.subquery`` spans and everything inside them
(``subquery_ns``)."""

from qbench.metrics.dispatch_ms import per_query


def read(run):
    return per_query(run, "subquery_ns")
