"""``lower_self_ms.session``: mean milliseconds a query of the window spent
lowering plans to fragments, less the dictionary maps and plan-time
subqueries inside them: the self time of the program's ``fragment.lower``
spans (``lower_ns``), re-lowerings on retry included."""

from qbench.metrics.dispatch_ms import per_query


def read(run):
    return per_query(run, "lower_ns")
