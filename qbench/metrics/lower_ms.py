"""``lower_ms``: mean milliseconds a query of the window spent building its
fragment (``CompiledFragment.lower_ms``, the program's own host clock
around ``Lowering``), over the queries that lowered one.  None where the
window lowered nothing (a plan cache served every query)."""

from qbench import stats


def read(run):
    return stats.mean([a.lower_ms for a in run.answers
                       if a.lower_ms is not None])
