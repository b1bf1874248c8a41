"""``decode_ms``: mean milliseconds, by the benchmark's host clock, of
forcing a result's rows into Python tuples (both entries return them
lazily), over the window's queries."""

from qbench import stats


def read(run):
    return stats.mean([a.decode_s * 1e3 for a in run.answers
                       if a.error is None])
