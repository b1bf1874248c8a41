"""``wait_ms``: mean milliseconds a query of the window spent blocked on
the device: the program's ``run.wait`` spans around the one read of an
attempt's error code, count and totals (``wait_ns``)."""

from qbench.metrics.dispatch_ms import per_query


def read(run):
    return per_query(run, "wait_ns")
