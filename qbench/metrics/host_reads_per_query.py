"""``host_reads_per_query``: device-to-host reads of the program's fragment
path a query of the window (``host_reads``: each scalar fetch of an
attempt, each result array, each subquery value the executor read)."""

from qbench.metrics.dispatch_ms import per_query


def read(run):
    return per_query(run, "host_reads", scale=1)
