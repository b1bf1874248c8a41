"""``launches_per_query``: CUDA kernels in the traced passes over the
queries those passes completed.  None without a device trace."""


def read(run):
    traced = sum(a.ok for a in run.answers if a.traced)
    if run.trace is None or not run.trace.kernels or not traced:
        return None
    return run.trace.kernels / traced
