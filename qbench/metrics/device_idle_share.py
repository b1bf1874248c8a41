"""``device_idle_share``: 1 - (union of the device's activity intervals /
the traced window's wall), from the profiler's trace of the traced
passes.  None without a device trace."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
