"""``dispatch_ms``: mean milliseconds a query of the window spent in the
program's enqueue of device work: the self time of its ``fragment.run``
spans (the attempt loop's host work) and of its ``run.dispatch`` spans
(the interpreter's launches), the window's delta of the program's
``dispatch_ns`` counter over the window's queries.

Also ``per_query``, the reading that every metric of a program counter
shares: None without the counter (a program that does not count it) and
without a device trace (a run where the traced passes saw no device)."""


def per_query(run, *keys, scale=1e-6):
    """The sum of the window's deltas of ``exec.fragment.STATS[key]`` for
    ``keys``, times ``scale``, over the window's queries; or None."""
    vals = [run.counters.get(f"fragment.{k}") for k in keys]
    if run.trace is None or not run.answers or None in vals:
        return None
    return sum(vals) * scale / len(run.answers)


def read(run):
    return per_query(run, "dispatch_ns")
