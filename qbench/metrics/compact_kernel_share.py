"""``compact_kernel_share``: the share of the window's compaction barriers
(``_Interp.r_compact`` and the compaction of a masked result) that went
through the program's ``compact_rows`` CUDA kernel: the window's delta of
the program's ``compact_kernel`` counter over that of ``compactions``.
None, as every reader of a program counter, without a device trace (a run
where the traced passes saw no device); and None when the program has
either counter not, or ran no compaction."""


def read(run):
    kernel = run.counters.get("fragment.compact_kernel")
    compactions = run.counters.get("fragment.compactions")
    if run.trace is None or kernel is None or not compactions:
        return None
    return kernel / compactions
