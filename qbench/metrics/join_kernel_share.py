"""``join_kernel_share``: the share of the window's dense join probes
(``_Interp.r_join``, strategy "dense") that went through the program's
``join_probe`` CUDA kernel: the window's delta of the program's
``join_probe_kernel`` counter over that of ``join_probes``.  None, as
every reader of a program counter, without a device trace (a run where
the traced passes saw no device); and None when the program has either
counter not, or ran no dense probe."""


def read(run):
    kernel = run.counters.get("fragment.join_probe_kernel")
    probes = run.counters.get("fragment.join_probes")
    if run.trace is None or kernel is None or not probes:
        return None
    return kernel / probes
