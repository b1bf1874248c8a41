"""``dict_device_share.session``: the share of the string-dictionary values
that the window's lowerings mapped on the device (LIKE masks and substring
remaps by the program's CUDA kernels, ops/dictmap.py): the window's delta
of the program's ``dict_device_values`` counter over that of
``dict_values`` (both count no value inside a plan-time subquery).  None,
as every reader of a program counter, without a device trace (a run where
the traced passes saw no device); and None when the program has either
counter not, or mapped no value."""


def read(run):
    device = run.counters.get("fragment.dict_device_values")
    mapped = run.counters.get("fragment.dict_values")
    if run.trace is None or device is None or not mapped:
        return None
    return device / mapped
