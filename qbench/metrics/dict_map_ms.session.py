"""``dict_map_ms.session``: mean milliseconds a query of the window spent
mapping string dictionaries on the host while lowering (LIKE masks,
string functions, casts and code remaps, each with its lut's upload): the
program's ``lower.dict`` spans (``dict_ns``)."""

from qbench.metrics.dispatch_ms import per_query


def read(run):
    return per_query(run, "dict_ns")
