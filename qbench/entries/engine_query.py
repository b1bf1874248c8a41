"""Entry ``engine_query``: ``Engine(catalog).query(text)``, the embedded
entry with its plan cache.

The catalog is built from the port's public column constructors:
``Column.from_numpy`` for the host arrays of the dimensions (strings
dictionary-encoded with ``StrDict.encode``) and ``Column.from_device`` for
the device columns of the fact table, padded to the port's capacity with
the type's nil, with the property flags the port's own loader derives
(min, max, sorted, reverse-sorted, key, no nil), worked out here with
torch where the column lies.  A string column that comes as codes
(``gen.ssb.Coded``) keeps them and its sorted dictionary.
"""

from __future__ import annotations

import numpy as np

__all__ = ["open_entry", "halve", "props"]


def props(vals) -> dict:
    """The flags of ``monetdb_tpu_torch/bench/tpch_load._encode_column``
    for the physical values ``vals`` (a tensor of integers or string codes,
    on any device)."""
    import torch
    n = vals.shape[0]
    out = {"sorted": False, "revsorted": False, "key": False,
           "minval": None, "maxval": None}
    if n:
        mn, mx = int(vals.min()), int(vals.max())
        out["minval"], out["maxval"] = mn, mx
        d = torch.diff(vals)
        out["sorted"] = bool((d >= 0).all())
        out["revsorted"] = bool((d <= 0).all())
        if out["sorted"] and bool((d > 0).all()):
            out["key"] = True
        elif mx - mn + 1 == n:
            counts = torch.bincount((vals - mn).to(torch.int64), minlength=n)
            out["key"] = bool((counts <= 1).all())
    return out


def _column(arr, tag: str, device):
    import torch
    from monetdb_tpu_torch.column import Column, StrDict, capacity_for
    from .session_sql import sql_type
    typ = sql_type(tag)
    sdict = None
    if hasattr(arr, "codes"):                      # gen.ssb.Coded
        values = np.asarray(arr.values)
        if len(values) > 1 and not (values[:-1] < values[1:]).all():
            raise ValueError("a dictionary must be sorted and unique")
        sdict, arr = StrDict(values), arr.codes
    elif tag == "str":
        sdict, arr = StrDict.encode(np.asarray(arr).astype(str))
    if isinstance(arr, np.ndarray):
        vals = arr.astype(typ.np_dtype, copy=False)
        nonil = not bool((vals == typ.nil).any())
        return Column.from_numpy(vals, typ, sdict=sdict, device=device,
                                 nonil=nonil,
                                 **props(torch.from_numpy(vals)))
    vals = arr.to(device=device, dtype=getattr(torch, str(typ.np_dtype)))
    n = vals.shape[0]
    nonil = not bool((vals == int(typ.nil)).any())
    flags = props(vals)
    data = torch.full((capacity_for(n),), int(typ.nil), dtype=vals.dtype,
                      device=device)
    data[:n] = vals
    return Column.from_device(data, typ, n, sdict=sdict, nonil=nonil,
                              **flags)


class EngineEntry:
    def __init__(self, cfg: dict, data: dict, device):
        from monetdb_tpu_torch.engine import Engine
        from monetdb_tpu_torch.table import Catalog, Table
        cat = Catalog()
        for tname, cols in data.items():
            schema = cfg["schema"][tname]
            built = {}
            for c in list(cols):
                # hand each generated column over, so that only the
                # program's padded copy stays on the device
                built[c] = _column(cols.pop(c), schema[c][0], device)
            cat.add(Table.from_dict(tname, built))
        self.engine = Engine(cat)

    def query(self, text: str):
        return self.engine.query(text)

    def close(self) -> None:
        from monetdb_tpu_torch.engine import plan_cache_clear
        plan_cache_clear()
        self.engine = None


def open_entry(cfg: dict, data: dict, device) -> EngineEntry:
    return EngineEntry(cfg, data, device)


def halve(entry: EngineEntry) -> EngineEntry:
    """The tests' fault of half the batch left out: the largest table's
    column counts halved, so that every scan sees its first half."""
    t = max(entry.engine.catalog.tables.values(), key=lambda t: t.count)
    for c in t.columns.values():
        c.count //= 2
    return entry
