"""Load generated TPC-H numpy tables into Columns/Tables on a device.

The port of the reference package's bench/tpch_load.py.  On load we compute
the COLrec-style properties (sorted/key/nonil, min/max) that drive kernel
strategy picks — the reference maintains these incrementally in BATappend
(gdk/gdk_batop.c:674); we derive them once per bulk load.  The only change
is the device: every column is uploaded to the device the caller names.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict

import numpy as np
import torch

from ..column import Column, StrDict
from ..dtypes import DATE, I32, I64, decimal, is_nil_np, varchar
from ..table import Catalog, Table
from .tpch_gen import SCHEMA, gen_tpch

__all__ = ["load_tpch", "load_tables", "load_tpch_db", "make_column"]

_TYPES = {
    "i32": I32,
    "i64": I64,
    "dec2": decimal(15, 2),
    "date": DATE,
    "str": varchar(),
}


def _encode_column(arr: np.ndarray, tag: str) -> dict:
    """Host-side column payload: physical values (dict codes for str) +
    derived COLrec-style property flags.  Pure function of the input -
    disk-cacheable."""
    typ = _TYPES[tag]
    if tag == "str":
        sd, vals = StrDict.encode(np.asarray(arr, dtype=object).astype(str))
        payload = {"data": vals, "dictv": sd.values}
    else:
        vals = arr.astype(typ.np_dtype, copy=False)
        payload = {"data": vals, "dictv": None}
    n = len(vals)
    if tag == "str":
        nonil = not bool((vals < 0).any())
    else:
        nonil = not bool(is_nil_np(vals, typ).any())
    props = {"sorted": False, "revsorted": False, "key": False,
             "minval": None, "maxval": None, "nonil": nonil}
    if n and typ.np_dtype.kind in "iu":
        mn, mx = int(vals.min()), int(vals.max())
        props["minval"], props["maxval"] = mn, mx
        d = np.diff(vals)
        props["sorted"] = bool((d >= 0).all())
        props["revsorted"] = bool((d <= 0).all())
        if props["sorted"] and (d > 0).all():
            props["key"] = True
        elif mx - mn + 1 == n:
            # dense permutation ⇒ unique (cheap test covers PK columns)
            props["key"] = (bool(len(np.unique(vals)) == n)
                            if n < (1 << 22) else
                            bool((np.bincount(vals - mn,
                                              minlength=n) <= 1).all()))
    payload["props"] = props
    return payload


def _column_of(payload: dict, tag: str, device) -> Column:
    """Payload -> Column on ``device`` (pad + upload only)."""
    typ = _TYPES[tag]
    sd = StrDict(payload["dictv"]) if payload["dictv"] is not None else None
    return Column.from_numpy(payload["data"], typ, sdict=sd, device=device,
                             **payload["props"])


def make_column(arr: np.ndarray, tag: str, device) -> Column:
    return _column_of(_encode_column(arr, tag), tag, device)


def load_tables(data: Dict[str, Dict[str, np.ndarray]],
                device="cuda") -> Catalog:
    """Generated tables as a catalog with every column on ``device`` (the
    card unless the caller names another device)."""
    cat = Catalog()
    for tname, cols in data.items():
        schema = SCHEMA[tname]
        table = Table.from_dict(
            tname, {c: make_column(v, schema[c], device)
                    for c, v in cols.items()})
        cat.add(table)
    return cat


_cache: Dict[tuple, Catalog] = {}

#: encoded-payload disk cache version (bump when _encode_column changes)
_ENC_VER = 1


def _enc_path(sf: float) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"mtpu_torch_tpch_enc_sf{sf}_v{_ENC_VER}.npz")


def _encode_all(sf: float) -> Dict[str, Dict[str, dict]]:
    data = gen_tpch(sf)
    return {t: {c: _encode_column(v, SCHEMA[t][c])
                for c, v in cols.items()}
            for t, cols in data.items()}


def _payloads_save(path: str, enc) -> None:
    flat = {}
    meta = {}
    for t, cols in enc.items():
        for c, p in cols.items():
            flat[f"{t}::{c}::data"] = p["data"]
            if p["dictv"] is not None:
                flat[f"{t}::{c}::dict"] = p["dictv"]
            meta[f"{t}::{c}"] = p["props"]
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _payloads_load(path: str):
    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["__meta__"]).decode())
    enc: Dict[str, Dict[str, dict]] = {}
    for key, props in meta.items():
        t, c = key.split("::", 1)
        enc.setdefault(t, {})[c] = {
            "data": z[f"{t}::{c}::data"],
            "dictv": (z[f"{t}::{c}::dict"]
                      if f"{t}::{c}::dict" in z.files else None),
            "props": props,
        }
    return enc


def load_tpch(sf: float = 0.01, cache: bool = True, *,
              device="cuda") -> Catalog:
    """TPC-H catalog at scale factor sf with every column on ``device``:
    the card unless the caller names another device (without a card the
    default raises torch's own error; nothing falls back to the CPU).
    Large scale factors cache the *encoded* form (dict codes +
    dictionaries + property flags) on disk: re-loading costs one npz read
    + device upload instead of regeneration + string-dictionary build."""
    key = (sf, str(torch.device(device)))
    if cache and key in _cache:
        return _cache[key]
    enc = None
    use_disk = cache and sf >= 0.5
    if use_disk and os.path.exists(_enc_path(sf)):
        try:
            enc = _payloads_load(_enc_path(sf))
        except (OSError, ValueError, KeyError):
            enc = None       # a torn or stale cache file: re-encode
    if enc is None:
        enc = _encode_all(sf)
        if use_disk:
            try:
                _payloads_save(_enc_path(sf), enc)
            except OSError:
                pass         # the disk cache is an optimization
    cat = Catalog()
    for tname, cols in enc.items():
        cat.add(Table.from_dict(
            tname, {c: _column_of(p, SCHEMA[tname][c], device)
                    for c, p in cols.items()}))
    if cache:
        _cache[key] = cat
    return cat


def load_tpch_db(sf: float = 0.01, data=None, *, device="cuda"):
    """TPC-H loaded into an in-memory ``Database`` on ``device`` — the SQL
    *product* path (``Session``, embedded, DB-API).  Bulk-appends physical
    arrays directly (COPY INTO's ``TableData.append`` path, the role of
    modules/mal/tablet.c); ``data`` is ``gen_tpch(sf)``'s dict when the
    caller already holds it."""
    from ..storage.database import Database
    db = Database(device=device)
    if data is None:
        data = gen_tpch(sf)
    for tname, cols in data.items():
        schema = SCHEMA[tname]
        db.create_table(tname, [(c, _TYPES[schema[c]]) for c in cols])
        td = db.tables[tname]
        arrays = {}
        for c, v in cols.items():
            tag = schema[c]
            arrays[c] = v if tag == "str" else \
                v.astype(_TYPES[tag].np_dtype, copy=False)
        td.append(arrays)
    return db
