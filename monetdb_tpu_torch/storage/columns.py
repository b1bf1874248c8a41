"""Physical column ↔ device column conversion with property derivation.

The reference maintains COLrec properties incrementally in BATappend
(gdk/gdk_batop.c:674); here properties (sorted/key/nonil/min/max) are
derived per materialization of a storage version — they drive the kernel
strategy picks in ops.* exactly as in BATselect/BATjoin.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..column import Column, StrDict
from ..dtypes import (BOOL, DATE, F32, F64, I8, I16, I32, I64, TIMESTAMP,
                      Kind, SQLType, decimal, varchar)

__all__ = ["type_tag", "tag_type", "make_device_column", "to_physical_np"]


def type_tag(t: SQLType) -> str:
    if t.kind == Kind.DECIMAL:
        return f"dec:{t.precision}:{t.scale}"
    if t.kind == Kind.STR:
        return "blob" if t.scale == 1 else "str"
    if t.kind == Kind.DATE:
        return "date"
    if t.kind == Kind.TIMESTAMP:
        return "timestamp"
    if t.kind == Kind.TIME:
        return "time"
    if t.kind == Kind.BOOL:
        return "bool"
    return {"int8": "i8", "int16": "i16", "int32": "i32", "int64": "i64",
            "float32": "f32", "float64": "f64"}[t.np_dtype.name]


def tag_type(tag: str) -> SQLType:
    if tag.startswith("dec:"):
        _, p, s = tag.split(":")
        return decimal(int(p), int(s))
    from ..dtypes import TIME, blob as _blob
    if tag == "blob":
        return _blob()
    return {"str": varchar(), "date": DATE, "timestamp": TIMESTAMP,
            "time": TIME, "bool": BOOL, "i8": I8, "i16": I16, "i32": I32,
            "i64": I64, "f32": F32, "f64": F64}[tag]


def make_device_column(arr: np.ndarray, typ: SQLType,
                       dict_values: Optional[np.ndarray] = None, *,
                       device) -> Column:
    """Physical numpy array (+ dictionary for strings) → Column on
    ``device`` with derived properties."""
    if typ.kind == Kind.STR:
        col = Column.from_numpy(arr.astype(np.int32), typ,
                                sdict=StrDict(dict_values), device=device)
        return col
    arr = arr.astype(typ.np_dtype, copy=False)
    col = Column.from_numpy(arr, typ, device=device)
    n = len(arr)
    if n and typ.np_dtype.kind in "iu":
        from ..dtypes import is_nil_np
        nilm = is_nil_np(arr, typ)
        if not nilm.any():
            vals = arr
            col.minval, col.maxval = int(vals.min()), int(vals.max())
            d = np.diff(vals)
            col.sorted = bool((d >= 0).all())
            col.revsorted = bool((d <= 0).all())
            if col.sorted and n > 1 and (d > 0).all():
                col.key = True
            elif n == 1:
                col.key = True
            elif int(col.maxval) - int(col.minval) + 1 == n:
                col.key = bool(len(np.unique(vals)) == n)
    return col


def blob_norm(s: str) -> str:
    """Validate/canonicalize a blob hex literal: uppercase, even length,
    hex digits only (the reference's blobFromStr rejects invalid literals
    with 22M28, modules/atoms/blob.c)."""
    s = s.strip().upper()
    if len(s) % 2 or any(c not in "0123456789ABCDEF" for c in s):
        raise ValueError(f"22M28!invalid blob literal {s[:24]!r}")
    return s


def column_from_pyvalues(values, typ: SQLType, *, device) -> Column:
    """Logical python values → Column on ``device`` (dictionary-encodes strings
    with the engine's order-preserving code invariant)."""
    arr = to_physical_np(values, typ)
    if typ.kind == Kind.STR:
        isnil = np.array([v is None for v in arr], dtype=bool)
        vals = arr[~isnil].astype(str) if (~isnil).any() \
            else np.empty(0, dtype=str)
        d = np.unique(vals)
        codes = np.full(len(arr), np.iinfo(np.int32).min, np.int32)
        if len(vals):
            codes[~isnil] = np.searchsorted(d, vals)
        return make_device_column(codes, typ, d, device=device)
    return make_device_column(arr, typ, device=device)


def table_from_rows(name: str, schema, rows, *, device):
    """Build an in-memory Table on ``device`` from row tuples."""
    from ..table import Table
    cols = {}
    for i, (cname, t) in enumerate(schema):
        cols[cname] = column_from_pyvalues([r[i] for r in rows], t,
                                           device=device)
    return Table.from_dict(name, cols)


def _lenient_date(s: str):
    """ISO date allowing non-padded fields ('1988-1-1'), like the
    reference's date parser (gdk_time.c parse_date)."""
    import datetime
    try:
        return datetime.date.fromisoformat(s)
    except ValueError:
        y, m, d = s.split("-")
        return datetime.date(int(y), int(m), int(d))


def _lenient_ts(s: str):
    import datetime
    try:
        return datetime.datetime.fromisoformat(s)
    except ValueError:
        dpart, _, tpart = s.partition(" ")
        d = _lenient_date(dpart)
        if not tpart:
            return datetime.datetime(d.year, d.month, d.day)
        t = datetime.time.fromisoformat(tpart)
        return datetime.datetime.combine(d, t)


def to_physical_np(values, typ: SQLType) -> np.ndarray:
    """Logical python/numpy values → physical array (scaled ints, epoch
    days/µs, raw strings stay strings for dictionary merge upstream)."""
    import datetime
    from decimal import Decimal as PyDecimal

    if typ.kind == Kind.STR:
        from ..dtypes import is_blob
        if is_blob(typ):
            # every entry point (INSERT, COPY, UPDATE, CAST) validates
            # and canonicalizes blob literals (blobFromStr, 22M28)
            return np.array([None if v is None else blob_norm(str(v))
                             for v in values], dtype=object)
        # object array preserving None: the dictionary encoder maps None to
        # the nil code (int32 min), matching str_nil in the reference
        return np.array([None if v is None else str(v) for v in values],
                        dtype=object)
    out = np.empty(len(values), typ.np_dtype)
    nil = typ.nil
    intlike = typ.np_dtype.kind == "i" and typ.kind not in (
        Kind.DECIMAL, Kind.DATE, Kind.TIMESTAMP, Kind.TIME)
    for i, v in enumerate(values):
        if v is None:
            out[i] = nil
        elif intlike and isinstance(v, float):
            # float literal into an integer column: round (sql_atom.c
            # value coercion)
            out[i] = int(round(v))
        elif typ.kind == Kind.DECIMAL:
            if isinstance(v, PyDecimal):
                out[i] = int(v.scaleb(typ.scale).to_integral_value())
            else:
                out[i] = int(round(float(v) * 10 ** typ.scale))
        elif typ.kind == Kind.DATE:
            if isinstance(v, str):
                # implicit string→date coercion (MonetDB accepts ISO
                # strings in temporal positions; sql_atom.c casts)
                v = _lenient_date(v.strip())
            if isinstance(v, datetime.date):
                out[i] = (v - datetime.date(1970, 1, 1)).days
            else:
                out[i] = int(v)
        elif typ.kind == Kind.TIMESTAMP:
            if isinstance(v, str):
                v = _lenient_ts(v.strip())
            elif isinstance(v, datetime.date) and \
                    not isinstance(v, datetime.datetime):
                v = datetime.datetime(v.year, v.month, v.day)
            if isinstance(v, datetime.datetime):
                # naive-UTC epoch µs (matches the executor's constant
                # lowering; no local-timezone dependence)
                out[i] = int((v - datetime.datetime(1970, 1, 1))
                             .total_seconds() * 1_000_000)
            else:
                out[i] = int(v)
        elif typ.kind == Kind.TIME:
            if isinstance(v, str):
                v = datetime.time.fromisoformat(v.strip())
            if isinstance(v, datetime.time):
                out[i] = ((v.hour * 60 + v.minute) * 60 + v.second) \
                    * 1_000_000 + v.microsecond
            else:
                out[i] = int(v)
        else:
            out[i] = v
    return out
