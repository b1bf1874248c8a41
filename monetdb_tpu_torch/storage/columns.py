"""Physical column ↔ device column conversion with property derivation.

The reference maintains COLrec properties incrementally in BATappend
(gdk/gdk_batop.c:674); here properties (sorted/key/nonil/min/max) are
derived per materialization of a storage version — they drive the kernel
strategy picks in ops.* exactly as in BATselect/BATjoin.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..column import Column, StrDict, capacity_for, upload_padded
from ..dtypes import (BOOL, DATE, F32, F64, I8, I16, I32, I64, TIMESTAMP,
                      Kind, SQLType, decimal, varchar)

__all__ = ["type_tag", "tag_type", "make_device_column", "to_physical_np",
           "Categorical", "RowidColumn", "device_props", "str_nilmask",
           "to_physical_bulk"]

#: the code of a NULL string (str_nil's place in the dictionary order)
NIL_CODE = np.int32(np.iinfo(np.int32).min)


@dataclasses.dataclass
class Categorical:
    """A text column as ``codes`` over ``categories``, the shape pandas'
    ``Categorical`` has: int32 codes, each the position of its string in
    ``categories`` (sorted, unique), a negative code for NULL.  A store
    keeps copies of its codes and categories (``Connection.append``) once
    they are ``checked``."""

    codes: np.ndarray
    categories: np.ndarray
    #: set on what ``checked`` returns, so that a store checks a batch once
    _ok: bool = dataclasses.field(default=False, init=False, repr=False,
                                  compare=False)

    def __len__(self) -> int:
        return len(self.codes)

    def checked(self) -> "Categorical":
        """The same column with int32 codes, NULL as ``NIL_CODE``, and a
        ``str`` dictionary; raises ValueError unless ``categories`` is
        sorted and unique and every code is NULL or in range."""
        if self._ok:
            return self
        cats = np.asarray(self.categories)
        if cats.dtype.kind != "U":
            cats = cats.astype(str)
        if len(cats) > 1 and not (cats[:-1] < cats[1:]).all():
            raise ValueError("Categorical: categories must be sorted and "
                             "unique")
        codes = np.asarray(self.codes)
        if codes.dtype.kind not in "iu":
            raise ValueError("Categorical: codes must be integers")
        if len(codes):
            lo, hi = int(codes.min()), int(codes.max())
            if hi >= len(cats):
                raise ValueError(f"Categorical: code {hi} out of range "
                                 f"for {len(cats)} categories")
            if lo < 0:
                neg = codes < 0
                if (codes[neg] != NIL_CODE).any():
                    codes = np.where(neg, NIL_CODE, codes)
        out = Categorical(codes.astype(np.int32, copy=False), cats)
        out._ok = True
        return out

    def used(self) -> "Categorical":
        """``checked``, with the categories that no code names dropped and
        the codes renumbered to match."""
        c = self.checked()
        codes, cats = c.codes, c.categories
        seen = np.zeros(len(cats), dtype=bool)
        step = 1 << 24
        for i in range(0, len(codes), step):        # bounded index copies
            part = codes[i:i + step]
            seen[part[part >= 0] if part.min() < 0 else part] = True
        if seen.all():
            return c
        lut = (np.cumsum(seen) - 1).astype(np.int32)
        out = Categorical(np.where(codes >= 0, lut[np.maximum(codes, 0)],
                                   NIL_CODE).astype(np.int32), cats[seen])
        out._ok = True
        return out

    def nilmask(self) -> np.ndarray:
        return np.asarray(self.codes) < 0

    def strings(self):
        """(the values as a ``str`` array with "" for NULL, the NULL
        mask)."""
        c = self.checked()
        nil = c.codes < 0
        if not len(c.categories):
            return np.full(len(nil), ""), nil
        return np.where(nil, "", c.categories[np.maximum(c.codes, 0)]), nil

    def decode(self) -> np.ndarray:
        """The values as an object array, None for NULL."""
        vals, nil = self.strings()
        out = vals.astype(object)
        out[nil] = None
        return out


def str_nilmask(a) -> np.ndarray:
    """NULL positions of a text column as a store receives it: a
    ``Categorical``, a ``str`` array (no NULL) or an object array (None)."""
    if isinstance(a, Categorical):
        return a.nilmask()
    a = np.asarray(a)
    if a.dtype.kind == "O":
        return np.equal(a, None)
    return np.zeros(len(a), dtype=bool)


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


def device_props(vals: torch.Tensor, typ: SQLType,
                 code_flags: bool = False) -> dict:
    """The property flags of the live values ``vals`` (a tensor on any
    device), worked out where they lie and read back in one transfer:
    ``nonil`` always; for a column of integers (dates and decimals, and
    string codes if ``code_flags``) with no nil also ``minval``,
    ``maxval``, ``sorted``, ``revsorted`` and ``key``, as
    ``Column.from_numpy``'s callers derive them on the host
    (``bench/tpch_load._encode_column``)."""
    n = vals.shape[0]
    kind = typ.np_dtype.kind
    if kind == "f":
        return {"nonil": not bool(torch.isnan(vals).any())}
    if kind == "b":
        return {"nonil": bool(vals.all())}     # the bool nil is False
    if typ.kind == Kind.STR and not code_flags:
        return {"nonil": not bool((vals == int(typ.nil)).any())}
    out = {"nonil": True}
    if not n:
        return out
    a, b = vals[:-1], vals[1:]
    i64 = torch.int64
    head = torch.stack([vals.min().to(i64), vals.max().to(i64),
                        (b >= a).all().to(i64), (b <= a).all().to(i64),
                        (b > a).all().to(i64),
                        (vals == int(typ.nil)).any().to(i64)]).tolist()
    mn, mx, asc, desc, strict, nil = head
    if nil:
        return {"nonil": False}
    out.update(minval=mn, maxval=mx, sorted=bool(asc), revsorted=bool(desc),
               key=bool(asc and strict))
    if not out["key"] and mx - mn + 1 == n:
        # n values over a range of n: distinct exactly when every slot
        # of the range is hit (in slices, to bound the index tensor)
        seen = torch.zeros(n, dtype=torch.bool, device=vals.device)
        step = 1 << 24
        for i in range(0, n, step):
            seen[(vals[i:i + step] - mn).to(torch.int64)] = True
        out["key"] = bool(seen.all())
    return out


def make_device_column(arr: np.ndarray, typ: SQLType,
                       dict_values: Optional[np.ndarray] = None, *,
                       device, code_flags: bool = False,
                       clock: Optional[str] = None) -> Column:
    """Physical numpy array (+ dictionary for strings) → Column on
    ``device``: the live rows go up as they are, the tail of the bucketed
    capacity is filled with nil there, and ``device_props`` derives the
    flags there.  A text column gets its codes' flags only with
    ``code_flags`` (a store's table, which the planner reads as the
    Engine's loaders give it; an operator's result keeps the reference
    package's: none).  ``clock`` is ``upload_padded``'s."""
    str_col = typ.kind == Kind.STR
    phys = arr.astype(np.int32 if str_col else typ.np_dtype, copy=False)
    n = len(phys)
    fill = typ.nil if typ.np_dtype.kind != "b" else False
    data = upload_padded(phys, capacity_for(n), fill, device, clock)
    return Column(typ, data, n,
                  sdict=StrDict(dict_values) if str_col else None,
                  **device_props(data[:n], typ, code_flags))


class RowidColumn(Column):
    """A materialized table's hidden ``__rowid__`` (device row → storage
    oid), made on the device at its first read: ``0 .. count - 1`` while
    no row of the table is deleted, else the visible rows' ``oids``.
    Only UPDATE, DELETE and MERGE name it, so a table that only answers
    queries never holds it.  Its flags are known without a scan."""

    def __init__(self, count: int, device, oids: Optional[np.ndarray] = None):
        self._data = None
        self._device = device
        self._oids = oids
        props = {}
        if count:
            lo = 0 if oids is None else int(oids[0])
            hi = count - 1 if oids is None else int(oids[-1])
            props = dict(sorted=True, revsorted=count == 1, key=True,
                         minval=lo, maxval=hi)
        super().__init__(I64, None, count, nonil=True, **props)

    @property
    def data(self) -> torch.Tensor:
        if self._data is None:
            n, cap = self.count, capacity_for(self.count)
            if self._oids is None:
                data = torch.arange(cap, dtype=torch.int64,
                                    device=self._device)
                data[n:] = int(I64.nil)
            else:
                data = upload_padded(self._oids, cap, I64.nil, self._device)
            self._data = data
        return self._data

    @data.setter
    def data(self, value) -> None:
        self._data = value

    @property
    def cap(self) -> int:
        return capacity_for(self.count)

    @property
    def device(self) -> torch.device:
        return torch.device(self._device)

    def with_props(self, **props) -> Column:
        return Column(self.typ, self.data, self.count, sorted=self.sorted,
                      revsorted=self.revsorted, key=self.key,
                      nonil=self.nonil, minval=self.minval,
                      maxval=self.maxval).with_props(**props)

    def __repr__(self):
        return f"RowidColumn<n={self.count} made={self._data is not None}>"


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


_PLAIN_INTS = (Kind.INT, Kind.OID, Kind.INTERVAL)


def _fit_ints(a: np.ndarray, dt: np.dtype) -> np.ndarray:
    """Integer array ``a`` cast to the integer dtype ``dt``; raises
    OverflowError, as a value-by-value assignment does, when a value does
    not fit."""
    if len(a) and not np.can_cast(a.dtype, dt):
        info = np.iinfo(dt)
        if a.min() < info.min or a.max() > info.max:
            raise OverflowError(f"Python integer out of bounds for {dt}")
    return a.astype(dt, copy=False)


def to_physical_bulk(values, typ: SQLType):
    """One column of a bulk append (``monetdbe_append``) in the physical
    domain, with no Python per value where the input is a numpy array of
    a kind the type takes: a ``Categorical`` or a ``str`` / object array
    for text (the store merges the dictionary), integers, floats or bools
    for numbers (cast once, rounding floats into integers as
    ``to_physical_np`` does), ``datetime64`` for dates and timestamps.
    Anything else goes value by value through ``to_physical_np``."""
    from ..dtypes import is_blob
    k = typ.kind
    if isinstance(values, Categorical):
        if k != Kind.STR or is_blob(typ):
            raise ValueError("a Categorical fills a text column")
        return values
    if not isinstance(values, np.ndarray) or values.ndim != 1:
        return to_physical_np(list(values), typ)
    dk, dt = values.dtype.kind, typ.np_dtype
    if k == Kind.STR and not is_blob(typ) and dk in "UO":
        return values
    if k == Kind.BOOL and dk == "b":
        return values
    if k == Kind.FLOAT and dk in "fiub":
        return values.astype(dt, copy=False)
    if k in _PLAIN_INTS and dk in "iub":
        return _fit_ints(values, dt)
    if k in _PLAIN_INTS + (Kind.DECIMAL,) and dk == "f" and \
            np.isfinite(values).all():
        scaled = values * 10 ** typ.scale if k == Kind.DECIMAL else values
        r = np.round(scaled)
        if len(r) and np.abs(r).max() >= 2.0 ** 63:
            raise OverflowError("Python integer out of bounds")
        return _fit_ints(r.astype(np.int64), dt)
    if k == Kind.DECIMAL and dk in "iub":
        return to_physical_bulk(values.astype(np.float64), typ)
    if k in (Kind.DATE, Kind.TIMESTAMP) and dk == "M":
        unit = "D" if k == Kind.DATE else "us"
        raw = values.astype(f"datetime64[{unit}]").astype(np.int64)
        nat = np.isnat(values)
        out = _fit_ints(np.where(nat, 0, raw), dt)
        out[nat] = typ.nil
        return out
    return to_physical_np(list(values), typ)
