"""Column substrate: a torch tensor on an explicit device + host descriptor.

The port of the reference package's column.py.  A column is a dense 1-D
tensor of fixed-width values padded to a bucketed capacity (the tail holds
the type's nil sentinel), with a host-side descriptor carrying the property
flags (sorted/key/nonil, min/max) the fragment lowering reads — the
reference's BAT with its COLrec flags (gdk/gdk.h:545-804).  Strings are
dictionary-encoded with order-preserving codes (``StrDict``).

The device is always the caller's choice: ``Column.from_numpy`` uploads to
the device it is given and nothing here picks or falls back to another.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import config
from .dtypes import Kind, SQLType, varchar

__all__ = ["Column", "Cand", "StrDict", "capacity_for", "valid_mask"]


def capacity_for(n: int) -> int:
    """Bucketed device capacity for n logical rows."""
    floor = config.get("min_capacity")
    if n <= floor:
        return floor
    return 1 << math.ceil(math.log2(n))


def valid_mask(cap: int, count, device) -> torch.Tensor:
    """Boolean mask selecting the live prefix of a padded device tensor."""
    return torch.arange(cap, dtype=torch.int32, device=device) < count


def _pad_np(arr: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full(cap, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


# ---------------------------------------------------------------------------
# String dictionary
# ---------------------------------------------------------------------------


class StrDict:
    """Order-preserving string dictionary (host side).

    ``values`` is a sorted numpy array of unique strings; the device column
    holds int32 codes = rank in ``values``. Sorted codes ⇒ <,<=,>,>= on codes
    are equivalent to the string comparisons, so range/equality predicates
    compile to integer compares (reference: string heap + dict compression,
    gdk/gdk_string.c + sql/backends/monet5/dict.c).
    """

    # _geom_cache: lazily-parsed geometry per distinct value (ops/geom.py)
    __slots__ = ("values", "_geom_cache")

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values)
        self._geom_cache = None

    def __len__(self):
        return len(self.values)

    @staticmethod
    def encode(strings: np.ndarray) -> Tuple["StrDict", np.ndarray]:
        uniq, codes = np.unique(np.asarray(strings), return_inverse=True)
        return StrDict(uniq), codes.astype(np.int32)

    def code_of(self, s: str) -> int:
        """Exact-match code, or -1 if absent."""
        i = np.searchsorted(self.values, s)
        if i < len(self.values) and self.values[i] == s:
            return int(i)
        return -1

    def range_codes(self, s: str, side: str) -> int:
        """searchsorted rank for range predicates on codes."""
        return int(np.searchsorted(self.values, s, side=side))

    def decode(self, codes: np.ndarray) -> np.ndarray:
        if len(self.values) == 0:      # all-nil column, empty dictionary
            return np.full(len(codes), None, dtype=object)
        out = self.values[np.clip(codes, 0, len(self.values) - 1)]
        return np.where(codes < 0, None, out)

    def match_mask(self, pred) -> np.ndarray:
        """Host-evaluated predicate over the dictionary → bool lookup table
        (the strimps/LIKE strategy, gdk/gdk_strimps.c): the expensive string
        predicate runs once per *distinct* value on the host, the device
        applies it with one gather by code."""
        return np.fromiter((bool(pred(v)) for v in self.values),
                           count=len(self.values), dtype=np.bool_)


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cand:
    """Candidate set over ``base_count`` rows of an aligned column family.

    kind 'all'   — every live row (the absent-candidate fast path)
    kind 'dense' — contiguous rows [lo, hi)  (reference: void candidates)
    kind 'mask'  — device bool mask of base capacity (reference: TYPE_msk)
    kind 'oids'  — device int64 row ids, sorted ascending (reference: oid BAT)
    """

    kind: str
    base_count: int
    lo: int = 0
    hi: int = 0
    mask: Optional[torch.Tensor] = None
    oids: Optional[torch.Tensor] = None
    oid_count: Optional[int] = None  # host count for kind 'oids'

    # -- constructors -------------------------------------------------------
    @staticmethod
    def all(base_count: int) -> "Cand":
        return Cand("all", base_count)

    @staticmethod
    def dense(base_count: int, lo: int, hi: int) -> "Cand":
        lo = max(0, lo)
        hi = min(base_count, hi)
        if hi < lo:
            hi = lo
        return Cand("dense", base_count, lo=lo, hi=hi)

    @staticmethod
    def from_mask(mask: torch.Tensor, base_count: int) -> "Cand":
        return Cand("mask", base_count, mask=mask)

    @staticmethod
    def from_oids(oids: torch.Tensor, count: int, base_count: int) -> "Cand":
        return Cand("oids", base_count, oids=oids, oid_count=count)

    # -- conversions --------------------------------------------------------
    def as_mask(self, cap: int, device) -> torch.Tensor:
        """Bool mask of length cap on ``device`` (True = selected live row);
        the 'mask' and 'oids' kinds must already live there."""
        if self.kind == "mask":
            m = self.mask
            if m.shape[0] != cap:
                if m.shape[0] > cap:
                    m = m[:cap]
                else:
                    m = torch.nn.functional.pad(m, (0, cap - m.shape[0]))
            return m
        if self.kind == "oids":
            # oids → mask via scatter; dead slots write False to the last row
            oid = self.oids
            live = valid_mask(oid.shape[0], self.oid_count, oid.device)
            safe = torch.where(live, oid, cap - 1).to(torch.int64)
            m = torch.zeros(cap, dtype=torch.uint8, device=oid.device)
            m.scatter_reduce_(0, safe, live.to(torch.uint8), reduce="amax")
            return m.to(torch.bool)
        io = torch.arange(cap, dtype=torch.int64, device=device)
        if self.kind == "all":
            return io < self.base_count
        return (io >= self.lo) & (io < self.hi)

    def count(self) -> int:
        """Host row count (one device read for the mask kind)."""
        if self.kind == "all":
            return self.base_count
        if self.kind == "dense":
            return self.hi - self.lo
        if self.kind == "oids":
            return self.oid_count
        return int(self.mask.sum())

    def is_all(self) -> bool:
        return self.kind == "all" or (
            self.kind == "dense" and self.lo == 0 and self.hi == self.base_count)


# ---------------------------------------------------------------------------
# Column
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Column:
    typ: SQLType
    data: torch.Tensor       # 1-D device tensor, len = capacity, tail = nil
    count: int               # logical row count (host)
    # property flags — drive kernel selection (reference COLrec tsorted etc.)
    sorted: bool = False
    revsorted: bool = False
    key: bool = False        # all values distinct
    nonil: bool = True
    minval: Optional[object] = None
    maxval: Optional[object] = None
    sdict: Optional[StrDict] = None

    @staticmethod
    def from_numpy(arr: np.ndarray, typ: Optional[SQLType] = None,
                   sdict: Optional[StrDict] = None, *, device,
                   **props) -> "Column":
        """Pad ``arr`` to its bucketed capacity and upload it to
        ``device``."""
        arr = np.asarray(arr)
        if typ is None:
            from . import dtypes as dt
            typ = {np.dtype(np.int8): dt.I8, np.dtype(np.int16): dt.I16,
                   np.dtype(np.int32): dt.I32, np.dtype(np.int64): dt.I64,
                   np.dtype(np.float32): dt.F32, np.dtype(np.float64): dt.F64,
                   np.dtype(np.bool_): dt.BOOL}[arr.dtype]
        n = len(arr)
        cap = capacity_for(n)
        fill = typ.nil if typ.np_dtype.kind != "b" else False
        phys = arr.astype(typ.np_dtype, copy=False)
        padded = _pad_np(phys, cap, fill)
        nonil = props.pop("nonil", None)
        if nonil is None:
            from .dtypes import is_nil_np
            nonil = not bool(is_nil_np(phys, typ).any())
        data = torch.from_numpy(padded).to(device)
        return Column(typ, data, n, nonil=nonil, sdict=sdict, **props)

    @staticmethod
    def from_strings(strings, typ: Optional[SQLType] = None, *, device,
                     **props) -> "Column":
        sd, codes = StrDict.encode(np.asarray(strings, dtype=object).astype(str))
        return Column.from_numpy(codes, typ or varchar(), sdict=sd,
                                 device=device, **props)

    @staticmethod
    def from_device(data: torch.Tensor, typ: SQLType, count: int,
                    sdict: Optional[StrDict] = None, **props) -> "Column":
        return Column(typ, data, count, sdict=sdict, **props)

    @property
    def cap(self) -> int:
        return self.data.shape[0]

    def live_mask(self) -> torch.Tensor:
        return valid_mask(self.cap, self.count, self.data.device)

    def head(self, n: int = 10) -> np.ndarray:
        return self.data[: min(n, self.count)].cpu().numpy()

    def to_numpy(self, decode: bool = True):
        raw = self.data[: self.count].cpu().numpy()
        if decode and self.typ.kind == Kind.STR and self.sdict is not None:
            return self.sdict.decode(raw)
        return raw

    def with_props(self, **props) -> "Column":
        return dataclasses.replace(self, **props)

    def __len__(self):
        return self.count

    def __repr__(self):
        flags = "".join(f for f, on in
                        [("S", self.sorted), ("R", self.revsorted),
                         ("K", self.key), ("N", not self.nonil)] if on)
        return (f"Column<{self.typ!r} n={self.count} cap={self.cap} "
                f"{self.data.device} {flags}>")
