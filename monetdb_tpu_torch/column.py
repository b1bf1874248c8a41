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
from .dtypes import SQLType

__all__ = ["Column", "Cand", "StrDict", "capacity_for"]


def capacity_for(n: int) -> int:
    """Bucketed device capacity for n logical rows."""
    floor = config.get("min_capacity")
    if n <= floor:
        return floor
    return 1 << math.ceil(math.log2(n))


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

    __slots__ = ("values",)

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values)

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
# Candidates (only the 'all' kind: Table.all_cand)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cand:
    """Candidate set over ``base_count`` rows; the port has only the
    every-live-row kind so far (the reference's absent-candidate case)."""

    kind: str
    base_count: int

    @staticmethod
    def all(base_count: int) -> "Cand":
        return Cand("all", base_count)


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

    @property
    def cap(self) -> int:
        return self.data.shape[0]

    def to_numpy(self, decode: bool = True):
        raw = self.data[: self.count].cpu().numpy()
        if decode and self.sdict is not None:
            return self.sdict.decode(raw)
        return raw

    def __len__(self):
        return self.count

    def __repr__(self):
        flags = "".join(f for f, on in
                        [("S", self.sorted), ("R", self.revsorted),
                         ("K", self.key), ("N", not self.nonil)] if on)
        return (f"Column<{self.typ!r} n={self.count} cap={self.cap} "
                f"{self.data.device} {flags}>")
