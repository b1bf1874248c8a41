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
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import config
from .dtypes import Kind, SQLType, varchar

__all__ = ["Column", "Cand", "StrDict", "StrHeap", "capacity_for",
           "valid_mask", "upload_padded"]


def capacity_for(n: int) -> int:
    """Bucketed device capacity for n logical rows."""
    floor = config.get("min_capacity")
    if n <= floor:
        return floor
    return 1 << math.ceil(math.log2(n))


def valid_mask(cap: int, count, device) -> torch.Tensor:
    """Boolean mask selecting the live prefix of a padded device tensor."""
    return torch.arange(cap, dtype=torch.int32, device=device) < count


def upload_padded(arr: np.ndarray, cap: int, fill, device,
                  clock: Optional[str] = None) -> torch.Tensor:
    """A ``cap``-slot tensor on ``device`` whose first ``len(arr)`` slots
    are ``arr`` and whose tail is ``fill``: the live rows are copied as
    they are and the tail is filled on the device, so no padded host copy
    is made.  ``clock`` names an ``exec.fragment.STATS`` counter charged
    with the copy's own time in ns (CUDA events around it on a CUDA
    device, the host clock elsewhere)."""
    n = len(arr)
    src = torch.from_numpy(np.ascontiguousarray(arr))
    data = torch.empty(cap, dtype=src.dtype, device=device)
    if clock is None:
        data[:n].copy_(src)
    else:
        _timed_copy(data[:n], src, clock)
    if cap > n:
        data[n:].fill_(fill.item() if isinstance(fill, np.generic) else fill)
    return data


def _timed_copy(dst: torch.Tensor, src: torch.Tensor, clock: str) -> None:
    from .exec.fragment import stats_inc
    if dst.device.type == "cuda":
        with torch.cuda.device(dst.device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src)
            end.record()
            end.synchronize()
            ns = int(start.elapsed_time(end) * 1e6)
    else:
        t0 = time.perf_counter_ns()
        dst.copy_(src)
        ns = time.perf_counter_ns() - t0
    stats_inc(clock, ns)


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
    # _heap: the values' UTF-8 byte heap (``heap``), built at first use
    __slots__ = ("values", "_geom_cache", "_heap")

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values)
        self._geom_cache = None
        self._heap = None

    def __len__(self):
        return len(self.values)

    def heap(self) -> "StrHeap":
        """The values as one UTF-8 byte heap (``StrHeap``), built once per
        dictionary at first call and counted in ``STATS["dict_heaps"]``.
        A dictionary never changes (a table version with other strings
        brings a new ``StrDict``), so the heap cannot go stale."""
        if self._heap is None:
            with _HEAP_LOCK:
                if self._heap is None:
                    self._heap = StrHeap(self.values)
                    from .exec.fragment import stats_inc
                    stats_inc("dict_heaps")
        return self._heap

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


_HEAP_LOCK = threading.Lock()


class StrHeap:
    """A dictionary's values as one byte heap, the layout of MonetDB's
    string heap (gdk/gdk_atoms.c strPut) that the device kernels of
    ops/dictmap.py read: value ``i`` is ``data[offsets[i]:offsets[i+1]]``,
    UTF-8 (lone surrogates as ``surrogatepass`` writes them), so byte order
    is code point order.  ``data`` (uint8) and ``offsets`` (int32, n + 1)
    are host tensors, pinned where a CUDA device exists so that an upload
    runs asynchronously.  ``ascii``: every byte is below 0x80; ``nul_free``:
    no value holds a NUL; ``max_len``: the longest value in bytes;
    ``fits``: the heap's size fits the int32 offsets (else ``offsets`` is
    None and no kernel can read it)."""

    __slots__ = ("data", "offsets", "ascii", "nul_free", "max_len", "fits")

    def __init__(self, values: np.ndarray):
        vals = np.asarray(values).tolist()
        joined = "".join(vals)
        self.ascii = joined.isascii()
        if self.ascii:
            raw = joined.encode("ascii")
            lens = np.fromiter(map(len, vals), np.int64, len(vals))
        else:
            enc = [v.encode("utf-8", "surrogatepass") for v in vals]
            raw = b"".join(enc)
            lens = np.fromiter(map(len, enc), np.int64, len(enc))
        self.nul_free = b"\0" not in raw
        self.max_len = int(lens.max()) if len(lens) else 0
        self.fits = len(raw) < (1 << 31)
        pin = torch.cuda.is_available()
        self.data = torch.empty(len(raw), dtype=torch.uint8, pin_memory=pin)
        if raw:
            self.data.numpy()[:] = np.frombuffer(raw, np.uint8)
        self.offsets = None
        if self.fits:
            offs = np.zeros(len(lens) + 1, np.int32)
            np.cumsum(lens, out=offs[1:])
            self.offsets = torch.empty(len(offs), dtype=torch.int32,
                                       pin_memory=pin)
            self.offsets.numpy()[:] = offs


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
        """Upload ``arr`` to ``device`` in a tensor of its bucketed
        capacity (``upload_padded``)."""
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
        nonil = props.pop("nonil", None)
        if nonil is None:
            from .dtypes import is_nil_np
            nonil = not bool(is_nil_np(phys, typ).any())
        data = upload_padded(phys, cap, fill, device)
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

    @property
    def device(self) -> torch.device:
        return self.data.device

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
