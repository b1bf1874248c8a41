"""Tensor helpers shared by the operator library: dtype mapping, nil
sentinels, the scatter-with-dropped-updates pattern and truncating integer
division.  Every function takes its device from its tensor arguments."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

__all__ = ["tdt", "npdt", "nil_const", "nilm", "gather_nil", "set_drop",
           "idiv", "irem", "lexsort", "iota", "as_scalar", "catalog_device"]

_NP2TORCH = {np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
             np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
             np.dtype(np.int64): torch.int64,
             np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}
_TORCH2NP = {t: d for d, t in _NP2TORCH.items()}


def tdt(dt) -> torch.dtype:
    """numpy dtype (or its name) -> torch dtype."""
    return dt if isinstance(dt, torch.dtype) else _NP2TORCH[np.dtype(dt)]


def npdt(dt) -> np.dtype:
    return _TORCH2NP[dt] if isinstance(dt, torch.dtype) else np.dtype(dt)


def nil_const(dtype):
    """Nil sentinel of a numpy or torch dtype, as a python scalar."""
    d = npdt(dtype)
    if d.kind == "f":
        return float("nan")
    if d.kind == "b":
        return False
    return int(np.iinfo(d).min)


def nilm(x: torch.Tensor) -> torch.Tensor:
    """Nil mask of a tensor by its dtype's sentinel."""
    if x.dtype.is_floating_point:
        return torch.isnan(x)
    if x.dtype == torch.bool:
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    return x == torch.iinfo(x.dtype).min


def gather_nil(arr, oids, live_out):
    """arr[oids] with dead slots (live_out False or oid<0) -> nil."""
    ok = live_out & (oids >= 0)
    safe = torch.where(ok, oids, 0).long()
    return torch.where(ok, arr[safe], nil_const(arr.dtype))


def catalog_device(catalog, error=ValueError) -> torch.device:
    """The one device that holds every tensor of ``catalog`` (and its
    ``device`` attribute, which a store's catalog carries even when it
    holds no table); raises ``error`` when they are spread over several
    (or there is none)."""
    devs = {c.device for t in catalog.tables.values()
            for c in t.columns.values()}
    if getattr(catalog, "device", None) is not None:
        devs.add(catalog.device)
    if len(devs) != 1:
        raise error(f"catalog tensors on {sorted(map(str, devs))}: "
                    "need exactly one device")
    return devs.pop()


def iota(n: int, device, dtype=torch.int64) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device)


def as_scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A host scalar as a 0-d tensor of ``dtype`` on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    if isinstance(v, np.generic):
        v = v.item()
    return torch.tensor(v, dtype=dtype, device=device)


def set_drop(size: int, fill, pos, vals) -> torch.Tensor:
    """``full(size, fill)`` with ``vals`` written at ``pos``; positions
    outside [0, size) are dropped.  torch raises (CPU) or asserts (CUDA) on
    an out-of-range index, so those updates go to a spare last slot that is
    cut off.  Positions in range must be unique."""
    out = torch.full((size + 1,), fill, dtype=vals.dtype, device=vals.device)
    idx = torch.where((pos >= 0) & (pos < size), pos, size).long()
    out.scatter_(0, idx, vals)
    return out[:size]


def idiv(a, b):
    """Truncating integer division; b == 0 -> a (the caller flags it),
    INT_MIN / -1 -> INT_MIN.  The x86 divide instruction traps on
    INT_MIN / -1, so -1 is handled by negation."""
    safe = torch.where((b == 0) | (b == -1), 1, b)
    return torch.where(b == -1, -a, torch.div(a, safe, rounding_mode="trunc"))


def irem(a, b):
    """Truncating integer remainder (sign of the dividend); b == 0 -> 0."""
    safe = torch.where((b == 0) | (b == -1), 1, b)
    return torch.where(b == -1, 0, torch.fmod(a, safe))


def lexsort(keys: List[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic argsort, first key most significant: one stable
    argsort per key, least significant first."""
    perm = None
    for k in reversed(keys):
        perm = torch.argsort(k, stable=True) if perm is None else \
            perm[torch.argsort(k[perm], stable=True)]
    return perm
