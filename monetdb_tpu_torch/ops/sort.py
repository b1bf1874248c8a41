"""Sorting & top-N — the reference's BATsort (gdk/gdk_batop.c:2342) and
BATfirstn (gdk/gdk_firstn.c:1280).

Every ordering is expressed as a monotone int64 key transform (floats via
the sign-magnitude bit trick, strings via order-preserving dict codes,
descending via bitwise complement), so a stable argsort of the key realizes
BATsort's ordering contract: nils sort first ascending and last descending
by sentinel construction; explicit nils_last remaps the sentinel to the far
end.  A lexicographic order over several keys is one stable sort per key,
least significant first (``_tensor.lexsort``); torch has no multi-operand
sort.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..column import Cand, Column, capacity_for, valid_mask
from ._tensor import lexsort
from .project import project_oids

__all__ = ["sort_key", "argsort", "sorted_columns", "firstn"]

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def sort_key(x: torch.Tensor, descending: bool = False,
             nils_last: Optional[bool] = None) -> torch.Tensor:
    """Monotone int64 key for any physical column dtype.

    nils_last=None keeps GDK default (nil smallest → first asc, last desc);
    True/False force the position regardless of direction.
    """
    if x.dtype.is_floating_point:
        f = x.to(torch.float64)
        bits = f.view(torch.int64)
        key = torch.where(bits < 0, _I64_MIN ^ ~bits, bits)
        # NaN (nil) → smallest
        nilmask = torch.isnan(f)
        key = torch.where(nilmask, _I64_MIN, key)
    elif x.dtype == torch.bool:
        key = x.to(torch.int64)
        nilmask = None
    else:
        nilmask = x == torch.iinfo(x.dtype).min
        key = x.to(torch.int64)
        if x.dtype != torch.int64:
            # keep nil = smallest in the widened key space
            key = torch.where(nilmask, _I64_MIN, key)
    if descending:
        key = ~key  # order-reversing, overflow-free
    if nils_last is not None and nilmask is not None:
        key = torch.where(nilmask, _I64_MAX if nils_last else _I64_MIN, key)
    return key


def _lexsort(keys, count, base_mask):
    cap = keys[0].shape[0]
    dev = keys[0].device
    live = valid_mask(cap, count, dev)
    if base_mask is not None:
        live = live & base_mask
    dead = (~live).to(torch.int8)
    rows = lexsort([dead, *keys])
    n = live.sum()
    rows = torch.where(torch.arange(cap, device=dev) < n, rows, -1)
    return rows, n


def argsort(cols: Sequence[Column], descending=None, nils_last=None,
            cand: Optional[Cand] = None) -> Tuple[torch.Tensor, int]:
    """Stable lexicographic argsort → (oids, count). BATsort's order BAT."""
    k = len(cols)
    descending = descending or [False] * k
    nils_last = nils_last or [None] * k
    keys = [sort_key(c.data, d, nl)
            for c, d, nl in zip(cols, descending, nils_last)]
    base_mask = cand.as_mask(cols[0].cap, cols[0].data.device) \
        if (cand is not None and not cand.is_all()) else None
    rows, _n = _lexsort(keys, cols[0].count, base_mask)
    if cand is None:
        return rows, cols[0].count
    return rows, cand.count()


def sorted_columns(order: Tuple[torch.Tensor, int],
                   cols: Sequence[Column]) -> List[Column]:
    """Apply an order (oids, n) to payload columns (BATsort's sorted BAT)."""
    oids, n = order
    return [project_oids(oids, n, c) for c in cols]


def _topk_single(key, count: int, *, k: int):
    """Smallest-k row ids by a single monotone key, the lowest row id first
    among equal keys.  ``torch.topk`` promises no order among ties, so this
    is a stable sort cut at k."""
    cap = key.shape[0]
    live = valid_mask(cap, count, key.device)
    idx = torch.argsort(torch.where(live, key, _I64_MAX), stable=True)[:k]
    n = min(k, count)
    return torch.where(torch.arange(k, device=key.device) < n, idx, -1), n


def firstn(cols: Sequence[Column], n: int, descending=None, nils_last=None,
           cand: Optional[Cand] = None) -> Tuple[torch.Tensor, int]:
    """BATfirstn (gdk/gdk_firstn.c:1280): top-n row ids under the ordering."""
    from ..obs import set_algorithm
    k = len(cols)
    descending = descending or [False] * k
    nils_last = nils_last or [None] * k
    dev = cols[0].data.device
    if k == 1 and cand is None and n > 0 and n <= cols[0].cap:
        set_algorithm("firstn:topk")
        key = sort_key(cols[0].data, descending[0], nils_last[0])
        out_cap = capacity_for(n)
        kk = min(max(out_cap, n), cols[0].cap)
        oids, nn = _topk_single(key, cols[0].count, k=kk)
        n = min(n, nn)
        out_cap = capacity_for(n)
        sl = oids[:out_cap]
        sl = torch.where(valid_mask(out_cap, n, dev), sl, -1)
        return sl, n
    set_algorithm("firstn:sort")
    oids, total = argsort(cols, descending, nils_last, cand)
    n = min(n, total)
    out_cap = capacity_for(n)
    sl = oids[:out_cap] if out_cap <= oids.shape[0] else \
        torch.nn.functional.pad(oids, (0, out_cap - oids.shape[0]), value=-1)
    sl = torch.where(valid_mask(out_cap, n, dev), sl, -1)
    return sl, n
