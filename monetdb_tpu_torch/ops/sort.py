"""Sort keys — the port of the reference package's ops/sort.py ``sort_key``.

Every ordering is expressed as a monotone int64 key transform (floats via
the sign-magnitude bit trick, strings via order-preserving dict codes,
descending via bitwise complement), so a stable argsort of the key realizes
BATsort's ordering contract (gdk/gdk_batop.c:2342): nils sort first
ascending and last descending by sentinel construction; explicit nils_last
remaps the sentinel to the far end.  The op-at-a-time argsort/firstn
wrappers are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sort_key"]

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
