"""The lowering's maps over a string dictionary, on the card.

``exec/fragment.py`` lowers LIKE and the string functions over a dictionary
column to a lookup table by code (the strimps / dictionary trick of
ops/strfuncs.py): a bool a value for LIKE, a new code a value for
``substring`` / ``left`` / ``right``.  On the host that is a numpy or
Python pass over every distinct value, then the table's upload.  Here the
same tables come from two hand-written kernels (ops/cuda_kernels.py
``like_match``, ``substr_keys``) over the dictionary's UTF-8 byte heap
(``StrDict.heap``, built once a dictionary in pinned host memory).  Each
map uploads the heap into buffers that live for that map alone (the card
keeps no copy: the tables' residency is the deployment's memory), and the
table stays on the device.

Which path a map takes follows from what it can observe, with no setting:
the catalog's device is CUDA, the dictionary holds at least
``DEVICE_MIN_VALUES`` values, its heap fits int32 offsets and holds no NUL
(the host path reads values through numpy strings, which drop trailing
NULs), and the map is one the kernels compute exactly as the host does:
a LIKE pattern (not a regex) of at most ``LIKE_MAX_OPS`` ops, ILIKE only
with an all-ASCII heap and pattern, a substring / left / right with
integer arguments whose result fits 8 bytes.  Everything else returns None
and the caller keeps its host path, which stays the plain reference of
these maps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..column import StrDict, StrHeap
from . import cuda_kernels as CK
from .strfuncs import like_program

__all__ = ["DEVICE_MIN_VALUES", "like_plan", "like_mask", "substr_spec",
           "substr_plan", "remap_keys", "substr_remap"]

#: dictionaries with fewer values map on the host, where numpy beats the
#: launches, the upload and (substring) the read.  Measured on an NVIDIA
#: H100 80GB HBM3 (chip_smoke.py's kernel dict phase over prefixes of
#: TPC-H SF1's o_comment / c_phone, wall with the table on the card):
#: LIKE host 0.098 / device 0.115 ms at 150 values, 0.150 / 0.109 ms at
#: 256; substring 0.175 / 0.189 ms at 150, 0.278 / 0.182 ms at 256.
DEVICE_MIN_VALUES = 256


def _heap(sd: StrDict, device: torch.device) -> Optional[StrHeap]:
    """The dictionary's heap when a kernel may map it on ``device``."""
    if device.type != "cuda" or len(sd) < DEVICE_MIN_VALUES:
        return None
    heap = sd.heap()
    return heap if heap.fits and heap.nul_free else None


def _upload(heap: StrHeap, device: torch.device):
    """The heap on ``device``, in buffers of this map alone (freed in
    stream order once the caller drops them)."""
    return (heap.data.to(device, non_blocking=True),
            heap.offsets.to(device, non_blocking=True))


def like_plan(sd: StrDict, pattern: str, escape: Optional[str],
              caseless: bool, device: torch.device):
    """(heap, program, dollar_nl) of ``like_match`` when the LIKE map of
    ``sd`` runs on ``device``, else None (the routing, without a launch)."""
    heap = _heap(sd, device)
    if heap is None or (caseless and not (heap.ascii and pattern.isascii())):
        return None
    prog = like_program(pattern, escape, caseless)
    if len(prog) > CK.LIKE_MAX_OPS:
        return None
    # the host's regex fallback (escapes, '_') reads its '$' as Python's
    return heap, prog, escape is not None or "_" in pattern


def like_mask(sd: StrDict, pattern: str, escape: Optional[str],
              caseless: bool, negated: bool,
              device: torch.device) -> Optional[torch.Tensor]:
    """The LIKE / ILIKE (NOT when ``negated``) table of ``sd`` as a bool
    tensor on ``device``, equal to the host's mask (ops/strfuncs.py
    ``_like_mask_vectorized`` or the ``like_regex`` fallback, inverted for
    NOT); None where the host path keeps it."""
    plan = like_plan(sd, pattern, escape, caseless, device)
    if plan is None:
        return None
    heap, prog, dollar_nl = plan
    data, offs = _upload(heap, device)
    return CK.like_match(data, offs, prog, caseless=caseless,
                         dollar_nl=dollar_nl, negate=negated)


_SUBSTR = ("substring", "left", "right")


def substr_spec(name: str, args: list,
                heap: StrHeap) -> Optional[Tuple[int, int, bool]]:
    """(start, count, right) of ``substr_keys`` for the lowering's
    ``substring`` / ``left`` / ``right`` with constant ``args``, as
    ``_str_func`` slices (start and count in code points, count -1: to the
    end); None when the map stays on the host: another function, a
    non-integer or nil argument, or a result that may exceed 8 bytes."""
    if name not in _SUBSTR or not args or not isinstance(
            args[0], (int, np.integer)):
        return None
    first = int(args[0])
    if name == "substring":
        if len(args) > 1 and args[1] is not None:
            if not isinstance(args[1], (int, np.integer)):
                return None
            count = max(int(args[1]), 0)
        else:
            count = -1
        start, right = max(first - 1, 0), False
    else:
        start, count, right = 0, max(first, 0), name == "right"
    start, count = min(start, CK._I32_MAX), min(count, CK._I32_MAX)
    width = 1 if heap.ascii else 4          # bytes a code point, at most
    most = heap.max_len
    if count >= 0:
        most = min(most, count * width)
    elif heap.ascii:
        most = max(most - start, 0)
    return (start, count, right) if most <= 8 else None


def substr_plan(sd: StrDict, name: str, args: list, device: torch.device):
    """(heap, ``substr_spec``) when ``_str_func``'s map of ``sd`` runs on
    ``device``, else None (the routing, without a launch)."""
    if name not in _SUBSTR:
        return None
    heap = _heap(sd, device)
    spec = substr_spec(name, args, heap) if heap is not None else None
    return None if spec is None else (heap, spec)


def _unpack(keys: np.ndarray) -> np.ndarray:
    """The strings of ``substr_keys`` keys (int64, top bit flipped)."""
    raw = (keys.view(np.uint64) ^ np.uint64(1 << 63)).astype(">u8").tobytes()
    return np.array([raw[i:i + 8].rstrip(b"\0").decode(
        "utf-8", "surrogatepass") for i in range(0, len(raw), 8)], dtype=str)


def remap_keys(keys: torch.Tensor, prefix: bool
               ) -> Tuple[torch.Tensor, np.ndarray]:
    """(int32 new code a value, the new dictionary's sorted values) from
    ``substr_keys``' keys, as ``np.unique(..., return_inverse=True)`` gives
    them on the host.  ``prefix``: the keys are non-decreasing (a prefix of
    a sorted dictionary), so the codes are a scan of "key differs from the
    one before"; else the keys are sorted.  The distinct keys come back in
    one read."""
    if prefix:
        step = torch.ones(len(keys), dtype=torch.bool, device=keys.device)
        torch.ne(keys[1:], keys[:-1], out=step[1:])
        codes = torch.cumsum(step, 0, dtype=torch.int32) - 1
        uniq = keys[step]
    else:
        uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
        codes = inv.to(torch.int32)
    return codes, _unpack(uniq.cpu().numpy())


def substr_remap(sd: StrDict, name: str, args: list, device: torch.device
                 ) -> Optional[Tuple[torch.Tensor, np.ndarray]]:
    """``_str_func``'s map for substring / left / right on the card: (the
    int32 table old code -> new code, on ``device``; the new dictionary's
    sorted values), equal to the host's; None where the host path keeps
    it."""
    plan = substr_plan(sd, name, args, device)
    if plan is None:
        return None
    heap, (start, count, right) = plan
    data, offs = _upload(heap, device)
    keys = CK.substr_keys(data, offs, start=start, count=count, right=right)
    del data, offs
    return remap_keys(keys, start == 0 and not right)
