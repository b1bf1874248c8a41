"""Grouping — the reference's BATgroup (gdk/gdk_group.c:1347).

Contract preserved (gdk/gdk_group.c:20-45): ``group`` *refines* an existing
grouping — multi-column GROUP BY is chained refinement (col1 → groups;
col2 + groups → groups'), which is how n-ary keys avoid tuple
materialization. Outputs: per-row group ids, extents (representative oid per
group, usable as a candidate list), and histo (group sizes).

The reference documents 6 strategies (gdk_group.c:20-60). This build
keeps the property-driven dispatch with three:

* ``dense``  — small known domain (dict codes, bools, bounded ints):
  combined = prev_id·D + code, presence histogram + prefix-sum renumber.
  One pass, no sort; this is the reference's "subscan"/histogram strategy
  and covers virtually every SQL GROUP BY over dict-encoded columns.
* ``sorted`` — column already sorted within groups: boundary compare +
  prefix sum (reference strategy 3, consecutive-compare).
* ``sort``   — general: lexicographic device sort of (prev_id, value) with
  row payload, boundary flags, prefix-sum ids, scatter back (replaces the
  reference's hash strategies).

Group ids are aligned to the *base* rows (capacity array); rows outside the
candidate get id -1. ``ngroups`` is a host int (one sync — the reference
also materializes group counts).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..column import Cand, Column, capacity_for, valid_mask
from ..dtypes import I64, OID, Kind
from ._tensor import iota, lexsort, set_drop

__all__ = ["GroupResult", "group", "group_multi"]

_DENSE_DOMAIN_MAX = 1 << 20
_I64_MIN = -(1 << 63)


@dataclasses.dataclass
class GroupResult:
    ids: torch.Tensor       # int32, len = base cap, -1 = not a candidate
    ngroups: int            # host
    base_count: int
    extents: Optional[torch.Tensor] = None   # int64 oids, cap ≥ ngroups, tail -1
    histo: Optional[torch.Tensor] = None     # int64 counts, same cap

    @property
    def seg_cap(self) -> int:
        return capacity_for(self.ngroups)

    def extents_column(self) -> Column:
        return Column(OID, self.extents, self.ngroups, sorted=True, key=True)

    def histo_column(self) -> Column:
        return Column(I64, self.histo, self.ngroups)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _min_oid(safe, live, slots: int):
    """Lowest live row index per slot (cap + 1 where none); dead rows carry
    slot id ``slots - 1``, the spare slot."""
    cap = safe.shape[0]
    big = cap + 1
    out = torch.full((slots,), big, dtype=torch.int64, device=safe.device)
    out.scatter_reduce_(0, safe, torch.where(live, iota(cap, safe.device), big),
                        reduce="amin")
    return out


def _dense_group(comb, count, base_mask, *, domain: int):
    """Histogram + renumber for combined code ∈ [0, domain) (caller builds
    combined = prev_id·D + code)."""
    cap = comb.shape[0]
    live = valid_mask(cap, count, comb.device)
    if base_mask is not None:
        live = live & base_mask
    safe = torch.where(live, comb.to(torch.int64), domain)
    hist = torch.zeros(domain + 1, dtype=torch.int64, device=comb.device)
    hist.index_add_(0, safe, live.to(torch.int64))
    present = hist[:domain] > 0
    # compact renumber: new_id[code] = rank among present codes
    newid = torch.cumsum(present.to(torch.int32), 0, dtype=torch.int32) - 1
    ids = torch.where(live, newid[safe.clamp(0, domain - 1)], -1).to(torch.int32)
    ngroups = present.sum()
    # extents: min oid per combined code, then compact
    minoid = _min_oid(safe, live, domain + 1)
    return ids, ngroups, present, hist[:domain], minoid[:domain], newid


def _compact_per_group(present, values, newid, fill, *, seg_cap: int):
    """Scatter per-domain-slot values into compact group slots."""
    pos = torch.where(present, newid.to(torch.int64), seg_cap)
    return set_drop(seg_cap, fill, pos, values)


def _sort_group(keys_prev, keys_val, count, base_mask):
    """General sort-based grouping. Returns per-row ids + ngroups (device)."""
    cap = keys_val.shape[0]
    dev = keys_val.device
    live = valid_mask(cap, count, dev)
    if base_mask is not None:
        live = live & base_mask
    # push non-candidates to the end: sort key (dead, prev, val), row order
    # among equals
    dead = (~live).to(torch.int32)
    rows = lexsort([dead, keys_prev, keys_val])
    p_s, v_s, live_s = keys_prev[rows], keys_val[rows], live[rows]
    bound = (p_s != torch.roll(p_s, 1)) | (v_s != torch.roll(v_s, 1))
    bound[0] = True
    gid_s = torch.cumsum((bound & live_s).to(torch.int32), 0,
                         dtype=torch.int32) - 1
    gid_live = torch.where(live_s, gid_s, -1)
    ngroups = gid_live.max() + 1
    ids = torch.empty(cap, dtype=torch.int32, device=dev)
    ids[rows] = gid_live
    return ids, ngroups


def _extents_histo(ids, count, *, seg_cap: int):
    cap = ids.shape[0]
    live = valid_mask(cap, count, ids.device) & (ids >= 0)
    safe = torch.where(live, ids.to(torch.int64), seg_cap)
    hist = torch.zeros(seg_cap + 1, dtype=torch.int64, device=ids.device)
    hist = hist.index_add_(0, safe, live.to(torch.int64))[:seg_cap]
    ext = _min_oid(safe, live, seg_cap + 1)[:seg_cap]
    ext = torch.where(hist > 0, ext, -1)
    return ext, hist


# ---------------------------------------------------------------------------
# host dispatch
# ---------------------------------------------------------------------------


def _dense_domain(col: Column) -> Optional[int]:
    """Domain size if the column maps to small ints [0, D) cheaply.
    Nils get a dedicated extra slot (they form a group of their own,
    matching the reference where nil is an ordinary grouping value)."""
    t = col.typ
    if t.kind == Kind.STR and col.sdict is not None:
        return len(col.sdict) + 1
    if t.np_dtype.kind == "b":
        return 2
    if t.np_dtype == np.dtype(np.int8):
        return 256
    if col.nonil and col.minval is not None and col.maxval is not None:
        d = int(col.maxval) - int(col.minval) + 1
        if 0 < d <= _DENSE_DOMAIN_MAX:
            return d
    return None


def _codes(col: Column):
    """Column → (codes in [0, D), D) for the dense path."""
    t = col.typ
    if t.kind == Kind.STR and col.sdict is not None:
        D = len(col.sdict) + 1
        codes = col.data.to(torch.int32)
        codes = torch.where(codes < 0, D - 1, codes)  # nil → last slot
        return codes, D
    if t.np_dtype.kind == "b":
        return col.data.to(torch.int32), 2
    if t.np_dtype == np.dtype(np.int8):
        # int8 nil (-128) lands on slot 0, real values on 1..255 — distinct
        return col.data.to(torch.int32) + 128, 256
    lo = int(col.minval)
    return col.data.to(torch.int64) - lo, int(col.maxval) - lo + 1


def group(col: Column, cand: Optional[Cand] = None,
          prev: Optional[GroupResult] = None,
          with_extents: bool = True) -> GroupResult:
    """BATgroup: refine ``prev`` grouping by ``col`` within ``cand``."""
    from ..obs import set_algorithm
    dev = col.data.device
    base_mask = None
    if cand is not None and not cand.is_all():
        base_mask = cand.as_mask(col.cap, dev)
    base_count = col.count

    D = _dense_domain(col)
    # empty refinement input (0 prior groups) still needs domain ≥ D
    prev_n = max(prev.ngroups, 1) if prev is not None else 1
    if D is not None and D * prev_n <= _DENSE_DOMAIN_MAX:
        set_algorithm("group:dense")
        codes, D = _codes(col)
        if prev is not None:
            pm = prev.ids >= 0
            comb = torch.where(pm, prev.ids.to(torch.int64) * D, 0) \
                + codes.to(torch.int64)
            base_mask = pm if base_mask is None else (base_mask & pm)
            domain = D * prev_n
        else:
            comb = codes.to(torch.int64)
            domain = D
        ids, ng, present, hist, minoid, newid = _dense_group(
            comb, col.count, base_mask, domain=int(domain))
        ngroups = int(ng)
        res = GroupResult(ids, ngroups, base_count)
        if with_extents:
            seg_cap = res.seg_cap
            res.extents = _compact_per_group(present, minoid, newid, -1,
                                             seg_cap=seg_cap)
            res.histo = _compact_per_group(present, hist, newid, 0,
                                           seg_cap=seg_cap)
        return res

    # general sort path
    set_algorithm("group:sort")
    prev_ids = prev.ids if prev is not None else \
        torch.zeros(col.cap, dtype=torch.int32, device=dev)
    if prev is not None:
        pm = prev.ids >= 0
        base_mask = pm if base_mask is None else (base_mask & pm)
    vals = col.data
    if vals.dtype.is_floating_point:
        # make nils (NaN) group together: bitcast to sortable ints
        v = vals.to(torch.float64)
        vals = torch.where(torch.isnan(v), _I64_MIN, v.view(torch.int64))
    elif vals.dtype != torch.int64:
        vals = vals.to(torch.int64)
    ids, ng = _sort_group(prev_ids, vals, col.count, base_mask)
    ngroups = int(ng)
    res = GroupResult(ids, ngroups, base_count)
    if with_extents:
        res.extents, res.histo = _extents_histo(ids, col.count,
                                                seg_cap=res.seg_cap)
    return res


def group_multi(cols, cand: Optional[Cand] = None,
                with_extents: bool = True) -> GroupResult:
    """Chained refinement over several columns (multi-column GROUP BY)."""
    g = None
    for i, c in enumerate(cols):
        last = i == len(cols) - 1
        g = group(c, cand, g, with_extents=with_extents and last)
    return g
