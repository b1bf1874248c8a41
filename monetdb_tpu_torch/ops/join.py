"""Join family — the reference's gdk_join.c: BATjoin (:4451) with the
joincost (:3586) strategy pick between mergejoin (:1941), hashjoin (:2900),
fetchjoin (:3893), plus the variants BATleftjoin (:4320), BATouterjoin
(:4334), BATsemijoin (:4347), BATmarkjoin (:4367), BATintersect (:4378),
BATdiff (:4395).

Contract preserved (gdk/gdk_join.c:30-70): joins return aligned oid pairs
(r1 into left, r2 into right); left-variants are left-sorted; outer emits
nil (-1) right oids on miss; markjoin adds the 3-valued certainty flag for
NOT IN semantics; ``nil_matches`` toggles nil-as-value.

Device strategy: the hash table is replaced by *sort + searchsorted* (the
probe is a vectorized binary search). Property fast paths mirror the reference:

* fetchjoin — right is a dense key sequence (PKs!): roid = key - min, O(1).
* merge probe on pre-sorted right — skips the sort entirely.

Match expansion (data-dependent output size) follows the engine-wide
two-phase shape discipline: count on device, one host sync for the total,
then an exact-capacity expansion (searchsorted over the
match-offset prefix sum).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..column import Cand, Column, capacity_for, valid_mask
from ._tensor import iota, nil_const, set_drop
from .select import materialize
from .sort import sort_key

__all__ = ["join", "leftjoin", "outerjoin", "semijoin", "antijoin",
           "markjoin", "JoinResult"]

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


class JoinResult(Tuple):
    """The reference package's public tuple type of this module (no
    function of either package returns it)."""


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _gather_keys(keys, oids, oid_count, dead_key):
    """keys[oids] with dead slots (padding / oid -1 / nil) → dead_key."""
    cap = oids.shape[0]
    live = valid_mask(cap, oid_count, oids.device) & (oids >= 0)
    k = keys[torch.where(live, oids, 0)]
    return torch.where(live, k, dead_key), live


def _sort_with_payload(keys, payload):
    ks, perm = torch.sort(keys, stable=True)
    return ks, payload[perm]


def _probe_counts(rs_keys, lk, l_live, *, nil_matches: bool):
    lo = torch.searchsorted(rs_keys, lk, right=False)
    hi = torch.searchsorted(rs_keys, lk, right=True)
    ok = l_live
    if not nil_matches:
        ok = ok & (lk != _I64_MIN)
    cnt = torch.where(ok, hi - lo, 0)
    return lo, cnt


def _expand(l_oids, rs_oids, lo, cnt, eff, total: int, *, out_cap: int,
            outer: bool):
    """Emit (r1, r2) pairs; with outer=True unmatched lefts emit (l, -1)."""
    ends = torch.cumsum(eff, 0)
    starts = ends - eff
    io = iota(out_cap, l_oids.device)
    li = torch.searchsorted(ends, io, right=True)
    n_l = l_oids.shape[0]
    li_s = li.clamp(0, n_l - 1)
    within = io - starts[li_s]
    r1 = l_oids[li_s]
    matched = cnt[li_s] > 0
    ridx = lo[li_s] + within
    r2 = rs_oids[ridx.clamp(0, rs_oids.shape[0] - 1)]
    if outer:
        r2 = torch.where(matched, r2, -1)
    livep = io < total
    return torch.where(livep, r1, -1), torch.where(livep, r2, -1)


# ---------------------------------------------------------------------------
# host-side strategy dispatch
# ---------------------------------------------------------------------------


def _prep_side(col: Column, cand: Optional[Cand]):
    """Materialize candidate and produce (oids, n, sort-keys-of-rows)."""
    c = materialize(cand if cand is not None else Cand.all(col.count),
                    col.cap, col.data.device)
    keys = sort_key(col.data)
    return c.oids, c.oid_count, keys


def _dense_pk(col: Column) -> bool:
    """fetchjoin eligibility: right is a dense key sequence (PK column)."""
    return (col.key and col.sorted and col.nonil
            and col.minval is not None and col.maxval is not None
            and int(col.maxval) - int(col.minval) + 1 == col.count)


def _fetch_probe(lk, l_live, lo_val, r_count):
    """Dense-PK probe: position = key - min when in range."""
    pos = lk - lo_val
    ok = l_live & (pos >= 0) & (pos < r_count) & (lk != _I64_MIN)
    return torch.where(ok, pos, 0), torch.where(ok, 1, 0)


def join(l: Column, r: Column, lcand: Optional[Cand] = None,
         rcand: Optional[Cand] = None, nil_matches: bool = False,
         how: str = "inner"):
    """Equi-join → (r1_oids, r2_oids, count). how ∈ {inner, left, outer}.

    'left'  = BATleftjoin: every match, left-sorted output.
    'outer' = BATouterjoin: left-sorted, nil right oid on miss.
    (inner is unordered in the reference; ours is left-sorted too — stronger.)
    """
    l_oids, n_l, lkeys = _prep_side(l, lcand)
    lk, l_live = _gather_keys(lkeys, l_oids, n_l, _I64_MIN)
    # nil left keys never match unless nil_matches; treated in _probe_counts
    r_all = rcand is None or rcand.is_all()

    from ..obs import set_algorithm
    if _dense_pk(r) and r_all and not nil_matches:
        # fetchjoin (gdk/gdk_join.c:3893)
        set_algorithm("join:fetch")
        pos, cnt = _fetch_probe(lk, l_live, int(r.minval), r.count)
        rs_oids = None
        lo = pos
    else:
        set_algorithm("join:sortmerge")
        r_oids, n_r, rkeys = _prep_side(r, rcand)
        rk, _r_live = _gather_keys(rkeys, r_oids, n_r, _I64_MAX)
        if not nil_matches:
            rk = torch.where(rk == _I64_MIN, _I64_MAX, rk)  # nils never match
        rs_keys, rs_oids = _sort_with_payload(rk, r_oids)
        lo, cnt = _probe_counts(rs_keys, lk, l_live, nil_matches=nil_matches)

    outer = how == "outer"
    eff = torch.where(l_live, cnt.clamp(min=1), 0) if outer else cnt
    total = int(eff.sum())
    out_cap = capacity_for(total)
    if rs_oids is None:
        # fetch path: r2 = pos directly (right oid = position)
        rs_oids_arr = iota(r.cap, r.data.device)
    else:
        rs_oids_arr = rs_oids
    r1, r2 = _expand(l_oids, rs_oids_arr, lo, cnt, eff, total,
                     out_cap=out_cap, outer=outer)
    return r1, r2, total


def leftjoin(l, r, lcand=None, rcand=None, nil_matches=False):
    """BATleftjoin (gdk/gdk_join.c:4320)."""
    return join(l, r, lcand, rcand, nil_matches, how="left")


def outerjoin(l, r, lcand=None, rcand=None, nil_matches=False):
    """BATouterjoin (gdk/gdk_join.c:4334)."""
    return join(l, r, lcand, rcand, nil_matches, how="outer")


def _match_counts(l, r, lcand, rcand, nil_matches):
    l_oids, n_l, lkeys = _prep_side(l, lcand)
    lk, l_live = _gather_keys(lkeys, l_oids, n_l, _I64_MIN)
    r_all = rcand is None or rcand.is_all()
    if _dense_pk(r) and r_all and not nil_matches:
        _, cnt = _fetch_probe(lk, l_live, int(r.minval), r.count)
    else:
        r_oids, n_r, rkeys = _prep_side(r, rcand)
        rk, _ = _gather_keys(rkeys, r_oids, n_r, _I64_MAX)
        if not nil_matches:
            rk = torch.where(rk == _I64_MIN, _I64_MAX, rk)
        rs_keys, _rs = _sort_with_payload(rk, r_oids)
        _, cnt = _probe_counts(rs_keys, lk, l_live, nil_matches=nil_matches)
    return l_oids, n_l, lk, l_live, cnt


def semijoin(l, r, lcand=None, rcand=None, nil_matches=False):
    """BATsemijoin (gdk/gdk_join.c:4347): left oids with ≥1 match, sorted —
    the result doubles as a candidate list over the left."""
    l_oids, n_l, _lk, _live, cnt = _match_counts(l, r, lcand, rcand, nil_matches)
    sel = cnt > 0
    total = int(sel.sum())
    out_cap = capacity_for(total)
    oids = _compact_sel(l_oids, sel, out_cap=out_cap)
    return oids, total


def antijoin(l, r, lcand=None, rcand=None, nil_matches=False):
    """BATdiff (gdk/gdk_join.c:4395): left oids with no match."""
    l_oids, n_l, lk, l_live, cnt = _match_counts(l, r, lcand, rcand, nil_matches)
    sel = (cnt == 0) & l_live
    if not nil_matches:
        # NOT IN-style diff keeps nil lefts out? BATdiff keeps them (nil
        # never matches ⇒ no match ⇒ in the difference). Keep them.
        pass
    total = int(sel.sum())
    out_cap = capacity_for(total)
    oids = _compact_sel(l_oids, sel, out_cap=out_cap)
    return oids, total


def _compact_sel(l_oids, sel, *, out_cap: int):
    si = sel.to(torch.int32)
    idx = torch.cumsum(si, 0) - si
    pos = torch.where(sel, idx, out_cap)
    return set_drop(out_cap, -1, pos, l_oids)


def markjoin(l, r, lcand=None, rcand=None, nil_matches: bool = False):
    """BATmarkjoin (gdk/gdk_join.c:4367): for each left candidate row emit
    (oid, mark) where mark ∈ {1 matched, 0 no match, nil uncertain} — the
    3-valued flag for NOT IN / MARK semantics: a miss is 'uncertain' when
    the left key is nil or the right side contains nils."""
    l_oids, n_l, lk, l_live, cnt = _match_counts(l, r, lcand, rcand,
                                                 nil_matches)
    r_has_nil = (not r.nonil)
    if rcand is not None and not rcand.is_all():
        r_has_nil = r_has_nil  # conservative: candidate may still hit nils
    mark = _mark_flags(cnt, lk, l_live, bool(r_has_nil and not nil_matches),
                       nil_matches)
    return l_oids, mark, n_l


def _mark_flags(cnt, lk, l_live, r_has_nil: bool, nil_matches: bool):
    nil8 = nil_const(torch.int8)
    matched = cnt > 0
    out = matched.to(torch.int8)
    if not nil_matches:
        l_nil = lk == _I64_MIN
        uncertain = (~matched) & (l_nil | r_has_nil)
        out = torch.where(uncertain, nil8, out)
    return torch.where(l_live, out, nil8)
