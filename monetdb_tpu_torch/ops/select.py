"""Selection: the reference's BATselect (gdk/gdk_select.c:1342) as mask
kernels, plus candidate materialization (mask → oid compaction).

The full (tl, th, li, hi, anti, nil_matches) truth table documented at
gdk/gdk_select.c:1280-1340 is reproduced verbatim by :func:`select` — it is
the compiled form of every SQL WHERE predicate. The reference picks between
binary search on sorted columns, hash lookup, and scans; on the device the scan is a
vector compare at memory bandwidth, so the mask-compare is the
default strategy. Nil handling: integer types use the most-negative sentinel
(reference gdk/gdk_atoms.h:156), so predicates that would admit the sentinel
(x < v, x != v, anti ranges) carry an explicit nil guard; float nil is NaN
and fails ordered compares by construction (only != needs the guard).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..column import Cand, Column, capacity_for, valid_mask
from ..dtypes import SQLType
from ._tensor import iota, nilm, set_drop

__all__ = ["select", "thetaselect", "materialize", "compact_mask", "cand_and",
           "cand_or", "cand_not"]

_NIL = object()   # sentinel distinguishing "absent" from an explicit None


# ---------------------------------------------------------------------------
# mask kernel
# ---------------------------------------------------------------------------

# modes whose raw compare would wrongly admit the int nil sentinel (== type
# minimum) or, for !=, any nil; anti modes must always exclude nils
_GUARDED_INT = frozenset({"lt", "le", "ne", "anti_between", "notnil"})
_GUARDED_FLT = frozenset({"ne", "notnil"})


def _range_mask(x, count, base_mask, tl, th, *, mode: str, li: bool, hi: bool,
                guard: bool):
    live = valid_mask(x.shape[0], count, x.device)
    if base_mask is not None:
        live = live & base_mask
    nilmask = nilm(x) if (guard or mode in ("isnil", "notnil")) else None

    if mode == "nothing":
        return torch.zeros_like(live)
    if mode == "all":
        m = torch.ones_like(live)
    elif mode == "isnil":
        return live & nilmask
    elif mode == "notnil":
        return live & ~nilmask
    elif mode == "lt":
        m = x < tl
    elif mode == "le":
        m = x <= tl
    elif mode == "gt":
        m = x > tl
    elif mode == "ge":
        m = x >= tl
    elif mode == "eq":
        m = x == tl
    elif mode == "ne":
        m = x != tl
    elif mode == "between":
        m = ((x >= tl) if li else (x > tl)) & ((x <= th) if hi else (x < th))
    elif mode == "anti_between":
        m = ((x < tl) if li else (x <= tl)) | ((x > th) if hi else (x >= th))
    else:  # pragma: no cover
        raise ValueError(mode)
    if guard:
        m = m & ~nilmask
    return live & m

def _is_nil_host(v, typ: SQLType) -> bool:
    if typ.np_dtype.kind == "f":
        try:
            return np.isnan(v)
        except TypeError:
            return False
    return v == typ.nil


def select(col: Column, cand: Optional[Cand] = None, tl=_NIL, th=None,
           li: bool = True, hi: bool = True, anti: bool = False,
           nil_matches: bool = False) -> Cand:
    """BATselect semantics (truth table gdk/gdk_select.c:1280-1340).

    ``tl``/``th`` are host scalars in the column's *physical* domain (dict
    code for strings, scaled int for decimals, epoch days for dates).
    ``th=None`` is the C NULL (point select); the type's nil sentinel (or
    ``tl=None``) means "unbounded" on that side. Returns a mask candidate.
    """
    typ = col.typ
    base_mask = cand.as_mask(col.cap, col.data.device) if (cand is not None and not cand.is_all()) else None
    may_nil = not col.nonil and typ.np_dtype.kind != "b"
    guarded = _GUARDED_FLT if typ.np_dtype.kind == "f" else _GUARDED_INT

    def run(mode, a=None, b=None, li_=True, hi_=True):
        g = may_nil and not nil_matches and mode in guarded
        # bounds in the column's own type, as the reference casts them
        a = typ.np_dtype.type(0 if a is None else a).item()
        b = typ.np_dtype.type(0 if b is None else b).item()
        m = _range_mask(col.data, col.count, base_mask, a, b,
                        mode=mode, li=li_, hi=hi_, guard=g)
        return Cand.from_mask(m, col.count)

    tl_nil = tl is _NIL or tl is None or _is_nil_host(tl, typ)
    th_null = th is None
    th_nil = (not th_null) and _is_nil_host(th, typ)

    if tl_nil and (th_null or th_nil):
        if nil_matches:
            # nil as ordinary value: point select on nil / its complement
            if th_null and not li and not anti:
                return run("nothing")
            return run("notnil") if anti else run("isnil")
        if th_null:
            if anti:
                return run("notnil")
            return run("isnil") if li else run("nothing")
        # tl nil, th nil
        return run("nothing") if anti else run("notnil")
    if tl_nil:                       # no lower bound: compare against th only
        if anti:
            return run("gt" if hi else "ge", a=th)
        return run("le" if hi else "lt", a=th)
    if th_null:                      # point select on tl
        if not li:
            return run("notnil") if anti else run("nothing")
        return run("ne" if anti else "eq", a=tl)
    if th_nil:                       # no upper bound
        if anti:
            return run("lt" if li else "le", a=tl)
        return run("ge" if li else "gt", a=tl)
    if tl == th:                     # degenerate range = point select
        if li and hi:
            return run("ne" if anti else "eq", a=tl)
        return run("notnil") if anti else run("nothing")
    if tl > th:                      # inverted range
        return run("notnil") if anti else run("nothing")
    if anti:
        return run("anti_between", a=tl, b=th, li_=li, hi_=hi)
    return run("between", a=tl, b=th, li_=li, hi_=hi)


def thetaselect(col: Column, cand: Optional[Cand], val, op: str) -> Cand:
    """BATthetaselect (gdk/gdk_select.c:2103): single-comparison select."""
    if op in ("==", "="):
        return select(col, cand, tl=val, th=None)
    if op in ("!=", "<>"):
        return select(col, cand, tl=val, th=None, anti=True)
    if op == "<":
        return select(col, cand, tl=None, th=val, li=True, hi=False)
    if op == "<=":
        return select(col, cand, tl=None, th=val, li=True, hi=True)
    if op == ">":
        return select(col, cand, tl=val, th=col.typ.nil, li=False, hi=True)
    if op == ">=":
        return select(col, cand, tl=val, th=col.typ.nil, li=True, hi=True)
    raise ValueError(op)


# ---------------------------------------------------------------------------
# candidate algebra & materialization
# ---------------------------------------------------------------------------

def cand_and(a: Cand, b: Cand, cap: int, device) -> Cand:
    if a.is_all():
        return b
    if b.is_all():
        return a
    return Cand.from_mask(a.as_mask(cap, device) & b.as_mask(cap, device),
                          max(a.base_count, b.base_count))


def cand_or(a: Cand, b: Cand, cap: int, device) -> Cand:
    if a.is_all() or b.is_all():
        return Cand.all(max(a.base_count, b.base_count))
    return Cand.from_mask(a.as_mask(cap, device) | b.as_mask(cap, device),
                          max(a.base_count, b.base_count))


def cand_not(a: Cand, cap: int, device) -> Cand:
    """Complement within live rows (caller handles nil semantics)."""
    live = valid_mask(cap, a.base_count, device)
    return Cand.from_mask(live & ~a.as_mask(cap, device), a.base_count)


def _compact(mask, *, out_cap: int):
    """mask → sorted oid list of capacity out_cap (tail = -1)."""
    n = mask.shape[0]
    mi = mask.to(torch.int32)
    idx = torch.cumsum(mi, 0) - mi       # exclusive prefix sum
    pos = torch.where(mask, idx, out_cap)  # out-of-bounds → dropped
    return set_drop(out_cap, -1, pos, iota(n, mask.device))


def compact_mask(mask: torch.Tensor, count: Optional[int] = None):
    """Materialize a mask into (oids, count). One device read for the count
    (the reference's materialization point: every GDK op returns an exact-
    sized BAT; the capacity stays bucketed)."""
    if count is None:
        count = int(mask.sum())
    return _compact(mask, out_cap=capacity_for(count)), count


def materialize(cand: Cand, cap: int, device) -> Cand:
    """Candidate → oid form (inverse of gdk_select.c:30 ``virtualize``)."""
    if cand.kind == "oids":
        return cand
    if cand.kind in ("all", "dense"):
        lo = cand.lo if cand.kind == "dense" else 0
        hi = cand.hi if cand.kind == "dense" else cand.base_count
        n = hi - lo
        out_cap = capacity_for(n)
        oids = iota(out_cap, device) + lo
        oids = torch.where(valid_mask(out_cap, n, device), oids, -1)
        return Cand.from_oids(oids, n, cand.base_count)
    oids, n = compact_mask(cand.mask)
    return Cand.from_oids(oids, n, cand.base_count)
