"""Grouped aggregates — the reference's gdk_aggr.c family: BATgroupsum
(:900), BATgroupprod (:1575), BATgroupavg (:1801) + the exact 2-phase
decimal average BATgroupavg3/avg3combine (:1996/:2634), BATgroupcount
(:3069), BATgroupmin/max (:3561/:3720), quantiles (:4233) — as segmented
reductions over per-row group ids.

All take ``skip_nils`` (SQL aggregates skip nils; ``count(*)`` counts rows).
When ``skip_nils`` is false, any nil in a group makes that group's result
nil — preserved via a per-group nil-presence reduction.

The distributed decomposition the reference uses for partitioned plans
(mat_grp two-phase aggregation, monetdb5/optimizer/opt_mergetable.c:15-27)
falls out naturally: every aggregate here returns partials that combine
with a plain segment-add/min/max across shards (see parallel/), and
``avg`` keeps the exact (sum, count) pair like BATgroupavg3.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..column import Column, valid_mask
from ..dtypes import F64, I64, SQLType, Kind
from ._tensor import lexsort, nil_const, nilm as _nilmask, tdt
from .group import GroupResult

__all__ = ["group_sum", "group_count", "group_avg", "group_min", "group_max",
           "group_prod", "scalar_sum", "scalar_count", "scalar_avg",
           "scalar_min", "scalar_max", "group_var", "group_stdev",
           "group_quantile", "group_median", "group_covar", "group_corr",
           "group_concat_host"]


# ---------------------------------------------------------------------------
# core segmented reduction kernel
# ---------------------------------------------------------------------------

def _seg_add(sid, vals, seg_cap: int):
    """Per-segment sum into seg_cap slots; rows with sid == seg_cap land in
    a spare last slot that is cut off (torch has no dropped scatter)."""
    out = torch.zeros(seg_cap + 1, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, sid, vals)[:seg_cap]


def _seg_scatter(sid, vals, seg_cap: int, fill, reduce: str):
    out = torch.full((seg_cap + 1,), fill, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, sid, vals, reduce=reduce)[:seg_cap]


def _seg_reduce(x, ids, count, *, op: str, seg_cap: int, skip_nils: bool,
                may_nil: bool, acc_dtype, check: bool):
    cap = ids.shape[0]
    dev = ids.device
    live = valid_mask(cap, count, dev) & (ids >= 0)
    nilm = _nilmask(x) if may_nil else \
        torch.zeros(cap, dtype=torch.bool, device=dev)
    use = live & ~nilm
    ids64 = ids.to(torch.int64)
    sid = torch.where(use, ids64, seg_cap)
    err = None

    if op == "count":
        w = live if not skip_nils else use
        out = _seg_add(torch.where(w, ids64, seg_cap), w.to(torch.int64),
                       seg_cap)
        nil_in_group = torch.zeros(seg_cap, dtype=torch.bool, device=dev)
        return out, out, nil_in_group, err

    xa = x.to(acc_dtype)
    is_f = acc_dtype.is_floating_point
    if op == "sum":
        out = _seg_add(sid, torch.where(use, xa, 0), seg_cap)
        if check and not is_f and x.dtype == torch.int64:
            # running int64 sums can overflow: re-check via float magnitude
            fsum = _seg_add(sid, torch.where(use, x.to(torch.float64), 0.0),
                            seg_cap)
            err = (torch.abs(fsum) > 9.1e18).any()
    elif op == "prod":
        # sequential segment product via multiplicative scatter
        out = _seg_scatter(sid, torch.where(use, xa, 1), seg_cap, 1, "prod")
    elif op == "min":
        big = float("inf") if is_f else torch.iinfo(acc_dtype).max
        out = _seg_scatter(sid, torch.where(use, xa, big), seg_cap, big,
                           "amin")
    elif op == "max":
        small = float("-inf") if is_f else torch.iinfo(acc_dtype).min
        out = _seg_scatter(sid, torch.where(use, xa, small), seg_cap, small,
                           "amax")
    else:  # pragma: no cover
        raise ValueError(op)

    cnt = _seg_add(sid, use.to(torch.int64), seg_cap)
    lid = torch.where(live, ids64, seg_cap)
    nil_in_group = _seg_scatter(lid, (nilm & live).to(torch.uint8), seg_cap,
                                0, "amax").to(torch.bool)
    return out, cnt, nil_in_group, err


def _fix_empty_and_nil(out, cnt, nil_in_group):
    """Empty group or (non-skip_nils) nil-containing group ⇒ nil result."""
    bad = (cnt == 0) | nil_in_group
    return torch.where(bad, nil_const(out.dtype), out)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _acc_type(typ: SQLType, op: str) -> SQLType:
    if op in ("min", "max"):
        return typ
    if typ.np_dtype.kind == "f":
        return F64
    if typ.kind == Kind.DECIMAL:
        from ..dtypes import decimal
        return decimal(18, typ.scale)
    return I64


def _reduce_col(op, col, g, out_typ, skip_nils, check=False):
    out, cnt, nig, err = _seg_reduce(
        col.data, g.ids, g.base_count, op=op,
        seg_cap=g.seg_cap, skip_nils=skip_nils, may_nil=not col.nonil,
        acc_dtype=tdt(out_typ.np_dtype), check=check)
    nig = nig if not skip_nils else torch.zeros_like(nig)
    return out, cnt, nig, err


def group_sum(col: Column, g: GroupResult, skip_nils: bool = True,
              check_overflow: bool = True) -> Column:
    """BATgroupsum (gdk/gdk_aggr.c:900). Accumulates in int64/f64."""
    out_typ = _acc_type(col.typ, "sum")
    out, cnt, nig, err = _reduce_col("sum", col, g, out_typ, skip_nils,
                                     check_overflow)
    if check_overflow and err is not None and bool(err):
        from .calc import CalcOverflow
        raise CalcOverflow("22003!overflow in sum aggregate")
    res = _fix_empty_and_nil(out, cnt, nig)
    return Column(out_typ, res, g.ngroups, nonil=False)


def group_count(col: Optional[Column], g: GroupResult,
                skip_nils: bool = True) -> Column:
    """BATgroupcount; col=None = count(*) (counts candidate rows)."""
    if col is None:
        x = torch.zeros(len(g.ids), dtype=torch.int8, device=g.ids.device)
        may_nil = False
        skip = False
    else:
        x, may_nil, skip = col.data, not col.nonil, skip_nils
    out, _, _, _ = _seg_reduce(x, g.ids, g.base_count, op="count",
                               seg_cap=g.seg_cap, skip_nils=skip,
                               may_nil=may_nil, acc_dtype=torch.int64,
                               check=False)
    return Column(I64, out, g.ngroups, nonil=True)


def group_avg(col: Column, g: GroupResult, skip_nils: bool = True):
    """BATgroupavg (gdk/gdk_aggr.c:1801): returns float64 average; also
    returns the exact (sum, count) pair — the associative decomposition of
    BATgroupavg3 (:1996) used for distributed combining."""
    sum_typ = _acc_type(col.typ, "sum")
    out, cnt, nig2, _ = _reduce_col("sum", col, g, sum_typ, skip_nils)
    avg = _avg_div(out, cnt, nig2,
                   scale=col.typ.scale if col.typ.kind == Kind.DECIMAL else 0)
    sums = _fix_empty_and_nil(out, cnt, nig2)
    return (Column(F64, avg, g.ngroups, nonil=False),
            Column(sum_typ, sums, g.ngroups, nonil=False),
            Column(I64, cnt, g.ngroups, nonil=True))


def _avg_div(s, cnt, nil_in_group, *, scale: int = 0):
    f = s.to(torch.float64)
    if scale:
        f = f / (10.0 ** scale)
    a = f / cnt.clamp(min=1)
    return torch.where((cnt == 0) | nil_in_group, float("nan"), a)


def _minmax(op, col: Column, g: GroupResult, skip_nils=True) -> Column:
    out, cnt, nig, _ = _reduce_col(op, col, g, col.typ, skip_nils)
    res = _fix_empty_and_nil(out, cnt, nig)
    return Column(col.typ, res, g.ngroups, nonil=False, sdict=col.sdict)


def group_min(col, g, skip_nils=True):
    """BATgroupmin (gdk/gdk_aggr.c:3561)."""
    return _minmax("min", col, g, skip_nils)


def group_max(col, g, skip_nils=True):
    """BATgroupmax (gdk/gdk_aggr.c:3720)."""
    return _minmax("max", col, g, skip_nils)


def group_prod(col, g, skip_nils=True):
    out_typ = _acc_type(col.typ, "sum")
    out, cnt, nig, _ = _reduce_col("prod", col, g, out_typ, skip_nils)
    res = _fix_empty_and_nil(out, cnt, nig)
    return Column(out_typ, res, g.ngroups, nonil=False)


# ---------------------------------------------------------------------------
# scalar (ungrouped) aggregates — single-group reduction
# ---------------------------------------------------------------------------

def _one_group(col: Column, cand=None) -> GroupResult:
    dev = col.data.device
    if cand is not None and not cand.is_all():
        m = cand.as_mask(col.cap, dev)
    else:
        m = valid_mask(col.cap, col.count, dev)
    return GroupResult(torch.where(m, 0, -1).to(torch.int32), 1, col.count)


def scalar_sum(col, cand=None, skip_nils=True):
    return group_sum(col, _one_group(col, cand), skip_nils)


def scalar_count(col=None, cand=None, skip_nils=True, base=None):
    """count(col) or count(*) (col=None; ``base`` supplies the row shape)."""
    ref = col if col is not None else base
    g = _one_group(ref, cand)
    return group_count(col, g, skip_nils)


def scalar_avg(col, cand=None, skip_nils=True):
    return group_avg(col, _one_group(col, cand), skip_nils)


def scalar_min(col, cand=None):
    return group_min(col, _one_group(col, cand))


def scalar_max(col, cand=None):
    return group_max(col, _one_group(col, cand))


# ---------------------------------------------------------------------------
# statistical aggregates (gdk_aggr.c: BATgroupvariance/stdev :~2800,
# BATgroupmedian/quantile :4233) — two-pass moments and sort-based quantiles
# ---------------------------------------------------------------------------


def _use_sid(x_nil, ids, count, seg_cap):
    live = valid_mask(ids.shape[0], count, ids.device) & (ids >= 0)
    use = live & ~x_nil
    return use, torch.where(use, ids.to(torch.int64), seg_cap)


def _var_kernel(x, ids, count, *, seg_cap: int, sample: bool):
    use, sid = _use_sid(_nilmask(x), ids, count, seg_cap)
    xf = torch.where(use, x.to(torch.float64), 0.0)
    s1 = _seg_add(sid, xf, seg_cap)
    s2 = _seg_add(sid, xf * xf, seg_cap)
    n = _seg_add(sid, use.to(torch.int64), seg_cap)
    denom = (n - 1).clamp(min=1) if sample else n.clamp(min=1)
    var = (s2 - s1 * s1 / n.clamp(min=1)) / denom
    var = var.clamp(min=0.0)  # fp guard
    bad = (n <= 1) if sample else (n == 0)
    return torch.where(bad, float("nan"), var), n


def group_var(col: Column, g: GroupResult, sample: bool = True,
              skip_nils: bool = True) -> Column:
    """BATgroupvariance; scale-aware for decimals (divides by 10^2s)."""
    var, _ = _var_kernel(col.data, g.ids, g.base_count,
                         seg_cap=g.seg_cap, sample=sample)
    if col.typ.kind == Kind.DECIMAL and col.typ.scale:
        var = var / (10.0 ** (2 * col.typ.scale))
    return Column(F64, var, g.ngroups, nonil=False)


def group_stdev(col: Column, g: GroupResult, sample: bool = True,
                skip_nils: bool = True) -> Column:
    v = group_var(col, g, sample, skip_nils)
    return Column(F64, torch.sqrt(v.data), g.ngroups, nonil=False)


def _quantile_kernel(x, ids, count, q: float, *, seg_cap: int):
    """Sort (gid, value) then gather the interpolated q-position per group."""
    cap = ids.shape[0]
    use, gid = _use_sid(_nilmask(x), ids, count, seg_cap)
    key = torch.where(use, x.to(torch.float64), float("inf"))
    v_s = key[lexsort([gid, key])]
    # group start offsets + counts
    n = _seg_add(gid, use.to(torch.int64), seg_cap)
    starts = torch.cumsum(n, 0) - n
    pos = q * (n - 1).clamp(min=0).to(torch.float64)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(torch.float64)
    vlo = v_s[(starts + lo).clamp(0, cap - 1)]
    vhi = v_s[(starts + hi).clamp(0, cap - 1)]
    out = vlo + (vhi - vlo) * frac
    return torch.where(n == 0, float("nan"), out)


def group_quantile(col: Column, g: GroupResult, q: float) -> Column:
    """BATgroupquantile_avg (gdk/gdk_aggr.c:4233): interpolated quantile."""
    out = _quantile_kernel(col.data, g.ids, g.base_count, float(q),
                           seg_cap=g.seg_cap)
    if col.typ.kind == Kind.DECIMAL and col.typ.scale:
        out = out / (10.0 ** col.typ.scale)
    return Column(F64, out, g.ngroups, nonil=False)


def group_median(col: Column, g: GroupResult) -> Column:
    return group_quantile(col, g, 0.5)


def _covar_kernel(x, y, ids, count, *, seg_cap: int, sample: bool,
                  want: str):
    """Per-group covariance/correlation moments (BATgroupcovariance/
    BATgroupcorrelation, gdk/gdk_aggr.c ~2900): rows where either side is
    nil are skipped, matching the reference's pairwise nil rule."""
    use, sid = _use_sid(_nilmask(x) | _nilmask(y), ids, count, seg_cap)
    xf = torch.where(use, x.to(torch.float64), 0.0)
    yf = torch.where(use, y.to(torch.float64), 0.0)

    def seg(v):
        return _seg_add(sid, v, seg_cap)

    n = seg(use.to(torch.int64))
    nf = n.clamp(min=1).to(torch.float64)
    sx, sy = seg(xf), seg(yf)
    sxy = seg(xf * yf)
    cov_n = sxy - sx * sy / nf
    if want == "covar":
        denom = (n - 1).clamp(min=1) if sample else n
        out = cov_n / denom.clamp(min=1).to(torch.float64)
        bad = (n <= 1) if sample else (n == 0)
        return torch.where(bad, float("nan"), out)
    sxx = seg(xf * xf) - sx * sx / nf
    syy = seg(yf * yf) - sy * sy / nf
    denom = torch.sqrt((sxx * syy).clamp(min=0.0))
    out = cov_n / torch.where(denom == 0, 1.0, denom)
    return torch.where((n == 0) | (denom == 0), float("nan"), out)


def group_covar(col: Column, col2: Column, g: GroupResult,
                sample: bool = True) -> Column:
    """BATgroupcovariance_{sample,population} (gdk/gdk_aggr.c)."""
    out = _covar_kernel(col.data, col2.data, g.ids, g.base_count,
                        seg_cap=g.seg_cap, sample=sample, want="covar")
    s = (col.typ.scale if col.typ.kind == Kind.DECIMAL else 0) + \
        (col2.typ.scale if col2.typ.kind == Kind.DECIMAL else 0)
    if s:
        out = out / (10.0 ** s)
    return Column(F64, out, g.ngroups, nonil=False)


def group_corr(col: Column, col2: Column, g: GroupResult) -> Column:
    """BATgroupcorrelation — scale-invariant, no decimal adjustment."""
    out = _covar_kernel(col.data, col2.data, g.ids, g.base_count,
                        seg_cap=g.seg_cap, sample=True, want="corr")
    return Column(F64, out, g.ngroups, nonil=False)


def group_concat_host(col: Column, g: GroupResult, sep: str = ",") -> Column:
    """GROUP_CONCAT / LISTAGG (reference sql_aggr_str concat aggregate) —
    host-side over decoded strings (string building is inherently
    sequential; the group ids and codes come off-device in one transfer)."""
    ids = g.ids.cpu().numpy()
    n = int(g.base_count)
    ng = int(g.ngroups)
    raw = col.data[:n].cpu().numpy()
    if col.sdict is not None:
        vals = [None if c < 0 else str(col.sdict.values[c]) for c in raw]
    else:
        from ..dtypes import is_nil_np
        nil = is_nil_np(raw, col.typ)
        vals = [None if nil[i] else str(raw[i]) for i in range(n)]
    parts: list = [[] for _ in range(ng)]
    for i in range(n):
        gid = ids[i]
        if gid >= 0 and vals[i] is not None:
            parts[gid].append(vals[i])
    out = [sep.join(p) if p else None for p in parts]
    from ..storage.columns import column_from_pyvalues
    from ..dtypes import varchar
    return column_from_pyvalues(out, varchar(), device=col.data.device)
