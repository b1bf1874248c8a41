"""Window / analytic functions — the reference's gdk_analytic family
(gdk/gdk_analytic_bounds.c window bounds for ROWS/RANGE/GROUPS frames,
gdk_analytic_func.c diff/ntile/lag/lead/first/last/nth,
gdk_analytic_statistics.c framed aggregates; segment-tree sliding
aggregates via GDKinitialize_segment_tree gdk/gdk_analytic.h:59).

A window computation is expressed over rows *pre-sorted by (partition,
order)* (the SQL layer emits the sort, as the reference's sql_rank.c does).
Partition boundaries are a diff mask.  torch has no associative scan with a
user combiner, so the primitives are built from what it has:

* partition start / next boundary per row: partition id = cumsum(boundary)
  - 1, each boundary row's index scattered into a per-partition table, then
  gathered by id (no running max, no host read);
* segmented running sum of integers: cumsum minus the prefix at the
  partition start (exact, wrap-around included);
* segmented running min/max and float sums: a doubling pass of
  ceil(log2(cap)) steps, each combining a row with the row 2^k before it
  while that row is in the same partition;
* framed min/max: the levels of a sparse table computed one at a time, each
  row reading the level of its frame length, so memory stays O(rows).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..column import Column, valid_mask
from ..dtypes import BOOL, F64, I64, Kind, decimal
from ._tensor import iota, nil_const, nilm as _nilmask, tdt

__all__ = ["diff", "row_number", "rank", "dense_rank", "ntile",
           "lag", "lead", "first_value", "last_value", "nth_value",
           "cume_window_sum", "percent_rank", "cume_dist",
           "multi_boundary", "first_row_boundary", "windowed_agg",
           "framed_agg"]

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _boundary(parts, count):
    """diff: True at the first row of each partition (GDKanalyticaldiff)."""
    return _multi_boundary((parts,), count)


def diff(part_col: Column) -> Column:
    b = _boundary(part_col.data, part_col.count)
    return Column(BOOL, b, part_col.count, nonil=True)


def _pid(bound):
    """Partition id per row: -1 before the first boundary."""
    return torch.cumsum(bound, 0, dtype=torch.int64) - 1


def _seg_start(bound, pid=None):
    """For each row, index of its partition's first row (0 before the first
    boundary): boundary indices scattered by partition id, gathered back."""
    cap = bound.shape[0]
    if pid is None:
        pid = _pid(bound)
    table = torch.zeros(cap + 1, dtype=torch.int64, device=bound.device)
    table.scatter_(0, torch.where(bound, pid, cap), iota(cap, bound.device))
    return table[pid.clamp(min=0)]


def _next_start(newval):
    """For each row, the index of the next boundary row strictly after it
    (or cap): the start of partition id + 1."""
    cap = newval.shape[0]
    pid = _pid(newval)
    table = torch.full((cap + 2,), cap, dtype=torch.int64,
                       device=newval.device)
    table.scatter_(0, torch.where(newval, pid, cap + 1),
                   iota(cap, newval.device))
    table[cap + 1] = cap
    return table[pid + 1]


def _row_number(bound):
    return iota(bound.shape[0], bound.device) - _seg_start(bound) + 1


def _live_or_nil(col_like: Column, r, nil=_I64_MIN):
    return torch.where(col_like.live_mask(), r, nil)


def row_number(bound: Column) -> Column:
    r = _live_or_nil(bound, _row_number(bound.data))
    return Column(I64, r, bound.count, nonil=True)


def _rank(bound, order_bound):
    """rank: row_number of the first peer row. order_bound marks rows whose
    order-key differs from the previous row (peers share a rank)."""
    return _seg_start(bound | order_bound) - _seg_start(bound) + 1


def rank(part_bound: Column, order_bound: Column) -> Column:
    r = _live_or_nil(part_bound, _rank(part_bound.data, order_bound.data))
    return Column(I64, r, part_bound.count, nonil=True)


def _dense_rank(bound, order_bound):
    run = torch.cumsum(bound | order_bound, 0, dtype=torch.int64)
    pid = _pid(bound)
    # running peer count at the partition's first row (0 before any)
    base = torch.where(pid >= 0, run[_seg_start(bound, pid)], 0)
    return run - base + 1


def dense_rank(part_bound: Column, order_bound: Column) -> Column:
    r = _live_or_nil(part_bound,
                     _dense_rank(part_bound.data, order_bound.data))
    return Column(I64, r, part_bound.count, nonil=True)


def _part_size(bound, count):
    """Partition size broadcast to each row."""
    cap = bound.shape[0]
    live = valid_mask(cap, count, bound.device)
    # partition id = cumsum(bound)-1; sizes via bincount-style scatter
    pid = _pid(bound)
    sizes = torch.zeros(cap + 1, dtype=torch.int64, device=bound.device)
    sizes.index_add_(0, torch.where(live & (pid >= 0), pid, cap),
                     live.to(torch.int64))
    return sizes[pid.clamp(0, cap - 1)], pid


def ntile(part_bound: Column, n: int) -> Column:
    size, _pid_ = _part_size(part_bound.data, part_bound.count)
    rn = _row_number(part_bound.data)
    # SQL ntile: first (size % n) buckets get ceil(size/n) rows; all
    # operands are non-negative, so floor division is truncation
    q = size // n
    r = size % n
    boundary = r * (q + 1)
    idx = rn - 1
    t = torch.where(idx < boundary,
                    idx // (q + 1).clamp(min=1) + 1,
                    r + (idx - boundary) // q.clamp(min=1) + 1)
    return Column(I64, _live_or_nil(part_bound, t), part_bound.count,
                  nonil=True)


def _shift(x, bound, nil, *, offset: int):
    cap = x.shape[0]
    src = iota(cap, x.device) - offset
    pid = _pid(bound)
    ok = (src >= 0) & (src < cap)
    safe = src.clamp(0, cap - 1)
    same_part = pid[safe] == pid
    return torch.where(ok & same_part, x[safe], nil)


def lag(col: Column, part_bound: Column, offset: int = 1,
        default=None) -> Column:
    nil = default if default is not None else col.typ.nil
    v = _shift(col.data, part_bound.data, col.typ.np_dtype.type(nil).item(),
               offset=offset)
    v = torch.where(col.live_mask(), v, nil_const(col.data.dtype))
    return Column(col.typ, v, col.count, nonil=False, sdict=col.sdict)


def lead(col: Column, part_bound: Column, offset: int = 1,
         default=None) -> Column:
    return lag(col, part_bound, offset=-offset, default=default)


def first_value(col: Column, part_bound: Column) -> Column:
    v = col.data[_seg_start(part_bound.data)]
    v = torch.where(col.live_mask(), v, nil_const(col.data.dtype))
    return Column(col.typ, v, col.count, nonil=col.nonil, sdict=col.sdict)


def last_value(col: Column, part_bound: Column) -> Column:
    """last_value with default frame (up to current row) = current value;
    with full-partition frame = value at partition end."""
    size, pid = _part_size(part_bound.data, part_bound.count)
    start = _seg_start(part_bound.data, pid)
    v = col.data[(start + size - 1).clamp(0, col.cap - 1)]
    v = torch.where(col.live_mask(), v, nil_const(col.data.dtype))
    return Column(col.typ, v, col.count, nonil=col.nonil, sdict=col.sdict)


def nth_value(col: Column, part_bound: Column, n: int) -> Column:
    """nth_value(col, n) under the default frame (unbounded preceding →
    current row): nil before the nth row of the partition, the nth row's
    value from there on (GDKanalytical_nth_value,
    gdk/gdk_analytic_func.c)."""
    start = _seg_start(part_bound.data)
    rn = iota(col.cap, col.data.device) - start   # 0-based row in partition
    v = col.data[(start + (n - 1)).clamp(0, col.cap - 1)]
    nil = nil_const(col.data.dtype)
    v = torch.where((rn >= n - 1) & col.live_mask(), v, nil)
    return Column(col.typ, v, col.count, nonil=False, sdict=col.sdict)


def _prefix_from_start(cs, start):
    """Inclusive prefix sums ``cs`` restarted at each row's partition start."""
    cap = cs.shape[0]
    base = torch.where(start > 0, cs[(start - 1).clamp(0, cap - 1)], 0)
    return cs - base


def cume_window_sum(col: Column, part_bound: Column) -> Column:
    """Running sum within partition (ROWS UNBOUNDED PRECEDING..CURRENT)."""
    is_f = col.typ.np_dtype.kind == "f"
    x = col.data.to(torch.float64 if is_f else torch.int64)
    xz = torch.where(_nilmask(x), 0, x)
    out = _prefix_from_start(torch.cumsum(xz, 0),
                             _seg_start(part_bound.data))
    out = torch.where(col.live_mask(), out, nil_const(x.dtype))
    typ = F64 if is_f else I64
    if col.typ.kind == Kind.DECIMAL:
        typ = decimal(18, col.typ.scale)
    return Column(typ, out, col.count, nonil=False)


def percent_rank(part_bound: Column, order_bound: Column) -> Column:
    r = _rank(part_bound.data, order_bound.data)
    size, _ = _part_size(part_bound.data, part_bound.count)
    v = torch.where(size > 1, (r - 1).to(torch.float64) /
                    (size - 1).clamp(min=1), 0.0)
    v = _live_or_nil(part_bound, v, float("nan"))
    return Column(F64, v, part_bound.count, nonil=True)


def cume_dist(part_bound: Column, order_bound: Column) -> Column:
    """count of peers ≤ current / partition size."""
    bound = part_bound.data
    newval = bound | order_bound.data
    size, pid = _part_size(bound, part_bound.count)
    start = _seg_start(bound, pid)
    # clamp to partition end
    peer_end = torch.minimum(_next_start(newval), start + size)
    v = (peer_end - start).to(torch.float64) / size.clamp(min=1)
    v = _live_or_nil(part_bound, v, float("nan"))
    return Column(F64, v, part_bound.count, nonil=True)


# ---------------------------------------------------------------------------
# framed aggregates (gdk_analytic_statistics.c: GDKanalytical{sum,avg,min,...}
# over ROWS/RANGE frames, with prefix scans replacing the segment tree for
# unbounded-preceding frames)
# ---------------------------------------------------------------------------


def _multi_boundary(datas, count):
    cap = datas[0].shape[0]
    b = torch.zeros(cap, dtype=torch.bool, device=datas[0].device)
    b[0] = True
    for x in datas:
        b = b | (x != torch.roll(x, 1))
    return b & valid_mask(cap, count, b.device)


def multi_boundary(cols, count: int) -> Column:
    """True at each row whose (col tuple) differs from the previous row —
    the n-ary GDKanalyticaldiff chain (gdk_analytic_func.c)."""
    if not cols:
        raise ValueError("multi_boundary needs ≥1 column")
    b = _multi_boundary(tuple(c.data for c in cols), count)
    return Column(BOOL, b, count, nonil=True)


def first_row_boundary(cap: int, count: int, device) -> Column:
    """Single-partition boundary: True only at row 0."""
    b = (iota(cap, device) == 0) & valid_mask(cap, count, device)
    return Column(BOOL, b, count, nonil=True)


def _seg_scan(v, bound, *, op: str):
    """Segmented inclusive scan: restart at each True boundary."""
    start = _seg_start(bound)
    if op == "sum" and not v.dtype.is_floating_point:
        return _prefix_from_start(torch.cumsum(v, 0), start)
    f = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}[op]
    cap = v.shape[0]
    io = iota(cap, v.device)
    out = v
    d = 1
    while d < cap:
        # out[i] covers [max(start, i - d + 1), i]; joining the span that
        # ends at i - d doubles it while that row is in the same partition
        out = torch.where(io - d >= start, f(out, torch.roll(out, d)), out)
        d *= 2
    return out


def _part_reduce(v, pid, live, *, op: str, cap: int):
    """Full-partition reduce: scatter into per-partition slots, gather back."""
    safe = torch.where(live & (pid >= 0), pid, cap)
    if op == "sum":
        acc = torch.zeros(cap + 1, dtype=v.dtype, device=v.device)
        acc.index_add_(0, safe, torch.where(live, v, 0))
    else:
        is_min = op == "min"
        if v.dtype.is_floating_point:
            ident = float("inf") if is_min else float("-inf")
        else:
            info = torch.iinfo(v.dtype)
            ident = info.max if is_min else info.min
        acc = torch.full((cap + 1,), ident, dtype=v.dtype, device=v.device)
        acc.scatter_reduce_(0, safe, torch.where(live, v, ident),
                            reduce="amin" if is_min else "amax")
    return acc[pid.clamp(0, cap)]


def _agg_inputs(col: Optional[Column], live):
    """(is_float, nil mask, values with nils zeroed, non-nil counters)."""
    cap = live.shape[0]
    if col is None:
        xv = live.to(torch.int64)
        return False, torch.zeros_like(live), xv, xv
    x = col.data
    is_f = x.dtype.is_floating_point
    nilm = _nilmask(x) if not col.nonil else torch.zeros_like(live)
    skip = nilm | ~live
    xv = torch.where(skip, 0, x.to(torch.float64 if is_f else torch.int64))
    return is_f, nilm, xv, (~skip).to(torch.int64)


def _finish_agg(func, col, live, sums, cnts, vals, is_f, count,
                bool_minmax: bool, extra_empty=None):
    """Shared tail of windowed_agg/framed_agg: nil rules and result type."""
    if func in ("count", "count_star"):
        return Column(I64, torch.where(live, cnts, _I64_MIN), count,
                      nonil=True)
    if func == "avg":
        scale = col.typ.scale if col.typ.kind == Kind.DECIMAL else 0
        f = sums.to(torch.float64)
        if scale:
            f = f / (10.0 ** scale)
        a = f / cnts.clamp(min=1)
        out = torch.where(live & (cnts > 0), a, float("nan"))
        return Column(F64, out, count, nonil=False)
    empty = cnts == 0
    if func == "sum":
        if is_f:
            out = torch.where(live & ~empty, sums, float("nan"))
            return Column(F64, out, count, nonil=False)
        out = torch.where(live & ~empty, sums, _I64_MIN)
        typ = decimal(18, col.typ.scale) if col.typ.kind == Kind.DECIMAL \
            else I64
        return Column(typ, out, count, nonil=False)
    if func in ("min", "max"):
        if extra_empty is not None:
            empty = empty | extra_empty
        if is_f:
            out = torch.where(live & ~empty, vals, float("nan"))
            return Column(F64, out, count, nonil=False)
        if bool_minmax and col.typ.np_dtype.kind == "b":
            # bool columns cannot hold nil (the tri-state gap)
            out = torch.where(live & ~empty, vals, _I64_MIN)
            return Column(col.typ, out.to(torch.bool), count, nonil=True)
        # nil in the OUTPUT type's domain: casting the int64 sentinel to
        # a narrower type would truncate to 0, not the narrow nil
        out_dt = tdt(col.typ.np_dtype)
        nil_t = nil_const(out_dt) if bool_minmax else _I64_MIN
        out = torch.where(live & ~empty, vals, nil_t)
        return Column(col.typ, out.to(out_dt), count, nonil=False,
                      sdict=col.sdict)
    raise ValueError(func)


def windowed_agg(func: str, col: Optional[Column], part_bound: Column,
                 order_bound: Optional[Column], frame: str,
                 count: int) -> Column:
    """sum/count/avg/min/max/count_star over UNBOUNDED-PRECEDING frames.

    frame 'rows'  → through the current row;
          'range' → through the current row's last order-peer;
          'full'  → whole partition.
    Nil handling follows SQL aggregates: nils are skipped; an all-nil
    (or empty) frame yields nil. Inputs live on the (partition, order)
    pre-sorted row domain; the caller unsorts the result.
    """
    bound = part_bound.data
    cap = part_bound.cap
    live = valid_mask(cap, count, bound.device)
    is_f, nilm, xv, ones = _agg_inputs(col, live)
    minmax = func in ("min", "max")
    vals = None
    if minmax:
        xi = torch.where(nilm | ~live, _mm_identity(is_f, func), xv)

    if frame == "full":
        pid = _pid(bound)
        sums = _part_reduce(xv, pid, live, op="sum", cap=cap)
        cnts = _part_reduce(ones, pid, live, op="sum", cap=cap)
        if minmax:
            vals = _part_reduce(xi, pid, live, op=func, cap=cap)
    else:
        sums = _seg_scan(xv, bound, op="sum")
        cnts = _seg_scan(ones, bound, op="sum")
        if minmax:
            vals = _seg_scan(xi, bound, op=func)
        if frame == "range" and order_bound is not None:
            peer_last = _next_start(bound | order_bound.data) - 1
            idx = peer_last.clamp(0, cap - 1)
            sums = sums[idx]
            cnts = cnts[idx]
            if minmax:
                vals = vals[idx]
    return _finish_agg(func, col, live, sums, cnts, vals, is_f, count,
                       bool_minmax=True)


def _mm_identity(is_f: bool, func: str):
    if is_f:
        return float("inf") if func == "min" else float("-inf")
    return _I64_MAX if func == "min" else _I64_MIN + 1


# ---------------------------------------------------------------------------
# explicit frames — ROWS/RANGE/GROUPS BETWEEN lo AND hi
# (gdk/gdk_analytic_bounds.c GDKanalyticalwindowbounds :1440; the sliding
# min/max answers arbitrary [s,e) range queries from sparse-table levels
# instead of the reference's segment tree: two gathers per row and level)
# ---------------------------------------------------------------------------


def _part_lower_bound(vals, lo0, hi0, target, *, n_iter: int, strict: bool):
    """Vectorized per-row binary search: smallest j in [lo0, hi0) with
    vals[j] >= target (or > target when strict). vals must be ascending
    within each row's [lo0, hi0) slice."""
    cap = vals.shape[0]
    lo, hi = lo0, hi0
    for _ in range(n_iter):
        # lo, hi >= 0, so floor division is truncation
        mid = (lo + hi) // 2
        v = vals[mid.clamp(0, cap - 1)]
        go = (v <= target) if strict else (v < target)
        active = lo < hi
        lo, hi = (torch.where(active & go, mid + 1, lo),
                  torch.where(active & ~go, mid, hi))
    return lo


def _floor_log2(n):
    """floor(log2(n)) for n >= 1, exact (float estimate + correction)."""
    k = torch.floor(torch.log2(n.clamp(min=1).to(torch.float64))
                    ).to(torch.int64)
    one = torch.ones_like(k)
    k = torch.where((one << k) > n, k - 1, k)
    k = torch.where((one << (k + 1)) <= n, k + 1, k)
    return k.clamp(min=0)


def _range_minmax(x, s, e, *, op: str, levels: int):
    """op(x[s:e]) per row via two overlapping power-of-two blocks of sparse
    table level floor(log2(e - s)); level k is T[k][i] = op(x[i : i+2^k]),
    built from level k - 1 and dropped once the rows of that level have
    read it."""
    cap = x.shape[0]
    f = torch.minimum if op == "min" else torch.maximum
    io = iota(cap, x.device)
    k = _floor_log2((e - s).clamp(min=1))
    s_c = s.clamp(0, cap - 1)
    cur = x
    out = x
    for lev in range(levels):
        if lev:
            cur = f(cur, cur[(io + (1 << (lev - 1))).clamp(max=cap - 1)])
        ab = f(cur[s_c], cur[(e - (1 << lev)).clamp(0, cap - 1)])
        out = torch.where(k == lev, ab, out)
    return out


def framed_agg(func: str, col: Optional[Column], part_bound: Column,
               order_vals: Optional[torch.Tensor], unit: str,
               lo, hi, count: int) -> Column:
    """Aggregate over explicit frames [lo, hi] per row (negative =
    PRECEDING, positive = FOLLOWING, None = UNBOUNDED). unit:
      'rows'   — physical row offsets
      'groups' — peer-group offsets (order_vals required)
      'range'  — order-value deltas (single ascending order key required;
                 the caller negates values for DESC order)
    Inputs live on the (partition, order) pre-sorted domain."""
    bound = part_bound.data
    cap = part_bound.cap
    live = valid_mask(cap, count, bound.device)
    io = iota(cap, bound.device)

    size, pid = _part_size(bound, count)
    part_start = _seg_start(bound, pid)
    part_end = part_start + size                      # exclusive
    n_iter = max(int(math.ceil(math.log2(max(cap, 2)))) + 1, 1)

    def search(vals, delta, strict):
        return _part_lower_bound(vals, part_start, part_end,
                                 vals + int(delta), n_iter=n_iter,
                                 strict=strict)

    if unit == "rows":
        s = part_start if lo is None else \
            torch.maximum(part_start, io + int(lo))
        e = part_end if hi is None else \
            torch.minimum(part_end, io + int(hi) + 1)
    elif unit in ("groups", "range"):
        if order_vals is None:
            raise ValueError(f"{unit.upper()} frame requires ORDER BY")
        if unit == "groups":
            ob = _multi_boundary((order_vals,), count)
            v = _dense_rank(bound, ob) - 1            # 0-based peer group
        else:
            v = order_vals if order_vals.dtype.is_floating_point \
                else order_vals.to(torch.int64)
        s = part_start if lo is None else search(v, lo, False)
        e = part_end if hi is None else search(v, hi, True)
    else:  # pragma: no cover
        raise ValueError(unit)
    s = torch.maximum(s, part_start)
    e = torch.minimum(e, part_end)
    empty_frame = e <= s

    # per-row values with nils zeroed + non-nil counters
    is_f, nilm, xv, ones = _agg_inputs(col, live)

    def range_sum(pref):
        hi_v = pref[(e - 1).clamp(0, cap - 1)]
        lo_v = torch.where(s > 0, pref[(s - 1).clamp(0, cap - 1)], 0)
        return torch.where(empty_frame, 0, hi_v - lo_v)

    sums = range_sum(torch.cumsum(xv, 0))
    cnts = range_sum(torch.cumsum(ones, 0))
    vals = None
    if func in ("min", "max"):
        xi = torch.where(nilm | ~live, _mm_identity(is_f, func), xv)
        vals = _range_minmax(xi, s, e, op=func, levels=n_iter)
    return _finish_agg(func, col, live, sums, cnts, vals, is_f, count,
                       bool_minmax=False, extra_empty=empty_frame)
