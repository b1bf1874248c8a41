"""Plan executor: logical Rel tree → device kernel pipeline.

The reference compiles sql_rel to MAL instructions (rel_bin.c:7599 subrel_bin)
and interprets them (mal_interpreter.c:491), each instruction calling one GDK
operator. Here the two layers collapse: the executor walks the Rel tree and
calls the ops.* kernels directly, carrying a Frame (aligned column family) up
the tree. Candidate/mask threading happens inside predicate evaluation (the
opt_pushselect/opt_candidates analog); materialization points are explicit
(one device read per data-dependent cardinality, mirroring the reference's
operator-at-a-time full materialization).

Decimal semantics follow the reference's SQL rules (sql/common/sql_types.c):
add/sub align scales, mul adds scales, div goes through double; all decimal
arithmetic is exact scaled-int64 on device with overflow checks.

Every tensor an operator creates lives on the executor's device: the one
device that holds all of the catalog's tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
from decimal import Decimal as PyDecimal
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import config
from ..column import Cand, Column, StrDict, capacity_for, valid_mask
from ..dtypes import (BOOL, DATE, F64, I8, I32, I64, OID, Kind, SQLType,
                      decimal as dec_t)
from ..plan import logical as L
from ..plan.exprs import (Between, BinOp, BoolOp, Case, Cast, Cmp, ColRef,
                          Const, Expr, Func, InList, IsNull, Like, Not,
                          Subquery, WinRef, walk)
from ..table import Catalog
from ..ops import aggr as A
from ..ops import calc as C
from ..ops import datecalc as DT
from ..ops import group as G
from ..ops import join as J
from ..ops import project as P
from ..ops import select as S
from ..ops import sort as SRT
from ..ops import strfuncs as SF
from ..ops import window as W
from ..ops._tensor import (catalog_device, iota, nil_const, nilm, set_drop,
                           tdt)

__all__ = ["Executor", "Frame", "Scalar", "ExecError"]


class ExecError(Exception):
    pass


# ---------------------------------------------------------------------------
# runtime values
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Scalar:
    """Host scalar in *physical* domain (scaled int for decimals, epoch days
    for dates, raw str for strings — dict lookup happens at the use site)."""
    value: object
    typ: SQLType

    @property
    def scale(self) -> int:
        return self.typ.scale if self.typ and self.typ.kind == Kind.DECIMAL else 0

    def is_float(self) -> bool:
        return self.typ is not None and self.typ.np_dtype.kind == "f"


@dataclasses.dataclass
class Frame:
    """Aligned column family — all columns share count and capacity.
    Rows are implicitly numbered 0..count-1 (live prefix of the arrays)."""
    cols: Dict[Tuple[str, str], Column]
    count: int

    @property
    def cap(self) -> int:
        if not self.cols:
            return capacity_for(self.count)
        return next(iter(self.cols.values())).cap

    def get(self, table: Optional[str], name: str) -> Column:
        if table is not None:
            c = self.cols.get((table, name))
            if c is not None:
                return c
        hits = [c for (t, n), c in self.cols.items() if n == name]
        if len(hits) == 1:
            return hits[0]
        raise ExecError(f"column {table}.{name} not in frame "
                        f"(have {list(self.cols)[:8]}...)")

    def gather(self, oids: torch.Tensor, n: int,
               right_nil: bool = False) -> "Frame":
        out = {}
        for k, c in self.cols.items():
            pc = P.project_oids(oids, n, c)
            if right_nil:
                pc = pc.with_props(nonil=False)
            out[k] = pc
        return Frame(out, n)

    def rename(self, alias: str) -> "Frame":
        return Frame({(alias, n): c for (_t, n), c in self.cols.items()},
                     self.count)

    def merged(self, other: "Frame", count: int) -> "Frame":
        cols = dict(self.cols)
        for k, v in other.cols.items():
            if k in cols:
                raise ExecError(f"column collision {k}")
            cols[k] = v
        return Frame(cols, count)


def _scale_of(col_or_scalar) -> int:
    if isinstance(col_or_scalar, Column):
        return col_or_scalar.typ.scale if col_or_scalar.typ.kind == Kind.DECIMAL else 0
    return col_or_scalar.scale


def _is_float(x) -> bool:
    if isinstance(x, Column):
        return x.typ.np_dtype.kind == "f"
    return x.is_float()


def _upscale_col(col: Column, k: int) -> Column:
    if k == 0:
        return col
    s = (col.typ.scale if col.typ.kind == Kind.DECIMAL else 0) + k
    return C.convert(col, dec_t(18, s), scale_up=k)


def _to_f64_col(col: Column) -> Column:
    if col.typ.np_dtype.kind == "f" and col.typ is F64:
        return col
    return C.convert(col, F64)


def _parse_str_cast(x: str, to):
    """Parse one string into the logical value of the target type
    (gdk_calc_convert.c convert_str_any / per-atom fromstr)."""
    import datetime
    from decimal import Decimal as PyDecimal
    x = x.strip()
    if to.kind == Kind.DECIMAL:
        return PyDecimal(x)
    if to.kind == Kind.BOOL:
        return x.lower() in ("true", "t", "1", "yes")
    if to.kind == Kind.DATE:
        return datetime.date.fromisoformat(x)
    if to.kind == Kind.TIMESTAMP:
        return datetime.datetime.fromisoformat(x)
    if to.kind == Kind.TIME:
        return datetime.time.fromisoformat(x)
    if to.np_dtype.kind == "f":
        return float(x)
    return int(x)


def _to_f64_scalar(s: Scalar) -> float:
    if s.value is None:
        return float("nan")
    v = float(s.value)
    if s.scale:
        v /= 10.0 ** s.scale
    return v


# small tensor helpers ------------------------------------------------------


def _concat_vals(a, na: int, b, nb: int, nil, *, out_cap: int):
    """Concatenate the live prefixes of two padded tensors; tail = nil."""
    out = torch.full((out_cap,), nil, dtype=a.dtype, device=a.device)
    out[:na] = a[:na]
    out[na:na + nb] = b[:nb]
    return out


def _concat_live(a, na: int, b, nb: int, *, out_cap: int):
    """Concatenate the live prefixes of two padded int64 oid tensors."""
    return _concat_vals(a, na, b, nb, -1, out_cap=out_cap)


def _unique_sorted(r1, total: int, *, out_cap: int):
    """First occurrence of each value in a sorted live-prefix oid array."""
    cap = r1.shape[0]
    live = valid_mask(cap, total, r1.device)
    first = r1 != torch.roll(r1, 1)
    first[0] = True
    sel = live & first
    si = sel.to(torch.int32)
    idx = torch.cumsum(si, 0) - si
    pos = torch.where(sel, idx.to(torch.int64), out_cap)
    return set_drop(out_cap, -1, pos, r1), si.sum()


def _matched_mask(r1, total: int, *, cap: int):
    live = valid_mask(r1.shape[0], total, r1.device) & (r1 >= 0)
    safe = torch.where(live, r1, cap - 1)
    m = torch.zeros(cap, dtype=torch.uint8, device=r1.device)
    m.scatter_reduce_(0, safe, live.to(torch.uint8), reduce="amax")
    return m.to(torch.bool)


def _distinct_counts(ids, ext, ng2: int, nil_at_ext, *, seg_cap: int):
    """#subgroups per outer group (count distinct): for each live subgroup
    extent row, bump its outer group's counter (skipping nil values)."""
    cap2 = ext.shape[0]
    live = valid_mask(cap2, ng2, ext.device) & (ext >= 0) & ~nil_at_ext
    oid = torch.where(live, ext, 0)
    og = ids[oid].to(torch.int64)
    safe = torch.where(live & (og >= 0), og, seg_cap)
    out = torch.zeros(seg_cap + 1, dtype=torch.int64, device=ext.device)
    return out.index_add_(0, safe, live.to(torch.int64))[:seg_cap]


def _eq_nil_as_value(a, b):
    """Equality with NULL == NULL (set-operation matching semantics)."""
    return (a == b) | (nilm(a) & nilm(b))


def _remap_codes(codes, table: np.ndarray):
    """table[code] for live codes, nil codes unchanged (dictionary merge)."""
    ok = codes >= 0
    t = torch.from_numpy(np.ascontiguousarray(table)).to(codes.device)
    return torch.where(ok, t[torch.where(ok, codes, 0).long()], codes)


def _hex_norm(s: str) -> str:
    """Validate/normalize a blob hex literal (blobFromStr)."""
    from ..storage.columns import blob_norm
    try:
        return blob_norm(s)
    except ValueError as exc:
        raise ExecError(str(exc)) from None


def _concat_cols(a: Column, b: Column, na: int, nb: int) -> Column:
    """Vertical concatenation (BATappend analog) with dictionary merge for
    strings and scale alignment for decimals."""
    n = na + nb
    out_cap = capacity_for(n)
    if (a.typ is not None and a.typ.kind == Kind.STR) or \
            (b.typ is not None and b.typ.kind == Kind.STR):
        def as_str(col, cnt):
            """Non-string operand of a string set-op/append: convert by
            host decode (untyped NULL literals and mixed-type unions —
            convert_any_str)."""
            if col.typ is not None and col.typ.kind == Kind.STR \
                    and col.sdict is not None:
                return col
            from ..engine import _decode_column
            from ..storage.columns import column_from_pyvalues
            from ..dtypes import varchar as _vc
            if col.typ is not None and col.typ.kind == Kind.STR:
                return Column(col.typ, col.data, col.count,
                              nonil=col.nonil, sdict=StrDict(
                                  np.empty(0, dtype=str)))
            vv = [None if x is None else str(x)
                  for x in _decode_column(col)]
            return column_from_pyvalues(vv, _vc(), device=col.data.device)
        a, b = as_str(a, na), as_str(b, nb)
        merged = np.unique(np.concatenate([a.sdict.values, b.sdict.values]))
        def remap(col):
            if len(col.sdict.values) == 0:    # all-NULL side: codes stay nil
                return col.data
            m = np.searchsorted(merged, col.sdict.values).astype(np.int32)
            return _remap_codes(col.data, m)
        ad, bd = remap(a), remap(b)
        data = _concat_vals(ad, na, bd, nb, nil_const(ad.dtype),
                            out_cap=out_cap)
        return Column(a.typ, data, n, nonil=a.nonil and b.nonil,
                      sdict=StrDict(merged))
    sa = a.typ.scale if a.typ.kind == Kind.DECIMAL else 0
    sb = b.typ.scale if b.typ.kind == Kind.DECIMAL else 0
    if sa < sb:
        a = _upscale_col(a, sb - sa)
    elif sb < sa:
        b = _upscale_col(b, sa - sb)
    typ = a.typ if a.typ.np_dtype.itemsize >= b.typ.np_dtype.itemsize \
        else b.typ
    if a.typ.np_dtype != typ.np_dtype:
        a = C.convert(a, typ)       # nil-sentinel-correct widening
    if b.typ.np_dtype != typ.np_dtype:
        b = C.convert(b, typ)
    ad, bd = a.data, b.data
    data = _concat_vals(ad, na, bd, nb, nil_const(ad.dtype), out_cap=out_cap)
    return Column(typ, data, n, nonil=a.nonil and b.nonil)


def _unsort(vals, oids, cnt: int):
    """Scatter sorted-domain values back to original row positions."""
    cap = oids.shape[0]
    nil = nil_const(vals.dtype)
    live = valid_mask(cap, cnt, oids.device) & (oids >= 0)
    pos = torch.where(live, oids, cap)
    return set_drop(cap, nil, pos, torch.where(live, vals, nil))


def _cross_pairs(total: int, *, nr: int, out_cap: int, device):
    io = iota(out_cap, device)
    live = io < total
    # io >= 0, so floor division is truncation
    r1 = torch.where(live, io // nr, -1)
    r2 = torch.where(live, io % nr, -1)
    return r1, r2


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


class Executor:
    def __init__(self, catalog: Catalog, device=None):
        """``device`` defaults to the one device that holds every tensor of
        ``catalog`` (an error if they are spread over several)."""
        self.catalog = catalog
        self.device = torch.device(device) if device is not None \
            else catalog_device(catalog, ExecError)
        self.refs: Dict[str, set] = {}
        self._win_order = None

    def _full(self, n: int, value, dtype) -> torch.Tensor:
        return torch.full((n,), value, dtype=tdt(dtype), device=self.device)

    def _no_rows(self, fr: "Frame") -> Cand:
        return Cand.from_mask(self._full(fr.cap, False, torch.bool), fr.count)

    def _from_py(self, vals, typ) -> Column:
        from ..storage.columns import column_from_pyvalues
        return column_from_pyvalues(vals, typ, device=self.device)

    def _sub(self) -> "Executor":
        """A fresh executor for a subquery plan, on the same device."""
        return Executor(self.catalog, self.device)

    # -- entry ---------------------------------------------------------------
    def run(self, rel: L.Rel) -> Frame:
        self._collect_refs(rel)
        return self.exec_rel(rel)

    # -- column pruning (the rel_bin column-usage analysis analog) -----------
    def _collect_refs(self, rel: L.Rel):
        def ref_expr(e: Expr):
            for n in walk(e):
                if isinstance(n, ColRef) and n.table not in ("#out", "#grp"):
                    self.refs.setdefault(n.table, set()).add(n.name)
                if isinstance(n, Subquery) and isinstance(n.select, tuple):
                    self._collect_refs(n.select[1])

        def visit(r: L.Rel):
            if isinstance(r, L.Filter):
                ref_expr(r.pred)
            elif isinstance(r, L.Project):
                for _n, e in r.exprs:
                    ref_expr(e)
            elif isinstance(r, L.Join):
                for a, b in r.on:
                    ref_expr(a)
                    ref_expr(b)
                if r.extra is not None:
                    ref_expr(r.extra)
            elif isinstance(r, L.GroupBy):
                for _n, e in r.keys:
                    ref_expr(e)
                for _n, _f, arg, _d in r.aggs:
                    for a in (arg if isinstance(arg, list) else [arg]):
                        if a is not None:
                            ref_expr(a)
            elif isinstance(r, L.OrderBy):
                for e, _d, _nl in r.keys:
                    ref_expr(e)
            for c in r.children():
                visit(c)

        visit(rel)

    # -- node dispatch --------------------------------------------------------
    def exec_rel(self, rel: L.Rel) -> Frame:
        m = getattr(self, "_exec_" + type(rel).__name__.lower(), None)
        if m is None:
            raise ExecError(f"no executor for {type(rel).__name__}")
        # cooperative stop/timeout between operators (sysmon pause/stop,
        # mal_runtime.c QRYqueue status; mal_interpreter checks per instr)
        from ..sql.syscat import CURRENT_QUERY, QUEUE
        QUEUE.check(CURRENT_QUERY.tag)
        from ..obs import PROFILER
        if not PROFILER.enabled:
            out = m(rel)
        else:
            with PROFILER.op(type(rel).__name__, label=rel._label()):
                out = m(rel)
            PROFILER.events[-1]["rows"] = out.count
        # post-check: an operator that overran the deadline (or was
        # stopped mid-flight) aborts as soon as it returns
        QUEUE.check(CURRENT_QUERY.tag)
        # GDKdebug-style property validation of the operator's output
        # (BATassertProps after each op, gdk/gdk_bat.c)
        if config.get("assert_props") and isinstance(out, Frame):
            from ..obs.assertprops import assert_frame_props
            assert_frame_props(out, type(rel).__name__)
        return out

    def _exec_scan(self, r: L.Scan) -> Frame:
        if r.table not in self.catalog:
            # plan-cache hit on a fresh catalog: system relations are
            # materialized at bind time, so re-materialize here
            from ..sql.syscat import is_system_table, system_table
            if is_system_table(r.table):
                self.catalog.add(system_table(self.catalog, r.table))
        t = self.catalog.get(r.table)
        wanted = self.refs.get(r.alias) or self.refs.get(r.table) or set()
        names = [n for n in t.names() if n in wanted] or t.names()[:1]
        return Frame({(r.alias, n): t.col(n) for n in names}, t.count)

    def _exec_subplan(self, r: L.SubPlan) -> Frame:
        return self.exec_rel(r.child).rename(r.alias)

    def _exec_remotescan(self, r: L.RemoteScan) -> Frame:
        raise ExecError("RemoteScan: needs the server client (server.py), "
                        "which is not ported yet")

    def _exec_remotequery(self, r: L.RemoteQuery) -> Frame:
        raise ExecError("RemoteQuery: needs the server client (server.py), "
                        "which is not ported yet")

    def _exec_filter(self, r: L.Filter) -> Frame:
        fr = self.exec_rel(r.child)
        cand = self.eval_pred(r.pred, fr)
        return self._apply_cand(fr, cand)

    def _apply_cand(self, fr: Frame, cand: Cand) -> Frame:
        if cand.is_all():
            return fr
        c = S.materialize(cand, fr.cap, self.device)
        return fr.gather(c.oids, c.oid_count)

    def _exec_project(self, r: L.Project) -> Frame:
        fr = self.exec_rel(r.child)
        self._win_order = None
        out = {}
        for name, e in r.exprs:
            v = self.eval(e, fr)
            if isinstance(v, Scalar):
                v = self._broadcast(v, fr)
            out[("#out", name)] = v
        wo, self._win_order = self._win_order, None
        if wo is not None:
            # window functions ride the (partition, order)-sorted rows in
            # the reference (sql_rank.c projects aligned with the sorted
            # relation), so a query without its own ORDER BY surfaces
            # rows in that order - nosort corpus tests pin it.  Reorder
            # the projection to the LAST window's sort.
            oids, cnt = wo
            out = {k: P.project_oids(oids, cnt, c)
                   for k, c in out.items()}
            return Frame(out, cnt)
        return Frame(out, fr.count)

    def _broadcast(self, s: Scalar, fr: Frame) -> Column:
        typ = s.typ or I64
        if typ.kind == Kind.STR:
            if s.value is None:      # NULL string: empty dict, nil codes
                sd = StrDict(np.empty(0, dtype=str))
                return Column(typ, self._full(fr.cap, nil_const(torch.int32),
                                              torch.int32),
                              fr.count, nonil=False, sdict=sd)
            sd = StrDict(np.array([s.value]))
            data = self._full(fr.cap, 0, torch.int32)
            return Column(typ, data, fr.count, sdict=sd)
        if isinstance(s.value, tuple):
            # interval pseudo-const in value position: type it as
            # month_interval (months) or sec_interval (µs)
            amt, unit = s.value
            from ..dtypes import MONTH_INTERVAL, SEC_INTERVAL
            month_u = {"year": 12, "quarter": 3, "month": 1}
            sec_u = {"week": 604800, "day": 86400, "hour": 3600,
                     "minute": 60, "second": 1}
            if unit in month_u:
                typ = MONTH_INTERVAL
                v = np.int32(amt * month_u[unit])
            else:
                typ = SEC_INTERVAL
                v = np.int64(int(amt * sec_u[unit] * 1_000_000))
            return Column(typ, self._full(fr.cap, v.item(), v.dtype),
                          fr.count, nonil=True)
        v = typ.nil if s.value is None else typ.np_dtype.type(s.value)
        return Column(typ, self._full(fr.cap, v.item(), typ.np_dtype),
                      fr.count, nonil=s.value is not None)

    def _exec_orderby(self, r: L.OrderBy) -> Frame:
        fr = self.exec_rel(r.child)
        cols, desc, nl = [], [], []
        for e, d, n in r.keys:
            v = self.eval(e, fr)
            if isinstance(v, Scalar):
                continue
            cols.append(v)
            desc.append(d)
            nl.append(n)
        if not cols:
            return fr
        oids, n = SRT.argsort(cols, desc, nl)
        return fr.gather(oids, n)

    def _exec_limit(self, r: L.Limit) -> Frame:
        # ORDER BY + LIMIT fusion → BATfirstn (gdk/gdk_firstn.c; the
        # reference's topn pushdown creates the same shape)
        if isinstance(r.child, L.OrderBy) and r.n is not None:
            ob = r.child
            fr = self.exec_rel(ob.child)
            cols, desc, nl = [], [], []
            for e, d, n_l in ob.keys:
                v = self.eval(e, fr)
                if isinstance(v, Scalar):
                    continue
                cols.append(v)
                desc.append(d)
                nl.append(n_l)
            if cols:
                lo = r.offset or 0
                oids, n = SRT.firstn(cols, lo + r.n, desc, nl)
                out = fr.gather(oids, n)
                if lo:
                    c = S.materialize(Cand.dense(out.count, lo, out.count),
                                      out.cap, self.device)
                    out = out.gather(c.oids, c.oid_count)
                return out
            fr = fr  # all-scalar keys: fall through to plain limit
        else:
            fr = self.exec_rel(r.child)
        lo = r.offset or 0
        hi = fr.count if r.n is None else min(fr.count, lo + r.n)
        c = S.materialize(Cand.dense(fr.count, lo, hi), fr.cap, self.device)
        return fr.gather(c.oids, c.oid_count)

    def _exec_sample(self, r: L.Sample) -> Frame:
        """BATsample (gdk/gdk_sample.c): uniform without replacement,
        deterministic under SEED."""
        fr = self.exec_rel(r.child)
        n = min(r.n, fr.count)
        rng = np.random.default_rng(r.seed if r.seed is not None else 0xC0FFEE)
        picks = np.sort(rng.choice(fr.count, size=n, replace=False)) \
            if fr.count else np.empty(0, np.int64)
        cap = capacity_for(n)
        oids = np.full(cap, -1, np.int64)
        oids[:n] = picks
        return fr.gather(torch.from_numpy(oids).to(self.device), n)

    def _exec_values(self, r: L.Values) -> Frame:
        """VALUES table constructor → literal device columns."""
        n = len(r.cols[0]) if r.cols else 0
        cols = {}
        for name, typ, vals in zip(r.names, r.types, r.cols):
            cols[(r.alias, name)] = self._from_py(vals, typ)
        return Frame(cols, n)

    def _exec_series(self, r: L.Series) -> Frame:
        """generate_series(start, stop[, step]) — stop-exclusive lazy series
        (reference backends/monet5/generator/generator.c)."""
        step = r.step or 1
        n = max(0, -(-(r.stop - r.start) // step)) if step != 0 else 0
        cap = capacity_for(n)
        vals = iota(cap, self.device) * step + r.start
        vals = torch.where(valid_mask(cap, n, self.device), vals,
                           nil_const(torch.int64))
        col = Column(I64, vals, n, nonil=True, sorted=step > 0,
                     revsorted=step < 0, key=True)
        col.minval, col.maxval = (r.start, r.start + (n - 1) * step) \
            if n and step > 0 else (None, None)
        return Frame({(r.alias, "value"): col}, n)

    def _exec_distinct(self, r: L.Distinct) -> Frame:
        fr = self.exec_rel(r.child)
        g = G.group_multi(list(fr.cols.values()))
        return fr.gather(g.extents, g.ngroups)

    def _exec_setop(self, r: L.SetOp) -> Frame:
        """UNION [ALL] / EXCEPT / INTERSECT. Set semantics follow SQL:
        UNION/EXCEPT/INTERSECT deduplicate and treat NULLs as equal
        (the reference lowers these to BATunique + BATdiff/BATintersect,
        gdk/gdk_unique.c, gdk_join.c:4378/4395)."""
        lf, rf = self._exec_children_parallel([r.left, r.right])
        lcols = list(lf.cols.items())
        rcols = list(rf.cols.items())
        if len(lcols) != len(rcols):
            raise ExecError("set operands differ in arity")
        if r.kind in ("union", "union_all"):
            n = lf.count + rf.count
            out = {}
            for (lk, lc), (_rk, rc) in zip(lcols, rcols):
                out[lk] = _concat_cols(lc, rc, lf.count, rf.count)
            frame = Frame(out, n)
            if r.kind == "union":
                g = G.group_multi(list(frame.cols.values()))
                frame = frame.gather(g.extents, g.ngroups)
            return frame
        all_mode = r.kind in ("except_all", "intersect_all")
        base_kind = r.kind[:-4] if all_mode else r.kind
        if all_mode:
            # multiset semantics (sql_parser.y EXCEPT/INTERSECT ALL):
            # for a value with count_l left copies and count_r right
            # copies, EXCEPT ALL keeps max(count_l - count_r, 0) and
            # INTERSECT ALL keeps min(count_l, count_r).  Realized by
            # each left row's OCCURRENCE RANK within its value group:
            # EXCEPT ALL keeps ranks >= count_r, INTERSECT ALL keeps
            # ranks < count_r.
            gl = G.group_multi([c for _k, c in lcols])
            gr = G.group_multi([c for _k, c in rcols])
            # match left value groups to right value groups via the
            # deduped representative rows (the existing anti/semi chain)
            lrep = lf.gather(gl.extents, gl.ngroups)
            rrep = rf.gather(gr.extents, gr.ngroups)
            lrep_cols = list(lrep.cols.items())
            rrep_cols = list(rrep.cols.items())
            l0, r0 = self._align_join_keys(lrep_cols[0][1],
                                           rrep_cols[0][1])
            r1, r2, total = J.join(l0, r0, nil_matches=True, how="left")
            for (_lk, lc), (_rk, rc) in zip(lrep_cols[1:], rrep_cols[1:]):
                lc, rc = self._align_join_keys(lc, rc)
                lp = P.project_oids(r1, total, lc)
                rp = P.project_oids(r2, total, rc)
                eq = _eq_nil_as_value(lp.data, rp.data)
                c = S.materialize(Cand.from_mask(eq, total), lp.cap, self.device)
                r1 = P.project_oids(c.oids, c.oid_count,
                                    Column(OID, r1, total)).data
                r2 = P.project_oids(c.oids, c.oid_count,
                                    Column(OID, r2, total)).data
                total = c.oid_count
            # count_r per left gid (0 where unmatched)
            cnt_r = np.zeros(gl.seg_cap, np.int64)
            r1h = r1[:int(total)].cpu().numpy()
            r2h = r2[:int(total)].cpu().numpy()
            rh = gr.histo[: gr.ngroups].cpu().numpy()
            ok = (r1h >= 0) & (r2h >= 0)
            cnt_r[r1h[ok]] = rh[r2h[ok]]
            # occurrence rank of each left row within its value group
            ids = gl.ids[: lf.cap].cpu().numpy()
            order = np.argsort(ids[: lf.count], kind="stable")
            starts = np.zeros(gl.ngroups + 1, np.int64)
            np.cumsum(gl.histo[: gl.ngroups].cpu().numpy(),
                      out=starts[1:])
            rank = np.empty(lf.count, np.int64)
            gid_sorted = ids[: lf.count][order]
            rank[order] = np.arange(lf.count) - starts[
                np.clip(gid_sorted, 0, gl.ngroups)]
            valid = ids[: lf.count] >= 0
            cr = cnt_r[np.clip(ids[: lf.count], 0, gl.seg_cap - 1)]
            if base_kind == "except":
                keep = valid & (rank >= cr)
            else:
                keep = valid & (rank < cr)
            mask = np.zeros(lf.cap, bool)
            mask[: lf.count] = keep
            cand = Cand.from_mask(torch.from_numpy(mask).to(self.device),
                                  lf.count)
            return self._apply_cand(lf, cand)
        # except / intersect: dedupe left, then anti/semi match on all cols
        g = G.group_multi([c for _k, c in lcols])
        lf = lf.gather(g.extents, g.ngroups)
        lcols = list(lf.cols.items())
        l0, r0 = self._align_join_keys(lcols[0][1], rcols[0][1])
        r1, r2, total = J.join(l0, r0, nil_matches=True, how="left")
        for (_lk, lc), (_rk, rc) in zip(lcols[1:], rcols[1:]):
            lc, rc = self._align_join_keys(lc, rc)
            lp = P.project_oids(r1, total, lc)
            rp = P.project_oids(r2, total, rc)
            eq = _eq_nil_as_value(lp.data, rp.data)
            c = S.materialize(Cand.from_mask(eq, total), lp.cap, self.device)
            r1 = P.project_oids(c.oids, c.oid_count,
                                Column(OID, r1, total)).data
            r2 = P.project_oids(c.oids, c.oid_count,
                                Column(OID, r2, total)).data
            total = c.oid_count
        m = _matched_mask(r1, total, cap=lf.cap)
        cand = Cand.from_mask(m, lf.count)
        if r.kind == "except":
            cand = S.cand_not(cand, lf.cap, self.device)
        elif r.kind != "intersect":
            raise ExecError(f"set op {r.kind}")
        return self._apply_cand(lf, cand)

    # -- group by -------------------------------------------------------------
    def _exec_groupby(self, r: L.GroupBy) -> Frame:
        fr = self.exec_rel(r.child)
        out: Dict[Tuple[str, str], Column] = {}
        key_cols = []
        for name, e in r.keys:
            v = self.eval(e, fr)
            if isinstance(v, Scalar):
                v = self._broadcast(v, fr)
            key_cols.append((name, v))
        if key_cols:
            g = G.group_multi([c for _n, c in key_cols])
        else:
            # scalar aggregation: one group over all live rows
            ids = torch.where(valid_mask(fr.cap, fr.count, self.device),
                              0, -1).to(torch.int32)
            g = G.GroupResult(ids, 1, fr.count)
            g.extents = self._full(g.seg_cap, 0, torch.int64)
            g.histo = self._full(g.seg_cap, fr.count, torch.int64)
        for name, kc in key_cols:
            out[("#grp", name)] = P.project_oids(g.extents, g.ngroups, kc)
        for name, func, arg, distinct in r.aggs:
            ac = ac2 = None
            if isinstance(arg, list):
                arg, arg2 = arg
                ac2 = self.eval(arg2, fr)
                if isinstance(ac2, Scalar) and func not in (
                        "quantile", "group_concat", "listagg"):
                    ac2 = self._broadcast(ac2, fr)
            if arg is not None:
                ac = self.eval(arg, fr)
                if isinstance(ac, Scalar):
                    ac = self._broadcast(ac, fr)
            out[("#grp", name)] = self._agg(func, ac, g, distinct, fr, ac2)
        return Frame(out, g.ngroups)

    def _agg(self, func: str, col: Optional[Column], g: G.GroupResult,
             distinct: bool, fr: Frame, col2=None) -> Column:
        if distinct and func in ("min", "max"):
            distinct = False             # DISTINCT is a no-op for min/max
        if distinct:
            if func not in ("count", "sum", "avg"):
                raise ExecError(f"distinct {func} unsupported")
            g2 = G.group(col, None, prev=g, with_extents=True)
            ext = g2.extents
            if func == "count":
                if not col.nonil:
                    nil_at = nilm(col.data[torch.where(ext >= 0, ext, 0)])
                else:
                    nil_at = self._full(ext.shape[0], False, torch.bool)
                cnt = _distinct_counts(g.ids, ext, g2.ngroups,
                                       nil_at, seg_cap=g.seg_cap)
                return Column(I64, cnt, g.ngroups, nonil=True)
            # sum/avg DISTINCT: nil out every duplicate (group, value)
            # occurrence, then the plain skip-nils aggregate reduces each
            # distinct value exactly once (gdk_aggr.c distinct paths)
            cap2 = ext.shape[0]
            live = valid_mask(cap2, g2.ngroups, self.device) & (ext >= 0)
            first = self._full(col.cap, 0, torch.uint8)
            first.scatter_reduce_(0, torch.where(live, ext, 0),
                                  live.to(torch.uint8), reduce="amax")
            col2 = col.with_props(
                data=torch.where(first.to(torch.bool), col.data,
                                 nil_const(col.data.dtype)), nonil=False)
            if func == "sum":
                return A.group_sum(col2, g)
            return A.group_avg(col2, g)[0]
        if func in ("count_star",):
            return A.group_count(None, g)
        if func == "count":
            return A.group_count(col, g)
        if func == "sum":
            return A.group_sum(col, g)
        if func == "avg":
            return A.group_avg(col, g)[0]
        if func == "min":
            return A.group_min(col, g)
        if func == "max":
            return A.group_max(col, g)
        if func == "prod":
            return A.group_prod(col, g)
        if func in ("stddev_samp", "stddev_pop"):
            return A.group_stdev(col, g, sample=func.endswith("samp"))
        if func in ("var_samp", "var_pop"):
            return A.group_var(col, g, sample=func.endswith("samp"))
        if func == "median":
            return A.group_median(col, g)
        if func == "quantile":
            if not isinstance(col2, Scalar):
                raise ExecError("quantile requires a constant fraction")
            q = float(col2.value) / (10.0 ** col2.scale) \
                if not col2.is_float() else float(col2.value)
            return A.group_quantile(col, g, q)
        if func == "corr":
            return A.group_corr(col, col2, g)
        if func in ("covar_samp", "covar_pop"):
            return A.group_covar(col, col2, g, sample=func.endswith("samp"))
        if func in ("group_concat", "listagg"):
            sep = "," if col2 is None else str(col2.value)
            return A.group_concat_host(col, g, sep)
        raise ExecError(f"aggregate {func} unsupported")

    # -- joins ----------------------------------------------------------------
    def _side_of(self, e: Expr, lf: Frame, rf: Frame) -> str:
        for n in walk(e):
            if isinstance(n, ColRef):
                if any(k == (n.table, n.name) for k in lf.cols):
                    return "l"
                if any(k == (n.table, n.name) for k in rf.cols):
                    return "r"
        raise ExecError(f"cannot place join key {e!r}")

    def _key_cols(self, j: L.Join, lf: Frame, rf: Frame):
        pairs = []
        for a, b in j.on:
            if self._side_of(a, lf, rf) == "l":
                pairs.append((a, b))
            else:
                pairs.append((b, a))
        cols = []
        for a, b in pairs:
            lc = self.eval(a, lf)
            rc = self.eval(b, rf)
            if isinstance(lc, Scalar) or isinstance(rc, Scalar):
                raise ExecError("scalar join key")
            lc, rc = self._align_join_keys(lc, rc)
            cols.append((lc, rc))
        return cols

    def _align_join_keys(self, lc: Column, rc: Column):
        if lc.typ.kind == Kind.STR or rc.typ.kind == Kind.STR:
            if lc.sdict is rc.sdict:
                return lc, rc
            # translate right codes into the left dictionary's code space
            if len(lc.sdict) == 0:
                # empty left dictionary (0-row table): nothing matches
                nd = torch.where(rc.data >= 0, -2, rc.data)
                return lc, Column(rc.typ, nd, rc.count, nonil=rc.nonil,
                                  sdict=lc.sdict)
            idx = np.searchsorted(lc.sdict.values, rc.sdict.values)
            idx = np.clip(idx, 0, len(lc.sdict) - 1)
            found = lc.sdict.values[idx] == rc.sdict.values
            remap = np.where(found, idx, -2).astype(np.int32)
            nd = _remap_codes(rc.data, remap)
            return lc, Column(rc.typ, nd, rc.count, nonil=rc.nonil,
                              sdict=lc.sdict)
        ls = _scale_of(lc)
        rs = _scale_of(rc)
        if ls != rs:
            if ls < rs:
                lc = _upscale_col(lc, rs - ls)
            else:
                rc = _upscale_col(rc, ls - rs)
        return lc, rc

    def _pick_primary(self, cols) -> int:
        """Choose the join key with the most distinct right values (joincost
        analog, gdk/gdk_join.c:3586): unique key wins, else widest range."""
        best, best_score = 0, -1.0
        for i, (_lc, rc) in enumerate(cols):
            if rc.key:
                return i
            if rc.sdict is not None:
                score = float(len(rc.sdict))
            elif rc.minval is not None and rc.maxval is not None:
                score = float(int(rc.maxval) - int(rc.minval) + 1)
            else:
                score = 0.0
            if score > best_score:
                best, best_score = i, score
        return best

    def _estimate_bytes(self, rel: L.Rel) -> int:
        """Footprint estimate for admission (mal_resource.c claims are
        argument-size based the same way): sum of base scans under rel."""
        if isinstance(rel, L.Scan):
            try:
                t = self.catalog.get(rel.table)
            except Exception:
                return 1 << 20
            wanted = self.refs.get(rel.alias) or set()
            ncols = max(len(wanted), 1)
            return t.count * 8 * ncols
        return sum(self._estimate_bytes(c) for c in rel.children()) \
            or (1 << 20)

    def _exec_children_parallel(self, rels):
        """Execute independent subtrees on the dataflow pool (DFLOWworker
        analog). Sequential when: disabled, profiling (event buffer is
        per-query ordered), or already inside a dataflow worker (avoids
        nested-pool deadlock — the reference's workers also run nested
        dataflow blocks inline, mal_dataflow.c:460)."""
        import threading as _t
        from ..obs import PROFILER
        from . import dataflow
        if int(config.get("dataflow_workers")) <= 1 or PROFILER.enabled \
                or _t.current_thread().name.startswith("dflow") \
                or len(rels) < 2:
            return [self.exec_rel(r) for r in rels]
        from ..obs import set_algorithm
        set_algorithm(f"dataflow:parallel{len(rels)}")
        return dataflow.run_parallel(
            [lambda r=r: self.exec_rel(r) for r in rels],
            [self._estimate_bytes(r) for r in rels])

    def _exec_join(self, j: L.Join) -> Frame:
        if j.kind == "right":
            # RIGHT JOIN = LEFT JOIN with sides swapped (key sides resolve
            # dynamically in _key_cols; the reference swaps in rel_select.c)
            j = L.Join(j.right, j.left, "left", on=j.on, extra=j.extra)
        lf, rf = self._exec_children_parallel([j.left, j.right])
        kind = j.kind

        if kind == "cross" or not j.on:
            # no equi keys: nested-loop pairs + residual filter. For plain
            # cross/inner that's the result; outer/semi/anti kinds fall
            # through to the same completion logic as the keyed path
            # (thetajoin analog, gdk/gdk_join.c:3699)
            total = lf.count * rf.count
            out_cap = capacity_for(total)
            nr = max(rf.count, 1)
            r1, r2 = _cross_pairs(total, nr=nr, out_cap=out_cap,
                                  device=self.device)
            frame = lf.gather(r1, total).merged(rf.gather(r2, total), total)
            if j.extra is not None:
                cand = self.eval_pred(j.extra, frame)
                if not cand.is_all():
                    c = S.materialize(cand, frame.cap, self.device)
                    r1 = P.project_oids(c.oids, c.oid_count,
                                        Column(OID, r1, total)).data
                    r2 = P.project_oids(c.oids, c.oid_count,
                                        Column(OID, r2, total)).data
                    total = c.oid_count
            if kind in ("cross", "inner"):
                return lf.gather(r1, total).merged(rf.gather(r2, total),
                                                   total)
            return self._join_complete(kind, lf, rf, r1, r2, total)

        cols = self._key_cols(j, lf, rf)
        prim = self._pick_primary(cols)
        lc0, rc0 = cols[prim]
        rest = [cols[i] for i in range(len(cols)) if i != prim]

        # fast paths: single-key semi/anti with no residual
        if kind in ("semi", "anti") and not rest and j.extra is None:
            fn = J.semijoin if kind == "semi" else J.antijoin
            oids, n = fn(lc0, rc0)
            return lf.gather(oids, n)

        r1, r2, total = J.join(lc0, rc0, how="left")
        # refine on remaining keys (pair-space equality — the reference's
        # multi-attribute join refinement via mkey/second-column compare)
        for lc, rc in rest:
            lp = P.project_oids(r1, total, lc)
            rp = P.project_oids(r2, total, rc)
            eq = C.compare("=", lp, rp)
            cand = Cand.from_mask(eq.data == 1, total)
            c = S.materialize(cand, eq.cap, self.device)
            r1 = P.project_oids(c.oids, c.oid_count,
                                Column(OID, r1, total)).data
            r2 = P.project_oids(c.oids, c.oid_count,
                                Column(OID, r2, total)).data
            total = c.oid_count
        if j.extra is not None:
            pair = lf.gather(r1, total).merged(rf.gather(r2, total), total)
            cand = self.eval_pred(j.extra, pair)
            if not cand.is_all():
                c = S.materialize(cand, pair.cap, self.device)
                r1 = P.project_oids(c.oids, c.oid_count,
                                    Column(OID, r1, total)).data
                r2 = P.project_oids(c.oids, c.oid_count,
                                    Column(OID, r2, total)).data
                total = c.oid_count

        if kind == "inner":
            return lf.gather(r1, total).merged(rf.gather(r2, total), total)
        return self._join_complete(kind, lf, rf, r1, r2, total)

    def _join_complete(self, kind, lf: Frame, rf: Frame, r1, r2,
                       total: int) -> Frame:
        """Turn matched (r1, r2) pair lists into the requested join kind
        (semi/anti/left/full completion over the left/right frames)."""
        if kind == "semi":
            out_cap = capacity_for(min(total, lf.count))
            oids, n = _unique_sorted(r1, total, out_cap=out_cap)
            return lf.gather(oids, int(n))
        if kind == "anti":
            m = _matched_mask(r1, total, cap=lf.cap)
            cand = S.cand_not(Cand.from_mask(m, lf.count), lf.cap, self.device)
            return self._apply_cand(lf, cand)
        if kind in ("left", "left_outer", "outer"):
            m = _matched_mask(r1, total, cap=lf.cap)
            un = S.materialize(
                S.cand_not(Cand.from_mask(m, lf.count), lf.cap, self.device),
                lf.cap, self.device)
            n_all = total + un.oid_count
            out_cap = capacity_for(n_all)
            r1a = _concat_live(r1, total, un.oids,
                               un.oid_count, out_cap=out_cap)
            neg = self._full(un.oids.shape[0], -1, torch.int64)
            r2a = _concat_live(r2, total, neg,
                               un.oid_count, out_cap=out_cap)
            return lf.gather(r1a, n_all).merged(
                rf.gather(r2a, n_all, right_nil=True), n_all)
        if kind == "full":
            # FULL OUTER (BATouterjoin both-sided): left-outer pairs plus
            # unmatched right rows with NIL left
            lm = _matched_mask(r1, total, cap=lf.cap)
            lun = S.materialize(
                S.cand_not(Cand.from_mask(lm, lf.count), lf.cap, self.device),
                lf.cap, self.device)
            rm = _matched_mask(r2, total, cap=rf.cap)
            run = S.materialize(
                S.cand_not(Cand.from_mask(rm, rf.count), rf.cap, self.device),
                rf.cap, self.device)
            n_all = total + lun.oid_count + run.oid_count
            out_cap = capacity_for(n_all)
            n1 = total + lun.oid_count
            r1a = _concat_live(r1, total, lun.oids,
                               lun.oid_count,
                               out_cap=capacity_for(n1))
            r2a = _concat_live(r2, total,
                               self._full(lun.oids.shape[0], -1, torch.int64),
                               lun.oid_count,
                               out_cap=capacity_for(n1))
            r1b = _concat_live(r1a, n1,
                               self._full(run.oids.shape[0], -1, torch.int64),
                               run.oid_count, out_cap=out_cap)
            r2b = _concat_live(r2a, n1, run.oids,
                               run.oid_count, out_cap=out_cap)
            return lf.gather(r1b, n_all, right_nil=True).merged(
                rf.gather(r2b, n_all, right_nil=True), n_all)
        raise ExecError(f"join kind {kind} unsupported")

    # ======================================================================
    # expression evaluation (value context)
    # ======================================================================
    def eval(self, e: Expr, fr: Frame) -> Union[Column, Scalar]:
        if isinstance(e, ColRef):
            return fr.get(e.table, e.name)
        if isinstance(e, Const):
            return self._const(e)
        if isinstance(e, BinOp):
            return self._eval_binop(e, fr)
        if isinstance(e, Func):
            return self._eval_func(e, fr)
        if isinstance(e, Cast):
            return self._eval_cast(e, fr)
        if isinstance(e, Case):
            return self._eval_case(e, fr)
        if isinstance(e, Subquery):
            if e.kind == "mark_in":
                return self._eval_mark_in(e, fr)
            return self._eval_subquery(e)
        if isinstance(e, WinRef):
            return self._eval_winref(e, fr)
        if isinstance(e, (Cmp, BoolOp, Not, IsNull, Between, InList, Like)):
            cand = self.eval_pred(e, fr)
            m = cand.as_mask(fr.cap, self.device)
            return Column(I8, m.to(torch.int8), fr.count, nonil=True)
        raise ExecError(f"cannot evaluate {type(e).__name__}")

    def _const(self, e: Const) -> Scalar:
        v = e.value
        typ = e.typ
        if v is None:
            return Scalar(None, typ)
        if isinstance(v, PyDecimal):
            scale = typ.scale if typ is not None else 0
            return Scalar(int(v.scaleb(scale).to_integral_value()), typ)
        if isinstance(v, datetime.datetime):
            from ..dtypes import TIMESTAMP as _TS
            us = int((v - datetime.datetime(1970, 1, 1)).total_seconds()
                     * 1_000_000)
            return Scalar(us, typ or _TS)
        if isinstance(v, datetime.date):
            return Scalar((v - datetime.date(1970, 1, 1)).days, typ or DATE)
        if isinstance(v, datetime.time):
            from ..dtypes import TIME as _TIME
            us = ((v.hour * 60 + v.minute) * 60 + v.second) * 1_000_000 \
                + v.microsecond
            return Scalar(us, typ or _TIME)
        if isinstance(v, bool):
            return Scalar(bool(v), typ or BOOL)
        if isinstance(v, (int, float, str)):
            return Scalar(v, typ)
        if isinstance(v, tuple):
            return Scalar(v, None)    # interval pseudo-const
        raise ExecError(f"cannot lower constant {v!r}")

    def _eval_mark_in(self, e: Subquery, fr: Frame) -> Column:
        """x = ANY(S) / x <> ALL(S) in value position: per-row membership
        with the 3-valued certainty of BATmarkjoin (gdk/gdk_join.c:4367) —
        i8 1/0/nil: nil when no match but x is nil or S holds nils."""
        _tag, rel, scols = e.select
        frame = self._sub().run(rel)
        scol = frame.get("#out", scols[0].name)
        xv = self.eval(e.outer, fr)
        nil8 = np.int8(np.iinfo(np.int8).min)
        n = fr.count
        if scol.typ.kind == Kind.STR:
            sl = [None if v is None else str(v)
                  for v in scol.to_numpy(decode=True)[:frame.count]]
            svals = np.asarray([v for v in sl if v is not None], object)
            s_nil = np.asarray([v is None for v in sl], bool)
            if isinstance(xv, Scalar):
                xs = np.full(n, xv.value, object)
                x_nil = np.full(n, xv.value is None, bool)
            else:
                xl = [None if v is None else str(v)
                      for v in xv.to_numpy(decode=True)[:n]]
                xs = np.asarray([("" if v is None else v) for v in xl],
                                object)
                x_nil = np.asarray([v is None for v in xl], bool)
            member = np.isin(xs, svals) & ~x_nil
        else:
            svals = scol.data[:frame.count].cpu().numpy()
            if scol.typ.np_dtype.kind == "i":
                s_nil = svals == np.iinfo(scol.typ.np_dtype).min
            elif scol.typ.np_dtype.kind == "f":
                s_nil = np.isnan(svals)
            else:
                s_nil = np.zeros(len(svals), bool)
            if isinstance(xv, Scalar):
                x_nil = np.full(n, xv.value is None, bool)
                xs = np.zeros(n) if xv.value is None else \
                    np.full(n, xv.value)
            else:
                xs = xv.data[:n].cpu().numpy()
                if xv.typ.np_dtype.kind == "i":
                    x_nil = xs == np.iinfo(xv.typ.np_dtype).min
                elif xv.typ.np_dtype.kind == "f":
                    x_nil = np.isnan(xs)
                else:
                    x_nil = np.zeros(n, bool)
            # align decimal scales / float-vs-decimal physicals (the
            # binder's coercion rules, executor._eval_binop analog)
            sv = svals[~s_nil]
            ss = scol.typ.scale if scol.typ.kind == Kind.DECIMAL else 0
            xt = xv.typ
            sx = xt.scale if xt is not None and \
                xt.kind == Kind.DECIMAL else 0
            xf = xt is not None and xt.np_dtype.kind == "f"
            sf = scol.typ.np_dtype.kind == "f"
            if xf and not sf:
                sv = sv / (10.0 ** ss)
            elif sf and not xf:
                xs = xs / (10.0 ** sx)
            elif sx > ss:
                sv = sv * (10 ** (sx - ss))
            elif ss > sx:
                xs = xs * (10 ** (ss - sx))
            member = np.isin(xs, sv) & ~x_nil
        has_nil_s = bool(s_nil.any())
        empty = frame.count == 0
        out = np.where(member, np.int8(1), np.int8(0))
        if e.negated:
            out = np.where(member, np.int8(0), np.int8(1))
        if not empty:
            unknown = (~member) & (x_nil | has_nil_s)
            out = np.where(unknown, nil8, out)
        full = np.full(fr.cap, nil8)
        full[:n] = out
        from ..dtypes import I8 as _I8
        return Column(_I8, torch.from_numpy(full).to(self.device), fr.count,
                      nonil=False)

    def _eval_subquery(self, e: Subquery) -> Scalar:
        if not (isinstance(e.select, tuple) and e.select[0] == "bound"):
            raise ExecError("unbound subquery reached executor")
        _tag, rel, scols = e.select
        sub = self._sub()
        frame = sub.run(rel)
        col = frame.get("#out", scols[0].name)
        if frame.count == 0:
            return Scalar(None, col.typ)
        v = col.data[0].cpu().numpy()
        if col.typ.np_dtype.kind == "f":
            fv = float(v)
            return Scalar(None if np.isnan(fv) else fv, col.typ)
        iv = int(v)
        if col.typ.np_dtype.kind == "i" and iv == np.iinfo(col.typ.np_dtype).min:
            return Scalar(None, col.typ)
        if col.typ.kind == Kind.STR:
            return Scalar(str(col.sdict.values[iv]), col.typ)
        return Scalar(iv, col.typ)

    # window functions --------------------------------------------------------
    def _eval_winref(self, e: WinRef, fr: Frame) -> Column:
        """Window evaluation on the (partition, order)-sorted row domain
        (the reference sorts, applies gdk_analytic kernels, and the result
        rides the sorted rows — sql_rank.c; here we sort, compute, unsort)."""
        n = fr.count
        part_cols = []
        for p in e.partition:
            v = self.eval(p, fr)
            part_cols.append(self._broadcast(v, fr) if isinstance(v, Scalar)
                             else v)
        order_cols, descs = [], []
        for o, d in e.order:
            v = self.eval(o, fr)
            order_cols.append(self._broadcast(v, fr)
                              if isinstance(v, Scalar) else v)
            descs.append(d)
        # combined window sort (sql_rank.c): partition keys, refined by
        # order keys.  A partition key that ALSO appears in ORDER BY
        # takes the ORDER BY's direction (the reference dedups the sort
        # spec that way - analytics00 pins partition blocks in bb DESC
        # for `partition by bb order by bb desc`).  MonetDB sorts nils
        # FIRST in both directions.
        order_reprs = [str(o) for o, _d in e.order]
        part_descs = []
        for p in e.partition:
            pr = str(p)
            part_descs.append(descs[order_reprs.index(pr)]
                              if pr in order_reprs else False)
        sort_cols = part_cols + order_cols
        if sort_cols:
            oids, cnt = SRT.argsort(
                sort_cols, part_descs + descs,
                nils_last=[False] * len(sort_cols))
            # remember the window's row order: a projection with no
            # ORDER BY of its own surfaces rows in this order (see
            # _exec_project)
            self._win_order = (oids, cnt)
        else:
            oids = torch.where(valid_mask(fr.cap, n, self.device),
                               iota(fr.cap, self.device), -1)
            cnt = n
        sp = [P.project_oids(oids, cnt, c) for c in part_cols]
        so = [P.project_oids(oids, cnt, c) for c in order_cols]
        pb = W.multi_boundary(sp, cnt) if sp else \
            W.first_row_boundary(oids.shape[0], cnt, self.device)
        ob = W.multi_boundary(so, cnt) if so else None

        func = e.func
        arg = None
        if e.arg is not None:
            a = self.eval(e.arg, fr)
            a = self._broadcast(a, fr) if isinstance(a, Scalar) else a
            arg = P.project_oids(oids, cnt, a)

        if func == "row_number":
            out = W.row_number(pb)
        elif func == "rank":
            out = W.rank(pb, ob if ob is not None else pb)
        elif func == "dense_rank":
            out = W.dense_rank(pb, ob if ob is not None else pb)
        elif func == "percent_rank":
            out = W.percent_rank(pb, ob if ob is not None else pb)
        elif func == "cume_dist":
            out = W.cume_dist(pb, ob if ob is not None else pb)
        elif func == "ntile":
            k = e.arg
            kv = self.eval(k, fr).value if k is not None else 1
            out = W.ntile(pb, int(kv))
        elif func in ("lag", "lead"):
            off = 1
            if e.extra:
                off = int(self.eval(e.extra[0], fr).value)
            out = (W.lag if func == "lag" else W.lead)(arg, pb, offset=off)
        elif func == "first_value":
            out = W.first_value(arg, pb)
        elif func == "nth_value":
            k = int(self.eval(e.extra[0], fr).value) if e.extra else 1
            out = W.nth_value(arg, pb, k)
        elif func == "last_value":
            if e.frame != "full":
                raise ExecError("last_value with running frame unsupported")
            out = W.last_value(arg, pb)
        elif func in ("sum", "avg", "min", "max", "count", "count_star"):
            if isinstance(e.frame, tuple):
                unit, lo, hi = e.frame
                order_vals = None
                if so:
                    if unit == "range" and len(so) > 1:
                        raise ExecError(
                            "RANGE frame requires exactly one ORDER BY key")
                    ov = so[0]
                    order_vals = ov.data
                    if unit == "range":
                        osc = ov.typ.scale \
                            if ov.typ.kind == Kind.DECIMAL else 0
                        if osc:
                            lo = None if lo is None else \
                                int(PyDecimal(lo).scaleb(osc))
                            hi = None if hi is None else \
                                int(PyDecimal(hi).scaleb(osc))
                        else:
                            lo = None if lo is None else int(lo)
                            hi = None if hi is None else int(hi)
                        if descs and descs[0]:
                            # DESC order: negate values; [lo, hi] offsets
                            # keep their meaning in negated space
                            order_vals = -order_vals
                out = W.framed_agg(func, arg, pb, order_vals, unit, lo, hi,
                                   cnt)
            else:
                out = W.windowed_agg(func, arg, pb, ob, e.frame, cnt)
        else:
            raise ExecError(f"window function {func} unsupported")

        # unsort back to the frame's row order
        data = _unsort(out.data, oids, cnt)
        return Column(out.typ, data, n, nonil=out.nonil, sdict=out.sdict)

    # arithmetic ------------------------------------------------------------
    _OPMAP = {"+": "add", "-": "sub", "*": "mul", "/": "div", "%": "mod"}

    def _eval_binop(self, e: BinOp, fr: Frame):
        a = self.eval(e.left, fr)
        b = self.eval(e.right, fr)
        # column ± interval (mtime addition operators over DATE/TIMESTAMP)
        if isinstance(b, Scalar) and isinstance(b.value, tuple):
            amt, unit = b.value
            if e.op == "-":
                amt = -amt
            if isinstance(a, Scalar):
                raise ExecError("scalar ± interval should fold in binder")
            return DT.add_interval_col(a, int(amt), unit)
        if isinstance(a, Scalar) and isinstance(a.value, tuple) \
                and e.op == "+":
            amt, unit = a.value
            if isinstance(b, Column):
                return DT.add_interval_col(b, int(amt), unit)
        if e.op == "||":
            return self._concat(a, b)
        if isinstance(a, Scalar) and isinstance(b, Scalar):
            return self._fold_scalars(e.op, a, b)
        op = self._OPMAP[e.op]

        # float path: any float operand ⇒ f64 arithmetic
        if _is_float(a) or _is_float(b):
            a = _to_f64_col(a) if isinstance(a, Column) else Scalar(
                _to_f64_scalar(a), F64)
            b = _to_f64_col(b) if isinstance(b, Column) else Scalar(
                _to_f64_scalar(b), F64)
            return self._binop_dispatch(op, a, b, F64, fr)

        sa, sb = _scale_of(a), _scale_of(b)
        if op == "mul":
            s = sa + sb
            out = dec_t(18, s) if s else None
            return self._binop_dispatch(op, a, b, out, fr)
        if op in ("add", "sub"):
            s = max(sa, sb)
            if sa < s:
                a = self._rescale(a, s - sa)
            if sb < s:
                b = self._rescale(b, s - sb)
            out = dec_t(18, s) if s else None
            return self._binop_dispatch(op, a, b, out, fr)
        if op == "div":
            if sa == 0 and sb == 0:
                return self._binop_dispatch(op, a, b, None, fr)
            a = _to_f64_col(a) if isinstance(a, Column) else Scalar(
                _to_f64_scalar(a), F64)
            b = _to_f64_col(b) if isinstance(b, Column) else Scalar(
                _to_f64_scalar(b), F64)
            return self._binop_dispatch(op, a, b, F64, fr)
        if op == "mod":
            return self._binop_dispatch(op, a, b, None, fr)
        raise ExecError(f"operator {e.op}")

    def _concat(self, a, b):
        """|| / concat over any Column/Scalar string combination."""
        def as_str(v):
            if isinstance(v, Scalar):
                return None if v.value is None else str(v.value)
            return v
        if isinstance(a, Scalar) and isinstance(b, Scalar):
            if a.value is None or b.value is None:
                from ..dtypes import varchar
                return Scalar(None, varchar())
            from ..dtypes import varchar
            return Scalar(str(a.value) + str(b.value), varchar())
        if isinstance(a, Column) and isinstance(b, Scalar):
            if b.value is None:
                return self._nil_str_col(a.count)
            return SF.concat(a, str(b.value))
        if isinstance(a, Scalar) and isinstance(b, Column):
            if a.value is None:
                return self._nil_str_col(b.count)
            return SF.concat(b, str(a.value), prefix=True)
        return SF.concat_cols(a, b)

    def _nil_str_col(self, count: int) -> Column:
        from ..dtypes import varchar
        sd = StrDict(np.empty(0, dtype=str))
        return Column(varchar(),
                      self._full(capacity_for(count), nil_const(torch.int32),
                                 torch.int32),
                      count, nonil=False, sdict=sd)

    def _rescale(self, x, k: int):
        if isinstance(x, Column):
            return _upscale_col(x, k)
        if x.value is None:
            return Scalar(None, dec_t(18, x.scale + k))
        return Scalar(int(x.value) * 10 ** k, dec_t(18, x.scale + k))

    def _binop_dispatch(self, op, a, b, out_typ, fr: Frame):
        if isinstance(a, Scalar) and op in ("sub", "div", "mod"):
            a = self._broadcast(a, fr)
        if isinstance(a, Scalar):
            a, b = b, a   # commutative: put the column first
        if isinstance(b, Scalar):
            if b.value is None:
                return Scalar(None, out_typ or a.typ)
            return C.binop(op, a, b.value, out_typ=out_typ)
        return C.binop(op, a, b, out_typ=out_typ)

    def _fold_scalars(self, op: str, a: Scalar, b: Scalar) -> Scalar:
        if a.value is None or b.value is None:
            return Scalar(None, a.typ or b.typ)
        if _is_float(a) or _is_float(b) or op == "/":
            av, bv = _to_f64_scalar(a), _to_f64_scalar(b)
            v = {"+": av + bv, "-": av - bv, "*": av * bv,
                 "/": av / bv if bv else float("nan")}[op]
            return Scalar(v, F64)
        sa, sb = a.scale, b.scale
        if op == "*":
            return Scalar(int(a.value) * int(b.value),
                          dec_t(18, sa + sb) if sa + sb else I64)
        s = max(sa, sb)
        av = int(a.value) * 10 ** (s - sa)
        bv = int(b.value) * 10 ** (s - sb)
        v = av + bv if op == "+" else av - bv
        return Scalar(v, dec_t(18, s) if s else I64)

    # functions ---------------------------------------------------------------
    _DATE_FUNCS = frozenset({
        "year", "month", "day", "dayofmonth", "quarter", "dayofweek",
        "weekday", "dayofyear", "weekofyear", "week", "hour", "minute",
        "second", "century", "decade", "epoch"})

    def _eval_func(self, e: Func, fr: Frame):
        if e.name == "like_expr":
            # x LIKE <expr>: the pattern varies per row — decode both
            # sides and match on the host (pcre.c likematch over two
            # columns; inherently row-wise)
            import re as _re
            from ..engine import _decode_column
            a = self.eval(e.args[0], fr)
            p = self.eval(e.args[1], fr)
            neg = bool(getattr(e, "like_negated", False))
            flags = _re.DOTALL | (_re.IGNORECASE if
                                  getattr(e, "like_caseless", False)
                                  else 0)

            def match(x, pat):
                if x is None or pat is None:
                    return False
                rx = _re.compile(SF.like_regex(str(pat)).pattern, flags)
                return (rx.match(str(x)) is not None) != neg
            xs = [a.value] * fr.count if isinstance(a, Scalar) \
                else _decode_column(a)
            ps = [p.value] * fr.count if isinstance(p, Scalar) \
                else _decode_column(p)
            vals = np.array([match(x, q) for x, q in zip(xs, ps)],
                            np.bool_)
            return Column(BOOL, torch.from_numpy(
                np.pad(vals, (0, fr.cap - len(vals)))).to(self.device),
                fr.count, nonil=True)
        if e.name.startswith("extract_"):
            col = self.eval(e.args[0], fr)
            if isinstance(col, Scalar):
                col = self._broadcast(col, fr)
            return DT.extract(e.name[len("extract_"):], col)
        if e.name in self._DATE_FUNCS:
            col = self.eval(e.args[0], fr)
            if isinstance(col, Scalar):
                col = self._broadcast(col, fr)
            return DT.extract(e.name, col)
        if e.name in ("left", "right", "repeat", "reverse", "ascii",
                      "splitpart", "md5", "regexp_replace") or \
                (e.name == "insert" and len(e.args) == 4):
            a0 = self.eval(e.args[0], fr)
            if isinstance(a0, Scalar):
                a0 = self._broadcast(a0, fr)
            rest = [self.eval(a, fr).value for a in e.args[1:]]
            if e.name in ("left", "right"):
                fn = SF.left_str if e.name == "left" else SF.right_str
                return fn(a0, int(rest[0]))
            if e.name == "repeat":
                return SF.repeat(a0, int(rest[0]))
            if e.name == "reverse":
                return SF.reverse(a0)
            if e.name == "ascii":
                return SF.ascii_code(a0)
            if e.name == "splitpart":
                return SF.splitpart(a0, str(rest[0]), int(rest[1]))
            if e.name == "md5":
                return SF.md5_hex(a0)
            if e.name == "regexp_replace":
                flags = str(rest[2]) if len(rest) > 2 else ""
                return SF.regexp_replace(a0, str(rest[0]), str(rest[1]),
                                         flags)
            return SF.str_insert(a0, int(rest[0]), int(rest[1]),
                                 str(rest[2]))
        if e.name == "date_trunc":
            field = str(self.eval(e.args[0], fr).value)
            col = self.eval(e.args[1], fr)
            if isinstance(col, Scalar):
                col = self._broadcast(col, fr)
            return DT.date_trunc(field, col)
        if e.name in ("coalesce", "ifnull", "nvl"):
            return self._eval_coalesce(e, fr)
        if e.name == "nullif":
            return self._eval_nullif(e, fr)
        if e.name in ("greatest", "least", "sql_max", "sql_min"):
            return self._eval_greatest(e, fr)
        if e.name == "substring":
            col = self.eval(e.args[0], fr)
            start = self.eval(e.args[1], fr).value
            length = self.eval(e.args[2], fr).value if len(e.args) > 2 else None
            if isinstance(col, Scalar):
                if col.value is None:
                    return col
                s = str(col.value)[max(int(start) - 1, 0):]
                if length is not None:
                    s = s[:max(int(length), 0)]
                return Scalar(s, col.typ)
            return SF.substring(col, int(start), length)
        if e.name in ("neg", "abs"):
            v = self.eval(e.args[0], fr)
            if isinstance(v, Scalar):
                if v.value is None:
                    return v
                nv = -v.value if e.name == "neg" else abs(v.value)
                return Scalar(nv, v.typ)
            return C.unop(e.name, v)
        if e.name in ("upper", "ucase", "lower", "lcase", "trim", "ltrim",
                      "rtrim"):
            col = self.eval(e.args[0], fr)
            if isinstance(col, Scalar):
                if col.value is None:
                    return col
                pf = {"upper": str.upper, "ucase": str.upper,
                      "lower": str.lower, "lcase": str.lower,
                      "trim": str.strip, "ltrim": str.lstrip,
                      "rtrim": str.rstrip}[e.name]
                return Scalar(pf(str(col.value)), col.typ)
            fn = {"upper": SF.upper, "ucase": SF.upper, "lower": SF.lower,
                  "lcase": SF.lower, "trim": SF.trim, "ltrim": SF.ltrim,
                  "rtrim": SF.rtrim}[e.name]
            return fn(col)
        if e.name in ("length", "char_length", "character_length",
                      "octet_length"):
            from ..dtypes import is_blob
            col = self.eval(e.args[0], fr)
            nbytes = isinstance(col, (Scalar, Column)) and \
                is_blob(col.typ)    # blob length counts bytes (hex/2)
            if isinstance(col, Scalar):
                if col.value is None:
                    return Scalar(None, I32)
                n = len(str(col.value))
                return Scalar(n // 2 if nbytes else n, I32)
            out = SF.length(col)
            if nbytes:
                # halve only non-nil lengths: the nil sentinel must pass
                # through unchanged (INT32_MIN//2 would leak as a value)
                data = torch.where(out.data == nil_const(torch.int32),
                                   out.data, out.data // 2)
                out = Column(I32, data, out.count, nonil=out.nonil)
            return out
        if e.name == "replace":
            col = self.eval(e.args[0], fr)
            old = self.eval(e.args[1], fr).value
            new = self.eval(e.args[2], fr).value
            return SF.replace(col, str(old), str(new))
        if e.name in ("locate", "position"):
            # locate(sub, s) (MonetDB modules/atoms/str.c convention)
            sub = self.eval(e.args[0], fr).value
            col = self.eval(e.args[1], fr)
            return SF.position(col, str(sub))
        if e.name in ("lpad", "rpad"):
            col = self.eval(e.args[0], fr)
            k = int(self.eval(e.args[1], fr).value)
            fill = " "
            if len(e.args) > 2:
                fill = str(self.eval(e.args[2], fr).value)
            fn = SF.lpad if e.name == "lpad" else SF.rpad
            return fn(col, k, fill)
        if e.name == "concat":
            a = self.eval(e.args[0], fr)
            b = self.eval(e.args[1], fr)
            return self._concat(a, b)
        if e.name == "uuid" and not e.args:
            # uuid() generates a fresh value per row (atoms/uuid.c)
            from ..ops import atoms as AT
            from ..dtypes import varchar as _vc
            vals = [AT.new_uuid() for _ in range(fr.count)]
            return self._from_py(vals, _vc())
        if e.name == "isauuid":
            from ..ops import atoms as AT
            col = self.eval(e.args[0], fr)
            if isinstance(col, Scalar):
                col = self._broadcast(col, fr)
            return AT.isa_uuid(col)
        if e.name.startswith("get") and e.name[3:] in (
                "protocol", "host", "domain", "file", "basename", "anchor",
                "query", "user", "port", "context"):
            from ..ops import atoms as AT
            col = self.eval(e.args[0], fr)
            if isinstance(col, Scalar):
                col = self._broadcast(col, fr)
            return AT.url_get(col, e.name[3:])
        if e.name in ("inet_contains", "inet_contained_or_equal"):
            from ..ops import atoms as AT
            col = self.eval(e.args[0], fr)
            if isinstance(col, Scalar):
                col = self._broadcast(col, fr)
            net = str(self.eval(e.args[1], fr).value)
            cand = AT.inet_contains(col, net,
                                    equal_ok=e.name.endswith("equal"))
            return Column(BOOL, cand.as_mask(fr.cap, self.device), fr.count, nonil=True)
        if e.name in ("startswith", "endswith", "contains"):
            col = self.eval(e.args[0], fr)
            v = str(self.eval(e.args[1], fr).value)
            cand = {"startswith": SF.startswith, "endswith": SF.endswith,
                    "contains": SF.contains}[e.name](col, v)
            m = cand.as_mask(fr.cap, self.device)
            return Column(BOOL, m, fr.count, nonil=True)
        if e.name in ("sqrt", "ln", "log10", "exp", "sin", "cos", "tan",
                      "floor", "ceil", "ceiling", "power", "mod"):
            return self._eval_math(e, fr)
        if e.name in ("round", "truncate", "trunc"):
            # round(x[, d]) / truncate(x[, d]) — sql_round: decimals keep
            # their type, half away from zero (sql/common/sql_types.c)
            v = self.eval(e.args[0], fr)
            d = int(self.eval(e.args[1], fr).value) if len(e.args) > 1 \
                else 0
            trunc = e.name != "round"
            if isinstance(v, Scalar):
                if v.value is None:
                    return v
                if v.is_float():
                    import math
                    x = float(v.value)
                    f = 10.0 ** d
                    y = math.trunc(x * f) / f if trunc else \
                        math.floor(abs(x) * f + 0.5) / f * (1 if x >= 0
                                                            else -1)
                    return Scalar(y, v.typ or F64)
                sc = v.scale
                if d >= sc:
                    return v
                f = 10 ** (sc - d)
                val = int(v.value)
                q = abs(val) // f
                if not trunc and abs(val) % f >= f // 2:
                    q += 1
                return Scalar(q * f * (1 if val >= 0 else -1), v.typ)
            if v.typ.np_dtype.kind == "f":
                f = 10.0 ** d
                x = v.data * f
                y = torch.trunc(x) if trunc else \
                    torch.sign(x) * torch.floor(torch.abs(x) + 0.5)
                return Column(v.typ, y / f, v.count, nonil=v.nonil)
            sc = v.typ.scale if v.typ.kind == Kind.DECIMAL else 0
            if d >= sc:
                return v
            f = 10 ** (sc - d)
            a = v.data
            # |a| >= 0, so floor division and modulo are truncating
            q = torch.abs(a) // f
            if not trunc:
                q = q + torch.where(torch.abs(a) % f >= f // 2, 1, 0)
            out = torch.where(a == nil_const(a.dtype), a,
                              q * f * torch.where(a >= 0, 1, -1))
            return Column(v.typ, out, v.count, nonil=v.nonil)
        if e.name in ("levenshtein", "editdistance", "editdistance2",
                      "jarowinkler", "difference"):
            a = self.eval(e.args[0], fr)
            b = self.eval(e.args[1], fr)
            if isinstance(a, Scalar) and isinstance(b, Column):
                a, b = b, a      # txtsim metrics are symmetric
            if not (isinstance(a, Column) and isinstance(b, Scalar)):
                raise ExecError(f"{e.name} expects (column, constant)")
            from ..obs import set_algorithm
            set_algorithm(f"txtsim:{e.name}")
            other = str(b.value)
            fn = {"levenshtein": SF.levenshtein,
                  "editdistance": SF.editdistance,
                  "editdistance2": SF.editdistance,
                  "jarowinkler": SF.jarowinkler,
                  "difference": SF.difference}[e.name]
            return fn(a, other)
        if e.name in ("soundex", "qgramnormalize"):
            col = self.eval(e.args[0], fr)
            return (SF.soundex if e.name == "soundex"
                    else SF.qgram_normalize)(col)
        if e.name in ("json_isvalid", "json_filter", "json_text",
                      "json_length", "json_keyarray", "json_valuearray"):
            from ..ops import jsonfuncs as JF
            col = self.eval(e.args[0], fr)
            if not isinstance(col, Column):
                raise ExecError(f"{e.name} expects a string column")
            if e.name == "json_filter":
                path = str(self.eval(e.args[1], fr).value)
                return JF.filter_path(col, path)
            if e.name == "json_text":
                sep = " "
                if len(e.args) > 1:
                    sep = str(self.eval(e.args[1], fr).value)
                return JF.text(col, sep)
            return {"json_isvalid": JF.isvalid, "json_length": JF.length,
                    "json_keyarray": JF.keyarray,
                    "json_valuearray": JF.valuearray}[e.name](col)
        if e.name in ("str_to_date", "str_to_timestamp", "str_to_time",
                      "date_to_str", "timestamp_to_str", "time_to_str"):
            return self._eval_strtime(e, fr)
        if e.name.startswith("st_"):
            return self._eval_geom(e, fr)
        if e.name == "next_value_for":
            nsb = getattr(self.catalog, "next_sequence_block", None)
            if nsb is None:
                raise ExecError("no sequence store in this catalog")
            name = str(self.eval(e.args[0], fr).value).lower()
            inc = self.catalog.sequences[name]["inc"]
            first = nsb(name, fr.count)
            vals = first + iota(fr.cap, self.device) * inc
            return Column(I64, vals, fr.count)
        u = self.catalog.udfs.get(e.name)
        if u is not None:
            return self._eval_udf(u, e, fr)
        raise ExecError(f"function {e.name} unsupported")

    def _eval_strtime(self, e: Func, fr: Frame):
        """mtime strptime/strftime family (modules/atoms/mtime.c
        str_to_date/date_to_str etc., C strftime format directives)."""
        import datetime as _dt
        from ..engine import _decode_column
        fmt = str(self.eval(e.args[1], fr).value)
        v = self.eval(e.args[0], fr)
        name = e.name
        if name.startswith("str_to_"):
            parse = {"str_to_date":
                     lambda s: _dt.datetime.strptime(s, fmt).date(),
                     "str_to_timestamp":
                     lambda s: _dt.datetime.strptime(s, fmt),
                     "str_to_time":
                     lambda s: _dt.datetime.strptime(s, fmt).time()}[name]
            if isinstance(v, Scalar):
                val = None if v.value is None else parse(str(v.value))
                from ..storage.columns import to_physical_np
                phys = to_physical_np([val], e.typ)[0]
                return Scalar(None if val is None else int(phys), e.typ)
            vals = [None if x is None else parse(str(x))
                    for x in _decode_column(v)]
            return self._from_py(vals, e.typ)
        if not isinstance(v, Column):
            raise ExecError(f"{name} expects a temporal column")
        vals = [None if x is None else x.strftime(fmt)
                for x in _decode_column(v)]
        return self._from_py(vals, e.typ)

    def _eval_geom(self, e: Func, fr: Frame):
        raise ExecError(f"geometry function {e.name}: needs ops/geom.py, "
                        "which is not ported yet")

    def _eval_udf(self, u, e: Func, fr: Frame):
        """Vectorized Python UDF call (pyapi3 analog): columns → host
        numpy → body → column of the declared type on this device."""
        from ..obs import set_algorithm
        from ..udf import udf_from_host, udf_to_host
        args = []
        for a in e.args:
            v = self.eval(a, fr)
            if isinstance(v, Scalar):
                args.append(v.value)
            else:
                args.append(udf_to_host(v, v.typ))
        set_algorithm(f"python_udf:{u.name}")
        res = u.fn(*args)
        return udf_from_host(res, fr.count, u.ret_type, self.device)

    def _eval_math(self, e: Func, fr: Frame):
        """mmath/batmmath parity (modules/kernel/batmmath.c): float math
        over f64 with nil (NaN) propagation for free."""
        a = self.eval(e.args[0], fr)
        if isinstance(a, Scalar):
            a = self._broadcast(a, fr)
        x = _to_f64_col(a).data
        nm = e.name
        if nm == "power":
            b = self.eval(e.args[1], fr)
            p = _to_f64_scalar(b) if isinstance(b, Scalar) else \
                _to_f64_col(b).data
            out = x ** p
        elif nm == "mod":
            b = self.eval(e.args[1], fr)
            return self._binop_dispatch("mod", a, b, None, fr)
        else:
            fn = {"sqrt": torch.sqrt, "ln": torch.log, "log10": torch.log10,
                  "exp": torch.exp, "sin": torch.sin, "cos": torch.cos,
                  "tan": torch.tan, "floor": torch.floor,
                  "ceil": torch.ceil, "ceiling": torch.ceil}[nm]
            out = fn(x)
        out = torch.where(a.live_mask(), out, float("nan"))
        return Column(F64, out, a.count, nonil=False)

    def _eval_cast(self, e: Cast, fr: Frame):
        v = self.eval(e.arg, fr)
        to = e.to
        from ..dtypes import is_blob
        if is_blob(to):
            # CAST(x AS BLOB): normalize to uppercase hex, validate
            # (gdk_atoms.c blobFromStr)
            from ..engine import _decode_column
            if isinstance(v, Scalar):
                return Scalar(None if v.value is None
                              else _hex_norm(str(v.value)), to)
            vals = [None if x is None else _hex_norm(str(x))
                    for x in _decode_column(v)]
            return self._from_py(vals, to)
        if isinstance(v, Column) and to.kind == Kind.STR \
                and v.typ.kind != Kind.STR:
            # value→string cast: host-side format, re-encode as dictionary
            # column (gdk_calc_convert.c convert_any_str analog)
            from ..engine import _decode_column
            vals = [None if x is None else str(x)
                    for x in _decode_column(v)]
            return self._from_py(vals, to)
        if isinstance(v, Column) and v.typ.kind == Kind.STR \
                and to.kind != Kind.STR:
            # string→value cast: parse each *distinct* value on host,
            # apply by gather (convert_str_any analog)
            from ..engine import _decode_column
            vals = [None if x is None else _parse_str_cast(x, to)
                    for x in _decode_column(v)]
            return self._from_py(vals, to)
        if isinstance(v, Scalar):
            if v.value is None:        # typeless NULL: cast is just typing
                return Scalar(None, to)
            if to.kind == Kind.STR:
                return Scalar(str(v.value), to)
            if v.typ.kind == Kind.STR and v.value is not None:
                val = _parse_str_cast(str(v.value), to)
                if to.kind == Kind.DECIMAL:
                    val = int(val.scaleb(to.scale).to_integral_value())
                return Scalar(val, to)
            k = (to.scale if to.kind == Kind.DECIMAL else 0) - v.scale
            if v.value is None:
                return Scalar(None, to)
            if to.np_dtype.kind == "f":
                return Scalar(_to_f64_scalar(v), to)
            val = int(v.value) * 10 ** k if k >= 0 else \
                int(round(int(v.value) / 10 ** (-k)))
            return Scalar(val, to)
        fs = v.typ.scale if v.typ.kind == Kind.DECIMAL else 0
        ts = to.scale if to.kind == Kind.DECIMAL else 0
        return C.convert(v, to, scale_up=max(0, ts - fs),
                         scale_down=max(0, fs - ts))

    def _coerce_val(self, v, out_typ):
        """Coerce a Column/Scalar to the target numeric/temporal type
        (decimal scale alignment, float promotion)."""
        out_scale = out_typ.scale if out_typ.kind == Kind.DECIMAL else 0
        if isinstance(v, Scalar):
            if v.value is None:
                return Scalar(None, out_typ)
            if out_typ.np_dtype.kind == "f":
                return Scalar(_to_f64_scalar(v), out_typ)
            if out_typ.kind == Kind.STR:
                return v
            return Scalar(int(v.value) * 10 ** (out_scale - v.scale), out_typ)
        if out_typ.kind == Kind.STR:
            return v
        vs = v.typ.scale if v.typ.kind == Kind.DECIMAL else 0
        if out_typ.np_dtype.kind == "f":
            return _to_f64_col(v)
        if vs < out_scale:
            return _upscale_col(v, out_scale - vs)
        return v

    def _unify_strings(self, vals):
        """Remap string Columns/Scalars onto one merged order-preserving
        dictionary so code-space comparisons/selects stay valid (the
        engine's global-dictionary invariant, dict.c analog). Non-string
        operands (mixed-type COALESCE/CASE) convert to strings first
        (convert_any_str, gdk_calc_convert.c)."""
        conv = []
        for v in vals:
            if isinstance(v, Column) and v.typ.kind != Kind.STR:
                from ..engine import _decode_column
                from ..dtypes import varchar as _vc
                vv = [None if x is None else str(x)
                      for x in _decode_column(v)]
                v = self._from_py(vv, _vc())
            elif isinstance(v, Scalar) and v.typ is not None and \
                    v.typ.kind != Kind.STR and v.value is not None:
                from ..dtypes import varchar as _vc
                v = Scalar(str(v.value), _vc())
            conv.append(v)
        vals = conv
        pieces = []
        for v in vals:
            if isinstance(v, Column) and v.sdict is not None:
                pieces.append(np.asarray(v.sdict.values, dtype=str))
            elif isinstance(v, Scalar) and v.value is not None:
                pieces.append(np.array([str(v.value)]))
        merged = np.unique(np.concatenate(pieces)) if pieces \
            else np.empty(0, dtype=str)
        sd = StrDict(merged)
        out = []
        for v in vals:
            if isinstance(v, Column):
                if v.sdict is None or len(v.sdict.values) == 0:
                    out.append(Column(v.typ, v.data, v.count, nonil=False,
                                      sdict=sd))
                    continue
                m = np.searchsorted(merged, v.sdict.values).astype(np.int32)
                nd = _remap_codes(v.data, m)
                out.append(Column(v.typ, nd, v.count, nonil=v.nonil,
                                  sdict=sd))
            else:
                if v.value is None:
                    out.append(Scalar(None, v.typ))
                else:
                    out.append(Scalar(int(np.searchsorted(
                        merged, str(v.value))), v.typ))
        return out, sd

    def _fold_conditional(self, conds, vals, default, out_typ, fr: Frame):
        """Shared CASE/COALESCE folding: right-to-left ifthenelse chain."""
        sd = None
        if out_typ.kind == Kind.STR:
            unified, sd = self._unify_strings(vals + [default])
            vals, default = unified[:-1], unified[-1]
        else:
            vals = [self._coerce_val(v, out_typ) for v in vals]
            default = self._coerce_val(default, out_typ)
        result = default
        # a NULL scalar branch injects nil sentinels: the folded column
        # must not claim nonil (downstream aggregates rely on the flag to
        # skip sentinel values, BATgroupsum skip_nils)
        any_null = any(isinstance(v, Scalar) and v.value is None
                       for v in list(vals) + [default])
        for cnd, v in zip(reversed(conds), reversed(vals)):
            cm = Column(BOOL, cnd.as_mask(fr.cap, self.device), fr.count, nonil=True)
            av = v if isinstance(v, Column) else (
                out_typ.nil if v.value is None else v.value)
            bv = result if isinstance(result, Column) else (
                out_typ.nil if result.value is None else result.value)
            result = C.ifthenelse(cm, av, bv, out_typ)
            if sd is not None:
                result.sdict = sd
        if isinstance(result, Column) and any_null:
            result = Column(result.typ, result.data, result.count,
                            nonil=False, sdict=result.sdict)
        return result

    def _eval_case(self, e: Case, fr: Frame):
        out_typ = e.typ or F64
        conds = [self.eval_pred(c, fr) for c, _ in e.whens]
        vals = [self.eval(v, fr) for _, v in e.whens]
        default = self.eval(e.default, fr) if e.default is not None \
            else Scalar(None, out_typ)
        return self._fold_conditional(conds, vals, default, out_typ, fr)

    def _eval_coalesce(self, e: Func, fr: Frame):
        out_typ = e.typ
        vals = [self.eval(a, fr) for a in e.args]
        if out_typ is None:
            return Scalar(None, None)
        if all(isinstance(v, Scalar) for v in vals):
            for v in vals:
                if v.value is not None:
                    return self._coerce_val(v, out_typ)
            return Scalar(None, out_typ)
        sd = None
        if out_typ.kind == Kind.STR:
            vals, sd = self._unify_strings(vals)
        else:
            vals = [self._coerce_val(v, out_typ) for v in vals]
        result = vals[-1]
        for v in reversed(vals[:-1]):
            if isinstance(v, Scalar):
                if v.value is not None:
                    result = v        # non-null scalar shadows the rest
                continue
            cm = C.isnil(v)
            fb = result if isinstance(result, Column) else (
                out_typ.nil if result.value is None else result.value)
            result = C.ifthenelse(cm, fb, v, out_typ)
            if sd is not None:
                result.sdict = sd
        if isinstance(result, Scalar):
            return result
        return result

    def _eval_nullif(self, e: Func, fr: Frame):
        """NULLIF(a, b) = CASE WHEN a = b THEN NULL ELSE a END."""
        c = Cmp("=", e.args[0], e.args[1])
        c.typ = BOOL
        cand = self.eval_pred(c, fr)
        a = self.eval(e.args[0], fr)
        out_typ = e.typ or (a.typ if isinstance(a, (Column, Scalar)) else None)
        if isinstance(a, Scalar):
            a = self._broadcast(a, fr)
        cm = Column(BOOL, cand.as_mask(fr.cap, self.device), fr.count, nonil=True)
        out = C.ifthenelse(cm, out_typ.nil, a, out_typ)
        out.sdict = a.sdict
        return out

    def _eval_greatest(self, e: Func, fr: Frame):
        """GREATEST/LEAST (reference sql_max/sql_min, rel_exps) with nil
        propagation; strings compare via order-preserving merged codes."""
        op = "max" if e.name in ("greatest", "sql_max") else "min"
        out_typ = e.typ
        vals = [self.eval(a, fr) for a in e.args]
        if all(isinstance(v, Scalar) for v in vals):
            if any(v.value is None for v in vals):
                return Scalar(None, out_typ)
            coerced = [self._coerce_val(v, out_typ) for v in vals]
            if out_typ is not None and out_typ.kind == Kind.STR:
                vv = [str(v.value) for v in vals]
                return Scalar(max(vv) if op == "max" else min(vv), out_typ)
            f = max if op == "max" else min
            return Scalar(f(v.value for v in coerced), out_typ)
        sd = None
        if out_typ.kind == Kind.STR:
            vals, sd = self._unify_strings(vals)
        else:
            vals = [self._coerce_val(v, out_typ) for v in vals]
        cols = []
        for v in vals:
            if isinstance(v, Scalar):
                if sd is not None:   # unified string scalar = physical code
                    code = nil_const(torch.int32) if v.value is None \
                        else int(v.value)
                    v = Column(out_typ,
                               self._full(fr.cap, code, torch.int32), fr.count,
                               nonil=v.value is not None, sdict=sd)
                else:
                    v = self._broadcast(v, fr)
            cols.append(v)
        result = cols[0]
        for v in cols[1:]:
            result = C.binop(op, result, v, out_typ=out_typ)
        if sd is not None:
            result.sdict = sd
        return result

    # ======================================================================
    # predicate evaluation (candidate context)
    # ======================================================================
    def eval_pred(self, e: Expr, fr: Frame) -> Cand:
        if isinstance(e, BoolOp):
            cands = [self.eval_pred(a, fr) for a in e.args]
            out = cands[0]
            for c in cands[1:]:
                out = S.cand_and(out, c, fr.cap, self.device) if e.op == "and" else \
                    S.cand_or(out, c, fr.cap, self.device)
            return out
        if isinstance(e, Not):
            return S.cand_not(self.eval_pred(e.arg, fr), fr.cap, self.device)
        if isinstance(e, Cmp):
            return self._pred_cmp(e, fr)
        if isinstance(e, Between):
            return self._pred_between(e, fr)
        if isinstance(e, InList):
            return self._pred_inlist(e, fr)
        if isinstance(e, Like):
            col = self.eval(e.arg, fr)
            if isinstance(col, Scalar):
                # scalar LIKE (e.g. SELECT 'test' LIKE 'te%'): host eval
                if col.value is None:
                    return self._no_rows(fr)
                import re as _re
                flags = _re.DOTALL | (_re.IGNORECASE if
                                      getattr(e, "caseless", False) else 0)
                if getattr(e, "regex", False):
                    hit = _re.search(e.pattern, str(col.value),
                                     flags) is not None
                else:
                    rx = _re.compile(
                        SF.like_regex(e.pattern, e.escape).pattern, flags)
                    hit = rx.match(str(col.value)) is not None
                if e.negated:
                    hit = not hit
                return Cand.all(fr.count) if hit else \
                    self._no_rows(fr)
            return SF.like_cand(col, e.pattern, e.negated, e.escape,
                                caseless=getattr(e, "caseless", False),
                                regex=getattr(e, "regex", False))
        if isinstance(e, IsNull):
            col = self.eval(e.arg, fr)
            if isinstance(col, Scalar):
                hit = (col.value is None) != bool(e.negated)
                return Cand.all(fr.count) if hit else \
                    self._no_rows(fr)
            m = C.isnil(col)
            cand = Cand.from_mask(m.data, fr.count)
            return S.cand_not(cand, fr.cap, self.device) if e.negated else cand
        if isinstance(e, Const):
            if e.value:
                return Cand.all(fr.count)
            return self._no_rows(fr)
        # bare boolean expression (boolean column, function, CASE...):
        # evaluate to a bool column; nil/pad rows are already False
        v = self.eval(e, fr)
        if isinstance(v, Scalar):
            return Cand.all(fr.count) if v.value else \
                self._no_rows(fr)
        if v.typ.kind == Kind.BOOL:
            return Cand.from_mask(v.data, fr.count)
        raise ExecError(f"cannot compile predicate {type(e).__name__}")

    _FLIP = {"=": "=", "<>": "<>", "<": ">", "<=": ">=", ">": "<", ">=": "<="}

    def _pred_cmp(self, e: Cmp, fr: Frame) -> Cand:
        a = self.eval(e.left, fr)
        b = self.eval(e.right, fr)
        op = e.op
        if isinstance(a, Scalar) and isinstance(b, Column):
            a, b = b, a
            op = self._FLIP[op]
        if isinstance(a, Column) and isinstance(b, Scalar):
            return self._cmp_col_scalar(a, op, b, fr)
        if isinstance(a, Column) and isinstance(b, Column):
            if _is_float(a) or _is_float(b):
                a, b = _to_f64_col(a), _to_f64_col(b)
            else:
                a, b = self._align_join_keys(a, b)
            r = C.compare(op, a, b)
            return Cand.from_mask(r.data == 1, fr.count)
        # scalar vs scalar
        av, bv = a.value, b.value
        if av is None or bv is None:
            res = False
        else:
            s = max(a.scale, b.scale)
            if not (_is_float(a) or _is_float(b)):
                av = int(av) * 10 ** (s - a.scale)
                bv = int(bv) * 10 ** (s - b.scale)
            else:
                av, bv = _to_f64_scalar(a), _to_f64_scalar(b)
            res = {"=": av == bv, "<>": av != bv, "<": av < bv,
                   "<=": av <= bv, ">": av > bv, ">=": av >= bv}[op]
        if res:
            return Cand.all(fr.count)
        return self._no_rows(fr)

    def _cmp_col_scalar(self, col: Column, op: str, s: Scalar,
                        fr: Frame) -> Cand:
        if s.value is None:
            return self._no_rows(fr)
        if col.typ.kind == Kind.STR:
            sd = col.sdict
            val = str(s.value)
            if op in ("=", "<>"):
                code = sd.code_of(val)
                return S.thetaselect(col, None, code, op)
            if op == "<":
                th = sd.range_codes(val, "left")
                return S.select(col, None, tl=None, th=th, li=True, hi=False)
            if op == "<=":
                th = sd.range_codes(val, "right")
                return S.select(col, None, tl=None, th=th, li=True, hi=False)
            if op == ">":
                tl = sd.range_codes(val, "right")
                return S.thetaselect(col, None, tl, ">=")
            if op == ">=":
                tl = sd.range_codes(val, "left")
                return S.thetaselect(col, None, tl, ">=")
            raise ExecError(op)
        if _is_float(s) and col.typ.np_dtype.kind != "f":
            col = _to_f64_col(col)
            r = C.compare(op, col, _to_f64_scalar(s))
            return Cand.from_mask(r.data == 1, fr.count)
        if _is_float(col) and not _is_float(s):
            r = C.compare(op, col, _to_f64_scalar(s))
            return Cand.from_mask(r.data == 1, fr.count)
        if isinstance(s.value, tuple):
            # interval literal vs an interval column: convert the
            # (amount, unit) pseudo-const into the column's physical
            # domain (µs for sec_interval, months for month_interval —
            # sql_types.c month_interval/sec_interval)
            amt, unit = s.value
            if unit == "quarter":
                amt, unit = amt * 3, "month"
            if unit == "week":
                amt, unit = amt * 7, "day"
            if col.typ.np_dtype.itemsize == 4:   # month interval
                v = amt * 12 if unit == "year" else amt
            else:
                us = {"day": 86_400_000_000, "hour": 3_600_000_000,
                      "minute": 60_000_000, "second": 1_000_000}
                if unit not in us:
                    raise ExecError(
                        f"cannot compare {unit} interval to a day-time "
                        f"interval column")
                v = int(amt) * us[unit]
            return S.thetaselect(col, None, v, op)
        cs = _scale_of(col)
        ss = s.scale
        v = s.value
        if ss > cs:
            col = _upscale_col(col, ss - cs)
        elif cs > ss:
            v = int(v) * 10 ** (cs - ss)
        return S.thetaselect(col, None, v, op)

    def _pred_between(self, e: Between, fr: Frame) -> Cand:
        col = self.eval(e.arg, fr)
        lo = self.eval(e.lo, fr)
        hi = self.eval(e.hi, fr)
        if not (isinstance(col, Column) and isinstance(lo, Scalar)
                and isinstance(hi, Scalar)):
            lo_c = self._pred_cmp_parts(col, ">=", lo, fr)
            hi_c = self._pred_cmp_parts(col, "<=", hi, fr)
            c = S.cand_and(lo_c, hi_c, fr.cap, self.device)
            return S.cand_not(c, fr.cap, self.device) if e.negated else c
        if col.typ.kind == Kind.STR:
            # order-preserving dictionary: string range → code range
            # (dict.c's ordered-codes invariant makes this an int select)
            vals = col.sdict.values
            lv = int(np.searchsorted(vals, str(lo.value), "left"))
            hv = int(np.searchsorted(vals, str(hi.value), "right")) - 1
            return S.select(col, None, tl=lv, th=hv, anti=e.negated)
        if _is_float(lo) or _is_float(hi) or _is_float(col):
            colf = _to_f64_col(col)
            m1 = C.compare(">=", colf, _to_f64_scalar(lo))
            m2 = C.compare("<=", colf, _to_f64_scalar(hi))
            c = S.cand_and(Cand.from_mask(m1.data == 1, fr.count),
                           Cand.from_mask(m2.data == 1, fr.count), fr.cap,
                           self.device)
            return S.cand_not(c, fr.cap, self.device) if e.negated else c
        cs = _scale_of(col)
        s = max(cs, lo.scale, hi.scale)
        if cs < s:
            col = _upscale_col(col, s - cs)
        lv = int(lo.value) * 10 ** (s - lo.scale)
        hv = int(hi.value) * 10 ** (s - hi.scale)
        return S.select(col, None, tl=lv, th=hv, anti=e.negated)

    def _pred_cmp_parts(self, a, op, b, fr) -> Cand:
        if isinstance(a, Column) and isinstance(b, Scalar):
            return self._cmp_col_scalar(a, op, b, fr)
        if isinstance(a, Column) and isinstance(b, Column):
            if _is_float(a) or _is_float(b):
                a, b = _to_f64_col(a), _to_f64_col(b)
            else:
                a, b = self._align_join_keys(a, b)
            r = C.compare(op, a, b)
            return Cand.from_mask(r.data == 1, fr.count)
        raise ExecError("between shape unsupported")

    def _pred_inlist(self, e: InList, fr: Frame) -> Cand:
        col = self.eval(e.arg, fr)
        vals = [self.eval(i, fr) for i in e.items]
        if isinstance(col, Scalar) or \
                any(isinstance(v, Column) for v in vals):
            # general shape — scalar LHS (SELECT 1 IN (...)) or column
            # expressions in the list (x IN (y + 1)): rewrite to the OR
            # of equalities (rel_select.c in-value-list handling)
            ors = BoolOp("or", [Cmp("=", e.arg, i) for i in e.items])
            pos = self.eval_pred(ors, fr)
            if not e.negated:
                return pos
            # NOT IN: exclude nil LHS rows (3-valued logic)
            if isinstance(col, Scalar):
                if col.value is None:
                    return self._no_rows(fr)
                return S.cand_not(pos, fr.cap, self.device)
            nonil = S.select(col, None, tl=col.typ.nil, th=col.typ.nil,
                             anti=True) if not col.nonil else \
                Cand.all(col.count)
            return S.cand_and(nonil, S.cand_not(pos, fr.cap, self.device), fr.cap, self.device)
        if col.typ.kind == Kind.STR:
            return SF.in_strings_cand(col, [str(v.value) for v in vals],
                                      e.negated)
        out = None
        cs = _scale_of(col)
        for v in vals:
            pv = int(v.value) * 10 ** (cs - v.scale)
            c = S.thetaselect(col, None, pv, "=")
            out = c if out is None else S.cand_or(out, c, fr.cap, self.device)
        if e.negated:
            nonil = S.select(col, None, tl=col.typ.nil, th=col.typ.nil,
                             anti=True) if not col.nonil else \
                Cand.all(col.count)
            return S.cand_and(nonil, S.cand_not(out, fr.cap, self.device), fr.cap, self.device)
        return out
