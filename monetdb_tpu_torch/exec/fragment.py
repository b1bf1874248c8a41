"""Whole-plan fragment interpreter: Rel tree -> tuple IR -> torch ops.

The port of the reference package's exec/fragment.py.  A SQL plan is lowered
on the host to a hashable IR of nested tuples (``Lowering``, a copy of the
reference's with three changes, marked where they are), and ``_Interp``
runs that IR eagerly as PyTorch ops on the device that holds the catalog's
tensors, with the same node names (``r_*`` relations, ``e_*`` expressions,
``p_*`` predicates) as the reference's traced interpreter.  The IR is the
contract between the two packages: the port's IR for a query equals the
reference's.

Kept from the reference's design:

* mask-carrying: Filter produces a boolean mask, never a compaction; rows
  stay at base capacity until a compaction barrier (``r_compact``) or the
  result export.
* group-by over *domain slots*: dense small domains aggregate into
  [0, domain) slots, then compact by presence rank.  Integer slot sums go
  through the hand-written ``seg_sum64`` CUDA kernel on a CUDA device
  (ops/cuda_kernels.py) and its plain version on the CPU.
* errors (overflow / division by zero, gdk/gdk_calc_addsub.c:44-47
  ON_OVERFLOW) become per-run flags reduced to one int, read once on the
  host per attempt together with the live count and the count-retry
  totals.
* count-then-retry: compaction buckets and group-output capacities start
  at a default, and the host re-lowers with the measured total when it
  overflows (memoized per plan, on disk in the port's own memo file).

* unique-build equi-joins keep the probe side's rows at their capacity and
  gather the build side's columns (direct-address table, or sort + binary
  search); a build side that turns out non-unique is flagged on the device
  and re-lowered as an expanding join (``r_join_expand``), whose output
  capacity is one more count-then-retry bucket.
* scalar subqueries run at plan time, through this same fragment (or, if
  it rejects the subquery's plan, through the op-at-a-time executor), and
  are baked into the IR as literals.

A plan the fragment rejects raises ``Unsupported``, at lowering or at run
time; the engine then runs it through the op-at-a-time executor
(exec/executor.py), as it does every plan with window functions.

With a row mesh (``parallel/``), ``CompiledFragment.run(mesh=...)`` runs
the plan SPMD, one interpreter per shard on a thread of its own: the
largest scanned tables are row-sharded, ``_SpmdRewriter`` (the reference's
rewriter, host-only) places gather barriers, hash-repartition exchanges
and two-phase dense group-bys, and the interpreter's four mesh nodes
(``r_scan_sharded``, ``r_gather``, ``r_repartition``,
``r_groupby_dense_spmd``) call the mesh's collectives.  A plan the mesh
path rejects (``Unsupported``) runs on one device, as in the reference.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import threading
import time
from decimal import Decimal as PyDecimal
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..column import StrDict, capacity_for
from ..dtypes import (BOOL, DATE, F64, I8, I32, I64, TIMESTAMP, Kind,
                      SQLType, decimal as dec_t, varchar)
from ..ops._tensor import (catalog_device, idiv as _idiv, irem as _irem,
                           lexsort as _lexsort, nil_const as _nil_const,
                           nilm as _nilm_arr, npdt as _npdt,
                           set_drop as _set_drop, tdt as _tdt)
from ..ops.cuda_kernels import seg_sum64
from ..ops.sort import sort_key
from ..parallel.mesh import run_shards
from ..parallel.shuffle import exchange, hash64 as _hash64
from ..plan import logical as L
from ..plan.exprs import (Between, BinOp, BoolOp, Case, Cast, Cmp, ColRef,
                          Const, Expr, Func, InList, IsNull, Like, Not,
                          Subquery, walk)

__all__ = ["Unsupported", "FragmentResult", "CompiledFragment",
           "compile_fragment", "run_fragment", "STATS", "stats_inc"]


_I64_MIN = np.int64(np.iinfo(np.int64).min)
_I64_MAX = np.int64(np.iinfo(np.int64).max)
# error codes >= this encode "join build side <ordinal> was non-unique":
# the host re-lowers that join as an expanding join and retries
_ERR_DUP_BASE = 16
#: histogram-grouping domain cap (the reference's; part of the IR
#: contract).  With scatter-mode segment reductions (one scatter per
#: aggregate) the dense strategy serves domains far beyond the one-hot
#: bound; slot arrays at 16M are 128 MB int64.
_DENSE_DOMAIN_MAX = 1 << 24
#: initial group-output capacity bucket (grown by count-then-retry when
#: ngroups overflows it)
_GROUP_OUT_CAP0 = 1 << 16
#: compaction barrier: inputs of group-by/order-by/distinct larger than
#: _COMPACT_MIN_CAP are compacted to a count-retried bucket starting at
#: _COMPACT_CAP0 - sorts/scatters then run at live-row scale instead of
#: base-capacity scale (a filtered+joined 8.4M-cap pipeline with 300k
#: live rows pays 16-60x less; the reference gets this for free because
#: BATselect materializes candidates, gdk_select.c virtualize)
_COMPACT_MIN_CAP = 1 << 17
_COMPACT_CAP0 = 1 << 19

#: segment count at or below which the reference's grouped aggregation
#: uses its one-hot form (here: integer sums through the seg_sum64
#: kernel); above it both packages scatter (_SegReduce).
_ONEHOT_MAX = 128

#: largest build-side capacity that still uses the direct-address
#: (scatter-built) join table; bigger builds sort + binary-search probe.
_JOIN_DENSE_BUILD_MAX = 1 << 16
# results whose final capacity is at most this are fetched in one RPC;
# larger ones sync the count first and compact to a tight capacity
_SINGLE_PHASE_CAP = 1 << 16


class Unsupported(Exception):
    """Plan shape outside the fragment compiler; caller falls back."""


# ---------------------------------------------------------------------------
# physical type bookkeeping (host side, parallel to the IR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PT:
    """Static physical type of a lowered expression.  Mirrors what COLrec
    carries for kernel selection in the reference (gdk/gdk.h:545-804)."""
    typ: SQLType
    nonil: bool = True
    sdict: Optional[StrDict] = None
    minval: Optional[int] = None
    maxval: Optional[int] = None
    key: bool = False        # provably unique among live rows (BAT tkey)
    #: int128-equivalent sum (the reference's hge accumulator,
    #: gdk/gdk.h:441): the value is carried as TWO int64 arrays - this
    #: key holds the low 32 bits (in [0, 2^32), int64-min = nil) and a
    #: companion key (same name + "#hi") holds value >> 32.  Exact total
    #: = hi * 2^32 + lo, recombined into python ints at result decode.
    wide: bool = False

    @property
    def dt(self) -> str:
        return self.typ.np_dtype.str

    @property
    def scale(self) -> int:
        return self.typ.scale if self.typ.kind == Kind.DECIMAL else 0

    @property
    def is_float(self) -> bool:
        return self.typ.np_dtype.kind == "f"

    @property
    def is_str(self) -> bool:
        return self.typ.kind == Kind.STR


def _hikey(key: Tuple[str, str]) -> Tuple[str, str]:
    """Companion env key carrying the high 32-bit limbs of a wide sum."""
    return (key[0], key[1] + "#hi")


def _nil_np(dt: str):
    d = np.dtype(dt)
    if d.kind == "f":
        return d.type(np.nan)
    if d.kind == "b":
        return np.bool_(False)
    return d.type(np.iinfo(d).min)


# ---------------------------------------------------------------------------
# scalar (host) value model during lowering - mirrors executor.Scalar
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HScalar:
    value: object            # physical domain (scaled int for decimals, ...)
    typ: Optional[SQLType]

    @property
    def scale(self):
        return self.typ.scale if (self.typ is not None and
                                  self.typ.kind == Kind.DECIMAL) else 0

    def is_float(self):
        return self.typ is not None and self.typ.np_dtype.kind == "f"

    def as_f64(self) -> float:
        if self.value is None:
            return float("nan")
        v = float(self.value)
        if self.scale:
            v /= 10.0 ** self.scale
        return v


# ---------------------------------------------------------------------------
# lowering: Rel/Expr -> hashable IR + input arrays
# ---------------------------------------------------------------------------


class Lowering:
    """One-pass plan lowering.  Produces:
    * ``ir``     - hashable nested-tuple program (the jit static arg)
    * ``inputs`` - flat list of device arrays (base columns, counts, luts)
    * ``penv``   - final env key -> PT for result decoding
    """

    def __init__(self, catalog, expand: Optional[Dict[int, int]] = None):
        self.catalog = catalog
        self.inputs: List[torch.Tensor] = []
        # owning table name per input (None = lut/constant); drives the
        # SPMD shard-table choice (the mitosis partition pick,
        # monetdb5/optimizer/opt_mitosis.c:150-190)
        self.input_tables: List[Optional[str]] = []
        self._input_ids: Dict[int, int] = {}
        self.refs: Dict[str, set] = {}
        # joins whose build side proved non-unique at runtime are re-lowered
        # as *expanding* joins (the reference's N:M hashjoin,
        # gdk/gdk_join.c:2900): ordinal -> output capacity (None = pick a
        # default; the host retries with the measured total on overflow)
        self.expand: Dict[int, Optional[int]] = expand or {}
        self.expand_used: Dict[int, int] = {}
        # ordinal -> output capacity of every keyed group-by, with a retry
        # channel or without one (the mesh checks the latter's counts)
        self.group_caps: Dict[int, int] = {}
        self.scan_counts: Dict[int, int] = {}
        self._join_ord = 0
        # functional dependencies discovered at unique-build joins:
        # (frozenset of determinant key irs, frozenset of dependent env
        # irs).  A group-by whose key set contains all determinants can
        # drop the dependents from its SORT keys (the values are fetched
        # via extents regardless) - the rel_statistics.c/join-FD trick
        # that turns Q3's packed-int64 8M-row group sort into a single
        # int32 key sort.
        self.fds: List[Tuple[frozenset, frozenset]] = []

    # -- inputs --------------------------------------------------------------
    def _add_input(self, arr) -> int:
        k = id(arr)
        got = self._input_ids.get(k)
        if got is not None:
            return got
        idx = len(self.inputs)
        self.inputs.append(arr)
        self.input_tables.append(None)
        self._input_ids[k] = idx
        return idx

    def _add_lut(self, np_arr: np.ndarray) -> int:
        idx = len(self.inputs)
        # port: the lut goes to the device of the catalog's tensors
        self.inputs.append(torch.as_tensor(
            np_arr, device=catalog_device(self.catalog, Unsupported)))
        self.input_tables.append(None)
        return idx

    # -- column reference collection (executor._collect_refs analog) ---------
    def collect_refs(self, rel: L.Rel):
        def ref_expr(e: Expr):
            for n in walk(e):
                if isinstance(n, ColRef) and n.table not in ("#out", "#grp"):
                    self.refs.setdefault(n.table, set()).add(n.name)

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
                        if a is not None and isinstance(a, Expr):
                            ref_expr(a)
            elif isinstance(r, L.OrderBy):
                for e, _d, _nl in r.keys:
                    ref_expr(e)
            for c in r.children():
                visit(c)
        visit(rel)

    # ======================================================================
    # relational lowering - each returns (rel_ir, penv, cap)
    # penv: env key (table, name) -> PT
    # ======================================================================

    def rel(self, r: L.Rel):
        m = getattr(self, "_rel_" + type(r).__name__.lower(), None)
        if m is None:
            raise Unsupported(type(r).__name__)
        return m(r)

    def _rel_scan(self, r: L.Scan):
        if r.table not in self.catalog:
            # plan-cache hit on a fresh catalog: system relations only
            # exist after bind-time materialization — re-materialize
            from ..sql.syscat import is_system_table, system_table
            if is_system_table(r.table):
                self.catalog.add(system_table(self.catalog, r.table))
        t = self.catalog.get(r.table)
        wanted = self.refs.get(r.alias) or self.refs.get(r.table) or set()
        names = [n for n in t.names() if n in wanted] or t.names()[:1]
        cols = []
        penv: Dict[Tuple[str, str], PT] = {}
        cap = None
        for n in names:
            c = t.col(n)
            if cap is None:
                cap = c.cap
            elif c.cap != cap:
                raise Unsupported("misaligned scan capacities")
            idx = self._add_input(c.data)
            self.input_tables[idx] = t.name
            cols.append(((r.alias, n), idx))
            penv[(r.alias, n)] = PT(c.typ, nonil=c.nonil, sdict=c.sdict,
                                    minval=c.minval, maxval=c.maxval,
                                    key=bool(getattr(c, "key", False)))
        cnt_idx = self._add_lut(np.int64(t.count))
        # actual row count per count-input index: the SPMD rewriter's
        # broadcast-vs-shuffle cost pick uses real rows, not bucketed
        # capacities (rel_statistics.c rowcount role)
        self.scan_counts[cnt_idx] = int(t.count)
        ir = ("scan", tuple(cols), cnt_idx, cap)
        return ir, penv, cap

    def _rel_subplan(self, r: L.SubPlan):
        cir, penv, cap = self.rel(r.child)
        renamed = {(r.alias, n): pt for (_t, n), pt in penv.items()}
        keys = tuple(((r.alias, n), (t, n)) for (t, n) in penv.keys())
        self._remap_fds({("env", t, n): ("env", r.alias, n)
                         for (t, n) in penv.keys()})
        return ("rename", cir, keys), renamed, cap

    def _remap_fds(self, m: Dict[tuple, tuple]) -> None:
        """Rewrite recorded FDs through an env re-keying (rename/project).
        Determinant irs are rewritten structurally; an FD whose
        determinants reference env keys that no longer exist is dropped."""
        def rw(ir):
            if ir in m:
                return m[ir]
            if isinstance(ir, tuple):
                return tuple(rw(x) for x in ir)
            return ir

        def live(ir, avail):
            """Every env ref inside ir resolves in the new env."""
            if isinstance(ir, tuple):
                if len(ir) == 3 and ir[0] == "env":
                    return ir in avail
                return all(live(x, avail) for x in ir
                           if isinstance(x, tuple))
            return True
        avail = set(m.values())
        out = []
        for dets, deps in self.fds:
            dets2 = frozenset(rw(d) for d in dets)
            deps2 = frozenset(m[d] for d in deps if d in m)
            if deps2 and all(live(d, avail) for d in dets2):
                out.append((dets2, deps2))
        self.fds = out

    def _rel_filter(self, r: L.Filter):
        cir, penv, cap = self.rel(r.child)
        pred = self.pred(r.pred, penv)
        return ("filter", cir, pred), penv, cap

    def _rel_project(self, r: L.Project):
        cir, penv, cap = self.rel(r.child)
        items = []
        penv2: Dict[Tuple[str, str], PT] = {}
        for name, e in r.exprs:
            if isinstance(e, ColRef):
                key = self._resolve(e, penv)
                if penv[key].wide:
                    # pass a wide sum through whole: both limb arrays
                    items.append((("#out", name), ("env",) + key))
                    items.append(((_hikey(("#out", name))),
                                  ("env",) + _hikey(key)))
                    penv2[("#out", name)] = penv[key]
                    penv2[_hikey(("#out", name))] = PT(I64, nonil=True)
                    continue
            ir, pt = self.expr(e, penv)
            items.append((("#out", name), ir))
            penv2[("#out", name)] = pt
        # FDs survive a projection for identity-passed columns
        self._remap_fds({ir: ("env",) + key for key, ir in items
                         if isinstance(ir, tuple) and len(ir) == 3 and
                         ir[0] == "env"})
        return ("project", cir, tuple(items)), penv2, cap

    def _maybe_compact(self, cir, cap):
        """Insert a compaction barrier (count-retried bucket capacity)
        so the sort/scatter consumer runs at live-row scale.  Converges
        to a no-op when the live count reaches the base capacity."""
        ordinal = self._join_ord
        self._join_ord += 1
        if cap <= _COMPACT_MIN_CAP:
            return cir, cap
        oc = self.expand.get(ordinal) or min(cap, _COMPACT_CAP0)
        oc = min(oc, cap)
        if oc >= cap:
            return cir, cap
        self.expand_used[ordinal] = oc
        return ("compact", cir, int(oc), ordinal), oc

    def _rel_orderby(self, r: L.OrderBy):
        cir, penv, cap = self.rel(r.child)
        cir, cap = self._maybe_compact(cir, cap)
        keys = []
        for e, desc, nl in r.keys:
            if isinstance(e, ColRef):
                key = self._resolve(e, penv)
                if penv[key].wide:
                    # order a wide sum without narrowing: (hi, lo) is
                    # value order because lo is kept in [0, 2^32)
                    nlb = nl if nl is None else bool(nl)
                    keys.append((("whi", key, _hikey(key)),
                                 bool(desc), nlb))
                    keys.append((("env",) + key, bool(desc), nlb))
                    continue
            ir, pt = self.expr(e, penv)
            if ir[0] == "lit":
                continue
            keys.append((ir, bool(desc), nl if nl is None else bool(nl)))
        if not keys:
            return cir, penv, cap
        # reordering permutes rows but keeps the value set: stats survive
        return ("orderby", cir, tuple(keys)), dict(penv), cap

    def _rel_limit(self, r: L.Limit):
        cir, penv, cap = self.rel(r.child)
        if r.n is None:
            if not r.offset:
                return cir, penv, cap
            n = None
        n = r.n
        hi = cap if n is None else min(cap, (r.offset or 0) + n)
        out_cap = min(cap, capacity_for(max(hi, 1)))
        return ("limit", cir, None if n is None else int(n),
                int(r.offset or 0), out_cap), penv, out_cap

    def _rel_distinct(self, r: L.Distinct):
        cir, penv, cap = self.rel(r.child)
        cir, cap = self._maybe_compact(cir, cap)
        keys = tuple((("env", t, n), False, None) for (t, n) in penv.keys())
        return ("distinct", cir, keys), penv, cap

    # -- joins ----------------------------------------------------------------
    # In-jit equi-joins keep the mask-carrying shape: the PROBE side's rows
    # stay at their capacity; the BUILD side must match each probe row at
    # most once (PK side of the FK joins that dominate analytics - the
    # reference's joincost picks the same probe/build split,
    # gdk/gdk_join.c:3586).  Build rows land in a direct-address table when
    # the packed key domain is small (fetchjoin/hashjoin analog) else a
    # device sort + binary-search probe (mergejoin analog).  Non-unique
    # build sides are detected *on device* (error flag) and the engine
    # falls back to the op-at-a-time executor.

    _JOIN_DENSE_MAX = 1 << 25

    @staticmethod
    def _env_resolves(env, t, n) -> bool:
        if t is not None:
            return (t, n) in env
        return sum(1 for k in env if k[1] == n) == 1

    def _expr_side(self, e: Expr, lenv, renv) -> str:
        """'l' / 'r' when every column reference resolves in exactly one
        child env, '?' otherwise (mixed or no references)."""
        names = [(n.table, n.name) for n in walk(e) if isinstance(n, ColRef)]
        if not names:
            return "?"
        inl = all(self._env_resolves(lenv, t, n) for t, n in names)
        inr = all(self._env_resolves(renv, t, n) for t, n in names)
        if inl and not inr:
            return "l"
        if inr and not inl:
            return "r"
        return "?"

    def _rel_join(self, r: L.Join):
        kind = r.kind
        if kind == "right":
            return self._rel_join(L.Join(r.right, r.left, "left",
                                         on=r.on, extra=r.extra))
        if kind not in ("inner", "left", "semi", "anti"):
            raise Unsupported(f"join kind {kind}")
        if not r.on:
            raise Unsupported("join without equi keys")
        lir, lenv, lcap = self.rel(r.left)
        rir, renv, rcap = self.rel(r.right)
        ordinal = self._join_ord
        self._join_ord += 1

        # lower each equi pair against the side that resolves it
        pairs = []                      # [(a_ir, a_pt, b_ir, b_pt)]
        for a, b in r.on:
            sa, sb = self._expr_side(a, lenv, renv), \
                self._expr_side(b, lenv, renv)
            if sa == "r" or (sa == "?" and sb == "l"):
                a, b = b, a
            a_ir, a_pt = self.expr(a, lenv)
            b_ir, b_pt = self.expr(b, renv)
            if a_pt.is_str or b_pt.is_str:
                a_ir, a_pt, b_ir, b_pt = self._align_str(a_ir, a_pt,
                                                         b_ir, b_pt)
            elif a_pt.is_float or b_pt.is_float:
                raise Unsupported("float join key")
            else:
                ssa, ssb = a_pt.scale, b_pt.scale
                if ssa < ssb:
                    a_ir, a_pt = self._upscale(a_ir, a_pt, ssb - ssa)
                elif ssb < ssa:
                    b_ir, b_pt = self._upscale(b_ir, b_pt, ssa - ssb)
            pairs.append((a_ir, a_pt, b_ir, b_pt))

        runique = any(b_pt.key for _a, _ap, _b, b_pt in pairs)
        lunique = any(a_pt.key for _a, a_pt, _b, _bp in pairs)
        swap = False
        if kind == "inner" and not runique and lunique:
            # probe from the right side instead (env merge is symmetric)
            swap = True
            lir, rir = rir, lir
            lenv, renv = renv, lenv
            lcap, rcap = rcap, lcap
            pairs = [(b, bp, a, ap) for a, ap, b, bp in pairs]
            runique = True

        # key bounds for packing (union of both sides' stats)
        keyspecs = []
        domain = 1
        for a_ir, a_pt, b_ir, b_pt in pairs:
            if a_pt.is_str:
                lo, hi = 0, max(len(a_pt.sdict) - 1, 0)
            else:
                if a_pt.minval is None or b_pt.minval is None or \
                        a_pt.maxval is None or b_pt.maxval is None:
                    lo = hi = None
                else:
                    lo = min(int(a_pt.minval), int(b_pt.minval))
                    hi = max(int(a_pt.maxval), int(b_pt.maxval))
            if lo is None:
                domain = None
            elif domain is not None:
                span = hi - lo + 1
                if span <= 0 or (domain > 0 and
                                 domain * span > (1 << 62)):
                    domain = None
                else:
                    domain *= span
            keyspecs.append((a_ir, not a_pt.nonil, b_ir, not b_pt.nonil,
                             lo, None if lo is None else hi - lo + 1,
                             a_pt.is_str))
        if domain is None and len(pairs) > 1:
            raise Unsupported("multi-key join without packable bounds")
        # direct-address build: one scatter-min into a domain-sized
        # table + one gather per probe.  Measured on v5e (jax 0.9):
        # scatter-min of 2M rows into a 6M-slot table runs in ~90ms and
        # compiles in seconds, while every sort/searchsorted
        # *instantiation* costs 15-60s of XLA compile and loop-based
        # binary search runs ~1.5s at 8M probes - so dense direct
        # addressing wins whenever the packed key domain fits a
        # reasonable table (the fetchjoin/hashjoin pick of
        # gdk/gdk_join.c:3586, with TPU compile economics deciding).
        if domain is not None and domain <= self._JOIN_DENSE_MAX:
            strat = "dense"
        else:
            strat = "sort"
            domain = 0

        uniq_check = kind in ("inner", "left") and not runique

        # residual predicate: build-side-only -> prefilter the build rows;
        # cross-side -> evaluate on the merged env (needs unique build)
        bfilter = extra = None
        menv: Dict[Tuple[str, str], PT] = dict(lenv)
        for k, pt in renv.items():
            if k in menv:
                raise Unsupported(f"duplicate column {k} across join")
            menv[k] = dataclasses.replace(
                pt, nonil=pt.nonil and kind == "inner", key=False)
        if r.extra is not None:
            if self._expr_side(r.extra, lenv, renv) == "r":
                # references only the build side: prefilter its rows
                bfilter = self.pred(r.extra, renv)
            else:
                extra = self.pred(r.extra, menv)
                if kind in ("semi", "anti") and not runique:
                    uniq_check = True

        if uniq_check and ordinal in self.expand:
            return self._lower_join_expand(
                ordinal, kind, lir, rir, lenv, renv, lcap, rcap,
                keyspecs, bfilter, extra, menv)

        ir = ("join", kind, lir, rir, tuple(keyspecs), strat, int(domain),
              bool(uniq_check), bfilter, extra,
              tuple(sorted(renv.keys())), ordinal)
        if kind in ("semi", "anti"):
            out = {k: pt for k, pt in lenv.items()}
            return ir, out, lcap
        # unique build ⇒ every build column is functionally determined by
        # the probe-side key exprs (holds for runtime-checked uniqueness
        # too: a failed check re-lowers without recording the FD)
        dets = frozenset(a_ir for a_ir, _ap, _b, _bp in pairs)
        deps = frozenset(("env",) + k for k in renv.keys())
        self.fds.append((dets, deps))
        return ir, menv, lcap

    def _lower_join_expand(self, ordinal, kind, lir, rir, lenv, renv,
                           lcap, rcap, keyspecs, bfilter, extra, menv):
        """N:M join via match enumeration (gdk/gdk_join.c:2900 hashjoin
        with duplicate build keys).  Inner/left joins materialize one
        output row per (probe, match) pair into a static expansion
        capacity (count-then-retry on overflow - the XLA static-shape
        answer to data-dependent join cardinality); semi/anti joins with a
        cross-side residual evaluate it per pair and scatter-OR back onto
        the probe rows, so their output stays mask-carrying at probe
        capacity."""
        if kind == "left" and extra is not None:
            raise Unsupported("expanding left join with cross-side residual")
        ecap = self.expand.get(ordinal)
        if not ecap:
            ecap = capacity_for(2 * max(lcap, rcap))
        self.expand_used[ordinal] = ecap
        ir = ("join_expand", kind, lir, rir, tuple(keyspecs), bfilter,
              extra, tuple(sorted(lenv.keys())), tuple(sorted(renv.keys())),
              int(ecap), ordinal)
        if kind in ("semi", "anti"):
            out = {k: pt for k, pt in lenv.items()}
            return ir, out, lcap
        # probe rows may repeat in the output: every column loses key;
        # value ranges/dicts survive (outputs are copies of input rows)
        oenv = {}
        for k, pt in lenv.items():
            oenv[k] = dataclasses.replace(pt, key=False)
        for k, pt in renv.items():
            oenv[k] = dataclasses.replace(
                pt, nonil=pt.nonil and kind == "inner", key=False)
        return ir, oenv, int(ecap)

    # -- group by -------------------------------------------------------------
    def _rel_groupby(self, r: L.GroupBy):
        cir, penv, cap = self.rel(r.child)
        cir, cap = self._maybe_compact(cir, cap)
        ordinal = self._join_ord          # group-output capacity retry
        self._join_ord += 1               # channel (shared expand space)
        key_irs = []          # (env key, expr ir, pt)
        for name, e in r.keys:
            ir, pt = self.expr(e, penv)
            key_irs.append(((("#grp", name)), ir, pt))

        # FD reduction first: keys functionally determined (via a
        # unique-build join) by other keys in the set are dropped from
        # the GROUPING keys - grouping is identical and their values
        # come back via a representative-row gather (extents).  Q3's
        # (l_orderkey, o_orderdate, o_shippriority) collapses to
        # l_orderkey.
        irset = {ir for _k, ir, _pt in key_irs}
        drop: set = set()
        for _ in range(2):      # FD chains (dep of a dep)
            for dets, deps in self.fds:
                if dets <= (irset - drop):
                    drop |= {ir for ir in irset & deps if ir not in dets}
        keep = [(k, ir, pt) for k, ir, pt in key_irs if ir not in drop]
        if not keep:
            keep = key_irs[:1]
        kept_irs = {ir for _k, ir, _pt in keep}
        fetch_keys = tuple((k, ir) for k, ir, _pt in key_irs
                           if ir not in kept_irs)

        # strategy pick over the KEPT keys: dense combined domain
        # (gdk_group.c histogram strategy; aggregation is one scatter
        # per aggregate) when the domain fits a slot table, else device
        # sort
        dense_specs = []
        domain = 1
        dense_ok = True
        for _k, ir, pt in keep:
            spec = self._dense_code(ir, pt)
            if spec is None:
                dense_ok = False
                break
            code_ir, d = spec
            dense_specs.append((code_ir, d, pt.dt))
            domain *= d
            if domain > _DENSE_DOMAIN_MAX:
                dense_ok = False
                break
        # histogram slots cost O(domain) per aggregate; once the input
        # is compacted near live-row scale, a sparse domain much larger
        # than the rows is worse than one code sort (gdk_group.c makes
        # the same rows-vs-domain pick between histogram and hash)
        if dense_ok and domain > max(65536, 8 * cap):
            dense_ok = False

        aggs = []
        penv2: Dict[Tuple[str, str], PT] = {}
        for k, _ir, pt in key_irs:
            # key outputs are a subset of the input values: min/max bounds
            # survive grouping (rel_statistics.c propagates the same way) -
            # they keep downstream joins on grouped keys packable
            penv2[k] = dataclasses.replace(pt, nonil=False,
                                           key=len(key_irs) == 1)
        for name, func, arg, distinct in r.aggs:
            spec, pt = self._lower_agg(func, arg, penv, distinct=distinct)
            aggs.append(((("#grp", name)), spec))
            penv2[("#grp", name)] = pt
            if pt.wide:
                penv2[_hikey(("#grp", name))] = PT(I64, nonil=True)

        def _out_cap(bound: int) -> int:
            """Group-output capacity: start at a small bucket, grown by
            the count-then-retry loop (exp_totals) when ngroups
            overflows - downstream operators (order-by/limit/joins on
            aggregates) then run at group scale, not input scale."""
            if not key_irs:
                return 1                 # scalar aggregate: one row
            hard = capacity_for(max(bound, 1))
            oc = self.expand.get(ordinal) or min(hard, _GROUP_OUT_CAP0)
            oc = min(oc, hard)
            if oc < bound:
                self.expand_used[ordinal] = oc    # retry channel active
            self.group_caps[ordinal] = oc
            return oc

        if dense_ok:
            out_cap = _out_cap(int(domain))
            ir = ("groupby_dense", cir,
                  tuple((k, ir) for k, ir, _pt in keep),
                  tuple(dense_specs), int(domain), tuple(aggs),
                  fetch_keys, int(out_cap), ordinal)
            return ir, penv2, out_cap
        # sort strategy: when every kept key pack-codes and the combined
        # domain fits int64, ONE mixed-radix sort key (the mkey.hash
        # role, modules/mal/mkey.c, but exact) replaces the
        # multi-operand comparator sort; the interpreter narrows it to
        # int32 when the domain fits (no native 64-bit sort on TPU)
        kept_specs = []
        kdomain = 1
        kpackable = True
        for _k, ir, pt in keep:
            spec = self._pack_code(ir, pt)
            if spec is None:
                kpackable = False
                break
            code_ir, d = spec
            kept_specs.append((code_ir, d))
            kdomain *= d
            if kdomain > (1 << 62):
                kpackable = False
                break
        if kpackable and kept_specs:
            sort_keys = (("packcode", tuple(kept_specs)),)
        else:
            sort_keys = tuple(ir for _k, ir, _pt in keep)
        out_cap = _out_cap(cap)
        ir = ("groupby_sort", cir,
              tuple((k, ir) for k, ir, _pt in key_irs),
              sort_keys, tuple(aggs), int(out_cap), ordinal)
        return ir, penv2, out_cap

    def _dense_code(self, ir, pt: PT):
        """(code_ir in [0, D), D) for the dense histogram strategy -
        mirrors ops/group.py _dense_domain/_codes incl. the nil slot."""
        t = pt.typ
        if t.kind == Kind.STR and pt.sdict is not None:
            d = len(pt.sdict) + 1
            return ("dcode_str", ir, d), d
        if t.np_dtype.kind == "b":
            return ("dcode_bool", ir), 2
        if t.np_dtype == np.dtype(np.int8):
            return ("dcode_i8", ir), 256
        if pt.nonil and pt.minval is not None and pt.maxval is not None:
            d = int(pt.maxval) - int(pt.minval) + 1
            if 0 < d <= _DENSE_DOMAIN_MAX:
                return ("dcode_range", ir, int(pt.minval)), d
        return None

    def _pack_code(self, ir, pt: PT):
        """(code_ir in [0, D), D) for SORT-key packing: like _dense_code
        but without the histogram domain cap (packing only needs the
        combined domain to fit an integer sort key, not a slot array)
        and with an explicit nil slot for nullable ranges."""
        spec = self._dense_code(ir, pt)
        if spec is not None:
            return spec
        t = pt.typ
        if t.kind == Kind.STR or pt.is_float:
            return None
        if pt.minval is None or pt.maxval is None:
            return None
        lo, hi = int(pt.minval), int(pt.maxval)
        span = hi - lo + 1
        if span <= 0:
            return None
        if pt.nonil:
            return ("dcode_range", ir, lo), span
        # nullable wide range: nil -> slot 0, values shifted +1 (keeps
        # the sort_key convention of nils-first group order)
        return ("pcode_rangenil", ir, lo), span + 1

    def _lower_agg(self, func: str, arg, penv, distinct: bool = False):
        """Aggregate spec mirroring ops/aggr.py semantics (gdk_aggr.c:900
        BATgroupsum family): returns (spec_ir, out PT).  DISTINCT
        aggregates dedup (group, value) pairs by sort before reducing
        (the reference's count-distinct path in gdk_aggr.c)."""
        if isinstance(arg, list):
            raise Unsupported(f"2-ary aggregate")
        if func == "count_star":
            return ("count_star",), PT(I64, nonil=True)
        if arg is None:
            raise Unsupported(f"aggregate {func} without argument")
        air, apt = self.expr(arg, penv)
        anil = not apt.nonil
        if distinct and func in ("min", "max"):
            distinct = False            # DISTINCT is a no-op for min/max
        if distinct:
            if func == "count":
                return ("count_distinct", air, anil, apt.dt), \
                    PT(I64, nonil=True)
            if func in ("sum", "avg"):
                if apt.is_float:
                    acc = F64
                elif apt.typ.kind == Kind.DECIMAL:
                    acc = dec_t(18, apt.typ.scale)
                elif apt.typ.np_dtype.kind in ("i", "b"):
                    acc = I64
                else:
                    raise Unsupported(f"{func} over {apt.typ!r}")
                if func == "avg":
                    return ("avg_distinct", air, anil, apt.dt, apt.scale), \
                        PT(F64, nonil=False)
                check = acc.np_dtype.kind == "i" \
                    and apt.typ.np_dtype.itemsize == 8
                return ("sum_distinct", air, anil, apt.dt,
                        acc.np_dtype.str, check), \
                    PT(acc, nonil=False, wide=check)
            raise Unsupported(f"distinct aggregate {func}")
        if func == "count":
            return ("count", air, anil, apt.dt), PT(I64, nonil=True)
        if func in ("sum", "avg", "prod"):
            if apt.is_float:
                acc = F64
            elif apt.typ.kind == Kind.DECIMAL:
                acc = dec_t(18, apt.typ.scale)
            elif apt.typ.np_dtype.kind in ("i", "b"):
                acc = I64
            else:
                raise Unsupported(f"{func} over {apt.typ!r}")
            if func == "avg":
                return ("avg", air, anil, apt.dt, apt.scale), \
                    PT(F64, nonil=False)
            check = func == "sum" and acc.np_dtype.kind == "i" \
                and apt.typ.np_dtype.itemsize == 8
            return (func, air, anil, apt.dt, acc.np_dtype.str, check), \
                PT(acc, nonil=False, wide=check)
        if func in ("min", "max"):
            return (func, air, anil, apt.dt), \
                dataclasses.replace(apt, nonil=False, minval=None,
                                    maxval=None)
        if func in ("stddev_samp", "stddev_pop", "var_samp", "var_pop"):
            want = "std" if func.startswith("stddev") else "var"
            return ("moment2", air, anil, apt.dt, want,
                    func.endswith("samp"), apt.scale), PT(F64, nonil=False)
        raise Unsupported(f"aggregate {func}")

    # ======================================================================
    # expression lowering (value context) -> (ir, PT)
    # ======================================================================

    def expr(self, e: Expr, penv) -> Tuple[tuple, PT]:
        if isinstance(e, ColRef):
            key = self._resolve(e, penv)
            pt = penv[key]
            if pt.wide:
                # expression consumption of a wide sum narrows it to
                # int64 with an exact fits-check (22003 beyond int64 -
                # replaces the old f64-shadow heuristic); root outputs
                # bypass this via the project passthrough and decode
                # the full value exactly
                return ("wnarrow", key, _hikey(key)), \
                    dataclasses.replace(pt, wide=False)
            return ("env",) + key, pt
        if isinstance(e, Const):
            s = self._const(e)
            return self._lit(s)
        if isinstance(e, BinOp):
            return self._binop(e, penv)
        if isinstance(e, Cast):
            return self._cast(e, penv)
        if isinstance(e, Case):
            return self._case(e, penv)
        if isinstance(e, Func):
            return self._func(e, penv)
        if isinstance(e, Subquery):
            return self._subquery(e)
        if isinstance(e, (Cmp, BoolOp, Not, IsNull, Between, InList, Like)):
            p = self.pred(e, penv)
            return ("bool2val", p), PT(I8, nonil=True)
        raise Unsupported(f"expr {type(e).__name__}")

    def _resolve(self, e: ColRef, penv) -> Tuple[str, str]:
        if e.table is not None and (e.table, e.name) in penv:
            return (e.table, e.name)
        hits = [k for k in penv if k[1] == e.name]
        if len(hits) == 1:
            return hits[0]
        raise Unsupported(f"unresolved column {e.table}.{e.name}")

    def _const(self, e: Const) -> HScalar:
        v = e.value
        typ = e.typ
        if v is None:
            return HScalar(None, typ)
        if isinstance(v, PyDecimal):
            scale = typ.scale if typ is not None else 0
            return HScalar(int(v.scaleb(scale).to_integral_value()), typ)
        if isinstance(v, datetime.datetime):
            us = int((v - datetime.datetime(1970, 1, 1)).total_seconds()
                     * 1_000_000)
            return HScalar(us, typ or TIMESTAMP)
        if isinstance(v, datetime.date):
            return HScalar((v - datetime.date(1970, 1, 1)).days, typ or DATE)
        if isinstance(v, bool):
            return HScalar(bool(v), typ or BOOL)
        if isinstance(v, (int, float, str)):
            return HScalar(v, typ)
        raise Unsupported(f"constant {v!r}")

    def _lit(self, s: HScalar) -> Tuple[tuple, PT]:
        typ = s.typ or I64
        pt = PT(typ, nonil=s.value is not None)
        if s.value is None:
            return ("nil", pt.dt), pt
        if typ.kind == Kind.STR:
            # string literal in value context: single-entry dictionary
            sd = StrDict(np.array([str(s.value)]))
            pt = PT(typ, nonil=True, sdict=sd)
            return ("lit", 0, "<i4"), pt
        v = s.value
        if typ.np_dtype.kind == "f":
            v = float(v)
        elif typ.np_dtype.kind == "b":
            v = bool(v)
        else:
            v = int(v)
        return ("lit", v, pt.dt), pt

    def _subquery_executor(self, rel, name: str):
        """The scalar subquery's value through the op-at-a-time executor
        (the reference's only path)."""
        from .executor import Executor
        frame = Executor(self.catalog).run(rel)
        col = frame.get("#out", name)
        if frame.count == 0:
            return self._lit(HScalar(None, col.typ))
        v = col.data[0].cpu().numpy()
        if col.typ.np_dtype.kind == "f":
            fv = float(v)
            return self._lit(HScalar(None if np.isnan(fv) else fv, col.typ))
        iv = int(v)
        if col.typ.np_dtype.kind == "i" and \
                iv == np.iinfo(col.typ.np_dtype).min:
            return self._lit(HScalar(None, col.typ))
        if col.typ.kind == Kind.STR:
            return self._lit(HScalar(str(col.sdict.values[iv]), col.typ))
        return self._lit(HScalar(iv, col.typ))

    def _subquery(self, e: Subquery):
        """Scalar subquery: run it at plan time and bake the value
        (data-dependent -> IR changes with data, which keys the plan memo
        correctly).  The reference runs it through its op-at-a-time
        executor; the port runs the bound plan through a fragment of its
        own and takes the executor only where that fragment raises
        Unsupported."""
        if not (isinstance(e.select, tuple) and e.select[0] == "bound"):
            raise Unsupported("unbound subquery")
        if e.kind != "scalar":
            raise Unsupported(f"{e.kind} subquery in fragment expression")
        _tag, rel, scols = e.select
        try:
            fr = CompiledFragment(self.catalog, rel,
                                  [scols[0].name]).run(stat="subquery_runs")
        except Unsupported:
            return self._subquery_executor(rel, scols[0].name)
        typ = fr.pts[0].typ
        if fr.count == 0:
            return self._lit(HScalar(None, typ))
        v = fr.arrays[0][0]
        if typ.np_dtype.kind == "f":
            fv = float(v)
            return self._lit(HScalar(None if np.isnan(fv) else fv, typ))
        iv = int(v)
        if 0 in fr.wide:
            # a bare wide sum: nil rides in the low limb; beyond int64 is
            # the overflow a narrowing expression would raise
            if iv != _I64_MIN_PY:
                iv += int(fr.arrays[fr.wide[0]][0]) << 32
                if not -(1 << 63) < iv < (1 << 63):
                    _raise_err(4)
        if typ.np_dtype.kind == "i" and iv == np.iinfo(typ.np_dtype).min:
            return self._lit(HScalar(None, typ))
        if typ.kind == Kind.STR:
            return self._lit(HScalar(str(fr.pts[0].sdict.values[iv]), typ))
        return self._lit(HScalar(iv, typ))

    # -- arithmetic (mirrors executor._eval_binop + ops/calc.py) -------------
    def _tofloat(self, ir, pt: PT):
        if pt.is_float and pt.typ is F64:
            return ir, pt
        return ("tofloat", ir, pt.scale, not pt.nonil, pt.dt), \
            PT(F64, nonil=pt.nonil)

    def _upscale(self, ir, pt: PT, k: int):
        if k == 0:
            return ir, pt
        out = dec_t(18, pt.scale + k)
        check = bool(config.get("overflow_checks"))
        return ("upscale", ir, int(k), not pt.nonil, pt.dt, check), \
            dataclasses.replace(pt, typ=out, minval=None, maxval=None)

    def _binop(self, e: BinOp, penv):
        a_ir, a_pt = self.expr(e.left, penv)
        b_ir, b_pt = self.expr(e.right, penv)
        op = {"+": "add", "-": "sub", "*": "mul", "/": "div",
              "%": "mod"}.get(e.op)
        if op is None:
            raise Unsupported(f"operator {e.op}")
        if a_pt.is_str or b_pt.is_str:
            raise Unsupported("string arithmetic")
        check = bool(config.get("overflow_checks"))

        if a_pt.is_float or b_pt.is_float or \
                (op == "div" and (a_pt.scale or b_pt.scale)):
            a_ir, a_pt = self._tofloat(a_ir, a_pt)
            b_ir, b_pt = self._tofloat(b_ir, b_pt)
            node = "fdiv" if op == "div" else "farith"
            ir = (node, op, a_ir, b_ir, not a_pt.nonil, not b_pt.nonil)
            return ir, PT(F64, nonil=a_pt.nonil and b_pt.nonil)

        sa, sb = a_pt.scale, b_pt.scale
        if op == "mul":
            s = sa + sb
            out = dec_t(18, s) if s else self._common_int(a_pt, b_pt)
        elif op in ("add", "sub"):
            s = max(sa, sb)
            if sa < s:
                a_ir, a_pt = self._upscale(a_ir, a_pt, s - sa)
            if sb < s:
                b_ir, b_pt = self._upscale(b_ir, b_pt, s - sb)
            out = dec_t(18, s) if s else self._common_int(a_pt, b_pt)
        else:  # idiv / mod, scale-free
            out = self._common_int(a_pt, b_pt)
        ir = ("iarith", op, a_ir, b_ir, out.np_dtype.str, check,
              not a_pt.nonil, not b_pt.nonil)
        return ir, PT(out, nonil=a_pt.nonil and b_pt.nonil)

    @staticmethod
    def _common_int(a_pt: PT, b_pt: PT) -> SQLType:
        from ..dtypes import common_numeric
        return common_numeric(a_pt.typ, b_pt.typ)

    # -- casts ---------------------------------------------------------------
    def _cast(self, e: Cast, penv):
        ir, pt = self.expr(e.arg, penv)
        to = e.to
        if pt.is_str and to.kind != Kind.STR:
            return self._str_parse_lut(ir, pt, to)
        if to.kind == Kind.STR and not pt.is_str:
            return self._val_to_str_lut(ir, pt, to)
        if to.kind == Kind.STR:
            return ir, pt
        fs, ts = pt.scale, to.scale if to.kind == Kind.DECIMAL else 0
        check = bool(config.get("overflow_checks"))
        out = ("convert", ir, to.np_dtype.str, max(0, ts - fs),
               max(0, fs - ts), check, not pt.nonil, pt.dt,
               pt.typ.kind == Kind.DECIMAL, to.kind == Kind.DECIMAL)
        return out, PT(to, nonil=pt.nonil)

    def _str_parse_lut(self, ir, pt: PT, to: SQLType):
        """string->value cast: parse each *distinct* dict value on the host,
        apply by gather (gdk_calc_convert.c convert_str_any analog)."""
        if pt.sdict is None:
            raise Unsupported("string cast without dictionary")
        from .executor import _parse_str_cast
        from ..storage.columns import to_physical_np
        vals = []
        for sv in pt.sdict.values:
            try:
                vals.append(_parse_str_cast(str(sv), to))
            except Exception:
                raise Unsupported("unparseable string cast")
        phys = to_physical_np(vals, to)
        lut = self._add_lut(np.asarray(phys, dtype=to.np_dtype))
        return ("lutmap", lut, ir, to.np_dtype.str), PT(to, nonil=pt.nonil)

    def _val_to_str_lut(self, ir, pt: PT, to: SQLType):
        raise Unsupported("value->string cast")

    # -- CASE / functions ------------------------------------------------------
    def _coerce(self, ir, pt: PT, out: SQLType):
        """Coerce a lowered value to the CASE/COALESCE output type
        (executor._coerce_val)."""
        if out.kind == Kind.STR:
            return ir, pt
        if out.np_dtype.kind == "f":
            return self._tofloat(ir, pt)
        os = out.scale if out.kind == Kind.DECIMAL else 0
        if pt.scale < os:
            return self._upscale(ir, pt, os - pt.scale)
        if pt.typ.np_dtype != out.np_dtype:
            check = bool(config.get("overflow_checks"))
            return ("convert", ir, out.np_dtype.str, 0, 0, check,
                    not pt.nonil, pt.dt, False, False), \
                PT(out, nonil=pt.nonil)
        return ir, dataclasses.replace(pt, typ=out)

    def _unify_str_vals(self, lowered):
        """Merge the dictionaries of string CASE branches into one
        order-preserving dict; remap each branch by lut."""
        dicts = []
        for ir, pt in lowered:
            if pt.typ is not None and not pt.is_str:
                # mixed-type branches need host-side value→string casts:
                # executor path (convert_any_str)
                raise Unsupported("mixed-type string CASE/COALESCE")
            if pt.sdict is not None and len(pt.sdict.values):
                dicts.append(np.asarray(pt.sdict.values, dtype=str))
        merged = np.unique(np.concatenate(dicts)) if dicts \
            else np.empty(0, dtype=str)
        sd = StrDict(merged)
        out = []
        for ir, pt in lowered:
            if pt.sdict is None or not len(pt.sdict.values):
                out.append((ir, dataclasses.replace(pt, sdict=sd)))
                continue
            remap = np.searchsorted(merged, pt.sdict.values).astype(np.int32)
            lut = self._add_lut(remap)
            out.append((("lutmap", lut, ir, "<i4"),
                        dataclasses.replace(pt, sdict=sd)))
        return out, sd

    def _case(self, e: Case, penv):
        out_typ = e.typ
        if out_typ is None:
            raise Unsupported("untyped CASE")
        conds = [self.pred(c, penv) for c, _ in e.whens]
        vals = [self.expr(v, penv) for _, v in e.whens]
        default = self.expr(e.default, penv) if e.default is not None \
            else self._lit(HScalar(None, out_typ))
        sd = None
        if out_typ.kind == Kind.STR:
            unified, sd = self._unify_str_vals(vals + [default])
            vals, default = unified[:-1], unified[-1]
        else:
            vals = [self._coerce(ir, pt, out_typ) for ir, pt in vals]
            default = self._coerce(*default, out_typ)
        any_nil = any(not pt.nonil for _ir, pt in vals + [default])
        ir = ("case", tuple(zip(conds, (ir for ir, _ in vals))),
              default[0], out_typ.np_dtype.str)
        return ir, PT(out_typ, nonil=not any_nil, sdict=sd)

    _MATH = frozenset({"sqrt", "ln", "log10", "exp", "sin", "cos", "tan",
                       "floor", "ceil", "ceiling"})
    _DATE_FUNCS = frozenset({
        "year", "month", "day", "dayofmonth", "quarter", "dayofweek",
        "weekday", "dayofyear", "weekofyear", "week", "hour", "minute",
        "second", "century", "decade", "epoch"})

    def _func(self, e: Func, penv):
        name = e.name
        if name.startswith("extract_"):
            name = name[len("extract_"):]
        if name in self._DATE_FUNCS:
            ir, pt = self.expr(e.args[0], penv)
            return self._extract(name, ir, pt)
        if name in self._MATH:
            ir, pt = self.expr(e.args[0], penv)
            ir, pt = self._tofloat(ir, pt)
            fn = "ceil" if name == "ceiling" else name
            return ("math", fn, ir), PT(F64, nonil=False)
        if name == "power":
            a, apt = self.expr(e.args[0], penv)
            b, bpt = self.expr(e.args[1], penv)
            a, _ = self._tofloat(a, apt)
            b, _ = self._tofloat(b, bpt)
            return ("pow", a, b), PT(F64, nonil=False)
        if name in ("neg", "abs"):
            ir, pt = self.expr(e.args[0], penv)
            if pt.is_str:
                raise Unsupported("neg/abs over strings")
            return ("unop", name, ir, pt.dt, not pt.nonil), \
                dataclasses.replace(pt, minval=None, maxval=None)
        if name in ("coalesce", "ifnull", "nvl"):
            return self._coalesce(e, penv)
        if name == "nullif":
            c = Cmp("=", e.args[0], e.args[1])
            c.typ = BOOL
            p = self.pred(c, penv)
            ir, pt = self.expr(e.args[0], penv)
            return ("nullif", p, ir, pt.dt), \
                dataclasses.replace(pt, nonil=False)
        if name in ("upper", "ucase", "lower", "lcase", "trim", "ltrim",
                    "rtrim", "reverse", "substring", "left", "right",
                    "replace", "lpad", "rpad", "repeat"):
            return self._str_func(name, e, penv)
        if name in ("length", "char_length", "character_length",
                    "octet_length"):
            ir, pt = self.expr(e.args[0], penv)
            if not pt.is_str or pt.sdict is None:
                raise Unsupported("length of non-dict value")
            from ..dtypes import is_blob
            div = 2 if is_blob(pt.typ) else 1   # blob length = bytes
            lens = np.array([len(str(v)) // div
                             for v in pt.sdict.values], dtype=np.int32)
            lut = self._add_lut(lens)
            return ("lutmap", lut, ir, "<i4"), PT(I32, nonil=pt.nonil)
        if name == "date_trunc":
            field = e.args[0]
            if not isinstance(field, Const):
                raise Unsupported("dynamic date_trunc field")
            ir, pt = self.expr(e.args[1], penv)
            is_ts = pt.typ.kind == Kind.TIMESTAMP
            return ("dtrunc", str(field.value), ir, is_ts, not pt.nonil), \
                dataclasses.replace(pt, minval=None, maxval=None)
        raise Unsupported(f"function {e.name}")

    def _extract(self, field: str, ir, pt: PT):
        from ..ops.datecalc import _FIELD_ALIASES
        field = _FIELD_ALIASES.get(field, field)
        k = pt.typ.kind
        if k == Kind.TIME:
            if field not in ("hour", "minute", "second", "epoch"):
                raise Unsupported(f"extract {field} from TIME")
            return ("textract", field, ir, not pt.nonil), \
                PT(I64 if field == "epoch" else I32, nonil=pt.nonil)
        if k not in (Kind.DATE, Kind.TIMESTAMP):
            raise Unsupported(f"extract from {pt.typ!r}")
        out_pt = PT(I64 if field == "epoch" else I32, nonil=pt.nonil)
        if field == "year" and k == Kind.DATE and pt.minval is not None \
                and pt.maxval is not None:
            out_pt.minval = 1970 + int(pt.minval) // 366 - 1
            out_pt.maxval = 1970 + int(pt.maxval) // 365 + 1
            # year() over a nonil bounded date column is nonil and bounded:
            # eligible for the dense group-by domain (opt_mitosis-friendly)
            out_pt.nonil = pt.nonil
        return ("dextract", field, ir, k == Kind.TIMESTAMP, not pt.nonil), \
            out_pt

    def _coalesce(self, e: Func, penv):
        out_typ = e.typ
        if out_typ is None:
            raise Unsupported("untyped coalesce")
        vals = [self.expr(a, penv) for a in e.args]
        sd = None
        if out_typ.kind == Kind.STR:
            vals, sd = self._unify_str_vals(vals)
        else:
            vals = [self._coerce(ir, pt, out_typ) for ir, pt in vals]
        ir = vals[-1][0]
        for v_ir, _pt in reversed(vals[:-1]):
            ir = ("ifnil", v_ir, ir, out_typ.np_dtype.str)
        nonil = any(pt.nonil for _ir, pt in vals)
        return ir, PT(out_typ, nonil=nonil, sdict=sd)

    def _str_func(self, name: str, e: Func, penv):
        """Unary-ish string function = host map over the *distinct* dict
        values + device code-remap lut (the strimps/dict trick: compute
        per distinct once, gather by code - gdk_string.c bulk ops)."""
        ir, pt = self.expr(e.args[0], penv)
        if not pt.is_str or pt.sdict is None:
            raise Unsupported(f"{name} over non-dict value")
        args = []
        for a in e.args[1:]:
            la, lpt = self.expr(a, penv)
            if la[0] not in ("lit", "nil"):
                raise Unsupported(f"{name} with non-constant argument")
            if lpt.is_str:
                args.append(None if la[0] == "nil"
                            else str(lpt.sdict.values[la[1]]))
            else:
                args.append(None if la[0] == "nil" else la[1])

        def f(s: str) -> str:
            if name in ("upper", "ucase"):
                return s.upper()
            if name in ("lower", "lcase"):
                return s.lower()
            if name == "trim":
                return s.strip() if not args else s.strip(str(args[0]))
            if name == "ltrim":
                return s.lstrip() if not args else s.lstrip(str(args[0]))
            if name == "rtrim":
                return s.rstrip() if not args else s.rstrip(str(args[0]))
            if name == "reverse":
                return s[::-1]
            if name == "substring":
                start = int(args[0])
                out = s[max(start - 1, 0):]
                if len(args) > 1 and args[1] is not None:
                    out = out[:max(int(args[1]), 0)]
                return out
            if name == "left":
                return s[:max(int(args[0]), 0)]
            if name == "right":
                k = max(int(args[0]), 0)
                return s[-k:] if k else ""
            if name == "replace":
                return s.replace(str(args[0]), str(args[1]))
            if name == "lpad":
                fill = str(args[1]) if len(args) > 1 else " "
                k = int(args[0])
                return (fill * k + s)[-k:] if len(s) < k else s[:k]
            if name == "rpad":
                fill = str(args[1]) if len(args) > 1 else " "
                k = int(args[0])
                return (s + fill * k)[:k] if len(s) < k else s[:k]
            if name == "repeat":
                return s * int(args[0])
            raise Unsupported(name)

        mapped = np.array([f(str(v)) for v in pt.sdict.values], dtype=object)
        uniq, codes = (np.unique(mapped.astype(str), return_inverse=True)
                       if len(mapped) else (np.empty(0, dtype=str),
                                            np.empty(0, dtype=np.int64)))
        lut = self._add_lut(codes.astype(np.int32))
        out_pt = PT(varchar(), nonil=pt.nonil, sdict=StrDict(uniq))
        return ("lutmap", lut, ir, "<i4"), out_pt

    # ======================================================================
    # predicate lowering -> bool IR ("raw": caller ANDs with liveness)
    # ======================================================================

    def pred(self, e: Expr, penv) -> tuple:
        if isinstance(e, BoolOp):
            parts = tuple(self.pred(a, penv) for a in e.args)
            return ("and" if e.op == "and" else "or", parts)
        if isinstance(e, Not):
            return ("not", self.pred(e.arg, penv))
        if isinstance(e, Cmp):
            return self._pred_cmp(e, penv)
        if isinstance(e, Between):
            return self._pred_between(e, penv)
        if isinstance(e, InList):
            return self._pred_inlist(e, penv)
        if isinstance(e, Like):
            return self._pred_like(e, penv)
        if isinstance(e, IsNull):
            ir, pt = self.expr(e.arg, penv)
            p = ("isnilp", ir, pt.dt)
            return ("not", p) if e.negated else p
        if isinstance(e, Const):
            return ("ptrue",) if e.value else ("pfalse",)
        # bare boolean expression
        ir, pt = self.expr(e, penv)
        if pt.typ.kind == Kind.BOOL:
            return ("asbool", ir, pt.dt)
        raise Unsupported(f"predicate {type(e).__name__}")

    _FLIP = {"=": "=", "<>": "<>", "<": ">", "<=": ">=", ">": "<",
             ">=": "<="}
    _CMPN = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt", "<=": "le",
             ">": "gt", ">=": "ge"}

    def _pred_cmp(self, e: Cmp, penv) -> tuple:
        a = self._val_or_scalar(e.left, penv)
        b = self._val_or_scalar(e.right, penv)
        op = e.op
        if isinstance(a, HScalar) and not isinstance(b, HScalar):
            a, b = b, a
            op = self._FLIP[op]
        if isinstance(b, HScalar):
            if isinstance(a, HScalar):                 # const vs const
                return self._fold_cmp(op, a, b)
            return self._cmp_col_scalar(a, op, b)
        # column vs column
        (a_ir, a_pt), (b_ir, b_pt) = a, b
        if a_pt.is_str or b_pt.is_str:
            a_ir, a_pt, b_ir, b_pt = self._align_str(a_ir, a_pt, b_ir, b_pt)
        elif a_pt.is_float or b_pt.is_float:
            a_ir, a_pt = self._tofloat(a_ir, a_pt)
            b_ir, b_pt = self._tofloat(b_ir, b_pt)
        else:
            sa, sb = a_pt.scale, b_pt.scale
            if sa < sb:
                a_ir, a_pt = self._upscale(a_ir, a_pt, sb - sa)
            elif sb < sa:
                b_ir, b_pt = self._upscale(b_ir, b_pt, sa - sb)
        return ("cmp", self._CMPN[op], a_ir, b_ir,
                not a_pt.nonil, not b_pt.nonil, a_pt.dt)

    def _align_str(self, a_ir, a_pt, b_ir, b_pt):
        if not (a_pt.is_str and b_pt.is_str):
            raise Unsupported("string vs non-string comparison")
        if a_pt.sdict is b_pt.sdict:
            return a_ir, a_pt, b_ir, b_pt
        if a_pt.sdict is None or b_pt.sdict is None:
            raise Unsupported("string compare without dictionary")
        # translate right codes into the left code space (-2 = absent)
        idx = np.searchsorted(a_pt.sdict.values, b_pt.sdict.values)
        idx = np.clip(idx, 0, max(len(a_pt.sdict) - 1, 0))
        if len(a_pt.sdict):
            found = a_pt.sdict.values[idx] == b_pt.sdict.values
        else:
            found = np.zeros(len(b_pt.sdict.values), bool)
        remap = np.where(found, idx, -2).astype(np.int32)
        lut = self._add_lut(remap)
        b2 = ("lutmap_keepnil", lut, b_ir)
        return a_ir, a_pt, b2, dataclasses.replace(b_pt, sdict=a_pt.sdict)

    def _val_or_scalar(self, e: Expr, penv):
        """Lower to either an HScalar (host constant) or (ir, pt)."""
        if isinstance(e, Const):
            return self._const(e)
        ir, pt = self.expr(e, penv)
        if ir[0] == "nil":
            return HScalar(None, pt.typ)
        if ir[0] == "lit" and pt.is_str:
            return HScalar(str(pt.sdict.values[ir[1]]), pt.typ)
        if ir[0] == "lit":
            return HScalar(ir[1], pt.typ)
        return (ir, pt)

    def _fold_cmp(self, op, a: HScalar, b: HScalar):
        if a.value is None or b.value is None:
            return ("pfalse",)
        if a.is_float() or b.is_float():
            av, bv = a.as_f64(), b.as_f64()
        elif a.typ is not None and a.typ.kind == Kind.STR:
            av, bv = str(a.value), str(b.value)
        else:
            s = max(a.scale, b.scale)
            av = int(a.value) * 10 ** (s - a.scale)
            bv = int(b.value) * 10 ** (s - b.scale)
        res = {"=": av == bv, "<>": av != bv, "!=": av != bv, "<": av < bv,
               "<=": av <= bv, ">": av > bv, ">=": av >= bv}[op]
        return ("ptrue",) if res else ("pfalse",)

    def _cmp_col_scalar(self, a, op: str, s: HScalar):
        """BATthetaselect semantics (gdk/gdk_select.c:2103 + the
        truth table :1280-1340): nil guards match ops/select.py."""
        ir, pt = a
        if s.value is None:
            return ("pfalse",)
        if pt.is_str:
            sd = pt.sdict
            if sd is None:
                raise Unsupported("string compare without dictionary")
            val = str(s.value)
            if op in ("=", "<>"):
                code = sd.code_of(val)
                node = ("rangesel", ir, "eq", code, 0, True, True, False,
                        pt.dt)
                if op == "<>":
                    return ("rangesel", ir, "ne", code, 0, True, True,
                            not pt.nonil, pt.dt)
                return node
            if op == "<":
                th = sd.range_codes(val, "left")
                return ("rangesel", ir, "lt", th, 0, True, False,
                        not pt.nonil, pt.dt)
            if op == "<=":
                th = sd.range_codes(val, "right")
                return ("rangesel", ir, "lt", th, 0, True, False,
                        not pt.nonil, pt.dt)
            if op == ">":
                tl = sd.range_codes(val, "right")
                return ("rangesel", ir, "ge", tl, 0, True, True, False,
                        pt.dt)
            if op == ">=":
                tl = sd.range_codes(val, "left")
                return ("rangesel", ir, "ge", tl, 0, True, True, False,
                        pt.dt)
            raise Unsupported(op)
        if s.is_float() and not pt.is_float:
            ir, pt = self._tofloat(ir, pt)
            return ("cmp", self._CMPN[op], ir,
                    ("lit", s.as_f64(), "<f8"), not pt.nonil, False, "<f8")
        if pt.is_float:
            return ("cmp", self._CMPN[op], ir,
                    ("lit", s.as_f64(), "<f8"), not pt.nonil, False, pt.dt)
        cs, ss = pt.scale, s.scale
        v = s.value
        if ss > cs:
            ir, pt = self._upscale(ir, pt, ss - cs)
        elif cs > ss:
            v = int(v) * 10 ** (cs - ss)
        v = int(v) if not isinstance(v, bool) else bool(v)
        mode = self._CMPN[op]
        # nil guards per ops/select.py _GUARDED_INT: lt/le/ne admit the
        # int sentinel on a raw compare
        guard = (not pt.nonil) and mode in ("lt", "le", "ne")
        return ("rangesel", ir, mode, v, 0, True, True, guard, pt.dt)

    def _pred_between(self, e: Between, penv) -> tuple:
        a = self._val_or_scalar(e.arg, penv)
        lo = self._val_or_scalar(e.lo, penv)
        hi = self._val_or_scalar(e.hi, penv)
        if isinstance(a, HScalar) or not (isinstance(lo, HScalar)
                                          and isinstance(hi, HScalar)):
            # general shape: a >= lo AND a <= hi
            lo_p = self._cmp_parts(a, ">=", lo, penv)
            hi_p = self._cmp_parts(a, "<=", hi, penv)
            p = ("and", (lo_p, hi_p))
            return ("not", p) if e.negated else p
        ir, pt = a
        if pt.is_str:
            vals = pt.sdict.values
            lv = int(np.searchsorted(vals, str(lo.value), "left"))
            hv = int(np.searchsorted(vals, str(hi.value), "right")) - 1
            mode = "anti_between" if e.negated else "between"
            return ("rangesel", ir, mode, lv, hv, True, True,
                    e.negated and not pt.nonil, pt.dt)
        if lo.value is None or hi.value is None:
            return ("pfalse",)
        if pt.is_float or lo.is_float() or hi.is_float():
            ir2, pt2 = self._tofloat(ir, pt)
            mode = "anti_between" if e.negated else "between"
            return ("rangesel", ir2, mode, lo.as_f64(), hi.as_f64(),
                    True, True, e.negated and not pt2.nonil, pt2.dt)
        s = max(pt.scale, lo.scale, hi.scale)
        if pt.scale < s:
            ir, pt = self._upscale(ir, pt, s - pt.scale)
        lv = int(lo.value) * 10 ** (s - lo.scale)
        hv = int(hi.value) * 10 ** (s - hi.scale)
        mode = "anti_between" if e.negated else "between"
        return ("rangesel", ir, mode, lv, hv, True, True,
                e.negated and not pt.nonil, pt.dt)

    def _cmp_parts(self, a, op, b, penv):
        c = Cmp(op, _Wrapped(a), _Wrapped(b))
        return self._pred_cmp(c, penv)

    def _pred_inlist(self, e: InList, penv) -> tuple:
        ir, pt = self.expr(e.arg, penv)
        items = [self._val_or_scalar(i, penv) for i in e.items]
        if not all(isinstance(i, HScalar) for i in items):
            raise Unsupported("non-constant IN list")
        if pt.is_str:
            if pt.sdict is None:
                raise Unsupported("IN over string without dictionary")
            want = {str(i.value) for i in items if i.value is not None}
            lut = pt.sdict.match_mask(lambda v: v in want)
            li = self._add_lut(lut)
            p = ("strpred", li, ir)
            if e.negated:
                guard = ("notnilp", ir, pt.dt) if not pt.nonil else ("ptrue",)
                return ("and", (guard, ("not", p)))
            return p
        cs = pt.scale
        vals = tuple(sorted(int(i.value) * 10 ** (cs - i.scale)
                            for i in items if i.value is not None))
        p = ("inints", ir, vals, pt.dt)
        if e.negated:
            guard = ("notnilp", ir, pt.dt) if not pt.nonil else ("ptrue",)
            return ("and", (guard, ("not", p)))
        return p

    def _pred_like(self, e: Like, penv) -> tuple:
        """LIKE -> host regex over the dictionary, device code gather
        (ops/strfuncs.py like_cand semantics; strimps analog,
        gdk/gdk_strimps.c). NOT LIKE inverts the lut so nils stay
        excluded (SQL three-valued logic)."""
        import re
        ir, pt = self.expr(e.arg, penv)
        if not pt.is_str or pt.sdict is None:
            raise Unsupported("LIKE over non-dict value")
        from ..ops.strfuncs import _like_mask_vectorized, like_regex
        caseless = getattr(e, "caseless", False)
        flags = re.DOTALL | (re.IGNORECASE if caseless else 0)
        lut = None
        if not getattr(e, "regex", False):
            # vectorized %-pattern matching over the dict: one numpy pass
            # per literal segment; survives distincts ~ rows (the
            # high-cardinality case where a python regex loop collapses)
            lut = _like_mask_vectorized(pt.sdict.values, e.pattern,
                                        e.escape, caseless)
        if lut is None and getattr(e, "regex", False):
            rx = re.compile(e.pattern, flags)
            lut = pt.sdict.match_mask(lambda v: rx.search(v) is not None)
        elif lut is None:
            rx = re.compile(like_regex(e.pattern, e.escape).pattern, flags)
            lut = pt.sdict.match_mask(lambda v: rx.match(v) is not None)
        if e.negated:
            lut = ~lut
        li = self._add_lut(lut)
        return ("strpred", li, ir)


class _Wrapped(Expr):
    """Adapter letting pre-lowered values re-enter _pred_cmp."""
    def __init__(self, lowered):
        super().__init__()
        self.lowered = lowered


# hook _val_or_scalar for _Wrapped
_orig_val_or_scalar = Lowering._val_or_scalar


def _val_or_scalar_w(self, e, penv):
    if isinstance(e, _Wrapped):
        return e.lowered
    return _orig_val_or_scalar(self, e, penv)


Lowering._val_or_scalar = _val_or_scalar_w


# ---------------------------------------------------------------------------
# interpreter - runs the IR eagerly as torch ops on the inputs' device
# ---------------------------------------------------------------------------

_I64_MIN_PY = int(_I64_MIN)


def _bcast(v, cap: int):
    """A 0-d value (literal, scalar aggregate) as a column of cap rows."""
    return v.expand(cap) if v.dim() == 0 else v


def _nil64_to_i32(out):
    """An int64 extract result as int32, nil to nil."""
    return torch.where(out == _I64_MIN_PY, _nil_const(torch.int32),
                       out).to(torch.int32)


def _gather_nil(arr, oids, live_out):
    """arr[oids] with dead slots (live_out False or oid<0) -> nil."""
    ok = live_out & (oids >= 0)
    safe = torch.where(ok, oids, 0).long()
    return torch.where(ok, arr[safe], _nil_const(arr.dtype))


def _group_key(arr):
    """A column as a grouping sort key: grouping needs only a total order
    with nils grouped, so raw integer/code order qualifies; floats go
    through sort_key (NaN is not equal to itself) and bools become
    integers (they do not sort)."""
    if arr.dtype == torch.bool:
        return arr.to(torch.int8)
    if arr.dtype.is_floating_point:
        return sort_key(arr, False, None)
    return arr


class _SegReduce:
    """Segmented reduction over [0, seg) slots (the reference's BATgroup*
    aggregation loops, gdk/gdk_aggr.c:900).  sid holds the segment id in
    [0, seg) for contributing rows and seg for excluded rows.  Two modes,
    picked by segment count as the reference picks them:

    * one-hot (seg <= _ONEHOT_MAX): integer sums go through the
      ``seg_sum64`` kernel (plain version on a CPU tensor).
    * scatter (more slots): integer sums are one ``index_add_`` each.

    Float sums, extrema, products and first indices scatter into seg + 1
    slots in both modes (the spare slot takes the excluded rows and is cut
    off), so the (cap, seg) one-hot matrix that XLA fuses away is never
    built.
    Scattered float sums add in an order that changes from run to run.
    The reference's third mode (reductions in sorted order by prefix
    scans) has no counterpart: the sort group-by assigns ids and reduces
    over them in one of these two modes."""

    def __init__(self, sid, seg: int):
        self.seg = int(seg)
        self.onehot = self.seg <= _ONEHOT_MAX
        self.sid = sid
        self._index = None

    def _idx(self):
        if self._index is None:
            self._index = torch.where(
                (self.sid >= 0) & (self.sid < self.seg), self.sid,
                self.seg).long()
        return self._index

    def sum(self, vals, dtype=None):
        """Per-segment sum; vals must be 0 outside the contributing set."""
        dt = _tdt(dtype) if dtype is not None else vals.dtype
        if self.onehot and not dt.is_floating_point:
            # exact: the int64 sum wraps like the reference's sum in dt
            sums, _cnt = seg_sum64(self.sid, vals.contiguous(),
                                   domain=self.seg)
            return sums.to(dt)
        out = torch.zeros(self.seg + 1, dtype=dt, device=vals.device)
        return out.index_add_(0, self._idx(), vals.to(dt))[: self.seg]

    def extreme(self, vals, fill, is_min: bool):
        """Per-segment min/max; vals must be `fill` outside the set."""
        out = torch.full((self.seg + 1,), fill, dtype=vals.dtype,
                         device=vals.device)
        out.scatter_reduce_(0, self._idx(), vals,
                            reduce="amin" if is_min else "amax")
        return out[: self.seg]

    def prod(self, vals):
        """Per-segment product; vals must be 1 outside the set."""
        out = torch.ones(self.seg + 1, dtype=vals.dtype, device=vals.device)
        return out.scatter_reduce_(0, self._idx(), vals,
                                   reduce="prod")[: self.seg]

    def first_index(self):
        """Lowest contributing row index of each segment (-1 for empty
        segments) - BATgroup extents."""
        cap = self.sid.shape[0]
        rows = torch.arange(cap, dtype=torch.int64, device=self.sid.device)
        ext = self.extreme(rows, cap, True)
        return torch.where(ext == cap, -1, ext)


class _Interp:
    """IR interpreter: every method runs torch ops on the inputs' device
    and none reads a value back to the host.  A node it does not have
    raises Unsupported."""

    def __init__(self, inputs, coll=None, nsh: int = 1):
        self.inputs = inputs
        self.device = inputs[0].device
        # SPMD mode (one shard of a row mesh): the shard's collectives
        # (parallel/mesh.py Collectives) + shard count; None = one device
        self.coll = coll
        self.nsh = nsh
        self.errs: list = []
        # total counts per compaction barrier / group bucket (the host
        # compares each with its static capacity and retries on overflow)
        self.exp_totals: Dict[int, torch.Tensor] = {}
        # per-row error suppression inside untaken CASE branches (the
        # reference only evaluates the taken branch per row,
        # BugTracker-2009 case_evaluates_all_branches.SF-2893484; under
        # eager whole-column evaluation the per-element error conditions
        # are masked by the branch-selection mask instead)
        self._vmask = None

    def flag_rows(self, rows, code: int):
        """Record error ``code`` if any of ``rows`` is set, honoring the
        CASE branch-selection mask (rows where the branch is not taken
        never raise)."""
        if self._vmask is not None:
            rows = rows & self._vmask
        self.errs.append(torch.any(rows).to(torch.int32) * code)

    def _under(self, sel, ir, env, live):
        """Evaluate ``ir`` with errors confined to the rows of ``sel``
        (nested: to the rows the enclosing branches select as well)."""
        outer = self._vmask
        self._vmask = sel if outer is None else (outer & sel)
        try:
            return self.ev(ir, env, live)
        finally:
            self._vmask = outer

    def err(self):
        """This shard's error code (the mesh's is combined with the
        totals in ``combined_scalars``)."""
        if not self.errs:
            return torch.zeros((), dtype=torch.int32, device=self.device)
        return torch.stack(self.errs).max()

    def combined_scalars(self):
        """(error code, count-retry totals) over the whole mesh: the
        reference takes a ``pmax`` of the error and of each total where it
        is made; nothing on the device reads them, so here one ``pmax`` of
        all of them at the end of the run does the same with one
        collective."""
        err, tots = self.err(), self.exp_totals
        if self.coll is None:
            return err, tots
        keys = list(tots)
        vec = self.coll.pmax(torch.stack(
            [err.to(torch.int64)] + [tots[k].to(torch.int64).reshape(())
                                     for k in keys]))
        return vec[0], dict(zip(keys, vec[1:]))

    def _dispatch(self, prefix: str, name: str):
        m = getattr(self, prefix + name, None)
        if m is None:
            raise Unsupported(f"IR node {name!r} not ported yet")
        return m

    # -- relational nodes --------------------------------------------------
    def rel(self, ir):
        return self._dispatch("r_", ir[0])(ir)

    def live_of(self, cap, count, mask):
        live = torch.arange(cap, device=self.device) < count
        if mask is not None:
            live = live & mask
        return live

    def r_scan(self, ir):
        _, cols, cnt_idx, _cap = ir
        env = {key: self.inputs[i] for key, i in cols}
        count = self.inputs[cnt_idx]
        return env, count, None, env[cols[0][0]].shape[0]

    # -- the mesh nodes (SPMD; each is the identity on one device) -----------
    def r_scan_sharded(self, ir):
        """Row-sharded scan (the mitosis slice, opt_mitosis.c:21): shard i
        holds rows [i*lcap, (i+1)*lcap) of the base column; the global
        count becomes a per-shard liveness mask against the global row
        index."""
        _, cols, cnt_idx, _cap = ir
        env = {key: self.inputs[i] for key, i in cols}
        count = self.inputs[cnt_idx]            # global count (replicated)
        lcap = env[cols[0][0]].shape[0]
        if self.coll is None:
            return env, count, None, lcap
        base = self.coll.rank * lcap
        mask = torch.arange(base, base + lcap, device=self.device) < count
        return env, self._full(lcap), mask, lcap

    def _full(self, v: int):
        return torch.full((), v, dtype=torch.int64, device=self.device)

    def r_gather(self, ir):
        """Shard -> replicated barrier: all_gather every column + the
        liveness mask over the mesh (the reference's mat.pack merge of
        mitosis pieces, monetdb5/modules/mal/mat.c:124), in one
        collective."""
        env, count, mask, cap = self.rel(ir[1])
        if self.coll is None:
            return env, count, mask, cap
        keys = list(env)
        got = self.coll.all_gather(
            [_bcast(env[k], cap) for k in keys]
            + [self.live_of(cap, count, mask)])
        gcap = cap * self.nsh
        return dict(zip(keys, got[:-1])), self._full(gcap), got[-1], gcap

    def _repart_code(self, keyspec, env, live, cap):
        """Per-row partition key for a hash-repartition exchange.
        ("join", keyspecs, side) reuses the join's packed key codes so
        both sides of a key land on the same owner shard; ("keys", irs)
        hash-combines normalized sort keys (group-by / distinct)."""
        if keyspec[0] == "join":
            _, keyspecs, side = keyspec
            return self._join_codes(keyspecs, env, live, cap, side)
        h = None
        for e in keyspec[1]:
            k = sort_key(_bcast(self.ev(e, env, live), cap), False, None)
            h = k if h is None else _hash64(h) ^ k
        return h, live

    def r_repartition(self, ir):
        """Ragged all-to-all hash-partition exchange (parallel/shuffle.py
        design; the distributed feature the reference lacks - its remote
        joins ship whole columns to one site, modules/mal/remote.c:971
        RMTput).  Rows move to the shard owning hash(key) mod D; rows
        with invalid keys (nil / out-of-range - they can never match)
        stay local.  Static [D, lane_cap] send buffers, every column and
        the lane counts in one all_to_all (``parallel.shuffle.exchange``);
        the max lane count goes to the host, which retries with a larger
        capacity on overflow (the expanding-join retry discipline)."""
        _, cir, keyspec, lane_cap, ordinal = ir
        env, count, mask, cap = self.rel(cir)
        if self.coll is None:
            return env, count, mask, cap     # single-device: no-op
        D = self.nsh
        live = self.live_of(cap, count, mask)
        code, valid = self._repart_code(keyspec, env, live, cap)
        dest = torch.where(valid & live, _hash64(code) % D,
                           torch.where(live, self.coll.rank, D))
        keys = list(env)
        cnt, got, live_out = exchange(
            dest, [_bcast(env[k], cap) for k in keys],
            [_nil_const(env[k].dtype) for k in keys], lane_cap, self.coll)
        # overflow channel: host compares max lane vs lane_cap, retries
        self.exp_totals[-1 - ordinal] = cnt.max()
        cap2 = D * lane_cap
        return dict(zip(keys, got)), self._full(cap2), live_out, cap2

    def r_rename(self, ir):
        env, count, mask, cap = self.rel(ir[1])
        return {newk: env[oldk] for newk, oldk in ir[2]}, count, mask, cap

    def r_distinct(self, ir):
        """BATunique via sort grouping (gdk/gdk_unique.c): the lowest row
        of each distinct combination survives, in sorted key order."""
        env, count, mask, cap = self.rel(ir[1])
        live = self.live_of(cap, count, mask)
        keys = [_group_key(env[(e[1], e[2])]) for e, _d, _n in ir[2]]
        ng, ids = self._sort_ids(keys, live, cap)
        ext = _SegReduce(ids, cap).first_index()
        live_out = torch.arange(cap, device=self.device) < ng
        env2 = {k: _gather_nil(a, ext, live_out) for k, a in env.items()}
        return env2, ng, None, cap

    def r_compact(self, ir):
        """Compaction barrier: gather live rows to the front of a
        smaller (count-retried) capacity so sort/scatter consumers pay
        for data, not padding (gdk_select.c virtualize role)."""
        _, cir, out_cap, ordinal = ir
        env, count, mask, cap = self.rel(cir)
        live = self.live_of(cap, count, mask)
        oids, nlive, live_out = _compact_oids(live, out_cap)
        # overflow -> count-retry channel (rows would be dropped)
        self.exp_totals[ordinal] = nlive
        env2 = {k: _gather_nil(v, oids, live_out) for k, v in env.items()}
        return env2, nlive, None, out_cap

    def r_filter(self, ir):
        env, count, mask, cap = self.rel(ir[1])
        live = self.live_of(cap, count, mask)
        m = _bcast(self.pv(ir[2], env, live), cap)
        mask = m if mask is None else (mask & m)
        return env, count, mask, cap

    def r_project(self, ir):
        env, count, mask, cap = self.rel(ir[1])
        live = self.live_of(cap, count, mask)
        env2 = {key: _bcast(self.ev(e, env, live), cap) for key, e in ir[2]}
        return env2, count, mask, cap

    def r_orderby(self, ir):
        env, count, mask, cap = self.rel(ir[1])
        live = self.live_of(cap, count, mask)
        keys = [(~live).to(torch.int32)]        # dead rows sort last
        for e, desc, nl in ir[2]:
            keys.append(sort_key(_bcast(self.ev(e, env, live), cap),
                                 desc, nl))
        perm = _lexsort(keys)
        nlive = live.sum()
        live_out = torch.arange(cap, device=self.device) < nlive
        env2 = {k: _gather_nil(a, perm, live_out) for k, a in env.items()}
        return env2, nlive, None, cap

    def r_limit(self, ir):
        _, cir, n, offset, out_cap = ir
        env, count, mask, cap = self.rel(cir)
        dev = self.device
        if mask is None:
            nlive = count
            oids = torch.arange(out_cap, dtype=torch.int64,
                                device=dev) + offset
            oids = torch.where(oids < count, oids, -1)
        else:
            # oids[r] = index of the (offset+r+1)-th live row via one
            # rank-indexed scatter-set (see _compact_oids); ranks before
            # the offset or past out_cap land in the spare slot
            live = self.live_of(cap, count, mask)
            csum = torch.cumsum(live.to(torch.int64), 0)
            nlive = csum[-1]
            pos = csum - 1 - offset
            pos = torch.where(live & (pos >= 0), pos, out_cap)
            oids = _set_drop(out_cap, -1, pos, torch.arange(
                cap, dtype=torch.int64, device=dev))
        count2 = torch.clamp(nlive - offset, 0,
                             out_cap if n is None else min(n, out_cap))
        live_out = torch.arange(out_cap, device=dev) < count2
        env2 = {k: _gather_nil(a, oids, live_out) for k, a in env.items()}
        return env2, count2, None, out_cap

    # joins ------------------------------------------------------------------
    def _join_codes(self, keyspecs, env, live, cap, side: str):
        """Evaluate one side's join keys -> (packed int64 code, valid).
        valid excludes dead rows, nil keys and out-of-bounds values (a
        probe value outside the build stats range cannot match).  Codes
        stay int64: the reference's int32 narrowing serves the TPU's
        sort."""
        comb = None
        valid = live
        for a_ir, anil, b_ir, bnil, lo, span, is_str in keyspecs:
            ir = a_ir if side == "l" else b_ir
            mnil = anil if side == "l" else bnil
            k = _bcast(self.ev(ir, env, live), cap)
            if mnil and not is_str:
                valid = valid & ~_nilm_arr(k)
            k = k.to(torch.int64)
            if span is not None:
                c = k - lo
                valid = valid & (c >= 0) & (c < span)
                comb = c if comb is None else comb * span + c
            else:
                if is_str:
                    valid = valid & (k >= 0)
                comb = k
        return comb, valid

    def _join_sides(self, lir, rir, keyspecs, bfilter):
        """Both inputs of a join, the probe side's liveness, and each
        side's packed key codes with their validity (the build side's
        after its prefilter)."""
        lenv, lcount, lmask, lcap = self.rel(lir)
        renv, rcount, rmask, rcap = self.rel(rir)
        llive = self.live_of(lcap, lcount, lmask)
        rlive = self.live_of(rcap, rcount, rmask)
        if bfilter is not None:
            rlive = rlive & _bcast(self.pv(bfilter, renv, rlive), rcap)
        code_l, lvalid = self._join_codes(keyspecs, lenv, llive, lcap, "l")
        code_r, rvalid = self._join_codes(keyspecs, renv, rlive, rcap, "r")
        return (lenv, lcount, lmask, lcap, llive, code_l, lvalid,
                renv, rcap, code_r, rvalid)

    def r_join(self, ir):
        """Equi-join against a build side that matches each probe row at
        most once.  Of duplicate build keys the lowest build row wins in
        both strategies (scatter-min of row ids; stable sort + leftmost
        binary search), so semi and anti joins, which tolerate duplicates,
        see the reference's rows."""
        (_, kind, lir, rir, keyspecs, strat, domain, uniq_check,
         bfilter, extra, rkeys, ordinal) = ir
        (lenv, lcount, lmask, lcap, llive, code_l, lvalid,
         renv, rcap, code_r, rvalid) = self._join_sides(
            lir, rir, keyspecs, bfilter)
        dev = self.device

        if strat == "dense":
            # direct-address build (fetchjoin/hashjoin analog): invalid
            # build rows go to the spare slot `domain`, which is cut off
            rid = torch.arange(rcap, dtype=torch.int32, device=dev)
            safe_r = torch.where(rvalid, code_r, domain)
            tmin = torch.full((domain + 1,), rcap, dtype=torch.int32,
                              device=dev)
            tmin.scatter_reduce_(0, safe_r, rid, reduce="amin")
            tmin = tmin[:domain]
            if uniq_check:
                tmax = torch.full((domain + 1,), -1, dtype=torch.int32,
                                  device=dev)
                tmax.scatter_reduce_(0, safe_r, rid, reduce="amax")
                dup = (tmin < rcap) & (tmax[:domain] != tmin)
                self.flag_rows(dup, _ERR_DUP_BASE + ordinal)
            hit = tmin[torch.where(lvalid, code_l, 0)]
            matched = lvalid & (hit < rcap)
            rowid = torch.where(matched, hit, -1).long()
        else:
            # sort + binary-search probe (mergejoin analog); invalid rows
            # carry the sentinel and sort last
            sent = torch.iinfo(torch.int64).max
            kr = torch.where(rvalid, code_r, sent)
            ks, rs = torch.sort(kr, stable=True)
            if uniq_check:
                dup = (ks[1:] == ks[:-1]) & (ks[1:] != sent)
                self.flag_rows(dup, _ERR_DUP_BASE + ordinal)
            kl = torch.where(lvalid, code_l, sent)
            pos = torch.searchsorted(ks, kl, right=False).clamp(
                0, rcap - 1)
            matched = lvalid & (ks[pos] == kl) & (kl != sent)
            rowid = torch.where(matched, rs[pos], -1)

        def masked(m):
            return m if lmask is None else (lmask & m)

        if kind in ("semi", "anti") and extra is None:
            return lenv, lcount, masked(matched if kind == "semi"
                                        else ~matched), lcap

        menv = dict(lenv)
        ok = rowid >= 0
        for k in rkeys:
            menv[k] = _gather_nil(renv[k], rowid, ok)
        if extra is not None:
            matched = matched & _bcast(self.pv(extra, menv, llive), lcap)
            if kind in ("semi", "anti"):
                return lenv, lcount, masked(matched if kind == "semi"
                                            else ~matched), lcap
            if kind != "inner":
                for k in rkeys:
                    a = menv[k]
                    menv[k] = torch.where(matched, a, _nil_const(a.dtype))
        if kind == "inner":
            return menv, lcount, masked(matched), lcap
        return menv, lcount, lmask, lcap     # left outer

    def r_join_expand(self, ir):
        """N:M join by match enumeration (gdk/gdk_join.c:2900 hashjoin with
        duplicate keys).  Build side sorted by key; per probe row the match
        run is [searchsorted left, searchsorted right); output slot j maps
        back to (probe row, k-th match) through a cumsum of per-probe
        output counts.  The total match count goes to the host, which
        retries with a larger static capacity on overflow.  Slots at and
        past the total hold garbage, so every index is clipped before it
        gathers.  (Of the reference's two ways to find a match run, the
        histogram LUT over a dense key domain and the two binary searches,
        the port keeps the searches: they serve every key domain.)"""
        (_, kind, lir, rir, keyspecs, bfilter, extra, lkeys, rkeys,
         ecap, ordinal) = ir
        (lenv, lcount, lmask, lcap, llive, code_l, lvalid,
         renv, rcap, code_r, rvalid) = self._join_sides(
            lir, rir, keyspecs, bfilter)
        dev = self.device

        sent = torch.iinfo(torch.int64).max
        ks, rs = torch.sort(torch.where(rvalid, code_r, sent), stable=True)
        kl = torch.where(lvalid, code_l, sent)
        s = torch.searchsorted(ks, kl, right=False)
        e = torch.searchsorted(ks, kl, right=True)
        c = torch.where(lvalid, e - s, 0)
        if kind == "left":
            # probe rows with no match still emit one (nil-right) row
            c_out = torch.where(llive, c.clamp(min=1), 0)
        else:
            c_out = c
        csum = torch.cumsum(c_out, 0)
        total = csum[-1] if lcap else \
            torch.zeros((), dtype=torch.int64, device=dev)
        self.exp_totals[ordinal] = total

        # slot j -> owning probe row: the first row whose running count
        # passes j (rows that emit nothing repeat their predecessor's
        # count and are skipped).  The reference scatters each emitting
        # row's first slot and backfills with a running max; torch's
        # cummax kernel took 12.3 ms over 2^21 slots on an H100, three
        # quarters of Q13's device time, where this binary search is one
        # gather-bound pass
        row_starts = csum - c_out
        j = torch.arange(ecap, dtype=torch.int64, device=dev)
        i_safe = torch.searchsorted(csum, j, right=True).clamp(
            0, max(lcap - 1, 0))
        ok = j < total
        k = j - row_starts[i_safe]
        rok = ok & (k < c[i_safe])
        ridx = rs[(s[i_safe] + k).clamp(0, max(rcap - 1, 0))]

        env2 = {key: _gather_nil(lenv[key], i_safe, ok) for key in lkeys}
        for key in rkeys:
            env2[key] = _gather_nil(renv[key], ridx, rok)
        if kind in ("semi", "anti"):
            # evaluate the residual per pair; pairs are emitted in
            # probe-row order, so "any pair of probe row i passed" is a
            # range-sum over [csum[i] - c_out[i], csum[i]): a cumsum and
            # two gathers
            ex = rok
            if extra is not None:
                ex = ex & _bcast(self.pv(extra, env2, ok), ecap)
            cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(ex.to(torch.int64), 0)])
            hit = (cs[csum.clamp(0, ecap)]
                   - cs[row_starts.clamp(0, ecap)]) > 0
            m = hit if kind == "semi" else ~hit
            return lenv, lcount, m if lmask is None else (lmask & m), lcap
        if extra is not None:
            return env2, total, \
                ok & _bcast(self.pv(extra, env2, ok), ecap), ecap
        return env2, total, None, ecap

    def r_groupby_dense(self, ir, spmd: bool = False):
        """Histogram grouping over a combined small domain
        (gdk/gdk_group.c:20-60 strategies 4-5): aggregates land in domain
        slots, then compact by presence rank.  Group keys are decoded from
        the slot index itself (the slot IS the packed key combination).
        SPMD mode: per-shard slot partials are combined across the mesh
        with psum/pmin/pmax (the mat_grp + BATgroupavg3combine shape,
        gdk/gdk_aggr.c:2634), so every shard materializes identical,
        replicated outputs without gathering rows."""
        (_, cir, key_outs, dense_specs, domain, aggs, fetch_keys,
         out_cap, ordinal) = ir
        env, count, mask, cap = self.rel(cir)
        dev = self.device
        mcoll = self.coll if spmd else None
        live = self.live_of(cap, count, mask)
        comb = torch.zeros(cap, dtype=torch.int64, device=dev)
        for code_ir, d, _dt in dense_specs:
            comb = comb * d + self._dcode(code_ir, env, live, cap)
        safe = torch.where(live, comb, domain)
        red = _SegReduce(safe, domain)
        if dense_specs:
            hist = red.sum(live.to(torch.int32))
            if mcoll is not None:
                hist = mcoll.psum(hist)
            present = hist > 0
            newid = torch.cumsum(present.to(torch.int64), 0) - 1
            ng = present.sum()
        else:
            # scalar aggregation: always exactly one output row, even for
            # empty input (SQL: SELECT sum(x) over nothing -> one nil row)
            present = torch.ones(1, dtype=torch.bool, device=dev)
            newid = torch.zeros(1, dtype=torch.int64, device=dev)
            ng = torch.ones((), dtype=torch.int64, device=dev)
        if out_cap < max(domain, 1):
            # group-output capacity retry channel (count-then-allocate)
            self.exp_totals[ordinal] = ng
        pos = torch.where(present, newid, out_cap)

        def compact(slot_vals, fill):
            return _set_drop(out_cap, fill, pos, slot_vals)

        env2 = {}
        live_out = torch.arange(out_cap, device=dev) < ng
        if key_outs:
            # compact rank -> slot index -> key values (mixed-radix decode)
            slot_of = compact(torch.arange(domain, dtype=torch.int64,
                                           device=dev), -1)
            ok = live_out & (slot_of >= 0)
            rem = torch.where(ok, slot_of, 0)
            vals = []
            for code_ir, d, dt in reversed(dense_specs):
                code = rem % d
                rem = rem // d
                vals.append(self._decode_dcode(code_ir, code, dt, ok))
            vals.reverse()
            for (key, _e), v in zip(key_outs, vals):
                env2[key] = v
        if fetch_keys:
            # FD-dropped keys: gather from each group's representative
            # row (BATgroup extents; the value is well-defined per group
            # because the key is functionally determined)
            ext_rank = compact(red.first_index(), -1)
            for key, e in fetch_keys:
                arr = _bcast(self.ev(e, env, live), cap)
                env2[key] = _gather_nil(arr, ext_rank, live_out)
        for key, spec in aggs:
            slot = self._agg_slots(spec, env, live, cap, red, mcoll)
            if isinstance(slot, tuple):     # wide sum: (lo, hi) limbs
                lo, hi = slot
                env2[key] = compact(lo, _I64_MIN_PY)
                env2[_hikey(key)] = compact(hi, 0)
            else:
                env2[key] = compact(slot, _nil_const(slot.dtype))
        return env2, ng, None, out_cap

    def r_groupby_dense_spmd(self, ir):
        return self.r_groupby_dense(ir, spmd=True)

    def _sort_ids(self, keys, live, cap):
        """Per-row group ids via device sort (ops/group.py _sort_group):
        (number of groups, id per original row in [0, ng), cap for dead
        rows).  Ids follow the sorted key order; the sort is stable, so
        the lowest row of a group is its first sorted element."""
        dead = (~live).to(torch.int8)
        perm = _lexsort([dead] + keys)
        live_s = dead[perm] == 0
        bound = torch.zeros(cap, dtype=torch.bool, device=self.device)
        bound[:1] = True
        for k in keys:
            k_s = k[perm]
            bound[1:] |= k_s[1:] != k_s[:-1]
        gid_s = torch.cumsum((bound & live_s).to(torch.int64), 0) - 1
        ng = torch.where(live_s, gid_s, -1).max() + 1
        ids = torch.empty(cap, dtype=torch.int64, device=self.device)
        ids[perm] = torch.where(live_s, gid_s, cap)
        return ng, ids

    def r_groupby_sort(self, ir):
        """General grouping: device lexsort + boundary scan (replaces the
        reference's hash strategies; gdk/gdk_group.c:1347 BATgroup).  The
        sort only assigns group ids; the aggregates then reduce over those
        ids as the dense strategy's do (the reference reduces in sorted
        order with prefix scans instead, to spare the TPU its scatters)."""
        _, cir, key_outs, sort_keys, aggs, out_cap, ordinal = ir
        env, count, mask, cap = self.rel(cir)
        live = self.live_of(cap, count, mask)
        karrs = []
        for e in sort_keys:
            karrs.append(_group_key(_bcast(self.ev(e, env, live), cap)))
        ng, ids = self._sort_ids(karrs, live, cap)
        red = _SegReduce(ids, cap)
        env2 = {}
        if key_outs:
            ext = red.first_index()
            live_out = torch.arange(cap, device=self.device) < ng
            for key, e in key_outs:
                arr = _bcast(self.ev(e, env, live), cap)
                env2[key] = _gather_nil(arr, ext, live_out)
        for key, spec in aggs:
            slot = self._agg_slots(spec, env, live, cap, red)
            if isinstance(slot, tuple):     # wide sum: (lo, hi) limbs
                env2[key], env2[_hikey(key)] = slot
            else:
                env2[key] = slot
        # outputs are rank-compacted in [0, ng): slice to the group
        # bucket; ng overflow goes to the count-then-retry channel
        eff = min(out_cap, cap)
        if eff < cap:
            self.exp_totals[ordinal] = ng
            env2 = {k: v[:eff] for k, v in env2.items()}
        return env2, ng, None, eff

    @staticmethod
    def _decode_dcode(code_ir, code, dt, ok):
        """Inverse of _dcode: slot code -> key value (nil where ~ok)."""
        kind = code_ir[0]
        dtype = _tdt(dt)
        if kind == "dcode_str":
            d = code_ir[2]
            v = code.to(torch.int32)
            ok = ok & (v != d - 1)        # last slot = the nil string
        elif kind == "dcode_bool":
            return ok & (code > 0) if dtype == torch.bool else \
                torch.where(ok, code.to(dtype), _nil_const(dtype))
        elif kind == "dcode_i8":
            v = (code - 128).to(torch.int8)
        else:  # dcode_range
            v = (code + code_ir[2]).to(dtype)
        return torch.where(ok, v, _nil_const(dtype))

    def _dcode(self, code_ir, env, live, cap):
        """Column -> code in [0, D) (ops/group.py _codes incl. nil slot)."""
        kind = code_ir[0]
        arr = _bcast(self.ev(code_ir[1], env, live), cap)
        if kind == "dcode_str":
            c = arr.to(torch.int64)
            return torch.where(c < 0, code_ir[2] - 1, c)
        if kind == "dcode_bool":
            return arr.to(torch.int64)
        if kind == "dcode_i8":
            return arr.to(torch.int64) + 128
        if kind == "pcode_rangenil":
            # sort-key packing slot for a nullable range: nil -> 0,
            # value -> (v - lo) + 1 (nils-first group order)
            return torch.where(_nilm_arr(arr), 0,
                               arr.to(torch.int64) - code_ir[2] + 1)
        # dcode_range
        return arr.to(torch.int64) - code_ir[2]

    def _agg_slots(self, spec, env, live, cap, red, comb=None):
        """Aggregates into [0, seg) slots (gdk_aggr.c BATgroupsum family;
        mirrors ops/aggr.py _seg_reduce + _fix_empty_and_nil).  ``comb``:
        the mesh's collectives - per-shard slot partials are combined
        (psum for sums and counts, pmin/pmax for extrema) before
        finalization, the associative decomposition the reference uses for
        partitioned aggregation (BATgroupavg3combine, gdk/gdk_aggr.c:2634).
        """
        def comb_sum(x):
            return x if comb is None else comb.psum(x)

        op = spec[0]
        if op == "count_star":
            return comb_sum(red.sum(live.to(torch.int64)))
        arr = _bcast(self.ev(spec[1], env, live), cap)
        nilm = _nilm_arr(arr) if spec[2] else \
            torch.zeros(cap, dtype=torch.bool, device=self.device)
        use = live & ~nilm
        if op == "count":
            return comb_sum(red.sum(use.to(torch.int64)))
        if op in ("count_distinct", "sum_distinct", "avg_distinct"):
            # not shard-combinable: the SPMD rewrite repartitions or
            # gathers before a distinct aggregate
            if comb is not None:
                raise Unsupported("distinct aggregate under SPMD combine")
            return self._agg_distinct(spec, arr, use, cap, red)
        cnt = comb_sum(red.sum(use.to(torch.int64)))
        if op == "sum":
            return self._sum_slots(spec, arr, use, cnt, red, comb_sum)
        if op == "prod":
            acc_dt = _tdt(spec[4])
            out = red.prod(torch.where(use, arr.to(acc_dt), 1))
            if comb is not None:
                # no product collective: gather the partials, reduce
                out = comb.all_gather(out[None]).prod(0)
            return torch.where(cnt == 0, _nil_const(acc_dt), out)
        if op == "moment2":
            want, sample, scale = spec[4], spec[5], spec[6]
            xf = torch.where(use, arr.to(torch.float64), 0.0)
            s1 = comb_sum(red.sum(xf))
            s2 = comb_sum(red.sum(xf * xf))
            denom = torch.clamp(cnt - 1 if sample else cnt, min=1)
            var = (s2 - s1 * s1 / torch.clamp(cnt, min=1)) / denom
            var = torch.clamp(var, min=0.0)
            if scale:
                var = var / (10.0 ** (2 * scale))
            bad = (cnt <= 1) if sample else (cnt == 0)
            out = torch.sqrt(var) if want == "std" else var
            return torch.where(bad, float("nan"), out)
        if op not in ("avg", "min", "max"):
            raise Unsupported(f"aggregate {op}")
        if op == "avg":
            scale = spec[4]
            if arr.dtype.is_floating_point:
                f = comb_sum(red.sum(
                    torch.where(use, arr.to(torch.float64), 0.0)))
            else:
                s = comb_sum(red.sum(torch.where(use, arr.to(torch.int64),
                                                 0)))
                f = s.to(torch.float64)
            if scale:
                f = f / (10.0 ** scale)
            a = f / torch.clamp(cnt, min=1)
            return torch.where(cnt == 0, float("nan"), a)
        dt = arr.dtype
        if op == "min":
            fill = float("inf") if dt.is_floating_point else \
                torch.iinfo(dt).max
        else:
            fill = float("-inf") if dt.is_floating_point else \
                torch.iinfo(dt).min
        out = red.extreme(torch.where(use, arr, fill), fill, op == "min")
        if comb is not None:
            out = comb.pmin(out) if op == "min" else comb.pmax(out)
        return torch.where(cnt == 0, _nil_const(dt), out)

    @staticmethod
    def _sum_slots(spec, arr, use, cnt, red, comb_sum=lambda x: x):
        """sum / sum_distinct over the rows of ``use`` (nil for a segment
        none contributes to); spec[5] asks for the wide (lo, hi) form.
        ``comb_sum`` combines the partials of a mesh's shards."""
        acc_dt = _tdt(spec[4])
        vals = torch.where(use, arr.to(acc_dt), 0)
        if spec[5]:
            # exact int128-range accumulation via paired 32-bit limbs:
            # lo = sum of the low halves, hi = sum of the arithmetic
            # high halves; both int64, both psum-combinable, exact
            # total = hi*2^32 + lo
            v64 = vals.to(torch.int64)
            lo = comb_sum(red.sum(v64 & 0xFFFFFFFF))
            hi = comb_sum(red.sum(v64 >> 32))
            hi = hi + (lo >> 32)   # carry: lo into [0, 2^32)
            lo = lo & 0xFFFFFFFF
            return torch.where(cnt == 0, _I64_MIN_PY, lo), hi
        out = comb_sum(red.sum(vals, acc_dt))
        return torch.where(cnt == 0, _nil_const(acc_dt), out)

    def _agg_distinct(self, spec, arr, use, cap, red):
        """DISTINCT aggregates: dedup (group, value) pairs by a sort, then
        reduce the first occurrence of each pair (gdk_aggr.c
        count-distinct; the fused form of BATgroup-refine +
        BATgroupcount).  The reference reduces the sorted rows with prefix
        scans; here the flags go through the same segment reduction as
        every other aggregate."""
        op, seg = spec[0], red.seg
        k1 = torch.where(use, red.sid.to(torch.int64), seg)
        k2 = sort_key(arr, False, None)
        perm = _lexsort([k1, k2])
        k1s, k2s, vs = k1[perm], k2[perm], arr[perm]
        first = torch.ones(cap, dtype=torch.bool, device=self.device)
        first[1:] = (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])
        fu = first & (k1s < seg)
        dred = _SegReduce(k1s, seg)
        cnt_d = dred.sum(fu.to(torch.int64))
        if op == "count_distinct":
            return cnt_d
        if op == "sum_distinct":
            return self._sum_slots(spec, vs, fu, cnt_d, dred)
        scale = spec[4]
        sd = dred.sum(torch.where(fu, vs.to(torch.float64), 0.0))
        if scale:
            sd = sd / (10.0 ** scale)
        a = sd / torch.clamp(cnt_d, min=1)
        return torch.where(cnt_d == 0, float("nan"), a)

    # -- expression nodes ---------------------------------------------------
    def ev(self, ir, env, live):
        return self._dispatch("e_", ir[0])(ir, env, live)

    def e_env(self, ir, env, live):
        return env[(ir[1], ir[2])]

    def e_in(self, ir, env, live):
        return self.inputs[ir[1]]

    def _scalar(self, v, dt):
        """A 0-d tensor on the device, made by a fill: a copy from host
        memory would wait for the stream."""
        return torch.full((), v, dtype=_tdt(dt), device=self.device)

    def e_lit(self, ir, env, live):
        return self._scalar(np.dtype(ir[2]).type(ir[1]).item(), ir[2])

    def e_nil(self, ir, env, live):
        return self._scalar(_nil_const(ir[1]), ir[1])

    def e_bool2val(self, ir, env, live):
        return (self.pv(ir[1], env, live) & live).to(torch.int8)

    def e_packcode(self, ir, env, live):
        """Mixed-radix pack of dense key codes into one int64 sort key
        (exact mkey.bulk_rotate_xor_hash role, modules/mal/mkey.c)."""
        cap = live.shape[0]
        comb = None
        for code_ir, d in ir[1]:
            code = self._dcode(code_ir, env, live, cap)
            comb = code if comb is None else comb * d + code
        return comb

    def e_whi(self, ir, env, live):
        """High-limb order key of a wide sum: hi, with the lo nil
        sentinel propagated so nil groups sort by the nulls rule."""
        lo = env[ir[1]]
        hi = env[ir[2]]
        return torch.where(lo == _I64_MIN_PY, _I64_MIN_PY, hi)

    def e_wnarrow(self, ir, env, live):
        """Wide (int128-range) sum -> int64, exact fits-check.  The limb
        invariant (lo in [0, 2^32), total = hi*2^32 + lo) makes the check
        precise: the value fits int64 iff hi is in [-2^31, 2^31)."""
        lo = env[ir[1]]
        hi = env[ir[2]]
        isnil = lo == _I64_MIN_PY
        fits = (hi >= -(1 << 31)) & (hi < (1 << 31))
        self.flag_rows(live & ~isnil & ~fits, 4)
        return torch.where(isnil, _I64_MIN_PY, hi * (1 << 32) + lo)

    def e_iarith(self, ir, env, live):
        """Integer/decimal arithmetic with the reference's overflow and
        div-by-zero errors (gdk/gdk_calc_addsub.c ON_OVERFLOW; mirrors
        ops/calc.py _binop) - error checks restricted to *live* rows.
        int64 wraps in torch as in XLA, which the sign checks rely on."""
        _, op, a_ir, b_ir, out_dt, check, anil, bnil = ir
        a = self.ev(a_ir, env, live)
        b = self.ev(b_ir, env, live)
        dt = _tdt(out_dt)
        nil_in = torch.zeros(live.shape, dtype=torch.bool, device=self.device)
        if anil:
            nil_in = nil_in | _nilm_arr(a).expand(live.shape)
        if bnil:
            nil_in = nil_in | _nilm_arr(b).expand(live.shape)
        valid = live & ~nil_in
        ai = a.to(dt)
        bi = b.to(dt)
        if op == "add":
            res = ai + bi
            if check:
                self.flag_rows(valid & (((ai ^ res) & (bi ^ res)) < 0), 1)
        elif op == "sub":
            res = ai - bi
            if check:
                self.flag_rows(valid & (((ai ^ bi) & (ai ^ res)) < 0), 1)
        elif op == "mul":
            res = ai * bi
            if check:
                if dt.itemsize < 8:
                    wide = ai.to(torch.int64) * bi.to(torch.int64)
                    ovf = wide != res.to(torch.int64)
                else:
                    bz = bi == 0
                    ovf = (~bz) & (_idiv(res, bi) != ai)
                    ovf = ovf | ((ai == _I64_MIN_PY) & (bi == -1))
                self.flag_rows(valid & ovf, 1)
        elif op == "div":
            res = _idiv(ai, bi)
            self.flag_rows(valid & (bi == 0), 2)
            if check:
                ovf = (ai == torch.iinfo(dt).min) & (bi == -1)
                self.flag_rows(valid & ovf, 1)
        elif op == "mod":
            res = _irem(ai, bi)
            self.flag_rows(valid & (bi == 0), 2)
        else:
            raise Unsupported(op)
        return torch.where(valid, res, _nil_const(dt))

    def e_farith(self, ir, env, live):
        _, op, a_ir, b_ir, _anil, _bnil = ir
        a = self.ev(a_ir, env, live).to(torch.float64)
        b = self.ev(b_ir, env, live).to(torch.float64)
        if op == "add":
            return a + b
        if op == "sub":
            return a - b
        if op == "mul":
            return a * b
        if op == "mod":
            bz = b == 0
            return torch.where(
                bz, float("nan"),
                a - torch.trunc(a / torch.where(bz, 1.0, b)) * b)
        raise Unsupported(op)

    def e_fdiv(self, ir, env, live):
        """Float division; nil is NaN, and a zero divisor of a live,
        non-nil row is the reference's error 22012."""
        _, _op, a_ir, b_ir, anil, bnil = ir
        a = self.ev(a_ir, env, live).to(torch.float64)
        b = self.ev(b_ir, env, live).to(torch.float64)
        valid = live
        if anil:
            valid = valid & ~torch.isnan(a)
        if bnil:
            valid = valid & ~torch.isnan(b)
        bz = b == 0
        self.flag_rows(valid & bz, 2)
        return torch.where(bz, float("nan"), a / torch.where(bz, 1.0, b))

    def e_tofloat(self, ir, env, live):
        _, a_ir, scale, anil, _dt = ir
        a = self.ev(a_ir, env, live)
        f = a.to(torch.float64)
        if a.dtype.is_floating_point:
            return f
        if scale:
            f = f / (10.0 ** scale)
        if anil or a.dtype != torch.bool:
            f = torch.where(_nilm_arr(a), float("nan"), f)
        return f

    def e_upscale(self, ir, env, live):
        _, a_ir, k, anil, _dt, _check = ir
        a = self.ev(a_ir, env, live)
        x = a.to(torch.int64) * (10 ** k)
        return torch.where(_nilm_arr(a), _I64_MIN_PY, x)

    def e_convert(self, ir, env, live):
        """gdk/gdk_calc_convert.c semantics (mirrors ops/calc.py _convert):
        float->int rounds half away from zero, integer downscale rounds
        half away, narrowing range-checked (error 3)."""
        _, a_ir, out_dt, up, down, check, anil, _in_dt, _fdec, _tdec = ir
        a = self.ev(a_ir, env, live)
        dt = _tdt(out_dt)
        a_f = a.dtype.is_floating_point
        a_i = not a_f and a.dtype != torch.bool
        to_i = not dt.is_floating_point and dt != torch.bool
        nilm = _nilm_arr(a)         # all-False for bools
        valid = live & ~nilm
        if a_f and to_i:
            xs = a * (10 ** up) if up else a
            r = torch.where(xs >= 0, torch.floor(xs + 0.5),
                            torch.ceil(xs - 0.5))
            if check:
                lo = float(torch.iinfo(dt).min + 1)
                hi = float(torch.iinfo(dt).max)
                self.flag_rows(valid & ((r < lo) | (r > hi)), 3)
            res = r.to(dt)
        elif a_i and dt.is_floating_point and down:
            res = a.to(dt) / (10 ** down)
        else:
            x = a.to(torch.int64) if (a_i and (up or down)) else a
            if up:
                x = x * (10 ** up)
            if down:
                d = 10 ** down
                half = d // 2
                x = torch.where(x >= 0, (x + half) // d,
                                -((-x + half) // d))
            if check and a_i and to_i and dt.itemsize < 8:
                lo = torch.iinfo(dt).min + 1
                hi = torch.iinfo(dt).max
                self.flag_rows(valid & ((x < lo) | (x > hi)), 3)
            res = x.to(dt)
        return torch.where(nilm, _nil_const(dt), res)

    def e_lutmap(self, ir, env, live):
        _, lut_i, a_ir, out_dt = ir
        lut = self.inputs[lut_i]
        a = self.ev(a_ir, env, live)
        nil = _nil_const(out_dt)
        if lut.shape[0] == 0:      # empty dict: every code is nil
            return torch.full(a.shape, nil, dtype=_tdt(out_dt),
                              device=self.device)
        ok = a >= 0
        return torch.where(ok, lut[torch.where(ok, a, 0).long()], nil)

    def e_lutmap_keepnil(self, ir, env, live):
        _, lut_i, a_ir = ir
        lut = self.inputs[lut_i]
        a = self.ev(a_ir, env, live)
        if lut.shape[0] == 0:      # empty dict: no valid codes exist
            return a.clamp(max=-1)
        ok = a >= 0
        return torch.where(ok, lut[torch.where(ok, a, 0).long()], a)

    def e_case(self, ir, env, live):
        """Every branch is evaluated for all rows; its errors (division
        by zero, overflow) only fire for rows that take it (_vmask), as
        the reference's per-row lazy CASE.  Values are cast to the node's
        type before torch.where, which would otherwise promote."""
        _, whens, default, out_dt = ir
        dt = _tdt(out_dt)
        taken = torch.zeros(live.shape, dtype=torch.bool, device=self.device)
        branches = []
        for p_ir, v_ir in whens:
            p = self.pv(p_ir, env, live).expand(live.shape)
            branches.append((p, p & ~taken, v_ir))
            taken = taken | p
        res = self._under(~taken, default, env, live).to(dt)
        for p, sel, v_ir in reversed(branches):
            res = torch.where(p, self._under(sel, v_ir, env, live).to(dt),
                              res)
        return res

    def e_ifnil(self, ir, env, live):
        _, a_ir, b_ir, out_dt = ir
        dt = _tdt(out_dt)
        a = self.ev(a_ir, env, live).to(dt)
        isnil = _nilm_arr(a)
        # COALESCE's fallback is lazy per row (see e_case)
        b = self._under(isnil.expand(live.shape), b_ir, env, live).to(dt)
        return torch.where(isnil, b, a)

    def e_nullif(self, ir, env, live):
        _, p_ir, a_ir, dt = ir
        p = self.pv(p_ir, env, live)
        return torch.where(p, _nil_const(dt), self.ev(a_ir, env, live))

    def e_unop(self, ir, env, live):
        _, name, a_ir, _dt, _anil = ir
        a = self.ev(a_ir, env, live)
        res = -a if name == "neg" else torch.abs(a)
        if a.dtype.is_floating_point:
            return res                # NaN stays NaN
        return torch.where(_nilm_arr(a), _nil_const(a.dtype), res)

    _MATH_FNS = {"sqrt": torch.sqrt, "ln": torch.log, "log10": torch.log10,
                 "exp": torch.exp, "sin": torch.sin, "cos": torch.cos,
                 "tan": torch.tan, "floor": torch.floor, "ceil": torch.ceil}

    def e_math(self, ir, env, live):
        return self._MATH_FNS[ir[1]](self.ev(ir[2], env, live))

    def e_pow(self, ir, env, live):
        return torch.pow(self.ev(ir[1], env, live),
                         self.ev(ir[2], env, live))

    def e_dextract(self, ir, env, live):
        """EXTRACT from a date or timestamp: int32 with the int32 minimum
        as nil; ``epoch`` stays int64."""
        from ..ops.datecalc import _extract
        _, field, a_ir, is_ts, _anil = ir
        out = _extract(self.ev(a_ir, env, live), field=field, is_ts=is_ts)
        return out if field == "epoch" else _nil64_to_i32(out)

    def e_textract(self, ir, env, live):
        _, field, a_ir, _anil = ir
        us = self.ev(a_ir, env, live)
        if field == "hour":
            out = us // 3_600_000_000
        elif field == "minute":
            out = (us // 60_000_000) % 60
        elif field == "second":
            out = (us // 1_000_000) % 60
        else:  # epoch
            out = us // 1_000_000
        out = torch.where(us == _I64_MIN_PY, _I64_MIN_PY, out)
        return out if field == "epoch" else _nil64_to_i32(out)

    def e_dtrunc(self, ir, env, live):
        from ..ops.datecalc import _trunc
        _, field, a_ir, is_ts, _anil = ir
        return _trunc(self.ev(a_ir, env, live), field=field, is_ts=is_ts)

    # -- predicates -----------------------------------------------------------
    def pv(self, ir, env, live):
        return self._dispatch("p_", ir[0])(ir, env, live)

    def p_ptrue(self, ir, env, live):
        return self._scalar(True, torch.bool)

    def p_pfalse(self, ir, env, live):
        return self._scalar(False, torch.bool)

    def p_not(self, ir, env, live):
        return ~self.pv(ir[1], env, live)

    def p_isnilp(self, ir, env, live):
        return _nilm_arr(self.ev(ir[1], env, live))

    def p_notnilp(self, ir, env, live):
        return ~_nilm_arr(self.ev(ir[1], env, live))

    def p_inints(self, ir, env, live):
        _, a_ir, vals, _dt = ir
        x = self.ev(a_ir, env, live)
        t = _npdt(x.dtype).type     # values cast to the column's type
        m = torch.zeros(x.shape, dtype=torch.bool, device=self.device)
        for v in vals:
            m = m | (x == t(v).item())
        return m

    def p_asbool(self, ir, env, live):
        x = self.ev(ir[1], env, live)
        return x if x.dtype == torch.bool else x == 1

    def p_and(self, ir, env, live):
        parts = [self.pv(p, env, live) for p in ir[1]]
        out = parts[0]
        for p in parts[1:]:
            out = out & p
        return out

    def p_or(self, ir, env, live):
        parts = [self.pv(p, env, live) for p in ir[1]]
        out = parts[0]
        for p in parts[1:]:
            out = out | p
        return out

    def p_cmp(self, ir, env, live):
        _, op, a_ir, b_ir, anil, bnil, _dt = ir
        a = self.ev(a_ir, env, live)
        b = self.ev(b_ir, env, live)
        out = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
               "le": torch.le, "gt": torch.gt, "ge": torch.ge}[op](a, b)
        if anil:
            out = out & ~_nilm_arr(a)
        if bnil:
            out = out & ~_nilm_arr(b)
        return out

    def p_strpred(self, ir, env, live):
        _, lut_i, a_ir = ir
        lut = self.inputs[lut_i]
        codes = self.ev(a_ir, env, live)
        if lut.shape[0] == 0:
            # empty dictionary (all-nil / empty column): nothing matches
            return torch.zeros(codes.shape, dtype=torch.bool,
                               device=self.device)
        ok = codes >= 0
        return lut[torch.where(ok, codes, 0).long()] & ok

    def p_rangesel(self, ir, env, live):
        """BATselect scan kernel (gdk/gdk_select.c:964 scan_sel; mirrors
        ops/select.py _range_mask minus the liveness term)."""
        _, a_ir, mode, lo, hi, li, hi_incl, guard, _dt = ir
        x = self.ev(a_ir, env, live)
        # bounds cast to the column's type first, as numpy's dt.type() does
        t = _npdt(x.dtype).type
        tl = t(lo).item()
        th = t(hi).item()
        if mode == "eq":
            m = x == tl
        elif mode == "ne":
            m = x != tl
        elif mode == "lt":
            m = x < tl
        elif mode == "le":
            m = x <= tl
        elif mode == "gt":
            m = x > tl
        elif mode == "ge":
            m = x >= tl
        elif mode == "between":
            m = ((x >= tl) if li else (x > tl)) & \
                ((x <= th) if hi_incl else (x < th))
        elif mode == "anti_between":
            m = ((x < tl) if li else (x <= tl)) | \
                ((x > th) if hi_incl else (x >= th))
        else:
            raise Unsupported(mode)
        if guard:
            m = m & ~_nilm_arr(x)
        return m


# ---------------------------------------------------------------------------
# entry points + host orchestration
# ---------------------------------------------------------------------------


def _root_compact(itp, rel_ir, out_keys, out_cap):
    """Run the plan and compact the result to out_cap (shared by the
    single-device and SPMD entry points)."""
    env, count, mask, cap = itp.rel(rel_ir)
    if mask is None:
        nlive = count
        arrays = tuple(env[k][:out_cap] for k in out_keys)
    else:
        live = itp.live_of(cap, count, mask)
        oids, nlive, live_out = _compact_oids(live, out_cap)
        arrays = tuple(_gather_nil(env[k], oids, live_out) for k in out_keys)
    err, tots = itp.combined_scalars()
    return err, tots, nlive, arrays


def _run_single(ir, inputs):
    """Whole plan + result compaction (final capacity is small enough to
    fetch padded)."""
    rel_ir, out_keys, out_cap = ir
    return _root_compact(_Interp(inputs), rel_ir, out_keys, out_cap)


def _run_raw(ir, inputs):
    """Whole plan, results left at native capacity on device (the host
    reads the count, then compacts with a tight capacity)."""
    rel_ir, out_keys = ir
    itp = _Interp(inputs)
    env, count, mask, cap = itp.rel(rel_ir)
    if mask is None:
        live = None
        nlive = count
    else:
        live = itp.live_of(cap, count, mask)
        nlive = live.sum()
    arrays = tuple(env[k] for k in out_keys)
    return itp.err(), itp.exp_totals, nlive, live, arrays


def _compact_oids(live, out_cap: int):
    """Compaction map: oids[r] = index of the (r+1)-th live row, -1 past
    the live count (the virtualize role, gdk/gdk_select.c:30).  One
    rank-indexed scatter-set; ranks past out_cap are dropped."""
    cap = live.shape[0]
    csum = torch.cumsum(live.to(torch.int64), 0)
    nlive = csum[-1] if cap else \
        torch.zeros((), dtype=torch.int64, device=live.device)
    pos = torch.where(live, csum - 1, out_cap)
    oids = _set_drop(out_cap, -1, pos,
                     torch.arange(cap, dtype=torch.int64, device=live.device))
    live_out = torch.arange(out_cap, device=live.device) < nlive
    return oids, nlive, live_out


def _finish_mask(live, arrays, *, out_cap: int):
    oids, _nlive, live_out = _compact_oids(live, out_cap)
    return tuple(_gather_nil(a, oids, live_out) for a in arrays)


def _finish_slice(arrays, *, out_cap: int):
    return tuple(a[:out_cap] for a in arrays)


# ---------------------------------------------------------------------------
# SPMD execution over a row mesh - the reference's mitosis + mergetable
# pipeline (opt_mitosis.c:21 slices every eligible plan across workers;
# opt_mergetable.c:15-27 replicates operators per piece and two-phase-
# combines aggregates; mat.c:124 packs the pieces).  Here: the largest
# scanned tables are row-sharded over the mesh, the mask-carrying operator
# pipeline runs shard-local, dense group-bys combine slot partials with
# psum, and order/limit/distinct/build-side barriers all_gather.
# ---------------------------------------------------------------------------


def _ir_cap(ir, nsh: int, counts=None) -> int:
    """Static per-shard row-count bound of a (rewritten) plan IR subtree -
    mirrors the interpreter's cap propagation, tightened by actual scan
    row counts when known; drives the repartition lane-capacity guess and
    the broadcast-vs-shuffle cost pick (the role of the reference's
    joincost row estimates, gdk/gdk_join.c:3586)."""
    k = ir[0]
    if k in ("scan", "scan_sharded"):
        c = ir[3]
        if counts is not None and ir[2] in counts:
            c = min(c, max(counts[ir[2]], 1))
        # sharded scans hold a row-range slice; live rows are a prefix of
        # the capacity, so one shard holds at most min(cap/nsh, count)
        return c if k == "scan" else max(min(ir[3] // nsh, c), 1)
    if k in ("rename", "filter", "project", "orderby", "distinct"):
        return _ir_cap(ir[1], nsh, counts)
    if k == "compact":
        return ir[2]
    if k == "gather":
        return _ir_cap(ir[1], nsh, counts) * nsh
    if k == "repartition":
        return ir[3] * nsh
    if k == "limit":
        return ir[4]
    if k == "groupby_sort":
        return ir[5]
    if k in ("groupby_dense", "groupby_dense_spmd"):
        return ir[7]
    if k == "join":
        return _ir_cap(ir[2], nsh, counts)
    if k == "join_expand":
        return ir[9]
    raise Unsupported(f"spmd cap: {k}")


def _ir_rows(ir, counts=None) -> int:
    """Static GLOBAL row-count bound of a subtree (sums over shards -
    differs from _ir_cap at sharded/gathered nodes)."""
    k = ir[0]
    if k in ("scan", "scan_sharded"):
        c = ir[3]
        if counts is not None and ir[2] in counts:
            c = min(c, max(counts[ir[2]], 1))
        return c
    if k in ("rename", "filter", "project", "orderby", "distinct",
             "gather", "repartition"):
        return _ir_rows(ir[1], counts)
    if k == "compact":
        return min(_ir_rows(ir[1], counts), ir[2])
    if k == "limit":
        return ir[4]
    if k == "groupby_sort":
        return ir[5]
    if k in ("groupby_dense", "groupby_dense_spmd"):
        return ir[7]
    if k == "join":
        return _ir_rows(ir[2], counts)
    if k == "join_expand":
        return ir[9]
    raise Unsupported(f"spmd rows: {k}")


class _SpmdRewriter:
    """Single-device plan IR -> mesh IR (the reference's mitosis +
    mergetable pipeline as one pass; a copy of the reference's, so the
    mesh IR of a query is the reference's too).  ``rw`` returns (ir',
    dist) with dist in {"shard", "repl"}: whether the node's rows live
    sharded over the mesh or replicated on every shard.

    Distribution strategy per consumer of a sharded subtree:
    * orderby/limit: all_gather barrier (mat.pack before the
      order-sensitive consumer).
    * join build sides: cost pick - small builds broadcast (all_gather);
      large builds hash-repartition BOTH sides through the ragged
      all-to-all exchange so each shard joins only the keys it owns.
      This is the partitioned shuffle the reference lacks (its remote
      joins ship whole columns to one site, modules/mal/remote.c:971
      RMTput, design note remote.c:13-58).
    * group-by/distinct: dense small domains psum slot partials
      (two-phase, opt_mergetable.c:15-27); high-cardinality sorts and
      distinct aggregates repartition by key hash so groups are wholly
      shard-owned and every aggregate (incl. DISTINCT) runs local.
    """

    def __init__(self, sharded: frozenset, nsh: int,
                 lane_caps: Dict[int, int], counts=None):
        self.sharded = sharded
        self.nsh = nsh
        self.scan_rows = counts               # cnt input idx -> real rows
        self.lane_caps = lane_caps            # ordinal -> lane cap override
        self.lane_used: Dict[int, int] = {}   # ordinal -> lane cap used
        self.counts = {"shuffle_joins": 0, "shuffle_groupbys": 0,
                       "shuffle_distincts": 0}
        self._ord = 0
        self.bcast_rows = int(config.get("spmd_broadcast_rows"))
        self.min_rows = int(config.get("spmd_shuffle_min_rows"))

    def _repart(self, ir, keyspec):
        """Wrap ir in a hash-repartition exchange node.  The lane
        capacity starts at ~4x the uniform-hash mean and is corrected by
        the host retry loop from the measured max lane (the engine-wide
        count-then-allocate discipline)."""
        o = self._ord
        self._ord += 1
        cap = _ir_cap(ir, self.nsh, self.scan_rows)
        default = capacity_for(max(4 * cap // max(self.nsh, 1), 256))
        lane = self.lane_caps.get(o, default)
        self.lane_used[o] = lane
        return ("repartition", ir, keyspec, int(lane), o)

    def rw(self, ir):
        k = ir[0]
        if k == "scan":
            if ir[1][0][1] in self.sharded:
                return ("scan_sharded",) + ir[1:], "shard"
            return ir, "repl"
        if k == "rename":
            c, d = self.rw(ir[1])
            return ("rename", c, ir[2]), d
        if k in ("filter", "project"):
            c, d = self.rw(ir[1])
            return (k, c) + ir[2:], d
        if k == "compact":
            # shard-local compaction: each shard packs its own live rows
            c, d = self.rw(ir[1])
            return (k, c) + ir[2:], d
        if k in ("orderby", "limit"):
            # global-order barriers: gather the shards first
            c, d = self.rw(ir[1])
            if d == "shard":
                c = ("gather", c)
            return (k, c) + ir[2:], "repl"
        if k == "distinct":
            c, d = self.rw(ir[1])
            if d == "shard" and ir[2] and \
                    _ir_cap(c, self.nsh, self.scan_rows) >= self.min_rows:
                keys = tuple(e for e, _d, _n in ir[2])
                c = self._repart(c, ("keys", keys))
                self.counts["shuffle_distincts"] += 1
                return ("distinct", c) + ir[2:], "shard"
            if d == "shard":
                c = ("gather", c)
            return ("distinct", c) + ir[2:], "repl"
        if k == "groupby_sort":
            c, d = self.rw(ir[1])
            if d == "shard" and ir[3] and \
                    _ir_cap(c, self.nsh, self.scan_rows) >= self.min_rows:
                # repartition by group-key hash: every group is wholly
                # owned by one shard, so the sort-group and ALL its
                # aggregates (incl. avg/distinct) run shard-local with
                # no combine step
                c = self._repart(c, ("keys", ir[3]))
                self.counts["shuffle_groupbys"] += 1
                return ("groupby_sort", c) + ir[2:], "shard"
            if d == "shard":
                c = ("gather", c)
            return ("groupby_sort", c) + ir[2:], "repl"
        if k == "groupby_dense":
            c, d = self.rw(ir[1])
            if d == "shard":
                if ir[6] or any(spec[0].endswith("_distinct")
                                for _key, spec in ir[5]):
                    # FD-fetched keys need a shard-local representative
                    # row per whole group, and distinct aggregates need
                    # per-group global value sets: repartition by group
                    # key when big enough, else gather
                    if ir[3] and _ir_cap(c, self.nsh,
                                         self.scan_rows) >= self.min_rows:
                        keys = tuple(ci[1] for ci, _d, _dt in ir[3])
                        c = self._repart(c, ("keys", keys))
                        self.counts["shuffle_groupbys"] += 1
                        return ("groupby_dense", c) + ir[2:], "shard"
                    return ("groupby_dense", ("gather", c)) + ir[2:], \
                        "repl"
                return ("groupby_dense_spmd", c) + ir[2:], "repl"
            return ("groupby_dense", c) + ir[2:], "repl"
        if k in ("join", "join_expand"):
            l, dl = self.rw(ir[2])
            r, dr = self.rw(ir[3])
            if dr == "shard":
                bglobal = _ir_rows(r, self.scan_rows)
                if dl == "shard" and bglobal > self.bcast_rows:
                    # partitioned shuffle join: exchange both sides by
                    # join-key hash, then join shard-locally
                    keyspecs = ir[4]
                    l = self._repart(l, ("join", keyspecs, "l"))
                    r = self._repart(r, ("join", keyspecs, "r"))
                    self.counts["shuffle_joins"] += 1
                else:
                    # broadcast join: every shard gets the full build
                    r = ("gather", r)
            return ir[:2] + (l, r) + ir[4:], dl
        raise Unsupported(f"spmd rewrite: {k}")


def _run_shard(ir, inputs, coll):
    """One shard's whole plan + result compaction (the body the reference
    shard_maps); its outputs are replicated by construction."""
    rel_ir, out_keys, out_cap = ir
    itp = _Interp(inputs, coll=coll, nsh=coll.size)
    return _root_compact(itp, rel_ir, out_keys, out_cap)


#: mesh callables by (IR bundle, mesh, input sharding, repcheck); guarded
#: by _LOCK
_SPMD_CACHE: Dict[tuple, object] = {}


def _spmd_callable(ir_bundle, mesh, shard_flags: tuple,
                   repcheck: bool = False):
    """The plan as a function of the inputs over ``mesh``, cached by (IR,
    mesh, input sharding, repcheck).  It returns shard 0's outputs (every
    shard's are the same by construction), or with ``repcheck`` (config
    assert_props, the GDKdebug analog) every shard's, so the caller can
    assert replication at run time."""
    key = (ir_bundle, mesh, shard_flags, repcheck)
    with _LOCK:
        fn = _SPMD_CACHE.get(key)
    if fn is not None:
        return fn

    def fn(inputs):
        outs = run_shards(mesh, lambda ins, coll: _run_shard(
            ir_bundle, ins, coll), inputs, shard_flags)
        return outs if repcheck else outs[0]

    with _LOCK:
        _SPMD_CACHE[key] = fn
    return fn


def _fetch_scalars(err, count, tots: Dict[int, torch.Tensor]):
    """The error code, the live count and the count-retry totals in ONE
    device->host copy (the reference's jax.device_get of the same)."""
    vals = torch.stack([x.to(torch.int64).reshape(())
                        for x in (err, count, *tots.values())]).tolist()
    return vals[0], vals[1], dict(zip(tots, vals[2:]))


def _replicated_outputs(outs):
    """(error code, count, totals, arrays) of per-shard outputs that must
    be identical on every shard; raises AssertionError where a shard
    diverges."""
    fetched = []
    for err, tots, count, arrays in outs:
        code, n, tots_v = _fetch_scalars(err, count, tots)
        fetched.append((code, n, tots_v, [a.cpu().numpy() for a in arrays]))
    first = fetched[0]
    for d, (code, n, tots_v, arrs) in enumerate(fetched[1:], 1):
        what = None
        if code != first[0]:
            what = "error flag"
        elif n != first[1]:
            what = "row count"
        elif tots_v != first[2]:
            what = "count-retry totals"
        else:
            for i, (a, b) in enumerate(zip(arrs, first[3])):
                if not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
                    what = f"output[{i}]"
                    break
        if what is not None:
            raise AssertionError(f"SPMD replication violated: {what} "
                                 f"diverges on shard {d}")
    return first


def _raise_err(code: int):
    from ..ops.calc import CalcDivZero, CalcOverflow
    if code == 0:
        return
    if code == 1:
        raise CalcOverflow("22003!overflow in calculation")
    if code == 2:
        raise CalcDivZero("22012!division by zero")
    if code == 3:
        raise CalcOverflow("22003!value exceeds limits of type")
    if code == 4:
        raise CalcOverflow("22003!overflow in sum aggregate")
    raise CalcOverflow(f"22003!error {code}")


@dataclasses.dataclass
class FragmentResult:
    count: int
    arrays: List[np.ndarray]   # live prefix = rows [0, count)
    pts: List[PT]              # one per result column (≤ len(arrays))
    #: column index -> index (into arrays) of its high-limb companion
    #: for wide (int128-range) sums; exact value = hi*2^32 + lo
    wide: Dict[int, int] = dataclasses.field(default_factory=dict)


#: per-plan memo: naive plan IR -> {ordinal: capacity} for compaction
#: barriers, group buckets and non-unique joins whose measured totals
#: differ from the defaults.  Guarded by _LOCK.
_JOIN_MEMO: Dict[tuple, Dict[int, int]] = {}

#: disk-persisted copy of that memo, keyed by a digest of the naive plan IR
#: (scan capacities are part of the IR, so datasets never collide).  The
#: port's own file: MTPU_TORCH_EXPAND_MEMO, default $TMPDIR/<_MEMO_FILE>;
#: "0"/"off"/"" disables it.
_DISK_MEMO: Dict[str, dict] = {}

#: v2: an entry for a join with a non-unique build side now leads to the
#: expanding plan; a v1 file was written when that plan could not run
_MEMO_FILE = "mtpu_torch_expand_memo_v2.json"
_MEMO_LOCK = threading.Lock()


def _memo_path() -> Optional[str]:
    p = os.environ.get("MTPU_TORCH_EXPAND_MEMO",
                       os.path.join(tempfile.gettempdir(), _MEMO_FILE))
    return None if p in ("0", "off", "") else p


def _memo_digest(plan_key) -> str:
    import hashlib
    return hashlib.sha256(repr(plan_key).encode()).hexdigest()


def _memo_file(path: str) -> dict:
    import json
    if path not in _DISK_MEMO:
        try:
            with open(path) as f:
                _DISK_MEMO[path] = json.load(f)
        except (OSError, ValueError):
            _DISK_MEMO[path] = {}
    return _DISK_MEMO[path]


def _memo_disk_get(plan_key) -> Optional[Dict[int, Optional[int]]]:
    path = _memo_path()
    if path is None:
        return None
    with _MEMO_LOCK:
        d = _memo_file(path).get(_memo_digest(plan_key))
    if d is None:
        return None
    return {int(o): v for o, v in d.items()}


def _memo_disk_put(plan_key, expand: Dict[int, Optional[int]]) -> None:
    import json
    path = _memo_path()
    if path is None:
        return
    # sessions on several threads write here: one writer at a time
    with _MEMO_LOCK:
        memo = _memo_file(path)
        memo[_memo_digest(plan_key)] = {str(o): v for o, v in expand.items()}
        tmp = path + f".{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "w") as f:
                json.dump(memo, f)
            os.replace(tmp, path)
        except OSError:
            pass  # the memo is a cache: a read-only disk only costs retries


_LOCK = threading.Lock()

#: observability: runs and count-then-retry re-lowerings; tests use this to
#: prove the retry path executed.  ``runs`` counts the fragments of queries
#: (as in the reference); the fragments that plan-time scalar subqueries run
#: on (the reference runs those through its executor) count apart, under
#: ``subquery_runs``
STATS = {"runs": 0, "subquery_runs": 0, "uniq_retries": 0, "cap_retries": 0,
         "fallbacks": 0, "spmd_runs": 0,
         # SPMD plans that exchanged rows through the ragged all-to-all
         # (hash-partitioned joins / group-bys / distincts) instead of
         # broadcast-gathering - tests assert the shuffle path executed
         "shuffle_joins": 0, "shuffle_groupbys": 0, "shuffle_distincts": 0}


def stats_inc(key: str, n: int = 1) -> None:
    with _LOCK:
        STATS[key] += n


class CompiledFragment:
    """A lowered plan ready to execute (the engine's plan-cache value; the
    reference's query-cache entry, sql/server/sql_qc.c).  Holds the input
    tensors by reference - validity is pinned by the engine cache checking
    table identity."""

    def __init__(self, catalog, rel: L.Rel, out_names: List[str]):
        t0 = time.perf_counter()
        self.catalog = catalog
        self.rel = rel
        self.out_names = list(out_names)
        self._lower({})
        self.plan_key = self.rel_ir       # naive IR identifies the plan
        with _LOCK:
            memo = dict(_JOIN_MEMO.get(self.plan_key, ()))
        if not memo:
            memo = _memo_disk_get(self.plan_key) or {}
        if memo:
            self._lower(memo)
        self.lower_ms = (time.perf_counter() - t0) * 1e3

    def _lower(self, expand: Dict[int, int]) -> None:
        low = Lowering(self.catalog, expand=expand)
        low.collect_refs(self.rel)
        rel_ir, penv, cap = low.rel(self.rel)
        out_keys, pts = [], []
        for name in self.out_names:
            if ("#out", name) in penv:
                key = ("#out", name)
            else:
                hits = [k for k in penv if k[1] == name]
                if len(hits) != 1:
                    raise Unsupported(f"ambiguous output column {name}")
                key = hits[0]
            out_keys.append(key)
            pts.append(penv[key])
        # wide sums ship both limb arrays: hi companions ride after the
        # column arrays; decode recombines exactly (engine._decode_wide)
        wide: Dict[int, int] = {}
        for i, (key, pt) in enumerate(zip(list(out_keys), pts)):
            if pt.wide:
                wide[i] = len(out_keys)
                out_keys.append(_hikey(key))
        self.wide = wide
        self.expand = expand
        self.expand_used = dict(low.expand_used)
        self.group_caps = dict(low.group_caps)
        self.rel_ir = rel_ir
        self.inputs = tuple(low.inputs)
        self.input_tables = list(low.input_tables)
        self.scan_counts = dict(low.scan_counts)
        self.out_keys = tuple(out_keys)
        self.pts = pts
        self.cap = cap
        # the reference's event says "compile": "miss" when XLA compiled
        # the IR; here, when the IR is new since the last run
        self.fresh_ir = True

    def _memoize(self) -> None:
        with _LOCK:
            _JOIN_MEMO[self.plan_key] = dict(self.expand)
        _memo_disk_put(self.plan_key, dict(self.expand))

    def _pick_shard_inputs(self, nsh: int,
                           require_min: bool = False) -> Optional[frozenset]:
        """Input indices of the tables to row-shard: every scanned table
        large enough to split over the mesh (the reference shards every
        eligible bind, opt_mitosis.c:21; small tables stay replicated
        like its non-partitioned sides).  With an explicit mesh the
        largest table is always sharded so even small-table plans
        exercise the mesh; session auto-meshes set ``require_min`` so
        plans with no table >= spmd_min_shard_rows stay single-device
        (the reference's MIN_PART_SIZE gate, opt_mitosis.c:17)."""
        caps: Dict[str, int] = {}
        idxs: Dict[str, set] = {}
        for i, tname in enumerate(self.input_tables):
            if tname is None:
                continue
            caps[tname] = self.inputs[i].shape[0]
            idxs.setdefault(tname, set()).add(i)
        min_rows = int(config.get("spmd_min_shard_rows"))
        best = None
        chosen = set()
        for tname, cap in caps.items():
            if cap % nsh or cap < nsh:
                continue
            if best is None or cap > caps[best]:
                best = tname
            if cap >= min_rows:
                chosen.add(tname)
        if best is None or (require_min and not chosen):
            return None
        chosen.add(best)
        return frozenset(i for t in chosen for i in idxs[t])

    def _run_spmd(self, mesh, events: Optional[list], require_min: bool,
                  stat: str) -> FragmentResult:
        """Execute over a row mesh: SQL in, SPMD out.  The same retry
        discipline as the single-device path (non-unique build discovery,
        capacity overflow) applies, plus the repartition lane overflow.
        One host read of the scalars per attempt, after every shard ran."""
        if len(mesh.axis_names) != 1:
            raise Unsupported("spmd fragment needs a 1-D mesh")
        nsh = int(mesh.shape[mesh.axis_names[0]])
        if nsh <= 1:
            raise Unsupported("single-device mesh")
        picked = self._pick_shard_inputs(nsh, require_min)
        if picked is None:
            raise Unsupported("no shardable scan for the mesh")
        if require_min:
            # auto-mesh cost gate: SPMD pays off when the plan *reduces*
            # (group-by/top-n/selective join) - if the root result is on
            # the order of the sharded input, the final all_gather ships
            # ~everything to every shard and single-device wins (the
            # gather cost the reference never pays: its mat.pack is a
            # shared-memory concat, modules/mal/mat.c:124)
            big = max(self.inputs[i].shape[0] for i in picked)
            if self.cap * 2 > big:
                raise Unsupported("result ~ input size: gather dominates")
        from ..obs import set_algorithm
        set_algorithm("fragment:spmd")
        stats_inc(stat)
        stats_inc("spmd_runs")
        t0 = time.perf_counter()
        rpcs = 0
        lane_caps = getattr(self, "_lane_caps", None)
        if lane_caps is None:
            lane_caps = self._lane_caps = {}
        for _attempt in range(12):
            sharded = self._pick_shard_inputs(nsh, require_min)
            if sharded is None:
                raise Unsupported("no shardable scan for the mesh")
            rwr = _SpmdRewriter(sharded, nsh, lane_caps, self.scan_counts)
            sp_ir, d = rwr.rw(self.rel_ir)
            if d == "shard":
                sp_ir = ("gather", sp_ir)
            flags = tuple(i in sharded for i in range(len(self.inputs)))
            repcheck = bool(config.get("assert_props"))
            fn = _spmd_callable((sp_ir, self.out_keys, self.cap), mesh,
                                flags, repcheck=repcheck)
            out = fn(self.inputs)
            if repcheck:
                # runtime replication assert (GDKdebug/assert_props):
                # every shard must have produced identical outputs
                code, n, tots_v, arrs = _replicated_outputs(out)
            else:
                err, tots, count, arrays = out
                code, n, tots_v = _fetch_scalars(err, count, tots)
                arrs = [a.cpu().numpy() for a in arrays]
            rpcs += 1
            if code >= _ERR_DUP_BASE:
                expand = dict(self.expand)
                expand[code - _ERR_DUP_BASE] = None
                self._lower(expand)
                self.expand = {**expand, **self.expand_used}
                self._memoize()
                stats_inc("uniq_retries")
                continue
            # negative keys = repartition max-lane counts (shuffle
            # overflow); positive = compaction / group / expansion totals
            lane_over = {(-1 - o): t for o, t in tots_v.items()
                         if o < 0 and t > rwr.lane_used.get(-1 - o, 0)}
            if lane_over:
                for o, t in lane_over.items():
                    lane_caps[o] = capacity_for(max(t, 1))
                stats_inc("cap_retries")
                continue
            # a group-by without a retry channel (its capacity is at least
            # its one-device bound) reports its group count all the same
            # when the mesh hands it more row slots than that bound: a
            # gather of shard-local compactions, each of which was checked
            # on its own shard.  A count above its capacity lost rows that
            # no re-lowering can hold, so the plan runs on one device; a
            # count that fits a smaller bucket is retried at that bucket,
            # as the reference retries it (which may give it a channel);
            # any other count lost nothing.  (The reference compares such
            # a count with 0, so it retries until its attempts run out.)
            free = {o: t for o, t in tots_v.items()
                    if o >= 0 and o not in self.expand_used}
            if any(t > self.group_caps.get(o, 0) for o, t in free.items()):
                raise Unsupported("group count above its bound on the mesh")
            over = {o: t for o, t in tots_v.items()
                    if o in self.expand_used and t > self.expand_used[o]}
            over.update((o, t) for o, t in free.items()
                        if capacity_for(max(t, 1)) < self.group_caps.get(o, 0))
            if over:
                expand = dict(self.expand)
                for o, t in over.items():
                    expand[o] = capacity_for(max(t, 1))
                self._lower(expand)
                self._memoize()
                stats_inc("cap_retries")
                continue
            _raise_err(code)
            for key, v in rwr.counts.items():
                if v:
                    stats_inc(key, v)
            if events is not None:
                events.append({
                    "op": "fragment.run", "algorithm": "fragment:spmd",
                    "rows": n, "rpcs": rpcs, "devices": nsh,
                    "shuffles": dict(rwr.counts),
                    "usec": int((time.perf_counter() - t0) * 1e6)})
            return FragmentResult(n, arrs, self.pts, self.wide)
        raise Unsupported("expanding-join retry limit exceeded")

    def run(self, events: Optional[list] = None, stat: str = "runs",
            mesh=None, spmd_require_min: bool = False) -> FragmentResult:
        """Execute on the device of the inputs.  One host read of the
        error code, count and totals per attempt, plus one re-lowered
        retry per newly discovered compaction / group-bucket overflow
        (memoized across runs); results larger than _SINGLE_PHASE_CAP are
        compacted to a tight capacity after the count is known.  ``stat``
        is the STATS key the run counts under.  With a row mesh (more than
        one shard) the plan runs SPMD (see _run_spmd); a plan the mesh
        path rejects runs on one device.  ``spmd_require_min`` (session
        auto-mesh) keeps plans whose largest scan is below
        spmd_min_shard_rows on one device."""
        if mesh is not None:
            try:
                return self._run_spmd(mesh, events, spmd_require_min, stat)
            except Unsupported:
                pass    # e.g. tiny/unshardable plan: run single-device
        from ..obs import set_algorithm
        set_algorithm("fragment:jit")
        stats_inc(stat)
        t0 = time.perf_counter()
        rpcs = 0
        lowered = False
        for _attempt in range(8):
            lowered |= self.fresh_ir
            self.fresh_ir = False
            single = self.cap <= _SINGLE_PHASE_CAP
            if single:
                err, tots, count, arrays = _run_single(
                    (self.rel_ir, self.out_keys, self.cap), self.inputs)
            else:
                err, tots, count, live, arrays = _run_raw(
                    (self.rel_ir, self.out_keys), self.inputs)
            code, n, tots_v = _fetch_scalars(err, count, tots)
            rpcs += 1
            if code >= _ERR_DUP_BASE:
                # join <ordinal> build side is non-unique: re-lower it as
                # an expanding join and retry
                expand = dict(self.expand)
                expand[code - _ERR_DUP_BASE] = None
                self._lower(expand)
                self.expand = {**expand, **self.expand_used}
                self._memoize()
                stats_inc("uniq_retries")
                continue
            over = {o: t for o, t in tots_v.items()
                    if t > self.expand_used.get(o, 0)}
            if over:
                expand = dict(self.expand)
                for o, t in over.items():
                    expand[o] = capacity_for(max(t, 1))
                self._lower(expand)
                self._memoize()
                stats_inc("cap_retries")
                continue
            _raise_err(code)
            if not single:
                out_cap = min(self.cap, capacity_for(max(n, 1)))
                arrays = _finish_slice(arrays, out_cap=out_cap) \
                    if live is None else \
                    _finish_mask(live, arrays, out_cap=out_cap)
                rpcs += 1
            result = FragmentResult(n, [a.cpu().numpy() for a in arrays],
                                    self.pts, self.wide)
            # capacity SHRINK: buckets start at a conservative default;
            # once the true total is measured, re-lower to its bucket so
            # later runs pay for actual rows, not the guess
            shrink = {}
            for o, t in tots_v.items():
                used = self.expand_used.get(o, 0)
                tight = capacity_for(max(t, 1))
                if used > 2 * tight:
                    shrink[o] = tight
            if shrink:
                self._lower({**self.expand, **shrink})
                self.expand = {**self.expand, **shrink,
                               **self.expand_used}
                self._memoize()
            if events is not None:
                events.append({
                    "op": "fragment.run", "algorithm": "fragment:jit",
                    "device": str(self.inputs[0].device),
                    "rows": n, "rpcs": rpcs,
                    "compile": "miss" if lowered else "hit",
                    "expanding_joins": len(self.expand_used),
                    "usec": int((time.perf_counter() - t0) * 1e6)})
            return result
        raise Unsupported("expanding-join retry limit exceeded")


def compile_fragment(catalog, rel: L.Rel, out_names: List[str]):
    """Lower a plan (no query runs); raises Unsupported for plan shapes
    outside the compiler."""
    return CompiledFragment(catalog, rel, out_names)


def run_fragment(catalog, rel: L.Rel, out_names: List[str],
                 events: Optional[list] = None) -> FragmentResult:
    """One-shot lower + execute (see CompiledFragment; the engine caches
    the compiled object instead, engine._PLAN_CACHE)."""
    return CompiledFragment(catalog, rel, out_names).run(events=events)
