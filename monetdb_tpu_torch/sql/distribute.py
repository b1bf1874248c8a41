"""Distribution layer: merge (partitioned) tables, remote tables, replica
tables, partition pruning, and predicate shipping.

Reference mapping:
  * MergeDef / member partition specs   ⟷ CREATE MERGE TABLE ... PARTITION BY
                                           (sql/server/rel_schema.c, sql_partition.c)
  * prune + unionize                    ⟷ merge_table_prune_and_unionize
                                           (sql/server/rel_optimizer.c:130)
  * RemoteDef + RemoteScan shipping     ⟷ rel_rewrite_remote (rel_distribute.c:503)
                                           + remote.put/register/exec
                                           (monetdb5/modules/mal/remote.c)
  * ReplicaDef local-preference         ⟷ rel_rewrite_replica (rel_distribute.c:297)
  * to_sql predicate unparser           ⟷ opt_remoteQueries.c shipping plans as
                                           MAL text (here: SQL text, since our
                                           wire protocol speaks SQL)

Design note: a remote member's rows land on this host and are
re-dictionary-encoded into device columns; per-member filters are pushed to
the remote server so only surviving rows cross the network — the reference
ships whole columns (RMTput), which SURVEY.md §2.7 flags as its scalability
gap. Cross-shard aggregation above the union then runs on-device.
"""

from __future__ import annotations

import dataclasses
import datetime
from decimal import Decimal as PyDecimal
from typing import Any, Dict, List, Optional, Tuple

from ..dtypes import SQLType
from ..plan import logical as L
from ..plan.exprs import (Between, BinOp, BoolOp, Cmp, ColRef, Const, InList,
                          IsNull, Like, Not, walk)

__all__ = ["PartSpec", "MergeDef", "RemoteDef", "ReplicaDef",
           "expand_distribution", "to_sql", "prune_members",
           "route_partition"]


# ======================================================================
# catalog definitions
# ======================================================================
@dataclasses.dataclass
class PartSpec:
    """Member partition constraint. Range is inclusive on both ends
    (MonetDB's FROM x TO y semantics)."""
    lo: Any = None
    hi: Any = None
    values: Optional[List[Any]] = None
    nulls: bool = False

    def holds(self, v) -> bool:
        if v is None:
            return self.nulls
        if self.values is not None:
            return v in self.values
        if self.lo is not None and v < self.lo:
            return False
        if self.hi is not None and v > self.hi:
            return False
        return not (self.lo is None and self.hi is None and not self.nulls)


@dataclasses.dataclass
class MergeDef:
    name: str
    schema: List[Tuple[str, SQLType]]
    part_kind: Optional[str] = None      # 'range' | 'values' | None
    part_col: Optional[str] = None
    members: List[Tuple[str, Optional[PartSpec]]] = \
        dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RemoteDef:
    name: str
    schema: List[Tuple[str, SQLType]]
    addr: str                            # host:port (no credentials)
    rtable: str
    user: Optional[str] = None           # auth for the remote server
    password: Optional[str] = None


@dataclasses.dataclass
class ReplicaDef:
    name: str
    schema: List[Tuple[str, SQLType]]
    members: List[str] = dataclasses.field(default_factory=list)


# ======================================================================
# predicate → SQL text (for shipping to remote servers)
# ======================================================================
class NotShippable(Exception):
    pass


def _sql_value(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, PyDecimal):
        return str(v)
    if isinstance(v, datetime.datetime):
        return f"timestamp '{v.isoformat(sep=' ')}'"
    if isinstance(v, datetime.date):
        return f"date '{v.isoformat()}'"
    if isinstance(v, (int, float)):
        return repr(v)
    raise NotShippable(f"value {v!r}")


def to_sql(e) -> str:
    """Unparse a bound predicate back to SQL for remote execution. Raises
    NotShippable for anything the wire dialect can't express — the caller
    keeps such predicates local."""
    if isinstance(e, ColRef):
        return e.name
    if isinstance(e, Const):
        return _sql_value(e.value)
    if isinstance(e, Cmp):
        return f"({to_sql(e.left)} {e.op} {to_sql(e.right)})"
    if isinstance(e, BinOp):
        if e.op not in ("add", "sub", "mul", "div"):
            raise NotShippable(e.op)
        sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[e.op]
        return f"({to_sql(e.left)} {sym} {to_sql(e.right)})"
    if isinstance(e, BoolOp):
        sep = f" {e.op} "
        return "(" + sep.join(to_sql(a) for a in e.args) + ")"
    if isinstance(e, Not):
        return f"(not {to_sql(e.arg)})"
    if isinstance(e, IsNull):
        neg = " not" if e.negated else ""
        return f"({to_sql(e.arg)} is{neg} null)"
    if isinstance(e, Between):
        neg = "not " if e.negated else ""
        return (f"({to_sql(e.arg)} {neg}between {to_sql(e.lo)} "
                f"and {to_sql(e.hi)})")
    if isinstance(e, InList):
        neg = "not " if e.negated else ""
        items = ", ".join(to_sql(x) for x in e.items)
        return f"({to_sql(e.arg)} {neg}in ({items}))"
    if isinstance(e, Like):
        if e.escape is not None:
            raise NotShippable("like escape")
        neg = "not " if e.negated else ""
        return f"({to_sql(e.arg)} {neg}like {_sql_value(e.pattern)})"
    raise NotShippable(type(e).__name__)


def shippable(e) -> bool:
    try:
        to_sql(e)
        return True
    except NotShippable:
        return False


# ======================================================================
# partition pruning (merge_table_prune_and_unionize analog)
# ======================================================================
def _const_of(e):
    if isinstance(e, Const):
        return e.value
    return _MISS


_MISS = object()


def _spec_may_match(spec: PartSpec, op: str, c) -> bool:
    """Can any value admitted by `spec` satisfy `v <op> c`? Conservative:
    True unless provably disjoint. Comparisons never match NULL, so a
    nulls-only member is prunable by any comparison predicate."""
    if spec.values is not None:
        vals = spec.values
        if op == "=":
            return c in vals
        if op in ("<>", "!="):
            return any(v != c for v in vals)
        try:
            return any(_cmp(v, op, c) for v in vals)
        except TypeError:
            return True
    lo, hi = spec.lo, spec.hi
    if lo is None and hi is None:
        # nulls-only member: comparison predicates never match NULL;
        # a spec with no constraint at all always may match
        return not spec.nulls
    try:
        if op == "=":
            return (lo is None or c >= lo) and (hi is None or c <= hi)
        if op in ("<", "<="):
            return lo is None or _cmp(lo, op, c)
        if op in (">", ">="):
            return hi is None or _cmp(hi, op, c)
    except TypeError:
        return True
    return True


def _cmp(a, op, b) -> bool:
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    if op == "=":
        return a == b
    return a != b


_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "<>": "<>"}


def _pred_may_match(spec: PartSpec, pred, alias: str, part_col: str) -> bool:
    """Does this member possibly contain rows satisfying pred? Only prunes
    on predicates over the partition column; anything else keeps the
    member."""
    def is_pc(e):
        return isinstance(e, ColRef) and e.name == part_col and \
            (e.table is None or e.table == alias)

    if isinstance(pred, Cmp):
        if is_pc(pred.left):
            c = _const_of(pred.right)
            if c is not _MISS and c is not None:
                return _spec_may_match(spec, pred.op, c)
        if is_pc(pred.right):
            c = _const_of(pred.left)
            if c is not _MISS and c is not None:
                return _spec_may_match(spec, _FLIP.get(pred.op, pred.op), c)
        return True
    if isinstance(pred, Between) and not pred.negated and is_pc(pred.arg):
        lo, hi = _const_of(pred.lo), _const_of(pred.hi)
        ok = True
        if lo is not _MISS and lo is not None:
            ok = ok and _spec_may_match(spec, ">=", lo)
        if hi is not _MISS and hi is not None:
            ok = ok and _spec_may_match(spec, "<=", hi)
        return ok
    if isinstance(pred, InList) and not pred.negated and is_pc(pred.arg):
        cs = [_const_of(x) for x in pred.items]
        if any(c is _MISS for c in cs):
            return True
        return any(c is not None and _spec_may_match(spec, "=", c)
                   for c in cs)
    if isinstance(pred, IsNull) and not pred.negated and is_pc(pred.arg):
        if spec.values is not None or spec.lo is not None \
                or spec.hi is not None:
            return spec.nulls
        return True
    if isinstance(pred, BoolOp) and pred.op == "and":
        return all(_pred_may_match(spec, a, alias, part_col)
                   for a in pred.args)
    if isinstance(pred, BoolOp) and pred.op == "or":
        return any(_pred_may_match(spec, a, alias, part_col)
                   for a in pred.args)
    return True


def prune_members(mdef: MergeDef, preds: List, alias: str) -> List[str]:
    """Member names whose partition spec can intersect all predicates."""
    out = []
    for name, spec in mdef.members:
        if spec is None or mdef.part_col is None:
            out.append(name)
            continue
        if all(_pred_may_match(spec, p, alias, mdef.part_col)
               for p in preds):
            out.append(name)
    return out


def route_partition(mdef: MergeDef, value) -> str:
    """INSERT routing: pick the member whose spec holds `value`
    (the reference's rel_propagate.c partition routing)."""
    for name, spec in mdef.members:
        if spec is None or spec.holds(value):
            return name
    raise ValueError(
        f"no partition of {mdef.name} admits value {value!r}")


# ======================================================================
# plan rewrite: MergeScan/RemoteScan expansion
# ======================================================================
def expand_distribution(rel: L.Rel, catalog) -> L.Rel:
    """Post-bind rewrite: expand MergeScan into a pruned union of member
    scans with per-member filter replication, and fold shippable filters
    into RemoteScan nodes."""
    return _Expander(catalog).rw(rel)


class _Expander:
    def __init__(self, catalog):
        self.catalog = catalog

    # -- member name → source rel (recursively resolves remote/replica) --
    def member_rel(self, name: str, alias: str) -> L.Rel:
        cat = self.catalog
        rd = cat.remotes.get(name.lower())
        if rd is not None:
            return L.RemoteScan(name.lower(), alias, rd.addr, rd.rtable)
        rp = cat.replicas.get(name.lower())
        if rp is not None:
            return self.replica_rel(rp, alias)
        return L.Scan(name.lower(), alias)

    def replica_rel(self, rp: ReplicaDef, alias: str) -> L.Rel:
        # local member wins (rel_rewrite_replica's "prefer local" rule)
        for m in rp.members:
            if m.lower() in self.catalog.tables:
                return L.Scan(m.lower(), alias)
        for m in rp.members:
            rd = self.catalog.remotes.get(m.lower())
            if rd is not None:
                return L.RemoteScan(m.lower(), alias, rd.addr, rd.rtable)
        raise ValueError(f"replica table {rp.name} has no reachable member")

    # -- two-phase aggregate pushdown -------------------------------------
    # (mergetable two-phase grouped aggregation, opt_mergetable.c mat_grp/
    #  mat_cnt: per-partition partials + combine — here partials run ON the
    #  remote servers so only group rows cross the wire)
    _COMBINE = {"sum": "sum", "count": "sum", "count_star": "sum",
                "min": "min", "max": "max"}

    def _union_branches(self, rel):
        if isinstance(rel, L.SetOp) and rel.kind == "union_all":
            return self._union_branches(rel.left) + \
                self._union_branches(rel.right)
        return [rel]

    @staticmethod
    def _branch_remote(b):
        """(RemoteScan, preds) if branch is Filter*/RemoteScan, else None.
        """
        preds = []
        while isinstance(b, L.Filter):
            preds.extend(_split_and(b.pred))
            b = b.child
        if isinstance(b, L.RemoteScan):
            return b, preds + list(b.preds)
        return None

    def _agg_out_type(self, func: str, arg):
        from ..dtypes import I64, F64, Kind, decimal as dec_t
        if func in ("count", "count_star"):
            return I64
        t = getattr(arg, "typ", None)
        if t is None:
            return I64
        if func in ("min", "max"):
            return t
        if t.kind == Kind.DECIMAL:
            return dec_t(18, t.scale)
        if t.np_dtype.kind == "f":
            return F64
        return I64

    def push_aggregates(self, g: L.GroupBy) -> L.Rel:
        """GroupBy over (a union of) remote branches → per-branch partial
        GROUP BY (shipped as SQL for remote branches) + local combine."""
        branches = self._union_branches(g.child)
        if not any(self._branch_remote(b) for b in branches):
            return g
        if any(d for _n, _f, _a, d in g.aggs) or \
                not all(f in self._COMBINE for _n, f, _a, _d in g.aggs):
            return g
        # build the shared partial spec
        partial_aggs = []       # (pname, func, arg)
        combine_aggs = []       # (orig_name, combine_func, pname)
        for name, func, arg, _d in g.aggs:
            pname = f"_p_{name}"
            partial_aggs.append((pname, func, arg))
            combine_aggs.append((name, self._COMBINE[func], pname,
                                 self._agg_out_type(func, arg)))
        parts = []
        for b in branches:
            rb = self._branch_remote(b)
            if rb is None:
                parts.append(L.GroupBy(
                    b, list(g.keys),
                    [(pn, f, a, False) for pn, f, a in partial_aggs]))
                continue
            rs, preds = rb
            try:
                sel = [f"{to_sql(e)} as {n}" for n, e in g.keys]
                sel += [("count(*)" if f == "count_star" else
                         f"{f}({to_sql(a)})") + f" as {pn}"
                        for pn, f, a in partial_aggs]
                where = " and ".join(to_sql(p) for p in preds)
            except NotShippable:
                return g        # keep the whole aggregate local
            sql = f"select {', '.join(sel)} from {rs.rtable}"
            if where:
                sql += f" where {where}"
            if g.keys:
                sql += " group by " + ", ".join(n for n, _e in g.keys)
            rdef = self.catalog.remotes[rs.table]
            schema = [(n, e.typ) for n, e in g.keys]
            schema += [(pn, self._agg_out_type(f, a))
                       for pn, f, a in partial_aggs]
            parts.append(L.RemoteQuery(sql, rs.addr, schema, "#grp",
                                       rdef.user, rdef.password))
        out = parts[0]
        for p in parts[1:]:
            out = L.SetOp("union_all", out, p)
        keys = []
        for n, e in g.keys:
            r = ColRef("#grp", n)
            r.typ = e.typ
            keys.append((n, r))
        aggs = []
        for name, cfunc, pname, otyp in combine_aggs:
            r = ColRef("#grp", pname)
            r.typ = otyp
            aggs.append((name, cfunc, r, False))
        return L.GroupBy(out, keys, aggs)

    # -- generic recursion ------------------------------------------------
    def rw(self, rel: L.Rel) -> L.Rel:
        if isinstance(rel, L.GroupBy):
            rel.child = self.rw(rel.child)
            return self.push_aggregates(rel)
        if isinstance(rel, L.Filter):
            preds = []
            base = rel
            while isinstance(base, L.Filter):
                preds.extend(_split_and(base.pred))
                base = base.child
            if isinstance(base, L.MergeScan):
                return self.expand_merge(base, preds)
            if isinstance(base, L.RemoteScan):
                return self.fold_remote(base, preds)
            rel.child = self.rw(rel.child)
            self._rw_exprs(rel)
            return rel
        if isinstance(rel, L.MergeScan):
            return self.expand_merge(rel, [])
        if isinstance(rel, L.RemoteScan):
            return rel
        for f in dataclasses.fields(rel):
            v = getattr(rel, f.name)
            if isinstance(v, L.Rel):
                setattr(rel, f.name, self.rw(v))
        self._rw_exprs(rel)
        return rel

    def _rw_exprs(self, rel: L.Rel) -> None:
        """Expand plans hiding inside bound subquery expressions."""
        exprs = []
        if isinstance(rel, L.Filter):
            exprs = [rel.pred]
        elif isinstance(rel, L.Project):
            exprs = [e for _n, e in rel.exprs]
        elif isinstance(rel, L.Join):
            exprs = [a for ab in rel.on for a in ab]
            if rel.extra is not None:
                exprs.append(rel.extra)
        from ..plan.exprs import Subquery
        for e in exprs:
            for n in walk(e):
                if isinstance(n, Subquery) and isinstance(n.select, tuple):
                    n.select = (n.select[0], self.rw(n.select[1])) + \
                        tuple(n.select[2:])

    # -- merge expansion --------------------------------------------------
    def expand_merge(self, ms: L.MergeScan, preds: List) -> L.Rel:
        mdef = self.catalog.merges[ms.table.lower()]
        if not mdef.members:
            raise ValueError(
                f"merge table {mdef.name} has no members")
        keep = prune_members(mdef, preds, ms.alias)
        if not keep:
            # all pruned: keep one member, the filters above reject its rows
            keep = [mdef.members[0][0]]
        branches = []
        for m in keep:
            src = self.member_rel(m, ms.alias)
            if isinstance(src, L.RemoteScan):
                src = self.fold_remote(src, list(preds))
            else:
                for p in preds:
                    src = L.Filter(src, p)
            branches.append(src)
        out = branches[0]
        for b in branches[1:]:
            out = L.SetOp("union_all", out, b)
        return out

    # -- remote predicate shipping ----------------------------------------
    def fold_remote(self, rs: L.RemoteScan, preds: List) -> L.Rel:
        local = []
        for p in preds:
            if shippable(p):
                rs.preds.append(p)
            else:
                local.append(p)
        out: L.Rel = rs
        for p in local:
            out = L.Filter(out, p)
        return out


# ======================================================================
# JSON (de)serialization for manifest / WAL persistence
# ======================================================================
def _jval(v):
    if isinstance(v, datetime.datetime):
        return {"@ts": v.isoformat()}
    if isinstance(v, datetime.date):
        return {"@d": v.isoformat()}
    if isinstance(v, PyDecimal):
        return {"@n": str(v)}
    return v


def _unjval(v):
    if isinstance(v, dict):
        if "@ts" in v:
            return datetime.datetime.fromisoformat(v["@ts"])
        if "@d" in v:
            return datetime.date.fromisoformat(v["@d"])
        if "@n" in v:
            return PyDecimal(v["@n"])
    return v


def def_to_json(d) -> dict:
    from ..storage.columns import type_tag
    schema = [[n, type_tag(t)] for n, t in d.schema]
    if isinstance(d, MergeDef):
        return {"kind": "merge", "name": d.name, "schema": schema,
                "part_kind": d.part_kind, "part_col": d.part_col,
                "members": [[m, None if s is None else
                             {"lo": _jval(s.lo), "hi": _jval(s.hi),
                              "values": None if s.values is None else
                              [_jval(x) for x in s.values],
                              "nulls": s.nulls}]
                            for m, s in d.members]}
    if isinstance(d, RemoteDef):
        return {"kind": "remote", "name": d.name, "schema": schema,
                "addr": d.addr, "rtable": d.rtable,
                "user": d.user, "password": d.password}
    return {"kind": "replica", "name": d.name, "schema": schema,
            "members": list(d.members)}


def def_from_json(j: dict):
    from ..storage.columns import tag_type
    schema = [(n, tag_type(tag)) for n, tag in j["schema"]]
    if j["kind"] == "merge":
        members = []
        for m, s in j["members"]:
            spec = None if s is None else PartSpec(
                _unjval(s["lo"]), _unjval(s["hi"]),
                None if s["values"] is None else
                [_unjval(x) for x in s["values"]], s["nulls"])
            members.append((m, spec))
        return MergeDef(j["name"], schema, j["part_kind"], j["part_col"],
                        members)
    if j["kind"] == "remote":
        return RemoteDef(j["name"], schema, j["addr"], j["rtable"],
                         j.get("user"), j.get("password"))
    return ReplicaDef(j["name"], schema, list(j["members"]))


def _split_and(e):
    if isinstance(e, BoolOp) and e.op == "and":
        out = []
        for a in e.args:
            out.extend(_split_and(a))
        return out
    return [e]
