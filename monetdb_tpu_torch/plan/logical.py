"""Logical relational algebra — the analog of the reference's sql_rel tree
(sql/server/sql_relation.h: op_basetable, op_select, op_project, op_join,
op_groupby, op_topn, op_sample, set ops). The SQL binder produces this tree;
optimizer passes rewrite it; the executor walks it bottom-up."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .exprs import Expr

__all__ = ["Rel", "Scan", "Filter", "Project", "Join", "GroupBy", "OrderBy",
           "Limit", "Distinct", "SetOp", "SubPlan", "Sample", "Series",
           "MergeScan", "RemoteScan", "RemoteQuery", "Values"]


@dataclasses.dataclass
class Rel:
    def children(self) -> List["Rel"]:
        return []

    def show(self, indent=0) -> str:
        s = " " * indent + self._label()
        for c in self.children():
            s += "\n" + c.show(indent + 2)
        return s

    def _label(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class Scan(Rel):
    table: str
    alias: str
    # column pruning fills this during optimization (None = all)
    cols: Optional[List[str]] = None

    def _label(self):
        return f"Scan {self.table} as {self.alias}"


@dataclasses.dataclass
class MergeScan(Rel):
    """Scan of a partitioned merge table; expanded at plan time into a
    pruned union of member scans (the reference's
    merge_table_prune_and_unionize, sql/server/rel_optimizer.c:130)."""
    table: str
    alias: str

    def _label(self):
        return f"MergeScan {self.table} as {self.alias}"


@dataclasses.dataclass
class RemoteScan(Rel):
    """Scan of a table living on another server; executed by shipping a
    SQL subquery over the client protocol (the reference's remote tables:
    rel_distribute.c:503 + modules/mal/remote.c RMTexec)."""
    table: str                      # local (catalog) name
    alias: str
    addr: str                       # host:port
    rtable: str                     # table name on the remote server
    cols: Optional[List[str]] = None          # pruned select list
    preds: List[Expr] = dataclasses.field(default_factory=list)

    def _label(self):
        w = f" where {self.preds!r}" if self.preds else ""
        return f"RemoteScan {self.rtable}@{self.addr} as {self.alias}{w}"


@dataclasses.dataclass
class RemoteQuery(Rel):
    """Arbitrary SQL shipped to a remote server; the result lands as a
    frame with the given column names/types. Used by aggregate pushdown
    (partial GROUP BY at the data, combine locally — the reference's
    mergetable two-phase aggregation, opt_mergetable.c:15-27, pushed over
    the wire instead of per-thread)."""
    sql: str
    addr: str
    schema: List = dataclasses.field(default_factory=list)  # (name, type)
    key_table: str = "#grp"        # frame key namespace for the columns
    user: Optional[str] = None
    password: Optional[str] = None

    def _label(self):
        return f"RemoteQuery @{self.addr}: {self.sql}"


@dataclasses.dataclass
class Filter(Rel):
    child: Rel
    pred: Expr

    def children(self):
        return [self.child]

    def _label(self):
        return f"Filter {self.pred!r}"


@dataclasses.dataclass
class Project(Rel):
    child: Rel
    exprs: List[Tuple[str, Expr]]   # output name → expr

    def children(self):
        return [self.child]

    def _label(self):
        return f"Project {[n for n, _ in self.exprs]}"


@dataclasses.dataclass
class Join(Rel):
    left: Rel
    right: Rel
    kind: str                       # inner left right full semi anti cross
    # equi-key pairs (left expr, right expr); extra = residual predicate
    on: List[Tuple[Expr, Expr]] = dataclasses.field(default_factory=list)
    extra: Optional[Expr] = None

    def children(self):
        return [self.left, self.right]

    def _label(self):
        return f"Join[{self.kind}] on={self.on} extra={self.extra!r}"


@dataclasses.dataclass
class GroupBy(Rel):
    child: Rel
    keys: List[Tuple[str, Expr]]
    aggs: List[Tuple[str, str, Optional[Expr], bool]]  # name func arg distinct

    def children(self):
        return [self.child]

    def _label(self):
        return (f"GroupBy keys={[n for n, _ in self.keys]} "
                f"aggs={[(f, n) for n, f, _, _ in self.aggs]}")


@dataclasses.dataclass
class OrderBy(Rel):
    child: Rel
    keys: List[Tuple[Expr, bool, Optional[bool]]]  # expr, desc, nulls_last

    def children(self):
        return [self.child]


@dataclasses.dataclass
class Limit(Rel):
    child: Rel
    n: Optional[int]
    offset: int = 0

    def children(self):
        return [self.child]

    def _label(self):
        return f"Limit {self.n} offset {self.offset}"


@dataclasses.dataclass
class Distinct(Rel):
    child: Rel

    def children(self):
        return [self.child]


@dataclasses.dataclass
class SetOp(Rel):
    kind: str                       # union / union_all / except / intersect
    left: Rel
    right: Rel

    def children(self):
        return [self.left, self.right]

    def _label(self):
        return f"SetOp {self.kind}"


@dataclasses.dataclass
class SubPlan(Rel):
    """A bound subquery rendered as a relation (FROM-clause subquery)."""
    child: Rel
    alias: str

    def children(self):
        return [self.child]

    def _label(self):
        return f"SubPlan as {self.alias}"


@dataclasses.dataclass
class Sample(Rel):
    """Uniform sample without replacement (reference BATsample,
    gdk/gdk_sample.c; SQL `... SAMPLE n [SEED s]`)."""
    child: Rel
    n: int
    seed: Optional[int] = None

    def children(self):
        return [self.child]

    def _label(self):
        return f"Sample {self.n} seed={self.seed}"


@dataclasses.dataclass
class Values(Rel):
    """Literal relation from a VALUES table constructor (reference:
    rel_select.c rel_values → op_table with value exps)."""
    alias: str
    names: List[str]
    types: List        # SQLType per column
    cols: List         # python value lists, column-major

    def _label(self):
        return f"Values {self.names} x{len(self.cols[0]) if self.cols else 0}"


@dataclasses.dataclass
class Series(Rel):
    """Lazy integer series (reference generate_series,
    sql/backends/monet5/generator/generator.c — stop-exclusive)."""
    start: int
    stop: int
    step: int
    alias: str

    def _label(self):
        return f"Series [{self.start},{self.stop}) step {self.step}"
