"""Expression AST — the analog of the reference's sql_exp nodes
(sql/server/rel_exp.c): column refs, constants, operators, aggregates,
subquery markers. Bound expressions carry their SQLType."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from ..dtypes import SQLType

__all__ = ["Expr", "ColRef", "Const", "BinOp", "Cmp", "BoolOp", "Not",
           "IsNull", "Between", "InList", "Like", "Case", "Cast", "Func",
           "AggRef", "WinRef", "Subquery", "Param", "Star"]


@dataclasses.dataclass
class Expr:
    typ: Optional[SQLType] = dataclasses.field(default=None, init=False)

    def children(self) -> List["Expr"]:
        return []


@dataclasses.dataclass
class ColRef(Expr):
    table: Optional[str]      # alias (may be None before binding)
    name: str

    def __repr__(self):
        return f"{self.table or ''}.{self.name}"


@dataclasses.dataclass
class Const(Expr):
    value: Any                # host scalar in *logical* domain (str, int,
    ctype: Optional[SQLType] = None  # Decimal, datetime.date, None=NULL)

    def __repr__(self):
        return f"lit({self.value!r})"


@dataclasses.dataclass
class BinOp(Expr):
    op: str                   # + - * / % ||
    left: Expr
    right: Expr

    def children(self):
        return [self.left, self.right]


@dataclasses.dataclass
class Cmp(Expr):
    op: str                   # = <> < <= > >=
    left: Expr
    right: Expr

    def children(self):
        return [self.left, self.right]


@dataclasses.dataclass
class BoolOp(Expr):
    op: str                   # and / or
    args: List[Expr]

    def children(self):
        return self.args


@dataclasses.dataclass
class Not(Expr):
    arg: Expr

    def children(self):
        return [self.arg]


@dataclasses.dataclass
class IsNull(Expr):
    arg: Expr
    negated: bool = False

    def children(self):
        return [self.arg]


@dataclasses.dataclass
class Between(Expr):
    arg: Expr
    lo: Expr
    hi: Expr
    negated: bool = False

    def children(self):
        return [self.arg, self.lo, self.hi]


@dataclasses.dataclass
class InList(Expr):
    arg: Expr
    items: List[Expr]
    negated: bool = False

    def children(self):
        return [self.arg] + self.items


@dataclasses.dataclass
class Like(Expr):
    arg: Expr
    pattern: str
    negated: bool = False
    escape: Optional[str] = None
    caseless: bool = False    # ILIKE (reference: modules/mal/pcre.c ilike)
    regex: bool = False       # regexp_like / [NOT] SIMILAR TO (pcre parity)

    def children(self):
        return [self.arg]


@dataclasses.dataclass
class Case(Expr):
    whens: List[Tuple[Expr, Expr]]
    default: Optional[Expr]

    def children(self):
        out = []
        for c, v in self.whens:
            out += [c, v]
        if self.default is not None:
            out.append(self.default)
        return out


@dataclasses.dataclass
class Cast(Expr):
    arg: Expr
    to: SQLType

    def children(self):
        return [self.arg]


@dataclasses.dataclass
class Func(Expr):
    name: str                 # extract_year, substring, ...
    args: List[Expr]
    extra: Any = None

    def children(self):
        return self.args


@dataclasses.dataclass
class AggRef(Expr):
    """Reference to an aggregate output column (post-binding)."""
    func: str                 # sum count avg min max count_star ...
    arg: Optional[Expr]
    distinct: bool = False
    # second argument for 2-ary aggregates: quantile(x, q), corr(x, y),
    # covar_samp/covar_pop(x, y), group_concat(x, sep)
    arg2: Optional[Expr] = None

    def children(self):
        out = [self.arg] if self.arg is not None else []
        if self.arg2 is not None:
            out.append(self.arg2)
        return out


@dataclasses.dataclass
class WinRef(Expr):
    """Window function application (reference: sql_rank.c codegen targets).

    frame: 'rows'  = ROWS UNBOUNDED PRECEDING..CURRENT ROW
           'range' = RANGE UNBOUNDED PRECEDING..CURRENT ROW (peers included,
                     the SQL default when ORDER BY is present)
           'full'  = whole partition (the default without ORDER BY)
           or a general bound tuple (unit, lo, hi) for explicit frames
           (gdk/gdk_analytic_bounds.c ROWS/RANGE/GROUPS): unit in
           {'rows','range','groups'}; lo/hi are offsets where negative =
           PRECEDING, 0 = CURRENT ROW, positive = FOLLOWING, None =
           UNBOUNDED on that side.
    """
    func: str                          # row_number rank ... sum avg min max count
    arg: Optional[Expr]
    partition: List[Expr]
    order: List[Tuple[Expr, bool]]     # (expr, descending)
    frame: Any = "full"
    extra: List[Any] = dataclasses.field(default_factory=list)  # ntile n, lag k

    def children(self):
        out = [self.arg] if self.arg is not None else []
        out += self.partition
        out += [e for e, _ in self.order]
        return out


@dataclasses.dataclass
class Subquery(Expr):
    """EXISTS / IN / scalar subquery marker (carries the parsed select)."""
    select: Any               # sql.ast.SelectStmt
    kind: str                 # exists / in / scalar / any / all
    outer: Optional[Expr] = None   # lhs for IN/ANY/ALL
    negated: bool = False
    cmp_op: Optional[str] = None   # for ANY/ALL

    def children(self):
        return [self.outer] if self.outer is not None else []


@dataclasses.dataclass
class Param(Expr):
    """Prepared-statement placeholder '?' (reference: sql_parser.y
    param markers, bound at EXECUTE time)."""
    index: int


@dataclasses.dataclass
class Star(Expr):
    table: Optional[str] = None


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)
