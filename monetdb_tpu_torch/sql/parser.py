"""Recursive-descent SQL parser (replaces the reference's 7.5k-line yacc
grammar sql/server/sql_parser.y for the analytical subset). Produces
ast.SelectStmt / DDL nodes with plan.exprs expression trees."""

from __future__ import annotations

import datetime
from decimal import Decimal
from typing import List, Optional, Tuple

from ..dtypes import (BOOL, DATE, F64, I32, I64, TIMESTAMP, SQLType,
                      decimal as dec_t, varchar)
from ..plan.exprs import (Between, BinOp, BoolOp, Case, Cast, ColRef, Cmp,
                          Const, Expr, Func, InList, IsNull, Like, Not, Param,
                          Star, Subquery, AggRef)
from .ast import (CopyFrom, CreateTable, Delete, DropTable, InsertSelect,
                  InsertValues, JoinSource, SelectStmt, SubquerySource,
                  TableSource, TxnStmt, Update)
from .lexer import SQLSyntaxError, Token, tokenize

__all__ = ["parse", "parse_expr", "SQLSyntaxError"]

# any_value: non-deterministic pick; lowered as min (modules/kernel/
# aggr.c ANY_VALUE is similarly "some value from the group")
AGG_FUNCS = {"sum", "count", "avg", "min", "max", "prod", "any_value",
             "stddev_samp", "stddev_pop", "var_samp", "var_pop", "median",
             "quantile", "corr", "covar_samp", "covar_pop", "group_concat",
             "listagg"}

# aggregates taking a second argument (gdk_aggr.c BATgroupquantile q,
# BATgroupcorrelation y, ...)
AGG_FUNCS_2ARY = {"quantile", "corr", "covar_samp", "covar_pop",
                  "group_concat", "listagg"}

_CMP_OPS = {"=", "<>", "!=", "<", "<=", ">", ">="}


class Parser:
    def __init__(self, sql: str):
        self.sql_text = sql
        self.toks = tokenize(sql)
        self.i = 0
        self.n_params = 0   # '?' placeholders seen (prepared statements)

    # -- token helpers ------------------------------------------------------
    def peek(self, ahead=0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def eat_kw(self, *kws) -> bool:
        if self.at_kw(*kws):
            self.i += 1
            return True
        return False

    def expect_kw(self, kw):
        if not self.eat_kw(kw):
            raise SQLSyntaxError(f"expected {kw.upper()}, got {self.peek()}")

    def at_punct(self, p) -> bool:
        t = self.peek()
        return t.kind == "punct" and t.value == p

    def eat_punct(self, p) -> bool:
        if self.at_punct(p):
            self.i += 1
            return True
        return False

    def expect_punct(self, p):
        if not self.eat_punct(p):
            raise SQLSyntaxError(f"expected {p!r}, got {self.peek()}")

    def at_op(self, *ops) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    # -- statements ---------------------------------------------------------
    def _qname(self) -> str:
        """Possibly schema-qualified object name (sql_parser.y qname):
        kept dotted; resolution strips the schema downstream."""
        name = self.next().value
        while self.eat_punct("."):
            name += "." + self.next().value
        return name

    def parse_stmt(self):
        if self.at_kw("select") or self.at_punct("(") or self.at_kw("with"):
            return self.parse_select()
        if self.peek().kind == "ident" and self.peek().value == "truncate":
            # TRUNCATE [TABLE] t (sql_parser.y truncate_statement)
            self.next()
            self.eat_kw("table")
            from .ast import Truncate
            name = self._qname()
            # [CONTINUE|RESTART IDENTITY] [CASCADE|RESTRICT]
            if self._eat_ident("continue") or self._eat_ident("restart"):
                self._eat_ident("identity")
            self._eat_ident("cascade")
            self._eat_ident("restrict")
            return Truncate(name)
        if self.at_kw("set") and self.peek(1).kind == "ident":
            self.next()
            from .ast import SetVar
            name = self.next().value
            if name == "role" and not self.at_op("="):
                # SET ROLE r (sql_parser.y set_statement role)
                return SetVar("#role", Const(self.next().value))
            if name == "schema" and not self.at_op("="):
                # SET SCHEMA s (sql_parser.y set_statement schema)
                return SetVar("#schema", Const(self.next().value))
            if not self.at_op("="):
                raise SQLSyntaxError("expected = in SET")
            self.next()
            return SetVar(name, self.parse_expr())
        if self.peek().kind == "ident" and \
                self.peek().value in ("grant", "revoke"):
            return self.parse_grant_revoke()
        if self.peek().kind == "ident" and self.peek().value == "declare":
            self.next()
            from .ast import DeclareVar
            name = self.next().value
            return DeclareVar(name, self.parse_type())
        if self.peek().kind == "ident" and self.peek().value == "comment":
            self.next()
            self.expect_kw("on")
            from .ast import CommentOn
            kind = self.next().value          # table | column | view ...
            target = self.next().value
            while self.eat_punct("."):
                target += "." + self.next().value
            if not (self.peek().kind == "kw" and self.peek().value == "is"):
                raise SQLSyntaxError("expected IS")
            self.next()
            if self.eat_kw("null"):
                return CommentOn(kind, target, None)
            t = self.next()
            return CommentOn(kind, target, t.value)
        if self.peek().kind == "ident" and self.peek().value == "analyze":
            self.next()
            from .ast import Analyze
            tbl = None
            if self.peek().kind in ("ident", "kw") and \
                    self.peek().kind != "eof" and self.peek().value:
                self.next()                    # schema name (ignored)
                if self.peek().kind == "ident":
                    tbl = self.next().value
            return Analyze(tbl)
        if self.at_kw("create"):
            return self.parse_create()
        if self.at_kw("alter"):
            return self.parse_alter()
        if self.at_kw("drop"):
            self.next()
            if self.eat_kw("view"):
                from .ast import DropView
                return DropView(self._qname())
            if self.peek().kind == "ident" and \
                    self.peek().value == "schema":
                self.next()
                from .ast import DropSchema
                if_exists = False
                if self.eat_kw("if") or self._eat_ident("if"):
                    self.eat_kw("exists") or self._eat_ident("exists")
                    if_exists = True
                name = self.next().value
                cascade = bool(self._eat_ident("cascade"))
                self._eat_ident("restrict")
                return DropSchema(name, if_exists, cascade)
            if self.peek().kind == "ident" and \
                    self.peek().value == "index":
                self.next()
                from .ast import DropIndex
                return DropIndex(self._qname())
            if self.peek().kind == "ident" and \
                    self.peek().value == "function":
                self.next()
                from .ast import DropFunction
                return DropFunction(self._qname())
            if self.peek().kind == "ident" and \
                    self.peek().value == "sequence":
                self.next()
                from .ast import DropSequence
                return DropSequence(self._qname())
            if self.peek().kind == "ident" and \
                    self.peek().value == "trigger":
                self.next()
                from .ast import DropTrigger
                return DropTrigger(self._qname())
            if self.peek().kind == "ident" and self.peek().value == "user":
                self.next()
                from .ast import DropUser
                return DropUser(self.next().value)
            if self.peek().kind == "ident" and self.peek().value == "role":
                self.next()
                from .ast import DropRole
                return DropRole(self.next().value)
            if self.peek().kind == "ident" and \
                    self.peek().value == "procedure":
                self.next()
                from .ast import DropProcedure
                return DropProcedure(self._qname())
            self.expect_kw("table")
            if_exists = False
            if self.eat_kw("if") or self._eat_ident("if"):
                # DROP TABLE IF EXISTS t
                if not (self.eat_kw("exists")
                        or self._eat_ident("exists")):
                    raise SQLSyntaxError("expected EXISTS")
                if_exists = True
            name = self._qname()
            self._eat_ident("cascade")
            self._eat_ident("restrict")
            return DropTable(name, if_exists)
        if self.peek().kind == "ident" and self.peek().value == "call":
            self.next()
            name = self.next().value
            while self.eat_punct("."):
                name += "." + self.next().value
            args = []
            self.expect_punct("(")
            if not self.eat_punct(")"):
                args.append(self.parse_expr())
                while self.eat_punct(","):
                    args.append(self.parse_expr())
                self.expect_punct(")")
            from .ast import Call
            return Call(name, args)
        if self.at_kw("merge"):
            return self.parse_merge()
        if self.at_kw("insert"):
            return self.parse_insert()
        if self.at_kw("copy"):
            return self.parse_copy()
        if self.at_kw("delete"):
            self.next()
            self.expect_kw("from")
            name = self._qname()
            where = self.parse_expr() if self.eat_kw("where") else None
            return Delete(name, where)
        if self.at_kw("update"):
            self.next()
            name = self._qname()
            self.expect_kw("set")
            sets = []
            while True:
                c = self.next().value
                if not self.at_op("="):
                    raise SQLSyntaxError("expected = in UPDATE SET")
                self.next()
                sets.append((c, self.parse_expr()))
                if not self.eat_punct(","):
                    break
            where = self.parse_expr() if self.eat_kw("where") else None
            return Update(name, sets, where)
        if self.at_kw("start") or self.at_kw("begin"):
            self.next()
            self.eat_kw("transaction")
            return TxnStmt("begin")
        if self.at_kw("commit"):
            self.next()
            return TxnStmt("commit")
        if self.at_kw("rollback"):
            self.next()
            if self.eat_kw("to") or self._eat_ident("to"):
                self._eat_ident("savepoint")
                t = TxnStmt("rollback_to")
                t.savepoint = self.next().value
                return t
            return TxnStmt("rollback")
        if self._at_ident("savepoint"):
            self.next()
            t = TxnStmt("savepoint")
            t.savepoint = self.next().value
            return t
        if self._at_ident("release"):
            self.next()
            self._eat_ident("savepoint")
            t = TxnStmt("release")
            t.savepoint = self.next().value
            return t
        raise SQLSyntaxError(f"unsupported statement at {self.peek()}")

    def _opt_alias_stop(self, stop_words=()):
        """Alias unless the next ident is a context keyword (USING/ON are
        plain idents in this dialect)."""
        if self.eat_kw("as"):
            v = self.next().value
            if v == "":
                raise SQLSyntaxError("42000!empty alias")
            return v
        if self.peek().kind == "ident" and \
                self.peek().value not in stop_words:
            return self.next().value
        return None

    def parse_merge(self):
        """MERGE INTO t [a] USING s [b] ON cond WHEN MATCHED THEN
        {UPDATE SET ...|DELETE} / WHEN NOT MATCHED THEN INSERT [(cols)]
        VALUES (...) — sql_parser.y merge_stmt."""
        from .ast import MergeStmt
        self.next()
        self.expect_kw("into")
        target = self.next().value
        talias = self._opt_alias_stop(stop_words=("using",)) or target
        if not (self.peek().value == "using"
                and self.peek().kind in ("ident", "kw")):
            raise SQLSyntaxError("expected USING in MERGE")
        self.next()
        if self.eat_punct("("):
            source = self.parse_select()
            self.expect_punct(")")
            salias = self._opt_alias_stop(stop_words=("on",))
            if salias is None:
                raise SQLSyntaxError("MERGE subquery source needs an alias")
        else:
            source = self.next().value
            salias = self._opt_alias_stop(stop_words=("on",)) or source
        self.expect_kw("on")
        on = self.parse_expr()
        stmt = MergeStmt(target, talias, source, salias, on)
        while self.at_kw("when"):
            self.next()
            negated = bool(self.eat_kw("not"))
            if not (self.peek().kind == "ident"
                    and self.peek().value == "matched"):
                raise SQLSyntaxError("expected MATCHED in MERGE WHEN")
            self.next()
            self.expect_kw("then")
            if negated:
                self.expect_kw("insert")
                cols = None
                if self.eat_punct("("):
                    cols = [self.next().value]
                    while self.eat_punct(","):
                        cols.append(self.next().value)
                    self.expect_punct(")")
                self.expect_kw("values")
                self.expect_punct("(")
                exprs = [self.parse_expr()]
                while self.eat_punct(","):
                    exprs.append(self.parse_expr())
                self.expect_punct(")")
                stmt.not_matched = (cols, exprs)
            elif self.eat_kw("delete"):
                stmt.matched = ("delete",)
            else:
                self.expect_kw("update")
                self.expect_kw("set")
                sets = []
                while True:
                    c = self.next().value
                    if not self.at_op("="):
                        raise SQLSyntaxError("expected = in MERGE SET")
                    self.next()
                    sets.append((c, self.parse_expr()))
                    if not self.eat_punct(","):
                        break
                stmt.matched = ("update", sets)
        if stmt.matched is None and stmt.not_matched is None:
            raise SQLSyntaxError("MERGE needs at least one WHEN clause")
        return stmt

    def parse_grant_revoke(self):
        """GRANT privs ON [TABLE] t TO grantee | GRANT role TO user;
        REVOKE ... FROM ... (sql_parser.y grant/revoke; sql_privileges.c)."""
        from .ast import Grant, Revoke
        kind = self.next().value              # grant | revoke
        first = self.next().value
        privs = [first]
        while self.eat_punct(","):
            privs.append(self.next().value)
        if self.at_kw("on"):
            self.next()
            self.eat_kw("table")
            table = self._qname()
            if table.startswith("sys.") or table.startswith("tmp."):
                table = table.split(".", 1)[1]
            kw = "to" if kind == "grant" else "from"
            self.expect_kw(kw)
            grantee = self.next().value
            # [WITH GRANT OPTION] [FROM grantor]
            if self.eat_kw("with"):
                self.eat_kw("grant") or self._eat_ident("grant")
                self._eat_ident("option")
            if kind == "grant":
                return Grant(privs, table, grantee)
            return Revoke(privs, table, grantee)
        # role grant: GRANT r TO u / REVOKE r FROM u
        kw = "to" if kind == "grant" else "from"
        self.expect_kw(kw)
        user = self.next().value
        if kind == "grant":
            return Grant(None, first, user, role=True)
        return Revoke(None, first, user, role=True)

    def parse_select(self) -> SelectStmt:
        ctes = []
        if self.eat_kw("with"):
            if self.eat_kw("recursive"):
                # parity: the reference rejects RECURSIVE too
                # (sql_parser.y:3478 "RECURSIVE ... currently not supported")
                raise SQLSyntaxError("WITH RECURSIVE is not supported")
            while True:
                name = self.next().value
                cols = None
                if self.eat_punct("("):
                    cols = [self.next().value]
                    while self.eat_punct(","):
                        cols.append(self.next().value)
                    self.expect_punct(")")
                self.expect_kw("as")
                self.expect_punct("(")
                sel = self.parse_select()
                self.expect_punct(")")
                ctes.append((name, cols, sel))
                if not self.eat_punct(","):
                    break
        stmt = self.parse_select_core()
        stmt.ctes = ctes
        while self.at_kw("union", "except", "intersect"):
            op = self.next().value
            if self.eat_kw("all"):
                # UNION/EXCEPT/INTERSECT ALL: multiset semantics
                op = op + "_all"
            else:
                self.eat_kw("distinct")     # explicit DISTINCT = default
            corr = None
            if self._eat_ident("corresponding"):
                # CORRESPONDING [BY (cols)]: operate on the shared
                # column names (sql_parser.y set ops corresponding)
                corr = True
                if self.eat_kw("by"):
                    self.expect_punct("(")
                    corr = [self.next().value.lower()]
                    while self.eat_punct(","):
                        corr.append(self.next().value.lower())
                    self.expect_punct(")")
            # the rhs operand must not swallow a trailing ORDER BY/LIMIT —
            # those apply to the whole set expression (sql_parser.y gives
            # order/limit to the top-level select_statement only)
            rhs = self.parse_select_core(allow_order=False)
            rhs.corresponding = corr
            stmt.setops.append((op, rhs))
        # trailing ORDER BY / LIMIT apply to the whole set expression
        self._parse_order_limit(stmt)
        return stmt

    def parse_select_core(self, allow_order: bool = True) -> SelectStmt:
        if self.eat_punct("("):
            s = self.parse_select()
            self.expect_punct(")")
            return s
        self.expect_kw("select")
        distinct = bool(self.eat_kw("distinct"))
        self.eat_kw("all")
        items: List[Tuple[Optional[str], Expr]] = []
        while True:
            e = self.parse_expr()
            alias = None
            if self.eat_kw("as"):
                alias = self.next().value
                if alias == "":
                    raise SQLSyntaxError("42000!empty alias")
            elif self.peek().kind == "ident":
                alias = self.next().value
            items.append((alias, e))
            if not self.eat_punct(","):
                break
        stmt = SelectStmt(items=items, sources=[], distinct=distinct)
        if self.eat_kw("from"):
            stmt.sources = self.parse_from()
        if self.eat_kw("where"):
            stmt.where = self.parse_expr()
        if self.at_kw("group"):
            self.next()
            self.expect_kw("by")
            if self.peek().kind == "ident" and \
                    self.peek().value in ("rollup", "cube"):
                # GROUP BY ROLLUP(a,b) / CUBE(a,b) (sql_parser.y
                # group_by_element; lowered to grouping sets)
                kind = self.next().value
                self.expect_punct("(")
                cols = [self.parse_expr()]
                while self.eat_punct(","):
                    cols.append(self.parse_expr())
                self.expect_punct(")")
                stmt.group_by = list(cols)
                if kind == "rollup":
                    stmt.grouping_sets = [cols[:i]
                                          for i in range(len(cols), -1, -1)]
                else:
                    import itertools
                    stmt.grouping_sets = [
                        [c for c, keep in zip(cols, bits) if keep]
                        for bits in itertools.product(
                            (True, False), repeat=len(cols))]
            elif self.peek().kind == "ident" and \
                    self.peek().value == "grouping":
                self.next()
                if not (self.peek().kind == "ident"
                        and self.peek().value == "sets"):
                    raise SQLSyntaxError("expected SETS after GROUPING")
                self.next()
                self.expect_punct("(")
                sets = []
                while True:
                    self.expect_punct("(")
                    one = []
                    if not self.eat_punct(")"):
                        one.append(self.parse_expr())
                        while self.eat_punct(","):
                            one.append(self.parse_expr())
                        self.expect_punct(")")
                    sets.append(one)
                    if not self.eat_punct(","):
                        break
                self.expect_punct(")")
                stmt.grouping_sets = sets
                seen = []
                for st in sets:
                    for e in st:
                        if repr(e) not in [repr(x) for x in seen]:
                            seen.append(e)
                stmt.group_by = seen
            else:
                while True:
                    stmt.group_by.append(self.parse_expr())
                    if not self.eat_punct(","):
                        break
        if self.eat_kw("having"):
            stmt.having = self.parse_expr()
        if allow_order:
            self._parse_order_limit(stmt)
        return stmt

    def _parse_order_limit(self, stmt: SelectStmt):
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            stmt.order_by = []
            while True:
                e = self.parse_expr()
                desc = False
                if self.eat_kw("desc"):
                    desc = True
                else:
                    self.eat_kw("asc")
                nulls_last = None
                if self.eat_kw("nulls"):
                    nulls_last = bool(self.eat_kw("last"))
                    if nulls_last is False:
                        self.eat_kw("first")
                stmt.order_by.append((e, desc, nulls_last))
                if not self.eat_punct(","):
                    break
        if self.eat_kw("limit"):
            stmt.limit = int(self.next().value)
        if self.eat_kw("offset"):
            stmt.offset = int(self.next().value)
        if self.eat_kw("sample"):
            stmt.sample = int(self.next().value)
            if self.eat_kw("seed"):
                stmt.sample_seed = int(self.next().value)

    # -- FROM clause --------------------------------------------------------
    def parse_from(self):
        sources = [self.parse_table_ref()]
        while self.eat_punct(","):
            sources.append(self.parse_table_ref())
        return sources

    def parse_table_ref(self):
        left = self.parse_table_primary()
        while self._at_join_start():
            left = self._join_step(left)
        return left

    def _at_join_start(self) -> bool:
        return self.at_kw("natural", "cross", "join", "inner", "left",
                          "right", "full")

    def _join_step(self, left):
        """One join production (sql_parser.y joined_table).  The right
        operand may itself be an unparenthesized joined table whose ON
        binds innermost-first: A LEFT JOIN B INNER JOIN C ON e1 ON e2
        == A LEFT JOIN (B INNER JOIN C ON e1) ON e2."""
        natural = bool(self.eat_kw("natural"))
        if self.eat_kw("cross"):
            self.expect_kw("join")
            kind = "cross"
        elif self.at_kw("join"):
            self.next()
            kind = "inner"
        elif self.at_kw("inner"):
            self.next()
            self.expect_kw("join")
            kind = "inner"
        elif self.at_kw("left", "right", "full"):
            kind = self.next().value
            self.eat_kw("outer")
            self.expect_kw("join")
        else:
            raise SQLSyntaxError("expected JOIN after NATURAL")
        right = self.parse_table_primary()
        on = None
        using = None
        if kind != "cross" and not natural:
            if self.eat_kw("using"):
                # JOIN ... USING (c1, c2) (sql_parser.y joined_table)
                self.expect_punct("(")
                using = [self.next().value.lower()]
                while self.eat_punct(","):
                    using.append(self.next().value.lower())
                self.expect_punct(")")
            else:
                # right-nested joins consume their ONs before ours
                while self._at_join_start():
                    right = self._join_step(right)
                self.expect_kw("on")
                on = self.parse_expr()
        j = JoinSource(left, right, kind, on)
        j.natural = natural
        j.using = using
        return j

    def _paren_wraps_select(self) -> bool:
        """After eating '(', detect '((...(SELECT|WITH' — a derived table
        whose body is a parenthesized set expression."""
        j = self.i
        while j < len(self.toks) and self.toks[j].kind == "punct" \
                and self.toks[j].value == "(":
            j += 1
        t = self.toks[min(j, len(self.toks) - 1)]
        return t.kind == "kw" and t.value in ("select", "with")

    def parse_table_primary(self):
        if self.eat_punct("("):
            if self.at_kw("select") or self.at_kw("with") or \
                    (self.at_punct("(") and self._paren_wraps_select()):
                s = self.parse_select()
                self.expect_punct(")")
                alias = self._opt_alias() or f"_sq{self.i}"
                col_aliases = None
                if self.eat_punct("("):        # derived column list
                    col_aliases = [self.next().value]
                    while self.eat_punct(","):
                        col_aliases.append(self.next().value)
                    self.expect_punct(")")
                return SubquerySource(s, alias, col_aliases)
            if self.at_kw("values"):
                self.next()
                rows = []
                while True:
                    self.expect_punct("(")
                    row = [self.parse_expr()]
                    while self.eat_punct(","):
                        row.append(self.parse_expr())
                    self.expect_punct(")")
                    rows.append(row)
                    if not self.eat_punct(","):
                        break
                self.expect_punct(")")
                alias = self._opt_alias() or f"_vals{self.i}"
                col_aliases = None
                if self.eat_punct("("):
                    col_aliases = [self.next().value]
                    while self.eat_punct(","):
                        col_aliases.append(self.next().value)
                    self.expect_punct(")")
                from .ast import ValuesSource
                return ValuesSource(rows, alias, col_aliases)
            inner = self.parse_table_ref()
            self.expect_punct(")")
            return inner
        name = self.next().value
        if self.eat_punct("."):        # qualified name (sys.tables ...)
            name = name + "." + self.next().value
        if name in ("sys.generate_series",):
            name = name.split(".", 1)[1]
        if self.at_punct("("):
            # table function in FROM position: generate_series or a
            # user-defined RETURNS TABLE function (rel_psm.c)
            self.expect_punct("(")
            args = []
            if not self.eat_punct(")"):
                args.append(self.parse_expr())
                while self.eat_punct(","):
                    args.append(self.parse_expr())
                self.expect_punct(")")
            alias = self._opt_alias() or name
            from .ast import TableFuncSource
            return TableFuncSource(name, args, alias)
        alias = self._opt_alias() or name
        return TableSource(name, alias)

    def _opt_alias(self) -> Optional[str]:
        if self.eat_kw("as"):
            v = self.next().value
            if v == "":
                raise SQLSyntaxError("42000!empty alias")
            return v
        if self.peek().kind == "ident":
            return self.next().value
        return None

    # -- expressions --------------------------------------------------------
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        args = [self.parse_and()]
        while self.eat_kw("or"):
            args.append(self.parse_and())
        return args[0] if len(args) == 1 else BoolOp("or", args)

    def parse_and(self) -> Expr:
        args = [self.parse_not()]
        while self.eat_kw("and"):
            args.append(self.parse_not())
        return args[0] if len(args) == 1 else BoolOp("and", args)

    def parse_not(self) -> Expr:
        if self.eat_kw("not"):
            return Not(self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> Expr:
        e = self.parse_additive()
        negated = False
        if self.at_kw("not"):
            # x NOT BETWEEN / NOT IN / NOT LIKE
            self.next()
            negated = True
        if self.eat_kw("between"):
            lo = self.parse_additive()
            self.expect_kw("and")
            hi = self.parse_additive()
            return Between(e, lo, hi, negated=negated)
        if self.eat_kw("in"):
            self.expect_punct("(")
            if self.at_kw("select"):
                s = self.parse_select()
                self.expect_punct(")")
                return Subquery(s, "in", outer=e, negated=negated)
            items = [self.parse_expr()]
            while self.eat_punct(","):
                items.append(self.parse_expr())
            self.expect_punct(")")
            return InList(e, items, negated=negated)
        if self.at_kw("like") or self.at_kw("ilike"):
            caseless = self.next().value == "ilike"
            if self.peek().kind != "str":
                # column/expression pattern: x LIKE y (pcre.c likematch
                # over two columns) - lowered as a boolean function
                pat_e = self.parse_additive()
                f = Func("like_expr", [e, pat_e])
                f.like_negated = negated
                f.like_caseless = caseless
                return f
            pat = self.next()
            esc = None
            if self.eat_kw("escape"):
                esc = self.next().value
            return Like(e, pat.value, negated=negated, escape=esc,
                        caseless=caseless)
        if negated:
            raise SQLSyntaxError(f"unexpected NOT near {self.peek()}")
        if self.eat_kw("is"):
            neg = bool(self.eat_kw("not"))
            self.expect_kw("null")
            return IsNull(e, negated=neg)
        if self.at_op(*_CMP_OPS):
            op = self.next().value
            if op == "!=":
                op = "<>"
            # quantified comparison: x op ANY/ALL (select ...)
            if self.at_kw("any", "some", "all"):
                q = self.next().value
                self.expect_punct("(")
                s = self.parse_select()
                self.expect_punct(")")
                kind = "any" if q in ("any", "some") else "all"
                return Subquery(s, kind, outer=e, cmp_op=op)
            rhs = self.parse_additive()
            return Cmp(op, e, rhs)
        return e

    def parse_additive(self) -> Expr:
        e = self.parse_multiplicative()
        while self.at_op("+", "-", "||"):
            op = self.next().value
            rhs = self.parse_multiplicative()
            e = BinOp(op, e, rhs)
        return e

    def parse_multiplicative(self) -> Expr:
        e = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            rhs = self.parse_unary()
            e = BinOp(op, e, rhs)
        return e

    def parse_unary(self) -> Expr:
        if self.at_op("-"):
            self.next()
            e = self.parse_unary()
            if isinstance(e, Const) and isinstance(e.value, (int, float,
                                                             Decimal)):
                return Const(-e.value, e.ctype)
            return Func("neg", [e])
        if self.at_op("+"):
            self.next()
            return self.parse_unary()   # chains: + - + - 40
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "ident" and t.value == "next" and \
                self.peek(1).kind == "ident" and \
                self.peek(1).value == "value":
            # NEXT VALUE FOR seq (store_sequence.c / sql_parser.y)
            self.next()
            self.next()
            self.expect_kw("for")
            seq = self._qname().split(".")[-1]
            return Func("next_value_for", [Const(seq)])
        if t.kind == "punct" and t.value == "(":
            self.next()
            if self.at_kw("select"):
                s = self.parse_select()
                self.expect_punct(")")
                return Subquery(s, "scalar")
            e = self.parse_expr()
            self.expect_punct(")")
            return e
        if t.kind == "num":
            self.next()
            v = t.value
            if "." in v or "e" in v.lower():
                if "e" in v.lower():
                    return Const(float(v), F64)
                d = Decimal(v)
                scale = -d.as_tuple().exponent
                return Const(d, dec_t(18, scale))
            return Const(int(v), None)
        if t.kind == "str":
            self.next()
            return Const(t.value, varchar())
        if t.kind == "param":
            self.next()
            self.n_params += 1
            return Param(self.n_params - 1)
        if t.kind == "kw":
            return self.parse_kw_primary()
        if t.kind == "ident":
            self.next()
            # qualified name?
            if self.at_punct("."):
                self.next()
                col = self.next().value
                if col == "*":
                    return Star(t.value)
                if self.at_punct("(") and t.value == "sys":
                    # schema-qualified call: sys.group_concat(...) etc.
                    return self.parse_call(col)
                return ColRef(t.value, col)
            if self.at_punct("("):
                return self.parse_call(t.value)
            if t.value in ("current_date", "curdate"):
                return Const(datetime.date.today(), DATE)
            if t.value in ("current_timestamp", "now", "localtimestamp"):
                return Const(datetime.datetime.now(), TIMESTAMP)
            if t.value in ("current_time", "curtime", "localtime"):
                from ..dtypes import TIME
                return Const(datetime.datetime.now().time(), TIME)
            return ColRef(None, t.value)
        if t.kind == "op" and t.value == "*":
            self.next()
            return Star(None)
        raise SQLSyntaxError(f"unexpected token {t}")

    def _colref_or_call(self, name: str) -> Expr:
        """A keyword used in an identifier position (e.g. a column named
        `date`): qualified ref, call, or bare column."""
        if self.at_punct("."):
            self.next()
            col = self.next().value
            if col == "*":
                return Star(name)
            return ColRef(name, col)
        if self.at_punct("("):
            return self.parse_call(name)
        return ColRef(None, name)

    def parse_kw_primary(self) -> Expr:
        t = self.next()
        v = t.value
        # keywords that double as function names (left/right join kw,
        # insert stmt kw — sql_parser.y handles the same ambiguity)
        if v in ("left", "right", "insert") and self.at_punct("("):
            return self.parse_call(v)
        if v == "null":
            return Const(None, None)
        if v == "true":
            return Const(True, BOOL)
        if v == "false":
            return Const(False, BOOL)
        if v in ("date", "timestamp", "time") and \
                self.peek().kind != "str":
            # not a temporal literal: a column actually named date/time
            # (sql_parser.y resolves the same ambiguity by lookahead)
            return self._colref_or_call(v)
        if v == "date":
            s = self.next().value
            return Const(datetime.date.fromisoformat(s), DATE)
        if v == "timestamp":
            s = self.next().value
            return Const(datetime.datetime.fromisoformat(s), TIMESTAMP)
        if v == "time":
            from ..dtypes import TIME
            s = self.next().value
            return Const(datetime.time.fromisoformat(s), TIME)
        if v == "interval":
            amount = self.next().value
            sign = 1
            if isinstance(amount, str) and amount.startswith("-"):
                sign, amount = -1, amount[1:]
            unit = self.next().value.rstrip("s")  # day(s) month hour ...
            if unit not in ("day", "month", "year", "hour", "minute",
                            "second", "week", "quarter"):
                raise SQLSyntaxError(f"unknown interval unit {unit!r}")
            if self.eat_punct("("):
                # leading-field precision, e.g. interval '90' day (3)
                # (sql_parser.y interval_qualifier) — semantics unaffected
                self.next()
                self.expect_punct(")")
            unit2 = None
            if self.eat_kw("to") or self._eat_ident("to"):
                unit2 = self.next().value.rstrip("s")
            if ":" in str(amount) or unit2 is not None:
                # multi-field literal: '2:30' hour to minute etc.
                # (sql_parser.y interval_string): fields assign from the
                # leading unit downward
                parts = [p.strip() for p in str(amount).split(":")]
                order = ["day", "hour", "minute", "second"]
                if unit == "year":
                    months = int(parts[0]) * 12 + (
                        int(parts[1]) if len(parts) > 1 else 0)
                    return Const((sign * months, "month"), None)
                start = order.index(unit)
                sec_per = {"day": 86400, "hour": 3600, "minute": 60,
                           "second": 1}
                total = 0.0
                lim = {"hour": 24, "minute": 60, "second": 60}
                for k, part in enumerate(parts):
                    u = order[min(start + k, 3)]
                    val = float(part or 0)
                    if k > 0 and val >= lim.get(u, 60):
                        raise SQLSyntaxError(
                            f"22006!field {u} out of range in interval "
                            f"literal {amount!r}")
                    total += val * sec_per[u]
                return Const((sign * total, "second"), None)
            return Const((sign * int(amount), unit), None)
        if v == "case":
            whens = []
            base = None
            if not self.at_kw("when"):
                base = self.parse_expr()
            while self.eat_kw("when"):
                c = self.parse_expr()
                self.expect_kw("then")
                r = self.parse_expr()
                if base is not None:
                    c = Cmp("=", base, c)
                whens.append((c, r))
            default = None
            if self.eat_kw("else"):
                default = self.parse_expr()
            self.expect_kw("end")
            return Case(whens, default)
        if v == "cast":
            self.expect_punct("(")
            e = self.parse_expr()
            self.expect_kw("as")
            typ = self.parse_type()
            self.expect_punct(")")
            return Cast(e, typ)
        if v == "extract":
            self.expect_punct("(")
            field = self.next().value
            self.expect_kw("from")
            e = self.parse_expr()
            self.expect_punct(")")
            return Func(f"extract_{field}", [e])
        if v == "substring":
            self.expect_punct("(")
            e = self.parse_expr()
            if self.eat_kw("from"):
                start = self.parse_expr()
                length = None
                if self.eat_kw("for"):
                    length = self.parse_expr()
            else:
                self.expect_punct(",")
                start = self.parse_expr()
                length = None
                if self.eat_punct(","):
                    length = self.parse_expr()
            self.expect_punct(")")
            args = [e, start] + ([length] if length is not None else [])
            return Func("substring", args)
        if v == "exists":
            self.expect_punct("(")
            s = self.parse_select()
            self.expect_punct(")")
            return Subquery(s, "exists")
        if v == "current":
            if self.eat_kw("date"):
                return Const(datetime.date.today(), DATE)
            if self.eat_kw("timestamp"):
                return Const(datetime.datetime.now(), TIMESTAMP)
            if self.eat_kw("time"):
                from ..dtypes import TIME
                return Const(datetime.datetime.now().time(), TIME)
        raise SQLSyntaxError(f"unexpected keyword {v!r}")

    WINDOW_FUNCS = frozenset({
        "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
        "ntile", "lag", "lead", "first_value", "last_value", "nth_value"})

    def parse_call(self, name: str) -> Expr:
        self.expect_punct("(")
        if name == "position":
            # POSITION(sub IN s) (sql_parser.y string_funcs POSITION)
            sub = self.parse_additive()
            self.expect_kw("in")
            s = self.parse_expr()
            self.expect_punct(")")
            return Func("position", [sub, s])
        if name in AGG_FUNCS:
            distinct = bool(self.eat_kw("distinct"))
            self.eat_kw("all")            # AVG(ALL x) = AVG(x)
            if name == "count" and self.at_op("*"):
                self.next()
                self.expect_punct(")")
                if self.at_kw("over"):
                    return self.parse_window("count_star", None)
                return AggRef("count_star", None)
            arg = self.parse_expr()
            arg2 = None
            if name in AGG_FUNCS_2ARY and self.eat_punct(","):
                arg2 = self.parse_expr()
            self.expect_punct(")")
            if self.at_kw("over"):
                f = "count_star" if isinstance(arg, Star) else name
                return self.parse_window(f, None if f == "count_star" else arg)
            if isinstance(arg, Star):
                return AggRef("count_star", None)
            if name == "any_value":
                name = "min"
            return AggRef(name, arg, distinct=distinct, arg2=arg2)
        args = []
        if not self.at_punct(")"):
            args.append(self.parse_expr())
            while self.eat_punct(","):
                args.append(self.parse_expr())
        self.expect_punct(")")
        if name in self.WINDOW_FUNCS or self.at_kw("over"):
            arg = args[0] if args else None
            extra = args[1:]
            return self.parse_window(name, arg, extra)
        if name in ("now", "current_timestamp") and not args:
            return Const(datetime.datetime.now(), TIMESTAMP)
        # alias normalization (the reference maps these in sql_types.c
        # function registration: substr==substring etc.)
        name = {"substr": "substring", "character_length": "length",
                "char_length": "length"}.get(name, name)
        return Func(name, args)

    def parse_window(self, func: str, arg, extra=None) -> Expr:
        """OVER ([PARTITION BY ...] [ORDER BY ...] [frame]) — the window
        spec grammar of the reference's sql_parser.y window_specification."""
        from ..plan.exprs import WinRef
        self.expect_kw("over")
        self.expect_punct("(")
        partition = []
        order = []
        frame = None
        if self.eat_kw("partition"):
            self.expect_kw("by")
            partition.append(self.parse_expr())
            while self.eat_punct(","):
                partition.append(self.parse_expr())
        if self.eat_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                desc = bool(self.eat_kw("desc"))
                if not desc:
                    self.eat_kw("asc")
                order.append((e, desc))
                if not self.eat_punct(","):
                    break
        if self.at_kw("rows") or self.at_kw("range") or self.at_kw("groups"):
            unit = self.next().value          # rows | range | groups

            def bound(side: str):
                """→ None (unbounded), 0 (current row), ±n (rows/peers/
                value delta) — gdk_analytic_bounds.c bound kinds."""
                if self.eat_kw("unbounded"):
                    self.expect_kw("preceding" if side == "lo"
                                   else "following")
                    return None
                if self.eat_kw("current"):
                    self.expect_kw("row")
                    return 0
                n = self.parse_additive()
                if not isinstance(n, Const):
                    raise SQLSyntaxError("frame offset must be a constant")
                v = n.value
                if self.eat_kw("preceding"):
                    return -v
                self.expect_kw("following")
                return v

            if self.eat_kw("between"):
                lo = bound("lo")
                self.expect_kw("and")
                hi = bound("hi")
            else:
                lo = bound("lo")
                hi = 0
            if lo is None and hi is None:
                frame = "full"
            elif lo is None and hi == 0:
                frame = unit if unit != "groups" else ("groups", None, 0)
            else:
                frame = (unit, lo, hi)
        self.expect_punct(")")
        if frame is None:
            frame = "range" if order else "full"
        if func == "any_value":
            func = "min"       # see AGG_FUNCS note
        w = WinRef(func, arg, partition, order, frame)
        if extra:
            w.extra = extra
        return w

    def parse_type(self) -> SQLType:
        t = self.next().value
        if t in ("int", "integer"):
            return I32
        if t == "bigint":
            return I64
        if t in ("smallint",):
            from ..dtypes import I16
            return I16
        if t in ("tinyint",):
            from ..dtypes import I8
            return I8
        if t in ("double", "float", "real"):
            if self.at_kw("precision"):
                self.next()
            return F64
        if t in ("decimal", "numeric", "dec"):
            p, s = 18, 0
            if self.eat_punct("("):
                p = int(self.next().value)
                if self.eat_punct(","):
                    s = int(self.next().value)
                self.expect_punct(")")
            return dec_t(p, s)
        if t in ("varchar", "char", "character", "text", "string", "clob"):
            if t in ("char", "character", "varchar"):
                # CHARACTER VARYING / CHARACTER LARGE OBJECT (sql_parser.y
                # character_string_type)
                self._eat_ident("varying")
                if self._eat_ident("large"):
                    self._eat_ident("object")
            if self.eat_punct("("):
                self.next()
                self.expect_punct(")")
            return varchar()
        if t in ("blob", "binary", "varbinary"):
            if t == "binary":
                if self._eat_ident("large"):   # BINARY LARGE OBJECT
                    self._eat_ident("object")
            if self.eat_punct("("):
                self.next()
                self.expect_punct(")")
            from ..dtypes import blob as _blob
            return _blob()
        if t == "date":
            return DATE
        if t in ("timestamp", "timestamptz"):
            if self.eat_punct("("):            # precision
                self.next()
                self.expect_punct(")")
            if self.eat_kw("with") or self._eat_ident("without"):
                self._eat_ident("time") or self.eat_kw("time")
                self._eat_ident("zone") or self.eat_kw("zone")
            return TIMESTAMP
        if t in ("time", "timetz"):
            from ..dtypes import TIME
            if self.eat_punct("("):
                self.next()
                self.expect_punct(")")
            if self.eat_kw("with") or self._eat_ident("without"):
                self._eat_ident("time") or self.eat_kw("time")
                self._eat_ident("zone") or self.eat_kw("zone")
            return TIME
        if t == "interval":
            # INTERVAL <field> [TO <field>] (sql_types.c month_interval
            # i32 months / sec_interval i64 µs)
            from ..dtypes import MONTH_INTERVAL, SEC_INTERVAL
            fields = []
            while self.peek().kind in ("ident", "kw") and \
                    self.peek().value in ("year", "month", "day", "hour",
                                          "minute", "second", "to"):
                fields.append(self.next().value)
                if self.eat_punct("("):        # leading precision
                    self.next()
                    self.expect_punct(")")
            months = fields and fields[0] in ("year", "month")
            return MONTH_INTERVAL if months else SEC_INTERVAL
        if t in ("boolean", "bool"):
            return BOOL
        if t in ("hugeint",):
            # reference hge is int128 (gdk/gdk.h:441); we map to int64 with
            # overflow checking — documented narrowing until limb columns land
            return I64
        if t in ("oid", "wrd"):
            return I64
        if t in ("uuid", "inet", "url", "json"):
            # textual atom types (modules/atoms/{uuid,inet,url,json}.c):
            # stored as dictionary-encoded strings; type-specific
            # functions live in the json/uuid function modules
            return varchar()
        raise SQLSyntaxError(f"unknown type {t!r}")

    # -- DDL / DML ----------------------------------------------------------
    def parse_create(self):
        self.expect_kw("create")
        replace = False
        if self.eat_kw("or"):           # CREATE OR REPLACE (sql_parser.y)
            if not self._eat_ident("replace"):
                raise SQLSyntaxError("expected REPLACE after CREATE OR")
            replace = True
        if self.eat_kw("view"):
            from .ast import CreateView
            name = self.next().value
            while self.at_punct(".") and self.peek(1).kind in \
                    ("ident", "str"):
                self.next()
                name += "." + self.next().value
            aliases = None
            if self.eat_punct("("):     # optional column alias list
                aliases = [self.next().value]
                while self.eat_punct(","):
                    aliases.append(self.next().value)
                self.expect_punct(")")
            self.expect_kw("as")
            start = self.toks[self.i].pos
            self.parse_select()          # validate syntax; keep raw text
            body = self.sql_text[start:].strip().rstrip("; \t\n")
            if aliases:
                # apply the column alias list by wrapping the body in a
                # renaming derived table (sql_parser.y view_def passes
                # the list into the view's output names)
                bare = name.split(".")[-1]
                body = (f"select * from ({body}) as "
                        f"{bare}({', '.join(aliases)})")
            v = CreateView(name, body)
            v.replace = replace
            return v
        if self._at_ident("index") or \
                (self.at_kw("unique") and
                 self.peek(1).kind == "ident" and
                 self.peek(1).value == "index"):
            uniq = bool(self.eat_kw("unique"))
            self.next()                       # 'index'
            from .ast import CreateIndex
            name = self.next().value
            self.expect_kw("on")
            table = self.next().value
            while self.eat_punct("."):
                table += "." + self.next().value
            self.expect_punct("(")
            cols = [self.next().value]
            while self.eat_punct(","):
                cols.append(self.next().value)
            self.expect_punct(")")
            return CreateIndex(name, table, cols, uniq)
        if self._at_ident("schema"):
            # CREATE SCHEMA s [AUTHORIZATION owner] (sql_parser.y
            # schema_def; rel_schema.c rel_create_schema)
            self.next()
            from .ast import CreateSchema
            if_not_exists = False
            if self.eat_kw("if") or self._eat_ident("if"):
                self.expect_kw("not")
                self.eat_kw("exists") or self._eat_ident("exists")
                if_not_exists = True
            name = self.next().value
            auth = None
            if self._eat_ident("authorization"):
                auth = self.next().value
            return CreateSchema(name, auth, if_not_exists)
        if self.at_kw("merge") or self.at_kw("remote") or \
                self.at_kw("replica"):
            return self.parse_create_distributed()
        if self._at_ident("user"):
            # CREATE USER u WITH [UNENCRYPTED|ENCRYPTED] PASSWORD 'p' ...
            # (sql_parser.y user_def; sql_user.c)
            self.next()
            from .ast import CreateUser
            name = self.next().value
            self.expect_kw("with")
            self._eat_ident("unencrypted") or self._eat_ident("encrypted")
            if not self._eat_ident("password"):
                raise SQLSyntaxError("expected PASSWORD")
            pw = self.next().value
            # optional NAME 'Full Name' SCHEMA s — parsed and ignored
            while self.peek().kind in ("ident", "kw", "str") and \
                    self.peek().kind != "eof" and self.peek().value:
                self.next()
            return CreateUser(name, pw)
        if self._at_ident("role"):
            self.next()
            from .ast import CreateRole
            return CreateRole(self.next().value)
        if self._at_ident("trigger"):
            self.next()
            from .ast import CreateTrigger
            name = self.next().value
            if self._eat_ident("before"):
                time = "before"
            elif self._eat_ident("after"):
                time = "after"
            else:
                raise SQLSyntaxError("expected BEFORE or AFTER")
            t = self.next()
            if t.value not in ("insert", "update", "delete"):
                raise SQLSyntaxError(f"unknown trigger event {t.value!r}")
            event = t.value
            self.expect_kw("on")
            table = self.next().value
            if self.eat_kw("for"):          # FOR [EACH] ROW|STATEMENT
                self._eat_ident("each")
                self.next()
            # body = the rest of the statement text (one or more
            # ';'-separated statements, optionally BEGIN ATOMIC ... END)
            body = self.sql_text[self.peek().pos:].strip()
            low = body.lower()
            if low.startswith("begin"):
                inner = body[5:]
                if inner.lstrip().lower().startswith("atomic"):
                    inner = inner.lstrip()[6:]
                if inner.rstrip().rstrip(";").lower().endswith("end"):
                    inner = inner.rstrip().rstrip(";")[:-3]
                body = inner.strip()
            self.i = len(self.toks) - 1      # consumed
            return CreateTrigger(name, time, event, table, body,
                                 replace=replace)
        if self._at_ident("procedure"):
            self.next()
            from .ast import CreateProcedure
            name = self.next().value
            params = []
            self.expect_punct("(")
            if not self.eat_punct(")"):
                while True:
                    pname = self.next().value
                    params.append((pname, self.parse_type()))
                    if not self.eat_punct(","):
                        break
                self.expect_punct(")")
            body = self.sql_text[self.peek().pos:].strip()
            low = body.lower()
            if low.startswith("begin"):
                inner = body[5:]
                if inner.lstrip().lower().startswith("atomic"):
                    inner = inner.lstrip()[6:]
                if inner.rstrip().rstrip(";").lower().endswith("end"):
                    inner = inner.rstrip().rstrip(";")[:-3]
                body = inner.strip()
            self.i = len(self.toks) - 1
            return CreateProcedure(name, params, body)
        if self.peek().kind == "ident" and self.peek().value == "sequence":
            self.next()
            from .ast import CreateSequence
            name = self._qname()
            start, inc, minv, maxv = 1, 1, None, None
            while True:
                if self.at_kw("start"):
                    self.next()
                    self.expect_kw("with")
                    start = int(self.parse_expr().value)
                elif self.eat_kw("as"):
                    self.parse_type()       # AS int/bigint — range note only
                elif self._eat_ident("increment"):
                    self.expect_kw("by")
                    inc = int(self.parse_expr().value)
                elif self._eat_ident("minvalue"):
                    minv = int(self.parse_expr().value)
                elif self._eat_ident("maxvalue"):
                    maxv = int(self.parse_expr().value)
                elif self._eat_ident("cache"):
                    self.parse_expr()       # advisory here
                elif self._eat_ident("cycle"):
                    pass
                elif self.eat_kw("no") or self._eat_ident("no"):
                    self.next()             # NO MINVALUE/MAXVALUE/CYCLE             # NO MINVALUE/MAXVALUE/CYCLE
                else:
                    break
            return CreateSequence(name, start, inc, minv, maxv)
        # CREATE [LOCAL|GLOBAL] TEMP[ORARY] TABLE — approximated as a
        # regular table in the shared namespace (the reference's tmp
        # schema, rel_schema.c); ON COMMIT clause parsed below
        is_temp = False
        if self._eat_ident("local") or self._eat_ident("global"):
            is_temp = True
        if self._eat_ident("temporary") or self._eat_ident("temp"):
            is_temp = True
        self.expect_kw("table")
        name = self._qname()
        if is_temp and name.startswith("tmp."):
            name = name[4:]
        # CREATE TABLE t (c1, c2) AS <query>: bare column-name list
        # (sql_parser.y table_def AS with column list)
        ctas_cols = None
        if self.at_punct("("):
            j = self.i + 1
            names = []
            ok = False
            while j < len(self.toks):
                t = self.toks[j]
                if t.kind in ("ident", "kw"):
                    names.append(t.value)
                    j += 1
                    if self.toks[j].kind == "punct" and \
                            self.toks[j].value == ",":
                        j += 1
                        continue
                    if self.toks[j].kind == "punct" and \
                            self.toks[j].value == ")":
                        nxt = self.toks[j + 1] if j + 1 < len(self.toks) \
                            else None
                        ok = nxt is not None and nxt.kind == "kw" and \
                            nxt.value == "as"
                        j += 1
                    break
                break
            if ok:
                ctas_cols = names
                self.i = j
        if self.at_kw("as"):
            # CREATE TABLE t AS SELECT ... / AS VALUES ... [WITH [NO]
            # DATA] (sql_parser.y table_def AS, rel_schema.c)
            self.next()
            if self.at_kw("values"):
                self.next()
                rows = []
                while True:
                    self.expect_punct("(")
                    row = [self.parse_expr()]
                    while self.eat_punct(","):
                        row.append(self.parse_expr())
                    self.expect_punct(")")
                    rows.append(row)
                    if not self.eat_punct(","):
                        break
                from .ast import ValuesSource
                alias = "_v"
                sel = SelectStmt(items=[(None, Star())],
                                 sources=[ValuesSource(rows, alias,
                                                       ctas_cols)])
            else:
                sel = self.parse_select()
            with_data = True
            if self.eat_kw("with"):
                if self.eat_kw("no") or self._eat_ident("no"):
                    with_data = False
                self._eat_ident("data")
            from .ast import CreateTableAs
            return CreateTableAs(name, sel, with_data,
                                 columns=ctas_cols)
        cols = self.parse_column_defs()
        if self.eat_kw("on") or self._eat_ident("on"):
            # ON COMMIT {PRESERVE|DELETE} ROWS / DROP (temp tables)
            self._eat_ident("commit")
            self.next()
            self._eat_ident("rows")
        return CreateTable(name, cols, checks=self.table_checks or None,
                           uniques=self.table_uniques or None,
                           fks=self.table_fks or None)

    def _parse_column_flags(self) -> dict:
        """Column constraints: NOT NULL, PRIMARY KEY, UNIQUE,
        AUTO_INCREMENT, DEFAULT expr (kept as SQL text, evaluated at
        insert time — rel_schema.c column_option)."""
        flags = {"notnull": False, "pk": False, "serial": False}
        while True:
            if self.eat_kw("constraint") or \
                    self._eat_ident("constraint"):  # CONSTRAINT <name>
                self.next()
                continue
            if self.eat_kw("not"):
                self.expect_kw("null")
                flags["notnull"] = True
            elif self.eat_kw("null"):
                pass
            elif self.eat_kw("primary"):
                self.expect_kw("key")
                flags["notnull"] = flags["pk"] = True
            elif self._eat_ident("unique"):
                if self._eat_ident("nulls") or self.eat_kw("nulls"):
                    # UNIQUE NULLS [NOT] DISTINCT
                    self.eat_kw("not")
                    self._eat_ident("distinct") or self.eat_kw("distinct")
                flags["unique"] = True
            elif self._eat_ident("auto_increment"):
                flags["serial"] = True
            elif self._eat_ident("generated"):
                # GENERATED ALWAYS AS IDENTITY [(seq options)]
                # (sql_parser.y serial_opt_params; = serial)
                self.eat_kw("always") or self._eat_ident("always")
                self.eat_kw("as") or self._eat_ident("as")
                self._eat_ident("identity")
                flags["serial"] = True
                if self.eat_punct("("):
                    depth = 1
                    while depth:
                        tk = self.next()
                        if tk.kind == "punct" and tk.value == "(":
                            depth += 1
                        elif tk.kind == "punct" and tk.value == ")":
                            depth -= 1
            elif self.eat_kw("references") or self._eat_ident("references"):
                # inline FK (sql_parser.y column_constraint_type ref)
                rtab = self._qname().split(".")[-1].lower()
                rcols = []
                if self.eat_punct("("):
                    while not self.at_punct(")"):
                        t = self.next()
                        if t.kind in ("ident", "kw"):
                            rcols.append(t.value.lower())
                        self.eat_punct(",")
                    self.expect_punct(")")
                act = self._eat_fk_actions()
                flags["fk"] = [rtab, rcols, act]
            elif self.eat_kw("check") or self._eat_ident("check"):
                self.expect_punct("(")
                start = self.peek().pos
                depth = 1
                end = start
                while depth:
                    tk = self.next()
                    if tk.kind == "punct" and tk.value == "(":
                        depth += 1
                    elif tk.kind == "punct" and tk.value == ")":
                        depth -= 1
                    end = tk.pos
                flags["check"] = self.sql_text[start:end].strip()
            elif self.eat_kw("default"):
                start = self.peek().pos
                # additive expr only: NOT/IN/BETWEEN belong to the column
                # constraint list, not the default value
                self.parse_additive()
                flags["default"] = self.sql_text[start:self.peek().pos] \
                    .strip().rstrip(",")
            else:
                break
        return flags

    def _eat_fk_actions(self):
        """[MATCH ...] [ON DELETE action] [ON UPDATE action]
        (sql_parser.y opt_ref_action).  Returns the ON DELETE action:
        'restrict' (default/NO ACTION), 'cascade', or 'setnull'."""
        action = "restrict"
        while True:
            if self._eat_ident("match"):
                self.next()
            elif self.eat_kw("on") or self._eat_ident("on"):
                which = self.next().value.lower()   # delete | update
                if self.eat_kw("set") or self._eat_ident("set"):
                    tgt = self.next().value.lower()  # null | default
                    if which == "delete" and tgt == "null":
                        action = "setnull"
                elif self._eat_ident("no"):
                    self._eat_ident("action")
                    if which == "delete":
                        # MonetDB's explicit NO ACTION skips the delete
                        # check (Update_Delete_action tests pin this)
                        # while a clause-less FK enforces
                        action = "noaction"
                else:
                    a = self.next().value.lower()    # cascade | restrict
                    if which == "delete" and a == "cascade":
                        action = "cascade"
            else:
                return action

    def parse_column_defs(self):
        self.expect_punct("(")
        cols = []
        table_pks = []
        table_checks = []
        table_uniques = []
        table_fks = []
        self._cons_name = None
        while True:
            if self.eat_kw("constraint") or \
                    self._eat_ident("constraint"):  # CONSTRAINT <name>
                self._cons_name = self.next().value
                continue
            if self.eat_kw("check") or (self._at_ident("check") and
                                        self.peek(1).kind == "punct" and
                                        self.peek(1).value == "("):
                self._eat_ident("check")
                self.expect_punct("(")
                start = self.peek().pos
                depth = 1
                end = start
                while depth:
                    tk = self.next()
                    if tk.kind == "punct" and tk.value == "(":
                        depth += 1
                    elif tk.kind == "punct" and tk.value == ")":
                        depth -= 1
                    end = tk.pos
                table_checks.append(
                    (getattr(self, "_cons_name", None),
                     self.sql_text[start:end].strip()))
                self._cons_name = None
            elif self.at_kw("primary"):
                self.next()
                self.expect_kw("key")
                self.expect_punct("(")
                while not self.eat_punct(")"):
                    t = self.next()
                    if t.kind in ("ident", "kw"):
                        table_pks.append(t.value)
            elif self.at_kw("foreign"):
                self.next()
                self.expect_kw("key")
                self.expect_punct("(")
                fcols = []
                while not self.at_punct(")"):
                    t = self.next()
                    if t.kind in ("ident", "kw"):
                        fcols.append(t.value.lower())
                    self.eat_punct(",")
                self.expect_punct(")")
                self.expect_kw("references")
                rtab = self._qname().split(".")[-1].lower()
                rcols = []
                if self.eat_punct("("):
                    while not self.at_punct(")"):
                        t = self.next()
                        if t.kind in ("ident", "kw"):
                            rcols.append(t.value.lower())
                        self.eat_punct(",")
                    self.expect_punct(")")
                act = self._eat_fk_actions()
                table_fks.append([fcols, rtab, rcols, act])
            elif self._at_ident("unique") and (
                    (self.peek(1).kind == "punct" and
                     self.peek(1).value == "(") or
                    self.peek(1).value == "nulls"):
                # table-level UNIQUE [NULLS [NOT] DISTINCT] (cols)
                self.next()
                if self._eat_ident("nulls") or self.eat_kw("nulls"):
                    self.eat_kw("not")
                    self._eat_ident("distinct") or self.eat_kw("distinct")
                self.expect_punct("(")
                ucols = [self.next().value]
                while self.eat_punct(","):
                    ucols.append(self.next().value)
                self.expect_punct(")")
                if len(ucols) == 1:
                    for c, _t, flags in cols:
                        if c in ucols:
                            flags["unique"] = True
                else:
                    # constraint on the combination (sql_cat.c ukey)
                    table_uniques.append([c.lower() for c in ucols])
            else:
                cname = self.next().value
                if self.peek().kind == "ident" and \
                        self.peek().value in ("serial", "bigserial"):
                    # serial = int sequence + primary key (rel_schema.c)
                    from ..dtypes import I32 as _I32, I64 as _I64
                    ctype = _I32 if self.next().value == "serial" else _I64
                    flags = self._parse_column_flags()
                    flags["serial"] = flags["pk"] = flags["notnull"] = True
                else:
                    ctype = self.parse_type()
                    flags = self._parse_column_flags()
                cols.append((cname, ctype, flags))
            if not self.eat_punct(","):
                break
        self.expect_punct(")")
        for c, _t, flags in cols:
            if c in table_pks:
                flags["pk"] = True
                flags["notnull"] = True
        self.table_checks = table_checks
        self.table_uniques = table_uniques
        for c, _t, flags in cols:
            if flags.get("fk"):
                rtab, rcols, act = flags.pop("fk")
                table_fks.append([[c.lower()], rtab, rcols, act])
        self.table_fks = table_fks
        return cols

    def parse_create_distributed(self):
        from .ast import (CreateMergeTable, CreateRemoteTable,
                          CreateReplicaTable)
        if self.eat_kw("merge"):
            self.expect_kw("table")
            name = self.next().value
            cols = self.parse_column_defs()
            part_kind = part_col = None
            if self.eat_kw("partition"):
                self.expect_kw("by")
                if self.eat_kw("range"):
                    part_kind = "range"
                else:
                    self.expect_kw("values")
                    part_kind = "values"
                self.expect_kw("on")
                self.expect_punct("(")
                part_col = self.next().value
                self.expect_punct(")")
            return CreateMergeTable(name, cols, part_kind, part_col)
        if self.eat_kw("remote"):
            self.expect_kw("table")
            name = self.next().value
            cols = self.parse_column_defs()
            self.expect_kw("on")
            addr = self.next().value
            return CreateRemoteTable(name, cols, addr)
        self.expect_kw("replica")
        self.expect_kw("table")
        name = self.next().value
        cols = self.parse_column_defs()
        return CreateReplicaTable(name, cols)

    def _at_ident(self, *names) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.value in names

    def _eat_ident(self, *names) -> bool:
        if self._at_ident(*names):
            self.i += 1
            return True
        return False

    def parse_alter(self):
        from .ast import (AlterAddColumn, AlterAddTable, AlterDropColumn,
                          AlterDropTable, AlterRenameColumn,
                          AlterRenameTable)
        self.expect_kw("alter")
        if self._at_ident("sequence"):
            # ALTER SEQUENCE s RESTART [WITH n] | INCREMENT BY n | ...
            self.next()
            from .ast import AlterSequence
            name = self._qname()
            restart = inc = None
            while True:
                if self._eat_ident("restart"):
                    restart = "min"        # RESTART alone → initial start
                    if self.eat_kw("with"):
                        restart = self.parse_expr()   # Const or subquery
                elif self._eat_ident("increment"):
                    self.expect_kw("by")
                    inc = int(self.parse_expr().value)
                elif self.eat_kw("as"):
                    self.parse_type()
                elif self._eat_ident("minvalue") or \
                        self._eat_ident("maxvalue") or \
                        self._eat_ident("cache"):
                    self.parse_expr()
                elif self._eat_ident("cycle"):
                    pass
                elif self.eat_kw("no") or self._eat_ident("no"):
                    self.next()             # NO MINVALUE/MAXVALUE/CYCLE
                elif self.eat_kw("start"):
                    self.expect_kw("with")
                    restart = int(self.parse_expr().value)
                else:
                    break
            return AlterSequence(name, restart, inc)
        if self._at_ident("schema") or self.at_kw("schema"):
            # ALTER SCHEMA [IF EXISTS] s RENAME TO s2 (sql_parser.y)
            self.next()
            from .ast import AlterRenameSchema
            if_exists = False
            if self.eat_kw("if") or self._eat_ident("if"):
                self.eat_kw("exists") or self._eat_ident("exists")
                if_exists = True
            old = self.next().value
            if not self._eat_ident("rename"):
                self.expect_kw("rename")
            self.expect_kw("to")
            st = AlterRenameSchema(old, self.next().value)
            st.if_exists = if_exists
            return st
        self.expect_kw("table")
        alt_if_exists = bool(
            (self.eat_kw("if") or self._eat_ident("if")) and
            (self.eat_kw("exists") or self._eat_ident("exists")))
        parent = self._qname()

        def _t(st):
            # IF EXISTS: the session no-ops when the table is absent
            if alt_if_exists:
                st.if_exists = True
            return st
        if self._eat_ident("rename"):
            if self.eat_kw("to"):
                return _t(AlterRenameTable(parent, self.next().value))
            self._eat_ident("column")
            col = self.next().value
            self.expect_kw("to")
            return _t(AlterRenameColumn(parent, col, self.next().value))
        if self.eat_kw("drop"):
            if self.eat_kw("table"):
                return _t(AlterDropTable(parent, self._qname()))
            if self.eat_kw("constraint"):
                self.next()                     # constraints unenforced
                self._eat_ident("cascade")
                self._eat_ident("restrict")
                from .ast import NoOp
                return NoOp("drop constraint")
            self._eat_ident("column")
            return _t(AlterDropColumn(parent, self.next().value))
        if self.eat_kw("set") or self._eat_ident("set"):
            # SET SCHEMA s2 | {READ ONLY | READ WRITE | INSERT ONLY}
            # (sql_parser.y alter_statement; sql_cat.c sql_alter_table)
            if self._eat_ident("schema") or self.eat_kw("schema"):
                from .ast import AlterSetSchema
                return _t(AlterSetSchema(parent, self.next().value))
            from .ast import AlterSetAccess
            if self._eat_ident("insert"):
                self._eat_ident("only")
                return _t(AlterSetAccess(parent, "insert_only"))
            self._eat_ident("read")
            if self._eat_ident("only"):
                return _t(AlterSetAccess(parent, "read_only"))
            self._eat_ident("write")
            return _t(AlterSetAccess(parent, "read_write"))
        if self._eat_ident("alter"):
            # ALTER TABLE t ALTER [COLUMN] c SET ... / SET DEFAULT / NULL
            self._eat_ident("column")
            self.next()
            while self.peek().kind != "eof":
                self.next()
            from .ast import NoOp
            return NoOp("alter column")
        self.expect_kw("add")
        if self.at_kw("constraint") or self._at_ident("constraint"):
            self.next()
            self.next()                      # constraint name
        if self.at_kw("foreign") or self._at_ident("foreign"):
            self.next()
            self.expect_kw("key") if self.at_kw("key") else \
                self._eat_ident("key")
            self.expect_punct("(")
            fcols = []
            while not self.at_punct(")"):
                t = self.next()
                if t.kind in ("ident", "kw"):
                    fcols.append(t.value.lower())
                self.eat_punct(",")
            self.expect_punct(")")
            self.expect_kw("references") if self.at_kw("references") \
                else self._eat_ident("references")
            rtab = self._qname().split(".")[-1].lower()
            rcols = []
            if self.eat_punct("("):
                while not self.at_punct(")"):
                    t = self.next()
                    if t.kind in ("ident", "kw"):
                        rcols.append(t.value.lower())
                    self.eat_punct(",")
                self.expect_punct(")")
            act = self._eat_fk_actions()
            from .ast import AddForeignKey
            return _t(AddForeignKey(parent, fcols, rtab, rcols, act))
        if self.at_kw("primary") or self._at_ident("unique") or \
                self.eat_kw("unique"):
            is_pk = False
            if self.at_kw("primary"):
                self.next()
                self.expect_kw("key") if self.at_kw("key") else \
                    self._eat_ident("key")
                is_pk = True
            else:
                self._eat_ident("unique")
            cols = []
            self.expect_punct("(")
            while not self.at_punct(")"):
                t = self.next()
                if t.kind in ("ident", "kw"):
                    cols.append(t.value.lower())
                self.eat_punct(",")
            self.expect_punct(")")
            from .ast import AddUniqueKey
            return _t(AddUniqueKey(parent, cols, is_pk))
        if self.at_kw("check") or self._at_ident("check"):
            # post-hoc CHECK: parsed, not enforced
            while self.peek().kind != "eof":
                self.next()
            from .ast import NoOp
            return NoOp("add constraint")
        if not self.eat_kw("table"):
            # ALTER TABLE t ADD [COLUMN] c type [NOT NULL] [DEFAULT expr]
            self._eat_ident("column")
            cname = self.next().value
            if self.peek().kind == "ident" and \
                    self.peek().value in ("serial", "bigserial"):
                # serial = int sequence (rel_schema.c); backfills 1..n
                from ..dtypes import I32 as _I32, I64 as _I64
                ctype = _I32 if self.next().value == "serial" else _I64
                flags = self._parse_column_flags()
                flags["serial"] = flags["notnull"] = True
            else:
                ctype = self.parse_type()
                flags = self._parse_column_flags()
            return _t(AlterAddColumn(parent, cname, ctype, flags))
        member = self.next().value
        rng = vals = None
        nulls = False
        if self.eat_kw("as"):
            self.expect_kw("partition")
            if self.eat_kw("from"):
                lo = self.parse_expr()
                self.expect_kw("to")
                hi = self.parse_expr()
                rng = (lo, hi)
            elif self.eat_kw("in"):
                self.expect_punct("(")
                vals = [self.parse_expr()]
                while self.eat_punct(","):
                    vals.append(self.parse_expr())
                self.expect_punct(")")
            else:
                self.expect_kw("for")
                self.expect_kw("null")
                self.expect_kw("values")
                nulls = True
        return _t(AlterAddTable(parent, member, rng, vals, nulls))

    def parse_insert(self):
        self.expect_kw("insert")
        self.expect_kw("into")
        name = self._qname()
        columns = None
        if self.eat_punct("("):
            columns = []
            while True:
                columns.append(self.next().value)
                if not self.eat_punct(","):
                    break
            self.expect_punct(")")
        if self.at_kw("select"):
            return InsertSelect(name, self.parse_select(), columns)
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_punct("(")
            row = [self.parse_expr()]
            while self.eat_punct(","):
                row.append(self.parse_expr())
            self.expect_punct(")")
            rows.append(row)
            if not self.eat_punct(","):
                break
        return InsertValues(name, rows, columns)

    def parse_copy(self):
        self.expect_kw("copy")
        records = None
        if self.peek().kind == "ident" and self.peek().value == "binary":
            # COPY BINARY INTO t FROM ('f1', 'f2', ...) — fixed-width
            # binary bulk load (reference: sql/backends/monet5/sql_bincopy*)
            self.next()
            self.expect_kw("into")
            name = self.next().value
            self.expect_kw("from")
            paths = []
            wrapped = self.eat_punct("(")
            paths.append(self.next().value)
            while self.eat_punct(","):
                paths.append(self.next().value)
            if wrapped:
                self.expect_punct(")")
            from .ast import CopyBinaryFrom
            return CopyBinaryFrom(name, paths)
        if self.peek().kind == "num":
            records = int(self.next().value)
            self.expect_kw("records")
        if self.at_kw("select") or self.peek().kind == "ident":
            # COPY <table|SELECT...> INTO 'file' — result export
            # (reference: sql/server/sql_parser.y copyto, mvc_export)
            if self.at_kw("select"):
                src = self.parse_select()
            else:
                src = self.next().value
            self.expect_kw("into")
            path = self.next().value
            delim = "|"
            if self.eat_kw("delimiters"):
                delim = self.next().value
                while self.eat_punct(","):
                    self.next()
            from .ast import CopyInto
            return CopyInto(src, path, delim)
        self.expect_kw("into")
        name = self._qname()
        columns = None
        if self.eat_punct("("):        # COPY INTO t(cols) FROM ...
            columns = [self.next().value]
            while self.eat_punct(","):
                columns.append(self.next().value)
            self.expect_punct(")")
        self.expect_kw("from")
        path = self.next().value       # 'file' or STDIN (sql_parser.y)
        if self.eat_punct("("):        # FROM STDIN (header list)
            columns = [self.next().value]
            while self.eat_punct(","):
                columns.append(self.next().value)
            self.expect_punct(")")
        delim = "|"
        quote = None
        nullstr = None
        self.eat_kw("using")   # COPY ... USING DELIMITERS (sql_parser.y)
        if self.eat_kw("delimiters"):
            delim = self.next().value
            extras = []
            while self.eat_punct(","):
                extras.append(self.next().value)
            if len(extras) >= 2:       # field, row, quote
                quote = extras[1]
        if self.eat_kw("null") or self._eat_ident("null"):
            self.eat_kw("as") or self._eat_ident("as")
            nullstr = self.next().value
        self._eat_ident("best")        # BEST EFFORT error tolerance
        self._eat_ident("effort")
        return CopyFrom(name, path, delim, records, quote=quote,
                        nullstr=nullstr, columns=columns)


_CREATE_FUNC_RE = __import__("re").compile(
    r"^\s*create\s+function\b", __import__("re").I)


def _parse_create_function(sql: str):
    """CREATE FUNCTION f(x int, ...) RETURNS t
         LANGUAGE PYTHON { body }          — Python UDF (UDF/pyapi3), or
         [BEGIN] RETURN <expr>[;] [END]    — SQL scalar function
                                             (rel_psm.c, inlined at bind)."""
    from .ast import CreateFunction
    brace = sql.find("{")
    py = brace >= 0 and __import__("re").search(
        r"language\s+python", sql[:brace], __import__("re").I) is not None
    header = sql[:brace] if py else sql
    p = Parser(header if py else sql)
    p.expect_kw("create")
    if p.peek().kind == "kw" and p.peek().value == "or":
        p.next()
        p._eat_ident("replace")
    if not (p.peek().kind == "ident" and p.peek().value == "function"):
        raise SQLSyntaxError("expected FUNCTION")
    p.next()
    name = p._qname().split(".")[-1]
    params = []
    p.expect_punct("(")
    if not p.eat_punct(")"):
        while True:
            pname = p.next().value
            params.append((pname, p.parse_type()))
            if not p.eat_punct(","):
                break
        p.expect_punct(")")
    if not (p.peek().kind == "ident" and p.peek().value == "returns"):
        raise SQLSyntaxError("expected RETURNS")
    p.next()
    if p.at_kw("table") or p._at_ident("table"):
        # RETURNS TABLE (c1 t1, ...) — table function (rel_psm.c
        # rel_create_func table-returning case)
        p.next()
        p.expect_punct("(")
        cols = []
        while True:
            cn = p.next().value
            cols.append((cn, p.parse_type()))
            if not p.eat_punct(","):
                break
        p.expect_punct(")")
        body = sql[p.peek().pos:].strip().rstrip(";").strip()
        low = body.lower()
        if low.startswith("begin"):
            body = body[5:].strip()
            if body.lower().endswith("end"):
                body = body[:-3].strip().rstrip(";").strip()
        if body.lower().startswith("return"):
            body = body[6:].strip().rstrip(";").strip()
        if body.lower().startswith("table"):
            body = body[5:].strip()
            if body.startswith("(") and body.endswith(")"):
                body = body[1:-1].strip()
        if not body.lower().startswith(("select", "with", "(")):
            raise SQLSyntaxError(
                "table function body must be RETURN TABLE(select ...)")
        return CreateFunction(name, params, None, "sql_table", body,
                              cols=cols)
    ret = p.parse_type()
    if py:
        j = sql.rfind("}")
        if j < brace:
            raise SQLSyntaxError("unterminated { body }")
        body = sql[brace + 1:j]
        if not (p.peek().kind == "ident" and p.peek().value == "language"):
            raise SQLSyntaxError("expected LANGUAGE")
        p.next()
        lang = p.next().value
        if lang not in ("python", "python3"):
            raise SQLSyntaxError(f"unsupported UDF language {lang}")
        return CreateFunction(name, params, ret, "python", body)
    # SQL scalar function: capture the RETURN expression text
    from .psm import strip_line_comments
    body = strip_line_comments(sql[p.peek().pos:]).strip()\
        .rstrip(";").strip()
    low = body.lower()
    if low.startswith("begin"):
        body = body[5:].strip()
        if body.lower().endswith("end"):
            body = body[:-3].strip().rstrip(";").strip()
    if not body.lower().startswith("return"):
        # straight-line PSM body: DECLARE v t; SET v = expr; ... RETURN
        # expr — folded into one expression by back-substitution (the
        # inlinable subset of rel_psm.c; loops/exceptions stay
        # unsupported and error here)
        import re as _re
        stmts = [st.strip() for st in body.split(";") if st.strip()]
        env = {}
        ret_expr = None
        for st in stmts:
            lw = st.lower()
            if lw.startswith("declare"):
                m = _re.match(r"declare\s+(\w+)", st, _re.I)
                if m:
                    env.setdefault(m.group(1).lower(), "NULL")
                continue
            if lw.startswith("set"):
                m = _re.match(r"set\s+(\w+)\s*=\s*(.*)", st,
                              _re.I | _re.S)
                if not m:
                    raise SQLSyntaxError(f"bad SET in function body: {st}")
                v, ex = m.group(1).lower(), m.group(2).strip()
                for k, val in env.items():
                    ex = _re.sub(rf"\b{k}\b", f"({val})", ex,
                                 flags=_re.I)
                env[v] = ex
                continue
            if lw.startswith("return"):
                ret_expr = st[6:].strip()
                for k, val in env.items():
                    ret_expr = _re.sub(rf"\b{k}\b", f"({val})", ret_expr,
                                       flags=_re.I)
                break
            # control flow / side effects (WHILE, IF, INSERT, ...):
            # interpreted at call time (rel_psm.c full PSM)
            return CreateFunction(name, params, ret, "sql_interp", body)
        if ret_expr is None:
            raise SQLSyntaxError("SQL function body has no RETURN")
        return CreateFunction(name, params, ret, "sql", ret_expr)
    body = body[6:].strip().rstrip(";").strip()
    if body.lower().startswith(("select", "with")):
        # RETURN SELECT ...: a scalar subquery (rel_psm.c rel_psm_return)
        body = "(" + body + ")"
    return CreateFunction(name, params, ret, "sql", body)


def parse(sql: str):
    if _CREATE_FUNC_RE.match(sql):
        return _parse_create_function(sql)
    p = Parser(sql)
    stmt = p.parse_stmt()
    p.eat_punct(";")
    if p.peek().kind != "eof":
        raise SQLSyntaxError(f"trailing tokens at {p.peek()}")
    return stmt


def parse_expr(sql: str) -> Expr:
    p = Parser(sql)
    e = p.parse_expr()
    if p.peek().kind != "eof":
        raise SQLSyntaxError(f"trailing tokens at {p.peek()}")
    return e
