"""Session: the full SQL surface over a Database — queries, DDL, DML,
transactions, COPY INTO. The condensation of the reference's SQL scenario +
update plans (sql/backends/monet5/sql_scenario.c SQLengine; rel_updates.c
insert/update/delete plans lower to sql.append/sql.update/sql.delete — here
they lower to Database.insert/update/delete on storage oids selected by the
same query machinery).

Queries run through ``Engine`` on the device the session's ``Database``
was opened with, and SPMD over the session's row mesh where it has one
(``mesh=``, or ``parallel.default_mesh()`` for a store on a CUDA device
when config ``spmd_auto_mesh`` is on: every visible card when there are
more than one; the port's default is off)."""

from __future__ import annotations

import csv
import datetime
from decimal import Decimal as PyDecimal
from typing import Dict, List, Optional, Union

import numpy as np

from .dtypes import Kind, SQLType
from .engine import Engine, Result, check_mesh
from .obs.profiler import PROFILER
from .sql import ast as A
from .sql.binder import BindError, bind_select
from .sql.parser import parse
from .plan.exprs import ColRef, Const, Star
from .storage.columns import to_physical_np
from .storage.database import Database

__all__ = ["Session"]


def _open_maybe_compressed(path: str):
    """Text reader with transparent gz/bz2/xz decompression by suffix —
    the reference's layered compressed streams (common/stream/)."""
    if path.endswith(".gz"):
        import gzip
        return gzip.open(path, "rt", newline="")
    if path.endswith(".bz2"):
        import bz2
        return bz2.open(path, "rt", newline="")
    if path.endswith((".xz", ".lzma")):
        import lzma
        return lzma.open(path, "rt", newline="")
    return open(path, newline="")


class Session:
    def __init__(self, db: Database, user: Optional[str] = None,
                 mesh=None):
        self.db = db
        # row mesh for SPMD plan execution: explicit, or the process
        # default over the visible cards when config spmd_auto_mesh is on
        # (the reference's default, where mitosis sits in every session's
        # default_pipe, opt_pipes.c:76; off in the port: the thread mesh
        # over four cards was slower than one card, bench/mesh_cards.py)
        if mesh is None and getattr(getattr(db, "device", None), "type",
                                    None) == "cuda":
            from .parallel import default_mesh
            mesh = default_mesh()
        check_mesh(mesh)
        self.mesh = mesh
        # authenticated user; None = embedded/admin session (the reference
        # gives monetdbe the admin role the same way)
        self.user = user
        self.role: Optional[str] = None
        # plan cache (the reference's query cache, sql/server/sql_qc.c):
        # sql text → (schema_epoch, rel, out_cols)
        self._plan_cache: Dict[str, tuple] = {}
        # session variables (DECLARE/SET; sql_mvc.c mvc vars)
        self.vars: Dict[str, object] = {}
        # current schema (SET SCHEMA; sql_mvc.c cur_schema)
        self.current_schema = "sys"
        # re-entrancy guard for trigger cascades
        self._firing: set = set()
        # open snapshot-isolation transaction (sql_trans; one per session,
        # sql_mvc.c mvc->session->tr). None = autocommit.
        self.txn = None

    def _store(self):
        """DML/DDL target: the session transaction when one is open,
        else the shared autocommit store."""
        return self.txn if self.txn is not None else self.db

    def _td(self, name: str):
        """Transaction-visible TableData (the snapshot's version when a
        transaction is open)."""
        n = name.lower()
        if self.txn is not None:
            return self.txn.tabledata(n)
        return self.db.tables[n]

    def close(self) -> None:
        if self.txn is not None:
            self.txn.rollback()
            self.txn = None

    def _scalar_value(self, expr):
        """Evaluate a bound-free scalar expression (constant or scalar
        subquery) — DDL argument positions like ALTER SEQUENCE RESTART
        WITH (SELECT ...) (sql_parser.y opt_seq_param)."""
        from .plan.exprs import Const, Subquery
        if isinstance(expr, Const):
            return expr.value
        if isinstance(expr, Subquery):
            from .sql.binder import Binder
            rel, cols = Binder(self._catalog()).bind(expr.select)
            res = self._engine().execute_plan(rel, cols)
            if not res.rows or res.rows[0][0] is None:
                raise BindError("scalar subquery returned no value")
            return res.rows[0][0]
        raise BindError(f"unsupported scalar expression {expr!r}")

    def _catalog(self):
        cat = self.db.catalog(txn=self.txn)
        cat.vars = self.vars
        if not self.db.is_admin(self.user):
            cat.access = (self.user, self.role, self.db)
        return cat

    def _engine(self) -> Engine:
        """An Engine over the session-visible catalog, sharing the
        session mesh so eligible plans run SPMD (mitosis-by-default)."""
        return Engine(self._catalog(), mesh=self.mesh, spmd_auto=True)

    def _check_priv(self, table: str, priv: str) -> None:
        """Table privilege enforcement (sql_privileges.c table_privs)."""
        if self.db.is_admin(self.user):
            return
        t = table.lower()
        if self.db.owners.get(t) == self.user.lower():
            return
        if priv not in self.db.effective_privs(self.user, t, self.role):
            raise PermissionError(
                f"access denied for {self.user} to {priv} on {table}")

    # per-session query timeout in seconds (sys.setquerytimeout analog)
    timeout: Optional[float] = None

    def _exec_prepared(self, text: str):
        """EXEC[UTE] id(args) / DEALLOCATE [PREPARE] {id|ALL}; `**` means
        the most recent PREPARE (the mclient test convention,
        clients/mapiclient/mclient.c:2374)."""
        import re as _re
        prepared = getattr(self, "_prepared", {})
        kw, _, rest = text.partition(" ")
        rest = rest.strip().rstrip(";").strip()
        if kw.lower() == "deallocate":
            rest = _re.sub(r"(?i)^prepare\s+", "", rest)
            if rest == "**":
                if not prepared:
                    raise BindError("07003!no prepared statement")
                prepared.pop(max(prepared))
            elif rest.lower() == "all":
                prepared.clear()
            else:
                if int(rest) not in prepared:
                    raise BindError(
                        f"07003!no prepared statement {rest}")
                prepared.pop(int(rest))
            return None
        m = _re.match(r"(\*\*|\d+)\s*\((.*)\)\s*$", rest, _re.S)
        if not m:
            raise BindError(f"07003!bad EXEC syntax: {rest[:40]}")
        pid = max(prepared) if m.group(1) == "**" else int(m.group(1))
        ent = prepared.get(pid) if prepared else None
        if ent is None:
            raise BindError(f"07003!no prepared statement {pid}")
        # split args on top-level commas (respecting quotes/parens)
        args, buf, depth, q = [], [], 0, None
        for ch in m.group(2):
            if q:
                buf.append(ch)
                if ch == q:
                    q = None
            elif ch in "'\"":
                q = ch
                buf.append(ch)
            elif ch == "(":
                depth += 1
                buf.append(ch)
            elif ch == ")":
                depth -= 1
                buf.append(ch)
            elif ch == "," and depth == 0:
                args.append("".join(buf).strip())
                buf = []
            else:
                buf.append(ch)
        if "".join(buf).strip():
            args.append("".join(buf).strip())
        if len(args) != ent["nparams"]:
            raise BindError(
                f"07001!EXEC: expected {ent['nparams']} parameters, "
                f"got {len(args)}")
        # substitute '?' placeholders (outside string literals) in order
        out, q, it = [], None, iter(args)
        for ch in ent["text"]:
            if q:
                out.append(ch)
                if ch == q:
                    q = None
            elif ch in "'\"":
                q = ch
                out.append(ch)
            elif ch == "?":
                out.append("(" + next(it) + ")")
            else:
                out.append(ch)
        return self._sql("".join(out))

    def _try_interp_call(self, stmt):
        """SELECT f(args) over an interpreted PSM function (no FROM,
        constant args): run the body through the PSM interpreter and
        return its value as a one-row result."""
        from .plan.exprs import Const as _C, Func as _F
        if stmt.sources or stmt.where is not None or stmt.group_by or \
                len(stmt.items) != 1:
            return None
        _alias, e = stmt.items[0]
        if not isinstance(e, _F):
            return None
        f = self.db.sqlfuncs.get(e.name.split(".")[-1].lower())
        if f is None or f.get("kind") != "interp":
            return None
        if len(e.args) != len(f["params"]):
            raise BindError(
                f"function {e.name} expects {len(f['params'])} args")
        # non-constant arguments (e.g. scalar subqueries) evaluate
        # through the engine before the body runs (call-by-value)
        from .plan.exprs import ColRef as _CRef, walk as _walk
        args = []
        for a in e.args:
            if isinstance(a, _C):
                args.append(a)
                continue
            if any(isinstance(x, _CRef) for x in _walk(a)):
                return None     # row-dependent call: not interpretable
            res = self._engine().query_stmt(
                A.SelectStmt(items=[(None, a)], sources=[]))
            args.append(_C(res.rows[0][0] if res.rows else None))
        e = type(e)(e.name, args)
        from .sql.psm import run_psm_body
        from .storage.columns import tag_type
        env = {}
        for (pn, tg), a in zip(f["params"], args):
            v = a.value
            pt = tag_type(tg)
            if pt.kind in (Kind.DATE, Kind.TIME, Kind.TIMESTAMP) and \
                    isinstance(v, (int, float)):
                raise BindError(
                    f"22007!invalid {pt.kind.value} value for "
                    f"parameter {pn}")
            env[pn] = v
        val = run_psm_body(self, f["body"], env)
        rt = tag_type(f["ret"]) if f.get("ret") else None
        return Result([e.name], [rt], [(val,)])

    def _check_access(self, table: str, op: str) -> None:
        """Enforce ALTER TABLE SET READ ONLY / INSERT ONLY (sql_cat.c
        access modes): read_only blocks all writes, insert_only blocks
        update/delete."""
        mode = self.db.table_access.get(table.lower().split(".")[-1])
        if mode == "read_only" or (mode == "insert_only"
                                   and op in ("update", "delete")):
            raise PermissionError(
                f"42000!{op.upper()}: access denied: table "
                f"'{table}' is {mode.replace('_', ' ')}")

    # -- entry ----------------------------------------------------------------
    def sql(self, text: str,
            copy_data: Optional[str] = None) -> Union[Result, int, None]:
        """The profiler's ``sql`` span, whose query id is the statement's
        ``sys.queue`` tag; it records under TRACE."""
        from .sql.syscat import CURRENT_QUERY, QUEUE
        trace = text.lstrip()[:6].lower() == "trace "
        with PROFILER.record(trace), \
                PROFILER.span("sql", "sql_ns", root=True) as sp:
            tag = sp.query = QUEUE.start(text, self.timeout)
            CURRENT_QUERY.tag = tag
            try:
                out = self._sql(text, copy_data=copy_data)
            except Exception:
                QUEUE.finish(tag, "aborted")
                raise
            finally:
                CURRENT_QUERY.tag = None
            QUEUE.finish(tag)
            return out

    def _sql(self, text: str,
             copy_data: Optional[str] = None) -> Union[Result, int, None]:
        head = text.lstrip().lower()
        if head.startswith(("explain ", "plan ")):
            body = text.lstrip().split(None, 1)[1]
            rel, _cols = bind_select(self._catalog(), body)
            lines = rel.show().split("\n")
            from .dtypes import varchar
            return Result(["plan"], [varchar()], [(ln,) for ln in lines])
        if head.startswith("trace "):
            body = text.lstrip().split(None, 1)[1]
            res = self._engine().query(body, trace=True)
            from .dtypes import I64, varchar
            rows = [(e.get("usec", 0), e.get("rows", 0),
                     e.get("algorithm", ""), e.get("label", e["op"]))
                    for e in (res.trace or [])]
            return Result(["usec", "rows", "algorithm", "statement"],
                          [I64, I64, varchar(), varchar()], rows,
                          trace=res.trace)
        if head.startswith(("prepare ", "prep ")):
            # PREPARE <stmt> (sql_parser.y PREPARE; query cache entry,
            # sql_qc.c): validate, count '?' params, remember by id
            body = text.lstrip().split(None, 1)[1]
            from .sql.parser import Parser as _P
            p = _P(body)
            ps = p.parse_stmt()
            if isinstance(ps, A.SelectStmt):
                # validate semantics at PREPARE time, as the reference
                # compiles the full plan (sql_qc.c); a bare untyped
                # parameter in output position cannot be planned
                from .plan.exprs import Param as _Param
                for _al, it in ps.items:
                    if isinstance(it, _Param):
                        raise BindError(
                            "42000!PREPARE: untyped parameter in "
                            "output position")
                if p.n_params == 0:
                    bind_select(self._catalog(), ps)
            pid = self._next_prep = getattr(self, "_next_prep", 0) + 1
            if not hasattr(self, "_prepared"):
                self._prepared = {}
            self._prepared[pid] = {"text": body, "nparams": p.n_params}
            return None
        if head.startswith(("exec ", "execute ", "deallocate")):
            return self._exec_prepared(text.lstrip())
        with PROFILER.span("sql.parse", "parse_ns"):
            stmt = parse(text)
        if isinstance(stmt, A.SelectStmt):
            interp = self._try_interp_call(stmt)
            if interp is not None:
                return interp
            return self._cached_query(text)
        if isinstance(stmt, A.NoOp):
            return None
        # schema-qualified DDL/DML targets: s.t → t over the single
        # physical namespace, remembering the schema (rel_schema.c
        # qname resolution)
        qschema = None
        if not isinstance(stmt, (A.CreateSchema, A.DropSchema,
                                 A.CreateUser, A.DropUser, A.CreateRole,
                                 A.DropRole, A.SetVar, A.CommentOn)):
            for attr in ("name", "table", "parent"):
                v = getattr(stmt, attr, None)
                if isinstance(v, str) and "." in v:
                    pre, bare = v.split(".", 1)
                    if pre.lower() in self.db.schemas and "." not in bare:
                        setattr(stmt, attr, bare)
                        qschema = pre.lower()
        if isinstance(stmt, A.CreateTable):
            flags = {c: f for c, _t, f in stmt.columns
                     if isinstance(f, dict)}
            checks = [f["check"] for f in flags.values()
                      if f.get("check")]
            if getattr(stmt, "checks", None) or \
                    getattr(stmt, "uniques", None):
                flags["#table"] = {}
                if getattr(stmt, "checks", None):
                    flags["#table"]["checks"] = [list(x)
                                                 for x in stmt.checks]
                    checks += [tx for _nm, tx in stmt.checks]
                if getattr(stmt, "uniques", None):
                    flags["#table"]["uniques"] = [list(u)
                                                  for u in stmt.uniques]
            for tx in checks:
                # validate: parses, and no subqueries (the reference
                # rejects them at DDL time, 42000)
                from .sql.parser import parse_expr as _pe
                from .plan.exprs import Subquery as _Sq, walk as _walk
                ex = _pe(tx)
                if any(isinstance(n, _Sq) for n in _walk(ex)):
                    raise BindError("42000!SELECT: subquery not allowed "
                                    "in CHECK constraint")
            if getattr(stmt, "fks", None) and self.txn is None:
                self._store().create_table(
                    stmt.name, [(c, t) for c, t, _f in stmt.columns],
                    flags, fks=stmt.fks)
            else:
                self._store().create_table(
                    stmt.name, [(c, t) for c, t, _f in stmt.columns],
                    flags)
                if getattr(stmt, "fks", None):
                    def _lk2(n):
                        try:
                            return self._td(n)
                        except KeyError:
                            return None
                    # inside an open txn the constraint is STAGED on the
                    # Transaction (installed at commit, gone on rollback
                    # - ADVICE r4 phantom-FK fix); autocommit registers
                    # directly
                    self._store().add_foreign_keys(stmt.name, stmt.fks,
                                                   lookup=_lk2)
            if self.user is not None:
                self.db.set_owner(stmt.name, self.user)
            self.db.set_table_schema(stmt.name,
                                     qschema or self.current_schema)
            return None
        if isinstance(stmt, A.CreateTableAs):
            res = self._engine().query_stmt(stmt.select)
            from .dtypes import varchar as _vc
            out_names = getattr(stmt, "columns", None) or res.names
            if len(out_names) != len(res.names):
                raise BindError("CREATE TABLE AS column list arity "
                                "mismatch")
            schema = [(n.lower(), t if t is not None else _vc())
                      for n, t in zip(out_names, res.types)]
            self._store().create_table(stmt.name, schema, {})
            if self.user is not None:
                self.db.set_owner(stmt.name, self.user)
            self.db.set_table_schema(stmt.name,
                                     qschema or self.current_schema)
            if stmt.with_data and res.rows:
                self._insert_rows(stmt.name, None,
                                  [list(r) for r in res.rows])
            return None
        if isinstance(stmt, A.Call):
            return self._call(stmt)
        if isinstance(stmt, A.CreateSequence):
            self.db.create_sequence(stmt.name, stmt.start, stmt.inc,
                                    getattr(stmt, "minv", None),
                                    getattr(stmt, "maxv", None))
            return None
        if isinstance(stmt, A.DropSequence):
            self.db.drop_sequence(stmt.name)
            return None
        if isinstance(stmt, A.CreateIndex):
            self.db.create_index(stmt.name, stmt.table, stmt.cols,
                                 stmt.unique)
            return None
        if isinstance(stmt, A.DropIndex):
            self.db.drop_index(stmt.name)
            return None
        if isinstance(stmt, A.AlterSequence):
            restart = stmt.restart
            if restart is not None and restart != "min" and \
                    not isinstance(restart, int):
                restart = int(self._scalar_value(restart))
            self.db.alter_sequence(stmt.name, restart, stmt.inc)
            return None
        if isinstance(stmt, A.CreateSchema):
            self.db.create_schema(stmt.name, stmt.auth,
                                  stmt.if_not_exists)
            return None
        if isinstance(stmt, A.DropSchema):
            self.db.drop_schema(stmt.name, stmt.if_exists, stmt.cascade)
            return None
        if isinstance(stmt, A.AlterRenameSchema):
            if getattr(stmt, "if_exists", False) and \
                    stmt.schema.lower() not in self.db.schemas:
                return None
            self.db.rename_schema(stmt.schema, stmt.new_name)
            if self.current_schema == stmt.schema.lower():
                self.current_schema = stmt.new_name.lower()
            return None
        if isinstance(stmt, A.AlterSetSchema):
            # ALTER TABLE t SET SCHEMA s2 (sql_cat.c sql_set_table_schema)
            t = stmt.table.lower()
            s2 = stmt.new_schema.lower()
            if s2 not in self.db.schemas:
                raise ValueError(f"3F000!ALTER TABLE: no such schema "
                                 f"'{s2}'")
            self._td(t)                    # raises for unknown table
            if self.db._sql_mentions(t):
                raise ValueError(
                    f"2BM37!ALTER TABLE: unable to set schema of table "
                    f"'{t}', there are database objects which depend "
                    f"on it")
            if self.txn is not None:
                # staged: visible in this txn, applied at commit,
                # discarded on rollback
                self.txn.schema_moves[t] = s2
            else:
                self.db.set_table_schema(t, s2)
            return None
        if isinstance(stmt, A.DropTable):
            n = stmt.name.lower()
            if n in self.db.merges or n in self.db.remotes \
                    or n in self.db.replicas:
                self.db.drop_dist_def(n)
            else:
                self._store().drop_table(stmt.name,
                                         getattr(stmt, "if_exists", False))
            if self.txn is None:
                # txn drops keep the mapping: ROLLBACK restores the
                # table, and a committed drop's residue is overwritten
                # by any later CREATE (set_table_schema)
                self.db.table_schemas.pop(n, None)
            return None
        if isinstance(stmt, A.CreateView):
            # validate the view body binds against the current catalog
            bind_select(self._catalog(), stmt.select_sql)
            self.db.create_view(stmt.name, stmt.select_sql,
                                replace=getattr(stmt, "replace", False))
            self.db.set_table_schema(stmt.name,
                                     qschema or self.current_schema)
            return None
        if isinstance(stmt, A.DropView):
            self.db.drop_view(stmt.name)
            return None
        if isinstance(stmt, (A.CreateMergeTable, A.CreateRemoteTable,
                             A.CreateReplicaTable, A.AlterAddTable,
                             A.AlterDropTable)):
            return self._dist_ddl(stmt)
        if isinstance(stmt, A.CreateFunction):
            if stmt.language == "sql_interp":
                # control-flow body: validated by the PSM block parser,
                # interpreted per call (rel_psm.c)
                from .sql.psm import (parse_blocks, strip_line_comments,
                                      validate_body,
                                      _split_stmts as _ss)
                validate_body(parse_blocks(
                    _ss(strip_line_comments(stmt.body)))[0])
                self.db.create_sqlfunc(
                    stmt.name, [(n.lower(), t) for n, t in stmt.params],
                    stmt.ret_type, stmt.body, kind="interp")
                return None
            if stmt.language == "sql_table":
                # validate the body parses as a SELECT
                from .sql.parser import parse as _p
                _p(stmt.body)
                self.db.create_sqlfunc(
                    stmt.name, [(n.lower(), t) for n, t in stmt.params],
                    None, stmt.body, kind="table",
                    cols=[(n.lower(), t) for n, t in (stmt.cols or [])])
                return None
            if stmt.language == "sql":
                # validate the body parses
                from .sql.parser import parse_expr
                parse_expr(stmt.body)
                self.db.create_sqlfunc(
                    stmt.name, [(n.lower(), t) for n, t in stmt.params],
                    stmt.ret_type, stmt.body)
                return None
            from .udf import compile_python_udf
            u = compile_python_udf(stmt.name,
                                   [n.lower() for n, _t in stmt.params],
                                   [t for _n, t in stmt.params],
                                   stmt.ret_type, stmt.body)
            self.db.create_function(u)
            return None
        if isinstance(stmt, A.DropFunction):
            self.db.drop_function(stmt.name)
            return None
        if isinstance(stmt, A.TxnStmt):
            if stmt.kind == "begin":
                if self.txn is not None:
                    raise RuntimeError("nested transactions unsupported")
                self.txn = self.db.begin_txn()
            elif stmt.kind == "commit":
                if self.txn is None:
                    raise RuntimeError("no transaction")
                t, self.txn = self.txn, None
                t.commit()
            elif stmt.kind in ("savepoint", "rollback_to", "release"):
                if self.txn is None:
                    raise RuntimeError(
                        "25001!SAVEPOINT outside a transaction")
                getattr(self.txn, {"savepoint": "savepoint",
                                   "rollback_to": "rollback_to",
                                   "release": "release"}[stmt.kind])(
                    stmt.savepoint)
            else:
                if self.txn is None:
                    raise RuntimeError("no transaction")
                t, self.txn = self.txn, None
                t.rollback()
            return None
        if isinstance(stmt, (A.AddUniqueKey, A.AddForeignKey,
                             A.AlterSetAccess, A.AlterSetSchema,
                             A.AlterAddColumn, A.AlterDropColumn,
                             A.AlterRenameColumn, A.AlterRenameTable)) \
                and getattr(stmt, "if_exists", False):
            # ALTER TABLE IF EXISTS on an absent table: no-op
            t = getattr(stmt, "table", None) or getattr(stmt, "parent",
                                                        None)
            if t is not None:
                try:
                    self._td(t)
                except KeyError:
                    return None
        if isinstance(stmt, A.AddUniqueKey):
            self.db.add_unique_key(stmt.table, stmt.cols, stmt.pk)
            return None
        if isinstance(stmt, A.AddForeignKey):
            def _lk(n):
                try:
                    return self._td(n)
                except KeyError:
                    return None
            self.db.add_foreign_keys(
                stmt.table, [[stmt.cols, stmt.rtable, stmt.rcols,
                              getattr(stmt, "action", "restrict")]],
                lookup=_lk)
            return None
        if isinstance(stmt, A.AlterSetAccess):
            t = stmt.table.lower()
            if t not in self.db.tables:
                raise BindError(f"no such table {stmt.table}")
            self.db.table_access[t] = stmt.mode
            return None
        if isinstance(stmt, A.MergeStmt):
            return self._merge(stmt)
        if isinstance(stmt, A.InsertValues):
            self._check_access(stmt.table, "insert")
            return self._insert_values(stmt)
        if isinstance(stmt, A.InsertSelect):
            self._check_access(stmt.table, "insert")
            return self._insert_select(stmt)
        if isinstance(stmt, A.Delete):
            self._check_access(stmt.table, "delete")
            return self._delete(stmt)
        if isinstance(stmt, A.Update):
            self._check_access(stmt.table, "update")
            return self._update(stmt)
        if isinstance(stmt, A.CopyFrom):
            self._check_access(stmt.table, "insert")
            if copy_data is not None:
                stmt.data = copy_data
            return self._copy(stmt)
        if isinstance(stmt, A.CopyInto):
            return self._copy_into(stmt)
        if isinstance(stmt, A.CopyBinaryFrom):
            self._check_access(stmt.table, "insert")
            return self._copy_binary(stmt)
        if isinstance(stmt, A.Truncate):
            self._check_access(stmt.table, "delete")
            return self._delete(A.Delete(stmt.table, None))
        if isinstance(stmt, A.AlterAddColumn):
            fill = None
            flags = dict(stmt.flags)
            dflt = flags.get("default")
            if dflt is not None:
                fill = self._default_value(dflt, stmt.ctype)
            from .storage.columns import to_physical_np as _phys
            pf = None if fill is None else \
                (_phys([fill], stmt.ctype)[0] if stmt.ctype.kind != Kind.STR
                 else str(fill))
            if pf is not None and isinstance(pf, np.generic):
                pf = pf.item()
            self._store().alter_add_column(stmt.table, stmt.column, stmt.ctype,
                                     flags, pf)
            return None
        if isinstance(stmt, A.AlterDropColumn):
            self._store().alter_drop_column(stmt.table, stmt.column)
            return None
        if isinstance(stmt, A.AlterRenameColumn):
            self._store().alter_rename_column(stmt.table, stmt.column,
                                        stmt.new_name)
            return None
        if isinstance(stmt, A.AlterRenameTable):
            self._store().alter_rename_table(stmt.table, stmt.new_name)
            return None
        if isinstance(stmt, A.CreateTrigger):
            if stmt.table.lower() not in self.db.tables:
                raise BindError(f"unknown table {stmt.table}")
            self.db.create_trigger(stmt.name, stmt.table, stmt.time,
                                   stmt.event, stmt.body_sql,
                                   replace=getattr(stmt, "replace", False))
            return None
        if isinstance(stmt, A.DropTrigger):
            self.db.drop_trigger(stmt.name)
            return None
        if isinstance(stmt, A.CreateProcedure):
            self.db.create_procedure(stmt.name, stmt.params, stmt.body_sql)
            return None
        if isinstance(stmt, A.DropProcedure):
            self.db.drop_procedure(stmt.name)
            return None
        if isinstance(stmt, A.CommentOn):
            kind = stmt.kind.lower()
            target = stmt.target.lower()
            if kind in ("table", "view", "sequence", "index") and \
                    "." in target:
                target = target.rsplit(".", 1)[1]   # strip schema qualifier
            if kind == "column" and target.count(".") > 1:
                target = ".".join(target.rsplit(".", 2)[-2:])
            if kind == "schema":
                s = self.db.schemas.get(target)
                if s is None:
                    raise BindError(f"unknown schema {target}")
                # only the owner (or an admin) may comment
                # (sql_privileges.c mvc_schema_privs)
                if self.user is not None and \
                        not self.db.is_admin(self.user) and \
                        s.get("auth") not in (self.user, self.role):
                    raise PermissionError(
                        f"insufficient privileges for schema {target}")
            self.db.put_comment(f"{kind}:{target}", stmt.text)
            return None
        if isinstance(stmt, A.Analyze):
            # stats derive on materialization; refresh = drop cached device
            # columns + invalidate plans (sql/scripts/80_statistics.sql)
            self.db._device.clear()
            self.db.schema_epoch += 1
            return None
        if isinstance(stmt, A.SetVar):
            if stmt.name == "#role":
                role = str(stmt.value.value).lower()
                if not self.db.is_admin(self.user):
                    u = (self.user or "").lower()
                    if u not in self.db.roles.get(role, []):
                        raise PermissionError(
                            f"role {role} not granted to {self.user}")
                self.role = role
                return None
            if stmt.name == "#schema":
                sc = str(stmt.value.value).lower()
                if sc not in self.db.schemas:
                    raise BindError(f"unknown schema {sc}")
                self.current_schema = sc
                return None
            self.vars[stmt.name.lower()] = self._default_eval(stmt.value)
            return None
        if isinstance(stmt, A.CreateUser):
            self._require_admin("CREATE USER")
            self.db.create_user(stmt.name.lower(), stmt.password)
            return None
        if isinstance(stmt, A.DropUser):
            self._require_admin("DROP USER")
            self.db.drop_user(stmt.name.lower())
            return None
        if isinstance(stmt, A.CreateRole):
            self._require_admin("CREATE ROLE")
            self.db.create_role(stmt.name)
            return None
        if isinstance(stmt, A.DropRole):
            self._require_admin("DROP ROLE")
            self.db.drop_role(stmt.name)
            return None
        if isinstance(stmt, A.Grant):
            self._require_admin_or_owner(stmt if stmt.role else stmt.table)
            if stmt.role:
                self.db.grant_role(stmt.table, stmt.grantee)
            else:
                self.db.grant([p.lower() for p in stmt.privs], stmt.table,
                              stmt.grantee)
            return None
        if isinstance(stmt, A.Revoke):
            self._require_admin_or_owner(stmt if stmt.role else stmt.table)
            if stmt.role:
                self.db.revoke_role(stmt.table, stmt.grantee)
            else:
                self.db.revoke([p.lower() for p in stmt.privs], stmt.table,
                               stmt.grantee)
            return None
        if isinstance(stmt, A.DeclareVar):
            self.vars.setdefault(stmt.name.lower(), None)
            return None
        raise BindError(f"unsupported statement {type(stmt).__name__}")

    def _default_eval(self, expr):
        """Evaluate a bound-free scalar expression (SET var, DEFAULT):
        constants fold directly; anything else runs as SELECT <expr>."""
        try:
            return self._const_value(expr)
        except BindError:
            sel = A.SelectStmt(items=[(None, expr)], sources=[])
            res = self._engine().query_stmt(sel)
            return res.rows[0][0]

    def _default_value(self, sql_text: str, typ):
        from .sql.parser import parse_expr
        v = self._default_eval(parse_expr(sql_text))
        return v

    def _require_admin(self, what: str) -> None:
        if not self.db.is_admin(self.user):
            raise PermissionError(f"{what} requires administrator")

    def _require_admin_or_owner(self, table) -> None:
        if self.db.is_admin(self.user):
            return
        if isinstance(table, str) and \
                self.db.owners.get(table.lower()) == \
                (self.user or "").lower():
            return
        raise PermissionError("GRANT/REVOKE requires admin or owner")

    # -- statement-level triggers (rel_schema.c create_trigger) -----------
    def _fire_triggers(self, table: str, event: str, time: str) -> None:
        table = table.lower()
        for name, t in list(self.db.triggers.items()):
            if t["table"] != table or t["event"] != event \
                    or t["time"] != time:
                continue
            key = (name, event)
            if key in self._firing:        # no cascading re-entry
                continue
            self._firing.add(key)
            try:
                for stmt_text in _split_statements(t["body"]):
                    self._sql(stmt_text)
            finally:
                self._firing.discard(key)

    def query(self, text: str) -> Result:
        return self._cached_query(text)

    def _cached_query(self, text: str) -> Result:
        with PROFILER.span("sql.bind", "bind_ns"):
            eng = self._engine()
            rel, out_cols = self._bound(eng, text)
        return eng.execute_plan(rel, out_cols)

    def _bound(self, eng: Engine, text: str):
        """The bound plan of ``text``, from the session's plan cache."""
        if self.txn is not None:
            # inside a transaction the visible schema may differ from the
            # committed one (transactional CREATE/DROP) — bypass the cache
            # (the reference invalidates qc entries on trans schema changes)
            return bind_select(eng.catalog, text)
        key = " ".join(text.split())
        hit = self._plan_cache.get(key)
        if hit is not None and hit[0] == self.db.schema_epoch:
            return hit[1], hit[2]
        rel, out_cols = bind_select(eng.catalog, text)
        self._plan_cache[key] = (self.db.schema_epoch, rel, out_cols)
        return rel, out_cols

    # -- prepared statements (sql_qc.c prepared-query entries) ----------------
    def prepare(self, text: str) -> "Prepared":
        return Prepared(self, text)


    # -- procedures (sysmon: sql/scripts/26_sysmon.sql) --------------------
    def _call(self, stmt) -> None:
        from .sql.syscat import QUEUE
        name = stmt.name.lower()
        args = [self._const_value(a) for a in stmt.args]
        if name in ("sys.stop", "stop"):
            QUEUE.stop(int(args[0]))
            return None
        if name in ("sys.setquerytimeout", "setquerytimeout"):
            self.timeout = float(args[0]) or None
            return None
        if name in ("sys.settimeout", "settimeout"):
            self.timeout = float(args[0]) or None
            return None
        proc = self.db.procedures.get(name.split(".")[-1])
        if proc is not None:
            # full PSM interpretation: DECLARE/SET/IF/WHILE/RETURN plus
            # arbitrary side-effecting statements (rel_psm.c)
            from .sql.psm import run_psm_body
            env = {pname: val for (pname, _tag), val
                   in zip(proc["params"], args)}
            run_psm_body(self, proc["body"], env)
            return None
        raise BindError(f"unknown procedure {stmt.name}")

    # -- distribution DDL (merge/remote/replica; rel_schema.c analog) ------
    def _schema_of(self, name: str):
        n = name.lower()
        try:
            td = self._td(n)
            return [(c, td.types[c]) for c in td.order]
        except KeyError:
            pass
        for dd in (self.db.merges, self.db.remotes, self.db.replicas):
            if n in dd:
                return dd[n].schema
        raise BindError(f"unknown table {name}")

    def _dist_ddl(self, stmt):
        from .sql.distribute import MergeDef, PartSpec, RemoteDef, ReplicaDef
        from .storage.columns import type_tag
        if isinstance(stmt, A.CreateMergeTable):
            schema = [(c.lower(), t) for c, t, _nn in stmt.columns]
            pc = stmt.part_col.lower() if stmt.part_col else None
            if pc is not None and pc not in dict(schema):
                raise BindError(f"partition column {pc} not in schema")
            self.db.put_dist_def(MergeDef(stmt.name.lower(), schema,
                                          stmt.part_kind, pc))
            return None
        if isinstance(stmt, A.CreateRemoteTable):
            schema = [(c.lower(), t) for c, t, _nn in stmt.columns]
            loc = stmt.addr
            user = password = None
            if "@" in loc:        # 'user:password@host:port/table'
                creds, _, loc = loc.rpartition("@")
                user, _, password = creds.partition(":")
            addr, _, rtable = loc.partition("/")
            self.db.put_dist_def(RemoteDef(stmt.name.lower(), schema, addr,
                                           rtable or stmt.name.lower(),
                                           user, password))
            return None
        if isinstance(stmt, A.CreateReplicaTable):
            schema = [(c.lower(), t) for c, t, _nn in stmt.columns]
            self.db.put_dist_def(ReplicaDef(stmt.name.lower(), schema))
            return None
        if isinstance(stmt, A.AlterDropTable):
            p = stmt.parent.lower()
            d = self.db.merges.get(p) or self.db.replicas.get(p)
            if d is None:
                raise BindError(f"{stmt.parent} is not a merge/replica table")
            m = stmt.member.lower()
            if isinstance(d, MergeDef):
                d.members = [(n, s) for n, s in d.members if n != m]
            else:
                d.members = [n for n in d.members if n != m]
            self.db.put_dist_def(d)
            return None
        # AlterAddTable
        p = stmt.parent.lower()
        m = stmt.member.lower()
        d = self.db.merges.get(p) or self.db.replicas.get(p)
        if d is None:
            raise BindError(f"{stmt.parent} is not a merge/replica table")
        mschema = self._schema_of(m)
        want = [(n, type_tag(t)) for n, t in d.schema]
        have = [(n, type_tag(t)) for n, t in mschema]
        if want != have:
            raise BindError(
                f"member {m} schema {have} does not match {p} {want}")
        if isinstance(d, ReplicaDef):
            d.members = [x for x in d.members if x != m] + [m]
            self.db.put_dist_def(d)
            return None
        spec = None
        if stmt.part_range is not None:
            lo = self._const_value(stmt.part_range[0])
            hi = self._const_value(stmt.part_range[1])
            spec = PartSpec(lo=lo, hi=hi)
        elif stmt.part_values is not None:
            spec = PartSpec(values=[self._const_value(e)
                                    for e in stmt.part_values])
        elif stmt.part_nulls:
            spec = PartSpec(nulls=True)
        if d.part_col is not None and spec is None:
            raise BindError(
                f"{p} is partitioned: AS PARTITION clause required")
        d.members = [(n, s) for n, s in d.members if n != m] + [(m, spec)]
        self.db.put_dist_def(d)
        return None

    def _const_value(self, e):
        from .plan.exprs import Func
        if isinstance(e, Const):
            return e.value
        if isinstance(e, Func) and e.name == "neg":
            return -self._const_value(e.args[0])
        if isinstance(e, Func) and e.name == "next_value_for":
            return self.db.next_sequence_block(e.args[0].value, 1)
        raise BindError("INSERT VALUES must be constants")

    def _insert_values(self, stmt: A.InsertValues) -> int:
        rows = [[self._default_eval(e) for e in r] for r in stmt.rows]
        cols = [c.lower() for c in stmt.columns] if stmt.columns else None
        return self._insert_rows(stmt.table, cols, rows)

    def _insert_select(self, stmt: A.InsertSelect) -> int:
        res = self._engine().query_stmt(stmt.select)
        cols = [c.lower() for c in stmt.columns] if stmt.columns else None
        want = cols or [n for n, _t in self._schema_of(stmt.table)]
        if len(want) != len(res.names):
            raise BindError("INSERT SELECT arity mismatch")
        return self._insert_rows(stmt.table, cols,
                                 [list(r) for r in res.rows])

    def _insert_rows(self, table: str, cols, rows) -> int:
        """Insert logical-value rows, routing through merge partitions
        (rel_propagate.c) and remote tables (shipping INSERT SQL) before
        landing on local storage."""
        n = table.lower()
        mdef = self.db.merges.get(n)
        if mdef is not None:
            from .sql.distribute import route_partition
            order = cols or [c for c, _t in mdef.schema]
            if mdef.part_col is None:
                raise BindError(
                    f"cannot insert into unpartitioned merge table {n}")
            pi = order.index(mdef.part_col)
            by_member: Dict[str, list] = {}
            for r in rows:
                by_member.setdefault(
                    route_partition(mdef, r[pi]), []).append(r)
            return sum(self._insert_rows(m, cols, rs)
                       for m, rs in by_member.items())
        rdef = self.db.remotes.get(n)
        if rdef is not None:
            from .server import Client
            from .sql.distribute import _sql_value
            collist = f" ({', '.join(cols)})" if cols else ""
            vals = ", ".join(
                "(" + ", ".join(_sql_value(v) for v in r) + ")"
                for r in rows)
            host, port = rdef.addr.rsplit(":", 1)
            cl = Client(host, int(port), rdef.user, rdef.password)
            try:
                return cl.sql(
                    f"insert into {rdef.rtable}{collist} values {vals}")
            finally:
                cl.close()
        td = self._td(n)
        if not rows:
            return 0            # INSERT ... SELECT over an empty result
        arity = self._row_arity(rows)
        if cols is not None:
            names = cols
        elif arity == len(td.order):
            names = td.order
        elif arity == len(td.order) - len(td.serials):
            # serial columns omitted: values map to the non-serial columns
            names = [c for c in td.order if c not in td.serials]
        else:
            raise BindError(
                f"INSERT arity {arity} does not match {n}({len(td.order)})")
        if arity != len(names):
            raise BindError(
                f"INSERT arity {arity} does not match column list "
                f"{len(names)}")
        self._check_priv(n, "insert")
        self._fire_triggers(n, "insert", "before")
        arrays: Dict[str, np.ndarray] = {}
        for j, c in enumerate(names):
            arrays[c] = to_physical_np([r[j] for r in rows], td.types[c])
        for c in td.order:
            if c in arrays:
                continue
            if c in td.defaults and c not in td.serials:
                # DEFAULT expression fills omitted columns (rel_updates.c
                # insert defaults)
                v = self._default_value(td.defaults[c], td.types[c])
                arrays[c] = to_physical_np([v] * len(rows), td.types[c])
                continue
            if c in td.serials:
                # auto-fill from the column's sequence (serial /
                # auto_increment; store_sequence.c)
                seq = self.db.sequences[td.serials[c]]
                first = self.db.next_sequence_block(td.serials[c],
                                                    len(rows))
                vals = first + np.arange(len(rows), dtype=np.int64) \
                    * seq["inc"]
                arrays[c] = vals.astype(td.types[c].np_dtype)
            else:
                arrays[c] = to_physical_np([None] * len(rows), td.types[c])
        out = self._store().insert(n, arrays)
        self._fire_triggers(n, "insert", "after")
        return out

    @staticmethod
    def _row_arity(rows) -> int:
        return len(rows[0]) if rows else 0

    # -- MERGE INTO (rel_updates.c merge plans) -----------------------------
    def _merge(self, stmt: A.MergeStmt) -> int:
        """One LEFT JOIN pass over source × target computes, per source
        row, the matched target oid (NULL = not matched) plus the WHEN
        branch expressions; the three actions then apply through the
        session's store (txn-aware)."""
        tname = stmt.target.lower()
        if stmt.matched is not None:
            self._check_priv(
                tname, "delete" if stmt.matched[0] == "delete"
                else "update")
        if stmt.not_matched is not None:
            self._check_priv(tname, "insert")
        td = self._td(tname)
        src = A.TableSource(stmt.source, stmt.source_alias) \
            if isinstance(stmt.source, str) \
            else A.SubquerySource(stmt.source, stmt.source_alias)
        items = [("_tgtrow", ColRef(stmt.target_alias, "__rowid__"))]
        sets = stmt.matched[1] if (stmt.matched is not None
                                   and stmt.matched[0] == "update") else []
        items += [(f"_set{i}", e) for i, (_c, e) in enumerate(sets)]
        ins_exprs = stmt.not_matched[1] if stmt.not_matched else []
        base_ins = 1 + len(sets)
        items += [(f"_ins{i}", e) for i, e in enumerate(ins_exprs)]
        join = A.JoinSource(src,
                            A.TableSource(stmt.target, stmt.target_alias),
                            "left", stmt.on)
        sel = A.SelectStmt(items=items, sources=[join])
        res = self._engine().query_stmt(sel)
        matched = [r for r in res.rows if r[0] is not None]
        oids = np.array([r[0] for r in matched], np.int64)
        if len(np.unique(oids)) != len(oids):
            raise ValueError(
                "40002!MERGE: multiple source rows match the same "
                "target row")
        n_changed = 0
        if stmt.matched is not None and len(oids):
            if stmt.matched[0] == "delete":
                n_changed += self._store().delete(tname, oids)
            else:
                for i, (c, _e) in enumerate(sets):
                    vals = to_physical_np([r[1 + i] for r in matched],
                                          td.types[c.lower()])
                    self._store().update(tname, c, oids, vals)
                n_changed += len(oids)
        if stmt.not_matched is not None:
            rows = [list(r[base_ins:]) for r in res.rows if r[0] is None]
            if rows:
                cols = [c.lower() for c in stmt.not_matched[0]] \
                    if stmt.not_matched[0] else None
                n_changed += self._insert_rows(tname, cols, rows)
        return n_changed

    # -- DELETE / UPDATE (oid selection runs through the query engine) --------
    def _select_oids(self, table: str, where,
                     extra_items=None) -> Result:
        items = [(None, ColRef(None, "__rowid__"))]
        items += extra_items or []
        sel = A.SelectStmt(items=items,
                           sources=[A.TableSource(table, table)],
                           where=where)
        return self._engine().query_stmt(sel)

    def _delete(self, stmt: A.Delete) -> int:
        self._check_priv(stmt.table, "delete")
        self._fire_triggers(stmt.table, "delete", "before")
        res = self._select_oids(stmt.table, stmt.where)
        oids = np.array([r[0] for r in res.rows], np.int64)
        if not len(oids):
            return 0
        out = self._store().delete(stmt.table, oids)
        self._fire_triggers(stmt.table, "delete", "after")
        return out

    def _update(self, stmt: A.Update) -> int:
        self._check_priv(stmt.table, "update")
        self._fire_triggers(stmt.table, "update", "before")
        td = self._td(stmt.table)
        extra = [(f"_set{i}", e) for i, (_c, e) in enumerate(stmt.sets)]
        res = self._select_oids(stmt.table, stmt.where, extra)
        if not res.rows:
            return 0
        oids = np.array([r[0] for r in res.rows], np.int64)
        checks = getattr(td, "checks", ())
        if checks:
            # CHECK on UPDATE: evaluate each predicate with the SET
            # expressions substituted for their columns over the matched
            # rows (equivalent to checking the post-update rows)
            import copy as _copy
            from .sql.binder import Binder as _B
            from .sql.parser import parse_expr as _pe
            from .plan.exprs import ColRef as _CR, Not as _Not
            set_map = {c.lower(): e for c, e in stmt.sets}

            def subst(e):
                if isinstance(e, _CR) and e.name.lower() in set_map and                         e.table in (None, stmt.table):
                    return _copy.deepcopy(set_map[e.name.lower()])
                kids = e.children()
                if not kids:
                    return e
                return _B._clone_with(None, e, [subst(k) for k in kids])

            extras = [(f"_chk{i}", _Not(subst(_pe(tx))))
                      for i, (_nm, tx) in enumerate(checks)]
            vres = self._select_oids(stmt.table, stmt.where, extras)
            for i, (cname, tx) in enumerate(checks):
                if any(bool(r[i + 1]) for r in vres.rows):
                    raise ValueError(
                        f"40002!UPDATE: violated constraint "
                        f"'sys.{cname}' CHECK({tx})")
        colvals = {}
        for i, (c, _e) in enumerate(stmt.sets):
            colvals[c.lower()] = to_physical_np(
                [r[i + 1] for r in res.rows], td.types[c.lower()])
        # FK / PK / UNIQUE / NOT NULL enforcement over the post-update
        # state (ADVICE r4: updates used to check only CHECK constraints;
        # the reference raises 40002 from the update path too)

        def _resolve(n):
            try:
                return self._td(n)
            except KeyError:
                return None
        self.db.check_update_constraints(
            td, oids, colvals, resolver=_resolve,
            extra_fks=getattr(self.txn, "fks_add", None))
        for c, vals in colvals.items():
            self._store().update(stmt.table, c, oids, vals)
        self._fire_triggers(stmt.table, "update", "after")
        return len(oids)

    # -- COPY INTO (tablet.c analog: native parallel parser with Python
    # fallback) ----------------------------------------------------------------
    def _copy(self, stmt: A.CopyFrom) -> int:
        td = self._td(stmt.table)
        if getattr(stmt, "data", None) is None and \
                stmt.path.lower() == "stdin":
            raise BindError("COPY FROM STDIN needs inline data")
        from .storage import csv_native
        native_ok = all(td.types[c].kind in (Kind.INT, Kind.DECIMAL,
                                             Kind.DATE, Kind.STR)
                        or td.types[c].np_dtype.kind == "f"
                        for c in td.order) \
            and getattr(stmt, "quote", None) is None \
            and getattr(stmt, "nullstr", None) is None \
            and getattr(stmt, "data", None) is None
        native_ok = native_ok and not stmt.path.endswith(
            (".gz", ".bz2", ".xz", ".lzma"))
        if native_ok and csv_native.native_available():
            with open(stmt.path, "rb") as f:
                data = f.read()
            schema = [(c, td.types[c]) for c in td.order]
            arrays = csv_native.parse_csv(data, stmt.delimiter, schema,
                                          stmt.records)
            n = len(next(iter(arrays.values()))) if arrays else 0
            if n == 0:
                return 0
            return self._store().insert(stmt.table, arrays)
        return self._copy_python(stmt)

    def _copy_python(self, stmt: A.CopyFrom) -> int:
        import io
        td = self._td(stmt.table)
        # optional column subset/order (COPY INTO t(cols); sql_parser.y
        # opt_column_list): unlisted columns fill with DEFAULT/NULL
        order = [c.lower() for c in getattr(stmt, "columns", None)
                 or td.order]
        for c in order:
            if c not in td.types:
                raise BindError(f"42S22!no such column {stmt.table}.{c}")
        cols: List[List] = [[] for _ in order]
        limit = stmt.records
        data = getattr(stmt, "data", None)
        quote = getattr(stmt, "quote", None)
        nullstr = getattr(stmt, "nullstr", None)
        f = io.StringIO(data) if data is not None \
            else _open_maybe_compressed(stmt.path)
        with f:
            kw = {"delimiter": stmt.delimiter}
            if quote is not None:
                kw["quotechar"] = quote
            else:
                # no quote spec: fields are raw text (tablet.c default)
                kw["quoting"] = csv.QUOTE_NONE
            rd = csv.reader(f, **kw)
            for i, row in enumerate(rd):
                if limit is not None and i >= limit:
                    break
                # MonetDB dumps may carry a trailing delimiter
                if len(row) == len(order) + 1 and row[-1] == "":
                    row = row[:-1]
                for j, v in enumerate(row):
                    if nullstr is not None and v == nullstr:
                        cols[j].append(None)
                        continue
                    cols[j].append(self._parse_field(v, td.types[order[j]]))
        arrays = {c: to_physical_np(vals, td.types[c])
                  for c, vals in zip(order, cols)}
        n0 = len(cols[0]) if cols else 0
        for c in td.order:
            if c in arrays or n0 == 0:
                continue
            # unlisted column: DEFAULT when declared, else NULL
            dflt = td.defaults.get(c)
            fill = self._default_value(dflt, td.types[c])                 if dflt is not None else None
            arrays[c] = to_physical_np([fill] * n0, td.types[c])
        n = len(cols[0]) if cols else 0
        if n == 0:
            return 0
        return self._store().insert(stmt.table, arrays)

    def _copy_into(self, stmt: A.CopyInto) -> int:
        """COPY ... INTO 'file': export result rows as delimited text in
        the reference's dump format (NULL for nils, trailing newline;
        sql_result.c mvc_export_table)."""
        if isinstance(stmt.source, str):
            res = self.query(f"select * from {stmt.source}")
        else:
            res = self._engine().query_stmt(stmt.source)
        with open(stmt.path, "w") as f:
            for row in res.rows:
                f.write(stmt.delimiter.join(
                    "NULL" if v is None else str(v) for v in row) + "\n")
        return len(res.rows)

    def _copy_binary(self, stmt: A.CopyBinaryFrom) -> int:
        """COPY BINARY INTO t FROM (files...): one file per column in
        declared order; .npy arrays or raw little-endian fixed-width
        (strings: one value per line, text)."""
        td = self._td(stmt.table)
        if len(stmt.paths) != len(td.order):
            raise BindError(
                f"expected {len(td.order)} files, got {len(stmt.paths)}")
        arrays: Dict[str, np.ndarray] = {}
        n = None
        for c, path in zip(td.order, stmt.paths):
            t = td.types[c]
            if path.endswith(".npy"):
                arr = np.load(path)
                if t.kind != Kind.STR:
                    arr = arr.astype(t.np_dtype, copy=False)
            elif t.kind == Kind.STR:
                with open(path) as f:
                    vals = f.read().splitlines()
                arr = to_physical_np(
                    [None if v == "NULL" else v for v in vals], t)
            else:
                arr = np.fromfile(path, dtype=t.np_dtype)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise BindError(
                    f"column file {path} has {len(arr)} rows, expected {n}")
            arrays[c] = arr
        if not n:
            return 0
        return self._store().insert(stmt.table, arrays)

    @staticmethod
    def _parse_field(v: str, t: SQLType):
        if v == "" or v.upper() == "NULL":
            return None if t.kind != Kind.STR else v
        if t.kind == Kind.STR:
            return v
        if t.kind == Kind.DATE:
            return datetime.date.fromisoformat(v)
        if t.kind == Kind.TIMESTAMP:
            return datetime.datetime.fromisoformat(v)
        if t.kind == Kind.TIME:
            return datetime.time.fromisoformat(v)
        if t.kind == Kind.DECIMAL:
            return PyDecimal(v)
        if t.np_dtype.kind == "f":
            return float(v)
        if t.kind == Kind.BOOL:
            return v.lower() in ("true", "t", "1")
        return int(v)


def _split_statements(text: str) -> List[str]:
    """Split ';'-separated SQL, respecting single-quoted strings."""
    out, buf, in_str = [], [], False
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == "'":
            in_str = not in_str
            buf.append(ch)
        elif ch == ";" and not in_str:
            s = "".join(buf).strip()
            if s:
                out.append(s)
            buf = []
        else:
            buf.append(ch)
        i += 1
    s = "".join(buf).strip()
    if s:
        out.append(s)
    return out


def _substitute_params(obj, params, _seen=None):
    """Replace Param nodes with Consts across a statement tree (generic
    dataclass/list/tuple reflection — covers every stmt/expr shape).
    Returns the (possibly new) object."""
    import dataclasses as _dc
    from .plan.exprs import Const, Param as _P

    if _seen is None:
        _seen = set()
    if isinstance(obj, _P):
        return Const(params[obj.index])
    if id(obj) in _seen:
        return obj
    _seen.add(id(obj))
    if isinstance(obj, list):
        for i, x in enumerate(obj):
            obj[i] = _substitute_params(x, params, _seen)
        return obj
    if isinstance(obj, tuple):
        return tuple(_substitute_params(x, params, _seen) for x in obj)
    if _dc.is_dataclass(obj) and not isinstance(obj, type):
        for f in _dc.fields(obj):
            setattr(obj, f.name,
                    _substitute_params(getattr(obj, f.name), params, _seen))
    return obj


class Prepared:
    """PREPARE/EXECUTE: parse once, substitute '?' parameters per run
    (reference: prepared statements through the query cache, sql_qc.c)."""

    def __init__(self, session: Session, text: str):
        from .sql.parser import Parser
        p = Parser(text)
        self.stmt_template = p.parse_stmt()
        self.n_params = p.n_params
        self.session = session

    def run(self, *params):
        import copy
        if len(params) != self.n_params:
            raise BindError(f"expected {self.n_params} parameters, "
                            f"got {len(params)}")
        stmt = copy.deepcopy(self.stmt_template)
        _substitute_params(stmt, list(params))
        if isinstance(stmt, A.SelectStmt):
            return Engine(self.session.db.catalog(), mesh=self.session.mesh,
                          spmd_auto=True).query_stmt(stmt)
        # prepared DML (the reference prepares any statement kind)
        if isinstance(stmt, A.InsertValues):
            return self.session._insert_values(stmt)
        if isinstance(stmt, A.Delete):
            return self.session._delete(stmt)
        if isinstance(stmt, A.Update):
            return self.session._update(stmt)
        raise BindError(
            f"unsupported prepared statement {type(stmt).__name__}")

    # -- INSERT ----------------------------------------------------------------