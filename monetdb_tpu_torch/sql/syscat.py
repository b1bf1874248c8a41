"""System catalog relations — sys.tables, sys.columns, sys.storage,
sys.env, sys.queue, sys.querylog, sys.tracelog.

Reference mapping: the bootstrap SQL schema (sql/scripts/
{77_storage,75_storagemodel,26_sysmon,15_querylog,91_information_schema}.sql)
over catalog BATs; sys.queue is mal_runtime.c QRYqueue via
monetdb5/modules/mal/sysmon.c; sys.storage is gdk introspection
(sql/backends/monet5/sql.c sql_storage). Here each relation is materialized
at bind time from the live catalog / runtime registries into columns on the
catalog's device.

Table type codes follow the reference's sys.tables.type domain
(sql/include/sql_catalog.h: 0=TABLE, 1=VIEW, 3=MERGE TABLE, 5=REMOTE TABLE,
6=REPLICA TABLE).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

from ..dtypes import BOOL, F64, I32, I64, Kind, varchar
from ..ops._tensor import catalog_device
from ..table import Catalog, Table

__all__ = ["system_table", "is_system_table", "QUEUE", "QueryKilled",
           "CURRENT_QUERY"]

_VC = varchar()


# ======================================================================
# sys.queue — running/recent query registry (QRYqueue, mal_runtime.c:34)
# ======================================================================
class QueryKilled(Exception):
    """Raised inside the executor when a query is stopped or times out
    (the reference's sysmon stop / querytimeout, mal_runtime.c)."""


class QueryQueue:
    """Global registry of queries: running + a bounded history ring.
    Supports cooperative stop and per-query deadlines — the executor
    calls check() between operators (the reference checks its QRYqueue
    status flag in the MAL interpreter loop the same way)."""

    def __init__(self, keep: int = 256):
        self.keep = keep
        self._next = 1
        self.running = {}            # tag → (sql, start_time)
        self.deadlines = {}          # tag → abs time
        self.stopped = set()
        self.finished: List[Tuple[int, str, float, float, str]] = []

    def start(self, sql: str, timeout: Optional[float] = None) -> int:
        tag = self._next
        self._next += 1
        self.running[tag] = (sql, time.time())
        if timeout:
            self.deadlines[tag] = time.time() + timeout
        return tag

    def finish(self, tag: int, status: str = "finished") -> None:
        ent = self.running.pop(tag, None)
        self.deadlines.pop(tag, None)
        self.stopped.discard(tag)
        if ent is None:
            return
        sql, t0 = ent
        self.finished.append((tag, sql, t0, time.time(), status))
        if len(self.finished) > self.keep:
            del self.finished[:len(self.finished) - self.keep]

    def stop(self, tag: int) -> None:
        if tag in self.running:
            self.stopped.add(tag)

    def check(self, tag: Optional[int]) -> None:
        if tag is None:
            return
        if tag in self.stopped:
            raise QueryKilled(f"query {tag} stopped")
        dl = self.deadlines.get(tag)
        if dl is not None and time.time() > dl:
            raise QueryKilled(f"query {tag} exceeded its timeout")

    def rows(self):
        now = time.time()
        out = [(tag, sql, int(t0), int((now - t0) * 1e6), "running")
               for tag, (sql, t0) in self.running.items()]
        out += [(tag, sql, int(t0), int((t1 - t0) * 1e6), status)
                for tag, sql, t0, t1, status in self.finished]
        return sorted(out)


QUEUE = QueryQueue()


class _CurrentQuery(__import__("threading").local):
    tag: Optional[int] = None


# thread-local current query tag: the executor checks QUEUE against it
# between operators (each session connection runs on its own thread)
CURRENT_QUERY = _CurrentQuery()


# ======================================================================
# relation builders
# ======================================================================
def _tables_rows(cat: Catalog):
    """sys.tables with the reference's column set (sql_catalog.h /
    25_debug.sql: id, name, schema_id, query, type, system,
    commit_action, access, temporary) plus a trailing count column."""
    ts = getattr(cat, "table_schemas", {}) or {}

    def sid(n):
        return _oid(cat, "schema", ts.get(n, "sys"))

    rows = [(_oid(cat, "table", n), n, sid(n), None, 0, False, 0, 0, 0,
             t.count)
            for n, t in cat.tables.items() if not n.startswith("sys.")]
    rows += [(_oid(cat, "table", n), n, sid(n),
              (cat.views or {}).get(n), 1, False, 0, 0, 0, None)
             for n in cat.views]
    rows += [(_oid(cat, "table", n), n, sid(n), None, 3, False, 0, 0, 0,
              None) for n in cat.merges]
    rows += [(_oid(cat, "table", n), n, sid(n), None, 5, False, 0, 0, 0,
              None) for n in cat.remotes]
    rows += [(_oid(cat, "table", n), n, sid(n), None, 6, False, 0, 0, 0,
              None) for n in cat.replicas]
    return sorted(rows, key=lambda r: r[1])


def _columns_rows(cat: Catalog):
    """sys.columns: reference column set (id, name, type, table_id,
    number, "null") with a leading table-name convenience column."""
    rows = []

    def add(tname, cname, typ, i):
        rows.append((_oid(cat, "column", f"{tname}.{cname}"), tname,
                     cname, str(typ), _oid(cat, "table", tname), i,
                     True))
    for tname in sorted(cat.tables):
        if tname.startswith("sys."):
            continue
        t = cat.get(tname)
        for i, cname in enumerate(t.names()):
            if cname == "__rowid__":
                continue
            add(tname, cname, t.col(cname).typ, i)
    for dd in (cat.merges, cat.remotes, cat.replicas):
        for dname in sorted(dd):
            for i, (cname, typ) in enumerate(dd[dname].schema):
                add(dname, cname, typ, i)
    return rows


def _storage_rows(cat: Catalog):
    rows = []
    for tname in sorted(cat.tables):
        if tname.startswith("sys."):
            continue
        t = cat.get(tname)
        for cname in t.names():
            if cname == "__rowid__":
                continue
            c = t.col(cname)
            nbytes = c.data.numel() * c.data.element_size()
            dictsize = len(c.sdict.values) if c.sdict is not None else 0
            # a text column's code flags serve the planner only: the
            # catalog reports none, as the reference package derives none
            flags = (False, False, False) if c.typ.kind == Kind.STR else \
                (bool(c.sorted), bool(c.revsorted), bool(c.key))
            rows.append((tname, cname, str(c.typ), c.count, int(nbytes),
                         *flags, bool(c.nonil), dictsize))
    return rows


def _env_rows(cat: Catalog):
    from .. import config
    rows = [(k, str(config.get(k))) for k in config._defaults]
    # the reference package's row names, filled from the catalog's device
    dev = catalog_device(cat)
    if dev.type == "cuda":
        rows.append(("jax_backend", torch.cuda.get_device_name(dev)))
        rows.append(("n_devices", str(torch.cuda.device_count())))
    else:
        rows.append(("jax_backend", "cpu"))
        rows.append(("n_devices", "1"))
    from .. import __version__ as v
    rows.append(("version", v))
    return sorted(rows)


def _triggers_rows(cat: Catalog):
    trs = getattr(cat, "triggers", {}) or {}
    return sorted((n, t["table"], t["time"], t["event"], t["body"])
                  for n, t in trs.items())


def _comments_rows(cat: Catalog):
    cm = getattr(cat, "comments", {}) or {}
    return sorted((_oid(cat, k.split(":", 1)[0], k.split(":", 1)[1]),
                   k.split(":", 1)[0], k.split(":", 1)[1], v)
                  for k, v in cm.items())


def _sequences_rows(cat: Catalog):
    sq = getattr(cat, "sequences", {}) or {}
    return sorted((n, int(s["next"]), int(s["inc"])) for n, s in sq.items())


def _functions_rows(cat: Catalog):
    rows = [(n, "python") for n in getattr(cat, "udfs", {}) or {}]
    rows += [(n, "proc") for n in getattr(cat, "procedures", {}) or {}]
    return sorted(rows)


def _oid(cat, kind, name):
    f = getattr(cat, "oid", None)
    return int(f(kind, name)) if f else 0


def _schemas_rows(cat: Catalog):
    sc = getattr(cat, "schemas", {}) or {}
    out = []
    for n, s in sorted(sc.items()):
        auth = s.get("auth", "monetdb")
        aid = 3 if auth == "monetdb" else _oid(cat, "auth", auth)
        out.append((_oid(cat, "schema", n), n, aid,
                    bool(s.get("system"))))
    return out


def _auths_rows(cat: Catalog):
    rows = [(3, "monetdb", 0), (1, "public", 0), (2, "sysadmin", 0)]
    for u in sorted(getattr(cat, "users", {}) or {}):
        rows.append((_oid(cat, "auth", u), u, 3))
    for r in sorted(getattr(cat, "roles", {}) or {}):
        rows.append((_oid(cat, "auth", r), r, 3))
    return rows


def _tables_full_rows(cat: Catalog):
    """sys._tables: id/schema_id/type/system (sql_catalog.h type codes)."""
    ts = getattr(cat, "table_schemas", {}) or {}

    def srow(name, kind, code):
        return (_oid(cat, kind, name), name,
                _oid(cat, "schema", ts.get(name, "sys")), code, False)
    out = [srow(n, "table", 0)
           for n in getattr(cat, "tables", {}) or {}]
    out += [srow(n, "view", 1) for n in getattr(cat, "views", {}) or {}]
    out += [srow(n, "table", 3) for n in getattr(cat, "merges", {}) or {}]
    out += [srow(n, "table", 5) for n in getattr(cat, "remotes", {}) or {}]
    out += [srow(n, "table", 6)
            for n in getattr(cat, "replicas", {}) or {}]
    return sorted(out)


_TABLE_TYPES = [(0, "TABLE"), (1, "VIEW"), (3, "MERGE TABLE"),
                (4, "STREAM TABLE"), (5, "REMOTE TABLE"),
                (6, "REPLICA TABLE"), (7, "UNLOGGED TABLE")]


_RELATIONS = {
    "sys.tables": (
        [("id", I32), ("name", _VC), ("schema_id", I32), ("query", _VC),
         ("type", I32), ("system", BOOL), ("commit_action", I32),
         ("access", I32), ("temporary", I32), ("count", I64)],
        _tables_rows),
    "sys.schemas": (
        [("id", I32), ("name", _VC), ("authorization", I32),
         ("system", BOOL)], _schemas_rows),
    "sys.auths": (
        [("id", I32), ("name", _VC), ("grantor", I32)], _auths_rows),
    "sys._tables": (
        [("id", I32), ("name", _VC), ("schema_id", I32), ("type", I32),
         ("system", BOOL)], _tables_full_rows),
    "sys.table_types": (
        [("table_type_id", I32), ("table_type_name", _VC)],
        lambda cat=None: list(_TABLE_TYPES)),
    "sys.triggers": (
        [("name", _VC), ("table", _VC), ("time", _VC), ("event", _VC),
         ("statement", _VC)], _triggers_rows),
    "sys.comments": (
        [("id", I32), ("kind", _VC), ("target", _VC), ("remark", _VC)],
        _comments_rows),
    "sys.sequences": (
        [("name", _VC), ("next_value", I64), ("increment", I64)],
        _sequences_rows),
    "sys.functions": ([("name", _VC), ("language", _VC)], _functions_rows),
    "sys.columns": (
        [("id", I32), ("table", _VC), ("name", _VC), ("type", _VC),
         ("table_id", I32), ("number", I32), ("null", BOOL)],
        _columns_rows),
    "sys.storage": (
        [("table", _VC), ("column", _VC), ("type", _VC), ("count", I64),
         ("bytes", I64), ("sorted", BOOL), ("revsorted", BOOL),
         ("key", BOOL), ("nonil", BOOL), ("dictsize", I64)],
        _storage_rows),
    "sys.env": ([("name", _VC), ("value", _VC)], _env_rows),
    "sys.queue": (
        [("tag", I64), ("query", _VC), ("started", I64), ("usec", I64),
         ("status", _VC)], lambda cat=None: QUEUE.rows()),
    # query history (monetdb5/modules/mal/querylog.c;
    # sql/scripts/15_querylog.sql querylog_catalog/querylog_calls)
    "sys.querylog_calls": (
        [("tag", I64), ("query", _VC), ("started", I64), ("stopped", I64),
         ("run_usec", I64), ("status", _VC)],
        lambda cat=None: [(tag, sql, int(t0), int(t1),
                           int((t1 - t0) * 1e6), status)
                          for tag, sql, t0, t1, status in QUEUE.finished]),
    "sys.querylog_catalog": (
        [("tag", I64), ("query", _VC)],
        lambda cat=None: sorted({(tag, sql) for tag, sql, _t0, _t1, _s
                                 in QUEUE.finished})),
}
_RELATIONS["sys.environment"] = _RELATIONS["sys.env"]
# information_schema facade (sql/scripts/91_information_schema.sql)
_RELATIONS["information_schema.tables"] = _RELATIONS["sys.tables"]
_RELATIONS["information_schema.columns"] = _RELATIONS["sys.columns"]


def _columns_full_rows(cat: Catalog):
    """sys._columns: id/name/type/table_id/number (sql_catalog.h)."""
    rows = []
    for tname in sorted(getattr(cat, "tables", {}) or {}):
        if tname.startswith("sys."):
            continue
        t = cat.get(tname)
        for i, cname in enumerate(t.names()):
            if cname == "__rowid__":
                continue
            rows.append((_oid(cat, "column", f"{tname}.{cname}"), cname,
                        str(t.col(cname).typ), _oid(cat, "table", tname), i))
    return rows


def _keys_rows(cat: Catalog):
    """sys.keys: pk/unique constraints from column flags (objectset keys,
    sql/storage/store.c; type 0=pkey 1=ukey 2=fkey)."""
    rows = []
    for tname in sorted(getattr(cat, "tables", {}) or {}):
        if tname.startswith("sys."):
            continue
        t = cat.get(tname)
        for cname in t.names():
            c = t.col(cname)
            if cname != "__rowid__" and c.key and c.typ.kind != Kind.STR:
                rows.append((_oid(cat, "key", f"{tname}.{cname}"),
                             _oid(cat, "table", tname), 0,
                             f"{tname}_{cname}_pkey", -1, -1))
    return rows


def _idxs_rows(cat: Catalog):
    return [(_oid(cat, "idx", n), _oid(cat, "table", d.get("table", "")),
             0, n)
            for n, d in sorted((getattr(cat, "indexes", {}) or {}).items())]


def _users_rows(cat: Catalog):
    rows = [("monetdb", "MonetDB Admin", "sys")]
    for u in sorted(getattr(cat, "users", {}) or {}):
        rows.append((u, u, "sys"))
    return rows


# reference dependency kinds (sql/include/sql_catalog.h sql_dependency)
_DEP_TYPES = [(1, "SCHEMA"), (2, "TABLE"), (3, "COLUMN"), (4, "KEY"),
              (5, "VIEW"), (6, "USER"), (7, "FUNC"), (8, "TRIGGER"),
              (9, "OWNER"), (10, "INDEX"), (11, "FKEY"), (12, "SEQUENCE"),
              (13, "PROCEDURE"), (14, "BE_DROPPED"), (15, "TYPE")]


def _args_rows(cat: Catalog):
    rows = []
    for fname, d in sorted((getattr(cat, "udfs", {}) or {}).items()):
        params = d.get("params") or []
        for i, p in enumerate(params):
            pname = p[0] if isinstance(p, (list, tuple)) else str(p)
            rows.append((_oid(cat, "arg", f"{fname}.{pname}"),
                         _oid(cat, "func", fname), pname, i + 1))
    return rows


_RELATIONS.update({
    "sys._columns": (
        [("id", I32), ("name", _VC), ("type", _VC), ("table_id", I32),
         ("number", I32)], _columns_full_rows),
    "sys.keys": (
        [("id", I32), ("table_id", I32), ("type", I32), ("name", _VC),
         ("rkey", I32), ("action", I32)], _keys_rows),
    "sys.idxs": (
        [("id", I32), ("table_id", I32), ("type", I32), ("name", _VC)],
        _idxs_rows),
    "sys.users": (
        [("name", _VC), ("fullname", _VC), ("default_schema", _VC)],
        _users_rows),
    "sys.db_user_info": (
        [("name", _VC), ("fullname", _VC), ("default_schema", _VC)],
        _users_rows),
    "sys.dependency_types": (
        [("dependency_type_id", I32), ("dependency_type_name", _VC)],
        lambda cat=None: list(_DEP_TYPES)),
    "sys.dependencies": (
        [("id", I32), ("depend_id", I32), ("depend_type", I32)],
        lambda cat=None: []),
    "sys.args": (
        [("id", I32), ("func_id", I32), ("name", _VC), ("number", I32)],
        _args_rows),
    # COPY BEST EFFORT rejects (sql/scripts/27_rejects.sql) — the loader
    # raises instead of rejecting, so this is always empty
    "sys.rejects": (
        [("rowid", I64), ("fldid", I32), ("message", _VC),
         ("input", _VC)], lambda cat=None: []),
    "sys.objects": (
        [("id", I32), ("name", _VC), ("nr", I32)], lambda cat=None: []),
    "sys.roles": (
        [("id", I32), ("name", _VC), ("grantor", I32)],
        lambda cat: [(_oid(cat, "auth", r), r, 3)
                     for r in sorted(getattr(cat, "roles", {}) or {})]),
})


def is_system_table(name: str) -> bool:
    n = name.lower()
    # unqualified references resolve against the sys schema, as the
    # reference's name resolution does (rel_semantic.c sql_bind_table)
    return n in _RELATIONS or ("." not in n and "sys." + n in _RELATIONS)


def system_table(cat: Catalog, name: str) -> Table:
    from ..storage.columns import table_from_rows
    n = name.lower()
    if n not in _RELATIONS and "sys." + n in _RELATIONS:
        n = "sys." + n
    schema, builder = _RELATIONS[n]
    try:
        rows = builder(cat)
    except TypeError:
        rows = builder()
    return table_from_rows(name.lower(), schema, rows,
                           device=catalog_device(cat))
