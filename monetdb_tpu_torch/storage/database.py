"""Database: durable tables with WAL + atomic-manifest checkpointing and
MVCC-lite delta visibility.

Reference mapping:
  * manifest.json + os.replace       ⟷ BBP.dir + BACKUP/ rename commit
                                        (gdk/gdk_bbp.c:12-66, BBPsync :3860)
  * Wal (storage/wal.py)             ⟷ gdk_logger WAL (replay on open)
  * TableData deleted-mask + in-place
    numpy bases + txn undo copies    ⟷ sql_delta {inserts, deletes, updates}
                                        (sql/storage/bat/bat_storage.h:19-56)
  * checkpoint()                     ⟷ store_apply_deltas → TMsubcommit →
                                        BBPsync (store.c:2356)
  * snapshot()                       ⟷ store_hot_snapshot → tar (store.c:2903)
  * table() device materialization   ⟷ sql.bind/sql.tid delta read path
                                        (backends/monet5/sql.c:2088+)

Everything but materialization is host numpy; the on-disk format
(manifest.json, data/*.npy, wal.log) is the reference package's, byte for
byte.  A store's tables are materialized on the one device it is opened
with (``Database(path, device=...)``, the card unless the caller names
another device).
"""

from __future__ import annotations

import json
import os
import tarfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dtypes import Kind, SQLType
from ..obs.profiler import PROFILER
from ..table import Catalog, Table
from .columns import (NIL_CODE, Categorical, RowidColumn, make_device_column,
                      str_nilmask, tag_type, type_tag)
from .wal import (REC_COMMIT, REC_CREATE, REC_CREATE_VIEW, REC_DDL,
                  REC_DELETE, REC_DROP, REC_DROP_VIEW, REC_INSERT,
                  REC_UPDATE, Wal)

__all__ = ["Database", "TableData", "Transaction", "ConcurrencyConflict"]


def _store_device(device) -> torch.device:
    """The one device a store materializes on.  A CUDA device without an
    index names the current card, so it compares equal to its tensors'
    devices; a CUDA device without a card raises (nothing falls back to
    the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"Database(device={device!r}): no CUDA "
                               "device; pass device='cpu' for a CPU store")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ConcurrencyConflict(Exception):
    """First-committer-wins validation failure (the reference aborts the
    later transaction: sql_trans_commit validation, store.c:3980)."""


import itertools as _itertools

_VERSION_COUNTER = _itertools.count(1)


def _next_version() -> int:
    """Globally unique, monotone TableData version stamp. COW copies that
    diverge from a common ancestor get distinct stamps, so device-cache
    keys (name, version) never collide across transactions."""
    return next(_VERSION_COUNTER)


class TableData:
    """Host-side authoritative state of one table (physical domain)."""

    def __init__(self, name: str, schema: List[Tuple[str, SQLType]],
                 flags: Optional[Dict[str, dict]] = None):
        self.name = name
        self.types: Dict[str, SQLType] = {c: t for c, t in schema}
        self.order = [c for c, _t in schema]
        flags = flags or {}
        self.notnull = {c for c, f in flags.items() if f.get("notnull")}
        self.pks = [c for c, _t in schema
                    if flags.get(c, {}).get("pk")]
        self.serials = {c: f"seq_{name}_{c}" for c, f in flags.items()
                        if f.get("serial")}
        self.uniques = {c for c, f in flags.items() if f.get("unique")}
        # multi-column UNIQUE constraints: [(col, col, ...)]
        self.unique_sets = [tuple(u) for u in
                            (flags.get("#table", {}).get("uniques") or [])]
        # CHECK constraints (sql_cat.c; enforced at append/update):
        # [(constraint_name, expr_sql)]
        self.checks = [(f"{name}_{c}_check", f["check"])
                       for c, f in flags.items() if f.get("check")]
        self.checks += [(nm or f"{name}_check", tx) for nm, tx in
                        (flags.get("#table", {}).get("checks") or [])]
        # column → DEFAULT expression SQL text (evaluated at insert)
        self.defaults = {c: f["default"] for c, f in flags.items()
                         if f.get("default") is not None}
        self.cols: Dict[str, np.ndarray] = {}
        self.dicts: Dict[str, np.ndarray] = {}
        for c, t in schema:
            if t.kind == Kind.STR:
                self.cols[c] = np.empty(0, np.int32)
                self.dicts[c] = np.empty(0, dtype=str)
            else:
                self.cols[c] = np.empty(0, t.np_dtype)
        self.deleted = np.empty(0, np.bool_)
        self.version = _next_version()

    @property
    def count(self) -> int:
        return len(self.deleted)

    def flags_json(self) -> Dict[str, dict]:
        out = {}
        for c in self.order:
            f = {}
            if c in self.notnull:
                f["notnull"] = True
            if c in self.pks:
                f["pk"] = True
            if c in self.serials:
                f["serial"] = True
            if c in self.uniques:
                f["unique"] = True
            if c in self.defaults:
                f["default"] = self.defaults[c]
            if f:
                out[c] = f
        # persist every check (column-level included) as table-level:
        # enforcement is identical and replay stays simple
        tbl = [[nm, tx] for nm, tx in getattr(self, "checks", ())]
        usets = [list(u) for u in getattr(self, "unique_sets", ())]
        if tbl or usets:
            out["#table"] = {}
            if tbl:
                out["#table"]["checks"] = tbl
            if usets:
                out["#table"]["uniques"] = usets
        return out

    def copy(self) -> "TableData":
        td = TableData.__new__(TableData)
        td.name = self.name
        td.types = dict(self.types)
        td.order = list(self.order)
        td.notnull = set(self.notnull)
        td.pks = list(self.pks)
        td.serials = dict(self.serials)
        td.uniques = set(self.uniques)
        td.checks = list(getattr(self, "checks", ()))
        td.unique_sets = list(getattr(self, "unique_sets", ()))
        td.defaults = dict(self.defaults)
        td.cols = {c: a.copy() for c, a in self.cols.items()}
        td.dicts = {c: a.copy() for c, a in self.dicts.items()}
        td.deleted = self.deleted.copy()
        td.version = self.version
        return td

    # -- mutations (physical domain; strings arrive as str or object arrays
    #    or as a Categorical) -------------------------------------------------
    def append(self, arrays: Dict[str, np.ndarray]) -> None:
        """Append a batch, column by column, with no Python per value, in
        a ``load.append`` span (``Database.insert`` opens its own around
        the checks and the WAL record as well and calls ``_append``)."""
        with PROFILER.span("load.append", "append_ns",
                           count=("append_rows", _rows(arrays))):
            self._append(arrays)

    def _append(self, arrays: Dict[str, np.ndarray]) -> None:
        """The text columns (in a ``load.dict`` span), then the others;
        a batch of ``_PARALLEL_ROWS`` rows or more takes the columns of
        each phase in parallel threads, one a column (numpy's sorts and
        copies release the GIL, and each column's state is its own)."""
        n = _rows(arrays)
        par = n >= _PARALLEL_ROWS
        text = [c for c in self.order if self.types[c].kind == Kind.STR]
        if text:
            with PROFILER.span("load.dict", "load_dict_ns"):
                _each(lambda c: self._append_strings(c, arrays[c]), text,
                      par)
        _each(lambda c: self._append_values(c, arrays[c]),
              [c for c in self.order if c not in text], par)
        self.deleted = np.zeros(n, np.bool_) if not self.count else \
            np.concatenate([self.deleted, np.zeros(n, np.bool_)])
        self.version = _next_version()

    def _append_values(self, c: str, a) -> None:
        b = np.asarray(a).astype(self.types[c].np_dtype, copy=False)
        self._extend(c, b, np.may_share_memory(a, b))

    def _extend(self, c: str, a: np.ndarray, foreign: bool) -> None:
        """Append ``a`` to column ``c``.  Into an empty column an array
        that the store made for this batch (a cast, a dictionary's codes)
        is adopted; one that ``foreign`` says may share the caller's
        memory is copied, as a concatenation would, since the caller may
        refill its buffer after the append returns."""
        if len(self.cols[c]):
            self.cols[c] = np.concatenate([self.cols[c], a])
        else:
            self.cols[c] = np.array(a) if foreign else \
                np.ascontiguousarray(a)

    _NIL_CODE = NIL_CODE

    def _append_strings(self, c: str, new) -> None:
        """Order-preserving dictionary maintenance: merge, remap old codes
        (the engine-wide invariant that code order == string order; the
        reference's dict.c rebuilds on overflow the same way). NULLs get
        the nil code and never enter the dictionary.  A batch of strings
        is encoded with one sort of its values; a ``Categorical`` brings
        its sorted dictionary, which is kept once the categories no row
        uses are dropped, so that either way the dictionary holds
        exactly the strings the table has."""
        if isinstance(new, Categorical):
            cat = new.used()
            codes, uniq = cat.codes, cat.categories
            if np.may_share_memory(uniq, new.categories):
                uniq = uniq.copy()
            foreign = np.may_share_memory(codes, new.codes)
        else:
            new = np.asarray(new)
            isnil = str_nilmask(new)
            vals = new[~isnil] if isnil.any() else new
            if vals.dtype.kind != "U":
                vals = vals.astype(str)
            uniq, inv = np.unique(vals, return_inverse=True)
            codes = np.full(len(new), NIL_CODE, np.int32)
            codes[~isnil] = inv.reshape(-1)
            foreign = False
        self._merge_codes(c, uniq, codes, foreign)

    def _merge_codes(self, c: str, uniq: np.ndarray, codes: np.ndarray,
                     foreign: bool) -> None:
        """Append ``codes`` over the sorted unique dictionary ``uniq`` to
        column ``c`` (``foreign`` as ``_extend`` takes it), merging
        ``uniq`` into the column's dictionary:
        in place when every new string sorts after its tail (the old
        codes stay valid: append-friendly data such as monotonic ids,
        timestamps, log lines), else by a remap of the old codes."""
        old = self.dicts[c]
        if not len(old):
            self.dicts[c] = uniq
            self._extend(c, codes, foreign)
            return
        pos = np.searchsorted(old, uniq)
        found = old[np.minimum(pos, len(old) - 1)] == uniq
        fresh = uniq[~found]
        if len(fresh):
            if fresh[0] > old[-1]:
                self.dicts[c] = np.concatenate([old, fresh])
            else:
                merged = np.union1d(old, fresh)
                remap = np.searchsorted(merged, old).astype(np.int32)
                old_codes = self.cols[c]
                self.cols[c] = np.where(old_codes >= 0, remap[np.clip(
                    old_codes, 0, None)], old_codes).astype(np.int32)
                self.dicts[c] = merged
            pos = np.searchsorted(self.dicts[c], uniq)
        lut = pos.astype(np.int32)
        if len(lut):
            codes = np.where(codes >= 0, lut[np.maximum(codes, 0)], NIL_CODE)
        self._extend(c, codes.astype(np.int32, copy=False), False)

    def delete_oids(self, oids: np.ndarray) -> None:
        self.deleted[oids] = True
        self.version = _next_version()

    def update_col(self, c: str, oids: np.ndarray, vals: np.ndarray) -> None:
        t = self.types[c]
        if t.kind == Kind.STR:
            vals = np.asarray(vals, dtype=object)
            isnil = str_nilmask(vals)
            nn = vals[~isnil].astype(str) if (~isnil).any() else \
                np.empty(0, dtype=str)
            merged = np.unique(np.concatenate([self.dicts[c], nn]))
            if not np.array_equal(merged, self.dicts[c]):
                remap = np.searchsorted(merged, self.dicts[c]).astype(np.int32)
                oc = self.cols[c]
                self.cols[c] = np.where(oc >= 0, remap[np.clip(oc, 0, None)],
                                        oc).astype(np.int32)
                self.dicts[c] = merged
            codes = np.full(len(vals), self._NIL_CODE, np.int32)
            if len(nn):
                codes[~isnil] = np.searchsorted(self.dicts[c], nn)
            self.cols[c][oids] = codes
        else:
            self.cols[c][oids] = vals.astype(t.np_dtype, copy=False)
        self.version = _next_version()


def _rows(arrays: Dict[str, np.ndarray]) -> int:
    return len(next(iter(arrays.values())))


#: the rows from which ``TableData._append`` works on columns in parallel
_PARALLEL_ROWS = 1 << 16


def _each(fn, items: List[str], parallel: bool) -> None:
    """``fn`` on every item: in threads, one an item, if ``parallel``."""
    if not parallel or len(items) < 2:
        for x in items:
            fn(x)
        return
    with ThreadPoolExecutor(min(len(items), os.cpu_count() or 1)) as ex:
        list(ex.map(fn, items))


def _checked_batch(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """An insert's batch with lower-case column names and each
    ``Categorical`` checked, once for the constraints, the append and
    the WAL record."""
    return {c.lower(): a.checked() if isinstance(a, Categorical) else a
            for c, a in arrays.items()}


class Database:
    def __init__(self, path: Optional[str] = None, *, device="cuda"):
        self.path = path
        self.device = _store_device(device)
        self.tables: Dict[str, TableData] = {}
        # view name → SQL text (inlined at bind time, the reference's
        # rel_semantic view expansion over sys._tables type=1 entries)
        self.views: Dict[str, str] = {}
        # distribution DDL (merge/remote/replica table definitions;
        # sql/server/rel_distribute.c + rel_schema.c partitioned tables)
        self.merges: Dict[str, object] = {}
        self.remotes: Dict[str, object] = {}
        self.replicas: Dict[str, object] = {}
        # SQL-created Python UDFs (pyapi3 analog); persisted via source
        self.udfs: Dict[str, object] = {}
        # user → sha512(password) hex (mal_authorize.c stores password
        # hashes, never plaintext). Empty dict = open server.
        self.users: Dict[str, str] = {}
        # sequences (sql/storage/store_sequence.c): name → {next, inc}
        self.sequences: Dict[str, dict] = {}
        # statement-level triggers (rel_schema.c create_trigger):
        # name → {table, time, event, body}
        self.triggers: Dict[str, dict] = {}
        # SQL procedures (rel_psm.c): name → {params: [[n, tag]], body}
        self.procedures: Dict[str, dict] = {}
        # COMMENT ON texts (sys.comments): "kind:target" → text
        self.comments: Dict[str, str] = {}
        # SQL scalar functions (rel_psm.c; inlined at bind time):
        # name → {params: [[n, tag]], ret: tag, body: expr SQL}
        self.sqlfuncs: Dict[str, dict] = {}
        # roles & privileges (sql_user.c / sql_privileges.c):
        self.roles: Dict[str, List[str]] = {}       # role → member users
        # grantee (user|role|'public') → {table → [privs]}
        self.grants: Dict[str, Dict[str, List[str]]] = {}
        self.owners: Dict[str, str] = {}            # table → owning user
        # SQL schemas (rel_schema.c rel_create_schema; sys.schemas):
        # name → {"auth": owner, "system": bool}. System schemas mirror
        # the reference bootstrap (sql/scripts/*.sql).
        self.schemas: Dict[str, dict] = {
            n: {"auth": "monetdb", "system": True}
            for n in ("sys", "tmp", "json", "profiler", "logging")}
        # stable object ids ("kind:name" → id) — the reference's global
        # id space (sqlstore store_next_oid); feeds sys.schemas.id,
        # sys._tables.id and sys.comments.id joins
        self.oids: Dict[str, int] = {}
        self._next_oid = 2000
        # table/view → owning schema (created under SET SCHEMA s)
        self.table_schemas: Dict[str, str] = {}
        # foreign keys (sql_cat.c fkey DDL; enforced RESTRICT):
        # child table → [([cols], rtable, [rcols])]
        self.fks: Dict[str, list] = {}
        # table access mode (sql_cat.c sql_alter_table SET READ ONLY /
        # INSERT ONLY / READ WRITE): table → mode; absent = read_write
        self.table_access: Dict[str, str] = {}
        # advisory index definitions (sql_cat.c create_index; execution
        # uses sort-based kernels instead of persisted indexes):
        # name → {table, cols, unique}
        self.indexes: Dict[str, dict] = {}
        self.schema_epoch = 0   # bumped on DDL (plan-cache invalidation)
        # store lock: serializes mutations across sessions (the reference's
        # store_lock, sql/storage/store.c)
        self._mu = threading.RLock()
        self._device: Dict[str, Tuple[int, Table, np.ndarray]] = {}
        # open snapshot count: while > 0, autocommit writes go copy-on-
        # write so pinned snapshots stay immutable (the reference keeps
        # old object versions alive while any transaction can see them,
        # objectset.c versioned objects)
        self._snapshot_pins = 0
        # database-level default transaction (legacy begin()/commit()
        # facade used by the embedded API; sessions hold their own)
        self._txn: Optional["Transaction"] = None
        self._next_txn = 1
        self.wal: Optional[Wal] = None
        if path is not None:
            os.makedirs(path, exist_ok=True)
            os.makedirs(os.path.join(path, "data"), exist_ok=True)
            self._load_manifest()
            self._replay_wal()
            self.wal = Wal(os.path.join(path, "wal.log"))

    # ======================================================================
    # durability
    # ======================================================================
    def _manifest_path(self) -> str:
        return os.path.join(self.path, "manifest.json")

    def _load_manifest(self) -> None:
        mp = self._manifest_path()
        if not os.path.exists(mp):
            return
        with open(mp) as f:
            man = json.load(f)
        for tname, tinfo in man["tables"].items():
            schema = [(c, tag_type(tag)) for c, tag in tinfo["schema"]]
            td = TableData(tname, schema, tinfo.get("flags"))
            fors = tinfo.get("for", {})
            for c, t in schema:
                arr = np.load(os.path.join(
                    self.path, "data", f"{tname}.{c}.npy"))
                if c in fors:        # FOR-decompress to the declared type
                    arr = arr.astype(t.np_dtype) + t.np_dtype.type(fors[c])
                td.cols[c] = arr
                dp = os.path.join(self.path, "data", f"{tname}.{c}.dict.npy")
                if os.path.exists(dp):
                    td.dicts[c] = np.load(dp)
            td.deleted = np.load(os.path.join(
                self.path, "data", f"{tname}.__deleted__.npy"))
            self.tables[tname] = td
        self.views = dict(man.get("views", {}))
        from ..sql.distribute import def_from_json
        for j in man.get("dist", []):
            self._dist_dicts()[j["kind"]][j["name"].lower()] = \
                def_from_json(j)
        for j in man.get("udfs", []):
            u = self._udf_from_json(j)
            self.udfs[u.name] = u
        self.users = dict(man.get("users", {}))
        self.sequences = {n: dict(s)
                          for n, s in man.get("seqs", {}).items()}
        self.triggers = {n: dict(t)
                         for n, t in man.get("triggers", {}).items()}
        self.procedures = {n: dict(p)
                           for n, p in man.get("procs", {}).items()}
        self.comments = dict(man.get("comments", {}))
        self.sqlfuncs = {n: dict(f)
                         for n, f in man.get("sqlfuncs", {}).items()}
        self.roles = {n: list(m) for n, m in man.get("roles", {}).items()}
        self.grants = {g: {t: list(p) for t, p in d.items()}
                       for g, d in man.get("grants", {}).items()}
        self.owners = dict(man.get("owners", {}))
        self.schemas.update({n: dict(s)
                             for n, s in man.get("schemas", {}).items()})
        self.oids = {k: int(v) for k, v in man.get("oids", {}).items()}
        self._next_oid = int(man.get("next_oid", 2000))
        self.table_schemas = dict(man.get("table_schemas", {}))
        self.indexes = {n: dict(d)
                        for n, d in man.get("indexes", {}).items()}

    def _replay_wal(self) -> None:
        wp = os.path.join(self.path, "wal.log")
        for rtype, _txn, meta, arrays in Wal.replay(wp):
            self._apply(rtype, meta, arrays)

    def _apply(self, rtype: int, meta: dict,
               arrays: Dict[str, np.ndarray]) -> None:
        arrays = self._wal_decode(arrays)
        if rtype == REC_CREATE:
            schema = [(c, tag_type(tag)) for c, tag in meta["schema"]]
            self.tables[meta["table"]] = TableData(
                meta["table"], schema, meta.get("flags"))
            for ent in meta.get("fks") or []:
                cols, rtab, rcols = ent[0], ent[1], ent[2]
                act = ent[3] if len(ent) > 3 else "restrict"
                if not rcols:
                    rt = self.tables.get(rtab)
                    rcols = list(rt.pks) if rt is not None else []
                self.fks.setdefault(meta["table"], []).append(
                    (list(cols), rtab, list(rcols), act))
        elif rtype == REC_DROP:
            self.tables.pop(meta["table"], None)
            self.fks.pop(meta["table"], None)
            self._device.pop(meta["table"], None)
        elif rtype == REC_INSERT:
            self.tables[meta["table"]].append(arrays)
        elif rtype == REC_DELETE:
            self.tables[meta["table"]].delete_oids(arrays["oids"])
        elif rtype == REC_UPDATE:
            self.tables[meta["table"]].update_col(
                meta["col"], arrays["oids"], arrays["vals"])
        elif rtype == REC_CREATE_VIEW:
            self.views[meta["view"]] = meta["sql"]
        elif rtype == REC_DROP_VIEW:
            self.views.pop(meta["view"], None)
        elif rtype == REC_DDL:
            from ..sql.distribute import def_from_json
            if meta["op"] == "put":
                j = meta["def"]
                self._dist_dicts()[j["kind"]][j["name"].lower()] = \
                    def_from_json(j)
            elif meta["op"] == "put_udf":
                u = self._udf_from_json(meta["udf"])
                self.udfs[u.name] = u
            elif meta["op"] == "drop_udf":
                self.udfs.pop(meta["name"], None)
            elif meta["op"] == "put_user":
                self.users[meta["name"]] = meta["hash"]
            elif meta["op"] == "drop_user":
                self.users.pop(meta["name"], None)
            elif meta["op"] == "put_seq":
                s = {"next": meta["next"], "inc": meta["inc"]}
                # bounds survive restart (store_sequence.c persists the
                # full record); updates that omit them keep prior bounds
                prev = self.sequences.get(meta["name"], {})
                for b in ("min", "max"):
                    if b in meta:
                        s[b] = meta[b]
                    elif b in prev:
                        s[b] = prev[b]
                self.sequences[meta["name"]] = s
            elif meta["op"] == "drop_seq":
                self.sequences.pop(meta["name"], None)
            elif meta["op"] == "put_trigger":
                self.triggers[meta["name"]] = meta["trigger"]
            elif meta["op"] == "drop_trigger":
                self.triggers.pop(meta["name"], None)
            elif meta["op"] == "put_proc":
                self.procedures[meta["name"]] = meta["proc"]
            elif meta["op"] == "drop_proc":
                self.procedures.pop(meta["name"], None)
            elif meta["op"] == "put_role":
                self.roles.setdefault(meta["name"], [])
            elif meta["op"] == "drop_role":
                self.roles.pop(meta["name"], None)
            elif meta["op"] == "put_member":
                self.roles.setdefault(meta["role"], [])
                if meta["user"] not in self.roles[meta["role"]]:
                    self.roles[meta["role"]].append(meta["user"])
            elif meta["op"] == "drop_member":
                if meta["user"] in self.roles.get(meta["role"], []):
                    self.roles[meta["role"]].remove(meta["user"])
            elif meta["op"] == "put_grant":
                d = self.grants.setdefault(meta["grantee"], {})
                ps = d.setdefault(meta["table"], [])
                for p in meta["privs"]:
                    if p not in ps:
                        ps.append(p)
            elif meta["op"] == "drop_grant":
                d = self.grants.get(meta["grantee"], {})
                ps = d.get(meta["table"], [])
                for p in meta["privs"]:
                    if p in ps:
                        ps.remove(p)
            elif meta["op"] == "put_owner":
                self.owners[meta["table"]] = meta["user"]
            elif meta["op"] == "add_ukey":
                self._add_ukey_replay(meta)
            elif meta["op"] == "add_fks":
                self.fks[meta["table"]] = [
                    self._fk4(e) for e in meta["fks"]]
            elif meta["op"] == "put_sqlfunc":
                self.sqlfuncs[meta["name"]] = meta["func"]
            elif meta["op"] == "drop_sqlfunc":
                self.sqlfuncs.pop(meta["name"], None)
            elif meta["op"] == "put_comment":
                if meta["text"] is None:
                    self.comments.pop(meta["key"], None)
                else:
                    self.comments[meta["key"]] = meta["text"]
            elif meta["op"] == "rename_schema":
                s = self.schemas.pop(meta["old"], None)
                if s is not None:
                    self.schemas[meta["new"]] = s
                for t, sc in list(self.table_schemas.items()):
                    if sc == meta["old"]:
                        self.table_schemas[t] = meta["new"]
            elif meta["op"] == "put_schema":
                self.schemas[meta["name"]] = dict(meta["def"])
            elif meta["op"] == "drop_schema":
                self.schemas.pop(meta["name"], None)
            elif meta["op"] == "put_oid":
                self.oids[meta["key"]] = int(meta["id"])
                self._next_oid = max(self._next_oid, int(meta["id"]) + 1)
            elif meta["op"] == "put_tschema":
                self.table_schemas[meta["table"]] = meta["schema"]
            elif meta["op"] == "put_index":
                self.indexes[meta["name"]] = dict(meta["def"])
            elif meta["op"] == "drop_index":
                self.indexes.pop(meta["name"], None)
            elif meta["op"] == "add_col":
                self._add_col_apply(meta)
            elif meta["op"] == "drop_col":
                self._drop_col_apply(meta["table"], meta["col"])
            elif meta["op"] == "rename_col":
                self._rename_col_apply(meta["table"], meta["col"],
                                       meta["new"])
            elif meta["op"] == "rename_table":
                self._rename_table_apply(meta["table"], meta["new"])
            else:
                self._dist_dicts()[meta["kind"]].pop(meta["name"], None)

    def checkpoint(self) -> None:
        """store_apply_deltas + BBPsync: write column files, atomically swap
        the manifest, truncate the WAL."""
        if self.path is None:
            return
        from ..sql.distribute import def_to_json
        man = {"version": 2, "tables": {}, "views": dict(self.views),
               "dist": [def_to_json(d)
                        for dd in self._dist_dicts().values()
                        for d in dd.values()],
               "udfs": [self._udf_json(u) for u in self.udfs.values()
                        if u.body is not None],
               "users": dict(self.users),
               "seqs": {n: dict(s) for n, s in self.sequences.items()},
               "triggers": {n: dict(t) for n, t in self.triggers.items()},
               "procs": {n: dict(p) for n, p in self.procedures.items()},
               "comments": dict(self.comments),
               "sqlfuncs": {n: dict(f) for n, f in self.sqlfuncs.items()},
               "roles": {n: list(m) for n, m in self.roles.items()},
               "grants": {g: {t: list(p) for t, p in d.items()}
                          for g, d in self.grants.items()},
               "owners": dict(self.owners),
               "schemas": {n: dict(s) for n, s in self.schemas.items()
                           if not s.get("system")},
               "oids": dict(self.oids),
               "next_oid": self._next_oid,
               "table_schemas": dict(self.table_schemas),
               "indexes": {n: dict(d) for n, d in self.indexes.items()}}
        for tname, td in self.tables.items():
            fors = {}
            for c in td.order:
                arr = td.cols[c]
                # FOR (frame-of-reference) compression at rest: nil-free
                # int columns whose range fits a narrower width store as
                # base + deltas (backends/monet5/for.c; decompressed on
                # load, so device semantics are unchanged)
                if arr.dtype.kind == "i" and arr.dtype.itemsize > 2 \
                        and len(arr) and td.types[c].kind != Kind.STR:
                    from ..dtypes import is_nil_np
                    if not is_nil_np(arr, td.types[c]).any():
                        lo, hi = int(arr.min()), int(arr.max())
                        span = hi - lo
                        for nt in (np.int8, np.int16, np.int32):
                            ii = np.iinfo(nt)
                            if np.dtype(nt).itemsize < arr.dtype.itemsize \
                                    and span <= int(ii.max) - 1:
                                fors[c] = lo
                                arr = (arr - lo).astype(nt)
                                break
                np.save(os.path.join(self.path, "data", f"{tname}.{c}.npy"),
                        arr)
                if td.types[c].kind == Kind.STR:
                    np.save(os.path.join(self.path, "data",
                                         f"{tname}.{c}.dict.npy"),
                            td.dicts[c])
            np.save(os.path.join(self.path, "data",
                                 f"{tname}.__deleted__.npy"), td.deleted)
            man["tables"][tname] = {
                "schema": [[c, type_tag(td.types[c])] for c in td.order],
                "count": td.count,
                "flags": td.flags_json(),
                "for": fors,
            }
        tmp = self._manifest_path() + ".new"
        with open(tmp, "w") as f:
            json.dump(man, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())   # the atomic commit point
        if self.wal is not None:
            self.wal.truncate()

    def snapshot(self, tar_path: str) -> None:
        """Hot snapshot: consistent tar of the db dir (store.c:2903)."""
        self.checkpoint()
        with tarfile.open(tar_path, "w") as tar:
            tar.add(self._manifest_path(), arcname="manifest.json")
            tar.add(os.path.join(self.path, "data"), arcname="data")

    @staticmethod
    def restore(tar_path: str, dest: str, *, device="cuda") -> "Database":
        os.makedirs(dest, exist_ok=True)
        with tarfile.open(tar_path) as tar:
            tar.extractall(dest, filter="data")
        return Database(dest, device=device)

    # ======================================================================
    # transactions (sql_trans_create/commit/rollback, store.c:3889+)
    # ======================================================================
    def begin_txn(self) -> "Transaction":
        """Open a snapshot-isolation transaction (sql_trans_create,
        store.c:3889). Concurrent sessions each hold their own; commit
        validates first-committer-wins (store.c:3980)."""
        return Transaction(self)

    # legacy single-txn facade (embedded API / monetdbe.h semantics)
    def begin(self) -> None:
        if self._txn is not None:
            raise RuntimeError("nested transactions unsupported")
        self._txn = Transaction(self)

    def commit(self) -> None:
        if self._txn is None:
            raise RuntimeError("no transaction")
        t, self._txn = self._txn, None
        t.commit()

    def rollback(self) -> None:
        if self._txn is None:
            raise RuntimeError("no transaction")
        t, self._txn = self._txn, None
        t.rollback()

    def _mutable_td(self, name: str) -> TableData:
        """Autocommit write target: in-place when nothing pins a snapshot,
        copy-on-write otherwise so open transactions keep reading their
        begin-time state."""
        td = self.tables[name]
        if self._snapshot_pins > 0:
            td = td.copy()
            self.tables[name] = td
        return td

    @staticmethod
    def _wal_encode(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Object string arrays (with None) and Categoricals → '<U' values
        + nil-mask pairs (npz can't hold object arrays without pickling);
        a replay reads them back as strings."""
        out = {}
        for k, a in arrays.items():
            if isinstance(a, Categorical):
                out[k + "@s"], out[k + "@nil"] = a.strings()
            elif a.dtype == object:
                isnil = np.equal(a, None)
                out[k + "@s"] = np.where(isnil, "", a).astype(str)
                out[k + "@nil"] = isnil
            else:
                out[k] = a
        return out

    @staticmethod
    def _wal_decode(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {}
        for k, a in arrays.items():
            if k.endswith("@s"):
                base = k[:-2]
                obj = a.astype(object)
                obj[arrays[base + "@nil"]] = None
                out[base] = obj
            elif not k.endswith("@nil"):
                out[k] = a
        return out

    def _log(self, rtype: int, meta: dict,
             arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Write one committed record to the WAL (nothing without one)."""
        if self.wal is None:
            return
        txn = self._next_txn
        self._next_txn += 1
        self.wal.append(rtype, txn, meta, self._wal_encode(arrays or {}),
                        flush=False)
        self.wal.commit(txn)

    # ======================================================================
    # DDL / DML (physical domain)
    # ======================================================================
    def create_table(self, name: str,
                     schema: List[Tuple[str, SQLType]],
                     flags: Optional[Dict[str, dict]] = None,
                     fks: Optional[list] = None) -> None:
        name = name.lower()
        if self._txn is not None:
            return self._txn.create_table(name, schema, flags)
        if name in self.tables:
            raise ValueError(f"table {name} exists")
        flags = {c.lower(): f for c, f in (flags or {}).items()}
        if name == "":
            raise ValueError("42000!CREATE TABLE: empty table name")
        for c, _t in schema:
            if c == "":
                raise ValueError("42000!CREATE TABLE: empty column name")
        import re as _re
        for c, f in flags.items():
            d = f.get("default") if isinstance(f, dict) else None
            if d:
                m = _re.search(
                    r"next\s+value\s+for\s+((?:\"[^\"]+\"|\w+)"
                    r"(?:\s*\.\s*(?:\"[^\"]+\"|\w+))*)", str(d), _re.I)
                if m and m.group(1).split(".")[-1].strip()\
                        .strip('\"').lower() not in self.sequences:
                    raise ValueError(
                        f"42000!DEFAULT: no such sequence {m.group(1)!r}")
        td = TableData(name, [(c.lower(), t) for c, t in schema], flags)
        self.tables[name] = td
        for c, seq in td.serials.items():
            if seq not in self.sequences:
                self.create_sequence(seq)
        self.schema_epoch += 1
        if fks:
            self.add_foreign_keys(name, fks, log=False)
        self._log(REC_CREATE, {"table": name, "schema": [
            [c.lower(), type_tag(t)] for c, t in schema],
            "flags": flags,
            # log the RESOLVED fks (REFERENCES t without columns binds
            # to the parent pk at DDL time)
            "fks": [[list(e[0]), e[1], list(e[2]),
                     e[3] if len(e) > 3 else "restrict"]
                    for e in self.fks.get(name, [])]})

    def add_unique_key(self, name: str, cols, pk: bool = False) -> None:
        """Post-hoc PRIMARY KEY / UNIQUE: reject when a pk already
        exists (pk), existing data has duplicates, or (pk) nils."""
        name = name.lower()
        td = self.tables.get(name)
        if td is None:
            # merge/remote tables (or txn-local): constraint accepted as
            # advisory, no data to validate here
            return
        cols = [c.lower() for c in cols]
        for c in cols:
            if c not in td.types:
                raise ValueError(f"42S22!no such column {name}.{c}")
        if pk and td.pks:
            raise ValueError(
                f"42000!ADD PRIMARY KEY: table {name} already has one")
        live = ~td.deleted
        from ..dtypes import is_nil_np

        def vals(c):
            t = td.types[c]
            col = td.cols[c][live]
            if t.kind == Kind.STR:
                d = td.dicts[c]
                return [None if k < 0 else str(d[k]) for k in col]
            nm = is_nil_np(col, t)
            return [None if b else v for v, b in zip(col.tolist(),
                                                     nm.tolist())]
        combos = list(zip(*[vals(c) for c in cols])) if td.count else []
        if pk and any(None in cb for cb in combos):
            raise ValueError(
                "40002!ADD PRIMARY KEY: column holds NULLs")
        if len(set(combos)) != len(combos):
            raise ValueError(
                f"40002!ADD {'PRIMARY KEY' if pk else 'UNIQUE'}: "
                f"existing rows are not distinct on ({', '.join(cols)})")
        if pk:
            td.pks = list(cols)
            td.notnull |= set(cols)
            if len(cols) == 1:
                td.uniques.add(cols[0])
            else:
                td.unique_sets.append(tuple(cols))
        elif len(cols) == 1:
            td.uniques.add(cols[0])
        else:
            td.unique_sets.append(tuple(cols))
        self.schema_epoch += 1
        self._log(REC_DDL, {"op": "add_ukey", "table": name,
                            "cols": cols, "pk": bool(pk)})

    def _add_ukey_replay(self, meta: dict) -> None:
        td = self.tables.get(meta["table"])
        if td is None:
            return
        cols = meta["cols"]
        if meta.get("pk"):
            td.pks = list(cols)
            td.notnull |= set(cols)
        if len(cols) == 1:
            td.uniques.add(cols[0])
        else:
            td.unique_sets.append(tuple(cols))

    @staticmethod
    def _fk_validate(ent, lookup) -> tuple:
        """Validate one FOREIGN KEY spec against ``lookup``'s visible
        state and return the normalized (cols, rtab, rcols, action)
        entry (sql_cat.c constraint DDL checks)."""
        cols, rtab, rcols = ent[0], ent[1], ent[2]
        action = ent[3] if len(ent) > 3 else "restrict"
        rt = lookup(rtab.lower())
        if rt is None:
            raise ValueError(
                f"42S02!FOREIGN KEY: no such table {rtab}")
        rc = [c.lower() for c in rcols] or list(rt.pks)
        if not rc or len(rc) != len(cols):
            raise ValueError("42000!FOREIGN KEY: column mismatch")
        uniq = (rc == list(getattr(rt, "pks", []))
                or (len(rc) == 1 and rc[0] in
                    getattr(rt, "uniques", ()))
                or tuple(rc) in [tuple(u) for u in
                                 getattr(rt, "unique_sets", ())])
        if not uniq:
            raise ValueError(
                "42000!FOREIGN KEY: referenced columns must be a "
                "PRIMARY KEY or UNIQUE constraint")
        return ([c.lower() for c in cols], rtab.lower(), rc, action)

    def add_foreign_keys(self, name: str, fks: list, log: bool = True,
                         lookup=None) -> None:
        """Register FOREIGN KEY constraints (RESTRICT semantics); the
        referenced table must exist — ``lookup`` overrides the table
        resolver so transactional sessions validate against their own
        visible state."""
        name = name.lower()
        lookup = lookup or self.tables.get
        for ent in fks:
            entry = self._fk_validate(ent, lookup)
            if log:
                # post-hoc ADD FOREIGN KEY validates existing child rows
                # (sql_cat.c: the constraint must hold when added)
                ctd = self.tables.get(name)
                if ctd is not None and ctd.count:
                    live = ~ctd.deleted
                    arrays = {c: ctd.cols[c][live] for c in entry[0]}
                    if any(ctd.types[c].kind == Kind.STR
                           for c in entry[0]):
                        arrays = {
                            c: (np.asarray(
                                [None if k < 0 else str(ctd.dicts[c][k])
                                 for k in ctd.cols[c][live]], object)
                                if ctd.types[c].kind == Kind.STR
                                else ctd.cols[c][live])
                            for c in entry[0]}
                    saved = self.fks.get(name)
                    self.fks[name] = [entry]
                    try:
                        self._fk_check_insert(ctd, arrays, lookup)
                    finally:
                        self.fks[name] = saved if saved is not None \
                            else []
            self.fks.setdefault(name, []).append(entry)
        if log:
            self._log(REC_DDL, {"op": "add_fks", "table": name,
                                "fks": [[list(e[0]), e[1], list(e[2]),
                                         e[3]] for e in self.fks[name]]})
        self.schema_epoch += 1

    @staticmethod
    def _fk4(ent):
        cols, rtab, rcols = ent[0], ent[1], ent[2]
        return (list(cols), rtab, list(rcols),
                ent[3] if len(ent) > 3 else "restrict")

    def _fk_check_insert(self, td: TableData,
                         arrays: Dict[str, np.ndarray],
                         resolver=None, extra_fks=None) -> None:
        """Child-side FK check: every non-nil key combination in the
        batch must exist in the parent (RESTRICT/NO ACTION default,
        the reference checks in the append path too)."""
        from ..dtypes import is_nil_np

        def norm(src_td, col, vals, codes=False):
            t = src_td.types[col]
            if t.kind == Kind.STR:
                if codes:
                    d = src_td.dicts[col]
                    return [None if k < 0 else str(d[k]) for k in vals]
                return [None if v is None else str(v) for v in vals]
            a = np.asarray(vals, t.np_dtype)
            nm = is_nil_np(a, t)
            return [None if b else v for v, b in zip(a.tolist(),
                                                     nm.tolist())]
        resolver = resolver or self.tables.get
        ents = list(self.fks.get(td.name, ())) + \
            list((extra_fks or {}).get(td.name, ()))
        for cols, rtab, rcols, _act in map(self._fk4, ents):
            if not all(c in arrays for c in cols):
                continue
            parent = resolver(rtab)
            if parent is None:
                continue
            live = ~parent.deleted
            have = set(zip(*[norm(parent, rc, parent.cols[rc][live],
                                  codes=True) for rc in rcols]))                 if parent.count else set()
            for combo in zip(*[norm(td, c, arrays[c]) for c in cols]):
                if any(v is None for v in combo):
                    continue               # nil FK always allowed
                if combo not in have:
                    raise ValueError(
                        f"40002!INSERT INTO: FOREIGN KEY constraint "
                        f"violated: {td.name}({', '.join(cols)}) -> "
                        f"{rtab}")

    def _fk_check_delete(self, td: TableData, oids: np.ndarray,
                         resolver=None, deleter=None,
                         updater=None, extra_fks=None) -> None:
        """Parent-side FK check on delete: a key value removed from the
        parent must not remain referenced by any child row.

        ``resolver`` maps a child table name to its *visible* TableData
        (a transaction passes its own view); ``deleter(child, oids)`` /
        ``updater(child, col, oids, vals)`` perform the CASCADE / SET
        NULL side effects through the caller's write path (the
        transaction buffers them in its WAL record group; autocommit
        goes through _mutable_td so open snapshots never see the
        cascade - the reference applies FK actions inside the same
        sql_trans, sql/storage/store.c sql_trans_commit)."""
        from ..dtypes import is_nil_np
        import itertools
        src = itertools.chain(self.fks.items(),
                              (extra_fks or {}).items())
        refs = [(child, cols, rcols, act)
                for child, lst in src
                for cols, rtab, rcols, act in map(self._fk4, lst)
                if rtab == td.name]
        if not refs:
            return
        if resolver is None:
            resolver = self.tables.get
        if deleter is None:
            def deleter(child, coids):
                ctd = self._mutable_td(child)
                ctd.delete_oids(coids)
                self._log(REC_DELETE, {"table": child}, {"oids": coids})
                self._device.pop(child, None)
        if updater is None:
            def updater(child, col, coids, vals):
                ctd = self._mutable_td(child)
                ctd.update_col(col, coids, vals)
                self._log(REC_UPDATE, {"table": child, "col": col},
                          {"oids": coids, "vals": vals})
                self._device.pop(child, None)

        def norm(src_td, col, sel):
            t = src_td.types[col]
            vals = src_td.cols[col][sel]
            if t.kind == Kind.STR:
                d = src_td.dicts[col]
                return [None if k < 0 else str(d[k]) for k in vals]
            nm = is_nil_np(vals, t)
            return [None if b else v for v, b in zip(vals.tolist(),
                                                     nm.tolist())]
        live = ~td.deleted
        gone = np.zeros(td.count, bool)
        gone[oids] = True
        staying = live & ~gone
        for child, cols, rcols, act in refs:
            removed = set(zip(*[norm(td, rc, gone) for rc in rcols]))                 if gone.any() else set()
            kept = set(zip(*[norm(td, rc, staying) for rc in rcols]))                 if staying.any() else set()
            removed -= kept
            if not removed:
                continue
            ctd = resolver(child)
            if ctd is None or ctd.count == 0:
                continue
            clive = ~ctd.deleted
            hit = [int(i) for i, combo in zip(
                np.nonzero(clive)[0],
                zip(*[norm(ctd, c, clive) for c in cols]))
                if combo in removed]
            if not hit:
                continue
            if act == "noaction":
                continue          # explicit NO ACTION: unenforced
            if act == "cascade":
                # ON DELETE CASCADE: recursively remove referencing rows
                hit_np = np.asarray(hit, np.int64)
                self._fk_check_delete(ctd, hit_np, resolver=resolver,
                                      deleter=deleter, updater=updater,
                                      extra_fks=extra_fks)
                deleter(child, hit_np)
            elif act == "setnull":
                for c in cols:
                    t = ctd.types[c]
                    if t.kind == Kind.STR:
                        vals = np.full(len(hit), TableData._NIL_CODE,
                                       np.int32)
                    else:
                        vals = np.full(len(hit), t.nil, t.np_dtype)
                    updater(child, c, np.asarray(hit, np.int64), vals)
            else:
                raise ValueError(
                    f"40002!DELETE: FOREIGN KEY constraint "
                    f"violated: {child}({', '.join(cols)}) "
                    f"references {td.name}")

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        name = name.lower()
        if self._txn is not None:
            if if_exists and name not in self.tables:
                return None
            return self._txn.drop_table(name)
        if name not in self.tables:
            if if_exists:
                return
            raise ValueError(f"42S02!unknown table {name}")
        self.tables.pop(name, None)
        self.fks.pop(name, None)
        self._device.pop(name, None)
        self.schema_epoch += 1
        self._log(REC_DROP, {"table": name})

    # -- ALTER TABLE column DDL (sql_cat.c sql_alter_table) ----------------
    def _add_col_apply(self, meta: dict, td: "TableData" = None) -> None:
        if td is None:
            td = self._mutable_td(meta["table"])
        c, t = meta["col"], tag_type(meta["tag"])
        fill = meta.get("fill")
        td.types[c] = t
        td.order.append(c)
        n = td.count
        if t.kind == Kind.STR:
            if fill is None:
                td.dicts[c] = np.empty(0, dtype=str)
                td.cols[c] = np.full(n, TableData._NIL_CODE, np.int32)
            else:
                td.dicts[c] = np.array([str(fill)])
                td.cols[c] = np.zeros(n, np.int32)
        else:
            v = t.nil if fill is None else t.np_dtype.type(fill)
            td.cols[c] = np.full(n, v, t.np_dtype)
        f = meta.get("flags") or {}
        if f.get("notnull"):
            td.notnull.add(c)
        if f.get("unique"):
            td.uniques.add(c)
        if f.get("default") is not None:
            td.defaults[c] = f["default"]
        if f.get("serial"):
            # ALTER ADD COLUMN c serial: backfill existing rows from the
            # new sequence (rel_schema.c serial = seq + default next value)
            seq = f"seq_{td.name}_{c}"
            td.serials[c] = seq
            if seq not in self.sequences:
                self.sequences[seq] = {"next": 1, "inc": 1}
            s = self.sequences[seq]
            first, inc = s["next"], s["inc"]
            td.cols[c] = (first + inc * np.arange(n)).astype(t.np_dtype)
            s["next"] = first + inc * n
        td.version = _next_version()

    def _drop_col_apply(self, table: str, c: str,
                        td: "TableData" = None) -> None:
        if td is None:
            td = self._mutable_td(table)
        td.order.remove(c)
        td.types.pop(c)
        td.cols.pop(c, None)
        td.dicts.pop(c, None)
        td.notnull.discard(c)
        td.uniques.discard(c)
        td.defaults.pop(c, None)
        td.serials.pop(c, None)
        if c in td.pks:
            td.pks.remove(c)
        td.version = _next_version()

    def _rename_col_apply(self, table: str, c: str, new: str,
                          td: "TableData" = None) -> None:
        if td is None:
            td = self._mutable_td(table)
        td.order[td.order.index(c)] = new
        td.types[new] = td.types.pop(c)
        td.cols[new] = td.cols.pop(c)
        if c in td.dicts:
            td.dicts[new] = td.dicts.pop(c)
        if c in td.notnull:
            td.notnull.discard(c)
            td.notnull.add(new)
        if c in td.uniques:
            td.uniques.discard(c)
            td.uniques.add(new)
        if c in td.defaults:
            td.defaults[new] = td.defaults.pop(c)
        if c in td.serials:
            td.serials[new] = td.serials.pop(c)
        td.pks = [new if p == c else p for p in td.pks]
        td.version = _next_version()

    def _rename_table_apply(self, old: str, new: str) -> None:
        td = self._mutable_td(old)
        self.tables.pop(old)
        td.name = new
        self.tables[new] = td
        self._device.pop(old, None)
        td.version = _next_version()

    def alter_add_column(self, table: str, col: str, typ, flags: dict,
                         fill=None) -> None:
        """fill = physical-domain constant used for existing rows (the
        evaluated DEFAULT); JSON-able (int/float/str/None)."""
        table, col = table.lower(), col.lower()
        if self._txn is not None:
            return self._txn.alter_add_column(table, col, typ, flags, fill)
        td = self.tables[table]
        if col in td.types:
            raise ValueError(f"column {col} exists")
        meta = {"op": "add_col", "table": table, "col": col,
                "tag": type_tag(typ), "flags": flags, "fill": fill}
        self._add_col_apply(meta)
        self.schema_epoch += 1
        self._device.pop(table, None)
        self._log(REC_DDL, meta)

    def alter_drop_column(self, table: str, col: str) -> None:
        table, col = table.lower(), col.lower()
        if self._txn is not None:
            return self._txn.alter_drop_column(table, col)
        td = self.tables[table]
        if col not in td.types:
            raise ValueError(f"unknown column {col}")
        if len(td.order) == 1:
            raise ValueError("cannot drop the last column")
        self._drop_col_apply(table, col)
        self.schema_epoch += 1
        self._device.pop(table, None)
        self._log(REC_DDL, {"op": "drop_col", "table": table, "col": col})

    def alter_rename_column(self, table: str, col: str, new: str) -> None:
        table, col, new = table.lower(), col.lower(), new.lower()
        if self._txn is not None:
            return self._txn.alter_rename_column(table, col, new)
        td = self.tables[table]
        if col not in td.types:
            raise ValueError(f"unknown column {col}")
        if new in td.types:
            raise ValueError(f"column {new} exists")
        self._rename_col_apply(table, col, new)
        self.schema_epoch += 1
        self._device.pop(table, None)
        self._log(REC_DDL, {"op": "rename_col", "table": table,
                            "col": col, "new": new})

    def alter_rename_table(self, table: str, new: str) -> None:
        table, new = table.lower(), new.lower()
        if self._txn is not None:
            return self._txn.alter_rename_table(table, new)
        if table not in self.tables:
            raise ValueError(f"unknown table {table}")
        if new in self.tables or new in self.views:
            raise ValueError(f"name {new} exists")
        if self._sql_mentions(table):
            raise ValueError(
                f"2BM37!ALTER TABLE: unable to rename table '{table}', "
                f"there are database objects which depend on it")
        self._rename_table_apply(table, new)
        self.schema_epoch += 1
        self._log(REC_DDL, {"op": "rename_table", "table": table,
                            "new": new})

    # -- triggers / procedures / comments ----------------------------------
    def create_trigger(self, name: str, table: str, time: str, event: str,
                       body: str, replace: bool = False) -> None:
        name = name.lower()
        if name in self.triggers and not replace:
            raise ValueError(f"trigger {name} exists")
        t = {"table": table.lower(), "time": time, "event": event,
             "body": body}
        self.triggers[name] = t
        self._log(REC_DDL, {"op": "put_trigger", "name": name, "trigger": t})

    def drop_trigger(self, name: str) -> None:
        name = name.lower()
        if name not in self.triggers:
            raise ValueError(f"unknown trigger {name}")
        del self.triggers[name]
        self._log(REC_DDL, {"op": "drop_trigger", "name": name})

    def create_procedure(self, name: str, params, body: str) -> None:
        name = name.lower()
        p = {"params": [[n, type_tag(t)] for n, t in params], "body": body}
        self.procedures[name] = p
        self._log(REC_DDL, {"op": "put_proc", "name": name, "proc": p})

    def drop_procedure(self, name: str) -> None:
        name = name.lower()
        if name not in self.procedures:
            raise ValueError(f"unknown procedure {name}")
        del self.procedures[name]
        self._log(REC_DDL, {"op": "drop_proc", "name": name})

    def put_comment(self, key: str, text) -> None:
        if text is None or text == "":
            # COMMENT ... IS NULL / IS '' removes (sql_parser.y comment)
            self.comments.pop(key, None)
            text = None
        else:
            self.comments[key] = text
        self._log(REC_DDL, {"op": "put_comment", "key": key, "text": text})

    # -- schemas (rel_schema.c rel_create_schema / sys.schemas) ------------
    def create_schema(self, name: str, auth=None,
                      if_not_exists: bool = False) -> None:
        name = name.lower()
        if name in self.schemas:
            if if_not_exists:
                return
            raise ValueError(f"schema {name} exists")
        if auth is not None and self.users and \
                auth not in self.users and auth not in self.roles and \
                auth != "monetdb":
            raise ValueError(f"unknown authorization {auth}")
        s = {"auth": auth or "monetdb", "system": False}
        self.schemas[name] = s
        self.schema_epoch += 1
        self._log(REC_DDL, {"op": "put_schema", "name": name, "def": s})

    def drop_schema(self, name: str, if_exists: bool = False,
                    cascade: bool = False) -> None:
        name = name.lower()
        s = self.schemas.get(name)
        if s is None:
            if if_exists:
                return
            raise ValueError(f"unknown schema {name}")
        if s.get("system"):
            raise ValueError(f"cannot drop system schema {name}")
        members = [t for t, sc in self.table_schemas.items() if sc == name]
        if members and not cascade:
            raise ValueError(f"schema {name} not empty")
        for t in members:
            if t in self.views:
                self.drop_view(t)
            elif t in self.tables:
                self.drop_table(t)
            self.table_schemas.pop(t, None)
        del self.schemas[name]
        self.comments.pop(f"schema:{name}", None)
        self.schema_epoch += 1
        self._log(REC_DDL, {"op": "drop_schema", "name": name})

    def _sql_mentions(self, token: str, skip=()) -> bool:
        """Does any view / SQL function / procedure body reference
        ``token`` (word match)?  The dependency probe behind the
        reference's 2BM37 rename refusals (sql_cat.c sql_rename_*
        via the dependency tables)."""
        import re
        pat = re.compile(r'(?<![\w])"?' + re.escape(token) + r'"?(?![\w])',
                         re.IGNORECASE)
        for name, sql in self.views.items():
            if name not in skip and pat.search(sql or ""):
                return True
        for reg in (self.sqlfuncs, self.procedures):
            for name, d in reg.items():
                body = d.get("body", d.get("sql", "")) \
                    if isinstance(d, dict) else str(d)
                if pat.search(body or ""):
                    return True
        return False

    def rename_schema(self, old: str, new: str) -> None:
        """ALTER SCHEMA old RENAME TO new (sql_cat.c sql_rename_schema):
        tables keep their names, their schema mapping follows."""
        old, new = old.lower(), new.lower()
        s = self.schemas.get(old)
        if s is None:
            raise ValueError(f"3F000!ALTER SCHEMA: no such schema "
                             f"'{old}'")
        members = {t for t, sc in self.table_schemas.items() if sc == old}
        deps = any(self._sql_mentions(t, skip=members) for t in members) \
            or self._sql_mentions(old)
        if deps:
            raise ValueError(
                f"2BM37!ALTER SCHEMA: unable to rename schema '{old}', "
                f"there are database objects which depend on it")
        if s.get("system"):
            raise ValueError(f"3F000!ALTER SCHEMA: cannot rename a "
                             f"system schema '{old}'")
        if new in self.schemas:
            raise ValueError(f"3F000!ALTER SCHEMA: schema '{new}' "
                             f"already exists")
        del self.schemas[old]
        self.schemas[new] = s
        for t, sc in list(self.table_schemas.items()):
            if sc == old:
                self.table_schemas[t] = new
        self.schema_epoch += 1
        self._log(REC_DDL, {"op": "rename_schema", "old": old,
                            "new": new})

    def create_index(self, name: str, table: str, cols, unique=False,
                     replace: bool = False) -> None:
        name = name.lower()
        if name in self.indexes and not replace:
            raise ValueError(f"index {name} exists")
        if table.lower() not in self.tables:
            raise ValueError(f"unknown table {table}")
        d = {"table": table.lower(), "cols": [c.lower() for c in cols],
             "unique": bool(unique)}
        self.indexes[name] = d
        self._log(REC_DDL, {"op": "put_index", "name": name, "def": d})

    def drop_index(self, name: str) -> None:
        name = name.lower()
        if name not in self.indexes:
            raise ValueError(f"unknown index {name}")
        del self.indexes[name]
        self._log(REC_DDL, {"op": "drop_index", "name": name})

    def oid(self, kind: str, name: str) -> int:
        """Stable object id for (kind, name) — sys.schemas.id /
        sys._tables.id / sys.comments.id share this space (the
        reference's store-wide id counter)."""
        key = f"{kind}:{name.lower()}"
        i = self.oids.get(key)
        if i is None:
            i = self._next_oid
            self._next_oid += 1
            self.oids[key] = i
            self._log(REC_DDL, {"op": "put_oid", "key": key, "id": i})
        return i

    def set_table_schema(self, table: str, schema: str) -> None:
        self.table_schemas[table.lower()] = schema.lower()
        self.schema_epoch += 1      # qualified-name resolution changed
        self._log(REC_DDL, {"op": "put_tschema",
                            "table": table.lower(),
                            "schema": schema.lower()})

    # -- distribution DDL (merge/remote/replica tables) -------------------
    def _dist_dicts(self):
        return {"merge": self.merges, "remote": self.remotes,
                "replica": self.replicas}

    def put_dist_def(self, d) -> None:
        """Install/replace a MergeDef/RemoteDef/ReplicaDef (also the
        ALTER ADD/DROP TABLE commit path — the whole def is re-logged)."""
        from ..sql.distribute import def_to_json
        j = def_to_json(d)
        name = d.name.lower()
        cur = next((k for k, dd in self._dist_dicts().items()
                    if name in dd), None)
        if cur is None:
            if name in self.tables or name in self.views:
                raise ValueError(f"name {name} exists")
        elif cur != j["kind"]:
            raise ValueError(f"name {name} exists as {cur} table")
        self._dist_dicts()[j["kind"]][name] = d
        self.schema_epoch += 1
        self._log(REC_DDL, {"op": "put", "def": j})

    def drop_dist_def(self, name: str) -> None:
        name = name.lower()
        for kind, dd in self._dist_dicts().items():
            if name in dd:
                del dd[name]
                self.schema_epoch += 1
                self._log(REC_DDL, {"op": "drop", "name": name,
                                    "kind": kind})
                return
        raise ValueError(f"unknown distributed table {name}")

    # -- UDFs (persisted by re-compiling source at replay) ----------------
    @staticmethod
    def _udf_json(u) -> dict:
        return {"name": u.name, "args": [[n, type_tag(t)] for n, t in
                                         zip(u.arg_names, u.arg_types)],
                "ret": type_tag(u.ret_type), "body": u.body}

    @staticmethod
    def _udf_from_json(j):
        from ..udf import compile_python_udf
        return compile_python_udf(
            j["name"], [n for n, _t in j["args"]],
            [tag_type(t) for _n, t in j["args"]],
            tag_type(j["ret"]), j["body"])

    def create_function(self, udf) -> None:
        self.udfs[udf.name] = udf
        self.schema_epoch += 1
        if udf.body is not None:     # programmatic UDFs are not durable
            self._log(REC_DDL, {"op": "put_udf", "udf": self._udf_json(udf)})

    def drop_function(self, name: str) -> None:
        name = name.lower()
        if name in self.sqlfuncs:
            del self.sqlfuncs[name]
            self.schema_epoch += 1
            self._log(REC_DDL, {"op": "drop_sqlfunc", "name": name})
            return
        if name not in self.udfs:
            raise ValueError(f"unknown function {name}")
        del self.udfs[name]
        self.schema_epoch += 1
        self._log(REC_DDL, {"op": "drop_udf", "name": name})

    # -- roles & privileges (sql_user.c / sql_privileges.c) ----------------
    ADMIN = "monetdb"      # the reference's default administrator account

    def create_role(self, name: str) -> None:
        name = name.lower()
        if name in self.roles:
            raise ValueError(f"role {name} exists")
        self.roles[name] = []
        self._log(REC_DDL, {"op": "put_role", "name": name})

    def drop_role(self, name: str) -> None:
        name = name.lower()
        if name not in self.roles:
            raise ValueError(f"unknown role {name}")
        del self.roles[name]
        self._log(REC_DDL, {"op": "drop_role", "name": name})

    def grant_role(self, role: str, user: str) -> None:
        role, user = role.lower(), user.lower()
        if role not in self.roles:
            raise ValueError(f"unknown role {role}")
        if user not in self.roles[role]:
            self.roles[role].append(user)
        self._log(REC_DDL, {"op": "put_member", "role": role, "user": user})

    def revoke_role(self, role: str, user: str) -> None:
        role, user = role.lower(), user.lower()
        if user in self.roles.get(role, []):
            self.roles[role].remove(user)
        self._log(REC_DDL, {"op": "drop_member", "role": role,
                            "user": user})

    def grant(self, privs: List[str], table: str, grantee: str) -> None:
        table, grantee = table.lower(), grantee.lower()
        d = self.grants.setdefault(grantee, {})
        ps = d.setdefault(table, [])
        for p in privs:
            if p not in ps:
                ps.append(p)
        self._log(REC_DDL, {"op": "put_grant", "grantee": grantee,
                            "table": table, "privs": list(privs)})

    def revoke(self, privs: List[str], table: str, grantee: str) -> None:
        table, grantee = table.lower(), grantee.lower()
        ps = self.grants.get(grantee, {}).get(table, [])
        for p in privs:
            if p in ps:
                ps.remove(p)
        self._log(REC_DDL, {"op": "drop_grant", "grantee": grantee,
                            "table": table, "privs": list(privs)})

    def set_owner(self, table: str, user: str) -> None:
        self.owners[table.lower()] = user.lower()
        self._log(REC_DDL, {"op": "put_owner", "table": table.lower(),
                            "user": user.lower()})

    def effective_privs(self, user: str, table: str,
                        active_role: Optional[str] = None) -> set:
        """Union of the user's direct grants, grants to roles the user is
        a member of (MonetDB requires SET ROLE; we honor both the active
        role and memberships), and PUBLIC grants."""
        user, table = user.lower(), table.lower()
        out = set(self.grants.get(user, {}).get(table, []))
        out |= set(self.grants.get("public", {}).get(table, []))
        for role, members in self.roles.items():
            if user in members or role == active_role:
                out |= set(self.grants.get(role, {}).get(table, []))
        if active_role:
            out |= set(self.grants.get(active_role, {}).get(table, []))
        return out

    def is_admin(self, user: Optional[str]) -> bool:
        return user is None or user.lower() in (self.ADMIN, "monetdbe",
                                                "admin")

    def create_sqlfunc(self, name: str, params, ret, body: str,
                       kind: str = "scalar", cols=None) -> None:
        name = name.lower()
        f = {"params": [[n, type_tag(t)] for n, t in params],
             "ret": type_tag(ret) if ret is not None else None,
             "body": body, "kind": kind}
        if cols:
            # table function result signature (RETURNS TABLE(...))
            f["cols"] = [[n, type_tag(t)] for n, t in cols]
        self.sqlfuncs[name] = f
        self.schema_epoch += 1
        self._log(REC_DDL, {"op": "put_sqlfunc", "name": name, "func": f})

    # -- sequences (store_sequence.c) -------------------------------------
    def create_sequence(self, name: str, start: int = 1,
                        inc: int = 1, minv=None, maxv=None) -> None:
        name = name.lower()
        if name in self.sequences:
            raise ValueError(f"sequence {name} exists")
        if minv is not None and start < minv:
            raise ValueError(f"start {start} below MINVALUE {minv}")
        if maxv is not None and start > maxv:
            raise ValueError(f"start {start} above MAXVALUE {maxv}")
        s = {"next": int(start), "inc": int(inc)}
        if minv is not None:
            s["min"] = int(minv)
        if maxv is not None:
            s["max"] = int(maxv)
        self.sequences[name] = s
        self._log(REC_DDL, {"op": "put_seq", "name": name, **s})

    def alter_sequence(self, name: str, restart=None, inc=None) -> None:
        """ALTER SEQUENCE RESTART/INCREMENT (store_sequence.c)."""
        name = name.lower()
        seq = self.sequences.get(name)
        if seq is None:
            raise ValueError(f"unknown sequence {name}")
        if restart is not None:
            v = seq.get("min", 1) if restart == "min" else int(restart)
            if "min" in seq and v < seq["min"]:
                raise ValueError(f"restart {v} below MINVALUE")
            if "max" in seq and v > seq["max"]:
                raise ValueError(f"restart {v} above MAXVALUE")
            seq["next"] = v
        if inc is not None:
            seq["inc"] = int(inc)
        self._log(REC_DDL, {"op": "put_seq", "name": name, **seq})

    def drop_sequence(self, name: str) -> None:
        name = name.lower()
        if name not in self.sequences:
            raise ValueError(f"unknown sequence {name}")
        del self.sequences[name]
        self._log(REC_DDL, {"op": "drop_seq", "name": name})

    def next_sequence_block(self, name: str, n: int = 1) -> int:
        """Reserve n consecutive values; returns the first. The advanced
        state is WAL-logged so replay never reissues values
        (store_sequence.c sequences_lock + logger the same way)."""
        name = name.lower()
        seq = self.sequences.get(name)
        if seq is None:
            raise ValueError(f"unknown sequence {name}")
        first = seq["next"]
        last = first + (n - 1) * seq["inc"]
        # NO CYCLE semantics: exceeding a declared bound errors
        # (store_sequence.c sequence_next_value overflow check)
        if "max" in seq and max(first, last) > seq["max"]:
            raise ValueError(
                f"sequence {name} exceeds MAXVALUE {seq['max']}")
        if "min" in seq and min(first, last) < seq["min"]:
            raise ValueError(
                f"sequence {name} below MINVALUE {seq['min']}")
        seq["next"] = first + n * seq["inc"]
        self._log(REC_DDL, {"op": "put_seq", "name": name, **seq})
        return first

    # -- users (sql_user.c / mal_authorize.c) -----------------------------
    def create_user(self, name: str, password: str) -> None:
        import hashlib
        self.users[name] = hashlib.sha512(password.encode()).hexdigest()
        self._log(REC_DDL, {"op": "put_user", "name": name,
                            "hash": self.users[name]})

    def drop_user(self, name: str) -> None:
        if name not in self.users:
            raise ValueError(f"unknown user {name}")
        del self.users[name]
        self._log(REC_DDL, {"op": "drop_user", "name": name})

    def create_view(self, name: str, sql: str,
                    replace: bool = False) -> None:
        name = name.lower()
        if name in self.tables or (name in self.views and not replace):
            raise ValueError(f"name {name} exists")
        self.views[name] = sql
        self.schema_epoch += 1
        self._log(REC_CREATE_VIEW, {"view": name, "sql": sql})

    def drop_view(self, name: str) -> None:
        name = name.lower()
        if name not in self.views:
            raise ValueError(f"unknown view {name}")
        del self.views[name]
        self.schema_epoch += 1
        self._log(REC_DROP_VIEW, {"view": name})

    def _eval_check_violations(self, td: TableData,
                               arrays: Dict[str, np.ndarray],
                               expr_sql: str) -> int:
        """Rows in the candidate batch where the CHECK predicate is
        exactly FALSE (nil passes).  Evaluated by binding
        ``select count(*) from <batch> where not (expr)`` over a
        temporary in-memory table of the batch."""
        from ..engine import Engine
        from ..table import Catalog, Table
        from ..column import Column
        from ..dtypes import Kind as _K
        cols = {}
        for c in td.order:
            t = td.types[c]
            if c not in arrays:
                continue
            a = arrays[c]
            if t.kind == _K.STR:
                nil = str_nilmask(a)
                vals = np.where(nil, "", a).astype(str)
                col = Column.from_strings(vals, t, device=self.device)
                nilpos = np.nonzero(nil)[0]
                if len(nilpos):
                    codes = col.data[: col.count].cpu().numpy().copy()
                    codes[nilpos] = -1
                    col = Column.from_numpy(codes, t, sdict=col.sdict,
                                            nonil=False, device=self.device)
            else:
                col = Column.from_numpy(
                    np.asarray(a, t.np_dtype), t, device=self.device)
            cols[c] = col
        cat = Catalog()
        cat.device = self.device
        cat.add(Table.from_dict("_check_batch", cols))
        res = Engine(cat).query(
            f"select count(*) from _check_batch where not ({expr_sql})")
        return int(res.rows[0][0])

    def _check_constraints(self, td: TableData,
                           arrays: Dict[str, np.ndarray],
                           resolver=None, extra_fks=None) -> None:
        """NOT NULL + PRIMARY KEY enforcement (the reference checks at
        append time too: sql/storage/bat/bat_storage.c key/null checks,
        sql_cat.c constraint DDL)."""
        from ..dtypes import is_nil_np

        def nilmask(c: str) -> np.ndarray:
            a = arrays[c]
            if td.types[c].kind == Kind.STR:
                return str_nilmask(a)
            if td.types[c].np_dtype.kind == "b":
                # bool columns are nonil in practice (False is a value,
                # not the sentinel)
                return np.zeros(len(a), dtype=bool)
            return is_nil_np(np.asarray(a, td.types[c].np_dtype),
                             td.types[c])

        for c in td.notnull:
            if c in arrays and nilmask(c).any():
                raise ValueError(f"NOT NULL constraint violated for "
                                 f"{td.name}.{c}")
        for c in td.order:
            # decimal precision envelope (22003): a decimal(p,s) value
            # must fit p digits scaled (gdk_calc convert checks)
            t = td.types[c]
            if c in arrays and t.kind == Kind.DECIMAL and \
                    0 < t.precision < 19:
                lim = 10 ** t.precision
                vals = np.asarray(arrays[c])
                from ..dtypes import is_nil_np
                bad = (~is_nil_np(vals, t)) & (np.abs(vals) >= lim)
                if bad.any():
                    raise ValueError(
                        f"22003!value exceeds decimal({t.precision},"
                        f"{t.scale}) range for {td.name}.{c}")
        if td.pks or td.uniques or getattr(td, "unique_sets", ()) or \
                getattr(td, "checks", ()) or self.fks.get(td.name) or \
                (extra_fks or {}).get(td.name):
            # the checks below compare values: a Categorical as its strings
            arrays = {c: a.decode() if isinstance(a, Categorical) else a
                      for c, a in arrays.items()}
        self._fk_check_insert(td, arrays, resolver, extra_fks)
        for uset in getattr(td, "unique_sets", ()):
            if not all(c in arrays for c in uset):
                continue
            live = ~td.deleted

            def norm_new(c):
                t = td.types[c]
                if t.kind == Kind.STR:
                    return [None if v is None else str(v)
                            for v in arrays[c]]
                return [None if b else v for v, b in
                        zip(np.asarray(arrays[c]).tolist(),
                            nilmask(c).tolist())]

            def norm_old(c):
                t = td.types[c]
                col = td.cols[c][live]
                if t.kind == Kind.STR:
                    d = td.dicts[c]
                    return [None if k < 0 else str(d[k]) for k in col]
                from ..dtypes import is_nil_np
                nm = is_nil_np(col, t)
                return [None if b else v for v, b in
                        zip(col.tolist(), nm.tolist())]
            newt = list(zip(*[norm_new(c) for c in uset]))
            oldt = set(zip(*[norm_old(c) for c in uset])) \
                if td.count else set()
            if len(set(newt)) != len(newt) or set(newt) & oldt:
                raise ValueError(
                    f"40002!UNIQUE constraint violated for "
                    f"{td.name}({', '.join(uset)})")
        for cname, expr_sql in getattr(td, "checks", ()):
            # CHECK enforcement over the candidate batch (the reference
            # checks in the append path too; 40002 violation class).
            # NULL check results pass (SQL 3-valued CHECK semantics), so
            # a row violates only when the predicate is exactly FALSE.
            n_bad = self._eval_check_violations(td, arrays, expr_sql)
            if n_bad:
                raise ValueError(
                    f"40002!INSERT INTO: violated constraint "
                    f"'sys.{cname}' CHECK({expr_sql})")
        for c in td.uniques:
            if c not in arrays:
                continue
            live = ~td.deleted
            nm = nilmask(c)
            if td.types[c].kind == Kind.STR:
                newv = [str(v) for v, isnil in zip(arrays[c], nm)
                        if not isnil]
                oldc = td.cols[c][live]
                oldv = [str(td.dicts[c][k]) for k in oldc if k >= 0]
            else:
                newv = list(np.asarray(arrays[c])[~nm])
                old = td.cols[c][live]
                from ..dtypes import is_nil_np
                oldv = list(old[~is_nil_np(old, td.types[c])])
            if len(set(newv)) != len(newv) or set(newv) & set(oldv):
                raise ValueError(
                    f"UNIQUE constraint violated for {td.name}.{c}")
        if td.pks and all(c in arrays for c in td.pks):
            live = ~td.deleted

            def keyvals(c: str):
                new = arrays[c]
                if td.types[c].kind == Kind.STR:
                    old_codes = td.cols[c][live]
                    old = [None if k < 0 else td.dicts[c][k]
                           for k in old_codes]
                    return list(old), [v for v in new]
                return list(td.cols[c][live]), list(np.asarray(new))

            olds, news = zip(*(keyvals(c) for c in td.pks)) if td.pks \
                else ((), ())
            new_keys = list(zip(*news)) if news else []
            if len(set(new_keys)) != len(new_keys):
                raise ValueError(
                    f"PRIMARY KEY constraint violated for {td.name}")
            if olds and len(olds[0]):
                existing = set(zip(*olds))
                if existing & set(new_keys):
                    raise ValueError(
                        f"PRIMARY KEY constraint violated for {td.name}")

    def check_update_constraints(self, td: TableData, oids: np.ndarray,
                                 colvals: Dict[str, np.ndarray],
                                 resolver=None,
                                 extra_fks=None) -> None:
        """Constraint enforcement for UPDATE (ADVICE r4: updates used to
        check only CHECK constraints).  ``colvals``: lower-cased SET
        column -> new physical values aligned with ``oids``.  Enforces:
        * child-side FK: updated key combos must exist in the parent;
        * parent-side FK: a referenced key value may not be updated away
          while children still reference it (RESTRICT, 40002 - the
          reference has no ON UPDATE actions either);
        * PRIMARY KEY / UNIQUE: the post-update column set must stay
          unique across live rows (40002)."""
        from ..dtypes import is_nil_np
        if resolver is None:
            resolver = self.tables.get
        oids = np.asarray(oids, np.int64)

        def stored_vals(src_td, c, sel=None):
            """Stored column -> comparable python values (None = nil),
            matching _fk_check_insert's norm(); ``sel`` optional mask."""
            t = src_td.types[c]
            vals = src_td.cols[c] if sel is None else src_td.cols[c][sel]
            if t.kind == Kind.STR:
                d = src_td.dicts[c]
                return [None if k < 0 else str(d[k])
                        for k in vals.tolist()]
            nm = is_nil_np(vals, t)
            return [None if b else v
                    for v, b in zip(vals.tolist(), nm.tolist())]

        def new_vals(c):
            """SET values for column c -> comparable python values."""
            t = td.types[c]
            nv = colvals[c]
            if t.kind == Kind.STR:
                seq = nv.tolist() if hasattr(nv, "tolist") else nv
                return [None if v is None else str(v) for v in seq]
            a = np.asarray(nv, t.np_dtype)
            nm = is_nil_np(a, t)
            return [None if b else v
                    for v, b in zip(a.tolist(), nm.tolist())]

        def post_col(c):
            """Post-update comparable values of column c over ALL rows
            (index-aligned with td.cols); updated rows patched in."""
            cur = stored_vals(td, c)
            if c in colvals:
                for o, v in zip(oids.tolist(), new_vals(c)):
                    cur[o] = v
            return cur

        live_idx = np.nonzero(~td.deleted)[0].tolist()
        touched = set(colvals)

        # -- NOT NULL on updated columns ---------------------------------
        for c in set(td.notnull) | set(td.pks):
            if c in colvals and any(v is None for v in new_vals(c)):
                raise ValueError(
                    f"40002!UPDATE: NOT NULL constraint violated for "
                    f"{td.name}.{c}")

        # -- child-side FK: new combos must resolve in the parent --------
        ents = list(self.fks.get(td.name, ())) + \
            list((extra_fks or {}).get(td.name, ()))
        for cols, rtab, rcols, _act in map(self._fk4, ents):
            if not touched & set(cols):
                continue
            parent = resolver(rtab)
            if parent is None:
                continue
            plive = ~parent.deleted
            have = set()
            if parent.count:
                have = set(zip(*[stored_vals(parent, rc, plive)
                                 for rc in rcols]))
            post = [post_col(c) for c in cols]
            for o in oids.tolist():
                combo = tuple(p[o] for p in post)
                if any(v is None for v in combo):
                    continue
                if combo not in have:
                    raise ValueError(
                        f"40002!UPDATE: FOREIGN KEY constraint "
                        f"violated: {td.name}({', '.join(cols)}) -> "
                        f"{rtab}")

        # -- parent-side FK: referenced values updated away --------------
        import itertools
        src = itertools.chain(self.fks.items(),
                              (extra_fks or {}).items())
        for child, lst in src:
            for cols, rtab, rcols, act in map(self._fk4, lst):
                if rtab != td.name or not touched & set(rcols):
                    continue
                if act == "noaction":
                    # explicit NO ACTION: unenforced (MonetDB pins this:
                    # Update_Delete_action__update_no_action.test allows
                    # dangling children after a parent-key update)
                    continue
                post = {rc: post_col(rc) for rc in rcols}
                pre = {rc: stored_vals(td, rc) for rc in rcols}
                kept = set(tuple(post[rc][i] for rc in rcols)
                           for i in live_idx)
                removed = set(tuple(pre[rc][int(o)] for rc in rcols)
                              for o in oids) - kept
                removed.discard(tuple([None] * len(rcols)))
                if not removed:
                    continue
                ctd = resolver(child)
                if ctd is None or ctd.count == 0:
                    continue
                clive = ~ctd.deleted
                ccols = [stored_vals(ctd, c, clive) for c in cols]
                if any(combo in removed for combo in zip(*ccols)):
                    raise ValueError(
                        f"40002!UPDATE: FOREIGN KEY constraint "
                        f"violated: {child}({', '.join(cols)}) "
                        f"references {td.name}")

        # -- PK / UNIQUE: post-update uniqueness --------------------------
        keysets = []
        if td.pks and touched & set(td.pks):
            keysets.append((list(td.pks), True))
        for c in getattr(td, "uniques", ()):
            if c in touched:
                keysets.append(([c], False))
        for uset in getattr(td, "unique_sets", ()):
            if touched & set(uset):
                keysets.append((list(uset), False))
        for cols, is_pk in keysets:
            post = [post_col(c) for c in cols]
            seen = set()
            for i in live_idx:
                combo = tuple(p[i] for p in post)
                if not is_pk and any(v is None for v in combo):
                    continue               # nils never collide (UNIQUE)
                if combo in seen:
                    what = "PRIMARY KEY" if is_pk else "UNIQUE"
                    raise ValueError(
                        f"40002!UPDATE: {what} constraint violated "
                        f"for {td.name}({', '.join(cols)})")
                seen.add(combo)

    def insert(self, name: str, arrays: Dict[str, np.ndarray]) -> int:
        name = name.lower()
        if self._txn is not None:
            return self._txn.insert(name, arrays)
        td = self._mutable_td(name)
        arrays = _checked_batch(arrays)
        n = _rows(arrays)
        with PROFILER.span("load.append", "append_ns",
                           count=("append_rows", n)):
            self._check_constraints(td, arrays)
            td._append(arrays)
            self._log(REC_INSERT, {"table": name}, arrays)
        self._device.pop(name, None)
        return n

    def delete(self, name: str, oids: np.ndarray) -> int:
        name = name.lower()
        if self._txn is not None:
            return self._txn.delete(name, oids)
        self._fk_check_delete(self.tables[name], np.asarray(oids))
        self._mutable_td(name).delete_oids(oids)
        self._log(REC_DELETE, {"table": name},
                  {"oids": oids.astype(np.int64)})
        self._device.pop(name, None)
        return len(oids)

    def update(self, name: str, col: str, oids: np.ndarray,
               vals: np.ndarray) -> int:
        name = name.lower()
        if self._txn is not None:
            return self._txn.update(name, col, oids, vals)
        self._mutable_td(name).update_col(col.lower(), oids, vals)
        self._log(REC_UPDATE, {"table": name, "col": col.lower()},
                  {"oids": oids.astype(np.int64), "vals": vals})
        self._device.pop(name, None)
        return len(oids)

    # ======================================================================
    # device materialization (the sql.bind/tid delta read path)
    # ======================================================================
    def table(self, name: str) -> Tuple[Table, Optional[np.ndarray]]:
        """Device Table of visible rows + vis_oids (device row → storage oid
        mapping, the tid candidate list; None while no row is deleted,
        when device row = storage oid)."""
        name = name.lower()
        if self._txn is not None:
            return self._txn.table(name)
        return self._materialize(name, self.tables[name], self._device)

    def _materialize(self, name: str, td: TableData, cache: dict) \
            -> Tuple[Table, Optional[np.ndarray]]:
        """Upload the visible rows of ``td`` to the store's device, once
        per table version (``cache``: name → (version, Table, vis_oids)):
        each column's live values as they are (no copy through the
        visibility mask while nothing is deleted), padded and scanned for
        its flags on the device; the hidden ``__rowid__`` is made there
        only when a statement reads it."""
        cached = cache.get(name)
        if cached is not None and cached[0] == td.version:
            return cached[1], cached[2]
        with PROFILER.span("load.upload", "upload_ns") as sp:
            vis_oids = np.nonzero(~td.deleted)[0] if td.deleted.any() \
                else None
            cols = {}
            nbytes = 0
            for c in td.order:
                t = td.types[c]
                arr = td.cols[c] if vis_oids is None else td.cols[c][vis_oids]
                nbytes += arr.nbytes
                cols[c] = make_device_column(
                    arr, t, td.dicts.get(c) if t.kind == Kind.STR else None,
                    device=self.device, code_flags=True,
                    clock="upload_copy_ns")
            count = td.count if vis_oids is None else len(vis_oids)
            cols["__rowid__"] = RowidColumn(count, self.device, vis_oids)
            tbl = Table.from_dict(name, cols)
            sp.add_count("upload_bytes", nbytes)
        cache[name] = (td.version, tbl, vis_oids)
        return tbl, vis_oids

    def catalog(self, txn: Optional["Transaction"] = None) -> Catalog:
        txn = txn if txn is not None else self._txn
        cat = Catalog()
        cat.device = self.device
        if txn is not None:
            for name in txn.visible_tables():
                cat.add(txn.table(name)[0])
        else:
            for name in self.tables:
                cat.add(self.table(name)[0])
        cat.views = dict(self.views)
        cat.merges = dict(self.merges)
        cat.remotes = dict(self.remotes)
        cat.replicas = dict(self.replicas)
        cat.udfs = dict(self.udfs)
        cat.sequences = self.sequences
        cat.next_sequence_block = self.next_sequence_block
        cat.triggers = self.triggers
        cat.comments = self.comments
        cat.procedures = self.procedures
        cat.sqlfuncs = self.sqlfuncs
        cat.schemas = self.schemas
        cat.table_schemas = self.table_schemas
        if txn is not None and getattr(txn, "schema_moves", None):
            # txn-local ALTER TABLE SET SCHEMA visibility (applied to
            # the store only at commit)
            cat.table_schemas = {**self.table_schemas,
                                 **txn.schema_moves}
        cat.users = self.users
        cat.roles = self.roles
        cat.oid = self.oid
        cat.indexes = self.indexes
        return cat

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()

def _locked(fn):
    """Serialize mutations under the store lock (store.c store_lock)."""
    import functools

    @functools.wraps(fn)
    def wrap(self, *a, **kw):
        with self._mu:
            return fn(self, *a, **kw)
    return wrap


for _m in ("create_table", "drop_table", "insert", "delete", "update",
           "begin", "commit", "rollback", "checkpoint", "table"):
    setattr(Database, _m, _locked(getattr(Database, _m)))


class Transaction:
    """Snapshot-isolation transaction (sql_trans, sql/storage/store.c:3889):
    reads see the committed state as of begin; writes go to private
    copy-on-write table versions; commit validates first-committer-wins
    against the store (store.c:3980 write-conflict check) and installs all
    versions + the WAL record group atomically. Concurrent sessions each
    hold their own Transaction over one shared Database."""

    def __init__(self, db: Database):
        self.db = db
        with db._mu:
            self.snapshot: Dict[str, TableData] = dict(db.tables)
            db._snapshot_pins += 1
        self.writes: Dict[str, TableData] = {}
        self.created: set = set()
        self.dropped: set = set()
        # FOREIGN KEYs declared inside this txn: staged here, enforced
        # against the txn's state, installed + logged only at commit
        # (ADVICE r4: immediate registration leaked phantom constraints
        # past ROLLBACK and into WAL replay)
        self.fks_add: Dict[str, list] = {}
        # ALTER TABLE SET SCHEMA moves staged in this txn (table ->
        # new schema); visible through catalog(), applied at commit
        self.schema_moves: Dict[str, str] = {}
        # buffered WAL records, flushed as one commit group (log_tstart/
        # log_tend grouping, gdk/gdk_logger.c:3464)
        self.recs: List[Tuple[int, dict, Dict[str, np.ndarray]]] = []
        self._device: Dict[str, Tuple[int, Table, np.ndarray]] = {}
        self.done = False
        # SAVEPOINT name → captured write-state (sql_parser.y savepoint;
        # the reference nests sql_trans the same way)
        self._savepoints: Dict[str, tuple] = {}

    # -- savepoints --------------------------------------------------------
    def savepoint(self, name: str) -> None:
        self._savepoints[name.lower()] = (
            {n: td.copy() for n, td in self.writes.items()},
            set(self.created), set(self.dropped), list(self.recs),
            {n: list(v) for n, v in self.fks_add.items()},
            dict(self.schema_moves))

    def rollback_to(self, name: str) -> None:
        st = self._savepoints.get(name.lower())
        if st is None:
            raise ValueError(f"3B001!no such savepoint {name!r}")
        writes, created, dropped, recs, fks_add, moves = st
        self.writes = {n: td.copy() for n, td in writes.items()}
        self.created = set(created)
        self.dropped = set(dropped)
        self.recs = list(recs)
        self.fks_add = {n: list(v) for n, v in fks_add.items()}
        self.schema_moves = dict(moves)
        self._device.clear()
        # savepoints set after this one vanish (SQL standard)
        names = list(self._savepoints)
        for n in names[names.index(name.lower()) + 1:]:
            del self._savepoints[n]

    def release(self, name: str) -> None:
        if name.lower() not in self._savepoints:
            raise ValueError(f"3B001!no such savepoint {name!r}")
        del self._savepoints[name.lower()]

    # -- reads -------------------------------------------------------------
    def visible_tables(self) -> List[str]:
        names = [n for n in self.snapshot if n not in self.dropped]
        names += [n for n in self.writes if n not in self.snapshot]
        return names

    def tabledata(self, name: str) -> TableData:
        name = name.lower()
        if name in self.dropped:
            raise KeyError(name)
        if name in self.writes:
            return self.writes[name]
        return self.snapshot[name]

    def table(self, name: str) -> Tuple[Table, np.ndarray]:
        name = name.lower()
        td = self.tabledata(name)
        if name not in self.writes:
            with self.db._mu:
                # unmodified table still current in the store: share the
                # store-wide device cache instead of materializing again
                if self.db.tables.get(name) is td:
                    return self.db._materialize(name, td, self.db._device)
        return self.db._materialize(name, td, self._device)

    def _writable(self, name: str) -> TableData:
        name = name.lower()
        td = self.writes.get(name)
        if td is None:
            td = self.tabledata(name).copy()
            self.writes[name] = td
        return td

    def _wal_arrays(self, arrays: Dict[str, np.ndarray]) \
            -> Dict[str, np.ndarray]:
        """A buffered record's arrays, encoded for the WAL now and in
        memory of their own (the caller may refill its buffers before
        COMMIT); none for a store without a WAL, which never writes
        them."""
        if self.db.wal is None:
            return {}
        return {k: np.array(a) for k, a in
                Database._wal_encode(arrays).items()}

    # -- DML -----------------------------------------------------------------
    def insert(self, name: str, arrays: Dict[str, np.ndarray]) -> int:
        name = name.lower()
        arrays = _checked_batch(arrays)
        td = self._writable(name)

        def _parent(n):
            try:
                return self.tabledata(n)
            except KeyError:
                return None
        n = _rows(arrays)
        with PROFILER.span("load.append", "append_ns",
                           count=("append_rows", n)):
            self.db._check_constraints(td, arrays, resolver=_parent,
                                       extra_fks=self.fks_add)
            td._append(arrays)
            self.recs.append((REC_INSERT, {"table": name},
                              self._wal_arrays(arrays)))
        self._device.pop(name, None)
        return n

    def delete(self, name: str, oids: np.ndarray) -> int:
        name = name.lower()

        # FK enforcement against the txn's visible state, with CASCADE /
        # SET NULL side effects buffered into this txn's write set + WAL
        # record group (ADVICE r4: the autocommit-only check let a txn
        # commit dangling child references)
        def _resolve(n):
            try:
                return self.tabledata(n)
            except KeyError:
                return None

        def _deleter(child, coids):
            self._writable(child).delete_oids(coids)
            self._device.pop(child, None)
            self.recs.append((REC_DELETE, {"table": child},
                              self._wal_arrays({"oids": coids})))

        def _updater(child, col, coids, vals):
            self._writable(child).update_col(col, coids, vals)
            self._device.pop(child, None)
            self.recs.append((REC_UPDATE, {"table": child, "col": col},
                              self._wal_arrays({"oids": coids,
                                                "vals": vals})))
        self.db._fk_check_delete(self.tabledata(name),
                                 np.asarray(oids, np.int64),
                                 resolver=_resolve, deleter=_deleter,
                                 updater=_updater,
                                 extra_fks=self.fks_add)
        self._writable(name).delete_oids(oids)
        self._device.pop(name, None)
        self.recs.append((REC_DELETE, {"table": name},
                          self._wal_arrays({"oids": oids.astype(np.int64)})))
        return len(oids)

    def update(self, name: str, col: str, oids: np.ndarray,
               vals: np.ndarray) -> int:
        name = name.lower()
        self._writable(name).update_col(col.lower(), oids, vals)
        self._device.pop(name, None)
        self.recs.append((REC_UPDATE, {"table": name, "col": col.lower()},
                          self._wal_arrays({"oids": oids.astype(np.int64),
                                            "vals": vals})))
        return len(oids)

    # -- transactional DDL (create/drop table inside START TRANSACTION) ------
    def create_table(self, name: str, schema, flags=None) -> None:
        name = name.lower()
        if (name in self.snapshot and name not in self.dropped) \
                or name in self.writes:
            raise ValueError(f"table {name} exists")
        flags = {c.lower(): f for c, f in (flags or {}).items()}
        td = TableData(name, [(c.lower(), t) for c, t in schema], flags)
        self.writes[name] = td
        self.created.add(name)
        self.dropped.discard(name)
        for _c, seq in td.serials.items():
            # sequences are non-transactional (store_sequence.c: values are
            # never reissued, even across rollback)
            if seq not in self.db.sequences:
                self.db.create_sequence(seq)
        self.recs.append((REC_CREATE, {"table": name, "schema": [
            [c.lower(), type_tag(t)] for c, t in schema],
            "flags": flags}, {}))

    def add_foreign_keys(self, name: str, fks: list,
                         lookup=None) -> None:
        """Stage FOREIGN KEY constraints for a txn-created table:
        validated now against the txn's visible state, installed and
        WAL-logged only at commit (rollback discards them)."""
        name = name.lower()
        if lookup is None:
            def lookup(n):
                try:
                    return self.tabledata(n)
                except KeyError:
                    return None
        for ent in fks:
            entry = Database._fk_validate(ent, lookup)
            self.fks_add.setdefault(name, []).append(entry)
        # one WAL record with the table's full staged list (replay
        # replaces wholesale, matching Database.add_foreign_keys)
        self.recs = [r for r in self.recs
                     if not (r[0] == REC_DDL and
                             r[1].get("op") == "add_fks" and
                             r[1].get("table") == name)]
        self.recs.append((REC_DDL, {"op": "add_fks", "table": name,
                                    "fks": [[list(e[0]), e[1],
                                             list(e[2]), e[3]]
                                            for e in self.fks_add[name]]},
                          {}))

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        name = name.lower()
        if if_exists:
            try:
                self.tabledata(name)
            except KeyError:
                return
        self.tabledata(name)          # raises KeyError if not visible
        self.writes.pop(name, None)
        self.created.discard(name)
        self.fks_add.pop(name, None)
        if name in self.snapshot:
            self.dropped.add(name)
        self._device.pop(name, None)
        self.recs.append((REC_DROP, {"table": name}, {}))

    # -- transactional ALTER (sql_cat.c alters run inside the txn) -----------
    def alter_add_column(self, table: str, col: str, typ, flags: dict,
                         fill=None) -> None:
        table, col = table.lower(), col.lower()
        if col in self.tabledata(table).types:
            raise ValueError(f"column {col} exists")
        td = self._writable(table)
        meta = {"op": "add_col", "table": table, "col": col,
                "tag": type_tag(typ), "flags": flags, "fill": fill}
        self.db._add_col_apply(meta, td)
        self._device.pop(table, None)
        self.recs.append((REC_DDL, meta, {}))

    def alter_drop_column(self, table: str, col: str) -> None:
        table, col = table.lower(), col.lower()
        vtd = self.tabledata(table)
        if col not in vtd.types:
            raise ValueError(f"unknown column {col}")
        if len(vtd.order) == 1:
            raise ValueError("cannot drop the last column")
        td = self._writable(table)
        self.db._drop_col_apply(table, col, td)
        self._device.pop(table, None)
        self.recs.append((REC_DDL, {"op": "drop_col", "table": table,
                                    "col": col}, {}))

    def alter_rename_column(self, table: str, col: str, new: str) -> None:
        table, col, new = table.lower(), col.lower(), new.lower()
        vtd = self.tabledata(table)
        if col not in vtd.types:
            raise ValueError(f"unknown column {col}")
        if new in vtd.types:
            raise ValueError(f"column {new} exists")
        td = self._writable(table)
        self.db._rename_col_apply(table, col, new, td)
        self._device.pop(table, None)
        self.recs.append((REC_DDL, {"op": "rename_col", "table": table,
                                    "col": col, "new": new}, {}))

    def alter_rename_table(self, table: str, new: str) -> None:
        table, new = table.lower(), new.lower()
        if new in self.visible_tables() or new in self.db.views:
            raise ValueError(f"name {new} exists")
        td = self._writable(table)    # raises if not visible
        self.writes.pop(table, None)
        td.name = new
        self.writes[new] = td
        self.created.add(new)
        if table in self.snapshot:
            self.dropped.add(table)
        self.created.discard(table)
        self._device.pop(table, None)
        self.recs.append((REC_DDL, {"op": "rename_table", "table": table,
                                    "new": new}, {}))

    # -- end ------------------------------------------------------------------
    def commit(self) -> None:
        if self.done:
            raise RuntimeError("transaction already finished")
        db = self.db
        with db._mu:
            try:
                for name in set(self.writes) | self.dropped:
                    cur = db.tables.get(name)
                    if name in self.created:
                        if cur is not None:
                            raise ConcurrencyConflict(
                                "40001!COMMIT: table created concurrently, "
                                "transaction is aborted, will ROLLBACK")
                        continue
                    if cur is not self.snapshot.get(name):
                        raise ConcurrencyConflict(
                            "40001!COMMIT: transaction is aborted because "
                            "of concurrency conflicts, will ROLLBACK")
            except ConcurrencyConflict:
                self._finish_locked()
                raise
            if db.wal is not None and self.recs:
                txn = db._next_txn
                db._next_txn += 1
                for rtype, meta, arrays in self.recs:
                    db.wal.append(rtype, txn, meta, arrays, flush=False)
                db.wal.commit(txn)
            ddl = bool(self.created or self.dropped) or any(
                r[0] in (REC_CREATE, REC_DROP, REC_DDL) for r in self.recs)
            for name in self.dropped:
                db.tables.pop(name, None)
                db._device.pop(name, None)
            for name, td in self.writes.items():
                db.tables[name] = td
                db._device.pop(name, None)
            for name, entries in self.fks_add.items():
                if name in db.tables:
                    db.fks.setdefault(name, []).extend(entries)
            for t, sc in self.schema_moves.items():
                if t in db.tables or t in db.views:
                    db.set_table_schema(t, sc)
            if ddl:
                db.schema_epoch += 1
            self._finish_locked()

    def rollback(self) -> None:
        with self.db._mu:
            self._finish_locked()

    def _finish_locked(self) -> None:
        if not self.done:
            self.db._snapshot_pins -= 1
            self.done = True
