"""Entry ``session_sql``: ``Session(db).sql(text)`` over an in-memory
``Database`` on the device.

The product path that the DB-API, embedded and server entries share: the
session binds a SQL text once and lowers its plan again at every run.  The
tables are bulk-appended from the generated host arrays (``TableData.append``,
as the port's ``load_tpch_db`` does); the first query uploads them.
"""

from __future__ import annotations

__all__ = ["open_entry", "halve"]


def sql_type(tag: str):
    from monetdb_tpu_torch.dtypes import DATE, I32, I64, decimal, varchar
    return {"i32": I32, "i64": I64, "dec2": decimal(15, 2), "date": DATE,
            "str": varchar()}[tag]


class SessionEntry:
    def __init__(self, cfg: dict, data: dict, device):
        from monetdb_tpu_torch.session import Session
        from monetdb_tpu_torch.storage.database import Database
        self.db = Database(device=device)
        for tname, cols in data.items():
            schema = cfg["schema"][tname]
            self.db.create_table(
                tname, [(c, sql_type(schema[c][0])) for c in cols])
            arrays = {}
            for c, v in cols.items():
                typ = sql_type(schema[c][0])
                arrays[c] = v if schema[c][0] == "str" else \
                    v.astype(typ.np_dtype, copy=False)
            self.db.tables[tname].append(arrays)
        self.session = Session(self.db)

    def query(self, text: str):
        return self.session.sql(text)

    def close(self) -> None:
        self.session.close()
        self.session = self.db = None


def open_entry(cfg: dict, data: dict, device) -> SessionEntry:
    return SessionEntry(cfg, data, device)


def halve(entry: SessionEntry) -> SessionEntry:
    """The tests' fault of half the batch left out: the second half of the
    largest table's rows marked deleted, and its version bumped so that
    the Session uploads it again."""
    from monetdb_tpu_torch.storage.database import _next_version
    td = max(entry.db.tables.values(), key=lambda t: t.count)
    td.deleted[td.count // 2:] = True
    td.version = _next_version()
    return entry
