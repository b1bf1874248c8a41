"""PEP 249 (DB-API 2.0) interface — the pymonetdb/ODBC-driver analog
(clients/odbc, and the Python client the reference ecosystem ships).

Two connection modes:
  * embedded:  connect(database="/path/or/None", device=...) — monetdbe
               analog (tools/monetdbe/monetdbe.h in-process API) over a
               store on ``device``
  * network:   connect(host=..., port=..., user=..., password=...)
               — mapilib analog over the block-stream protocol (server.py);
               the server's store names the device
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

apilevel = "2.0"
threadsafety = 1
paramstyle = "qmark"


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


def connect(database: Optional[str] = None, host: Optional[str] = None,
            port: Optional[int] = None, user: Optional[str] = None,
            password: Optional[str] = None,
            columnar: bool = False, *, device="cuda") -> "Connection":
    """An in-process connection to the store at ``database`` (None = in
    memory) on ``device``, or with ``host`` a network connection.
    columnar=True: network result sets use the binary columnar wire
    mode (sql_result.c:1216 analog) - no per-value JSON; Cursor.fetchnumpy
    returns the raw buffers."""
    if host is not None:
        from .server import Client
        return Connection(remote=Client(host, int(port), user, password),
                          columnar=columnar)
    from .session import Session
    from .storage import Database
    return Connection(session=Session(Database(database, device=device)),
                      columnar=columnar)


class Connection:
    def __init__(self, session=None, remote=None, columnar: bool = False):
        self._session = session
        self._remote = remote
        self._columnar = columnar
        self._closed = False

    def cursor(self) -> "Cursor":
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def _run(self, sql: str):
        try:
            if self._remote is not None:
                return self._remote.sql(sql, columnar=self._columnar)
            return self._session.sql(sql)
        except Error:
            raise
        except Exception as ex:
            raise DatabaseError(str(ex)) from ex

    def commit(self) -> None:
        # autocommit outside explicit START TRANSACTION (MonetDB default)
        if self._session is not None and self._session.txn is not None:
            self._session.sql("commit")

    def rollback(self) -> None:
        if self._session is not None and self._session.txn is not None:
            self._session.sql("rollback")

    def close(self) -> None:
        if self._remote is not None:
            self._remote.close()
        elif self._session is not None:
            self._session.db.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _render_param(v) -> str:
    from .sql.distribute import _sql_value
    return _sql_value(v)


class Cursor:
    arraysize = 1

    def __init__(self, conn: Connection):
        self.connection = conn
        self.description: Optional[List[Tuple]] = None
        self.rowcount = -1
        self._result = None
        self._rows: Optional[List[tuple]] = []
        self._pos = 0

    def execute(self, sql: str, params: Sequence = ()) -> "Cursor":
        if params:
            parts = sql.split("?")
            if len(parts) - 1 != len(params):
                raise InterfaceError(
                    f"statement has {len(parts) - 1} placeholders, "
                    f"{len(params)} parameters given")
            sql = "".join(p + (_render_param(v) if v is not ... else "")
                          for p, v in zip(parts, list(params) + [...]))
        res = self.connection._run(sql)
        self.description = None
        self._result = None
        self._rows = []
        self._pos = 0
        self.rowcount = -1
        if res is None:
            return self
        if isinstance(res, int):
            self.rowcount = res
            return self
        self.description = [(n, str(t), None, None, None, None, None)
                            for n, t in zip(res.names, res.types)]
        self._result = res
        self._rows = None           # materialized lazily (columnar mode)
        self.rowcount = len(res)
        return self

    @property
    def _materialized(self) -> List[tuple]:
        if self._rows is None:
            self._rows = list(self._result.rows) if self._result is not None \
                else []
        return self._rows

    def fetchnumpy(self):
        """{name: numpy array} of the current result's physical columns
        (columnar wire mode or embedded fragment results): the fast bulk
        fetch the reference exposes through the columnar protocol +
        monetdbe_result binding."""
        import numpy as np
        res = self._result
        if res is None:
            raise InterfaceError("no result set")
        if hasattr(res, "numpy"):
            return {n: res.numpy(n) for n in res.names}
        if getattr(res, "raw", None):
            return {n: np.asarray(a)
                    for n, (a, _t, _s) in zip(res.names, res.raw)}
        raise InterfaceError(
            "result has no columnar form (use connect(columnar=True) "
            "for network connections; an embedded result that ran through "
            "the op-at-a-time executor has none)")

    def executemany(self, sql: str, seq) -> "Cursor":
        for params in seq:
            self.execute(sql, params)
        return self

    def fetchone(self) -> Optional[tuple]:
        rows = self._materialized
        if self._pos >= len(rows):
            return None
        row = rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> List[tuple]:
        size = size or self.arraysize
        rows = self._materialized
        out = rows[self._pos:self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[tuple]:
        rows = self._materialized
        out = rows[self._pos:]
        self._pos = len(rows)
        return out

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def close(self) -> None:
        self._rows = []
