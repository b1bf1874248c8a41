"""Embedded in-process API — the monetdbe surface
(reference: tools/monetdbe/monetdbe.h:160-190 monetdbe_open/query/
prepare/bind/execute/append/dump; monetdbe.c).

Python-native shapes: results come back as column dicts of numpy arrays
(zero extra copies beyond device→host), appends take numpy arrays —
the same bulk-columnar contract monetdbe_append has in C — and text
columns also as ``Categorical`` (int32 codes over a sorted dictionary,
pandas' shape), which the store takes without touching a string.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .engine import Result
from .session import Session
from .storage.columns import Categorical, to_physical_bulk
from .storage.database import Database

__all__ = ["connect", "Connection", "Categorical"]


class Connection:
    """monetdbe database handle (monetdbe_open/close)."""

    def __init__(self, path: Optional[str] = None, *, device="cuda"):
        self.db = Database(path, device=device)
        self.session = Session(self.db)
        self._closed = False

    # -- monetdbe_query -----------------------------------------------------
    def query(self, sql: str):
        """→ (Result | None, affected_rows). Mirrors monetdbe_query's
        (result, affected) out-params."""
        out = self.session.sql(sql)
        if isinstance(out, Result):
            return out, len(out.rows)
        if isinstance(out, int):
            return None, out
        return None, 0

    def query_columns(self, sql: str) -> Dict[str, np.ndarray]:
        """Columnar fetch (monetdbe_result_fetch): name → numpy array
        (object arrays where NULLs are present)."""
        res, _ = self.query(sql)
        if res is None:
            return {}
        cols: Dict[str, np.ndarray] = {}
        for i, name in enumerate(res.names):
            cols[name] = np.array([r[i] for r in res.rows], dtype=object)
        return cols

    # -- monetdbe_prepare / bind / execute -----------------------------------
    def prepare(self, sql: str):
        return self.session.prepare(sql)

    def execute(self, prepared, *params):
        return prepared.run(*params)

    # -- monetdbe_append ------------------------------------------------------
    def append(self, table: str, data: Dict[str, np.ndarray]) -> int:
        """Bulk columnar append (monetdbe_append): logical numpy arrays
        (numbers, dates as datetime64 or date objects, strings as str or
        object arrays with None for NULL, or a ``Categorical``), one per
        column.  Numpy arrays of a kind the column's type takes are
        converted in bulk (``to_physical_bulk``).  The store keeps copies:
        the caller may refill or change its arrays once the call returns."""
        td = self.db.tables[table.lower()]
        arrays = {}
        n = None
        for c in td.order:
            if c not in data:
                raise KeyError(f"missing column {c}")
            arrays[c] = to_physical_bulk(data[c], td.types[c])
            if n is None:
                n = len(arrays[c])
            elif len(arrays[c]) != n:
                raise ValueError(f"column {c} has {len(arrays[c])} values, "
                                 f"not {n}")
        if not n:
            return 0
        return self.db.insert(table, arrays)

    # -- monetdbe_dump_database ------------------------------------------------
    def dump_database(self, path: str) -> None:
        from .dump import dump_sql
        with open(path, "w") as f:
            f.write(dump_sql(self.db))

    # -- transactions (monetdbe's in_transaction surface) --------------------
    def begin(self):
        self.db.begin()

    def commit(self):
        self.db.commit()

    def rollback(self):
        self.db.rollback()

    def close(self) -> None:
        if not self._closed:
            self.db.close()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect(path: Optional[str] = None, *, device="cuda") -> Connection:
    """monetdbe_open: None = in-memory (the reference's NULL url); tables
    are materialized on ``device``."""
    return Connection(path, device=device)
