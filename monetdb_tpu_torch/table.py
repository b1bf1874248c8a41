"""Table & catalog — host-side schema over aligned column families.

The reference decomposes a SQL table into per-column BATs registered in the
BBP directory with a catalog on top (sql/storage/store.c); here a Table is a
named, ordered dict of aligned Columns plus row count, and the Catalog is
the in-process schema registry (database-level persistence lives in
storage/persist.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .column import Cand, Column
from .dtypes import SQLType

__all__ = ["Table", "Catalog"]


@dataclasses.dataclass
class Table:
    name: str
    columns: Dict[str, Column]

    def __post_init__(self):
        counts = {c.count for c in self.columns.values()}
        assert len(counts) <= 1, f"misaligned columns in {self.name}: {counts}"

    @property
    def count(self) -> int:
        if not self.columns:
            return 0
        return next(iter(self.columns.values())).count

    @property
    def cap(self) -> int:
        return next(iter(self.columns.values())).cap

    def col(self, name: str) -> Column:
        return self.columns[name.lower()]

    def names(self) -> List[str]:
        return list(self.columns)

    def all_cand(self) -> Cand:
        return Cand.all(self.count)

    def to_pandas(self):  # convenience for tests/debug
        import pandas as pd
        return pd.DataFrame({k: v.to_numpy() for k, v in self.columns.items()})

    @staticmethod
    def from_dict(name: str, cols: Dict[str, Column]) -> "Table":
        return Table(name, {k.lower(): v for k, v in cols.items()})


class Catalog:
    """In-process schema registry (the mvc/store analog, sql/storage/store.c).
    """

    def __init__(self):
        self.tables: Dict[str, Table] = {}
        # view name → SQL text (expanded at bind time, the reference's
        # sql_rel view inlining)
        self.views: Dict[str, str] = {}
        # distribution DDL (sql/server/rel_distribute.c analog); values are
        # sql.distribute.{MergeDef, RemoteDef, ReplicaDef}
        self.merges: Dict[str, object] = {}
        self.remotes: Dict[str, object] = {}
        self.replicas: Dict[str, object] = {}
        # registered UDFs (udf.UDF) — pyapi3 analog
        self.udfs: Dict[str, object] = {}
        # live sequence hooks (set by Database.catalog(); None for
        # catalogs not backed by a store)
        self.sequences: Dict[str, dict] = {}
        self.next_sequence_block = None

    def add(self, table: Table) -> None:
        self.tables[table.name.lower()] = table

    def get(self, name: str) -> Table:
        return self.tables[name.lower()]

    def drop(self, name: str) -> None:
        self.tables.pop(name.lower(), None)

    def __contains__(self, name: str) -> bool:
        return name.lower() in self.tables
