"""System relations (sys.tables, sys.columns, ...): the names only.

The binder asks ``is_system_table`` for every FROM item.  Materializing a
system relation needs the storage layer, which is not ported yet, so
``system_table`` raises."""

from __future__ import annotations

__all__ = ["is_system_table", "system_table"]

#: the reference package's sql/syscat.py _RELATIONS keys
_RELATIONS = frozenset({
    "information_schema.columns", "information_schema.tables",
    "sys._columns", "sys._tables", "sys.args", "sys.auths", "sys.columns",
    "sys.comments", "sys.db_user_info", "sys.dependencies",
    "sys.dependency_types", "sys.env", "sys.environment", "sys.functions",
    "sys.idxs", "sys.keys", "sys.objects", "sys.querylog_calls",
    "sys.querylog_catalog", "sys.queue", "sys.rejects", "sys.roles",
    "sys.schemas", "sys.sequences", "sys.storage", "sys.table_types",
    "sys.tables", "sys.triggers", "sys.users",
})


def is_system_table(name: str) -> bool:
    n = name.lower()
    # unqualified references resolve against the sys schema, as the
    # reference's name resolution does (rel_semantic.c sql_bind_table)
    return n in _RELATIONS or ("." not in n and "sys." + n in _RELATIONS)


def system_table(cat, name: str):
    from ..exec.fragment import Unsupported
    raise Unsupported(f"system table {name}: storage layer not ported yet")
