"""Database dump — the msqldump analog (clients/mapiclient/dump.c:
schema + data as replayable SQL text).

Covers tables (CREATE TABLE + INSERT batches), views, merge/remote/replica
definitions with partition specs, and Python UDFs.
"""

from __future__ import annotations

import datetime
from decimal import Decimal as PyDecimal
from typing import List, Optional, TextIO

from .dtypes import Kind, SQLType

__all__ = ["dump_sql", "sql_type_name"]


def sql_type_name(t: SQLType) -> str:
    if t.kind == Kind.DECIMAL:
        return f"decimal({t.precision},{t.scale})"
    if t.kind == Kind.STR:
        return f"varchar({t.precision})" if t.precision else "varchar(1024)"
    if t.kind == Kind.DATE:
        return "date"
    if t.kind == Kind.TIMESTAMP:
        return "timestamp"
    if t.kind == Kind.BOOL:
        return "boolean"
    if t.np_dtype.kind == "f":
        return "real" if t.np_dtype.itemsize == 4 else "double"
    return {1: "tinyint", 2: "smallint", 4: "int", 8: "bigint"}[
        t.np_dtype.itemsize]


def _sql_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, datetime.datetime):
        return f"timestamp '{v.isoformat(sep=' ')}'"
    if isinstance(v, datetime.date):
        return f"date '{v.isoformat()}'"
    if isinstance(v, PyDecimal):
        return str(v)
    return repr(v)


def _dump_spec(spec) -> str:
    if spec is None:
        return ""
    if spec.nulls and spec.values is None and spec.lo is None \
            and spec.hi is None:
        return " as partition for null values"
    if spec.values is not None:
        vals = ", ".join(_sql_literal(v) for v in spec.values)
        return f" as partition in ({vals})"
    return (f" as partition from {_sql_literal(spec.lo)} "
            f"to {_sql_literal(spec.hi)}")


def dump_sql(db, data: bool = True, batch: int = 1024) -> str:
    """Replayable SQL dump of the database (schema first, then data,
    then distribution DDL so member tables exist before ALTER ADD)."""
    from .session import Session
    out: List[str] = []
    w = out.append

    for sname, sq in sorted(db.sequences.items()):
        w(f"create sequence {sname} start with {sq['next']} "
          f"increment by {sq['inc']};")
    for tname, td in sorted(db.tables.items()):
        defs = []
        for c in td.order:
            if c in td.serials:
                tn = "serial" if td.types[c].np_dtype.itemsize == 4 \
                    else "bigserial"
                defs.append(f"{c} {tn}")
                continue
            d = f"{c} {sql_type_name(td.types[c])}"
            if c in td.pks and len(td.pks) == 1:
                d += " primary key"
            elif c in td.notnull:
                d += " not null"
            defs.append(d)
        if len(td.pks) > 1:
            defs.append(f"primary key ({', '.join(td.pks)})")
        w(f"create table {tname} ({', '.join(defs)});")
    for vname, vsql in sorted(db.views.items()):
        w(f"create view {vname} as {vsql.rstrip(';')};")

    if data and db.tables:
        s = Session(db)
        for tname, td in sorted(db.tables.items()):
            if not td.count:
                continue
            res = s.query(f"select {', '.join(td.order)} from {tname}")
            for i in range(0, len(res.rows), batch):
                chunk = res.rows[i:i + batch]
                vals = ",\n  ".join(
                    "(" + ", ".join(_sql_literal(v) for v in r) + ")"
                    for r in chunk)
                w(f"insert into {tname} values\n  {vals};")

    for d in sorted(db.remotes.values(), key=lambda d: d.name):
        cols = ", ".join(f"{n} {sql_type_name(t)}" for n, t in d.schema)
        w(f"create remote table {d.name} ({cols}) "
          f"on '{d.addr}/{d.rtable}';")
    for d in sorted(db.replicas.values(), key=lambda d: d.name):
        cols = ", ".join(f"{n} {sql_type_name(t)}" for n, t in d.schema)
        w(f"create replica table {d.name} ({cols});")
        for m in d.members:
            w(f"alter table {d.name} add table {m};")
    for d in sorted(db.merges.values(), key=lambda d: d.name):
        cols = ", ".join(f"{n} {sql_type_name(t)}" for n, t in d.schema)
        part = ""
        if d.part_kind:
            part = f" partition by {d.part_kind} on ({d.part_col})"
        w(f"create merge table {d.name} ({cols}){part};")
        for m, spec in d.members:
            w(f"alter table {d.name} add table {m}{_dump_spec(spec)};")

    for u in sorted(db.udfs.values(), key=lambda u: u.name):
        if u.body is None:
            continue
        args = ", ".join(f"{n} {sql_type_name(t)}"
                         for n, t in zip(u.arg_names, u.arg_types))
        w(f"create function {u.name}({args}) returns "
          f"{sql_type_name(u.ret_type)} language python {{{u.body}}};")
    return "\n".join(out) + "\n"


def restore_sql(db, text: str) -> None:
    """Replay a dump into a database (statement-at-a-time; dump text uses
    ';\n' only at statement ends)."""
    from .session import Session
    s = Session(db)
    buf: List[str] = []
    for line in text.splitlines():
        buf.append(line)
        if line.rstrip().endswith(";"):
            stmt = "\n".join(buf).strip()
            buf = []
            if stmt:
                s.sql(stmt)
    if "".join(buf).strip():
        s.sql("\n".join(buf))
