"""Entry ``embedded_append``: the embedded user's path.

``embedded.connect(device=...)`` (monetdbe_open with a NULL URL: one
in-memory store on the device), a ``CREATE TABLE`` per table from the
configuration's schema, one ``Connection.append`` per table
(monetdbe_append: numpy columns, text as the program's ``Categorical``
where the generator gives codes over a sorted dictionary) and queries as
SQL text through ``Connection.query`` (``Session.sql`` over the store,
which uploads each table version to the device at its first query).  No
key is declared, as Crystal loads SSB.

The program must take a ``Categorical``: without it a fact table of 120 M
rows would be appended value by value for half an hour, so the entry
raises before it touches any data.
"""

from __future__ import annotations

import numpy as np

__all__ = ["open_entry", "halve"]

#: the schema's loader tags as SQL types (a text column takes its source
#: width, the schema's second number)
_SQL = {"i32": "INTEGER", "i64": "BIGINT", "dec2": "DECIMAL(15,2)",
        "date": "DATE"}


def _embedded():
    """The program's embedded module, once it is known to take a
    ``Categorical``."""
    from monetdb_tpu_torch import embedded
    if not hasattr(embedded, "Categorical"):
        raise RuntimeError("monetdb_tpu_torch.embedded has no Categorical: "
                           "the program cannot bulk-append coded text")
    return embedded


def _host(col, tag: str, categorical):
    """A generated column as Connection.append takes it: host numpy, a
    coded column (``gen.ssb.Coded``) as a ``Categorical``."""
    if hasattr(col, "codes"):
        codes = col.codes
        codes = codes.cpu().numpy() if hasattr(codes, "cpu") else codes
        return categorical(np.asarray(codes, np.int32),
                           np.asarray(col.values))
    if hasattr(col, "cpu"):
        return col.cpu().numpy()
    return col if tag == "str" else np.asarray(col)


class EmbeddedEntry:
    def __init__(self, cfg: dict, data: dict, device):
        embedded = _embedded()
        self.conn = embedded.connect(device=device)
        for tname, cols in data.items():
            schema = cfg["schema"][tname]
            decl = ", ".join(
                f"{c} " + (f"VARCHAR({schema[c][1]})" if schema[c][0] == "str"
                           else _SQL[schema[c][0]]) for c in cols)
            self.conn.query(f"CREATE TABLE {tname} ({decl})")
            arrays = {}
            for c in list(cols):
                # one column at a time to the host, its device copy freed
                arrays[c] = _host(cols.pop(c), schema[c][0],
                                  embedded.Categorical)
            self.conn.append(tname, arrays)
            del arrays

    def query(self, text: str):
        return self.conn.query(text)[0]

    def close(self) -> None:
        self.conn.session.close()
        self.conn.close()
        self.conn = None


def open_entry(cfg: dict, data: dict, device) -> EmbeddedEntry:
    return EmbeddedEntry(cfg, data, device)


def halve(entry: EmbeddedEntry) -> EmbeddedEntry:
    """The tests' fault of half the batch left out: the second half of the
    largest table's rows marked deleted, and its version bumped so that
    the store uploads it again."""
    from monetdb_tpu_torch.storage.database import _next_version
    td = max(entry.conn.db.tables.values(), key=lambda t: t.count)
    td.deleted[td.count // 2:] = True
    td.version = _next_version()
    return entry
