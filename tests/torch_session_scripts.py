"""SQL statement scripts run through a ``Session`` of either package.

Shared by the CPU parity tests (tests/test_torch_session.py: the JAX
package's ``Session(Database())`` against the port's
``Session(Database(device="cpu"))``) and the GPU tests
(tests/test_torch_cuda.py: the port on the card against the port on the
CPU).  This module imports neither package.

A script is a list of statements.  A statement is SQL text, or
``(session, text)`` to run it on a second session over the same store (a
conflict between two transactions).  ``{tmp}`` in a statement is the
script's own scratch directory; ``write(name, text)`` stands for a file
the script needs before its next statement.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List

import numpy as np

#: one Python UDF that sleeps, for the query timeout
_SLOW_UDF = ("create function slow(x int) returns int language python "
             "{\nimport time\ntime.sleep(0.12)\nreturn x\n}")

SCRIPTS: Dict[str, list] = {
    "ddl_dml": [
        "create table t (a int primary key, b varchar(10) default 'd', "
        "c decimal(9,2), d date, e double)",
        "insert into t values (1, 'x', 1.50, date '2024-01-02', 0.5), "
        "(2, 'yy', -2.25, null, null), (3, null, 10.00, "
        "date '1999-12-31', 1e10)",
        "insert into t (a, c) values (4, 3.33)",
        "select * from t order by a",
        "update t set c = c * 2, b = 'up' where a >= 3",
        "delete from t where a = 2",
        "select a, b, c, d, e from t order by a",
        "alter table t add column f int default 7",
        "alter table t rename column b to bb",
        "select a, bb, f from t order by a",
        "alter table t drop column e",
        "insert into t values (1, 'dup', 0, null, 0)",      # PK violation
        "insert into t values (null, 'nil', 0, null, 0)",   # NOT NULL (PK)
        "select count(*), sum(c), min(d), max(bb) from t",
        "create table s (k int not null, v varchar(5) unique, "
        "w int check (w > 0))",
        "insert into s values (1, 'a', 1), (2, 'b', 2)",
        "insert into s values (3, 'a', 3)",                 # UNIQUE
        "insert into s values (4, 'c', -1)",                # CHECK
        "insert into s values (null, 'd', 1)",              # NOT NULL
        "insert into s select a, bb, f from t where a > 3",
        "select * from s order by k",
        "drop table s",
        "select * from s",
        "truncate t",
        "select count(*) from t",
    ],
    "transactions": [
        "create table t (a int, b int)",
        "insert into t values (1, 10), (2, 20)",
        "start transaction",
        "insert into t values (3, 30)",
        "savepoint sp1",
        "update t set b = 0 where a = 1",
        "savepoint sp2",
        "delete from t where a = 2",
        "select * from t order by a",
        "rollback to savepoint sp1",
        "select * from t order by a",
        "release savepoint sp1",
        "commit",
        "select * from t order by a",
        "start transaction",
        "delete from t",
        "rollback",
        "select count(*), sum(b) from t",
        # a conflict between two sessions: first committer wins
        "start transaction",
        (1, "start transaction"),
        "update t set b = 99 where a = 1",
        (1, "update t set b = 55 where a = 1"),
        "commit",
        (1, "commit"),
        "select * from t order by a",
        (1, "select * from t order by a"),
        # disjoint tables do not conflict
        "create table u (x int)",
        "start transaction",
        (1, "start transaction"),
        "insert into t values (4, 40)",
        (1, "insert into u values (7)"),
        "commit",
        (1, "commit"),
        (1, "select count(*) from t"),
        "select * from u",
    ],
    "prepared_views_sequences": [
        "create table t (a int, b varchar(5), c decimal(6,1))",
        "insert into t values (1, 'p', 1.5), (2, 'q', 2.5), (3, 'p', 3.5)",
        "prepare select a, c from t where a >= ? and b = ? order by a",
        "exec **(2, 'p')",
        "exec **(1, 'p')",
        "prepare insert into t values (?, ?, ?)",
        "exec **(4, 'r', 4.5)",
        "create view v as select b, sum(c) as total, count(*) as n "
        "from t group by b",
        "select * from v order by b",
        "create view v2 as select b from v where n > 1",
        "select * from v2",
        "drop view v2",
        "select * from v2",
        "create sequence sq as integer start with 10 increment by 5",
        "create table w (id int default next value for sq, nm varchar(3))",
        "insert into w (nm) values ('a'), ('b')",
        "insert into w values (next value for sq, 'c')",
        "select id, nm from w order by id",
        "alter sequence sq restart with (select max(id) + 100 from w)",
        "insert into w (nm) values ('d')",
        "select id, nm from w order by id",
        "create table z (id serial, nm varchar(3))",
        "insert into z (nm) values ('x'), ('y')",
        "select id, nm from z order by id",
        "drop sequence sq",
    ],
    "psm": [
        "create table lg (msg varchar(20), v int)",
        "create table t (a int, b int)",
        "create function addone(a int) returns int begin return a + 1; end",
        "create function clamp(x int) returns int begin "
        "if x > 5 then return 5; end if; return x; end",
        "create procedure addv(x int) begin "
        "insert into lg values ('proc', x); "
        "insert into lg values ('proc', x + 1); end",
        "create trigger tr after insert on t "
        "insert into lg values ('ins', 0)",
        "create trigger tu after update on t "
        "insert into lg values ('upd', 0)",
        "insert into t values (1, 2), (7, 8)",
        "update t set b = b + 1 where a = 1",
        "call addv(10)",
        "select a, addone(a), addone(b) from t order by a",
        "select addone(41)",
        "select clamp(9)",
        "select clamp(-3)",
        "select clamp(a) from t",       # IF over a column: not inlinable
        "select msg, v from lg order by msg, v",
        "drop trigger tr",
        "insert into t values (3, 4)",
        "select count(*) from lg",
        "drop procedure addv",
        "call addv(1)",
    ],
    "python_udf": [
        "create table t (a int, f double, s varchar(10), d decimal(8,2))",
        "insert into t values (1, 1.5, 'ab', 1.25), (2, null, null, null), "
        "(3, -2.0, 'cde', 7.00)",
        "create function plus7(x int) returns int language python "
        "{ return x + 7 }",
        "create function hyp(x int, y double) returns double language "
        "python { return np.sqrt(x * x + y * y) }",
        "create function shout(v varchar(10)) returns varchar(12) "
        "language python "
        "{ return [None if x is None else x.upper() + '!' for x in v] }",
        "create function half(v decimal(8,2)) returns double language "
        "python { return v / 2 }",
        "select a, plus7(a), hyp(a, f), shout(s), half(d) from t order by a",
        "select sum(plus7(a)) from t where plus7(a) > 8",
    ],
    "copy": [
        "create table t (a int, b decimal(9,2), c varchar(20), d date, "
        "e bigint)",
        ("write", "d.csv", "1|12.34|alpha|2020-01-31|-5\n"
         "2|-0.05|beta gamma|1999-12-31|17\n"
         "3||NULL|2024-02-29|\n4|7|x|2001-07-04|0\n"),
        "copy into t from '{tmp}/d.csv'",
        "select * from t order by a",
        # the Python reader: a quote character and a null string
        "create table q (a int, c varchar(20), d date)",
        ("write", "q.csv", '1,"x,y",2020-01-01\n2,,2021-02-03\n'
         '3,"z",\n'),
        "copy into q from '{tmp}/q.csv' using delimiters ',', '\\n', '\"' "
        "null as ''",
        "select * from q order by a",
        "copy 2 records into q from '{tmp}/q.csv' using delimiters ',', "
        "'\\n', '\"'",
        "select count(*) from q",
        # COPY BINARY: raw int32, .npy float64, text strings
        ("binary", "x.bin", "y.npy", "nm.txt"),
        "create table b (x int, y double, nm varchar(8))",
        "copy binary into b from ('{tmp}/x.bin', '{tmp}/y.npy', "
        "'{tmp}/nm.txt')",
        "select * from b order by x",
        # COPY ... INTO a file, read back through COPY FROM
        "copy t into '{tmp}/out.csv'",
        "copy select a, c from t where a < 3 into '{tmp}/out2.csv'",
        "create table t2 (a int, b decimal(9,2), c varchar(20), d date, "
        "e bigint)",
        "copy into t2 from '{tmp}/out.csv' using delimiters '|', '\\n' "
        "null as 'NULL'",
        "select * from t2 order by a",
    ],
    "system_tables": [
        "create table t (a int, b varchar(5))",
        "insert into t values (1, 'x'), (2, 'y'), (2, 'z')",
        "create view v as select a from t",
        "create table p1 (k int)",
        "create table p2 (k int)",
        "create merge table m (k int) partition by range on (k)",
        "alter table m add table p1 as partition from 0 to 9",
        "alter table m add table p2 as partition from 10 to 19",
        "create sequence sq start with 3",
        "comment on table t is 'core'",
        "select name, type, query from sys.tables order by name",
        "select name, type, number from sys.columns order by id",
        "select * from sys.storage order by 1, 2",
        "select count(*) > 0 from sys.queue where status = 'finished'",
        "select name from sys.schemas order by name",
        "select name from sys.sequences",
        "select remark from sys.comments",
        "select t.name, count(*) from sys.tables t join sys.columns c on "
        "c.table_id = t.id group by t.name order by t.name",
        "select name from sys.env where name in ('jax_backend', "
        "'n_devices', 'version', 'fragment_exec') order by name",
    ],
    "timeout": [
        "create table t (a int)",
        "insert into t values (1), (2), (3)",
        _SLOW_UDF,
        "call sys.setquerytimeout(0.05)",
        "select slow(a) from t where slow(a) > 0 order by a",
        "call sys.setquerytimeout(0)",
        "select count(*) from t",
        "select count(*) > 0 from sys.queue where status = 'aborted'",
    ],
}


def _prepare_files(tmp: str, item) -> None:
    kind = item[0]
    if kind == "write":
        with open(os.path.join(tmp, item[1]), "w") as f:
            f.write(item[2])
    else:                                    # COPY BINARY inputs
        fx, fy, fn = (os.path.join(tmp, n) for n in item[1:])
        np.array([3, 1, 2], np.int32).tofile(fx)
        np.save(fy, np.array([3.5, 1.5, np.nan]))
        with open(fn, "w") as f:
            f.write("cc\naa\nNULL\n")


def outcome(res):
    """A statement's result in a form both packages can be compared in:
    rows with names and types, a count, None, or an error's class."""
    if hasattr(res, "rows"):
        return ("rows", list(res.names), [str(t) for t in res.types],
                [tuple(r) for r in res.rows])
    return ("value", res)


def run_script(make_session: Callable[[], object], stmts: List, tmp: str,
               second: Callable[[object], object]) -> list:
    """Run ``stmts`` through ``make_session()`` (and ``second(first)`` for
    statements addressed to session 1); one outcome per SQL statement."""
    s0 = make_session()
    sessions = {0: s0}
    out = []
    for st in stmts:
        if isinstance(st, tuple) and st[0] in ("write", "binary"):
            _prepare_files(tmp, st)
            continue
        sid, sql = st if isinstance(st, tuple) else (0, st)
        if sid not in sessions:
            sessions[sid] = second(s0)
        try:
            res = sessions[sid].sql(sql.replace("{tmp}", tmp))
        except Exception as ex:         # the class is what is compared
            out.append(("error", type(ex).__name__))
            continue
        out.append(outcome(res))
    return out


def assert_outcomes_equal(got: list, want: list, rtol: float = 1e-12):
    """Equal outcomes: integers, decimals, strings, dates and counts
    exactly, floats to ``rtol``."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], (i, g, w)
        if g[0] != "rows":
            assert g == w, (i, g, w)
            continue
        assert g[1:3] == w[1:3], (i, g[1:3], w[1:3])
        assert len(g[3]) == len(w[3]), (i, g[3], w[3])
        for grow, wrow in zip(g[3], w[3]):
            assert len(grow) == len(wrow), (i, grow, wrow)
            for gv, wv in zip(grow, wrow):
                if isinstance(wv, float) and wv == wv:
                    assert isinstance(gv, float) and \
                        abs(gv - wv) <= rtol * abs(wv), (i, grow, wrow)
                elif isinstance(wv, float):
                    assert gv is None or gv != gv, (i, grow, wrow)
                else:
                    assert gv == wv and type(gv) is type(wv), \
                        (i, grow, wrow)
