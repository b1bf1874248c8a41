"""The PyTorch port's SQL front door (monetdb_tpu_torch ``Session`` over
``Database(device="cpu")``) against the reference JAX package's
``Session(Database())``, statement by statement.

* the two faults of the port before its Session existed: ``parse`` of a
  PSM function body (``sql/psm.py``) and a query over a MERGE TABLE
  (``sql/distribute.py``);
* the statement scripts of tests/torch_session_scripts.py: DDL and DML,
  constraints, transactions, savepoints and a conflict between two
  sessions, prepared statements, views, sequences, a PSM function,
  procedure and trigger, Python UDFs, COPY (native and Python readers,
  BINARY, INTO a file), system tables, a query timeout;
* dump/restore, the prepared-statement API, the embedded and DB-API
  connections;
* TPC-H Q1, Q3, Q6, Q13 and Q18 through ``Session.sql`` over
  ``load_tpch_db(0.01)``.

Outcomes must be equal: names, types, rows, affected-row counts and the
class of an exception.  Integers, decimals, strings and dates exactly;
floats to rel 1e-12.  The JAX side runs with ``spmd_auto_mesh`` off: with
the suite's 8 virtual CPU devices its Session would otherwise build a mesh
and compile SPMD plans, which is not the port's (single-device) path.
"""

import os
from datetime import date

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import monetdb_tpu.config as ref_config  # noqa: E402
import monetdb_tpu.sql.binder as ref_binder  # noqa: E402
from monetdb_tpu import dbapi as ref_dbapi  # noqa: E402
from monetdb_tpu import embedded as ref_embedded  # noqa: E402
from monetdb_tpu.bench.tpch_gen import gen_tpch  # noqa: E402
from monetdb_tpu.bench.tpch_load import load_tpch_db as ref_load_db  # noqa: E402
from monetdb_tpu.dump import dump_sql as ref_dump, restore_sql as ref_restore  # noqa: E402
from monetdb_tpu.session import Session as RefSession  # noqa: E402
from monetdb_tpu.sql.parser import parse as ref_parse  # noqa: E402
from monetdb_tpu.storage import Database as RefDatabase  # noqa: E402
import monetdb_tpu_torch.sql.binder as binder  # noqa: E402
from monetdb_tpu_torch import dbapi, embedded  # noqa: E402
from monetdb_tpu_torch.bench.tpch_load import load_tpch_db  # noqa: E402
from monetdb_tpu_torch.bench.tpch_queries import QUERIES  # noqa: E402
from monetdb_tpu_torch.dump import dump_sql, restore_sql  # noqa: E402
from monetdb_tpu_torch.engine import plan_cache_stats  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
from monetdb_tpu_torch.session import Session  # noqa: E402
from monetdb_tpu_torch.sql.parser import parse  # noqa: E402
from monetdb_tpu_torch.storage import Database  # noqa: E402

from torch_session_scripts import (  # noqa: E402
    SCRIPTS, assert_outcomes_equal, outcome, run_script)


@pytest.fixture(autouse=True)
def _single_device_reference():
    ref_config.set("spmd_auto_mesh", False)
    binder.Binder._auto_counter = ref_binder.Binder._auto_counter = 0
    yield
    ref_config.reset("spmd_auto_mesh")


def _port_session():
    return Session(Database(device="cpu"))


def _both(stmts, tmp_path):
    """One script through both packages: (port outcomes, JAX outcomes)."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = run_script(lambda: RefSession(RefDatabase()), stmts,
                      str(tmp_path / "ref"), lambda s: RefSession(s.db))
    binder.Binder._auto_counter = ref_binder.Binder._auto_counter = 0
    got = run_script(_port_session, stmts, str(tmp_path / "port"),
                     lambda s: Session(s.db))
    return got, want


def test_parse_psm_function_body():
    """Fault: the port's parser imported ``.psm``, which it did not have."""
    sql = ("CREATE FUNCTION f(a int) RETURNS int BEGIN "
           "DECLARE b int; SET b = a * 2; RETURN b + 1; END")
    assert repr(parse(sql)) == repr(ref_parse(sql))
    s = _port_session()
    s.sql(sql)
    assert s.sql("select f(20)").rows == [(41,)]


def test_merge_table_two_partitions(tmp_path):
    """Fault: the port's binder imported ``.distribute`` for any catalog
    with a merge table."""
    stmts = [
        "create table p1 (k int, v varchar(4))",
        "create table p2 (k int, v varchar(4))",
        "create merge table m (k int, v varchar(4)) "
        "partition by range on (k)",
        "alter table m add table p1 as partition from 0 to 9",
        "alter table m add table p2 as partition from 10 to 19",
        "insert into m values (1, 'a'), (12, 'b'), (5, 'c'), (19, null)",
        "select k, v from m order by k",
        "select count(*) from p2",
        "select v, count(*) from m where k > 3 group by v order by v",
        "explain select k from m where k = 3",
        "insert into m values (25, 'x')",
    ]
    got, want = _both(stmts, tmp_path)
    assert_outcomes_equal(got, want)
    assert want[6][3] == [(1, "a"), (5, "c"), (12, "b"), (19, None)]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_reference(name, tmp_path):
    got, want = _both(SCRIPTS[name], tmp_path)
    assert_outcomes_equal(got, want)


def _dump_db(session_cls, db_cls, **kw):
    s = session_cls(db_cls(**kw))
    for st in ["create table t (a int, b decimal(8,2), c varchar(10), "
               "d date)",
               "insert into t values (1, 2.50, 'x', date '2024-01-02'), "
               "(2, null, null, null)",
               "create view v as select a from t where a > 1",
               "create function dbl(x int) returns int language python "
               "{ return x * 2 }",
               "create sequence sq start with 4",
               "create table p1 (k int)", "create table p2 (k int)",
               "create merge table m (k int) partition by range on (k)",
               "alter table m add table p1 as partition from 0 to 9",
               "alter table m add table p2 as partition from 10 to 19",
               "insert into m values (5), (15)"]:
        s.sql(st)
    return s


def test_dump_restore_matches_reference():
    ref = _dump_db(RefSession, RefDatabase)
    port = _dump_db(Session, Database, device="cpu")
    text = dump_sql(port.db)
    assert text == ref_dump(ref.db)
    db2 = Database(device="cpu")
    restore_sql(db2, text)
    rdb2 = RefDatabase()
    ref_restore(rdb2, text)
    s2, r2 = Session(db2), RefSession(rdb2)
    for q in ["select a, b, c, d from t order by a", "select a from v",
              "select dbl(a) from t order by a", "select count(*) from m",
              "select k from m where k > 10"]:
        assert outcome(s2.sql(q)) == outcome(r2.sql(q)), q
    assert s2.sql("select a, b, c, d from t order by a").rows == \
        port.sql("select a, b, c, d from t order by a").rows


def test_prepared_api_matches_reference():
    outs = []
    for s in (Session(Database(device="cpu")), RefSession(RefDatabase())):
        s.sql("create table t (a int, b varchar(4), c int)")
        ins = s.prepare("insert into t values (?, ?, ?)")
        got = [ins.run(i, "ab"[i % 2], i * 10) for i in range(6)]
        sel = s.prepare("select a, c from t where a >= ? and b = ? "
                        "order by a")
        got += [outcome(sel.run(2, "a")), outcome(sel.run(0, "b"))]
        got.append(s.prepare("update t set c = ? where a = ?").run(-1, 3))
        got.append(s.prepare("delete from t where a = ?").run(4))
        got.append(outcome(s.sql("select * from t order by a")))
        outs.append(got)
    assert outs[0] == outs[1]


def test_embedded_matches_reference(tmp_path):
    outs = []
    for mod, kw in ((embedded, {"device": "cpu"}), (ref_embedded, {})):
        with mod.connect(**kw) as con:
            con.query("create table t (a int, s varchar(5), d date)")
            n = con.append("t", {"a": np.array([3, 1, 2]),
                                 "s": np.array(["x", None, "zz"], object),
                                 "d": np.array([date(2024, 1, 1), None,
                                                date(1999, 12, 31)],
                                               object)})
            res, k = con.query("select a, s, d from t order by a")
            cols = con.query_columns("select a, s from t order by a")
            p = con.prepare("select s from t where a = ?")
            path = str(tmp_path / f"dump_{mod.__name__}.sql")
            con.dump_database(path)
            outs.append((n, outcome(res), k,
                         {c: v.tolist() for c, v in cols.items()},
                         outcome(con.execute(p, 2)), open(path).read()))
    assert outs[0] == outs[1]


def test_dbapi_matches_reference():
    outs = []
    for mod, kw in ((dbapi, {"device": "cpu"}), (ref_dbapi, {})):
        with mod.connect(**kw) as con:
            cur = con.cursor()
            cur.execute("create table t (a int, b varchar(5))")
            cur.executemany("insert into t values (?, ?)",
                            [(1, "x"), (2, None), (3, "it's")])
            cur.execute("select a, b from t where a >= ? order by a", (2,))
            desc = cur.description
            rows = cur.fetchall()
            cur.execute("select count(*) from t")
            outs.append((desc, rows, cur.fetchone(), cur.rowcount))
    assert outs[0] == outs[1]


def test_dbapi_columnar_fetch_and_transactions():
    con = dbapi.connect(device="cpu")
    cur = con.cursor()
    cur.execute("create table t (a int)")
    cur.execute("insert into t values (1), (2)")
    cur.execute("select a from t order by a")
    assert cur.fetchnumpy()["a"].tolist() == [1, 2]
    cur.execute("start transaction")
    cur.execute("insert into t values (3)")
    con.rollback()
    cur.execute("select count(*) from t")
    assert cur.fetchone() == (2,)
    cur.execute("start transaction")
    cur.execute("insert into t values (4)")
    con.commit()
    cur.execute("select count(*) from t")
    assert cur.fetchone() == (3,)


def test_network_connections_name_the_missing_module():
    """The network mode needed server.py, which is ported now: a DB-API
    connection and a remote table reach a server of the port."""
    from monetdb_tpu_torch.server import Server
    srv = Server(Database(device="cpu")).start()
    try:
        host, port = srv.address
        con = dbapi.connect(host=host, port=port)
        cur = con.cursor()
        cur.execute("create table t (a int)")
        cur.execute("insert into t values (4), (2)")
        s = _port_session()
        s.sql(f"create remote table r (a int) on '{host}:{port}/t'")
        assert s.sql("select a from r order by a").rows == [(2,), (4,)]
        con.close()
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def tpch_dbs():
    data = gen_tpch(0.01)
    return (Session(load_tpch_db(0.01, data, device="cpu")),
            RefSession(ref_load_db(0.01, data)))


@pytest.mark.parametrize("q", [1, 3, 6, 13, 18])
def test_tpch_through_session(q, tpch_dbs):
    port, ref = tpch_dbs
    falls = TF.STATS["fallbacks"]
    got = [outcome(port.sql(QUERIES[q])) for _ in range(2)]
    want = outcome(ref.sql(QUERIES[q]))
    assert got[1] == got[0]
    assert_outcomes_equal([got[0]], [want])
    assert TF.STATS["fallbacks"] == falls
    assert plan_cache_stats()["entries"] >= 1
