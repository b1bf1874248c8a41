"""The PyTorch port's op-at-a-time executor (monetdb_tpu_torch
exec/executor.py, device="cpu") and its place in the Engine, against the
reference JAX package on the same generated data.

* the 15 TPC-DS and 13 SSBM queries through both Engines with the default
  config: Q53, Q89 and Q98 (window functions) fall back to the executor on
  both sides, and ``STATS["fallbacks"]`` moves by the same amount;
* statements only the executor runs: string casts both ways, ``||``, set
  operations, VALUES, generate_series, SAMPLE, LIMIT/OFFSET, IN / NOT IN /
  EXISTS with nils, quantiles and moments, group_concat, greatest/least,
  CASE over strings, a cross join;
* ``trace=True`` gives per-operator events and the fallback reason;
* what is not ported yet raises with the missing module's name.

The 22 TPC-H queries through the executor are in test_torch_tpch_paths.py.
Names, types, integers, decimals, dates, strings and counts must be equal.
Floats get rel 1e-9 (tests/torch_parity.py): averages divide by a scalar on
both sides but torch multiplies by the reciprocal, and var/stdev/corr sum
squares by ``index_add_``, whose order is not XLA's.
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import monetdb_tpu.sql.binder as ref_binder  # noqa: E402
from monetdb_tpu.bench import ssbm as ref_ssbm  # noqa: E402
from monetdb_tpu.bench import tpcds as ref_tpcds  # noqa: E402
from monetdb_tpu.bench.tpch_load import load_tpch as ref_load_tpch  # noqa: E402
from monetdb_tpu.engine import Engine as RefEngine  # noqa: E402
from monetdb_tpu.exec import fragment as RF  # noqa: E402
import monetdb_tpu_torch.config as config  # noqa: E402
import monetdb_tpu_torch.sql.binder as binder  # noqa: E402
from monetdb_tpu_torch.bench import ssbm, tpcds  # noqa: E402
from monetdb_tpu_torch.bench.tpch_load import load_tpch  # noqa: E402
from monetdb_tpu_torch.bench.tpch_queries import QUERIES  # noqa: E402
from monetdb_tpu_torch.engine import Engine, ExecError  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
from monetdb_tpu_torch.exec.executor import Executor  # noqa: E402

from test_torch_cuda import (  # noqa: E402
    DATE_SQL, EXECUTOR_SQL, JOIN_EXPAND_SQL, dup_tables, exec_tables)
from test_torch_engine import _catalogs  # noqa: E402
from torch_parity import (  # noqa: E402,F401  (executor_only: a fixture)
    EXECUTOR_ATOL, EXECUTOR_RTOL, assert_same_result, executor_only)


def query_both(eng, ref, sql):
    """The statement through both Engines, with the binder's process-wide
    counter for unnamed columns reset on both sides."""
    binder.Binder._auto_counter = 0
    ref_binder.Binder._auto_counter = 0
    return eng.query(sql), ref.query(sql)


def assert_same(eng, ref, sql):
    got, want = query_both(eng, ref, sql)
    assert_same_result(got, want, EXECUTOR_RTOL, EXECUTOR_ATOL)
    return got


@pytest.fixture(scope="module")
def tpch():
    return (Engine(load_tpch(0.01, device="cpu")),
            RefEngine(ref_load_tpch(0.01)))


@pytest.fixture(scope="module")
def ds():
    cat, _data = tpcds.load_tpcds(25_000, device="cpu")
    rcat, _rdata = ref_tpcds.load_tpcds(25_000)
    return Engine(cat), RefEngine(rcat)


@pytest.fixture(scope="module")
def ssb():
    cat, _data = ssbm.load_ssbm(20_000, device="cpu")
    rcat, _rdata = ref_ssbm.load_ssbm(20_000)
    return Engine(cat), RefEngine(rcat)


_DS_FALLBACKS = {"53", "89", "98"}


@pytest.mark.parametrize("qid", sorted(tpcds.QUERIES, key=int))
def test_tpcds_matches_reference(ds, qid):
    eng, ref = ds
    assert tpcds.QUERIES[qid] == ref_tpcds.QUERIES[qid]
    t0, r0 = TF.STATS["fallbacks"], RF.STATS["fallbacks"]
    assert_same(eng, ref, tpcds.QUERIES[qid])
    fell, ref_fell = TF.STATS["fallbacks"] - t0, RF.STATS["fallbacks"] - r0
    assert fell == ref_fell == (1 if qid in _DS_FALLBACKS else 0)


@pytest.mark.parametrize("qid", sorted(ssbm.QUERIES))
def test_ssbm_matches_reference(ssb, qid):
    eng, ref = ssb
    assert ssbm.QUERIES[qid] == ref_ssbm.QUERIES[qid]
    t0, r0 = TF.STATS["fallbacks"], RF.STATS["fallbacks"]
    assert_same(eng, ref, ssbm.QUERIES[qid])
    assert TF.STATS["fallbacks"] - t0 == RF.STATS["fallbacks"] - r0 == 0


def test_generators_match_reference():
    """The copied numpy generators give the reference's arrays."""
    for mine, theirs in ((tpcds.gen_tpcds(3000, 13),
                          ref_tpcds.gen_tpcds(3000, 13)),
                         (ssbm.gen_ssbm(3000, 11),
                          ref_ssbm.gen_ssbm(3000, 11))):
        assert list(mine) == list(theirs)
        for t in mine:
            assert list(mine[t]) == list(theirs[t])
            for c in mine[t]:
                assert np.array_equal(mine[t][c], theirs[t][c])


# ---------------------------------------------------------------------------
# statements that only the executor runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exec_engines():
    return _catalogs(exec_tables())


@pytest.mark.parametrize("sql", EXECUTOR_SQL)
def test_executor_statement_matches_reference(exec_engines, executor_only,
                                              sql):
    eng, ref = exec_engines
    assert_same(eng, ref, sql)


@pytest.mark.parametrize("sql", DATE_SQL)
def test_executor_dates_match_reference(tpch, executor_only, sql):
    eng, ref = tpch
    assert_same(eng, ref, sql)


def test_string_cast_lowers_in_the_fragment(exec_engines):
    """A string -> value cast is a lookup table in the fragment now, in
    both packages: no fallback."""
    eng, ref = exec_engines
    sql = "select k, cast(n as integer) + 1 as n1 from r order by k"
    t0, r0 = TF.STATS["fallbacks"], RF.STATS["fallbacks"]
    assert_same(eng, ref, sql)
    assert TF.STATS["fallbacks"] == t0 and RF.STATS["fallbacks"] == r0
    assert "lutmap" in repr(eng._cached_plan(sql).fragment.rel_ir)


def test_scalar_subquery_falls_back_to_the_executor(exec_engines):
    """A scalar subquery whose own plan the fragment rejects (a window
    function) is computed by the executor at lowering time and baked in;
    the outer plan still runs as a fragment."""
    eng, ref = exec_engines
    sql = ("select count(*) as n from t where u > (select max(rn) from "
           "(select row_number() over (order by k) as rn from r) q)")
    runs0 = TF.STATS["runs"]
    got = assert_same(eng, ref, sql)
    assert TF.STATS["runs"] > runs0
    assert eng._cached_plan(sql).fragment is not None
    assert list(got.rows)[0][0] > 0


def test_run_time_rejection_falls_back(exec_engines, monkeypatch):
    """A fragment that raises Unsupported while running hands the plan to
    the executor and counts one fallback."""
    eng, _ref = exec_engines
    sql = "select g, count(*) as n from t group by g order by g"
    want = list(eng.query(sql).rows)

    def refuse(self, events=None, **_mesh_args):
        raise TF.Unsupported("refused at run time")
    monkeypatch.setattr(TF.CompiledFragment, "run", refuse)
    f0 = TF.STATS["fallbacks"]
    assert list(eng.query(sql).rows) == want
    assert TF.STATS["fallbacks"] == f0 + 1


def test_trace_gives_operator_events_and_fallback_reason(tpch):
    eng, ref = tpch
    sql = ("select s_suppkey, row_number() over (partition by s_nationkey "
           "order by s_suppkey) as rn from supplier "
           "order by s_nationkey, s_suppkey limit 50")
    binder.Binder._auto_counter = ref_binder.Binder._auto_counter = 0
    got, want = eng.query(sql, trace=True), ref.query(sql, trace=True)
    assert list(got.rows) == list(want.rows)
    assert [e["op"] for e in got.trace] == [e["op"] for e in want.trace]
    fb = got.trace[0]
    assert fb["op"] == "fragment.fallback" and fb["reason"] == "expr WinRef"
    assert fb["reason"] == want.trace[0]["reason"]
    ops = [e for e in got.trace[1:]]
    assert {"Scan", "Project", "Limit"} <= {e["op"] for e in ops}
    assert all("usec" in e and "rows" in e for e in ops)
    assert [e["rows"] for e in ops] == [e["rows"] for e in want.trace[1:]]
    # the profiler is off again and holds no events of this query
    from monetdb_tpu_torch.obs import PROFILER
    assert not PROFILER.enabled


def test_query_stmt_and_execute_plan(exec_engines):
    """The other entry points of the reference Engine: a parsed statement,
    and a bound plan."""
    from monetdb_tpu_torch.sql.parser import parse
    eng, _ref = exec_engines
    sql = "select g, sum(v) as sv from t group by g order by g"
    want = list(eng.query(sql).rows)
    assert list(eng.query_stmt(parse(sql)).rows) == want
    rel, out_cols = eng.plan(sql)
    assert list(eng.execute_plan(rel, out_cols).rows) == want
    config.set("fragment_exec", False)
    try:
        assert list(eng.execute_plan(rel, out_cols).rows) == want
    finally:
        config.reset("fragment_exec")


def test_assert_props_holds_on_executor_outputs(tpch):
    """With ``assert_props`` on, every operator output's claimed flags are
    checked against its data (read back with .cpu().numpy())."""
    eng, _ref = tpch
    config.set("assert_props", True)
    config.set("fragment_exec", False)
    try:
        for q in (1, 3, 5):
            assert len(eng.query(QUERIES[q]).rows) > 0
    finally:
        config.reset("assert_props")
        config.reset("fragment_exec")


def test_executor_device_is_the_catalogs(exec_engines):
    import torch
    eng, _ref = exec_engines
    ex = Executor(eng.catalog)
    assert ex.device == torch.device("cpu")
    from monetdb_tpu_torch.table import Catalog
    with pytest.raises(ExecError, match="exactly one device"):
        Executor(Catalog())


WAITS_SQL = [
    ("select st_area(s) from r", "ops/geom.py"),
    ("select name from sys.tables", "storage"),
]
#: modules a later slice ported: their statements answer as the reference
PORTED = {"storage", "ops/geom.py"}


@pytest.mark.parametrize("sql,needle", WAITS_SQL)
def test_waits_name_the_missing_module(exec_engines, sql, needle):
    """What this slice leaves out raises, and the message names the module
    that is missing; once that module is ported (the storage layer, with
    system tables), the statement answers as the reference does."""
    eng, ref = exec_engines
    if needle in PORTED:
        assert_same(eng, ref, sql)
        return
    with pytest.raises((ExecError, TF.Unsupported, ImportError)) as exc:
        eng.query(sql)
    assert needle in str(exc.value)


def test_dup_join_through_executor(executor_only):
    """Joins with duplicate keys on both sides, every kind."""
    eng, ref = _catalogs(dup_tables())
    for sql in JOIN_EXPAND_SQL:
        assert_same(eng, ref, sql)
