"""The three open faults of the PyTorch port against the reference JAX
package, each held by a test that fails on the port before its repair:

1. TRACE and the profiler tag a fragment run ``fragment:jit``, the
   reference's tag (the port wrote ``fragment:torch`` and did not set the
   algorithm when a run starts);
2. ``exec.fragment.STATS["runs"]`` counts one run per query: the fragments
   that plan-time scalar subqueries run on count under ``subquery_runs``
   (over the 22 TPC-H queries ``runs`` rose by 28 on the port, by 22 in the
   reference);
3. ``config`` and ``sys.env`` carry the reference's keys, ``pallas_groupby``
   (the TPU gate the port leaves out) excepted, with the reference's
   defaults, ``spmd_auto_mesh`` excepted: off in the port (on four H100s
   the default thread mesh ran the 22 TPC-H queries a median 9.96x slower
   than one card), on in the reference.
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import pytest  # noqa: E402
import monetdb_tpu.sql.binder as ref_binder  # noqa: E402
import monetdb_tpu_torch.sql.binder as binder  # noqa: E402

import monetdb_tpu.config as ref_config  # noqa: E402
from monetdb_tpu.session import Session as RefSession  # noqa: E402
from monetdb_tpu.storage import Database as RefDatabase  # noqa: E402
from monetdb_tpu_torch import config  # noqa: E402
from monetdb_tpu_torch.bench.tpch_load import load_tpch  # noqa: E402
from monetdb_tpu_torch.bench.tpch_queries import QUERIES  # noqa: E402
from monetdb_tpu_torch.engine import Engine, plan_cache_clear  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
from monetdb_tpu_torch.obs import PROFILER  # noqa: E402
from monetdb_tpu_torch.session import Session  # noqa: E402
from monetdb_tpu_torch.storage import Database  # noqa: E402

_TABLE = ["create table t (a int, b int)",
          "insert into t values (1, 10), (2, 20), (1, 5), (3, 7)"]


@pytest.fixture(autouse=True, scope="module")
def _restore_binder_counters():
    """Leave the generated-name counters (``col<N>``) of both binders as
    this file found them: other files of the same worker compare names
    across the packages."""
    saved = binder.Binder._auto_counter, ref_binder.Binder._auto_counter
    yield
    binder.Binder._auto_counter, ref_binder.Binder._auto_counter = saved


@pytest.fixture(autouse=True)
def _single_device_reference():
    ref_config.set("spmd_auto_mesh", False)
    yield
    ref_config.reset("spmd_auto_mesh")


def _sessions():
    port, ref = Session(Database(device="cpu")), RefSession(RefDatabase())
    for st in _TABLE:
        port.sql(st)
        ref.sql(st)
    return port, ref


def _fragment_rows(res):
    """The TRACE rows of fragment runs, without their time."""
    return [r[1:] for r in res.rows if r[3] == "fragment.run"]


def test_trace_fragment_row_matches_reference():
    port, ref = _sessions()
    sql = "trace select a, sum(b) from t group by a"
    got, want = port.sql(sql), ref.sql(sql)
    assert got.names == want.names == ["usec", "rows", "algorithm",
                                      "statement"]
    assert _fragment_rows(got) == _fragment_rows(want) \
        == [(3, "fragment:jit", "fragment.run")]


def test_fragment_run_sets_the_profiler_algorithm():
    """A fragment run tags the profiler's open operator as the reference's
    does (set_algorithm at the start of CompiledFragment.run), and its
    event says whether the run lowered the IR (the reference's compile
    miss) or reused it (hit)."""
    plan_cache_clear()                  # a fresh lowering for this Engine
    eng = Engine(load_tpch(0.01, device="cpu"))
    first = eng.query(QUERIES[6], trace=True).trace
    again = eng.query(QUERIES[6], trace=True).trace
    run1 = [e for e in first if e["op"] == "fragment.run"]
    run2 = [e for e in again if e["op"] == "fragment.run"]
    assert run1[0]["algorithm"] == run2[0]["algorithm"] == "fragment:jit"
    assert (run1[0]["compile"], run2[0]["compile"]) == ("miss", "hit")
    PROFILER.enabled = True
    try:
        with PROFILER.op("outer"):
            eng.query(QUERIES[6])
        assert PROFILER.events[-1]["algorithm"] == "fragment:jit"
    finally:
        PROFILER.enabled = False
        PROFILER.events.clear()


def test_runs_count_one_per_query_over_22_tpch():
    """22 queries, 22 runs, as the reference's own test of the same queries
    asserts (tests/test_fragment.py::test_all_22_tpch_fused); the port's
    plan-time subquery fragments (Q2, Q11, Q15, Q17, Q20, Q22 bake scalar
    subqueries) count apart.  Both packages side by side, one query at a
    time through their servers: test_torch_server.py's wire parity."""
    plan_cache_clear()                  # every query lowered in this test
    eng = Engine(load_tpch(0.01, device="cpu"))
    runs, subs = TF.STATS["runs"], TF.STATS["subquery_runs"]
    for q in range(1, 23):
        eng.query(QUERIES[q])
    assert TF.STATS["runs"] - runs == 22
    assert TF.STATS["subquery_runs"] - subs > 0


#: the port's deliberate divergences from the reference's config: a key
#: it leaves out, and a default it turns the other way
_LEFT_OUT = {"pallas_groupby"}
_OTHER_DEFAULT = {"spmd_auto_mesh": False}


def test_config_has_the_reference_keys():
    want = set(ref_config._defaults) - _LEFT_OUT
    assert set(config._defaults) == want
    for k in want:
        assert config._defaults[k] == _OTHER_DEFAULT.get(
            k, ref_config._defaults[k]), k
    assert ref_config._defaults["spmd_auto_mesh"] is True
    config.set("spmd_auto_mesh", True)
    try:
        assert config.get("spmd_auto_mesh") is True
    finally:
        config.reset("spmd_auto_mesh")
    assert config.get("spmd_auto_mesh") is False


def test_sys_env_rows_match_reference():
    port, ref = _sessions()
    sql = "select name from sys.env order by name"
    want = [r for r in ref.sql(sql).rows if r != ("pallas_groupby",)]
    assert port.sql(sql).rows == want
    # the values of the configuration keys, too
    sql = "select name, value from sys.env"
    keys = set(config._defaults)
    got = {n: v for n, v in port.sql(sql).rows if n in keys}
    ref_config.reset("spmd_auto_mesh")
    want = {n: v for n, v in ref.sql(sql).rows if n in keys}
    assert want["spmd_auto_mesh"] == "True"
    want.update({k: str(v) for k, v in _OTHER_DEFAULT.items()})
    assert got == want
