"""Every in-process path of the PyTorch port (monetdb_tpu_torch,
device="cpu") against the JAX package's (monetdb_tpu) rows for the TPC-H
queries, on the same generated data.

The JAX Engine answers each (scale factor, query) once in this module,
through its fragment with its default config; each path of the port is
held to that answer (tests/torch_parity.py: names, types, rows; floats to
rel 1e-12, the executor's to rel 1e-9):

* the fragment Engine, cold and warm: the 22 queries at SF0.01, and Q1-Q6,
  Q9, Q10, Q13, Q16 and Q18-Q21 at SF0.1.  SF0.1's lineitem capacity 2^20
  is above the 2^17 compaction threshold, so it reaches ``r_compact`` and
  the count-then-retry loop, whose shrunk buckets re-lower Q3's and Q20's
  group-by to the sort strategy; Q13 and Q21 find duplicate build keys on
  the device and re-lower as expanding joins;
* the op-at-a-time executor (``fragment_exec`` off), the 22 queries at
  SF0.01, also against the port's own fragment;
* ``Session.sql`` over ``load_tpch_db(0.01)``: Q1, Q3, Q6, Q13 and Q18;
* ``STATS["runs"]``: one run per query over the 22 queries.

The paths run in that order, the fragment first: its retry counts need
plans that no other path lowered before.
"""

import os
from types import SimpleNamespace

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import pytest  # noqa: E402

import monetdb_tpu.config as ref_config  # noqa: E402
import monetdb_tpu.sql.binder as ref_binder  # noqa: E402
from monetdb_tpu.bench.tpch_load import load_tpch as ref_load_tpch  # noqa: E402
from monetdb_tpu.engine import Engine as RefEngine  # noqa: E402
import monetdb_tpu_torch.config as config  # noqa: E402
import monetdb_tpu_torch.sql.binder as binder  # noqa: E402
from monetdb_tpu_torch.bench.tpch_gen import gen_tpch  # noqa: E402
from monetdb_tpu_torch.bench.tpch_load import load_tpch, load_tpch_db  # noqa: E402
from monetdb_tpu_torch.bench.tpch_queries import QUERIES  # noqa: E402
from monetdb_tpu_torch.engine import (  # noqa: E402
    Engine, plan_cache_clear, plan_cache_stats)
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
from monetdb_tpu_torch.session import Session  # noqa: E402

from torch_parity import (  # noqa: E402,F401  (executor_only: a fixture)
    EXECUTOR_ATOL, EXECUTOR_RTOL, FRAGMENT_RTOL, assert_rows_close,
    assert_same_result, executor_only)
from test_torch_engine_cd import _ir_nodes  # noqa: E402
from torch_session_scripts import outcome  # noqa: E402


class _Tpch:
    """One scale factor: the port's catalog (and, on first use, a
    ``Session`` over a ``Database`` of the same data) and the JAX Engine,
    whose answers are kept."""

    def __init__(self, sf):
        self.sf = sf
        self.engine = Engine(load_tpch(sf, device="cpu"))
        self.ref = RefEngine(ref_load_tpch(sf))
        self._session = None
        self._answers = {}

    @property
    def session(self):
        if self._session is None:
            self._session = Session(load_tpch_db(self.sf, gen_tpch(self.sf),
                                                 device="cpu"))
        return self._session

    def answer(self, q):
        """The JAX Engine's result of Q``q``: its fragment, its default
        config and its binder counter at 0, whichever path asks first."""
        if q not in self._answers:
            saved = ref_config.get("fragment_exec")
            ref_config.reset("fragment_exec")
            ref_binder.Binder._auto_counter = 0
            try:
                res = self.ref.query(QUERIES[q])
                self._answers[q] = SimpleNamespace(
                    names=res.names, types=res.types, rows=list(res.rows))
            finally:
                ref_config.set("fragment_exec", saved)
        return self._answers[q]


@pytest.fixture(scope="module")
def tpch():
    """``tpch(sf)``: that scale factor's data, made once.  The port's plan
    cache and capacity memo start empty."""
    plan_cache_clear()
    with TF._LOCK:
        TF._JOIN_MEMO.clear()
    made = {}

    def get(sf):
        if sf not in made:
            made[sf] = _Tpch(sf)
        return made[sf]
    return get


@pytest.fixture(autouse=True)
def _same_generated_names():
    """Generated result names (``col<N>``) come from a process-wide counter
    in each binder; start both at 0, whatever other files of the same
    worker bound before."""
    binder.Binder._auto_counter = ref_binder.Binder._auto_counter = 0


_FRAGMENT_CASES = [(0.01, q) for q in range(1, 23)] + \
    [(0.1, q) for q in (1, 2, 3, 4, 5, 6, 9, 10, 13, 16, 18, 19, 20, 21)]


@pytest.mark.parametrize("sf,q", _FRAGMENT_CASES,
                         ids=[f"sf{sf}-q{q}" for sf, q in _FRAGMENT_CASES])
def test_fragment_matches_reference(tpch, sf, q):
    d = tpch(sf)
    eng = d.engine
    stats0 = dict(TF.STATS)
    got = eng.query(QUERIES[q])
    want = d.answer(q)
    assert_same_result(got, want, FRAGMENT_RTOL)
    assert got.rows
    frag = eng._cached_plan(QUERIES[q]).fragment
    nodes = _ir_nodes(frag.rel_ir)
    if sf == 0.1 and q == 1:
        # 2^19-row compaction bucket < ~590k live rows: overflow,
        # re-lowered with the measured total
        assert TF.STATS["cap_retries"] > stats0["cap_retries"]
    if sf == 0.1 and q == 6:
        # a few thousand live rows: compacted, then shrunk to their bucket
        assert "'compact'" in repr(frag.rel_ir)
        assert max(frag.expand.values()) < (1 << 19)
    if q in (13, 21):
        # the build side has duplicate keys: found on the device, then
        # re-lowered as an expanding join
        assert TF.STATS["uniq_retries"] > stats0["uniq_retries"]
        assert "join_expand" in nodes
    if q == 16:
        assert "count_distinct" in nodes
    if q in (7, 8, 9):
        assert "dextract" in nodes
    # a warm run reuses the cached plan and gives the same rows
    warm = eng.query(QUERIES[q], trace=True)
    assert_rows_close(list(warm.rows), want.rows, FRAGMENT_RTOL)
    run = [e for e in warm.trace if e["op"] == "fragment.run"]
    assert run and run[0]["device"] == "cpu" and run[0]["rpcs"] >= 1


@pytest.mark.parametrize("q", range(1, 23), ids=lambda q: f"q{q}")
def test_executor_matches_reference_and_fragment(tpch, executor_only, q):
    d = tpch(0.01)
    eng = d.engine
    runs0, falls0 = TF.STATS["runs"], TF.STATS["fallbacks"]
    got = eng.query(QUERIES[q])
    assert_same_result(got, d.answer(q), EXECUTOR_RTOL, EXECUTOR_ATOL)
    # the executor answered: no fragment ran, and a forced executor run is
    # no fallback
    assert TF.STATS["runs"] == runs0 and TF.STATS["fallbacks"] == falls0
    config.reset("fragment_exec")
    frag = eng.query(QUERIES[q])
    assert TF.STATS["runs"] > runs0
    assert frag.names == got.names
    assert_rows_close(list(got.rows), list(frag.rows), EXECUTOR_RTOL,
                      EXECUTOR_ATOL)


@pytest.mark.parametrize("q", [1, 3, 6, 13, 18], ids=lambda q: f"q{q}")
def test_session_matches_reference(tpch, q):
    d = tpch(0.01)
    falls = TF.STATS["fallbacks"]
    got = [d.session.sql(QUERIES[q]) for _ in range(2)]
    assert outcome(got[1]) == outcome(got[0])
    assert_same_result(got[0], d.answer(q), FRAGMENT_RTOL)
    assert TF.STATS["fallbacks"] == falls
    assert plan_cache_stats()["entries"] >= 1


def test_runs_count_one_per_query_over_22_tpch(tpch):
    """22 queries, 22 runs, as the reference's own test of the same queries
    asserts (tests/test_fragment.py::test_all_22_tpch_fused); the port's
    plan-time subquery fragments (Q2, Q11, Q15, Q17, Q20, Q22 bake scalar
    subqueries) count apart.  Both packages side by side, one query at a
    time through their servers: test_torch_server.py's wire parity."""
    plan_cache_clear()                  # every query lowered in this test
    eng = Engine(tpch(0.01).engine.catalog)
    runs, subs = TF.STATS["runs"], TF.STATS["subquery_runs"]
    for q in range(1, 23):
        eng.query(QUERIES[q])
    assert TF.STATS["runs"] - runs == 22
    assert TF.STATS["subquery_runs"] - subs > 0
