"""SQL over the port's row mesh (exec/fragment.py _run_spmd) against the
reference package's mesh on its 8 virtual CPU devices.

* the SPMD rewrite: for all 22 TPC-H queries the port's ``_SpmdRewriter``
  gives the reference's mesh IR, at the default ``spmd_*`` thresholds and
  at the multi-chip dry run's scaled ones;
* TPC-H 1, 3, 5, 6, 13, 16, 18, 21 at SF0.01 through ``Engine(cat,
  mesh=...)``: the port's rows equal the reference mesh's and the port's
  single-device rows, and ``spmd_runs``, the ``shuffle_*`` counts and
  ``cap_retries`` move alike on both sides;
* the reference's tests/test_spmd_shuffle.py cases, its mesh cases of
  test_wide_sum.py and test_assert_props.py, and a ``Session`` over a mesh.

Both packages start every comparison from a cold plan cache and capacity
memo, and generated column names (``Binder._auto_counter``) start at 0.
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import math  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from monetdb_tpu import config as RC  # noqa: E402
from monetdb_tpu import engine as RE  # noqa: E402
from monetdb_tpu.bench.tpch_gen import gen_tpch  # noqa: E402
from monetdb_tpu.bench import tpch_load as RL  # noqa: E402
from monetdb_tpu.exec import fragment as RF  # noqa: E402
from monetdb_tpu.session import Session as RSession  # noqa: E402
from monetdb_tpu.sql import binder as RB  # noqa: E402
from monetdb_tpu_torch import config as TC  # noqa: E402
from monetdb_tpu_torch import engine as TE  # noqa: E402
from monetdb_tpu_torch.bench.tpch_load import (  # noqa: E402
    load_tables, load_tpch_db)
from monetdb_tpu_torch.bench.tpch_queries import QUERIES  # noqa: E402
from monetdb_tpu_torch.column import Column  # noqa: E402
from monetdb_tpu_torch.dtypes import I32, I64, decimal, varchar  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
from monetdb_tpu_torch.parallel import row_mesh  # noqa: E402
from monetdb_tpu_torch.session import Session  # noqa: E402
from monetdb_tpu_torch.sql import binder as TB  # noqa: E402
from monetdb_tpu_torch.storage.columns import (  # noqa: E402
    column_from_pyvalues)
from monetdb_tpu_torch.table import Catalog, Table  # noqa: E402
from test_torch_lowering import _ir_differ  # noqa: E402
from test_torch_parallel import _one_op_thread  # noqa: E402,F401

D = 8
_COUNTED = ("spmd_runs", "shuffle_joins", "shuffle_groupbys",
            "shuffle_distincts", "cap_retries")
#: the multi-chip dry run's thresholds (__graft_entry__.py:105-107): tiny
#: tables take the shard / shuffle / broadcast decisions SF100 tables would
_DRYRUN = {"spmd_min_shard_rows": 64, "spmd_broadcast_rows": 4096,
           "spmd_shuffle_min_rows": 64}
#: the reference's test_spmd_shuffle.py thresholds
_FORCED = {"spmd_min_shard_rows": 64, "spmd_broadcast_rows": 128,
           "spmd_shuffle_min_rows": 64}


def _mesh():
    return row_mesh(["cpu"] * D)


def _ref_mesh():
    assert len(jax.devices()) >= D
    return Mesh(np.array(jax.devices()[:D]), ("x",))


def _cold():
    """Both packages' plan caches and capacity memos emptied."""
    TE.plan_cache_clear()
    RE.plan_cache_clear()
    with TF._LOCK:
        TF._JOIN_MEMO.clear()
    with RF._LOCK:
        RF._JOIN_MEMO.clear()


def _set_both(values: dict):
    for k, v in values.items():
        TC.set(k, v)
        RC.set(k, v)


def _reset_both(values: dict):
    for k in values:
        TC.reset(k)
        RC.reset(k)


def _rows_equal(a, b) -> bool:
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                if not (x == pytest.approx(y, rel=1e-9)
                        or (math.isnan(x) and math.isnan(y))):
                    return False
            elif x != y or type(x) is not type(y):
                return False
    return True


def _delta(stats, before):
    return {k: stats[k] - before[k] for k in _COUNTED}


# ---------------------------------------------------------------------------
# the rewrite
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch():
    data = gen_tpch(0.01)
    return data, load_tables(data, device="cpu"), RL.load_tables(data)


def _lowered(binder_mod, fragment_mod, cat, sql):
    saved = binder_mod.Binder._auto_counter
    binder_mod.Binder._auto_counter = 0
    try:
        rel, _cols = binder_mod.bind_select(cat, sql)
    finally:
        binder_mod.Binder._auto_counter = saved
    low = fragment_mod.Lowering(cat)
    low.collect_refs(rel)
    ir, _penv, _cap = low.rel(rel)
    return ir, low


def _rewrite(fragment_mod, ir, low):
    holder = types.SimpleNamespace(inputs=low.inputs,
                                   input_tables=low.input_tables)
    sharded = fragment_mod.CompiledFragment._pick_shard_inputs(holder, D)
    rwr = fragment_mod._SpmdRewriter(sharded, D, {}, dict(low.scan_counts))
    return sharded, rwr.rw(ir), rwr.counts, rwr.lane_used


@pytest.mark.parametrize("q", range(1, 23))
def test_rewrite_matches_reference(tpch, q):
    _data, tcat, rcat = tpch
    tir, tlow = _lowered(TB, TF, tcat, QUERIES[q])
    rir, rlow = _lowered(RB, RF, rcat, QUERIES[q])
    for values in ({}, _DRYRUN):
        _set_both(values)
        try:
            got = _rewrite(TF, tir, tlow)
            want = _rewrite(RF, rir, rlow)
        finally:
            _reset_both(values)
        assert got[0] == want[0] and got[0]
        assert got[2:] == want[2:]
        # the IR trees: a plan-time float literal may differ in its last
        # bit (test_torch_lowering.py), everything else exactly
        assert _ir_differ(got[1], want[1]) is None, values


def test_dryrun_thresholds_give_every_mesh_node(tpch):
    """Across the 22 queries the scaled thresholds produce all four mesh
    nodes, so the rewrite test above covers each."""
    _data, tcat, _rcat = tpch
    seen = set()

    def walk(ir):
        if isinstance(ir, tuple):
            if ir and isinstance(ir[0], str):
                seen.add(ir[0])
            for x in ir:
                walk(x)

    _set_both(_DRYRUN)
    try:
        for q in range(1, 23):
            walk(_rewrite(TF, *_lowered(TB, TF, tcat, QUERIES[q]))[1][0])
    finally:
        _reset_both(_DRYRUN)
    assert {"scan_sharded", "gather", "repartition",
            "groupby_dense_spmd"} <= seen


# ---------------------------------------------------------------------------
# TPC-H through the mesh Engine, both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(tpch):
    _data, tcat, rcat = tpch
    return (TE.Engine(tcat), TE.Engine(tcat, mesh=_mesh()),
            RE.Engine(rcat), RE.Engine(rcat, mesh=_ref_mesh()))


def _query(binder_mod, eng, sql):
    binder_mod.Binder._auto_counter = 0
    return list(eng.query(sql).rows)


@pytest.mark.parametrize("q", [1, 3, 5, 6, 13, 16, 18, 21])
def test_tpch_mesh_engine_equals_reference(engines, q):
    t1, t8, _r1, r8 = engines
    sql = QUERIES[q]
    _cold()                     # both meshes start from an empty memo
    s0 = dict(TF.STATS)
    t_mesh = _query(TB, t8, sql)
    t_delta = _delta(TF.STATS, s0)
    s0 = dict(RF.STATS)
    r_mesh = _query(RB, r8, sql)
    r_delta = _delta(RF.STATS, s0)
    t_single = _query(TB, t1, sql)
    assert t_delta["spmd_runs"] == 1, t_delta
    assert t_delta == r_delta
    assert _rows_equal(t_mesh, r_mesh)
    assert _rows_equal(t_mesh, t_single)


def test_tpch_shuffled_at_dryrun_thresholds(tpch):
    """Q18 at the dry run's thresholds: a join and a group-by go through
    the exchange on both sides alike, a channel-less group-by over the
    gathered rows is retried once at a smaller bucket on both sides, and
    the rows are equal.  (Q3 shuffles the same two nodes, without the
    retry; the reference's compiles make each query cost seconds.)"""
    data, tcat, _rcat = tpch
    _set_both(_DRYRUN)
    try:
        t1, t8 = TE.Engine(tcat), TE.Engine(tcat, mesh=_mesh())
        r8 = RE.Engine(RL.load_tables(data), mesh=_ref_mesh())
        total = dict.fromkeys(_COUNTED, 0)
        for q in (18,):
            _cold()
            single = _query(TB, t1, QUERIES[q])
            s0 = dict(TF.STATS)
            got = _query(TB, t8, QUERIES[q])
            d = _delta(TF.STATS, s0)
            s0 = dict(RF.STATS)
            want = _query(RB, r8, QUERIES[q])
            assert d == _delta(RF.STATS, s0), q
            assert _rows_equal(got, want) and _rows_equal(got, single), q
            for k in _COUNTED:
                total[k] += d[k]
    finally:
        _reset_both(_DRYRUN)
    assert total["spmd_runs"] == 1 and total["cap_retries"] == 1
    assert total["shuffle_joins"] > 0 and total["shuffle_groupbys"] > 0


def test_spmd_trace_event_matches_reference(engines):
    t1, t8, _r1, r8 = engines
    _cold()
    TB.Binder._auto_counter = RB.Binder._auto_counter = 0
    got = [e for e in t8.query(QUERIES[6], trace=True).trace
           if e["op"] == "fragment.run"]
    want = [e for e in r8.query(QUERIES[6], trace=True).trace
            if e["op"] == "fragment.run"]
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    for k in ("algorithm", "rows", "devices", "shuffles"):
        assert got[0][k] == want[0][k], k
    assert got[0]["algorithm"] == "fragment:spmd" and got[0]["devices"] == D


# ---------------------------------------------------------------------------
# the reference's test_spmd_shuffle.py cases, on the port
# ---------------------------------------------------------------------------


@pytest.fixture
def forced():
    for k, v in _FORCED.items():
        TC.set(k, v)
    TE.plan_cache_clear()
    yield
    for k in _FORCED:
        TC.reset(k)
    TE.plan_cache_clear()


def _table(name, cols):
    return Table.from_dict(name, {
        n: column_from_pyvalues(list(v), t, device="cpu")
        for n, (t, v) in cols.items()})


def _parity(cat, sql, want=None):
    """Single-device vs mesh rows; returns the STATS delta of the mesh
    run, which must have run on the mesh."""
    a = TE.Engine(cat).query(sql)
    s0 = dict(TF.STATS)
    b = TE.Engine(cat, mesh=_mesh()).query(sql)
    delta = {k: TF.STATS[k] - s0[k] for k in TF.STATS}
    assert delta["spmd_runs"] >= 1, "plan did not run on the mesh"
    assert _rows_equal(list(a.rows), list(b.rows)), \
        f"SPMD diverged:\n single {list(a.rows)[:5]}\n mesh {list(b.rows)[:5]}"
    if want is not None:
        assert _rows_equal(list(b.rows), want)
    return delta


def test_shuffle_join_exceeding_broadcast_threshold(forced):
    rng = np.random.default_rng(5)
    n_fact, n_dim = 4096, 1024
    fk = rng.integers(0, n_dim, n_fact)
    amt = rng.integers(1, 100, n_fact)
    cat = Catalog()
    cat.add(_table("fact", {"fk": (I64, fk.tolist()),
                            "amt": (I64, amt.tolist())}))
    cat.add(_table("dim", {"id": (I64, list(range(n_dim))),
                           "grp": (I64, [i % 7 for i in range(n_dim)])}))
    d = _parity(cat, "select d.grp, sum(f.amt) from fact f, dim d "
                     "where f.fk = d.id group by d.grp order by d.grp")
    assert d["shuffle_joins"] >= 1, f"join did not shuffle: {d}"


def test_shuffle_groupby_high_cardinality(forced):
    rng = np.random.default_rng(7)
    n = 1 << 15
    keys = rng.integers(0, 10_000, n) * 1_000_003
    vals = rng.integers(1, 50, n)
    cat = Catalog()
    cat.add(_table("t", {"k": (I64, keys.tolist()),
                         "v": (I64, vals.tolist())}))
    d = _parity(cat, "select k, sum(v), count(*), min(v), max(v) "
                     "from t group by k order by k limit 50")
    assert d["shuffle_groupbys"] >= 1, f"group-by did not shuffle: {d}"


def test_shuffle_distinct(forced):
    rng = np.random.default_rng(9)
    n = 1 << 14
    keys = (rng.integers(0, 5_000, n) * 2_000_003).tolist()
    cat = Catalog()
    cat.add(_table("t", {"k": (I64, keys)}))
    d = _parity(cat, "select distinct k from t order by k limit 40")
    assert d["shuffle_distincts"] >= 1, f"distinct did not shuffle: {d}"


def test_shuffle_lane_overflow_retries(forced):
    """Every row hashes to one destination shard, so the first lane
    capacity overflows; the host retries with the measured lane."""
    n = 1 << 14
    cat = Catalog()
    cat.add(_table("t", {"k": (I64, [42] * n), "v": (I64, list(range(n)))}))
    r0 = TF.STATS["cap_retries"]
    d = _parity(cat, "select k * 7, sum(v) from t group by k * 7",
                want=[(294, n * (n - 1) // 2)])
    assert d["shuffle_groupbys"] >= 1
    assert TF.STATS["cap_retries"] > r0, "skewed lanes should have retried"


def test_shuffle_left_and_semi_joins(forced):
    n_dim = 512
    cat = Catalog()
    lk = [i % (2 * n_dim) if i % 5 else None for i in range(4096)]
    cat.add(_table("l", {"k": (I64, lk), "v": (I64, list(range(4096)))}))
    cat.add(_table("r", {"id": (I64, list(range(n_dim))),
                         "w": (I64, [i * 10 for i in range(n_dim)])}))
    d = _parity(cat, "select count(*), sum(r.w), sum(l.v) from l "
                     "left join r on l.k = r.id")
    assert d["shuffle_joins"] >= 1
    d2 = _parity(cat, "select count(*) from l where k in "
                      "(select id from r)")
    assert d2["spmd_runs"] >= 1


def test_broadcast_still_used_for_small_builds(forced):
    cat = Catalog()
    cat.add(_table("fact", {"fk": (I64, [i % 64 for i in range(4096)]),
                            "amt": (I64, [1] * 4096)}))
    cat.add(_table("dim", {"id": (I64, list(range(64))),
                           "grp": (I64, [i % 3 for i in range(64)])}))
    d = _parity(cat, "select d.grp, sum(f.amt) from fact f, dim d "
                     "where f.fk = d.id group by d.grp order by d.grp")
    assert d["shuffle_joins"] == 0, f"small build should broadcast: {d}"


def test_shuffle_string_keys(forced):
    names = [f"name{i:05d}" for i in range(1024)]
    cat = Catalog()
    rng = np.random.default_rng(3)
    picks = rng.integers(0, 1024, 4096)
    cat.add(_table("f", {"nm": (varchar(12), [names[i] for i in picks]),
                         "x": (I64, list(range(4096)))}))
    cat.add(_table("d", {"nm": (varchar(12), names),
                         "y": (I64, list(range(1024)))}))
    dd = _parity(cat, "select count(*), sum(f.x + d.y) from f, d "
                      "where f.nm = d.nm")
    assert dd["shuffle_joins"] >= 1


def _keyed_table(k, v) -> Catalog:
    cat = Catalog()
    cat.add(Table.from_dict("t", {
        "k": Column.from_numpy(k, device="cpu"),
        "v": Column.from_numpy(v, device="cpu")}))
    return cat


_GATHERED_SQL = ("select k, sum(v), count(*) from t where v < 3 group by k "
                 "order by k")


def _shrunk_on_one_device(n: int) -> list:
    """Run _GATHERED_SQL on one device over 50 keys, twice, so that the
    memo shrinks its compaction and group buckets to the live count; the
    plan's sort group-by then has no retry channel (its capacity is its
    bound).  Returns the rows."""
    rng = np.random.default_rng(1)
    cat = _keyed_table(rng.integers(0, 50, n).astype(np.int64) * 1_000_003,
                       rng.integers(0, 10_000, n).astype(np.int64))
    _cold()
    single = TE.Engine(cat)
    rows = single.query(_GATHERED_SQL).rows
    single.query(_GATHERED_SQL)
    return cat, rows


def test_group_over_gathered_compactions_runs_on_the_mesh():
    """A sort group-by whose output capacity is its one-device bound (no
    retry channel) over a gather of shard-local compactions: the mesh
    hands it 8x that many row slots, so it reports its group count.  A
    count within its capacity, in the smallest bucket, is no overflow, and
    the mesh run finishes without a retry (the reference retries until its
    12 attempts run out, then runs the plan on one device - TPC-H Q2 and
    Q18 at SF1 do the same)."""
    cat, want = _shrunk_on_one_device(1 << 20)
    for _ in range(2):
        TE.plan_cache_clear()
        s0 = dict(TF.STATS)
        got = TE.Engine(cat, mesh=_mesh()).query(_GATHERED_SQL).rows
        d = {k: TF.STATS[k] - s0[k] for k in TF.STATS}
        assert (d["runs"], d["spmd_runs"], d["cap_retries"]) == \
            (1, 1, 0), d
        assert got == want and len(got) == 50


def test_group_above_its_bound_on_the_mesh_runs_on_one_device():
    """The same plan, its buckets shrunk by a one-device run, over a table
    of the same capacity whose filter now keeps 6000 rows of distinct keys
    (as after DML): each shard's compaction fits its bucket, but the
    gathered rows hold more groups than the channel-less group-by's
    capacity.  The mesh must not return its truncated groups: the plan
    runs on one device, which grows the buckets and answers in full."""
    n, live = 1 << 20, 6000
    _shrunk_on_one_device(n)
    rng = np.random.default_rng(2)
    top = 49 * 1_000_003
    k = rng.integers(0, top + 1, n).astype(np.int64)
    k[:2] = 0, top                          # the same min / max as before
    v = rng.integers(3, 10_000, n).astype(np.int64)
    v[:2] = 9_999, 3
    rows = rng.choice(np.arange(2, n), live, replace=False)
    k[rows] = rng.choice(np.arange(1, top), live, replace=False)
    v[rows] = rng.integers(0, 3, live)
    s0 = dict(TF.STATS)
    got = TE.Engine(_keyed_table(k, v), mesh=_mesh()).query(
        _GATHERED_SQL).rows
    d = {key: TF.STATS[key] - s0[key] for key in TF.STATS}
    with TF._LOCK:
        assert len(TF._JOIN_MEMO) == 1      # the one plan, memo shared
    order = np.argsort(k[rows])
    assert [tuple(int(x) for x in r) for r in got] == \
        [(int(a), int(b), 1) for a, b in zip(k[rows][order],
                                             v[rows][order])]
    assert d["spmd_runs"] == 1 and d["cap_retries"] >= 1, d


# ---------------------------------------------------------------------------
# the reference's mesh cases of test_wide_sum.py and test_assert_props.py
# ---------------------------------------------------------------------------


def test_wide_sum_spmd_parity():
    """Per-shard limb partials psum-combine exactly (the two-phase
    BATgroupavg3combine shape, gdk/gdk_aggr.c:2634)."""
    n, big, small = 400_000, 40_000_000_000_000, 9_000_000_000_000
    g = np.repeat(np.arange(3), n).astype(np.int32)
    v = np.full(3 * n, small, np.int64)
    v[:n] = big
    cat = Catalog()
    cat.add(Table.from_dict("t", {
        "g": Column.from_numpy(g, I32, device="cpu"),
        "v": Column.from_numpy(v, I64, device="cpu"),
        "d": Column.from_numpy((v // 100).astype(np.int64), decimal(18, 2),
                               device="cpu")}))
    s0 = TF.STATS["spmd_runs"]
    r = TE.Engine(cat, mesh=_mesh()).query(
        "select g, sum(v) from t group by g order by g")
    assert [(int(a), int(b)) for a, b in r.rows] == [
        (0, n * big), (1, n * small), (2, n * small)]
    assert TF.STATS["spmd_runs"] > s0


def test_spmd_replication_check_runs():
    """assert_props also turns on the run-time cross-shard replication
    assert of the SPMD path (every shard's outputs compared)."""
    n = 1 << 13
    rng = np.random.default_rng(0)
    cat = Catalog()
    cat.add(Table.from_dict("big", {
        "g": Column.from_numpy(rng.integers(0, 8, n).astype(np.int64),
                               device="cpu"),
        "x": Column.from_numpy(rng.integers(0, 100, n).astype(np.int64),
                               device="cpu")}))
    sql = "select g, sum(x) from big group by g order by g"
    TC.set("assert_props", True)
    try:
        s0 = TF.STATS["spmd_runs"]
        rows = TE.Engine(cat, mesh=row_mesh(["cpu"] * 4)).query(sql).rows
        assert TF.STATS["spmd_runs"] > s0
    finally:
        TC.reset("assert_props")
    assert rows == TE.Engine(cat).query(sql).rows


def test_replication_check_catches_a_diverging_shard():
    import torch
    z = torch.zeros((), dtype=torch.int64)

    def out(v):
        return z, {0: z + 5}, z + 2, (torch.tensor([1, v]),)

    assert TF._replicated_outputs([out(7), out(7)])[1] == 2
    with pytest.raises(AssertionError, match="output.0. diverges on shard 2"):
        TF._replicated_outputs([out(7), out(7), out(8)])


# ---------------------------------------------------------------------------
# Session over a mesh
# ---------------------------------------------------------------------------


def test_session_over_mesh_equals_reference(tpch):
    data, _tcat, _rcat = tpch
    _cold()
    sql = QUERIES[6]
    s = Session(load_tpch_db(0.01, data=data, device="cpu"), mesh=_mesh())
    r = RSession(RL.load_tpch_db(data=data), mesh=_ref_mesh())
    assert s.mesh == _mesh()
    s0, r0 = dict(TF.STATS), dict(RF.STATS)
    got, want = list(s.sql(sql).rows), list(r.sql(sql).rows)
    assert _delta(TF.STATS, s0) == _delta(RF.STATS, r0)
    assert TF.STATS["spmd_runs"] - s0["spmd_runs"] == 1
    assert _rows_equal(got, want)
    # a store on the CPU gets no default mesh
    assert Session(load_tpch_db(0.01, data=data, device="cpu")).mesh is None
