"""The port's row mesh (monetdb_tpu_torch/parallel/) against numpy and
against the reference package's parallel/ on its 8 virtual CPU devices.

The port's mesh is ``row_mesh(["cpu"] * 8)``: eight shards, each on a thread
of its own.  The same numpy data, made from a seed, goes through both
packages; integer results must be equal, and the shuffle layouts (which
row lands in which lane of which shard) too.
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import threading  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from monetdb_tpu.bench.tpch_gen import _days, gen_tpch  # noqa: E402
from monetdb_tpu import parallel as RP  # noqa: E402
from monetdb_tpu.parallel import shuffle as RS  # noqa: E402
from monetdb_tpu_torch import parallel as TP  # noqa: E402
from monetdb_tpu_torch.bench import kernels as TK  # noqa: E402
from monetdb_tpu_torch.ops import cuda_kernels as CK  # noqa: E402
from monetdb_tpu_torch.parallel import mesh as TM  # noqa: E402
from monetdb_tpu_torch.parallel import shuffle as TS  # noqa: E402

D = 8


@pytest.fixture(scope="module", autouse=True)
def _one_op_thread():
    """The mesh's shards are the parallelism here: torch's own op threads
    on top of eight shard threads only contend for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= D
    return TP.row_mesh(["cpu"] * D), RP.row_mesh(jax.devices()[:D])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------


def _per_shard(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {"i": rng.integers(-1 << 40, 1 << 40, 16),
            "f": rng.standard_normal(16),
            "a2a": rng.integers(0, 1000, (D * 3, 2))}


def test_collectives_match_numpy(meshes):
    mesh, _ = meshes
    data = [_per_shard(r) for r in range(D)]

    def fn(ins, coll):
        d = data[coll.rank]
        i, f = torch.from_numpy(d["i"]), torch.from_numpy(d["f"])
        s_i, s_f = coll.psum([i, f])
        return {"rank": coll.rank, "psum_i": s_i, "psum_f": s_f,
                "pmax": coll.pmax(i), "pmin": coll.pmin(f),
                "gather": coll.all_gather(i),
                "gather0": coll.all_gather(i[0]),
                "a2a": coll.all_to_all(torch.from_numpy(d["a2a"]))}

    s0 = dict(TM.STATS)
    outs = TM.run_shards(mesh, fn, (), ())
    # 6 collectives a shard; bytes handed over by all 8 shards
    sent = 16 * 8 * 2 + 16 * 8 + 16 * 8 + 16 * 8 + 8 + D * 3 * 2 * 8
    assert {k: TM.STATS[k] - s0[k] for k in s0} == {
        "calls": 1, "collectives": 6, "bytes": D * sent}
    ints = np.stack([d["i"] for d in data])
    floats = np.stack([d["f"] for d in data])
    f_sum = floats[0].copy()
    for r in range(1, D):               # rank order, one add at a time
        f_sum = f_sum + floats[r]
    for r, o in enumerate(outs):
        assert o["rank"] == r
        assert np.array_equal(_np(o["psum_i"]), ints.sum(0))
        assert np.array_equal(_np(o["psum_f"]), f_sum)       # bit-equal
        assert np.array_equal(_np(o["pmax"]), ints.max(0))
        assert np.array_equal(_np(o["pmin"]), floats.min(0))
        assert np.array_equal(_np(o["gather"]), ints.reshape(-1))
        assert np.array_equal(_np(o["gather0"]), ints[:, 0])
        want = np.concatenate([data[s]["a2a"][3 * r:3 * r + 3]
                               for s in range(D)])
        assert np.array_equal(_np(o["a2a"]), want)


def test_run_shards_splits_views_and_replicates(meshes):
    mesh, _ = meshes
    x = torch.arange(D * 5)
    y = torch.tensor([7, 8, 9])

    def fn(ins, coll):
        a, b = ins
        return a.data_ptr(), a.tolist(), b.tolist()

    outs = TM.run_shards(mesh, fn, (x, y), (True, False))
    for r, (ptr, a, b) in enumerate(outs):
        assert a == list(range(5 * r, 5 * r + 5)) and b == [7, 8, 9]
        assert ptr == x.data_ptr() + 5 * r * x.element_size()   # a view
    with pytest.raises(ValueError):
        TM.run_shards(mesh, fn, (torch.arange(D * 5 + 1), y), (True, False))


def test_raising_shard_ends_the_call_fast(meshes):
    """One shard raises before its first collective while the others wait
    at it: the call raises that exception, well inside 5 s."""
    mesh, _ = meshes

    def fn(ins, coll):
        if coll.rank == 5:
            time.sleep(0.05)
            raise ZeroDivisionError("shard 5")
        return coll.psum(torch.ones(3))

    t0 = time.perf_counter()
    with pytest.raises(ZeroDivisionError, match="shard 5"):
        TM.run_shards(mesh, fn, (), ())
    assert time.perf_counter() - t0 < 5.0


def test_missed_collective_times_out(meshes, monkeypatch):
    """A shard that skips a collective breaks the barrier at its timeout
    instead of hanging the call."""
    mesh, _ = meshes
    assert TM.BARRIER_TIMEOUT_S > 0
    monkeypatch.setattr(TM, "BARRIER_TIMEOUT_S", 0.5)

    def fn(ins, coll):
        if coll.rank != 0:
            coll.psum(torch.ones(1))
        return coll.rank

    t0 = time.perf_counter()
    with pytest.raises(TM.MeshError):
        TM.run_shards(mesh, fn, (), ())
    assert time.perf_counter() - t0 < 5.0


def test_row_mesh_is_hashable_and_cuda_default_raises():
    a, b = TP.row_mesh(["cpu"] * 4), TP.row_mesh([torch.device("cpu")] * 4)
    assert a == b and hash(a) == hash(b) and a.size == 4
    assert a.shape == {"rows": 4} and a.axis_names == ("rows",)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TP.row_mesh()
        assert TP.default_mesh() is None


def test_default_mesh_spans_the_cards_unless_turned_off(monkeypatch):
    """On a host with four cards the session-default mesh is None: the
    port's spmd_auto_mesh is off (the reference's is on; the thread mesh
    over four H100s was slower than one card).  Turned on, it is one shard
    per card, as in the reference."""
    from monetdb_tpu_torch import config as TC
    from monetdb_tpu_torch.parallel import mitosis
    monkeypatch.setattr(mitosis, "_DEFAULT_MESH", [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert TC.get("spmd_auto_mesh") is False
    assert TP.default_mesh() is None and mitosis._DEFAULT_MESH == []
    TC.set("spmd_auto_mesh", True)
    try:
        mesh = TP.default_mesh()
        assert mesh == TP.row_mesh([torch.device("cuda", i)
                                    for i in range(4)])
        assert TP.default_mesh() is mesh and mitosis._DEFAULT_MESH == [mesh]
    finally:
        TC.reset("spmd_auto_mesh")


class _YieldingCounts(dict):
    """A launch-count dict that hands the GIL to another thread between
    reading a count and writing it back, so that an unguarded ``+= 1``
    loses counts."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counter_is_thread_safe(monkeypatch):
    """16 threads (more than the shards of a mesh, and than the cores
    here) x N counted launches (the counting path the wrapper takes after
    each kernel launch) add up to exactly 16N."""
    n, k = 1000, 16
    counts = _YieldingCounts(CK.LAUNCHES, seg_sum64=0)
    monkeypatch.setattr(CK, "LAUNCHES", counts)
    threads = [threading.Thread(
        target=lambda: [CK._launched("seg_sum64", 0) for _ in range(n)])
        for _ in range(k)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert counts["seg_sum64"] == k * n


# ---------------------------------------------------------------------------
# mitosis: the fused sharded steps at SF0.01 against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lineitem():
    return gen_tpch(0.01)["lineitem"]


def test_hash64_bits_equal_reference():
    rng = np.random.default_rng(11)
    keys = np.concatenate([
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 50_000,
                     dtype=np.int64),
        np.array([0, 1, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max],
                 np.int64)])
    got = TS.hash64(torch.from_numpy(keys)).numpy()
    want = np.asarray(RS.hash64(jnp.asarray(keys)))
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert got.min() >= 0 and got.max() < (1 << 62)


def test_sharded_q6_equals_reference(meshes, lineitem):
    tm, rm = meshes
    li = lineitem
    args = [(li["l_shipdate"], 0), (li["l_discount"], -1),
            (li["l_quantity"], 1 << 40),
            (li["l_extendedprice"].astype(np.int32), 0)]
    lo, hi = _days("1994-01-01"), _days("1995-01-01")
    scal = (np.int32(lo), np.int32(hi), np.int64(5), np.int64(7),
            np.int64(2400))
    got = TP.sharded_q6(tm)(*[TP.shard_array(a, tm, fill=f)
                              for a, f in args], *scal)
    want = RP.sharded_q6(rm)(*[RP.shard_array(a, rm, fill=f)
                               for a, f in args], *scal)
    assert got.dtype == torch.int64 and int(got) == int(want) > 0


def _q1_inputs(li):
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    rf_u, ls_u = sorted(set(rf.tolist())), sorted(set(ls.tolist()))
    code = (np.searchsorted(rf_u, rf) * len(ls_u)
            + np.searchsorted(ls_u, ls)).astype(np.int32)
    cols = [li[c] for c in ("l_shipdate", "l_quantity", "l_extendedprice",
                            "l_discount", "l_tax")]
    return code, cols, len(rf_u) * len(ls_u), \
        np.int32(_days("1998-12-01") - 90)


def test_sharded_q1_equals_reference(meshes, lineitem):
    """Both of the port's routes against the reference on int64 columns
    (its int32 product wraps at TPC-H sizes): lineitem's int64 columns
    take seg_sum64, int32 ones the q1_grouped_sums kernel's route."""
    tm, rm = meshes
    code, cols, domain, cutoff = _q1_inputs(lineitem)
    want = RP.sharded_q1(rm, domain=domain)(
        RP.shard_array(code, rm, fill=-1),
        *[RP.shard_array(np.asarray(c, np.int64), rm) for c in cols], cutoff)
    for dt in (np.int64, np.int32):
        got = TP.sharded_q1(tm, domain=domain)(
            TP.shard_array(code, tm, fill=-1),
            *[TP.shard_array(np.asarray(c, dt), tm) for c in cols], cutoff)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert np.array_equal(_np(g), np.asarray(w)), dt
        assert int(got[5].sum()) > 0


def test_q1_step_routes_int32_columns_to_the_fused_kernel(lineitem):
    """int32 columns take q1_grouped_sums (its plain version on the CPU),
    int64 ones the seg_sum64 route; both give the same partials."""
    code, cols, domain, cutoff = _q1_inputs(lineitem)
    t64 = [torch.from_numpy(np.asarray(c, np.int64)) for c in cols]
    t32 = [c.to(torch.int32) for c in t64]
    tc = torch.from_numpy(code)
    a = TK.q1_step(tc, *t64, int(cutoff), domain=domain)
    b = TK.q1_step(tc, *t32, int(cutoff), domain=domain)
    c = CK.q1_grouped_sums_plain(tc, *t32, int(cutoff), domain=domain)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(y, z)


def test_two_phase_sum_equals_reference(meshes):
    tm, rm = meshes
    rng = np.random.default_rng(5)
    n = 10_001                              # pads to a multiple of 8
    vals = rng.integers(-1 << 40, 1 << 40, n)
    keys = rng.integers(-1, 14, n)
    mask = rng.random(n) < 0.8
    got = TP.two_phase_sum(tm, TP.shard_array(vals, tm),
                           TP.shard_array(keys, tm),
                           TP.shard_array(mask, tm, fill=False), 12)
    want = RP.two_phase_sum(rm, RP.shard_array(vals, rm),
                            RP.shard_array(keys, rm),
                            RP.shard_array(mask, rm, fill=False), 12)
    assert np.array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# shuffle: the exchange and what is built on it, against the reference
# ---------------------------------------------------------------------------


def _jitted(fn):
    """The reference's mesh function ``fn(mesh, ...)`` traced under one
    ``jax.jit``, as its fragment runs ``jit(shard_map(...))``: its
    shard_map bodies compile once instead of dispatching op by op, which
    costs seconds a call on the virtual devices.  Integer arguments (lane
    capacities) and keywords stay static; arrays and lists of them are
    traced."""
    def call(mesh, *args, **kw):
        def body(*dyn):
            it = iter(dyn)
            return fn(mesh, *[a if isinstance(a, int) else next(it)
                              for a in args], **kw)
        return jax.jit(body)(*[a for a in args if not isinstance(a, int)])
    return call


def _both(mesh_pair, arrays, fills):
    tm, rm = mesh_pair
    return ([TP.shard_array(a, tm, fill=f) for a, f in zip(arrays, fills)],
            [RP.shard_array(a, rm, fill=f) for a, f in zip(arrays, fills)])


def _uniform(n=1 << 13, seed=21):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3000, n).astype(np.int64),
            rng.integers(-1000, 1000, n).astype(np.int64),
            rng.random(n) < 0.9)


def _zipf(n=1 << 13, seed=22):
    rng = np.random.default_rng(seed)
    return (np.minimum(rng.zipf(2.0, n), 50_000).astype(np.int64),
            rng.integers(0, 100, n).astype(np.int64),
            np.ones(n, bool))


@pytest.mark.parametrize("data", [_uniform, _zipf])
def test_lane_counts_equal_reference(meshes, data):
    k, _v, lv = data()
    (tk, tl), (rk, rl) = _both(meshes, [k, lv], [0, False])
    got = TS.lane_counts(meshes[0], tk, tl)
    want = RS.lane_counts(meshes[1], rk, rl)
    assert got.shape == (D, D) and np.array_equal(got, np.asarray(want))
    assert got.sum() == lv.sum()


def test_shuffle_equals_reference(meshes):
    k, v, lv = _uniform()
    (tk, tv, tl), (rk, rv, rl) = _both(meshes, [k, v, lv], [0, 0, False])
    cap = 512
    gk, (gv,), gl = TS.shuffle(meshes[0], tk, [tv], tl, cap)
    wk, (wv,), wl = _jitted(RS.shuffle)(meshes[1], rk, [rv], rl, cap)
    for g, w in ((gk, wk), (gv, wv), (gl, wl)):
        assert np.array_equal(_np(g), np.asarray(w))
    # every live row arrives once, at the shard that owns its key
    assert int(gl.sum()) == int(lv.sum())
    owner = (TS.hash64(gk) % D).numpy()
    shard = np.repeat(np.arange(D), D * cap)
    assert np.array_equal(owner[_np(gl)], shard[_np(gl)])


def _group_sums(k, s, lv):
    k, s, lv = _np(k), _np(s), _np(lv).astype(bool)
    return dict(zip(k[lv].tolist(), s[lv].tolist()))


def test_dist_group_sum_equals_reference(meshes):
    """Without the pre-combiner against the reference; with it (the path
    dist_group_sum_auto takes on skewed keys, compared with the reference
    below) against numpy."""
    k, v, lv = _uniform()
    (tk, tv, tl), (rk, rv, rl) = _both(meshes, [k, v, lv], [0, 0, False])
    got = TS.dist_group_sum(meshes[0], tk, tv, tl, 512)
    want = _jitted(RS.dist_group_sum)(meshes[1], rk, rv, rl, 512)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))
    exp = {}
    for key, val in zip(k[lv].tolist(), v[lv].tolist()):
        exp[key] = exp.get(key, 0) + val
    assert _group_sums(*got) == exp
    pre = TS.dist_group_sum(meshes[0], tk, tv, tl, 512, pre_combine=True)
    assert _group_sums(*pre) == exp


def test_dist_group_sum_auto_zipf_equals_reference(meshes, monkeypatch):
    k, v, lv = _zipf()
    for name in ("_pre_combine", "dist_group_sum"):
        monkeypatch.setattr(RS, name, _jitted(getattr(RS, name)))
    (tk, tv, tl), (rk, rv, rl) = _both(meshes, [k, v, lv], [0, 0, False])
    *got, ginfo = TS.dist_group_sum_auto(meshes[0], tk, tv, tl)
    *want, winfo = RS.dist_group_sum_auto(meshes[1], rk, rv, rl)
    assert ginfo == winfo and ginfo["skewed"]
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))
    exp = {}
    for key, val in zip(k.tolist(), v.tolist()):
        exp[key] = exp.get(key, 0) + val
    assert _group_sums(*got) == exp


def test_dist_fk_join_equals_reference(meshes):
    rng = np.random.default_rng(31)
    n = 1 << 12
    lk = rng.integers(0, 1500, n).astype(np.int64)   # some miss the build
    lvv = rng.integers(0, 1 << 30, n).astype(np.int64)
    rk = np.arange(1024, dtype=np.int64)
    rv = rk * 100 + 7
    (tlk, tlv, tll), (rlk, rlv, rll) = _both(
        meshes, [lk, lvv, np.ones(n, bool)], [0, 0, False])
    (trk, trv, trl), (rrk, rrv, rrl) = _both(
        meshes, [rk, rv, np.ones(1024, bool)], [0, 0, False])
    cap = 1024
    gk, gcols, ghit = TS.dist_fk_join(meshes[0], tlk, [tlv], tll,
                                      trk, [trv], trl, cap)
    wk, wcols, whit = _jitted(RS.dist_fk_join)(
        meshes[1], rlk, [rlv], rll, rrk, [rrv], rrl, cap)
    for g, w in zip([gk, *gcols, ghit], [wk, *wcols, whit]):
        assert np.array_equal(_np(g), np.asarray(w))
    hit = _np(ghit)
    assert hit.sum() == (lk < 1024).sum()
    assert np.array_equal(_np(gcols[1])[hit], _np(gk)[hit] * 100 + 7)
