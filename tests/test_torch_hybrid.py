"""The port's hybrid row mesh (monetdb_tpu_torch/parallel/dist.py with
several shards a process): two gloo processes of four CPU shards each, one
global mesh of eight - the shape of the reference's tests/test_multihost.py
(2 processes x 4 devices in one ``jax.distributed`` job, which stays
opt-in) - against the port's thread mesh ``row_mesh(["cpu"] * 8)``, the
reference package's mesh over conftest's eight virtual devices and numpy.

Each process runs ``bench/mesh_procs.py``'s rank program (every primitive
of the parallel package once, each shard's piece checked against numpy in
the process) over 8 x 4096 rows, 500 keys and 100 dead rows from seed 42,
then test_multihost.py's own data and calls (``dist_group_sum`` and
``shuffle`` at lane capacity 4096), then the collectives' own cases, and
saves every shard's outputs.  Global shard g = 4 p + l (local shard l of
process p) must be bit-equal to shard g of the thread mesh's outputs and
equal to shard g of the reference's (floats to rel 1e-12).
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from monetdb_tpu import parallel as RP  # noqa: E402
from monetdb_tpu.parallel import shuffle as RS  # noqa: E402
from monetdb_tpu_torch import parallel as TP  # noqa: E402
from monetdb_tpu_torch.bench import mesh_procs as MP  # noqa: E402
from monetdb_tpu_torch.parallel import dist as TD  # noqa: E402
from monetdb_tpu_torch.parallel import mesh as TM  # noqa: E402
from monetdb_tpu_torch.parallel import shuffle as TS  # noqa: E402

from test_torch_dist import CASES, _jitted  # noqa: E402

PROCS = 2
LOCAL = 4
D = PROCS * LOCAL
ROWS_LOG2 = 15                          # 8 x 4096 rows
KEYS = 500
DEAD = 100
FUSED_ROWS = 8 * 4096
SEED = 42
LANE_CAP = 4096                         # test_multihost.py's

#: tests/test_multihost.py's global arrays, the same in every process
MULTIHOST = r'''
def multihost_data():
    n = 8 * 4096
    rng = np.random.default_rng(42)
    keys = rng.integers(0, 500, n).astype(np.int64)
    vals = rng.integers(0, 1000, n).astype(np.int64)
    live = np.ones(n, bool)
    live[rng.integers(0, n, 100)] = False
    return keys, vals, live
'''
exec(CASES)
exec(MULTIHOST)

#: a process: mesh_procs's rank program, test_multihost.py's calls, then
#: the collectives' own cases
WORKER = r"""
import sys
import numpy as np
import torch
from monetdb_tpu_torch.bench import mesh_procs as MP
from monetdb_tpu_torch.parallel import dist as TD
from monetdb_tpu_torch.parallel import mesh as TM
from monetdb_tpu_torch.parallel import shard_array
from monetdb_tpu_torch.parallel import shuffle as SH
D = 8
""" + CASES + MULTIHOST + r"""
args = MP._args(sys.argv[1:])
mesh = TD.initialize(args.addr, args.ranks, args.rank,
                     devices=args.device.split(","), timeout=60)
assert TD.process_index() == args.rank and TD.process_count() == args.ranks
MP.rank_run(mesh, args)
keys, vals, live = multihost_data()
gk, gv = shard_array(keys, mesh), shard_array(vals, mesh)
gl = shard_array(live, mesh, fill=False)
k2, s2, l2 = SH.dist_group_sum(mesh, gk, gv, gl, lane_cap=4096)
k3, (v3,), l3 = SH.shuffle(mesh, gk, [gv], gl, lane_cap=4096)
np.savez(f"{args.out}/multihost{args.rank}.npz",
         **{k: v.numpy() for k, v in dict(k2=k2, s2=s2, l2=l2, k3=k3, v3=v3,
                                          l3=l3).items()})
s0 = dict(TM.STATS)
out = TM.run_shards(mesh, collective_cases, (), ())
assert len(out) == mesh.local
stats = [TM.STATS[k] - s0[k] for k in ("calls", "collectives", "bytes")]
for j, g in enumerate(mesh.shards):
    np.savez(f"{args.out}/coll{g}.npz", **out[j], stats=np.array(stats))
mesh.barrier()
TD.shutdown()
"""


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two gloo processes of four CPU shards each, run once: every global
    shard's saved outputs, and each process's test_multihost.py outputs."""
    out = str(tmp_path_factory.mktemp("hybrid"))
    addr = f"127.0.0.1:{MP.free_port()}"
    argvs = [[sys.executable, "-c", WORKER] + MP.rank_argv(
        p, PROCS, addr, ",".join(["cpu"] * LOCAL), "gloo", out, ROWS_LOG2,
        FUSED_ROWS, KEYS, SEED, DEAD, warm=0, timeout=60, save=True)[3:]
        for p in range(PROCS)]
    res = MP.run_ranks(argvs, wait_s=240)
    for p, (rc, _out, err) in enumerate(res):
        assert rc == 0, f"process {p}:\n{err[-3000:]}"
    got = []
    for g in range(D):
        with open(f"{out}/rank{g}.json") as f:
            rep = json.load(f)
        prims = np.load(f"{out}/rank{g}.npz")
        coll = np.load(f"{out}/coll{g}.npz")
        got.append({"rep": rep, "coll": {k: coll[k] for k in coll.files},
                    "prims": {k: prims[k] for k in prims.files}})
    multi = []
    for p in range(PROCS):
        m = np.load(f"{out}/multihost{p}.npz")
        multi.append({k: m[k] for k in m.files})
    return got, multi


@pytest.fixture(scope="module")
def inputs():
    return MP.make_inputs(1 << ROWS_LOG2, FUSED_ROWS, KEYS, SEED, DEAD,
                          floats=True)


@pytest.fixture(scope="module")
def thread_outputs(inputs):
    """The thread mesh's per-shard outputs of the same primitives, and of
    test_multihost.py's calls (whole row-sharded tensors)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = TP.row_mesh(["cpu"] * D)
        _p, caps, outs, stats = MP.drive(mesh, inputs, floats=True)
        keys, vals, live = multihost_data()
        gk, gv = TP.shard_array(keys, mesh), TP.shard_array(vals, mesh)
        gl = TP.shard_array(live, mesh, fill=False)
        k2, s2, l2 = TS.dist_group_sum(mesh, gk, gv, gl, LANE_CAP)
        k3, (v3,), l3 = TS.shuffle(mesh, gk, [gv], gl, LANE_CAP)
        multi = {k: v.numpy() for k, v in dict(
            k2=k2, s2=s2, l2=l2, k3=k3, v3=v3, l3=l3).items()}
    finally:
        torch.set_num_threads(saved)
    return caps, outs, stats, multi


def _arrays(shard: dict, name: str) -> list:
    prims = shard["prims"]
    n = sum(1 for k in prims if k.rsplit(".", 1)[0] == name)
    assert n, name
    return [prims[f"{name}.{i}"] for i in range(n)]


def _names():
    return [n for n, _k, _f in MP.primitives(True)]


def _pieces(whole: np.ndarray) -> list:
    """The D shard pieces of a row-sharded array."""
    return list(whole.reshape(D, -1))


def test_every_primitive_ran_on_every_shard(shards):
    got, _multi = shards
    for g, shard in enumerate(got):
        rep = shard["rep"]
        p = g // LOCAL
        assert rep["rank"] == g and rep["process"] == p
        assert rep["mesh"] == (f"ProcessMesh(rank {p} of {PROCS}, shards "
                               f"{p * LOCAL}-{p * LOCAL + LOCAL - 1} of {D} "
                               f"on cpu x{LOCAL}, gloo)")
        assert sorted(rep["digests"]) == sorted(_names())


@pytest.mark.parametrize("name", _names())
def test_shard_equals_thread_mesh_shard(shards, thread_outputs, name):
    """Global shard g's outputs bit-equal to shard g of
    row_mesh(["cpu"] * 8), with the same collectives and bytes a shard."""
    caps, outs, stats, _m = thread_outputs
    for g, shard in enumerate(shards[0]):
        got = _arrays(shard, name)
        want = outs[name][g]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, g)
        assert shard["rep"]["caps"] == caps
        assert shard["rep"]["stats"][name] == stats[name]


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def reference(inputs, thread_outputs, monkeypatch_module):
    """The reference package's outputs over jax.devices()[:8], per shard,
    and its test_multihost.py calls (whole row-sharded arrays)."""
    assert len(jax.devices()) >= D
    rm = RP.row_mesh(jax.devices()[:D])
    caps = thread_outputs[0]
    inp = inputs
    for name in ("_pre_combine", "dist_group_sum"):
        monkeypatch_module.setattr(RS, name, _jitted(getattr(RS, name)))

    def sh(a, fill=0):
        return RP.shard_array(a, rm, fill=fill)

    live, vals = sh(inp["live"], False), sh(inp["vals"])
    q64 = [c.astype(np.int64) for c in inp["q"]]
    out = {
        "two_phase_sum": (_jitted(RP.two_phase_sum)(
            rm, vals, sh(inp["small"]), live, MP.SMALL_DOMAIN),),
        "two_phase_sum_f64": (_jitted(RP.two_phase_sum)(
            rm, sh(inp["fvals"]), sh(inp["small"]), live,
            MP.SMALL_DOMAIN),)}
    for tag, q in (("32", inp["q"]), ("64", q64)):
        out["sharded_q6_i" + tag] = (RP.sharded_q6(rm)(
            sh(q[1]), sh(q[4], -1), sh(q[2], 1 << 30), sh(q[3]),
            *[np.asarray(x, q[1].dtype if i < 2 else np.int64)
              for i, x in enumerate(MP.Q6_ARGS)]),)
        # the reference's int32 Q1 product wraps: it takes int64 columns
        out["sharded_q1_i" + tag] = tuple(RP.sharded_q1(
            rm, domain=MP.Q1_DOMAIN)(sh(q64[0], -1),
                                     *[sh(c) for c in q64[1:]],
                                     np.int32(MP.Q1_CUTOFF)))
    for keys in ("uniform", "zipf"):
        k = sh(inp[keys])
        out["lane_counts_" + keys] = (RS.lane_counts(rm, k, live),)
        gk, (gv,), gl = _jitted(RS.shuffle)(rm, k, [vals], live, caps[keys])
        out["shuffle_" + keys] = (gk, gv, gl)
        out["dist_group_sum_" + keys] = _jitted(RS.dist_group_sum)(
            rm, k, vals, live, caps[keys])
        *res, info = RS.dist_group_sum_auto(rm, k, vals, live)
        out["dist_group_sum_auto_" + keys] = tuple(res) + (np.array(
            [int(info["skewed"]), info["lane_cap"], info["max_lane"]]),)
    build = inp["build"]
    gk, gcols, hit = _jitted(RS.dist_fk_join)(
        rm, sh(inp["probe"]), [vals], live, sh(build),
        [sh(build * 1000 + 7)], sh(np.ones(len(build), bool), False),
        caps["join"])
    out["dist_fk_join"] = (gk, *gcols, hit)
    kinds = {n: k for n, k, _f in MP.primitives(True)}
    per = {}
    for name, arrs in out.items():
        arrs = [np.asarray(a) for a in arrs]
        if kinds[name] == "replicated":
            per[name] = [arrs] * D
        else:
            split = len(arrs) - (kinds[name] == "sharded+info")
            per[name] = [[a.reshape(D, -1)[g] for a in arrs[:split]]
                         + arrs[split:] for g in range(D)]
    keys, mvals, mlive = multihost_data()
    mk, mv, ml = sh(keys), sh(mvals), sh(mlive, False)
    k2, s2, l2 = _jitted(RS.dist_group_sum)(rm, mk, mv, ml, LANE_CAP)
    k3, (v3,), l3 = _jitted(RS.shuffle)(rm, mk, [mv], ml, LANE_CAP)
    multi = {k: np.asarray(v) for k, v in dict(
        k2=k2, s2=s2, l2=l2, k3=k3, v3=v3, l3=l3).items()}
    return per, multi


@pytest.mark.parametrize("name", _names())
def test_shard_equals_reference_shard(shards, reference, name):
    """Global shard g's outputs equal shard g of the reference package's
    over eight devices (floats to rel 1e-12)."""
    per, _multi = reference
    for g, shard in enumerate(shards[0]):
        got = _arrays(shard, name)
        want = per[name][g]
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
            else:
                assert np.array_equal(a, b), (name, g)


def test_multihost_calls_equal_thread_mesh_and_reference(shards,
                                                         thread_outputs,
                                                         reference):
    """test_multihost.py's dist_group_sum and shuffle at lane capacity
    4096: every global shard's piece bit-equal to the thread mesh's shard
    and equal to the reference's."""
    _got, multi = shards
    thread, ref = thread_outputs[3], reference[1]
    for k in ("k2", "s2", "l2", "k3", "v3", "l3"):
        for g in range(D):
            mine = multi[g // LOCAL][k].reshape(LOCAL, -1)[g % LOCAL]
            assert np.array_equal(mine, _pieces(thread[k])[g]), (k, g)
            assert np.array_equal(mine, _pieces(ref[k])[g]), (k, g)


def test_multihost_oracle_holds(shards):
    """tests/test_multihost.py's checks over the two processes: each of
    the 500 keys is owned by exactly one shard and its sum is exact, and
    the shuffle delivers live rows (every one, once)."""
    _got, multi = shards
    keys, vals, live = multihost_data()
    oracle = {}
    for k, v in zip(keys[live].tolist(), vals[live].tolist()):
        oracle[k] = oracle.get(k, 0) + v
    owners = {}
    for p, m in enumerate(multi):
        for j, (k, s, lv) in enumerate(zip(*(m[x].reshape(LOCAL, -1)
                                             for x in ("k2", "s2", "l2")))):
            for key, total in zip(k[lv].tolist(), s[lv].tolist()):
                assert key not in owners, f"key {key} on two shards"
                owners[key] = p * LOCAL + j
                assert total == oracle[key]
    assert len(owners) == len(oracle) == KEYS
    arrived = sum(int(m["l3"].sum()) for m in multi)
    assert 0 < arrived == int(live.sum())


def test_collectives_match_thread_mesh_and_numpy(shards):
    """int64, float64, bool, 0-d and lists: every shard's results
    bit-equal to the thread mesh's shard and to numpy (floats summed in
    rank order)."""
    got_all, _m = shards
    thread = TM.run_shards(TP.row_mesh(["cpu"] * D), collective_cases, (),
                           ())
    data = [_per_rank(g) for g in range(D)]
    ints = np.stack([x["i"] for x in data])
    floats = np.stack([x["f"] for x in data])
    f_sum = floats[0].copy()
    for g in range(1, D):
        f_sum = f_sum + floats[g]
    for g, shard in enumerate(got_all):
        got = shard["coll"]
        assert int(got["rank"]) == g
        for k, w in thread[g].items():
            if k.startswith("unequal"):     # the thread mesh takes any size
                continue
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
        assert np.array_equal(got["psum_i"], ints.sum(0))
        assert np.array_equal(got["psum_f"], f_sum)          # bit-equal
        assert np.array_equal(got["pmax"], ints.max(0))
        assert np.array_equal(got["pmin"], floats.min(0))
        assert np.array_equal(got["gather"], ints.reshape(-1))
        assert np.array_equal(got["gather0"], ints[:, 0])
        assert np.array_equal(got["gather_b"],
                              np.concatenate([x["b"] for x in data]))
        assert np.array_equal(got["a2a"], np.concatenate(
            [data[s]["a2a"][3 * g:3 * g + 3] for s in range(D)]))
        assert np.array_equal(got["a2a_list1"], np.concatenate(
            [data[s]["b"][2 * g:2 * g + 2] for s in range(D)]))
        assert np.array_equal(got["after"], np.full(2, D))


def test_unequal_all_gather_raises_on_every_shard(shards):
    """Pieces of different lengths raise MeshError naming the two global
    shards' shapes on every shard of both processes, and the group goes
    on."""
    for shard in shards[0]:
        got = shard["coll"]
        assert int(got["unequal"]) == 1
        msg = bytes(got["unequal_msg"]).decode()
        assert "rank 0 [('int64', (1,))]" in msg
        assert "rank 1 [('int64', (2,))]" in msg
        assert np.array_equal(got["after"], np.full(2, D))


def test_stats_count_this_process(shards):
    """STATS of a process count its own shards: one call, 11 collectives
    of one shard (the failed all_gather's included), the bytes all four of
    its shards handed over."""
    sent = (16 * 8 * 2 + D * 3 * 2 * 8 + D * 2 + 8 + 16 * 8 + 16 * 8
            + 16 * 8 + 8 + 16 + D * 3 * 2 * 8 + 16)
    for g, shard in enumerate(shards[0]):
        p = g // LOCAL
        calls, colls, nbytes = shard["coll"]["stats"].tolist()
        assert (calls, colls) == (1, 11)
        assert nbytes == sum(sent + 8 * (r + 1)
                             for r in range(p * LOCAL, (p + 1) * LOCAL))


def test_failing_local_shard_ends_both_processes():
    """The last local shard of the last process raises after the first
    collective: both processes exit non-zero, well inside 30 s, under a
    5 s timeout."""
    t0 = time.monotonic()
    took = MP.fail_drill(["cpu"] * D, "gloo", 5.0, local=LOCAL)
    assert took < 30 and time.monotonic() - t0 < 30, took


def test_hybrid_mesh_api():
    """A hybrid mesh without joining a group: its size, shards, shape,
    hash and repr; the one-shard-a-process mesh keeps its own."""
    a = TD.ProcessMesh(2, 1, ["cpu"] * 4, "gloo")
    b = TD.ProcessMesh(2, 1, [torch.device("cpu")] * 4, "gloo")
    assert a == b and hash(a) == hash(b)
    assert a != TD.ProcessMesh(2, 0, ["cpu"] * 4, "gloo")
    assert a != TD.ProcessMesh(2, 1, ["cpu"] * 2, "gloo")
    assert a.size == 8 and a.local == 4 and a.processes == 2
    assert a.shape == {"rows": 8} and list(a.shards) == [4, 5, 6, 7]
    assert repr(a) == "ProcessMesh(rank 1 of 2, shards 4-7 of 8 on cpu x4, " \
                      "gloo)"
    staged = TD.ProcessMesh(2, 0, ["cuda:0", "cuda:1"], "gloo")
    assert staged.staged and repr(staged).endswith(
        "on cuda:0, cuda:1, gloo, host-staged)")
    one = a.per_process()
    assert one.size == 2 and one.local == 1 and one.rank == 1
    assert repr(one) == "ProcessMesh(rank 1 of 2, cpu, gloo)"
    assert TM.home_device(a) == torch.device("cpu")
    with pytest.raises(ValueError, match="not both"):
        TD.initialize("127.0.0.1:1", 2, 0, device="cpu", devices=["cpu"])
    with pytest.raises(ValueError):
        TD.initialize("127.0.0.1:1", 2, 0, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        TD.initialize("127.0.0.1:1", 2, 0, devices=["cpu"] * 2,
                      backend="nccl")


def test_shard_array_gives_a_process_its_shards_rows():
    """On a hybrid mesh shard_array returns the pieces of the process's
    shards end to end; the two processes' pieces are the thread mesh's
    row-sharded array."""
    arr = np.arange(21)
    pieces = [TP.shard_array(arr, TD.ProcessMesh(2, p, ["cpu"] * 4,
                                                 "gloo"), fill=-1)
              for p in range(2)]
    whole = TP.shard_array(arr, TP.row_mesh(["cpu"] * 8), fill=-1)
    assert [len(p) for p in pieces] == [12, 12]
    assert pieces[0].tolist() == list(range(12))
    assert torch.equal(torch.cat(pieces), whole)


def test_engine_and_session_refuse_a_hybrid_mesh():
    """SQL runs over a thread mesh only (the SPMD path reads every shard's
    outputs in one process)."""
    from monetdb_tpu_torch.engine import Engine
    from monetdb_tpu_torch.session import Session
    from monetdb_tpu_torch.storage import Database
    from monetdb_tpu_torch.table import Catalog
    mesh = TD.ProcessMesh(2, 0, ["cpu"] * 4, "gloo")
    with pytest.raises(TypeError, match="thread mesh"):
        Engine(Catalog(), mesh=mesh)
    with pytest.raises(TypeError, match="thread mesh"):
        Session(Database(device="cpu"), mesh=mesh)
