"""The port's process mesh (monetdb_tpu_torch/parallel/dist.py): four gloo
ranks on the CPU, each a process of its own, against the port's thread mesh
``row_mesh(["cpu"] * 4)``, the reference package's mesh over four of
conftest's virtual devices and numpy - the analog of the reference's
tests/test_multihost.py (which stays opt-in).

The ranks run ``bench/mesh_procs.py``'s rank program (every primitive of
the parallel package once, each checked against numpy in the rank) over
4 x 4096 rows, 500 keys and test_multihost.py's 100 dead rows, then the
collectives' own cases, and save every output.  Rank r's outputs must be
bit-equal to shard r of the thread mesh's and equal to shard r of the
reference's (floats to rel 1e-12).
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

D = 4
ROWS_LOG2 = 14                          # 4 x 4096 rows
KEYS = 500
DEAD = 100                              # test_multihost.py's dead rows
FUSED_ROWS = 4 * 4096
SEED = 42

#: the collectives' own cases: run by every rank (below) and by the thread
#: mesh here (defined from the same source); imports torch, numpy, TM, D
CASES = r'''
def _per_rank(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {"i": rng.integers(-1 << 40, 1 << 40, 16),
            "f": rng.standard_normal(16),
            "b": rng.random(16) < 0.5,
            "a2a": rng.integers(0, 1000, (D * 3, 2))}


def collective_cases(ins, coll) -> dict:
    """Every collective on int64, float64, bool, 0-d tensors and lists;
    an all_gather of unequal sizes (must raise MeshError on every shard),
    then one more collective."""
    d = _per_rank(coll.rank)
    i, f = torch.from_numpy(d["i"]), torch.from_numpy(d["f"])
    b = torch.from_numpy(d["b"])
    a2a = torch.from_numpy(d["a2a"])
    s_i, s_f = coll.psum([i, f])
    x, y = coll.all_to_all((a2a, b[:D * 2]))
    out = {"rank": torch.tensor(coll.rank), "psum_i": s_i, "psum_f": s_f,
           "psum_0d": coll.psum(f[0]), "pmax": coll.pmax(i),
           "pmin": coll.pmin(f), "gather": coll.all_gather(i),
           "gather0": coll.all_gather(i[0]), "gather_b": coll.all_gather(b),
           "a2a": coll.all_to_all(a2a), "a2a_list0": x, "a2a_list1": y}
    try:
        coll.all_gather(torch.arange(coll.rank + 1))
        out["unequal"] = torch.tensor(0)
    except TM.MeshError as ex:
        out["unequal"] = torch.tensor(1)
        out["unequal_msg"] = torch.frombuffer(bytearray(str(ex).encode()),
                                              dtype=torch.uint8)
    out["after"] = coll.psum(torch.ones(2, dtype=torch.int64))
    return {k: v.numpy() for k, v in out.items()}
'''
exec(CASES)


#: a rank: mesh_procs's rank program, then the collectives' own cases
WORKER = r"""
import sys
import numpy as np
import torch
from monetdb_tpu_torch.bench import mesh_procs as MP
from monetdb_tpu_torch.parallel import dist as TD
from monetdb_tpu_torch.parallel import mesh as TM
D = 4
""" + CASES + r"""
args = MP._args(sys.argv[1:])
mesh = TD.initialize(args.addr, args.ranks, args.rank, device="cpu",
                     timeout=60)
assert TD.process_index() == args.rank and TD.process_count() == args.ranks
MP.rank_run(mesh, args)
s0 = dict(TM.STATS)
out = TM.run_shards(mesh, collective_cases, (), ())
assert len(out) == 1
stats = {k: TM.STATS[k] - s0[k] for k in s0}
np.savez(f"{args.out}/coll{args.rank}.npz", **out[0],
         stats=np.array([stats["calls"], stats["collectives"],
                         stats["bytes"]]))
mesh.barrier()
TD.shutdown()
"""

#: a rank that raises after the first collective while the others go on
FAILING = r"""
import sys
import torch
from monetdb_tpu_torch.parallel import dist as TD
from monetdb_tpu_torch.parallel import mesh as TM
rank = int(sys.argv[2])
mesh = TD.initialize(sys.argv[1], 4, rank, device="cpu", timeout=5)

def fn(ins, coll):
    coll.psum(torch.ones(3))
    if coll.rank == 2:
        raise ZeroDivisionError("rank 2")
    return coll.psum(torch.ones(3))

TM.run_shards(mesh, fn, (), ())
TD.shutdown()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four gloo ranks on the CPU, run once: their saved outputs."""
    out = str(tmp_path_factory.mktemp("ranks"))
    addr = f"127.0.0.1:{MP.free_port()}"
    argvs = [[sys.executable, "-c", WORKER] + MP.rank_argv(
        r, D, addr, "cpu", "gloo", out, ROWS_LOG2, FUSED_ROWS, KEYS, SEED,
        DEAD, warm=0, timeout=60, save=True)[3:] for r in range(D)]
    res = MP.run_ranks(argvs, wait_s=240)
    for r, (rc, _out, err) in enumerate(res):
        assert rc == 0, f"rank {r}:\n{err[-3000:]}"
    got = []
    for r in range(D):
        with open(f"{out}/rank{r}.json") as f:
            rep = json.load(f)
        prims = np.load(f"{out}/rank{r}.npz")
        coll = np.load(f"{out}/coll{r}.npz")
        got.append({"rep": rep, "coll": {k: coll[k] for k in coll.files},
                    "prims": {k: prims[k] for k in prims.files}})
    return got


@pytest.fixture(scope="module")
def inputs():
    return MP.make_inputs(1 << ROWS_LOG2, FUSED_ROWS, KEYS, SEED, DEAD,
                          floats=True)


@pytest.fixture(scope="module")
def thread_outputs(inputs):
    """The thread mesh's per-shard outputs of the same primitives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _p, caps, outs, stats = MP.drive(TP.row_mesh(["cpu"] * D), inputs,
                                         floats=True)
    finally:
        torch.set_num_threads(saved)
    return caps, outs, stats


def _rank_arrays(rank: dict, name: str) -> list:
    prims = rank["prims"]
    n = sum(1 for k in prims if k.rsplit(".", 1)[0] == name)
    assert n, name
    return [prims[f"{name}.{i}"] for i in range(n)]


def _names():
    return [n for n, _k, _f in MP.primitives(True)]


def test_every_primitive_ran_on_every_rank(ranks):
    for r, rank in enumerate(ranks):
        rep = rank["rep"]
        assert rep["rank"] == r
        assert rep["mesh"] == f"ProcessMesh(rank {r} of {D}, cpu, gloo)"
        assert sorted(rep["digests"]) == sorted(_names())


@pytest.mark.parametrize("name", _names())
def test_rank_equals_thread_mesh_shard(ranks, thread_outputs, name):
    """Rank r's outputs bit-equal to shard r of row_mesh(["cpu"] * 4), with
    the same collectives and bytes a shard."""
    caps, outs, stats = thread_outputs
    for r, rank in enumerate(ranks):
        got = _rank_arrays(rank, name)
        want = outs[name][r]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), (name, r)
        assert rank["rep"]["caps"] == caps
        assert rank["rep"]["stats"][name] == stats[name]


def _jitted(fn):
    """The reference's mesh function traced under one ``jax.jit`` (its
    shard_map bodies compile once instead of dispatching op by op; the
    same helper as tests/test_torch_parallel.py).  Integer arguments stay
    static."""
    def call(mesh, *args, **kw):
        def body(*dyn):
            it = iter(dyn)
            return fn(mesh, *[a if isinstance(a, int) else next(it)
                              for a in args], **kw)
        return jax.jit(body)(*[a for a in args if not isinstance(a, int)])
    return call


@pytest.fixture(scope="module")
def reference(inputs, thread_outputs, monkeypatch_module):
    """The reference package's outputs over jax.devices()[:4], per shard."""
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
    q32 = inp["q"]
    out = {
        "two_phase_sum": (_jitted(RP.two_phase_sum)(
            rm, vals, sh(inp["small"]), live, MP.SMALL_DOMAIN),),
        "two_phase_sum_f64": (_jitted(RP.two_phase_sum)(
            rm, sh(inp["fvals"]), sh(inp["small"]), live,
            MP.SMALL_DOMAIN),)}
    for tag, q in (("32", q32), ("64", q64)):
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
            per[name] = [[a.reshape(D, -1)[r] for a in arrs[:split]]
                         + arrs[split:] for r in range(D)]
    return per


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("name", _names())
def test_rank_equals_reference_shard(ranks, reference, name):
    """Rank r's outputs equal shard r of the reference package's (floats
    to rel 1e-12)."""
    for r, rank in enumerate(ranks):
        got = _rank_arrays(rank, name)
        want = reference[name][r]
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
            else:
                assert np.array_equal(g, w), (name, r)


def test_multihost_oracle_holds(ranks, inputs):
    """tests/test_multihost.py's checks over the four ranks: each of the
    500 keys is owned by exactly one rank and its sum is exact, and every
    live row arrives once through the shuffle."""
    live, keys, vals = inputs["live"], inputs["uniform"], inputs["vals"]
    oracle = {}
    for k, v in zip(keys[live].tolist(), vals[live].tolist()):
        oracle[k] = oracle.get(k, 0) + v
    owners = {}
    for r, rank in enumerate(ranks):
        k, s, lv = _rank_arrays(rank, "dist_group_sum_uniform")
        for key, total in zip(k[lv].tolist(), s[lv].tolist()):
            assert key not in owners, f"key {key} on ranks {owners[key]}, {r}"
            owners[key] = r
            assert total == oracle[key]
    assert len(owners) == len(oracle) == KEYS
    arrived = sum(int(_rank_arrays(rank, "shuffle_uniform")[2].sum())
                  for rank in ranks)
    assert arrived == int(live.sum())


def test_collectives_match_thread_mesh_and_numpy(ranks):
    """int64, float64, bool, 0-d and lists: every rank's results bit-equal
    to the thread mesh's shard and to numpy (floats summed in rank
    order)."""
    thread = TM.run_shards(TP.row_mesh(["cpu"] * D), collective_cases, (),
                           ())
    data = [_per_rank(r) for r in range(D)]
    ints = np.stack([x["i"] for x in data])
    floats = np.stack([x["f"] for x in data])
    f_sum = floats[0].copy()
    for r in range(1, D):
        f_sum = f_sum + floats[r]
    for r, rank in enumerate(ranks):
        got = rank["coll"]
        assert int(got["rank"]) == r
        for k, w in thread[r].items():
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
            [data[s]["a2a"][3 * r:3 * r + 3] for s in range(D)]))
        assert np.array_equal(got["a2a_list1"], np.concatenate(
            [data[s]["b"][2 * r:2 * r + 2] for s in range(D)]))
        assert np.array_equal(got["after"], np.full(2, D))


def test_unequal_all_gather_raises_on_every_rank(ranks):
    """Pieces of different lengths raise MeshError naming both shapes on
    every rank (NCCL would wait forever), and the group goes on."""
    for rank in ranks:
        got = rank["coll"]
        assert int(got["unequal"]) == 1
        msg = bytes(got["unequal_msg"]).decode()
        assert "rank 0 [('int64', (1,))]" in msg
        assert "rank 1 [('int64', (2,))]" in msg
        assert np.array_equal(got["after"], np.full(2, D))


def test_stats_count_this_process(ranks):
    """STATS of a rank count its own calls, collectives and bytes: one
    call, 11 collectives (the failed all_gather's included)."""
    sent = (16 * 8 * 2 + D * 3 * 2 * 8 + D * 2 + 8 + 16 * 8 + 16 * 8
            + 16 * 8 + 8 + 16 + D * 3 * 2 * 8 + 16)
    for r, rank in enumerate(ranks):
        calls, colls, nbytes = rank["coll"]["stats"].tolist()
        assert (calls, colls) == (1, 11)
        assert nbytes == sent + 8 * (r + 1)


def test_failing_rank_ends_every_rank():
    """One rank raises after the first collective: every rank exits
    non-zero, well inside 30 s, under a 5 s timeout."""
    addr = f"127.0.0.1:{MP.free_port()}"
    t0 = time.monotonic()
    res = MP.run_ranks([[sys.executable, "-c", FAILING, addr, str(r)]
                        for r in range(D)], wait_s=60)
    took = time.monotonic() - t0
    assert [rc != 0 for rc, _o, _e in res] == [True] * D
    assert "ZeroDivisionError: rank 2" in res[2][2]
    assert took < 30, took


def test_process_mesh_api():
    """What a process mesh is without joining a group: hashable, one axis,
    its size and shape; gloo on a card is host-staged and says so; no
    card means no default device."""
    a = TD.ProcessMesh(4, 1, "cpu", "gloo")
    b = TD.ProcessMesh(4, 1, torch.device("cpu"), "gloo")
    assert a == b and hash(a) == hash(b) and a != TD.ProcessMesh(
        4, 2, "cpu", "gloo")
    assert a.size == 4 and a.shape == {"rows": 4}
    assert a.axis_names == ("rows",) and not a.staged
    staged = TD.ProcessMesh(2, 0, "cuda:0", "gloo")
    assert staged.staged and "host-staged" in repr(staged)
    assert not TD.ProcessMesh(2, 0, "cuda:0", "nccl").staged
    assert TM.home_device(a) == torch.device("cpu")
    with pytest.raises(ValueError):
        TD.initialize("127.0.0.1:1", 2, 0, device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TD.initialize("127.0.0.1:1", 2, 0)


def test_shard_array_gives_a_rank_its_rows():
    """On a process mesh shard_array takes the global array and returns
    this rank's padded piece; the thread mesh's row-sharded array is the
    pieces end to end."""
    arr = np.arange(10)
    pieces = [TP.shard_array(arr, TD.ProcessMesh(4, r, "cpu", "gloo"),
                             fill=-1) for r in range(4)]
    whole = TP.shard_array(arr, TP.row_mesh(["cpu"] * 4), fill=-1)
    assert [p.tolist() for p in pieces] == [[0, 1, 2], [3, 4, 5],
                                            [6, 7, 8], [9, -1, -1]]
    assert torch.equal(torch.cat(pieces), whole)


def test_engine_refuses_a_process_mesh():
    """SQL runs over a thread mesh only (the SPMD path reads every shard's
    outputs in one process)."""
    from monetdb_tpu_torch.engine import Engine
    from monetdb_tpu_torch.table import Catalog
    with pytest.raises(TypeError, match="thread mesh"):
        Engine(Catalog(), mesh=TD.ProcessMesh(2, 0, "cpu", "gloo"))
