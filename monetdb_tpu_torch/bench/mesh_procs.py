"""The row mesh's parallel primitives on a process mesh - one rank per card,
NCCL between them (``parallel/dist.py``) - beside the thread mesh over the
same cards (``row_mesh([cuda:0..n-1])``), with every shard's output held to
a numpy oracle and to the thread mesh's shard of the same rank.

    python -m monetdb_tpu_torch.bench.mesh_procs [--rows-log2 25]
        [--fused-rows 24000000] [--warm 5] [--local K] [--out FILE]

On a host with two or more cards it starts one rank per card, each a
process of its own (``python -m monetdb_tpu_torch.bench.mesh_procs --rank
...``); with ``--local K``, one process per K cards instead, each holding
K shards (the hybrid mesh: peer copies inside a process, NCCL between
processes), and then the one-card-a-process mesh as well, so that the
table has the hybrid mesh, the process mesh and the thread mesh over the
same cards.  Every rank makes the same global data from one seed: 2^rows-log2
int64 rows (keys uniform in [0, 2^20) and Zipf(2), values, 5% dead rows, a
unique build side of 2^20 keys) and ``--fused-rows`` rows of TPC-H Q1 / Q6
columns in int32 and int64 (the ranges of ``chip_smoke.py``'s kernel
phase), and runs ``two_phase_sum``, ``sharded_q6``, ``sharded_q1`` (the
int32 route through ``q1_grouped_sums``, the int64 one through
``seg_sum64``), ``lane_counts``, ``shuffle``, ``dist_group_sum``,
``dist_group_sum_auto`` and ``dist_fk_join`` once, checks its own piece of
each of its shards' pieces against numpy, and then times ``--warm`` runs
of each (a barrier before each run), the all-to-all of one shuffle's
buffers alone (on a hybrid mesh also its two parts apart: the chunks that
stay inside a process, and those that cross), and its host's cost per
eager op.  When the ranks are done the script runs the same primitives
over the thread mesh, holds each shard's output bit-equal to the same
global shard's (sha256 of every output tensor), and times them the same
way.  Last, a failure drill: the same processes again, the last shard
raising after one collective; every process must exit non-zero, and the
script prints how long that took.

Prints the cards' name and power limit, one line per primitive (the warm
median wall on each mesh, collectives and bytes a rank, the all-to-all's
rate) and last one JSON object with every number (also written to
``--out``).  Exits 1 on any difference or failed rank, 2 on a host with
fewer than two cards.  ``chip_smoke.py`` drives the same code with two
host-staged gloo ranks on one card, and with two processes of two shards
each there; tests/test_torch_dist.py the rank program with four gloo ranks
on the CPU, and tests/test_torch_hybrid.py with two of four CPU shards
each.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from ..column import capacity_for
from ..ops import cuda_kernels as CK
from ..parallel import dist as DIST
from ..parallel import mesh as MESH
from ..parallel import shuffle as SH
from ..parallel.mesh import RowMesh
from ..parallel.mitosis import (row_mesh, shard_array, sharded_q1,
                                sharded_q6, two_phase_sum)
from .mesh_cards import dispatch_cost

#: the group domain of two_phase_sum (keys mod this); seg_sum64 takes <= 128
SMALL_DOMAIN = 100
#: Q1's code domain, cutoff and Q6's parameters over the fused columns
Q1_DOMAIN = 8
Q1_CUTOFF = 10471
Q6_ARGS = (8766, 9131, 5, 7, 2400)
#: seconds a rank waits at one collective before its group fails
RANK_TIMEOUT_S = 300.0
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# data: the same global arrays in every process, from one seed
# ---------------------------------------------------------------------------


def make_inputs(rows: int, fused_rows: int, key_domain: int, seed: int,
                dead: int, floats: bool) -> dict:
    """Global numpy arrays: int64 keys (uniform in [0, key_domain), and
    Zipf(2) capped at key_domain), int64 values, a live mask with ``dead``
    rows dropped at seeded places, a unique build side of ``key_domain``
    keys with probe keys 25% of which miss it, and the six Q1 / Q6 columns
    of ``fused_rows`` rows (int32; code -1 on ~1% of the rows)."""
    rng = np.random.default_rng(seed)
    live = np.ones(rows, bool)
    live[rng.integers(0, rows, dead)] = False
    inp = {
        "uniform": rng.integers(0, key_domain, rows),
        "zipf": np.minimum(rng.zipf(2.0, rows), key_domain).astype(np.int64),
        "vals": rng.integers(-(1 << 40), 1 << 40, rows),
        "live": live,
        "probe": rng.integers(0, key_domain + key_domain // 4, rows),
        "build": np.arange(key_domain, dtype=np.int64),
    }
    inp["small"] = inp["uniform"] % SMALL_DOMAIN
    if floats:
        inp["fvals"] = rng.standard_normal(rows)
    n = fused_rows
    code = rng.integers(0, 6, n).astype(np.int32)
    code[rng.random(n) < 0.01] = -1
    inp["q"] = [code] + [rng.integers(lo, hi, n).astype(np.int32)
                         for lo, hi in ((8035, 10561), (100, 5100),
                                        (9000, 2_000_000), (0, 11), (0, 9))]
    return inp


def _placed(mesh, inp: dict) -> dict:
    """The inputs as the mesh's row-sharded tensors (set-up, not timed)."""
    def sh(a, fill=0):
        return shard_array(a, mesh, fill=fill)
    p = {k: sh(inp[k]) for k in ("uniform", "zipf", "vals", "small",
                                  "probe")}
    p["live"] = sh(inp["live"], False)
    p["rk"], p["rv"] = sh(inp["build"]), sh(inp["build"] * 1000 + 7)
    p["rl"] = sh(np.ones(len(inp["build"]), bool), False)
    if "fvals" in inp:
        p["fvals"] = sh(inp["fvals"])
    for tag, dt in (("32", np.int32), ("64", np.int64)):
        cols = [c.astype(dt) for c in inp["q"]]
        p["q1_" + tag] = [sh(cols[0], -1)] + [sh(c) for c in cols[1:]]
        p["q6_" + tag] = [sh(cols[1]), sh(cols[4], -1), sh(cols[2], 1 << 30),
                          sh(cols[3])]
    return p


# ---------------------------------------------------------------------------
# the primitives: name -> (kind, fn(mesh, placed, caps) -> tuple of tensors)
# ---------------------------------------------------------------------------


def _lanes(mesh, p, name):
    return (torch.from_numpy(SH.lane_counts(mesh, p[name], p["live"])),)


def _auto(mesh, p, name):
    *out, info = SH.dist_group_sum_auto(mesh, p[name], p["vals"], p["live"])
    return tuple(out) + (torch.tensor([int(info["skewed"]),
                                       info["lane_cap"], info["max_lane"]]),)


def _fk(mesh, p, caps):
    k, (lv, rv), hit = SH.dist_fk_join(mesh, p["probe"], [p["vals"]],
                                       p["live"], p["rk"], [p["rv"]],
                                       p["rl"], caps["join"])
    return k, lv, rv, hit


def primitives(floats: bool) -> list:
    """(name, kind, fn) in the order they run; kind says how the outputs
    lie on a thread mesh: "replicated" (every shard's the same),
    "sharded" (row-sharded), "sharded+info" (row-sharded but the last, the
    replicated info of dist_group_sum_auto)."""
    prims = [("two_phase_sum", "replicated", lambda m, p, c: (two_phase_sum(
        m, p["vals"], p["small"], p["live"], SMALL_DOMAIN),))]
    if floats:                      # index_add_ of floats is exact in order
        prims.append(("two_phase_sum_f64", "replicated",
                      lambda m, p, c: (two_phase_sum(
                          m, p["fvals"], p["small"], p["live"],
                          SMALL_DOMAIN),)))
    for tag in ("32", "64"):
        prims += [
            ("sharded_q6_i" + tag, "replicated", lambda m, p, c, t=tag: (
                sharded_q6(m)(*p["q6_" + t], *Q6_ARGS),)),
            ("sharded_q1_i" + tag, "replicated", lambda m, p, c, t=tag:
             tuple(sharded_q1(m, domain=Q1_DOMAIN)(*p["q1_" + t],
                                                   Q1_CUTOFF)))]
    for keys in ("uniform", "zipf"):
        prims += [
            ("lane_counts_" + keys, "replicated",
             lambda m, p, c, k=keys: _lanes(m, p, k)),
            ("shuffle_" + keys, "sharded", lambda m, p, c, k=keys: (
                lambda o: (o[0], *o[1], o[2]))(SH.shuffle(
                    m, p[k], [p["vals"]], p["live"], c[k]))),
            ("dist_group_sum_" + keys, "sharded", lambda m, p, c, k=keys:
             SH.dist_group_sum(m, p[k], p["vals"], p["live"], c[k])),
            ("dist_group_sum_auto_" + keys, "sharded+info",
             lambda m, p, c, k=keys: _auto(m, p, k))]
    prims.append(("dist_fk_join", "sharded", _fk))
    return prims


def lane_caps(mesh, p) -> dict:
    """Lane capacities from the counts pass (the same on every rank)."""
    def top(k, live="live"):
        return int(SH.lane_counts(mesh, p[k], p[live]).max())
    caps = {k: capacity_for(top(k)) for k in ("uniform", "zipf")}
    caps["join"] = capacity_for(max(top("probe"), top("rk", "rl")))
    return caps


def pieces(mesh, kind: str, outs) -> list:
    """Per shard of this process (every shard of a thread mesh), the output
    tensors as numpy arrays: each shard's slice of a row-sharded
    result."""
    outs = [o.cpu().numpy() for o in outs]
    d = len(mesh.devices)
    if kind == "replicated" or d == 1:
        return [outs] * d
    split = len(outs) - (kind == "sharded+info")
    return [[o.reshape(d, -1)[r] for o in outs[:split]] + outs[split:]
            for r in range(d)]


def digest(arrays) -> list:
    return [hashlib.sha256(str((a.dtype.str, a.shape)).encode()
                           + np.ascontiguousarray(a).tobytes()).hexdigest()
            for a in arrays]


# ---------------------------------------------------------------------------
# numpy oracle of one rank's piece
# ---------------------------------------------------------------------------


def np_hash64(keys: np.ndarray) -> np.ndarray:
    """``parallel.shuffle.hash64`` in numpy: int64 multiplies wrap, >> is
    arithmetic."""
    with np.errstate(over="ignore"):
        h = keys.astype(np.int64) * np.int64(-7046029254386353131)
        h = h ^ (h >> np.int64(31))
        h = h * np.int64(-4417276706812531889)
        return (h ^ (h >> np.int64(33))) & np.int64(0x3FFF_FFFF_FFFF_FFFF)


def _group_sums(k: np.ndarray, v: np.ndarray):
    """(distinct keys ascending, their sums) exactly, by a sort."""
    order = np.argsort(k, kind="stable")
    ks, vs = k[order], v[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]]) if len(ks) \
        else np.zeros(0, np.int64)
    if not len(ks):
        return ks, vs
    return ks[starts], np.add.reduceat(vs, starts)


#: make_inputs's values lie in [-2^40, 2^40): a key below 2^21 and a value
#: pack into one int64 that sorts as the pair does
_VAL_BITS = 41


def _pairs(k: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(key, value) rows as one sorted int64 array: equal for equal
    multisets of pairs."""
    if len(k) and (k.min() < 0 or k.max() >= 1 << (62 - _VAL_BITS)):
        raise ValueError("keys outside the packed range")
    return np.sort((k.astype(np.int64) << _VAL_BITS)
                   | (v + (1 << (_VAL_BITS - 1))))


class Oracle:
    """numpy's answers for the shards of a mesh of ``size`` over ``inp``."""

    def __init__(self, inp: dict, size: int):
        self.inp, self.size = inp, size
        self._memo = {}

    def _once(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def dest(self, name: str) -> np.ndarray:
        return self._once(("dest", name),
                          lambda: np_hash64(self.inp[name]) % self.size)

    def mine(self, name: str, rank: int) -> np.ndarray:
        """Live rows whose key shard ``rank`` owns."""
        return self._once(("mine", name, rank), lambda: self.inp["live"]
                          & (self.dest(name) == rank))

    def q1(self) -> list:
        """Q1's six grouped sums over the fused columns, exactly: rows
        sorted by group (excluded rows last), prefix sums cut at the
        group bounds."""
        def run():
            code, ship, qty, extp, disc, tax = (
                c.astype(np.int64) for c in self.inp["q"])
            g = np.where((code >= 0) & (ship <= Q1_CUTOFF), code,
                         Q1_DOMAIN).astype(np.int8)
            order = np.argsort(g, kind="stable")
            bounds = np.searchsorted(g[order], np.arange(Q1_DOMAIN + 1))
            dp = extp * (100 - disc)
            out = []
            for c in (qty, extp, dp, dp * (100 + tax), disc):
                cs = np.r_[0, np.cumsum(c[order])]
                out.append(cs[bounds[1:]] - cs[bounds[:-1]])
            return out + [np.diff(bounds)]
        return self._once("q1", run)

    def sums(self, keys: str, rank: int):
        m = self.mine(keys, rank)
        return self._once(("sums", keys, rank), lambda: _group_sums(
            self.inp[keys][m], self.inp["vals"][m]))

    def check(self, name: str, got: list, rank: int) -> None:
        """Raise AssertionError unless ``got`` (shard ``rank``'s output
        arrays of primitive ``name``) is numpy's answer."""
        inp, d = self.inp, self.size
        live, vals = inp["live"], inp["vals"]
        base = name.rsplit("_", 1)
        if name == "two_phase_sum":
            want = np.zeros(SMALL_DOMAIN, np.int64)
            np.add.at(want, inp["small"][live], vals[live])
            ok = np.array_equal(got[0], want)
        elif name == "two_phase_sum_f64":
            want = np.zeros(SMALL_DOMAIN)
            np.add.at(want, inp["small"][live], inp["fvals"][live])
            ok = np.allclose(got[0], want, rtol=1e-9, atol=1e-9)
        elif name.startswith("sharded_q6"):
            ship, disc, qty = inp["q"][1], inp["q"][4], inp["q"][2]
            lo, hi, dlo, dhi, qmax = Q6_ARGS
            m = ((ship >= lo) & (ship < hi) & (disc >= dlo) & (disc <= dhi)
                 & (qty < qmax))
            want = int((inp["q"][3][m].astype(np.int64)
                        * disc[m].astype(np.int64)).sum())
            ok = int(got[0]) == want
        elif name.startswith("sharded_q1"):
            ok = all(np.array_equal(g, w) for g, w in zip(got, self.q1()))
        elif base[0] == "lane_counts":
            dest = self.dest(base[1])
            n = len(dest)
            want = np.stack([np.bincount(
                dest[r * n // d:(r + 1) * n // d][
                    live[r * n // d:(r + 1) * n // d]],
                minlength=d) for r in range(d)])
            ok = np.array_equal(got[0], want)
        elif base[0] == "shuffle":
            k, v, lv = got
            m = self.mine(base[1], rank)
            ok = (np.array_equal(_pairs(k[lv], v[lv]),
                                 _pairs(inp[base[1]][m], vals[m]))
                  and bool((np_hash64(k[lv]) % d == rank).all()))
        elif name.startswith("dist_group_sum"):
            k, s, lv = got[:3]
            ks, ss = self.sums(name.rsplit("_", 1)[1], rank)
            order = np.argsort(k[lv], kind="stable")
            ok = (np.array_equal(k[lv][order], ks)
                  and np.array_equal(s[lv][order], ss))
        elif name == "dist_fk_join":
            k, lv, rv, hit = got
            m = self.mine("probe", rank) & (inp["probe"]
                                            < len(inp["build"]))
            ok = (np.array_equal(_pairs(k[hit], lv[hit]),
                                 _pairs(inp["probe"][m], vals[m]))
                  and np.array_equal(rv[hit], k[hit] * 1000 + 7))
        else:
            raise KeyError(name)
        if not ok:
            raise AssertionError(f"shard {rank}: {name} != numpy")


# ---------------------------------------------------------------------------
# one mesh: drive, check, time
# ---------------------------------------------------------------------------


def _sync(mesh) -> None:
    for dv in set(mesh.devices):
        if dv.type == "cuda":
            torch.cuda.synchronize(dv)


def _barrier(mesh) -> None:
    _sync(mesh)
    if not isinstance(mesh, RowMesh):
        mesh.barrier()


def drive(mesh, inp: dict, floats: bool):
    """Every primitive once over ``mesh``.  Returns (placed inputs, lane
    capacities, {name: numpy outputs of each shard of this process},
    {name: {collectives, bytes} of one shard})."""
    p = _placed(mesh, inp)
    caps = lane_caps(mesh, p)
    outs, stats = {}, {}
    for name, kind, fn in primitives(floats):
        s0 = dict(MESH.STATS)
        got = fn(mesh, p, caps)
        _sync(mesh)
        shards = len(mesh.devices)
        stats[name] = {
            "collectives": MESH.STATS["collectives"] - s0["collectives"],
            "bytes": (MESH.STATS["bytes"] - s0["bytes"]) // shards}
        outs[name] = pieces(mesh, kind, got)
    return p, caps, outs, stats


def time_all(mesh, p, caps, floats: bool, warm: int) -> dict:
    """Median wall ms of ``warm`` runs of each primitive, each run after a
    barrier and ended by a device synchronise."""
    ms = {}
    for name, _kind, fn in primitives(floats):
        runs = []
        for _ in range(warm):
            _barrier(mesh)
            t0 = time.perf_counter()
            fn(mesh, p, caps)
            _sync(mesh)
            runs.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(runs)
    return ms


def a2a_rate(mesh, nbytes: int, reps: int) -> dict:
    """The all-to-all alone: ``reps`` exchanges of an ``nbytes`` buffer a
    shard; ms a call (the slowest shard) and GB/s a shard hands over."""
    def fn(ins, coll):
        buf = torch.zeros(nbytes // 8, dtype=torch.int64,
                          device=coll.device)
        coll.all_to_all(buf)            # warm, and lines the shards up
        if coll.device.type == "cuda":
            torch.cuda.synchronize(coll.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            coll.all_to_all(buf)
        if coll.device.type == "cuda":
            torch.cuda.synchronize(coll.device)
        return (time.perf_counter() - t0) / reps * 1e3
    ms = max(MESH.run_shards(mesh, fn, (), ()))
    return {"bytes": nbytes, "ms": ms, "gb_s": nbytes / ms / 1e6}


def a2a_parts(mesh, nbytes: int, reps: int) -> dict:
    """A hybrid mesh's all-to-all of ``nbytes`` a shard in its two parts,
    each alone.  In the process: the 1 / processes of a shard's bytes
    meant for the process's own shards, exchanged among them as the thread
    mesh over its devices exchanges them (by reference, or a peer copy
    between cards); GB/s a shard.  Across processes: the process group's
    ``all_to_all_single`` of the rest, as the mesh of one shard a process
    over the same group sends it (local x ``nbytes`` a process, of which
    (processes - 1) / processes cross); GB/s of what crosses, a
    process."""
    inner = a2a_rate(RowMesh(mesh.devices), nbytes // mesh.processes, reps)
    mesh.barrier()
    cross = a2a_rate(mesh.per_process(), nbytes * mesh.local, reps)
    crossed = nbytes * mesh.local * (mesh.processes - 1) // mesh.processes
    return {"in_process": inner,
            "cross_process": {"bytes": crossed, "ms": cross["ms"],
                              "gb_s": crossed / cross["ms"] / 1e6}}


def eager_us(device, n: int = 2000) -> float:
    """Host microseconds an eager op takes on ``device`` (2,000 of them)."""
    x = torch.zeros(8, device=device)
    if x.is_cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        torch.where(x > 0, x, x)
    if x.is_cuda:
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / n * 1e6


def a2a_bytes(mesh, caps) -> int:
    """Bytes a shard hands to the uniform shuffle's all_to_all (lane
    counts, keys, values)."""
    d = mesh.size
    return d * 8 + 2 * d * caps["uniform"] * 8


# ---------------------------------------------------------------------------
# a rank
# ---------------------------------------------------------------------------


def rank_run(mesh, args) -> list:
    """This process's part on a joined ``mesh``: every primitive once
    (the kernel launch counts set to 0 just before and read just after),
    each of its shards' pieces checked against numpy, ``args.warm`` timed
    runs; writes ``rank<g>.json`` (and with ``args.save`` every output
    array in ``rank<g>.npz``) under ``args.out`` for each of its global
    shards g, and returns their reports."""
    floats = mesh.device.type == "cpu"
    if floats:
        # the ranks share the host's cores: torch's op threads, spinning
        # between ops, would starve the other ranks' transport threads
        torch.set_num_threads(1)
    took = {}
    t0 = time.perf_counter()
    inp = make_inputs(1 << args.rows_log2, args.fused_rows,
                      args.key_domain, args.seed, args.dead, floats)
    took["inputs"] = time.perf_counter() - t0
    for k in CK.LAUNCHES:
        CK.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    p, caps, outs, stats = drive(mesh, inp, floats)
    took["drive"] = time.perf_counter() - t0
    launches = dict(CK.LAUNCHES)
    t0 = time.perf_counter()
    oracle = Oracle(inp, mesh.size)
    for name, shards in outs.items():
        for g, got in zip(mesh.shards, shards):
            oracle.check(name, got, g)
    took["numpy_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    digests = {n: [digest(g) for g in shards] for n, shards in outs.items()}
    took["digests"] = time.perf_counter() - t0
    rep = {"process": mesh.rank, "mesh": repr(mesh), "caps": caps,
           "launches": launches, "stats": stats, "seconds": took}
    if args.warm:
        t0 = time.perf_counter()
        rep["ms"] = time_all(mesh, p, caps, floats, args.warm)
        rep["a2a"] = a2a_rate(mesh, a2a_bytes(mesh, caps), args.warm)
        if mesh.local > 1:
            mesh.barrier()
            rep["a2a_parts"] = a2a_parts(mesh, a2a_bytes(mesh, caps),
                                         args.warm)
        mesh.barrier()
        rep["eager_us"] = eager_us(mesh.device)
        took["timed"] = time.perf_counter() - t0
    reps = []
    for j, g in enumerate(mesh.shards):
        reps.append(dict(rep, rank=g, digests={n: d[j] for n, d in
                                               digests.items()}))
        out = os.path.join(args.out, f"rank{g}")
        if args.save:
            np.savez(out + ".npz", **{f"{n}.{i}": a
                                      for n, shards in outs.items()
                                      for i, a in enumerate(shards[j])})
        with open(out + ".json", "w") as f:
            json.dump(reps[-1], f)
    return reps


def _drill(mesh, fail_rank: int) -> None:
    """Two psums; shard ``fail_rank`` raises between them."""
    def fn(ins, coll):
        coll.psum(torch.ones(4, device=coll.device))
        if coll.rank == fail_rank:
            raise RuntimeError(f"rank {fail_rank} fails on purpose")
        return coll.psum(torch.ones(4, device=coll.device)).cpu()
    MESH.run_shards(mesh, fn, (), ())


def rank_main(args) -> int:
    """One process: join the group (one shard on ``--device``, or one on
    each of a comma-separated list), run its part (or the failure drill),
    leave."""
    devs = args.device.split(",") if args.device else [None]
    where = ({"device": devs[0]} if len(devs) == 1 else {"devices": devs})
    mesh = DIST.initialize(args.addr, args.ranks, args.rank,
                           backend=args.backend, timeout=args.timeout,
                           **where)
    if args.fail_rank is not None:
        _drill(mesh, args.fail_rank)
        return 0
    rank_run(mesh, args)
    mesh.barrier()
    DIST.shutdown()
    return 0


# ---------------------------------------------------------------------------
# the launcher: ranks, then the thread mesh, then the comparison
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_argv(rank: int, ranks: int, addr: str, device: str, backend: str,
              out: str, rows_log2: int, fused_rows: int, key_domain: int,
              seed: int, dead: int, warm: int, timeout: float,
              save: bool = False) -> list:
    """The command line of one process (``device``: one, or a
    comma-separated list of its devices)."""
    argv = [sys.executable, "-m", "monetdb_tpu_torch.bench.mesh_procs",
            "--rank", str(rank), "--ranks", str(ranks), "--addr", addr,
            "--device", device, "--backend", backend, "--out", out,
            "--rows-log2", str(rows_log2), "--fused-rows", str(fused_rows),
            "--key-domain", str(key_domain), "--seed", str(seed),
            "--dead", str(dead), "--warm", str(warm),
            "--timeout", str(timeout)]
    return argv + (["--save"] if save else [])


def run_ranks(argvs: list, wait_s: float) -> list:
    """Start every rank (``subprocess``: a fresh interpreter each, as CUDA
    needs), wait for all; returns their (rc, stdout, stderr).  A rank still
    running after ``wait_s`` is killed.  Output goes to files, so that no
    rank blocks on a full pipe while another waits for it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                   if x])
    with tempfile.TemporaryDirectory(prefix="mesh_ranks_") as logs:
        files, procs = [], []
        try:
            for r, a in enumerate(argvs):
                out = open(os.path.join(logs, f"{r}.out"), "w+")
                err = open(os.path.join(logs, f"{r}.err"), "w+")
                files.append((out, err))
                procs.append(subprocess.Popen(a, cwd=_ROOT, env=env,
                                              stdout=out, stderr=err,
                                              text=True))
            deadline = time.monotonic() + wait_s
            res = []
            for pr, (out, err) in zip(procs, files):
                note = ""
                try:
                    pr.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pr.kill()
                    pr.wait()
                    note = f"\nkilled after {wait_s} s"
                out.seek(0)
                err.seek(0)
                res.append((pr.returncode, out.read(), err.read() + note))
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
            for out, err in files:
                out.close()
                err.close()
    return res


def _groups(devices: list, local: int) -> list:
    """Each process's devices, as its ``--device`` argument."""
    if not devices or len(devices) % local:
        raise ValueError(f"{len(devices)} devices do not split into "
                         f"processes of {local}")
    return [",".join(map(str, devices[p:p + local]))
            for p in range(0, len(devices), local)]


def fail_drill(devices: list, backend: str, timeout: float,
               local: int = 1) -> float:
    """One process per ``local`` devices; the last shard raises after the
    first collective.  Every process must exit non-zero (the others at
    their next collective, or at ``timeout``); returns the seconds until
    the last one ended."""
    if any(str(x).startswith("cuda") for x in devices):
        CK.build()
    groups = _groups(devices, local)
    n = len(groups)
    addr = f"127.0.0.1:{free_port()}"
    argvs = [rank_argv(r, n, addr, groups[r], backend, ".", 0, 0, 0,
                       0, 0, 0, timeout)
             + ["--fail-rank", str(len(devices) - 1)] for r in range(n)]
    t0 = time.perf_counter()
    res = run_ranks(argvs, wait_s=timeout + 60)
    took = time.perf_counter() - t0
    if any(rc == 0 for rc, _o, _e in res) or "fails on purpose" not in \
            res[-1][2]:
        raise AssertionError(f"failure drill: exits {[r[0] for r in res]}"
                             f"\n{res[-1][2][-2000:]}")
    return took


def compare(devices: list, backend: str, rows_log2: int, fused_rows: int,
            key_domain: int = 1 << 20, seed: int = 42, warm: int = 5,
            dead: int = -1, timeout: float = RANK_TIMEOUT_S,
            local: int = 1) -> dict:
    """Processes of ``local`` devices each over ``devices`` (one shard per
    device, global shard g on ``devices[g]``) joined by ``backend``, then
    the thread mesh ``row_mesh(devices)``: every shard's outputs checked
    against numpy (in its process) and against the thread mesh's shard of
    the same rank (here).  Returns the numbers; raises AssertionError on a
    failed process or a difference."""
    groups = _groups(devices, local)
    n = len(groups)
    d = len(devices)
    dead = (1 << rows_log2) // 20 if dead < 0 else dead
    if any(str(x).startswith("cuda") for x in devices):
        CK.build()                      # once, before the ranks load it
    addr = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="mesh_procs_") as out:
        t0 = time.perf_counter()
        res = run_ranks([rank_argv(r, n, addr, groups[r], backend,
                                   out, rows_log2, fused_rows, key_domain,
                                   seed, dead, warm, timeout)
                         for r in range(n)], wait_s=timeout + 600)
        procs_s = time.perf_counter() - t0
        bad = [f"rank {r} exit {rc}:\n{err[-3000:]}"
               for r, (rc, _o, err) in enumerate(res) if rc != 0]
        if bad:
            raise AssertionError("\n".join(bad))
        reps = []
        for g in range(d):
            with open(os.path.join(out, f"rank{g}.json")) as f:
                reps.append(json.load(f))
    per_proc = reps[::local]
    floats = torch.device(devices[0]).type == "cpu"
    inp = make_inputs(1 << rows_log2, fused_rows, key_domain, seed, dead,
                      floats)
    mesh = row_mesh(devices)
    p, caps, outs, stats = drive(mesh, inp, floats)
    differ = [f"{name} shard {r}"
              for name, shards in outs.items()
              for r, g in enumerate(shards)
              if digest(g) != reps[r]["digests"][name]]
    if caps != reps[0]["caps"]:
        differ.append(f"lane capacities {caps} != {reps[0]['caps']}")
    result = {"mesh": reps[0]["mesh"], "ranks": n, "local": local,
              "rows": 1 << rows_log2, "fused_rows": fused_rows,
              "caps": caps, "procs_s": procs_s,
              "launches": {k: sum(rp["launches"][k] for rp in per_proc)
                           for k in reps[0]["launches"]},
              "launches_per_rank": [rp["launches"] for rp in per_proc],
              "rank_seconds": reps[0]["seconds"],
              "primitives": {}}
    if warm:
        tms = time_all(mesh, p, caps, floats, warm)
        ta2a = a2a_rate(mesh, a2a_bytes(mesh, caps), warm)
        result["a2a"] = {"process": max((rp["a2a"] for rp in per_proc),
                                        key=lambda a: a["ms"]),
                         "thread": ta2a}
        if local > 1:
            for part in ("in_process", "cross_process"):
                result["a2a"][part] = max(
                    (rp["a2a_parts"][part] for rp in per_proc),
                    key=lambda a: a["ms"])
        # threads: one alone, and one per shard at once (mesh_cards's)
        threads = (dispatch_cost(list(mesh.devices))
                   if mesh.devices[0].type == "cuda" else
                   {"one_thread": eager_us(mesh.devices[0])})
        result["eager_us"] = {
            "process_per_card": [rp["eager_us"] for rp in per_proc],
            **threads}
    for name in outs:
        e = {"process_stats": reps[0]["stats"][name],
             "thread_stats": stats[name]}
        if warm:
            e["process_ms"] = max(rp["ms"][name] for rp in per_proc)
            e["thread_ms"] = tms[name]
        result["primitives"][name] = e
    result["differ"] = differ
    if differ:
        raise AssertionError(f"process mesh != thread mesh: {differ}")
    return result


def report(result: dict) -> None:
    """One line per primitive of a ``compare`` result (with
    ``result["per_process"]``, a second one's over the same cards with one
    card a process: the hybrid mesh, the process mesh and the thread
    mesh)."""
    kind = "hybrid mesh" if result["local"] > 1 else "process mesh"
    other = result.get("per_process")
    for name, e in result["primitives"].items():
        times = ""
        if "process_ms" in e:
            also = ""
            if other:
                o = other["primitives"][name]
                also = (f"{o['process_ms']:.3f} ms process mesh (thread mesh "
                        f"{o['thread_ms']:.3f} ms in its run), ")
            times = (f"warm median {e['process_ms']:.3f} ms {kind}, "
                     f"{also}{e['thread_ms']:.3f} ms thread mesh; ")
        _log(f"mesh_procs: {name}: every shard equal to numpy and to the "
             f"thread mesh's shard; {times}a shard "
             f"{e['process_stats']['collectives']} collectives, "
             f"{e['process_stats']['bytes'] / 2**20:.2f} MiB "
             f"(thread mesh a shard {e['thread_stats']['collectives']}, "
             f"{e['thread_stats']['bytes'] / 2**20:.2f} MiB)")
    if "a2a" in result:
        a, t = result["a2a"]["process"], result["a2a"]["thread"]
        _log(f"mesh_procs: all_to_all of {a['bytes'] / 2**20:.1f} MiB a "
             f"shard: {kind} {a['ms']:.3f} ms ({a['gb_s']:.1f} GB/s a "
             f"shard), thread mesh {t['ms']:.3f} ms ({t['gb_s']:.1f} "
             f"GB/s a shard)")
        if "in_process" in result["a2a"]:
            i, c = (result["a2a"]["in_process"],
                    result["a2a"]["cross_process"])
            _log(f"mesh_procs: its parts alone: in a process "
                 f"{i['bytes'] / 2**20:.1f} MiB a shard in {i['ms']:.3f} ms "
                 f"({i['gb_s']:.1f} GB/s a shard), across processes "
                 f"{c['bytes'] / 2**20:.1f} MiB a process in "
                 f"{c['ms']:.3f} ms ({c['gb_s']:.1f} GB/s a process)")
        if other and "a2a" in other:
            a = other["a2a"]["process"]
            _log(f"mesh_procs: process mesh all_to_all of "
                 f"{a['bytes'] / 2**20:.1f} MiB a rank {a['ms']:.3f} ms "
                 f"({a['gb_s']:.1f} GB/s a rank)")
        eu = result["eager_us"]
        per = (f", {eu['per_card']:.2f} us with one thread per device at "
               f"once" if "per_card" in eu else "")
        _log(f"mesh_procs: host cost per eager op: "
             f"{', '.join(f'{x:.2f}' for x in eu['process_per_card'])} us "
             f"with one process per {result['local']} device(s) at once, "
             f"{eu['one_thread']:.2f} us from one thread alone{per}")


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-log2", type=int, default=25)
    ap.add_argument("--fused-rows", type=int, default=24_000_000)
    ap.add_argument("--key-domain", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dead", type=int, default=-1,
                    help="dead rows (default 5%% of the rows)")
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--timeout", type=float, default=RANK_TIMEOUT_S)
    ap.add_argument("--local", type=int, default=1,
                    help="cards (shards) a process")
    ap.add_argument("--out", default=None)
    # a rank's own arguments (given by the launcher)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--addr", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--fail-rank", type=int, default=None)
    return ap.parse_args(argv)


def main(argv) -> int:
    args = _args(argv)
    if args.rank is not None:
        try:
            return rank_main(args)
        except BaseException:           # noqa: BLE001 - the rank's exit
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)                 # no teardown that waits on peers
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        _log(f"mesh_procs: {n} CUDA device(s); needs two or more")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    cards = [ln.strip() for ln in smi.stdout.strip().splitlines()]
    for ln in cards:
        _log(ln)
    devs = [f"cuda:{i}" for i in range(n)]
    t0 = time.perf_counter()
    try:
        result = compare(devs, "nccl", args.rows_log2, args.fused_rows,
                         args.key_domain, args.seed, args.warm,
                         dead=args.dead, timeout=args.timeout,
                         local=args.local)
        if args.local > 1:
            result["per_process"] = compare(
                devs, "nccl", args.rows_log2, args.fused_rows,
                args.key_domain, args.seed, args.warm, dead=args.dead,
                timeout=args.timeout)
        result["fail_drill_s"] = fail_drill(devs, "nccl", args.timeout,
                                            args.local)
    except (AssertionError, ValueError) as ex:
        _log(f"mesh_procs: FAILED {ex}")
        return 1
    _log(f"mesh_procs: failure drill: shard {n - 1} raised after one "
         f"collective; all {n // args.local} processes exited non-zero "
         f"within {result['fail_drill_s']:.2f} s")
    # whether the cards reach each other's memory directly (the thread
    # mesh's copies and NCCL's transports depend on it)
    result["peer_access"] = [[i == j or torch.cuda.can_device_access_peer(
        i, j) for j in range(n)] for i in range(n)]
    result.update(cards=cards, torch=torch.__version__,
                  nccl=".".join(map(str, torch.cuda.nccl.version())),
                  seconds=time.perf_counter() - t0)
    report(result)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    _log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
