"""Distributed shuffle: ragged all-to-all hash-partition exchange over the
row mesh — the feature the reference does NOT have (its remote joins ship
whole columns to one site, modules/mal/remote.c:971 RMTput).

Design (static-shape discipline, as in the reference package):
  1. counts pass — each shard histograms its rows by destination
     (dest = hash64(key) mod D); one host read yields the max lane size,
     bucketed into a lane capacity C (count-then-allocate).
  2. pack — stable sort rows by destination, gather into a [D, C] send
     buffer per column (padding = 0).
  3. exchange — the mesh's all_to_all.
  4. unpack — received [D, C] lanes flatten into the local partition with a
     validity mask derived from the exchanged counts.

Skew: the counts pass reports the max/mean lane ratio (detect_skew);
dist_group_sum_auto reacts to a hot-key (Zipf) distribution with a
shard-local combiner before the exchange, so every key ships at most one
partial row per shard.

A row-sharded array is one tensor on the mesh's first device whose length
divides by the shard count (``mitosis.shard_array``); every function here
takes and returns such tensors.  On a process mesh (``parallel/dist.py``)
it is the pieces of this process's shards instead, end to end on its first
device, and every function takes and returns those; ``lane_counts`` gives
every shard the whole matrix, so that the host decisions taken from it
(skew, lane capacity) are the same on every shard and every shard posts
all-to-alls of one shape.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..column import capacity_for
from .mesh import home_device, run_shards

__all__ = ["hash64", "lane_counts", "shuffle", "dist_group_sum",
           "dist_group_sum_auto", "dist_fk_join"]

_MULT = -7046029254386353131       # 0x9E3779B97F4A7C15 as s64
_MULT2 = -4417276706812531889
_BIG = 1 << 62                     # sorts after every hash-owned key


def hash64(key: torch.Tensor) -> torch.Tensor:
    """splitmix-style avalanche of int64 keys; result in [0, 2^62).  The
    multiplies wrap modulo 2^64 and ``>>`` is arithmetic, as in the
    reference's int64 arithmetic, so the bits are the reference's."""
    h = key.to(torch.int64) * _MULT
    h = h ^ (h >> 31)
    h = h * _MULT2
    return (h ^ (h >> 33)) & 0x3FFF_FFFF_FFFF_FFFF


def _dest(key, live, ndev: int):
    return torch.where(live, (hash64(key) % ndev).to(torch.int32), ndev)


def _gathered(mesh, parts) -> torch.Tensor:
    """Per-shard pieces as one row-sharded tensor on the first device (a
    process's pieces of its own shards; one piece as it is)."""
    dev = home_device(mesh)
    if len(parts) == 1:
        return parts[0].to(dev)
    return torch.cat([p.to(dev) for p in parts])


def _outputs(mesh, outs) -> list:
    return [_gathered(mesh, [o[i] for o in outs])
            for i in range(len(outs[0]))]


def lane_counts(mesh, key: torch.Tensor,
                live: torch.Tensor) -> np.ndarray:
    """Counts pass: [D, D] matrix of rows each src shard sends to each dst,
    the whole of it on every shard (an all_gather of the shards' rows)."""
    D = mesh.size

    def count(ins, coll):
        d = _dest(ins[0], ins[1], D)
        row = torch.bincount(d, minlength=D + 1)[:D].to(torch.int32)
        return coll.all_gather(row[None])

    return run_shards(mesh, count, (key, live), (True, True))[0].cpu().numpy()


def detect_skew(counts: np.ndarray) -> Tuple[int, float]:
    """(max lane, max/mean ratio) — ratio ≫ 1 means a hot key (Zipf)."""
    mx = int(counts.max())
    mean = float(counts.mean()) or 1.0
    return mx, mx / mean


def exchange(dest, cols, fills, lane_cap: int, coll):
    """One shard's side of the ragged all-to-all: row i goes to shard
    ``dest[i]`` (``dest`` == D: the row is dropped).  A stable sort by
    destination packs each column into a [D, lane_cap] send buffer (cell
    (d, c) holds the c-th row bound for shard d; empty cells hold the
    column's ``fills`` entry); the clamped lane counts and every column
    travel in one all_to_all.  Returns (rows bound for each shard,
    unclamped, so a caller can see a lane overflow; the received columns,
    each of length D * lane_cap; their live mask)."""
    D = coll.size
    n = dest.shape[0]
    dev = dest.device
    order = torch.argsort(dest, stable=True)    # dropped rows sort last
    ends = torch.searchsorted(dest[order], torch.arange(D, dtype=dest.dtype,
                                                        device=dev),
                              right=True)
    offs = torch.cat([ends.new_zeros(1), ends[:-1]])
    cnt = ends - offs
    c_idx = torch.arange(lane_cap, device=dev)[None, :]
    cnt_send = cnt.clamp(max=lane_cap)
    valid = c_idx < cnt_send[:, None]
    src = order[(offs[:, None] + c_idx).clamp(0, max(n - 1, 0))]
    got = coll.all_to_all([cnt_send] + [torch.where(valid, c[src], f)
                                        for c, f in zip(cols, fills)])
    live = (c_idx < got[0][:, None]).reshape(-1)
    return cnt, [g.reshape(-1) for g in got[1:]], live


def _shuffle_local(k, lv, cols, lane_cap: int, coll):
    """One shard's side of ``shuffle``: (key', live', cols') of local
    length D * lane_cap, empty cells 0."""
    cols = [k, *cols]
    _cnt, got, live = exchange(_dest(k, lv, coll.size), cols,
                               [0] * len(cols), lane_cap, coll)
    return got[0], live, got[1:]


def shuffle(mesh, key: torch.Tensor, payloads: List[torch.Tensor],
            live: torch.Tensor, lane_cap: int):
    """Exchange rows to their hash-owner shard. Returns (key', payloads',
    live') with per-shard local length D·lane_cap."""

    def run(ins, coll):
        k, lv, cols = _shuffle_local(ins[0], ins[1], ins[2:], lane_cap, coll)
        return (k, lv, *cols)

    out = _outputs(mesh, run_shards(mesh, run, (key, live, *payloads),
                                    (True,) * (2 + len(payloads))))
    return out[0], list(out[2:]), out[1]


def _local_group_sum(k, v, lv):
    """Shard-local grouped sum, scatter-free: sort by key, cumsum at run
    boundaries, compact group starts by rank (the reference package's
    _SegReduce sorted strategy)."""
    n = k.shape[0]
    dev = k.device
    kk = torch.where(lv, k, _BIG)
    order = torch.argsort(kk, stable=True)
    ks, vs, ls = kk[order], v[order], lv[order]
    io = torch.arange(n, device=dev)
    first = (io == 0) | (ks != torch.roll(ks, 1))
    gfirst = first & ls
    # position of the g-th group's first row: rank-compact the flags
    csum_f = torch.cumsum(gfirst.to(torch.int64), 0)
    starts = torch.searchsorted(csum_f, io + 1, right=False)
    ng = csum_f[-1] if n else torch.zeros((), dtype=torch.int64, device=dev)
    gl = io < ng
    startsc = starts.clamp(0, max(n - 1, 0))
    # per-group sum = csum diff between consecutive group starts
    cv = torch.cat([vs.new_zeros(1), torch.cumsum(torch.where(ls, vs, 0), 0,
                                                  dtype=vs.dtype)])
    nxt = torch.cat([startsc[1:], startsc.new_full((1,), n)])
    live_end = torch.where(gl, torch.where(io + 1 < ng, nxt, n), 0)
    # rows of dead keys sort last; cap the final group at the live count
    live_end = torch.minimum(live_end, ls.sum())
    sums = cv[live_end] - cv[torch.where(gl, startsc, 0)]
    keys_out = torch.where(gl, ks[startsc], 0)
    return keys_out, sums, gl


def dist_group_sum(mesh, key: torch.Tensor, val: torch.Tensor,
                   live: torch.Tensor, lane_cap: int,
                   pre_combine: bool = False):
    """Distributed grouped sum: shuffle by key, then shard-local sort-based
    segmented sum (each key is wholly owned by one shard after exchange —
    the scalable replacement for two-phase aggregation when the group count
    is itself huge).

    pre_combine=True is the skew-aware mode: each shard locally combines
    duplicate keys first, so a Zipf-hot key contributes at most one partial
    row per shard and the exchange lane capacity tracks the distinct-key
    mean instead of the hottest key's row count.  Use dist_group_sum_auto
    to pick the mode from measured lane counts."""

    def run(ins, coll):
        k, v, lv = ins
        if pre_combine:
            k, v, lv = _local_group_sum(k, v, lv)
        k2, lv2, (v2,) = _shuffle_local(k, lv, [v], lane_cap, coll)
        return _local_group_sum(k2, v2, lv2)

    return tuple(_outputs(mesh, run_shards(mesh, run, (key, val, live),
                                           (True,) * 3)))


def dist_fk_join(mesh, lkey, lvals: List[torch.Tensor], llive,
                 rkey, rvals: List[torch.Tensor], rlive, lane_cap: int):
    """Distributed FK→PK join: shuffle both sides by key, then shard-local
    probe (right side unique per key). Returns left rows with gathered right
    payloads (miss → live=False), all row-sharded."""
    nl, nr = len(lvals), len(rvals)

    def run(ins, coll):
        lk, ll, lcols = _shuffle_local(ins[0], ins[1], ins[2:2 + nl],
                                       lane_cap, coll)
        rk, rl, rcols = _shuffle_local(ins[2 + nl], ins[3 + nl],
                                       ins[4 + nl:], lane_cap, coll)
        rkk = torch.where(rl, rk, _BIG)
        order = torch.argsort(rkk, stable=True)
        rks = rkk[order]
        pos = torch.searchsorted(rks, torch.where(ll, lk, _BIG - 1))
        posc = pos.clamp(0, rks.shape[0] - 1)
        hit = ll & (rks[posc] == lk)
        src = order[posc]
        out_r = [torch.where(hit, rc[src], 0) for rc in rcols]
        return (lk, *lcols, *out_r, hit)

    out = _outputs(mesh, run_shards(
        mesh, run, (lkey, llive, *lvals, rkey, rlive, *rvals),
        (True,) * (4 + nl + nr)))
    return out[0], list(out[1:-1]), out[-1]


def _pre_combine(mesh, key, val, live):
    """Shard-local combiner (the 'map-side combine' of the two-level
    skew-resistant aggregation)."""
    return tuple(_outputs(mesh, run_shards(
        mesh, lambda ins, coll: _local_group_sum(*ins), (key, val, live),
        (True,) * 3)))


def dist_group_sum_auto(mesh, key: torch.Tensor, val: torch.Tensor,
                        live: torch.Tensor, skew_ratio: float = 4.0):
    """Skew-aware distributed grouped sum: measure lane counts, and when
    the max/mean ratio exceeds skew_ratio, pre-combine locally so the
    exchange stays near the mean lane size.  Returns
    (keys, sums, live, info) with info = {"skewed", "ratio", "lane_cap",
    "max_lane"}."""
    counts = lane_counts(mesh, key, live)
    mx, ratio = detect_skew(counts)
    skewed = ratio > skew_ratio
    if skewed:
        key, val, live = _pre_combine(mesh, key, val, live)
        mx, _r = detect_skew(lane_counts(mesh, key, live))
    lane_cap = capacity_for(max(int(mx), 1))
    k, s, lv = dist_group_sum(mesh, key, val, live, lane_cap)
    return k, s, lv, {"skewed": skewed, "ratio": ratio,
                      "lane_cap": lane_cap, "max_lane": int(mx)}
