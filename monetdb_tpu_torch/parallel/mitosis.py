"""Row-partitioned SPMD execution (mitosis analog).

The reference splits a query into #threads row-range pieces
(opt_mitosis.c:150-190 picks the piece count), replicates the plan per piece
(opt_mergetable.c), runs pieces on a worker pool (mal_dataflow.c:247), and
concatenates with mat.pack (modules/mal/mat.c:124). Grouped aggregates run
two-phase: per-piece partials + a combine step (opt_mergetable.c:15-27,
BATgroupavg3combine gdk/gdk_aggr.c:2634).

Here: a 1-D row mesh (``parallel/mesh.py``: one thread per shard, or one
or more shards per process, ``parallel/dist.py``); on a thread mesh a
row-sharded column is one tensor padded to a multiple of the shard count,
which every shard sees a slice of, and on a process mesh each process holds
the slices of its own shards; the combine step is the mesh's ``psum``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..bench.kernels import q1_step, q6_step
from ..ops.cuda_kernels import seg_sum64
# AXIS is re-exported
from .mesh import AXIS, RowMesh, home_device, run_shards  # noqa: F401

__all__ = ["row_mesh", "shard_array", "two_phase_sum", "sharded_q1",
           "sharded_q6", "default_mesh"]


def row_mesh(devices=None) -> RowMesh:
    """A row mesh over ``devices`` (any torch device specs, repeats
    allowed); None means every visible CUDA device, and raises when there
    is none."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("row_mesh(): no CUDA device is visible; "
                               "pass the devices, e.g. ['cpu'] * 8")
        devices = [torch.device("cuda", i) for i in range(n)]
    return RowMesh(devices)


_DEFAULT_MESH: list = []  # [RowMesh | None] once resolved


def default_mesh() -> Optional[RowMesh]:
    """The session-default mesh: None unless config ``spmd_auto_mesh`` is
    on; then a row mesh over all visible CUDA devices when more than one is
    present, else None.  Sessions pass this to every Engine they build.
    The reference turns it on by default (mitosis sits in every session's
    default_pipe, opt_pipes.c:76); the port does not: on four H100s the
    thread mesh ran the 22 TPC-H queries a median 9.96x slower than one
    card (bench/mesh_cards.py).  ``Session(db, mesh=...)`` or
    ``spmd_auto_mesh=1`` turn it on."""
    from .. import config
    if not config.get("spmd_auto_mesh"):
        return None
    if not _DEFAULT_MESH:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _DEFAULT_MESH.append(row_mesh() if n > 1 else None)
    return _DEFAULT_MESH[0]


def shard_array(arr, mesh, fill=0) -> torch.Tensor:
    """Pad the global array ``arr`` to a multiple of the mesh size with
    ``fill``.  On a thread mesh: the whole, placed on the mesh's first
    device (every shard of a one-device mesh reads a view of it;
    ``run_shards`` copies the pieces of a multi-device mesh).  On a process
    mesh, where every process holds the same global array: the pieces of
    this process's shards, end to end (rows [p * K * c, (p + 1) * K * c)
    of the padded array for process p of K shards, c rows a shard), on its
    first device."""
    t = torch.as_tensor(np.asarray(arr)) if not isinstance(
        arr, torch.Tensor) else arr
    n = mesh.size
    k = -(-t.shape[0] // n)
    if not isinstance(mesh, RowMesh):
        lo = mesh.shards[0] * k
        t = t[lo:lo + mesh.local * k]
        want = k * mesh.local
    else:
        want = k * n
    t = t.to(home_device(mesh))
    if want != t.shape[0]:
        t = torch.cat([t, torch.full((want - t.shape[0],), fill,
                                     dtype=t.dtype, device=t.device)])
    return t


def _replicated(x, dev) -> torch.Tensor:
    return x.to(dev) if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x), device=dev)


def two_phase_sum(mesh, vals: torch.Tensor, keys: torch.Tensor,
                  mask: torch.Tensor, domain: int) -> torch.Tensor:
    """Grouped sum over row-sharded inputs: shard-local segment-sum, then
    psum across the mesh (the mat_grp two-phase aggregation).  Integer
    values sum exactly through ``seg_sum64``; float values scatter-add."""

    def step(ins, coll):
        v, k, m = ins
        sid = torch.where(m, k.to(torch.int32), domain)
        if v.dtype.is_floating_point:
            idx = torch.where((sid >= 0) & (sid < domain), sid, domain).long()
            part = torch.zeros(domain + 1, dtype=v.dtype,
                               device=v.device).index_add_(0, idx, v)[:domain]
        else:
            part = seg_sum64(sid, v.contiguous(), domain=domain)[0].to(
                v.dtype)
        return coll.psum(part)

    return run_shards(mesh, step, (vals, keys, mask), (True,) * 3)[0]


# ---------------------------------------------------------------------------
# fused sharded query fragments (flagship pipelines; also the bench kernels)
# ---------------------------------------------------------------------------


def sharded_q6(mesh):
    """TPC-H Q6 as one SPMD program: scan-filter + masked sum-reduce per
    shard (``bench.kernels.q6_step``), psum-combined.  Returns a function
    over the four row-sharded columns and five scalars."""

    def run(shipdate, disc, qty, extp, lo, hi, dlo, dhi, qmax):
        dev = home_device(mesh)
        scal = [_replicated(x, dev) for x in (lo, hi, dlo, dhi, qmax)]

        def step(ins, coll):
            return coll.psum(q6_step(*ins))

        return run_shards(mesh, step, (shipdate, disc, qty, extp, *scal),
                          (True,) * 4 + (False,) * 5)[0]

    return run


def sharded_q1(mesh, domain: int = 8):
    """TPC-H Q1 as one SPMD program: filter + dense-domain grouped
    aggregation per shard (``bench.kernels.q1_step``: the hand-written
    ``q1_grouped_sums`` on int32 CUDA columns), psum-combined.

    Inputs: per-row group code (returnflag·nls + linestatus, precomputed by
    the dictionary encoder), measure columns, cutoff. Outputs: per-group
    sum_qty, sum_base, sum_disc_price, sum_charge, sum_disc, count — the
    exact partials the avg columns derive from (BATgroupavg3 decomposition,
    gdk/gdk_aggr.c:1996)."""

    def run(code, shipdate, qty, extp, disc, tax, cutoff):
        cut = int(cutoff)

        def step(ins, coll):
            return coll.psum(tuple(q1_step(*ins, cut, domain=domain)))

        return run_shards(mesh, step, (code, shipdate, qty, extp, disc, tax),
                          (True,) * 6)[0]

    return run

