"""A 1-D row mesh of shards: threads in one process, or one rank per process.

The counterpart of ``jax.sharding.Mesh`` + ``shard_map`` + the ``lax``
collectives the reference package uses (``psum``, ``pmax``, ``pmin``,
``all_gather``, ``all_to_all``, ``axis_index``).  A mesh is one of two
kinds:

* ``RowMesh`` (here): one process holds the whole mesh, one Python thread
  per shard, as one JAX process holds its mesh.  ``Engine(cat, mesh=...)``
  and ``Session(db, mesh=...)`` keep their single-controller API.  A
  mesh's devices may repeat (``[cuda:0] * 8`` runs eight shards on one
  card, and ``["cpu"] * 8`` is the CPU tests' stand-in for the reference's
  eight virtual devices).
* ``dist.ProcessMesh`` (``parallel/dist.py``): one or more shards per
  process (one per local device), the collectives through
  ``torch.distributed`` (NCCL between cards, gloo on the CPU), as under
  ``jax.distributed``.  A process sees only its own shards, as a JAX
  process sees only its addressable shards.

``run_shards(mesh, fn, inputs, shard_flags)`` runs ``fn(shard_inputs,
coll)`` once per shard and returns the per-shard outputs in rank order.  On
a ``RowMesh`` it splits the row-sharded inputs (views of one tensor where a
shard shares its device, copies otherwise), passes the replicated ones
through (copied to a shard on another device) and runs each shard on a
thread of its own.  On a ``ProcessMesh`` every input is already this
process's (its rows of a sharded input, the whole of a replicated one); a
process with one shard runs it inline, on the caller's thread, over its
inputs moved to its device, and the result is a one-element list; a
process with several shards splits its rows across its devices and runs
each of its shards on a thread, as a ``RowMesh`` does, and returns their
outputs in local rank order.

``coll`` (``Collectives``) gives a shard its ``rank`` and the collectives.
Each takes one tensor or a list / tuple of tensors (one exchange for the
whole list) and returns the same structure.  Every collective combines in
rank order and every shard computes the combination itself, so replicated
outputs are bit-equal across shards (what ``assert_props`` checks), and
bit-equal between the two kinds of mesh.  Collective inputs of a thread
mesh are shared by reference: a shard must not write into a tensor after
handing it to a collective.

On a ``RowMesh`` (and among the local shards of a ``ProcessMesh``) a
shard that raises aborts the barrier: the other shards stop at their next
collective, and the caller gets the first exception that is not a broken
barrier.  A barrier that waits longer than
``BARRIER_TIMEOUT_S`` breaks as well, so a deadlock fails the call instead
of hanging it.  (A ``ProcessMesh`` gives ``torch.distributed`` the same
timeout; see ``dist.py``.)

``STATS`` counts, over all mesh calls of this process, the calls, the
collectives of one shard and the bytes this process's shards handed to
collectives.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Sequence

import torch

__all__ = ["AXIS", "RowMesh", "Collectives", "MeshError", "run_shards",
           "home_device", "BARRIER_TIMEOUT_S", "STATS"]

AXIS = "rows"

#: seconds a shard waits at one collective for the others before the mesh
#: call fails (a missed collective is a bug; this turns it into an error)
BARRIER_TIMEOUT_S = 120.0

#: mesh calls, collectives (of one shard) and bytes handed to collectives
#: (by all of this process's shards) since the process started; guarded by
#: _STATS_LOCK
STATS = {"calls": 0, "collectives": 0, "bytes": 0}
_STATS_LOCK = threading.Lock()


class MeshError(RuntimeError):
    """A mesh call broke down without a shard raising an error of its own
    (a collective timed out, or the shards handed one collective tensors of
    different shapes)."""


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``, so that a mesh device equals
    the device of the tensors made on it."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class RowMesh:
    """A hashable 1-D mesh over ``devices`` with the one axis ``"rows"``."""

    axis_names = (AXIS,)

    def __init__(self, devices: Sequence):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a row mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {AXIS: len(self.devices)}

    def __eq__(self, other) -> bool:
        return isinstance(other, RowMesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(("RowMesh", self.devices))

    def __repr__(self) -> str:
        return f"RowMesh({[str(d) for d in self.devices]})"


class _Group:
    """What the shards of one mesh call share: the barrier and two rows of
    deposit slots, used in turn (a shard can only overwrite a row after
    every shard has passed the next barrier, that is, after all of them
    took their references out of it)."""

    def __init__(self, n: int, timeout: float):
        self.n = n
        self.timeout = timeout
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = [[None] * n, [None] * n]
        self.lock = threading.Lock()
        self.errors: list = []          # in the order the shards raised
        # what a process mesh's leader hands its local shards (dist.py)
        self.result = None


def _tree(x):
    """(flat list of tensors, rebuild function) of a tensor or a
    list / tuple of tensors."""
    if isinstance(x, (list, tuple)):
        kind = type(x)
        return list(x), (lambda ys: kind(ys))
    return [x], (lambda ys: ys[0])


class Collectives:
    """The collectives of one shard of a mesh call (see module docstring).
    A kind of mesh supplies ``_swap``; the counting and the rank-order
    combinations are shared."""

    def __init__(self, rank: int, size: int, device: torch.device):
        self._gen = 0                   # collectives so far
        self.sent = 0                   # bytes handed to collectives
        self.rank = rank
        self.size = size
        self.device = device

    def _swap(self, xs: list) -> List[list]:
        """Every shard's ``xs`` in rank order, on this shard's device or
        shared by reference (one exchange; the kind of mesh's own)."""
        raise NotImplementedError

    def _note(self, xs: list) -> None:
        self._gen += 1
        self.sent += sum(t.numel() * t.element_size() for t in xs)

    def _exchange(self, xs: list) -> List[list]:
        self._note(xs)
        return self._swap(xs)

    def _here(self, t: torch.Tensor) -> torch.Tensor:
        return t if t.device == self.device else t.to(self.device)

    def _combine(self, x, op: Callable):
        flat, rebuild = _tree(x)
        got = self._exchange(flat)
        return rebuild([op([self._here(g[i]) for g in got])
                        for i in range(len(flat))])

    @staticmethod
    def _sum(parts):
        if parts[0].dtype.is_floating_point:
            # floats add one shard after another, in rank order
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            return acc
        # an integer sum is exact in any order (it wraps like the adds)
        return torch.stack(parts).sum(0, dtype=parts[0].dtype)

    def psum(self, x):
        return self._combine(x, self._sum)

    def pmax(self, x):
        return self._combine(x, lambda ps: torch.stack(ps).amax(0))

    def pmin(self, x):
        return self._combine(x, lambda ps: torch.stack(ps).amin(0))

    def all_gather(self, x):
        """Every shard's tensor concatenated along axis 0 in rank order
        (``tiled=True``; 0-d tensors stack into a vector)."""
        return self._combine(
            x, lambda ps: torch.cat(ps) if ps[0].dim() else torch.stack(ps))

    def all_to_all(self, x):
        """Axis 0 of each shard's tensor split into ``size`` equal chunks;
        chunk j goes to shard j, which concatenates what it receives along
        axis 0 in rank order (``split_axis=0, concat_axis=0,
        tiled=True``)."""
        flat, rebuild = _tree(x)
        got = self._exchange(flat)
        out = []
        for i, t in enumerate(flat):
            k = t.shape[0] // self.size
            lo = self.rank * k
            out.append(torch.cat([self._here(g[i][lo:lo + k]) for g in got]))
        return rebuild(out)


class _ThreadCollectives(Collectives):
    """A shard of a ``RowMesh`` call: a deposit in the shared slots and one
    barrier."""

    def __init__(self, group: _Group, rank: int, device: torch.device):
        super().__init__(rank, group.n, device)
        self._group = group

    def _swap(self, xs: list) -> List[list]:
        row = self._group.slots[(self._gen - 1) % 2]
        row[self.rank] = xs
        self._group.barrier.wait()
        return list(row)


def _split(t: torch.Tensor, n: int, devices) -> list:
    if t.dim() == 0 or t.shape[0] % n:
        raise ValueError(f"a row-sharded input of shape {tuple(t.shape)} "
                         f"does not split into {n} equal shards")
    k = t.shape[0] // n
    return [t[r * k:(r + 1) * k] if devices[r] == t.device
            else t[r * k:(r + 1) * k].to(devices[r]) for r in range(n)]


def home_device(mesh) -> torch.device:
    """Where a row-sharded tensor of ``mesh`` lives: the mesh's first
    device (a thread mesh's: every shard reads its slice), a process
    mesh's first local device (the process's rows only)."""
    return mesh.devices[0]


def _count(colls) -> None:
    with _STATS_LOCK:
        STATS["calls"] += 1
        STATS["collectives"] += colls[0]._gen
        STATS["bytes"] += sum(c.sent for c in colls)


def _run_here(mesh, fn: Callable, inputs: Sequence[torch.Tensor]) -> list:
    """The one shard of a process of a process mesh, on the caller's
    thread."""
    dev = mesh.device
    coll, = mesh.collectives()
    ins = [t if t.device == dev else t.to(dev) for t in inputs]
    try:
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return [fn(ins, coll)]
        return [fn(ins, coll)]
    finally:
        _count([coll])


def run_shards(mesh, fn: Callable, inputs: Sequence[torch.Tensor],
               shard_flags: Sequence[bool]) -> list:
    """Run ``fn(shard_inputs, coll)`` once per shard of ``mesh``; returns
    the outputs in rank order.  On a ``RowMesh`` each shard runs on a
    thread of its own, and ``shard_flags[i]`` says whether input i is split
    by rows (its length must divide by the mesh size) or given whole to
    every shard.  On a process mesh (``dist.ProcessMesh``) only this
    process's shards run, over inputs that are already its own: one shard
    on the caller's thread (``shard_flags`` is not needed to split them),
    and the list holds its output alone; several shards as on a
    ``RowMesh`` over the process's devices (the sharded inputs split into
    as many pieces), and the list holds their outputs in local rank
    order."""
    devs = mesh.devices
    n = len(devs)
    if not isinstance(mesh, RowMesh) and n == 1:
        return _run_here(mesh, fn, inputs)
    per = [[] for _ in range(n)]
    for t, sharded in zip(inputs, shard_flags):
        if sharded:
            for r, piece in enumerate(_split(t, n, devs)):
                per[r].append(piece)
        else:
            for r in range(n):
                per[r].append(t if t.device == devs[r] else t.to(devs[r]))
    if isinstance(mesh, RowMesh):
        group = _Group(n, BARRIER_TIMEOUT_S)
        colls = [_ThreadCollectives(group, r, devs[r]) for r in range(n)]
    else:
        # the leader waits on the other processes for up to the process
        # group's own timeout while its local shards wait at the barrier
        group = _Group(n, mesh.timeout + BARRIER_TIMEOUT_S)
        colls = mesh.collectives(group)
    outs = [None] * n

    def shard(r: int) -> None:
        coll = colls[r]
        try:
            if devs[r].type == "cuda":
                with torch.cuda.device(devs[r]):
                    outs[r] = fn(per[r], coll)
            else:
                outs[r] = fn(per[r], coll)
        except BaseException as ex:     # noqa: BLE001 - handed to caller
            with group.lock:
                group.errors.append(ex)
            group.barrier.abort()

    threads = [threading.Thread(target=shard, args=(r,), daemon=True,
                                name=f"mesh-shard-{colls[r].rank}")
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _count(colls)
    for ex in group.errors:
        if not isinstance(ex, threading.BrokenBarrierError):
            raise ex
    if group.errors:
        raise MeshError(f"a mesh collective waited longer than "
                        f"{group.timeout} s")
    return outs
