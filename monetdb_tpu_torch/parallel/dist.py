"""A row mesh of processes: one process per rank of ``torch.distributed``,
each holding one shard or several (one per local device), its collectives
through ``torch.distributed`` - the counterpart of ``jax.distributed`` as
the reference package's multi-process test uses it (tests/test_multihost.py:
2 processes x 4 devices, one global mesh of 8).

    mesh = initialize("10.0.0.1:29500", num_processes=4, process_id=r)
    key = shard_array(global_keys, mesh)      # this rank's rows, on its card
    k2, (v2,), live2 = shuffle(mesh, key, [val], live, lane_cap)

    # two processes of two cards each: a mesh of four shards
    mesh = initialize(addr, 2, p, devices=["cuda:0", "cuda:1"])

A mesh of P processes with K local devices each has P * K shards; global
shard g = p * K + l is local shard l of process p, on its l-th device.
Every process runs the same program over the same global arrays (made
from one seed, or read from one source); ``parallel/`` functions handed a
``ProcessMesh`` run this process's K shards (inline when K is 1, one thread
each otherwise, as the thread mesh runs its shards) and return its piece of
a row-sharded result (rows [p * K * c, (p + 1) * K * c) of the padded
global array, c rows a shard), and the whole of a replicated one, bit-equal
on every shard.  Only the parallel primitives run across processes:
``Engine`` and ``Session`` take a thread mesh (``RowMesh``) alone, as the
reference's SQL path reads every shard from one controller.

Backends: ``nccl`` between cards (the default on a CUDA device), ``gloo``
on the CPU (the default there).  ``gloo`` on a CUDA device is taken only
when the caller asks for it: it stages every collective through pinned
host memory (the compute stays on the card), and says so in its ``repr``.
It lets two processes share one card, which NCCL refuses.  A failed NCCL
initialisation raises; nothing falls back to gloo.

``DistCollectives`` has the semantics of the thread mesh's collectives
(``mesh.Collectives``), including one exchange for a whole list:

* a list of tensors of any dtypes (bool included) is packed into one uint8
  buffer, and ``all_gather`` / ``all_to_all`` move that buffer in one
  collective;
* ``psum`` / ``pmax`` / ``pmin`` are an ``all_gather`` and the thread
  mesh's combination in rank order on every shard, so a float sum is
  bit-equal to the thread mesh's (a ring ``all_reduce`` adds in another
  order);
* before the data moves, the processes exchange a fixed-size header per
  shard (payload bytes and a digest of the shapes and dtypes) on a gloo
  group, on the host.  Tensors of different shapes would make NCCL wait
  forever; here every shard raises ``MeshError`` naming both shapes
  instead.

With several shards a process, one collective has two levels.  The local
shards deposit their lists and meet at a barrier (the thread mesh's
``_Group``); the first local shard, the process's leader, alone calls
``torch.distributed`` (a process group takes one caller at a time, and
every process must post the same collectives in the same order): the
header of all K lists, then one exchange of the K lists packed into one
buffer on the process's first device, the one the NCCL communicator is
bound to; a second barrier hands the result out.  Local shards' pieces
never cross the process group: ``_swap`` hands them over by reference,
and ``all_to_all`` sends each other process only the K x K chunks meant
for its shards (one ``all_to_all_single``) and moves the chunks between
local shards by reference, or by a peer copy between local cards.

A shard that raises ends its process: its local barrier breaks, so its
leader never enters a collective with the other processes, and the others
fail at their next header exchange (gloo reports the closed connection)
or at the group's timeout (``initialize(timeout=...)``, by default
``mesh.BARRIER_TIMEOUT_S``).
"""

from __future__ import annotations

import datetime
import hashlib
import math
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from .mesh import AXIS, BARRIER_TIMEOUT_S, Collectives, MeshError, _tree

__all__ = ["initialize", "process_index", "process_count", "shutdown",
           "ProcessMesh", "DistCollectives"]

#: bytes each packed tensor is aligned to, so that it views as any dtype
_ALIGN = 16
#: header fields: payload bytes, spec bytes, spec digest
_HEADER = 3


class ProcessMesh:
    """This process's view of a row mesh of ``processes`` processes with
    one shard per local device each: its ``rank`` among the processes, its
    ``devices`` (``device`` is the first, where the process's row-sharded
    tensors and the NCCL communicator live), ``local`` shards, ``size`` =
    processes x local shards in all, and ``shards``, the global ranks of
    its own.  Hashable; ``axis_names``, ``size`` and ``shape`` as a
    ``RowMesh`` has them."""

    axis_names = (AXIS,)

    def __init__(self, processes: int, rank: int, devices, backend: str,
                 host_group=None, timeout: float = BARRIER_TIMEOUT_S):
        if not isinstance(devices, (list, tuple)):
            devices = [devices]
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a process mesh needs at least one device")
        self.processes = processes
        self.rank = rank
        self.local = len(self.devices)
        self.size = processes * self.local
        self.device = self.devices[0]
        self.backend = backend
        self.timeout = timeout
        # the gloo group the headers travel on (the default group's, or
        # one of its own beside NCCL)
        self._host_group = host_group

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    @property
    def shards(self) -> range:
        """The global ranks of this process's shards."""
        return range(self.rank * self.local, (self.rank + 1) * self.local)

    @property
    def staged(self) -> bool:
        """gloo on a CUDA device: every collective goes through host
        memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def collectives(self, group=None) -> List["DistCollectives"]:
        """One ``DistCollectives`` per local shard; with several, they
        share ``group`` (``mesh._Group`` of ``local`` threads)."""
        return [DistCollectives(self, i, group) for i in range(self.local)]

    def per_process(self) -> "ProcessMesh":
        """The mesh of one shard per process (this process's first device)
        over the same process group."""
        return ProcessMesh(self.processes, self.rank, self.device,
                           self.backend, self._host_group, self.timeout)

    def barrier(self) -> None:
        """Wait on the host until every process has come here."""
        dist.barrier(group=self._host_group)

    def _key(self):
        return (self.processes, self.rank, self.devices, self.backend)

    def __eq__(self, other) -> bool:
        return isinstance(other, ProcessMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(("ProcessMesh",) + self._key())

    def __repr__(self) -> str:
        staged = ", host-staged" if self.staged else ""
        if self.local == 1:
            return (f"ProcessMesh(rank {self.rank} of {self.size}, "
                    f"{self.device}, {self.backend}{staged})")
        devs = (f"{self.device} x{self.local}"
                if len(set(self.devices)) == 1
                else ", ".join(map(str, self.devices)))
        return (f"ProcessMesh(rank {self.rank} of {self.processes}, shards "
                f"{self.shards[0]}-{self.shards[-1]} of {self.size} on "
                f"{devs}, {self.backend}{staged})")


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, device=None, devices=None,
               backend: Optional[str] = None,
               timeout: Optional[float] = None) -> ProcessMesh:
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``; ``coordinator_address`` is ``host:port`` of rank 0's
    store.  The process holds one shard on ``device`` (default
    ``cuda:<process_id mod visible cards>``; raises without a card: the CPU
    only when asked, ``device="cpu"``), or one shard on each of
    ``devices``, a list of this process's devices (every process must give
    as many).  ``backend`` defaults to ``nccl`` on a CUDA device and
    ``gloo`` on the CPU.  ``timeout`` (seconds) bounds every collective's
    wait."""
    if dist.is_initialized():
        raise RuntimeError("parallel.dist: this process has joined a "
                           "process group already (call shutdown() first)")
    if devices is not None:
        if device is not None:
            raise ValueError("parallel.dist.initialize: give device or "
                             "devices, not both")
        devices = [torch.device(d) for d in devices]
        if not devices or len({d.type for d in devices}) != 1:
            raise ValueError(f"parallel.dist: devices {devices} must be "
                             f"one or more of one type")
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d
                   for d in devices]
    else:
        if device is None or torch.device(device) == torch.device("cuda"):
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError("parallel.dist.initialize: no CUDA device "
                                   "is visible; pass device='cpu' for the "
                                   "CPU")
            device = torch.device("cuda", process_id % n)
        devices = [torch.device(device)]
    device = devices[0]
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo") or (
            backend == "nccl" and device.type != "cuda"):
        raise ValueError(f"parallel.dist: backend {backend!r} on {device}")
    secs = BARRIER_TIMEOUT_S if timeout is None else timeout
    wait = datetime.timedelta(seconds=secs)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device    # NCCL connects now, or raises now
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=wait, **kw)
    host = (dist.group.WORLD if backend == "gloo"
            else dist.new_group(backend="gloo", timeout=wait))
    return ProcessMesh(num_processes, process_id, devices, backend, host,
                       secs)


def process_index() -> int:
    return dist.get_rank()


def process_count() -> int:
    return dist.get_world_size()


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _spec(xs) -> bytes:
    return repr([(str(t.dtype)[6:], tuple(t.shape)) for t in xs]).encode()


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    # all_gather_single replaces all_gather_into_tensor in newer torch
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _chunk_bytes(t: torch.Tensor, d: int) -> int:
    """Bytes of one of the ``d`` chunks of axis 0 of ``t``."""
    return (t.shape[0] // d) * math.prod(t.shape[1:]) * t.element_size()


def _unpack(row: torch.Tensor, like: list) -> list:
    """The tensors of one packed list (shapes and dtypes of ``like``)."""
    at, out = 0, []
    for t in like:
        n = t.numel() * t.element_size()
        out.append(row[at:at + n].view(t.dtype).reshape(t.shape))
        at += _aligned(n)
    return out


class DistCollectives(Collectives):
    """The collectives of local shard ``local`` of this process's shards of
    a ``ProcessMesh`` call (module docstring); ``group`` is what the local
    shards share when there are several."""

    def __init__(self, mesh: ProcessMesh, local: int = 0, group=None):
        super().__init__(mesh.shards[local], mesh.size, mesh.devices[local])
        self._mesh = mesh
        self._local = local
        self._group = group

    # -- the two levels: local deposit, one process-level call ---------------

    def _round(self, xs: list, lead: Callable[[list], object]):
        """``lead`` of every local shard's ``xs`` (in local rank order),
        called once, by the leader; its result, or the MeshError it
        raised, on every local shard.  Any other error the leader meets
        propagates from the leader alone (``run_shards`` then breaks the
        local barrier)."""
        group = self._group
        if group is None:
            return lead([xs])
        row = group.slots[(self._gen - 1) % 2]
        row[self._local] = xs
        group.barrier.wait()
        if self._local == 0:
            try:
                group.result = lead(list(row))
            except MeshError as ex:
                group.result = ex
        group.barrier.wait()
        got = group.result
        if isinstance(got, MeshError):
            raise MeshError(str(got))
        return got

    # -- host side: the header every shard checks before the data moves ----

    def _agree(self, lists: list) -> int:
        """Exchange (payload bytes, spec) of every local list with every
        process on the host; returns the payload bytes of one list, equal
        on every shard, or raises MeshError on every shard."""
        mesh = self._mesh
        k = len(lists)
        specs = [_spec(xs) for xs in lists]
        head = torch.tensor(
            [[sum(_aligned(t.numel() * t.element_size()) for t in xs),
              len(sp), int.from_bytes(hashlib.blake2b(
                  sp, digest_size=7).digest(), "little")]
             for xs, sp in zip(lists, specs)], dtype=torch.int64)
        heads = torch.empty(mesh.processes * k * _HEADER, dtype=torch.int64)
        _all_gather(heads, head.reshape(-1), mesh._host_group)
        heads = heads.view(mesh.size, _HEADER)
        if bool((heads == heads[0]).all()):
            return int(heads[0, 0])
        # tell every shard what each handed over, then all raise alike
        width = int(heads[:, 1].max())
        mine = torch.zeros(k, width, dtype=torch.uint8)
        for i, sp in enumerate(specs):
            mine[i, :len(sp)] = torch.frombuffer(bytearray(sp),
                                                 dtype=torch.uint8)
        every = torch.empty(mesh.size * width, dtype=torch.uint8)
        _all_gather(every, mine.reshape(-1), mesh._host_group)
        every = [bytes(every[g * width:(g + 1) * width].tolist())
                 .rstrip(b"\0").decode() for g in range(mesh.size)]
        other = next(g for g in range(mesh.size) if every[g] != every[0])
        raise MeshError(f"one collective got tensors of different shapes: "
                        f"rank 0 {every[0]}, rank {other} {every[other]}")

    # -- the data: one packed buffer a collective ----------------------------

    def _buffer(self, n: int) -> torch.Tensor:
        """A receive buffer of ``n`` bytes: pinned host memory when
        staged."""
        if self._mesh.staged:
            return torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return torch.empty(n, dtype=torch.uint8, device=self._mesh.device)

    def _sent(self, t: torch.Tensor) -> torch.Tensor:
        """A send buffer as the backend takes it: a host copy when
        staged."""
        if not self._mesh.staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self._mesh.device, non_blocking=True) \
            if self._mesh.staged else t

    def _gather(self, lists: list) -> List[list]:
        """The leader's part of ``_swap``: every shard's list in global
        rank order; this process's own by reference."""
        mesh = self._mesh
        payload = self._agree(lists)
        like = lists[0]
        if payload == 0:                # empty tensors of equal shapes
            got = None
        else:
            buf = torch.zeros(len(lists), payload, dtype=torch.uint8,
                              device=mesh.device)
            for i, xs in enumerate(lists):
                at = 0
                for t in xs:
                    b = _bytes_of(t)
                    buf[i, at:at + b.numel()] = b
                    at += _aligned(b.numel())
            got = self._buffer(mesh.size * payload)
            _all_gather(got, self._sent(buf.reshape(-1)))
            got = self._back(got).view(mesh.size, payload)
        first = mesh.shards[0]
        return [lists[g - first] if g in mesh.shards
                else [t.clone() for t in like] if got is None
                else _unpack(got[g], like) for g in range(mesh.size)]

    def _swap(self, xs: list) -> List[list]:
        return self._round(xs, self._gather)

    def _scatter(self, lists: list):
        """The leader's part of ``all_to_all``: the local lists, and what
        the other processes sent this one, [processes - 1, local (sender),
        local (receiver), bytes] (None when nothing crosses)."""
        mesh = self._mesh
        self._agree(lists)
        p, k, d = mesh.processes, mesh.local, mesh.size
        others = [q for q in range(p) if q != mesh.rank]
        w = sum(_aligned(_chunk_bytes(t, d)) for t in lists[0])
        if not others or w == 0:
            return lists, None
        send = torch.zeros(len(others), k, k, w, dtype=torch.uint8,
                           device=mesh.device)
        for src, xs in enumerate(lists):
            at = 0
            for t in xs:
                c = _chunk_bytes(t, d)
                # chunk j of t goes to shard j = process q, local m; only
                # the other processes' chunks leave the local shard's card
                chunks = _bytes_of(t[:(t.shape[0] // d) * d]).view(p, k, c)
                send[:, src, :, at:at + c] = chunks[others]
                at += _aligned(c)
        recv = self._buffer(send.numel())
        split = [0 if q == mesh.rank else k * k * w for q in range(p)]
        dist.all_to_all_single(recv, self._sent(send.reshape(-1)),
                               output_split_sizes=split,
                               input_split_sizes=split)
        return lists, self._back(recv).view(len(others), k, k, w)

    def all_to_all(self, x):
        """As the thread mesh's: chunk j of axis 0 of every tensor goes to
        shard j; one ``all_to_all_single`` among the processes for the
        whole list."""
        flat, rebuild = _tree(x)
        self._note(flat)
        lists, recv = self._round(flat, self._scatter)
        mesh = self._mesh
        d, k = mesh.size, mesh.local
        first = mesh.shards[0]
        out, at = [], 0
        for i, t in enumerate(flat):
            rows = t.shape[0] // d
            shape = (rows,) + tuple(t.shape[1:])
            c = _chunk_bytes(t, d)
            lo = self.rank * rows
            parts = []
            for g in range(d):
                if g in mesh.shards:
                    parts.append(self._here(lists[g - first][i][lo:lo + rows]))
                elif recv is None:      # no byte crosses
                    parts.append(t.new_empty(shape, device=self.device))
                else:
                    q = g // k
                    j = q - (q > mesh.rank)
                    parts.append(self._here(
                        recv[j, g % k, self._local, at:at + c]
                        .view(t.dtype).reshape(shape)))
            out.append(torch.cat(parts))
            at += _aligned(c)
        return rebuild(out)
