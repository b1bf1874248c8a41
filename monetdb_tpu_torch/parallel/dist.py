"""A row mesh of processes: one rank per process, one process per card, its
collectives through ``torch.distributed`` - the counterpart of
``jax.distributed`` as the reference package's multi-process test uses it
(tests/test_multihost.py).

    mesh = initialize("10.0.0.1:29500", num_processes=4, process_id=r)
    key = shard_array(global_keys, mesh)      # this rank's rows, on its card
    k2, (v2,), live2 = shuffle(mesh, key, [val], live, lane_cap)

Every process runs the same program over the same global arrays (made
from one seed, or read from one source); ``parallel/`` functions handed a
``ProcessMesh`` run this rank's shard and return its piece of a
row-sharded result (``run_shards`` returns a one-element list), and the
whole of a replicated one, bit-equal on every rank.  Only the parallel
primitives run across processes: ``Engine`` and ``Session`` take a thread
mesh (``RowMesh``) alone, as the reference's SQL path reads every shard
from one controller.

Backends: ``nccl`` between cards (the default on a CUDA device), ``gloo``
on the CPU (the default there).  ``gloo`` on a CUDA device is taken only
when the caller asks for it: it stages every collective through pinned
host memory (the compute stays on the card), and says so in its ``repr``.
It lets two ranks share one card, which NCCL refuses.  A failed NCCL
initialisation raises; nothing falls back to gloo.

``DistCollectives`` has the semantics of the thread mesh's collectives
(``mesh.Collectives``), including one exchange for a whole list:

* a list of tensors of any dtypes (bool included) is packed into one uint8
  buffer, and ``all_gather`` / ``all_to_all`` move that buffer in one
  collective;
* ``psum`` / ``pmax`` / ``pmin`` are an ``all_gather`` and the thread
  mesh's combination in rank order on every rank, so a float sum is
  bit-equal to the thread mesh's (a ring ``all_reduce`` adds in another
  order);
* before the data moves, the ranks exchange a fixed-size header (payload
  bytes and a digest of the shapes and dtypes) on a gloo group, on the
  host.  Tensors of different shapes would make NCCL wait forever; here
  every rank raises ``MeshError`` naming both shapes instead.

A rank that raises ends its process; the others fail at their next
collective (gloo reports the closed connection) or at the group's timeout
(``initialize(timeout=...)``, by default ``mesh.BARRIER_TIMEOUT_S``).
"""

from __future__ import annotations

import datetime
import hashlib
from typing import List, Optional

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
    """This process's view of a row mesh of ``size`` processes: its
    ``rank`` and ``device``.  Hashable; ``axis_names``, ``size`` and
    ``shape`` as a ``RowMesh`` has them."""

    axis_names = (AXIS,)

    def __init__(self, size: int, rank: int, device, backend: str,
                 host_group=None):
        self.size = size
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        # the gloo group the headers travel on (the default group's, or
        # one of its own beside NCCL)
        self._host_group = host_group

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    @property
    def staged(self) -> bool:
        """gloo on a CUDA device: every collective goes through host
        memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def collectives(self) -> "DistCollectives":
        return DistCollectives(self)

    def barrier(self) -> None:
        """Wait on the host until every rank has come here."""
        dist.barrier(group=self._host_group)

    def _key(self):
        return (self.size, self.rank, self.device, self.backend)

    def __eq__(self, other) -> bool:
        return isinstance(other, ProcessMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(("ProcessMesh",) + self._key())

    def __repr__(self) -> str:
        staged = ", host-staged" if self.staged else ""
        return (f"ProcessMesh(rank {self.rank} of {self.size}, "
                f"{self.device}, {self.backend}{staged})")


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, device=None, backend: Optional[str] = None,
               timeout: Optional[float] = None) -> ProcessMesh:
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``; ``coordinator_address`` is ``host:port`` of rank 0's
    store.  ``device`` defaults to ``cuda:<process_id mod visible cards>``
    (raises without a card: the CPU only when asked, ``device="cpu"``);
    ``backend`` to ``nccl`` on a CUDA device and ``gloo`` on the CPU.
    ``timeout`` (seconds) bounds every collective's wait."""
    if dist.is_initialized():
        raise RuntimeError("parallel.dist: this process has joined a "
                           "process group already (call shutdown() first)")
    if device is None or torch.device(device) == torch.device("cuda"):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("parallel.dist.initialize: no CUDA device is "
                               "visible; pass device='cpu' for the CPU")
        device = torch.device("cuda", process_id % n)
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo") or (
            backend == "nccl" and device.type != "cuda"):
        raise ValueError(f"parallel.dist: backend {backend!r} on {device}")
    wait = datetime.timedelta(
        seconds=BARRIER_TIMEOUT_S if timeout is None else timeout)
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
    return ProcessMesh(num_processes, process_id, device, backend, host)


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


class DistCollectives(Collectives):
    """The collectives of this process's shard of a ``ProcessMesh`` call
    (module docstring)."""

    def __init__(self, mesh: ProcessMesh):
        super().__init__(mesh.rank, mesh.size, mesh.device)
        self._mesh = mesh

    # -- host side: the header every rank checks before the data moves ----

    def _agree(self, xs: list) -> int:
        """Exchange (payload bytes, spec) with every rank on the host;
        returns the payload bytes, equal on every rank, or raises
        MeshError on every rank."""
        spec = _spec(xs)
        payload = sum(_aligned(t.numel() * t.element_size()) for t in xs)
        digest = int.from_bytes(hashlib.blake2b(spec, digest_size=7)
                                .digest(), "little")
        head = torch.tensor([payload, len(spec), digest], dtype=torch.int64)
        heads = torch.empty(self.size * _HEADER, dtype=torch.int64)
        _all_gather(heads, head, self._mesh._host_group)
        heads = heads.view(self.size, _HEADER)
        if bool((heads == head).all()):
            return payload
        # tell every rank what each handed over, then all raise alike
        width = int(heads[:, 1].max())
        mine = torch.zeros(width, dtype=torch.uint8)
        mine[:len(spec)] = torch.frombuffer(bytearray(spec),
                                            dtype=torch.uint8)
        specs = torch.empty(self.size * width, dtype=torch.uint8)
        _all_gather(specs, mine, self._mesh._host_group)
        specs = [bytes(specs[r * width:(r + 1) * width].tolist())
                 .rstrip(b"\0").decode() for r in range(self.size)]
        other = next(r for r in range(self.size) if specs[r] != specs[0])
        raise MeshError(f"one collective got tensors of different shapes: "
                        f"rank 0 {specs[0]}, rank {other} {specs[other]}")

    # -- the data: one packed buffer a collective ----------------------------

    def _buffer(self, *shape) -> torch.Tensor:
        """A receive buffer: pinned host memory when staged."""
        if self._mesh.staged:
            return torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        return torch.empty(shape, dtype=torch.uint8, device=self.device)

    def _sent(self, t: torch.Tensor) -> torch.Tensor:
        """A send buffer as the backend takes it: a host copy when
        staged."""
        if not self._mesh.staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True) if self._mesh.staged \
            else t

    def _swap(self, xs: list) -> List[list]:
        payload = self._agree(xs)
        if payload == 0:                # empty tensors of equal shapes
            return [[t.clone() for t in xs] for _ in range(self.size)]
        buf = torch.zeros(payload, dtype=torch.uint8, device=self.device)
        at = 0
        for t in xs:
            b = _bytes_of(t)
            buf[at:at + b.numel()] = b
            at += _aligned(b.numel())
        got = self._buffer(self.size * payload)
        _all_gather(got, self._sent(buf))
        got = self._back(got).view(self.size, payload)
        out = []
        for r in range(self.size):
            at, row = 0, []
            for t in xs:
                n = t.numel() * t.element_size()
                row.append(got[r, at:at + n].view(t.dtype).reshape(t.shape))
                at += _aligned(n)
            out.append(row)
        return out

    def all_to_all(self, x):
        """As the thread mesh's: chunk j of axis 0 of every tensor goes to
        rank j; one ``all_to_all_single`` for the whole list."""
        flat, rebuild = _tree(x)
        self._note(flat)
        self._agree(flat)
        d = self.size
        # [d, bytes of one chunk] a tensor, side by side in one buffer
        chunks = []
        for t in flat:
            k = t.shape[0] // d
            row = t[0].numel() * t.element_size() if t.shape[0] else 0
            chunks.append(_bytes_of(t[:k * d]).view(d, k * row))
        widths = [_aligned(c.shape[1]) for c in chunks]
        send = torch.zeros(d, sum(widths), dtype=torch.uint8,
                           device=self.device)
        at = 0
        for c, w in zip(chunks, widths):
            send[:, at:at + c.shape[1]] = c
            at += w
        recv = send
        if send.numel():
            recv = self._buffer(*send.shape)
            dist.all_to_all_single(recv, self._sent(send))
            recv = self._back(recv)
        out, at = [], 0
        for t, c, w in zip(flat, chunks, widths):
            k = t.shape[0] // d
            out.append(recv[:, at:at + c.shape[1]].contiguous()
                       .view(t.dtype).reshape((d * k,) + tuple(t.shape[1:])))
            at += w
        return rebuild(out)
