"""Out-of-device-memory column processing: host-resident columns streamed
through the card in bounded tiles — the port of the reference package's
ops/external.py (itself the analog of MonetDB's beyond-memory mmap policy,
STORE_MMAP, gdk/gdk_heap.c; candidate-list slice streaming + mitosis
memory-aware piece sizing, monetdb5/optimizer/opt_mitosis.c:150-190).

A column larger than device memory, or one whose monolithic device sort
would not fit (a sort's working set is a small multiple of its input),
stays on the host (the mmap role) and crosses to the device one tile at a
time, through a pinned host buffer when the device is a CUDA card:

* :func:`external_sort` — sample sort: device-sort tiles, range-partition
  them by splitters taken from a device-sorted sample, then device-sort
  each bounded range bucket; concatenation of bucket results is globally
  sorted.  Every device step is O(tile).
* :func:`streaming_cumsum` / :func:`streaming_window_sum` — windowed
  aggregates as a tile scan with carried state (prefix carry, w-1 halo),
  the GDKanalytical sliding-frame role (gdk/gdk_analytic_bounds.c) at
  out-of-memory scale.

Every function takes ``device`` (default ``"cuda"``); the device holds at
most a few tiles at a time.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ._tensor import tdt

__all__ = ["external_sort", "streaming_cumsum", "streaming_window_sum"]


class _Stage:
    """Host <-> device tile transfers.  On a CUDA device the tile goes
    through one pinned host buffer, reused for every tile (a copy from
    pageable memory would stage through a bounce buffer of its own)."""

    def __init__(self, device, rows: int, dtype: np.dtype):
        self.device = torch.device(device)
        self.pinned = None
        if self.device.type == "cuda" and rows > 0:
            self.pinned = torch.empty(rows, dtype=tdt(dtype),
                                      pin_memory=True)

    def up(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        if self.pinned is None or len(arr) > self.pinned.numel():
            return torch.from_numpy(arr).to(self.device)
        buf = self.pinned[:len(arr)]
        buf.numpy()[:] = arr
        # synchronous copy: the buffer is rewritten by the next tile
        return buf.to(self.device)

    @staticmethod
    def down(t: torch.Tensor, out: np.ndarray) -> None:
        out[:] = t.cpu().numpy()


def _dev_sort(stage: _Stage, x: np.ndarray, out: np.ndarray,
              descending: bool = False) -> None:
    """out[:] = sorted(x).  Descending is the ascending sort reversed, as
    in the reference, so ties and NaN land where they land there."""
    s = torch.sort(stage.up(x)).values
    if descending:
        s = s.flip(0)
    stage.down(s, out)


def _splitters(stage: _Stage, arr: np.ndarray, nbuckets: int) -> np.ndarray:
    """Device-sorted strided sample → nbuckets-1 range splitters."""
    s = min(len(arr), max(nbuckets * 64, 4096))
    idx = np.linspace(0, len(arr) - 1, s).astype(np.int64)
    sample = np.empty(s, arr.dtype)
    _dev_sort(stage, arr[idx], sample)
    cut = np.linspace(0, s, nbuckets + 1).astype(np.int64)[1:-1]
    return sample[np.clip(cut, 0, s - 1)]


def _emit_sorted(stage: _Stage, bucket: np.ndarray, out: np.ndarray,
                 pos: int, chunk_rows: int, descending: bool) -> int:
    """Write sorted(bucket) into out[pos:]; device-sort when it fits the
    tile, else three-way partition (< pivot, == pivot, > pivot) on a
    sampled median — the == run needs no sort, so heavy ties (splitter
    skew) make guaranteed progress instead of re-partitioning the same
    range forever."""
    n = len(bucket)
    if n == 0:
        return pos
    if n <= chunk_rows:
        _dev_sort(stage, bucket, out[pos: pos + n], descending=descending)
        return pos + n
    sample = bucket[:: max(1, n // 4096)]
    # median of a sample may fall between values; snap to a real sample
    # value so the == partition is non-empty
    med = np.median(sample)
    pivot = sample[np.argmin(np.abs(sample.astype(np.float64) - med))]
    lt = bucket[bucket < pivot]
    gt = bucket[bucket > pivot]
    neq = n - len(lt) - len(gt)
    first, last = (gt, lt) if descending else (lt, gt)
    pos = _emit_sorted(stage, first, out, pos, chunk_rows, descending)
    out[pos: pos + neq] = pivot
    pos += neq
    return _emit_sorted(stage, last, out, pos, chunk_rows, descending)


def external_sort(arr: np.ndarray, chunk_rows: int = 1 << 25,
                  descending: bool = False,
                  out: Optional[np.ndarray] = None, *,
                  device="cuda") -> np.ndarray:
    """Sort a host-resident 1-D array using bounded device tiles.

    Device working set is O(chunk_rows); host holds the input and the
    result.  Handles bucket skew by recursively splitting any range
    bucket that exceeds the tile size (ties/degenerate keys).
    """
    n = len(arr)
    if out is None:
        out = np.empty_like(arr)
    stage = _Stage(device, min(n, chunk_rows), arr.dtype)
    if n <= chunk_rows:
        _dev_sort(stage, arr, out, descending=descending)
        return out
    nchunks = -(-n // chunk_rows)
    spl = _splitters(stage, arr, nchunks)
    # phase 1: sort each tile on device; bucket boundaries via
    # searchsorted on the (host) sorted tile — O(log) per splitter
    pieces = [[] for _ in range(nchunks)]        # per-bucket list of runs
    for c in range(nchunks):
        tile = arr[c * chunk_rows: (c + 1) * chunk_rows]
        st = np.empty_like(tile)
        _dev_sort(stage, tile, st)
        bounds = np.concatenate(
            [[0], np.searchsorted(st, spl, side="right"), [len(st)]])
        for b in range(nchunks):
            lo, hi = bounds[b], bounds[b + 1]
            if hi > lo:
                pieces[b].append(st[lo:hi])
    # phase 2: device-sort each bounded bucket, emit in range order
    pos = 0
    order = range(nchunks - 1, -1, -1) if descending else range(nchunks)
    for b in order:
        if not pieces[b]:
            continue
        bucket = np.concatenate(pieces[b])
        pieces[b] = None                          # free host memory early
        pos = _emit_sorted(stage, bucket, out, pos, chunk_rows, descending)
    assert pos == n, (pos, n)
    return out


def streaming_cumsum(arr: np.ndarray, chunk_rows: int = 1 << 25,
                     out: Optional[np.ndarray] = None, *,
                     device="cuda") -> np.ndarray:
    """Running sum over a host-resident column via device tiles with a
    scalar carry (SUM() OVER (ORDER BY ... ROWS UNBOUNDED PRECEDING))."""
    n = len(arr)
    if out is None:
        out = np.empty_like(arr)
    stage = _Stage(device, min(n, chunk_rows), arr.dtype)
    carry = None
    for c in range(0, n, chunk_rows):
        tile = stage.up(arr[c: c + chunk_rows])
        # the sum stays in the column's dtype (torch would widen ints)
        res = torch.cumsum(tile, 0, dtype=tile.dtype)
        if carry is not None:
            res += carry
        carry = res[-1]
        stage.down(res, out[c: c + chunk_rows])
    return out


def _dev_window_sum(tile: torch.Tensor, halo: torch.Tensor) -> torch.Tensor:
    """Moving sum over concat(halo, tile), emitting len(tile) outputs;
    halo is the previous w-1 values (zeros at the start), so output i is
    c[w-1+i] - c[i-1] over the prefix sums c of the concatenation (c[-1] =
    0): two slices where the reference gathers by max(i, 0)."""
    x = torch.cat([halo, tile])
    c = torch.cumsum(x, 0, dtype=x.dtype)
    n = tile.shape[0]
    lo = torch.cat([torch.zeros(1, dtype=c.dtype, device=c.device),
                    c[:n - 1]])
    return c[halo.shape[0]:] - lo


def streaming_window_sum(arr: np.ndarray, w: int,
                         chunk_rows: int = 1 << 25,
                         out: Optional[np.ndarray] = None, *,
                         device="cuda") -> np.ndarray:
    """Moving-window sum (frame = ROWS w-1 PRECEDING .. CURRENT ROW) over
    a host-resident column: per tile the device sees the tile plus a
    (w-1)-row halo carried from the previous tile, so every output is
    exact with one pass over the host column."""
    n = len(arr)
    assert w >= 1 and w <= chunk_rows, (w, chunk_rows)
    if out is None:
        out = np.empty_like(arr)
    dt = np.asarray(arr[:1]).dtype
    stage = _Stage(device, min(n, chunk_rows), dt)
    halo = torch.zeros(w - 1, dtype=tdt(dt), device=stage.device)
    for c in range(0, n, chunk_rows):
        tile = stage.up(arr[c: c + chunk_rows])
        res = _dev_window_sum(tile, halo)
        stage.down(res, out[c: c + len(tile)])
        if w > 1:
            # the last w-1 values seen; a copy, so the tile can be freed
            halo = tile[-(w - 1):].clone() if len(tile) >= w - 1 else \
                torch.cat([halo, tile])[-(w - 1):]
    return out
