"""Out-of-device-memory streaming in the PyTorch port on the CPU
(``monetdb_tpu_torch.ops.external``): the reference package's tests
(tests/test_external.py) pointed at the port with ``device="cpu"``, and the
same arrays through both packages, whose outputs must be equal.

The always-on tests validate the machinery at moderate scale with tiny
tiles (so the multi-tile paths execute); the 1B-row envelope itself is
opt-in (MTPU_BIGSORT=1, as in the reference; intended for the card, where
``device="cuda"``) and records rows/s.
"""

import os
import time

import numpy as np
import pytest
import torch

from monetdb_tpu.ops import external as ref_external
from monetdb_tpu_torch.ops.external import (external_sort, streaming_cumsum,
                                            streaming_window_sum)

#: the opt-in envelope runs on the card when there is one
_BIG_DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


def test_external_sort_multichunk():
    rng = np.random.default_rng(3)
    arr = rng.integers(-10**12, 10**12, 1_000_000).astype(np.int64)
    got = external_sort(arr.copy(), chunk_rows=1 << 16, device="cpu")
    want = np.sort(arr)
    assert (got == want).all()


def test_external_sort_descending_and_single_chunk():
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 100, 10_000).astype(np.int64)
    assert (external_sort(arr.copy(), chunk_rows=1 << 20, device="cpu")
            == np.sort(arr)).all()
    got = external_sort(arr.copy(), chunk_rows=1 << 10, descending=True, device="cpu")
    assert (got == np.sort(arr)[::-1]).all()


def test_external_sort_heavy_ties_recurses():
    # a constant-heavy key distribution overflows one range bucket and
    # forces the recursive split path
    rng = np.random.default_rng(5)
    arr = np.where(rng.random(200_000) < 0.9, 7,
                   rng.integers(0, 1000, 200_000)).astype(np.int64)
    got = external_sort(arr.copy(), chunk_rows=1 << 14, device="cpu")
    assert (got == np.sort(arr)).all()


def test_streaming_cumsum_matches_numpy():
    rng = np.random.default_rng(6)
    arr = rng.integers(-1000, 1000, 300_000).astype(np.int64)
    got = streaming_cumsum(arr, chunk_rows=1 << 14, device="cpu")
    assert (got == np.cumsum(arr)).all()


@pytest.mark.parametrize("w", [1, 2, 7, 1000])
def test_streaming_window_sum(w):
    rng = np.random.default_rng(7)
    arr = rng.integers(-50, 50, 50_000).astype(np.int64)
    got = streaming_window_sum(arr, w, chunk_rows=1 << 13, device="cpu")
    c = np.concatenate([[0], np.cumsum(arr)])
    want = c[1:] - c[np.maximum(np.arange(len(arr)) - w + 1, 0)]
    assert (got == want).all()


@pytest.mark.skipif(not os.environ.get("MTPU_BIGSORT"),
                    reason="1B-row envelope: set MTPU_BIGSORT=1 (slow; "
                           "intended for the real chip)")
def test_billion_row_sort_and_window():
    """North-star config 3: 1B-row sort + window on one chip without
    OOM; device working set bounded by the tile size."""
    n = 1_000_000_000
    rng = np.random.default_rng(8)
    arr = rng.integers(-10**15, 10**15, n).astype(np.int64)
    t0 = time.time()
    got = external_sort(arr, chunk_rows=1 << 26, device=_BIG_DEVICE)
    t_sort = time.time() - t0
    # spot-verify: global monotonicity + checksum (a full np.sort oracle
    # would double the host memory)
    assert (np.diff(got[:: 1_000_001]) >= 0).all()
    assert (got[:-1] <= got[1:]).all()
    assert got.sum(dtype=np.int64) == arr.sum(dtype=np.int64)
    t0 = time.time()
    ws = streaming_window_sum(arr, 1000, chunk_rows=1 << 26,
                              device=_BIG_DEVICE)
    t_win = time.time() - t0
    c = np.concatenate([[0], np.cumsum(arr[:10_000])])
    want = c[1:] - c[np.maximum(np.arange(10_000) - 999, 0)]
    assert (ws[:10_000] == want).all()
    print(f"\n1B sort: {t_sort:.1f}s ({n/t_sort/1e6:.0f} Mrows/s); "
          f"1B window(1000): {t_win:.1f}s ({n/t_win/1e6:.0f} Mrows/s)")


# ---------------------------------------------------------------------------
# parity with the JAX package: the same arrays through both
# ---------------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(21)
    n = 60_000
    wide = rng.integers(-10**15, 10**15, n).astype(np.int64)
    ties = np.where(rng.random(n) < 0.9, -3,
                    rng.integers(-500, 500, n)).astype(np.int64)
    narrow = rng.integers(-100, 100, n).astype(np.int32)
    return {"wide": wide, "ties": ties, "narrow": narrow,
            "short": wide[:777].copy()}


@pytest.mark.parametrize("name", ["wide", "ties", "narrow", "short"])
@pytest.mark.parametrize("descending", [False, True])
def test_external_sort_matches_jax(name, descending):
    arr = _arrays()[name]
    got = external_sort(arr.copy(), chunk_rows=1 << 14,
                        descending=descending, device="cpu")
    want = ref_external.external_sort(arr.copy(), chunk_rows=1 << 14,
                                      descending=descending)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["wide", "narrow", "short"])
def test_streaming_cumsum_matches_jax(name):
    arr = _arrays()[name] // 1000 if name != "narrow" else _arrays()[name]
    got = streaming_cumsum(arr, chunk_rows=1 << 13, device="cpu")
    want = ref_external.streaming_cumsum(arr, chunk_rows=1 << 13)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("w", [1, 3, 1000])
def test_streaming_window_sum_matches_jax(w):
    arr = _arrays()["narrow"].astype(np.int64)
    got = streaming_window_sum(arr, w, chunk_rows=1 << 13, device="cpu")
    want = ref_external.streaming_window_sum(arr, w, chunk_rows=1 << 13)
    assert np.array_equal(got, want)
