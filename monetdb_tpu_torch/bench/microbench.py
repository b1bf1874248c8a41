"""Synthetic column generators for operator micro-benchmarks — the analog
of the reference's microbenchmark module (monetdb5/modules/kernel/
microbenchmark.c: bat.uniform / bat.normal / bat.zipf / bat.skewed).

All generators are seeded and vectorized; they return engine Columns on
``device`` (``"cuda"`` unless told otherwise, as ``load_tpch``) so they drop
straight into operator-level perf and correctness tests (the north-star
configs use Zipf-skewed keys for join/group skew handling).  For a given
seed the values are the JAX package's, bit for bit: the same numpy draws.
"""

from __future__ import annotations

import numpy as np

from ..column import Column
from ..dtypes import F64, I64
from ..storage.columns import make_device_column

__all__ = ["uniform", "normal", "zipf", "skewed", "sorted_runs"]


def _col(arr: np.ndarray, device) -> Column:
    t = F64 if arr.dtype.kind == "f" else I64
    return make_device_column(arr.astype(t.np_dtype), t, device=device)


def uniform(n: int, domain: int, seed: int = 0, *,
            device="cuda") -> Column:
    """BATuniform: n ints uniform in [0, domain)."""
    rng = np.random.default_rng(seed)
    return _col(rng.integers(0, domain, n).astype(np.int64), device)


def normal(n: int, mean: float = 0.0, stddev: float = 1.0,
           seed: int = 0, *, device="cuda") -> Column:
    """BATnormal: gaussian f64."""
    rng = np.random.default_rng(seed)
    return _col(rng.normal(mean, stddev, n), device)


def zipf(n: int, domain: int, alpha: float = 1.1, seed: int = 0, *,
         device="cuda") -> Column:
    """BATzipf: Zipf-distributed keys over [0, domain) — the skew model
    for shuffle/join skew tests (north-star config 5). Uses inverse-CDF
    over the truncated harmonic distribution."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, domain + 1, dtype=np.float64)
    w = ranks ** -alpha
    cdf = np.cumsum(w) / w.sum()
    u = rng.random(n)
    return _col(np.searchsorted(cdf, u).astype(np.int64), device)


def skewed(n: int, domain: int, hot_fraction: float = 0.1,
           hot_mass: float = 0.9, seed: int = 0, *,
           device="cuda") -> Column:
    """BATskewed: hot_mass of the rows land on hot_fraction of the
    domain."""
    rng = np.random.default_rng(seed)
    hot = max(int(domain * hot_fraction), 1)
    is_hot = rng.random(n) < hot_mass
    vals = np.where(is_hot, rng.integers(0, hot, n),
                    rng.integers(hot, max(domain, hot + 1), n))
    return _col(vals.astype(np.int64), device)


def sorted_runs(n: int, run_len: int, seed: int = 0, *,
                device="cuda") -> Column:
    """Piecewise-sorted ints (exercises the sorted-run detection in the
    grouping/sort strategy pick, gdk_group.c:20-60)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 30, n).astype(np.int64)
    for i in range(0, n, run_len):
        vals[i:i + run_len] = np.sort(vals[i:i + run_len])
    return _col(vals, device)
