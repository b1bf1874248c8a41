#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (monetdb_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA (no JAX needed):

    python3 chip_smoke.py

Phases, one or more output lines each:

1. device  - requires torch.cuda; prints the card's name and power limit
             as ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. build   - compiles the hand-written CUDA kernels from csrc/ with nvcc.
3. kernel  - seg_sum64 against its plain PyTorch version on the card at
             the main path's widths (n = 2^23 and 6,001,215 rows; domains
             1, 12, 32, 128; negative values, values beyond int32 and
             excluded segment ids); exact equality; median CUDA-event
             times of both.
4. slice   - TPC-H SF1 loaded onto the card with ``load_tpch``, then Q1
             and Q6 through ``Engine.query``: one cold and 5 warm runs
             each.  Each query must launch seg_sum64, and its rows must
             equal the numpy oracle (tests/tpch_oracle.py) over the same
             generated data: decimals and counts exactly, averages to
             rel 1e-12.  Also prints the device memory the tables hold
             and each query's peak above it.

Then one JSON line with each kernel's launches on the main path, error and
times, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero without that line.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from decimal import Decimal

import torch

from monetdb_tpu_torch.bench.tpch_gen import gen_tpch
from monetdb_tpu_torch.bench.tpch_load import load_tpch
from monetdb_tpu_torch.bench.tpch_queries import QUERIES
from monetdb_tpu_torch.engine import Engine
from monetdb_tpu_torch.ops import cuda_kernels as CK

_ROOT = os.path.dirname(os.path.abspath(__file__))
SF = 1.0
KERNEL_NS = (1 << 23, 6_001_215)
KERNEL_DOMAINS = (1, 12, 32, 128)
#: the main path's shape for the reported kernel time: Q1 at SF1 sums
#: over 2^23 rows into 12 slots with int64 segment ids
MAIN_SHAPE = (1 << 23, 12)
WARM_RUNS = 5
AVG_RTOL = 1e-12


def _log(*a):
    print(*a, flush=True)


def _load_oracle():
    path = os.path.join(_ROOT, "tests", "tpch_oracle.py")
    spec = importlib.util.spec_from_file_location("tpch_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() over reps runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False - "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        _log(line.strip())
    kind = torch.cuda.get_device_name(0)
    _log(f"device: {kind}, torch {torch.__version__}, "
         f"cuda {torch.version.cuda}, count {torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    t0 = time.perf_counter()
    CK.build()
    _log(f"build: seg_sum64 {time.perf_counter() - t0:.2f} s")
    for line in CK.BUILD_LOG.strip().splitlines():
        _log(f"  nvcc: {line.strip()}")


def phase_kernel(dev) -> dict:
    """seg_sum64 vs seg_sum64_plain on the card; returns the JSON entry
    (launches filled in by the slice phase)."""
    g = torch.Generator(device=dev).manual_seed(1234)
    max_err = 0
    main = None
    for n in KERNEL_NS:
        for domain in KERNEL_DOMAINS:
            for sid_dtype in (torch.int64, torch.int32):
                # ids in [-1, domain + 1]: both kinds of excluded rows
                sid = torch.randint(-1, domain + 2, (n,), generator=g,
                                    device=dev, dtype=sid_dtype)
                vals = torch.randint(-(1 << 45), 1 << 45, (n,), generator=g,
                                     device=dev, dtype=torch.int64)
                ks, kc = CK.seg_sum64(sid, vals, domain=domain)
                ps, pc = CK.seg_sum64_plain(sid, vals, domain=domain)
                torch.cuda.synchronize()
                err = max(int((ks - ps).abs().max()),
                          int((kc - pc).abs().max()))
                max_err = max(max_err, err)
                if not (torch.equal(ks, ps) and torch.equal(kc, pc)):
                    raise AssertionError(
                        f"seg_sum64 != plain at n={n} domain={domain} "
                        f"sid={sid_dtype}: max abs err {err}")
                if sid_dtype == torch.int32 and (n, domain) != MAIN_SHAPE:
                    _log(f"kernel: seg_sum64 n={n} domain={domain} "
                         f"sid=int32 equal")
                    continue
                ms = time_cuda(lambda: CK.seg_sum64(sid, vals,
                                                    domain=domain))
                plain_ms = time_cuda(lambda: CK.seg_sum64_plain(
                    sid, vals, domain=domain))
                gbs = n * (sid.element_size() + 8) / (ms * 1e-3) / 1e9
                _log(f"kernel: seg_sum64 n={n} domain={domain} "
                     f"sid={str(sid_dtype)[6:]} equal; kernel {ms:.4f} ms "
                     f"({gbs:.0f} GB/s read), plain {plain_ms:.4f} ms")
                if (n, domain) == MAIN_SHAPE and sid_dtype == torch.int64:
                    main = (ms, plain_ms)
    return {"name": "seg_sum64", "route": "cuda",
            "source": "monetdb_tpu_torch/csrc/seg_sum64.cu",
            "replaces": "monetdb_tpu/ops/pallas_kernels.py:162",
            "launches": None, "max_abs_err": max_err,
            "ms": main[0], "plain_ms": main[1]}


def _check_q1(rows, want):
    if len(rows) != len(want) or len(rows) != 4:
        raise AssertionError(f"Q1: {len(rows)} rows, oracle {len(want)}")
    for got, w in zip(rows, want):
        exact = (w[0], w[1], Decimal(w[2]).scaleb(-2),
                 Decimal(w[3]).scaleb(-2), Decimal(w[4]).scaleb(-4),
                 Decimal(w[5]).scaleb(-6))
        if tuple(got[:6]) != exact or got[9] != w[9]:
            raise AssertionError(f"Q1 row {got} != oracle {w}")
        for g_, w_ in zip(got[6:9], w[6:9]):
            if not (math.isfinite(g_) and
                    math.isclose(g_, w_, rel_tol=AVG_RTOL)):
                raise AssertionError(f"Q1 avg {g_} != oracle {w_}")


def _check_q6(rows, want):
    if [tuple(r) for r in rows] != [(Decimal(want[0][0]).scaleb(-4),)]:
        raise AssertionError(f"Q6 {list(rows)} != oracle {want}")


def phase_slice(dev, kernel_entry: dict) -> None:
    oracle = _load_oracle()
    t0 = time.perf_counter()
    data = gen_tpch(SF)
    _log(f"slice: gen_tpch({SF}) {time.perf_counter() - t0:.2f} s, "
         f"lineitem {len(data['lineitem']['l_orderkey'])} rows")
    t0 = time.perf_counter()
    cat = load_tpch(SF, device=dev)
    torch.cuda.synchronize()
    li = cat.get("lineitem")
    resident = torch.cuda.memory_allocated(dev)
    _log(f"slice: load_tpch({SF}, device={dev}) "
         f"{time.perf_counter() - t0:.2f} s, lineitem cap {li.cap} on "
         f"{li.col('l_quantity').data.device}; tables resident "
         f"{resident / 2**20:.1f} MiB")
    want = {1: oracle.q1(data), 6: oracle.q6(data)}
    check = {1: _check_q1, 6: _check_q6}
    eng = Engine(cat)
    CK.SEG_SUM64_LAUNCHES = 0           # main path starts here
    for q in (1, 6):
        torch.cuda.reset_peak_memory_stats(dev)
        before = CK.SEG_SUM64_LAUNCHES
        t0 = time.perf_counter()
        rows = list(eng.query(QUERIES[q]).rows)
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            wrows = list(eng.query(QUERIES[q]).rows)
            warm.append(time.perf_counter() - t0)
            if wrows != rows:
                raise AssertionError(f"Q{q}: warm rows differ from cold")
        launched = CK.SEG_SUM64_LAUNCHES - before
        if launched <= 0:
            raise AssertionError(f"Q{q} did not launch seg_sum64")
        check[q](rows, want[q])
        peak = torch.cuda.max_memory_allocated(dev) - resident
        _log(f"slice: Q{q} SF{SF} rows={len(rows)} equal to oracle; "
             f"cold {cold * 1e3:.1f} ms, warm "
             f"{', '.join(f'{w * 1e3:.2f}' for w in warm)} ms "
             f"(median {statistics.median(warm) * 1e3:.2f} ms); "
             f"seg_sum64 launches {launched}; peak device memory above "
             f"the tables {peak / 2**20:.1f} MiB")
    kernel_entry["launches"] = CK.SEG_SUM64_LAUNCHES


def main() -> int:
    device = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    entry = phase_kernel(dev)
    phase_slice(dev, entry)
    _log(json.dumps({"kernels": [entry]}))
    _log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
