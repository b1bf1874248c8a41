#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (monetdb_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA (no JAX needed):

    python3 chip_smoke.py [--profile]

Phases, one or more output lines each:

1. device  - requires torch.cuda; prints the card's name and power limit
             as ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. build   - compiles the hand-written CUDA kernels from csrc/ with nvcc.
3. kernel  - each kernel against its plain PyTorch version on the card,
             exact equality, and median CUDA-event times of the kernel,
             the plain version and one library call (``index_add_`` of the
             prepared values into domain + 1 slots):
             seg_sum64 at n = 2^23 and 6,001,215 rows, domains 1, 12, 32,
             128, int32 and int64 ids (negative values, values beyond
             int32, excluded ids);
             q1_grouped_sums and grouped_sum_limbs at n = 24,000,000 and 6,001,215 rows,
             domain 8, inputs in the reference micro-benchmark's ranges
             with ``code == -1`` rows and a cutoff / mask that excludes
             rows.
4. load    - TPC-H SF1 generated and loaded onto the card (``load_tpch``);
             the numpy oracle (monetdb_tpu_torch/bench/tpch_oracle.py)
             computes every query's expected rows from the same data.
5. fused   - the kernel path: q1_grouped_sums over the resident SF1
             lineitem (group code from the two flag columns, int32 copies
             of the measures, Q1's cutoff) must give the oracle's Q1 sums
             and counts exactly; grouped_sum_limbs over the same codes with
             l_quantity and the shipdate mask must give sum_qty and the
             counts.
6. slice   - Q1, Q6, Q2, Q3, Q4, Q5, Q19, Q20 through ``Engine.query``: one
             cold and 5 warm runs each; rows equal to the oracle as ordered
             lists (decimals, integers, strings, dates and counts exactly,
             averages to rel 1e-12).  Prints per query the times, peak
             device memory above the tables, seg_sum64 launches and
             capacity retries.  Q1, Q4, Q5, Q6 and Q19 must launch
             seg_sum64.
7. profile - only with ``--profile``: per query, 5 warm runs under
             ``torch.profiler``: host wall, device busy time, kernels per
             query, device idle share, top kernels by device time; and the
             host's cost per eager op.

The launch counts are set to 0 just before phases 5 and 6 and read just
after.  Then one JSON line with each kernel's launches on its path, error,
times and bound, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero without that line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from monetdb_tpu_torch.bench import tpch_oracle
from monetdb_tpu_torch.bench.tpch_gen import gen_tpch
from monetdb_tpu_torch.bench.tpch_load import load_tpch
from monetdb_tpu_torch.bench.tpch_queries import QUERIES
from monetdb_tpu_torch.engine import Engine
from monetdb_tpu_torch.exec import fragment
from monetdb_tpu_torch.ops import cuda_kernels as CK

SF = 1.0
KERNEL_NS = (1 << 23, 6_001_215)
KERNEL_DOMAINS = (1, 12, 32, 128)
#: the main path's shape for the reported seg_sum64 time: Q1 at SF1 sums
#: over 2^23 rows into 12 slots with int64 segment ids
MAIN_SHAPE = (1 << 23, 12)
#: the fused kernels' shapes: the reference micro-benchmark's 24,000,000
#: rows (the reported time) and a ragged length
FUSED_NS = (24_000_000, 6_001_215)
FUSED_DOMAIN = 8
SLICE_QUERIES = (1, 6, 2, 3, 4, 5, 19, 20)
#: queries whose plan has a one-hot integer sum (Q2, Q3 and Q20 aggregate
#: into more than 128 slots: scatter mode, no kernel)
MUST_LAUNCH = (1, 4, 5, 6, 19)
WARM_RUNS = 5
AVG_RTOL = 1e-12
#: published peaks of one H100 SXM (NVIDIA's data sheet): device memory
#: rate, and the float32 rate outside the tensor cores, taken here as the
#: rate of the integer adds and multiplies these kernels do (the sheet has
#: no integer row; it flatters them, and bytes bound every kernel anyway)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def _log(*a):
    print(*a, flush=True)


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of device time of fn() over reps runs, by CUDA
    events.  The stream is first held busy for a few tens of milliseconds
    so that the host enqueues the timed calls ahead of the device: the
    events then bracket device work alone (a wrapper's output zero-fill
    and its kernel), not the host's time to make a call, which exceeds a
    50 us kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(60_000_000)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take: bytes moved once over the
    memory rate, or operations over their peak rate, whichever is more."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def library_index_add(idx, src, domain: int):
    """The library yardstick: one index_add_ of prepared values (``src``
    [n] or [n, k], int64) into domain + 1 slots by prepared int64 indices.
    It is timed here and used nowhere in the port."""
    shape = (domain + 1,) + tuple(src.shape[1:])
    return lambda: torch.zeros(shape, dtype=torch.int64,
                               device=src.device).index_add_(0, idx, src)


def equal_or_raise(name: str, got, want, where: str) -> int:
    """Max abs error over the output tensors; raises unless all equal."""
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} != plain at {where}: "
                             f"max abs err {err}")
    return err


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
    fns = CK.build()
    _log(f"build: {', '.join(sorted(fns))} "
         f"{time.perf_counter() - t0:.2f} s")
    for line in CK.BUILD_LOG.strip().splitlines():
        _log(f"  nvcc: {line.strip()}")


def phase_kernel_seg_sum64(dev) -> dict:
    """seg_sum64 vs seg_sum64_plain on the card; returns the JSON entry
    (launches filled in after the slice phase)."""
    g = torch.Generator(device=dev).manual_seed(1234)
    max_err = 0
    entry = {"name": "seg_sum64", "route": "cuda",
             "source": "monetdb_tpu_torch/csrc/seg_sum64.cu",
             "replaces": "monetdb_tpu/ops/pallas_kernels.py:162"}
    for n in KERNEL_NS:
        for domain in KERNEL_DOMAINS:
            for sid_dtype in (torch.int64, torch.int32):
                # ids in [-1, domain + 1]: both kinds of excluded rows
                sid = torch.randint(-1, domain + 2, (n,), generator=g,
                                    device=dev, dtype=sid_dtype)
                vals = torch.randint(-(1 << 45), 1 << 45, (n,), generator=g,
                                     device=dev, dtype=torch.int64)
                got = CK.seg_sum64(sid, vals, domain=domain)
                want = CK.seg_sum64_plain(sid, vals, domain=domain)
                torch.cuda.synchronize()
                where = f"n={n} domain={domain} sid={str(sid_dtype)[6:]}"
                max_err = max(max_err, equal_or_raise("seg_sum64", got,
                                                      want, where))
                if sid_dtype == torch.int32 and (n, domain) != MAIN_SHAPE:
                    _log(f"kernel: seg_sum64 {where} equal")
                    continue
                ms = time_cuda(lambda: CK.seg_sum64(sid, vals,
                                                    domain=domain))
                plain_ms = time_cuda(lambda: CK.seg_sum64_plain(
                    sid, vals, domain=domain))
                gbs = n * (sid.element_size() + 8) / (ms * 1e-3) / 1e9
                _log(f"kernel: seg_sum64 {where} equal; kernel {ms:.4f} ms "
                     f"({gbs:.0f} GB/s read), plain {plain_ms:.4f} ms")
                if (n, domain) == MAIN_SHAPE and sid_dtype == torch.int64:
                    idx = torch.where((sid >= 0) & (sid < domain), sid,
                                      domain)
                    lib_ms = time_cuda(library_index_add(
                        idx, torch.stack([vals, torch.ones_like(vals)], 1),
                        domain))
                    # bytes: ids and values read once, 2 * domain words
                    # written; operations: one sum and one count add a row
                    entry.update(
                        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        **bound(n * 16 + 2 * domain * 8, 2 * n))
                    _log(f"kernel: seg_sum64 {where} library index_add_ "
                         f"{lib_ms:.4f} ms, bound {entry['bound_ms']:.4f} "
                         f"ms ({entry['bound_by']})")
    entry["max_abs_err"] = max_err
    return entry


def _fused_inputs(n: int, dev, g):
    """Six int32 columns in the reference micro-benchmark's ranges, ~1% of
    the rows with code == -1, and a cutoff that excludes ~4% of them."""
    def col(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)
    code = col(0, 6)
    code[torch.rand(n, generator=g, device=dev) < 0.01] = -1
    return (code, col(8035, 10561), col(100, 5100), col(9000, 2_000_000),
            col(0, 11), col(0, 9)), 10471


def phase_kernel_fused(dev):
    """q1_grouped_sums and grouped_sum_limbs vs their plain versions on the
    card; returns their JSON entries (launches filled in after the fused
    phase)."""
    g = torch.Generator(device=dev).manual_seed(4321)
    domain = FUSED_DOMAIN
    q1 = {"name": "q1_grouped_sums", "route": "cuda",
          "source": "monetdb_tpu_torch/csrc/q1_grouped_sums.cu",
          "replaces": "monetdb_tpu/ops/pallas_kernels.py:86",
          "max_abs_err": 0}
    gsl = {"name": "grouped_sum_limbs", "route": "cuda",
           "source": "monetdb_tpu_torch/csrc/grouped_sum_limbs.cu",
           "replaces": "monetdb_tpu/ops/pallas_kernels.py:221",
           "max_abs_err": 0}
    for n in FUSED_NS:
        cols, cutoff = _fused_inputs(n, dev, g)
        code, ship, qty, extp, disc, tax = cols
        want = CK.q1_grouped_sums_plain(*cols, cutoff, domain=domain)
        got = CK.q1_grouped_sums(*cols, cutoff, domain=domain)
        mask = ship <= cutoff
        gwant = CK.grouped_sum_limbs_plain(code, extp, mask, domain=domain)
        ggot = CK.grouped_sum_limbs(code, extp, mask, domain=domain)
        torch.cuda.synchronize()
        where = f"n={n} domain={domain}"
        q1["max_abs_err"] = max(q1["max_abs_err"], equal_or_raise(
            "q1_grouped_sums", got, want, where))
        gsl["max_abs_err"] = max(gsl["max_abs_err"], equal_or_raise(
            "grouped_sum_limbs", ggot, gwant, where))
        if int(want[5].sum()) in (0, n) or int(gwant[1].sum()) in (0, n):
            raise AssertionError(f"fused inputs at {where} exclude no row "
                                 f"or every row")
        if n != FUSED_NS[0]:
            _log(f"kernel: q1_grouped_sums and grouped_sum_limbs {where} "
                 f"equal")
            continue
        ms = time_cuda(lambda: CK.q1_grouped_sums(*cols, cutoff,
                                                  domain=domain))
        plain_ms = time_cuda(lambda: CK.q1_grouped_sums_plain(
            *cols, cutoff, domain=domain), reps=5, warmup=1)
        e = extp.long()
        dp = e * (100 - disc.long())
        src = torch.stack([qty.long(), e, dp, dp * (100 + tax.long()),
                           disc.long(), torch.ones_like(e)], 1)
        idx = torch.where((code >= 0) & mask, code, domain).long()
        lib_ms = time_cuda(library_index_add(idx, src, domain), reps=5,
                           warmup=1)
        del src, dp, e
        # bytes: six int32 columns read once, 6 * domain words written;
        # operations a row: 2 subtract/add, 2 multiplies, 6 accumulations
        q1.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                  **bound(n * 24 + 6 * domain * 8, 10 * n))
        _log(f"kernel: q1_grouped_sums {where} equal; kernel {ms:.4f} ms "
             f"({n * 24 / (ms * 1e-3) / 1e9:.0f} GB/s read), plain "
             f"{plain_ms:.4f} ms, library index_add_ [n, 6] {lib_ms:.4f} "
             f"ms, bound {q1['bound_ms']:.4f} ms ({q1['bound_by']})")
        ms = time_cuda(lambda: CK.grouped_sum_limbs(code, extp, mask,
                                                    domain=domain))
        plain_ms = time_cuda(lambda: CK.grouped_sum_limbs_plain(
            code, extp, mask, domain=domain), reps=5, warmup=1)
        e = extp.long()
        lib_ms = time_cuda(library_index_add(
            idx, torch.stack([e, torch.ones_like(e)], 1), domain), reps=5,
            warmup=1)
        # bytes: code, value and mask read once; 2 accumulations a row
        gsl.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   **bound(n * 9 + 2 * domain * 8, 2 * n))
        _log(f"kernel: grouped_sum_limbs {where} equal; kernel {ms:.4f} ms "
             f"({n * 9 / (ms * 1e-3) / 1e9:.0f} GB/s read), plain "
             f"{plain_ms:.4f} ms, library index_add_ [n, 2] {lib_ms:.4f} "
             f"ms, bound {gsl['bound_ms']:.4f} ms ({gsl['bound_by']})")
    return q1, gsl


def phase_load(dev):
    t0 = time.perf_counter()
    data = gen_tpch(SF)
    _log(f"load: gen_tpch({SF}) {time.perf_counter() - t0:.2f} s, "
         f"lineitem {len(data['lineitem']['l_orderkey'])} rows")
    t0 = time.perf_counter()
    cat = load_tpch(SF, device=dev)
    torch.cuda.synchronize()
    li = cat.get("lineitem")
    resident = torch.cuda.memory_allocated(dev)
    _log(f"load: load_tpch({SF}, device={dev}) "
         f"{time.perf_counter() - t0:.2f} s, lineitem cap {li.cap} on "
         f"{li.col('l_quantity').data.device}; tables resident "
         f"{resident / 2**20:.1f} MiB")
    t0 = time.perf_counter()
    want = {q: tpch_oracle.ORACLES[q](data) for q in SLICE_QUERIES}
    _log(f"load: numpy oracle for Q{', Q'.join(map(str, SLICE_QUERIES))} "
         f"{time.perf_counter() - t0:.2f} s")
    return cat, resident, want


def phase_fused(cat, want_q1, q1_entry: dict, gsl_entry: dict) -> None:
    """The kernel path on the resident SF1 lineitem against the oracle's
    Q1 rows (returnflag, linestatus, sum_qty, sum_base_price,
    sum_disc_price, sum_charge, avg_qty, avg_price, avg_disc, count)."""
    li = cat.get("lineitem")
    n = li.count
    rf, ls = li.col("l_returnflag"), li.col("l_linestatus")
    n_ls = len(ls.sdict.values)
    domain = FUSED_DOMAIN
    if len(rf.sdict.values) * n_ls > domain:
        raise AssertionError("Q1's flag domain exceeds the fused domain")

    def i32(name):
        return li.col(name).data[:n].to(torch.int32).contiguous()

    code = (rf.data[:n].to(torch.int32) * n_ls
            + ls.data[:n].to(torch.int32)).contiguous()
    ship, qty, extp, disc, tax = map(i32, (
        "l_shipdate", "l_quantity", "l_extendedprice", "l_discount",
        "l_tax"))
    cutoff = int((np.datetime64("1998-12-01") - 90
                  - np.datetime64("1970-01-01")).astype(int))
    for name in CK.LAUNCHES:
        CK.LAUNCHES[name] = 0           # the kernel path starts here
    sums = CK.q1_grouped_sums(code, ship, qty, extp, disc, tax, cutoff,
                              domain=domain)
    gs, gc = CK.grouped_sum_limbs(code, qty, ship <= cutoff, domain=domain)
    torch.cuda.synchronize()
    q1_entry["launches"] = CK.LAUNCHES["q1_grouped_sums"]
    gsl_entry["launches"] = CK.LAUNCHES["grouped_sum_limbs"]
    if q1_entry["launches"] != 1 or gsl_entry["launches"] != 1:
        raise AssertionError(f"fused path launches: {CK.LAUNCHES}")
    sums = [s.tolist() for s in sums]
    live = [g for g in range(domain) if sums[5][g]]
    got = [(str(rf.sdict.values[g // n_ls]), str(ls.sdict.values[g % n_ls]),
            sums[0][g], sums[1][g], sums[2][g], sums[3][g], sums[5][g])
           for g in live]
    if got != [w[:6] + w[9:] for w in want_q1]:
        raise AssertionError(f"fused Q1 {got} != oracle {want_q1}")
    for g, w in zip(live, want_q1):
        if not np.isclose(sums[4][g] / 100.0 / sums[5][g], w[8],
                          rtol=AVG_RTOL, atol=0):
            raise AssertionError(f"fused Q1 sum_disc of group {g}")
    if gs.tolist() != sums[0] or gc.tolist() != sums[5]:
        raise AssertionError("grouped_sum_limbs != fused Q1 sum_qty/count")
    ms = time_cuda(lambda: CK.q1_grouped_sums(
        code, ship, qty, extp, disc, tax, cutoff, domain=domain))
    gms = time_cuda(lambda: CK.grouped_sum_limbs(
        code, qty, ship <= cutoff, domain=domain))
    _log(f"fused: q1_grouped_sums over SF{SF} lineitem ({n} rows, "
         f"{len(live)} live groups) equal to the oracle's Q1 sums and "
         f"counts, {ms:.4f} ms; "
         f"grouped_sum_limbs equal to sum_qty and counts, {gms:.4f} ms "
         f"with its mask compare")


def phase_slice(dev, cat, resident: int, want: dict, entry: dict) -> Engine:
    eng = Engine(cat)
    for name in CK.LAUNCHES:
        CK.LAUNCHES[name] = 0           # the main path starts here
    for q in SLICE_QUERIES:
        torch.cuda.reset_peak_memory_stats(dev)
        before = CK.LAUNCHES["seg_sum64"]
        retries = fragment.STATS["cap_retries"]
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
        launched = CK.LAUNCHES["seg_sum64"] - before
        if q in MUST_LAUNCH and launched <= 0:
            raise AssertionError(f"Q{q} did not launch seg_sum64")
        diff = tpch_oracle.rows_differ(
            rows, tpch_oracle.decoded(q, want[q]), AVG_RTOL)
        if diff or not rows:
            raise AssertionError(f"Q{q} != oracle: {diff or 'no rows'}")
        peak = torch.cuda.max_memory_allocated(dev) - resident
        _log(f"slice: Q{q} SF{SF} rows={len(rows)} equal to oracle; "
             f"cold {cold * 1e3:.1f} ms, warm "
             f"{', '.join(f'{w * 1e3:.2f}' for w in warm)} ms "
             f"(median {statistics.median(warm) * 1e3:.2f} ms); "
             f"seg_sum64 launches {launched} "
             f"({launched // (1 + WARM_RUNS)} a run after retries); "
             f"cap_retries "
             f"{fragment.STATS['cap_retries'] - retries}; peak device "
             f"memory above the tables {peak / 2**20:.1f} MiB")
    entry["launches"] = CK.LAUNCHES["seg_sum64"]
    return eng


def phase_profile(dev, eng: Engine) -> None:
    """Per query: warm runs under torch.profiler (device busy time and
    kernel count from the CUDA activities, host wall around the runs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(8, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        torch.where(x > 0, x, x)
    per_op = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    _log(f"profile: host cost per eager op {per_op:.2f} us")
    for q in SLICE_QUERIES:
        plain = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            list(eng.query(QUERIES[q]).rows)
            plain.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(WARM_RUNS):
                list(eng.query(QUERIES[q]).rows)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / WARM_RUNS
        # device-side events only: an operator's row repeats the time of
        # the kernels it launched
        kernels = [(a.key, a.self_device_time_total, a.count)
                   for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA]
        busy = sum(t for _k, t, _c in kernels) / WARM_RUNS / 1e3
        count = sum(c for _k, _t, c in kernels) / WARM_RUNS
        kernels.sort(key=lambda k: -k[1])
        top = ", ".join(f"{k[:48]} {t / WARM_RUNS / 1e3:.3f} ms x{c // WARM_RUNS}"
                        for k, t, c in kernels[:5])
        med = statistics.median(plain) * 1e3
        _log(f"profile: Q{q} warm median {med:.2f} ms unprofiled (idle "
             f"share {1 - busy / med:.2f}); profiled wall "
             f"{wall * 1e3:.2f} ms (idle share "
             f"{1 - busy / (wall * 1e3):.2f}), device busy {busy:.3f} ms, "
             f"device activities {count:.0f} a query; top: {top}")


def main(argv) -> int:
    if [a for a in argv if a != "--profile"]:
        raise SystemExit(__doc__)
    device = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    seg = phase_kernel_seg_sum64(dev)
    q1, gsl = phase_kernel_fused(dev)
    torch.cuda.empty_cache()
    cat, resident, want = phase_load(dev)
    phase_fused(cat, want[1], q1, gsl)
    eng = phase_slice(dev, cat, resident, want, seg)
    if "--profile" in argv:
        phase_profile(dev, eng)
    _log(json.dumps({"kernels": [seg, q1, gsl]}))
    _log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
