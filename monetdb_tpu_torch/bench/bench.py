"""Benchmark: TPC-H hot-path throughput of the port on one NVIDIA GPU.

The port's counterpart of the JAX package's root ``bench.py``: the same
loops over the same seeded data, the same slope method and the same
headline JSON line.

    python -m monetdb_tpu_torch.bench.bench

runs on ``cuda:0`` and raises without a CUDA device; ``main(device="cpu",
...)`` with small sizes runs it on the CPU (the tests do).

Headline metric: scan-filter throughput in GB/s/chip on the Q6 loop (filter
over 3 columns + masked sum, 24 bytes a row) over 24,000,000 rows;
vs_baseline = value / 5.0.  Then the Q1 one-hot group-aggregate loop, the
same sums through the ``seg_sum64`` CUDA kernel (five launches an
iteration), the join and group-by roofline programs, and the 22 TPC-H
queries at SF1 through ``Engine.query`` (one cold and the middle of 3 warm
runs each, cheapest first, within ``MTPU_BENCH_BUDGET_S`` seconds, default
900; the queries left over are listed as skipped).

Measurement method: each loop runs K iterations from Python (torch has no
``lax.scan``) whose parameters vary with the iteration index, so no
iteration can be reused, and ends in one host read of the sum.  The time
an iteration is the slope between two K values of the median host-clock
time of the call plus that read, which cancels the fixed cost of a call.
Both K values run once before any timing (first-use costs: the kernel's
nvcc build, the caching allocator's growth).  The slope is a device time
only while no operation in a loop waits for the device; the GPU tests run
one iteration of each loop under ``torch.cuda.set_sync_debug_mode("error")``.

The JSON line goes to stdout after the microbenches, after every query and
at the end: the last line wins.  It has the reference's keys; ``detail``
adds ``device`` and ``power_limit`` (as ``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` gives them) and ``sections_failed``.
``vs_cpu_baseline_geomean`` divides BASELINE.md's sqlite times, measured
on the machine that wrote that file, by this run's warm medians: it
compares two machines.  Detail goes to stderr.

Unlike the reference, a section that raises, or a query that fails, makes
``main`` return 1 (the line still records every section); nothing falls
back to the CPU or to a kernel's plain version.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from ..engine import Engine
from ..exec.fragment import STATS
from ..ops import cuda_kernels
from ..ops._tensor import lexsort
from .kernels import q6_step
from .tpch_load import load_tpch
from .tpch_queries import QUERIES

__all__ = ["main", "q_columns", "join_keys", "groupby_columns", "seg_rows",
           "q6_args", "q1_args", "seg_args", "join_args", "groupby_args",
           "q6_loop", "q1_loop", "seg_loop", "join_loop", "groupby_loop",
           "groupby_sums", "q6_numpy", "q1_numpy", "seg_numpy", "join_numpy",
           "groupby_numpy"]

#: the Q1 loops' group-code domain
Q1_DOMAIN = 8
#: cheapest-first order (the reference's measured cold costs): a budget
#: timeout then drops only the most expensive tail
ORDER = (6, 4, 1, 19, 22, 17, 11, 16, 20, 14, 15, 12, 10, 13, 18, 2, 5, 3,
         7, 21, 8, 9)


def _timed(fn, *args, reps=5):
    """Median host seconds of ``fn(*args)`` and the host read of its sum
    (which waits for the device)."""
    vals = []
    for _ in range(reps):
        t0 = time.perf_counter()
        int(fn(*args))
        vals.append(time.perf_counter() - t0)
    vals.sort()
    return vals[len(vals) // 2]


def _slope(loop, args, ks, reps):
    """Seconds an iteration: both K values run once, then the slope of the
    median times between them."""
    k1, k2 = ks
    int(loop(*args, k1))
    int(loop(*args, k2))
    t1 = _timed(loop, *args, k1, reps=reps)
    t2 = _timed(loop, *args, k2, reps=reps)
    return max((t2 - t1) / (k2 - k1), 1e-9)


def _scan(body, k):
    """sum(body(i) for i in range(k)) as a 0-d int64 tensor."""
    acc = body(0)
    for i in range(1, k):
        acc = acc + body(i)
    return acc


# ---------------------------------------------------------------------------
# data: the reference's seeded draws, in its order
# ---------------------------------------------------------------------------


def q_columns(n: int) -> dict:
    """Q6 / Q1 columns (numpy) from seed 7."""
    rng = np.random.default_rng(7)
    return {"shipdate": rng.integers(8035, 10561, n).astype(np.int32),
            "disc": rng.integers(0, 11, n).astype(np.int64),
            "qty": rng.integers(100, 5100, n).astype(np.int64),
            "extp": rng.integers(9000, 2_000_000, n).astype(np.int32),
            "code": rng.integers(0, 6, n).astype(np.int32),
            "tax": rng.integers(0, 9, n).astype(np.int64)}


def join_keys(nb: int, npr: int, dom: int):
    """Build and probe keys (numpy int32) in [0, dom - 64) from seed 11."""
    rng = np.random.default_rng(11)
    return (rng.integers(0, dom - 64, nb).astype(np.int32),
            rng.integers(0, dom - 64, npr).astype(np.int32))


def groupby_columns(ngr: int, nseg: int):
    """Group ids in [0, nseg) and values in [0, 1000) (numpy int32) from
    seed 13."""
    rng = np.random.default_rng(13)
    return (rng.integers(0, nseg, ngr).astype(np.int32),
            rng.integers(0, 1000, ngr).astype(np.int32))


def seg_rows(n: int) -> int:
    """The seg_sum64 loop's rows: the reference kernel's block multiple,
    so both packages sum the same rows (the CUDA kernel takes any
    length)."""
    return (n // cuda_kernels.SEG_SUM_BLOCK) * cuda_kernels.SEG_SUM_BLOCK


def _on(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _q1_measures(c: dict) -> dict:
    """Adds the loop-invariant Q1 measures, int64: extendedprice,
    disc_price and charge (the reference computes them outside its
    scan)."""
    c["extp64"] = c["extp"].to(torch.int64)
    c["dp"] = c["extp64"] * (100 - c["disc"])
    c["ch"] = c["dp"] * (100 + c["tax"])
    return c


# each section's loop arguments before K, on ``device``, from its numpy
# arrays (the reference's ``*_args``)

def q6_args(qa: dict, device) -> tuple:
    return (_on({k: qa[k] for k in ("shipdate", "disc", "qty", "extp")},
                device),)


def q1_args(qa: dict, device) -> tuple:
    c = _q1_measures(_on(qa, device))
    c["ones"] = torch.ones_like(c["qty"])
    return (c,)


def seg_args(qa: dict, device) -> tuple:
    rows = seg_rows(len(qa["code"]))
    return (_q1_measures(_on({k: v[:rows] for k, v in qa.items()},
                             device)),)


def join_args(bkeys, pkeys, dom: int, device) -> tuple:
    return torch.from_numpy(bkeys).to(device), \
        torch.from_numpy(pkeys).to(device), dom


def groupby_args(sid, vals, nseg: int, device) -> tuple:
    return torch.from_numpy(sid).to(device), \
        torch.from_numpy(vals).to(device), nseg


# ---------------------------------------------------------------------------
# the loops (bench.py's scan bodies); each returns a 0-d int64 tensor
# ---------------------------------------------------------------------------


def q6_loop(c: dict, k: int):
    """Q6 scan-filter: the product stays in int32 (below 2^31 at these
    ranges), the sum in int64."""
    return _scan(lambda i: q6_step(c["shipdate"], c["disc"], c["qty"],
                                   c["extp"], 8766 + i % 7, 9131, 5 + i % 2,
                                   7, 2400), k)


def q1_loop(c: dict, k: int):
    """Q1 one-hot group-aggregate (the reference's XLA form): six sums of
    a [rows, domain] masked broadcast.  Eager torch materializes each
    broadcast that XLA fused (8 bytes x rows x domain)."""
    slots = torch.arange(Q1_DOMAIN, dtype=c["code"].dtype,
                         device=c["code"].device)
    vals = (c["qty"], c["extp64"], c["dp"], c["ch"], c["disc"], c["ones"])

    def body(i):
        m = (c["code"] >= 0) & (c["shipdate"] <= 10460 + i % 11)
        oh = m[:, None] & (c["code"][:, None] == slots)
        parts = sum(torch.where(oh, v[:, None], 0).sum(0) for v in vals)
        return parts.sum()
    return _scan(body, k)


def seg_loop(c: dict, k: int):
    """The same sums through ``seg_sum64``: one launch for each of five
    measures an iteration (the count comes with every sum)."""
    vals = (c["qty"], c["extp64"], c["dp"], c["ch"], c["disc"])

    def body(i):
        sid = torch.where((c["code"] >= 0)
                          & (c["shipdate"] <= 10460 + i % 11),
                          c["code"].to(torch.int64), Q1_DOMAIN)
        tot = 0
        for v in vals:
            s, n = cuda_kernels.seg_sum64(sid, v, domain=Q1_DOMAIN)
            tot = tot + s.sum() + n.sum()
        return tot
    return _scan(body, k)


def join_loop(bkeys, pkeys, dom: int, k: int):
    """Dense-build join: a scatter-min table of build row ids over
    [0, dom] and a gather probe; sums the matched build rows (-1 a miss)."""
    nb = bkeys.numel()
    rid = torch.arange(nb, dtype=torch.int32, device=bkeys.device)

    def body(i):
        key = bkeys + i % 7
        # mode="drop": a key outside [0, dom] goes to slot dom + 1, which
        # no probe reads (probes clamp to [0, dom])
        idx = torch.where((key >= 0) & (key <= dom), key, dom + 1).long()
        tmin = torch.full((dom + 2,), nb, dtype=torch.int32,
                          device=bkeys.device)
        tmin.scatter_reduce_(0, idx, rid, "amin", include_self=True)
        hit = tmin[(pkeys + i % 7).clamp_(0, dom)]
        return torch.where(hit < nb, hit, -1).to(torch.int64).sum()
    return _scan(body, k)


def groupby_sums(sid, vals, off: int, nseg: int):
    """Per-group int64 sums of ``vals`` by ``(sid + off) % nseg``: one
    stable sort, gather, cumsum and boundary difference (the engine's
    sorted group-by)."""
    s = (sid + off) % nseg
    perm = lexsort([s])
    ss = s[perm]
    c = torch.cat([torch.zeros(1, dtype=torch.int64, device=s.device),
                   torch.cumsum(vals[perm].to(torch.int64), 0)])
    ends = torch.searchsorted(
        ss, torch.arange(nseg, dtype=ss.dtype, device=ss.device), right=True)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    return c[ends] - c[starts]


def groupby_loop(sid, vals, nseg: int, k: int):
    return _scan(lambda i: groupby_sums(sid, vals, i % 5, nseg).sum(), k)


# ---------------------------------------------------------------------------
# numpy references of one iteration (chip_smoke.py and the tests)
# ---------------------------------------------------------------------------


def q6_numpy(a: dict, i: int) -> int:
    m = ((a["shipdate"] >= 8766 + i % 7) & (a["shipdate"] < 9131)
         & (a["disc"] >= 5 + i % 2) & (a["disc"] <= 7) & (a["qty"] < 2400))
    return int((a["extp"].astype(np.int64) * a["disc"])[m].sum())


def _q1_rows(a: dict, i: int):
    """(sum over the selected rows of the five measures, selected rows)."""
    sel = (a["code"] >= 0) & (a["code"] < Q1_DOMAIN) \
        & (a["shipdate"] <= 10460 + i % 11)
    extp = a["extp"].astype(np.int64)
    dp = extp * (100 - a["disc"])
    row = a["qty"] + extp + dp + dp * (100 + a["tax"]) + a["disc"]
    return int(row[sel].sum()), int(sel.sum())


def q1_numpy(a: dict, i: int) -> int:
    """The one-hot loop: five sums and the count."""
    total, count = _q1_rows(a, i)
    return total + count


def seg_numpy(a: dict, i: int) -> int:
    """The seg_sum64 loop over ``seg_rows``: five sums, five counts."""
    rows = seg_rows(len(a["code"]))
    total, count = _q1_rows({k: v[:rows] for k, v in a.items()}, i)
    return total + 5 * count


def join_numpy(bkeys, pkeys, i: int, dom: int) -> int:
    key = bkeys.astype(np.int64) + i % 7
    tmin = np.full(dom + 1, len(bkeys), np.int64)
    live = (key >= 0) & (key <= dom)
    uniq, first = np.unique(key[live], return_index=True)
    tmin[uniq] = np.flatnonzero(live)[first]
    hit = tmin[np.clip(pkeys.astype(np.int64) + i % 7, 0, dom)]
    return int(np.where(hit < len(bkeys), hit, -1).sum())


def groupby_numpy(sid, vals, i: int, nseg: int) -> np.ndarray:
    """Per-group sums, int64 (every partial sum of these values is an
    integer far below 2^53, so bincount's float64 is exact)."""
    s = (sid.astype(np.int64) + i % 5) % nseg
    return np.bincount(s, weights=vals, minlength=nseg).astype(np.int64)


# ---------------------------------------------------------------------------
# the bench
# ---------------------------------------------------------------------------


def _device_name(dev: torch.device):
    """(name, power limit) as nvidia-smi gives them; ("cpu", None)."""
    if dev.type != "cuda":
        return str(dev), None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    gpu = visible.split(",")[idx].strip() if visible else str(idx)
    out = subprocess.run(
        ["nvidia-smi", "-i", gpu, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    name, power = out.rsplit(",", 1)
    return name.strip(), power.strip()




def _peak(dev) -> str:
    if dev.type != "cuda":
        return ""
    return (f", peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")


def _q6(dev, qa: dict, n: int, ks) -> float:
    per = _slope(q6_loop, q6_args(qa, dev), ks, 5)
    print(f"q6 scan-filter: {per * 1e3:.4f} ms/iter  "
          f"{24.0 * n / per / 1e9:.1f} GB/s  {n / per / 1e6:.0f} Mrows/s"
          f"{_peak(dev)}", file=sys.stderr)
    return per


def _q1(dev, qa: dict, n: int, ks) -> float:
    per = _slope(q1_loop, q1_args(qa, dev), ks, 3)
    print(f"q1 group-aggr: {per * 1e3:.4f} ms/iter  {n / per / 1e6:.0f} "
          f"Mrows/s{_peak(dev)}", file=sys.stderr)
    return per


def _seg(dev, qa: dict, n: int, ks) -> float:
    before = cuda_kernels.LAUNCHES["seg_sum64"]
    per = _slope(seg_loop, seg_args(qa, dev), ks, 3)
    launched = cuda_kernels.LAUNCHES["seg_sum64"] - before
    iters = 4 * sum(ks)             # each K value: one run, 3 timed
    if dev.type == "cuda" and launched != 5 * iters:
        raise RuntimeError(f"seg_sum64 launched {launched} times in {iters} "
                           f"iterations, not 5 an iteration")
    print(f"q1 seg_sum64: {per * 1e3:.4f} ms/iter over {seg_rows(n)} rows, "
          f"{launched} launches in {iters} iterations{_peak(dev)}",
          file=sys.stderr)
    return per * 1e3


def _join(dev, nb: int, npr: int, dom: int, ks, hbm_gbps: float) -> float:
    per = _slope(join_loop, join_args(*join_keys(nb, npr, dom), dom, dev),
                 ks, 3)
    # compulsory traffic: build keys read (4B*nb) + table write (4B*dom) +
    # probe keys read (4B*npr) + probe gather (4B*npr)
    gbps = 4.0 * (nb + dom + 2 * npr) / per / 1e9
    print(f"join build+probe ({nb} build x {npr} probe): {per * 1e3:.3f} "
          f"ms/iter  {gbps:.1f} GB/s  {gbps / hbm_gbps:.3f} of "
          f"{hbm_gbps:g} GB/s{_peak(dev)}", file=sys.stderr)
    return gbps


def _groupby(dev, ngr: int, nseg: int, ks, hbm_gbps: float) -> float:
    per = _slope(groupby_loop, groupby_args(*groupby_columns(ngr, nseg),
                                            nseg, dev), ks, 3)
    # compulsory traffic: sid read + sort write-back (2x4B) + perm write
    # (4B) + value gather (4B) + widened cumsum (8B) per row
    gbps = ngr * 24.0 / per / 1e9
    print(f"group-by sum ({ngr} rows, {nseg} groups): {per * 1e3:.3f} "
          f"ms/iter  {gbps:.1f} GB/s  {gbps / hbm_gbps:.3f} of "
          f"{hbm_gbps:g} GB/s{_peak(dev)}", file=sys.stderr)
    return gbps


def main(device="cuda:0", *, n: int = 24_000_000, q6_ks=(4, 36),
         q1_ks=(2, 10), nb: int = 10_000_000, npr: int = 100_000_000,
         dom: int = 16_777_216, join_ks=(1, 5), ngr: int = 100_000_000,
         nseg: int = 1_000_000, gb_ks=(1, 3), sf: float = 1.0,
         catalog=None) -> int:
    """Run every section on ``device`` and print the JSON lines; returns 0,
    or 1 if a section raised or a query failed.  ``catalog``: a TPC-H
    catalog already on ``device`` (else ``load_tpch(sf)``); its queries run
    cold only if the plan cache holds none of them for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench: no CUDA device (torch.cuda."
                               "is_available() is False); pass device='cpu' "
                               "to run on the CPU")
        torch.cuda.init()       # the memory statistics need it first
    name, power = _device_name(dev)
    print(f"device: {dev} ({name}, {power}), torch {torch.__version__}",
          file=sys.stderr)
    hbm_gbps = float(os.environ.get("MTPU_HBM_ROOFLINE_GBPS", "3350"))
    res, failed_sections = {}, {}

    def section(key, fn, *args):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            res[key] = fn(dev, *args)
        except Exception as ex:  # recorded in the line; main returns 1
            failed_sections[key] = f"{type(ex).__name__}: {str(ex)[:160]}"
            print(f"{key} failed:", file=sys.stderr)
            traceback.print_exc(file=sys.stderr)

    qa = q_columns(n)
    section("q6", _q6, qa, n, q6_ks)
    section("q1", _q1, qa, n, q1_ks)
    section("q1_seg_sum64", _seg, qa, n, q1_ks)
    del qa
    section("join", _join, nb, npr, dom, join_ks, hbm_gbps)
    section("groupby", _groupby, ngr, nseg, gb_ks, hbm_gbps)
    per6, per1 = res.get("q6"), res.get("q1")
    gbs = 24.0 * n / per6 / 1e9 if per6 else None
    seg_ms = res.get("q1_seg_sum64")
    join_gbps, gb_gbps = res.get("join"), res.get("groupby")

    engine_ms, engine_cold_ms, skipped, failed = {}, {}, [], {}
    cpu_engine, cpu_sf1_ms = _load_cpu_baseline()

    def emit():
        vs_cpu = None
        ncov = 0
        if cpu_sf1_ms and engine_ms and sf == 1.0:    # the table is SF1's
            ratios = [cpu_sf1_ms[q] / engine_ms[q] for q in engine_ms
                      if engine_ms.get(q) and cpu_sf1_ms.get(q)]
            ncov = len(ratios)
            if ratios:
                vs_cpu = round(_geomean(ratios), 2)

        print(json.dumps({
            "metric": "tpch_sf4_q6_scan_filter_throughput",
            "value": round(gbs, 2) if gbs else None,
            "unit": "GB/s/chip",
            "vs_baseline": round(gbs / 5.0, 2) if gbs else None,
            "detail": {
                "q6_ms_per_iter": round(per6 * 1e3, 4) if per6 else None,
                "q6_mrows_per_s": (round(n / per6 / 1e6, 1)
                                   if per6 else None),
                "q1_ms_per_iter": round(per1 * 1e3, 4) if per1 else None,
                "q1_mrows_per_s": (round(n / per1 / 1e6, 1)
                                   if per1 else None),
                "q1_pallas_ms_per_iter": (round(seg_ms, 4)
                                          if seg_ms else None),
                "q1_pallas_speedup": (round(per1 * 1e3 / seg_ms, 2)
                                      if seg_ms and per1 else None),
                "join_gbps": round(join_gbps, 1) if join_gbps else None,
                "join_roofline_frac": (round(join_gbps / hbm_gbps, 3)
                                       if join_gbps else None),
                "groupby_gbps": round(gb_gbps, 1) if gb_gbps else None,
                "groupby_roofline_frac": (round(gb_gbps / hbm_gbps, 3)
                                          if gb_gbps else None),
                "hbm_roofline_gbps": hbm_gbps,
                "engine_sf1_wall_ms": engine_ms or None,
                "engine_sf1_cold_ms": engine_cold_ms or None,
                "engine_sf1_skipped": skipped or None,
                "engine_sf1_failed": failed or None,
                "cpu_baseline_engine": cpu_engine,
                "cpu_baseline_sf1_ms": cpu_sf1_ms or None,
                # geomean over the measured queries; coverage says how
                # many of 22 it includes
                "vs_cpu_baseline_geomean": vs_cpu,
                "vs_cpu_baseline_coverage": f"{ncov}/22",
                "rows": n,
                "device": name,
                "power_limit": power,
                "sections_failed": failed_sections or None,
            },
        }), flush=True)

    emit()              # the microbench headline is on record from here on

    def engine():
        t0 = time.perf_counter()
        eng = Engine(catalog if catalog is not None
                     else load_tpch(sf, device=dev))
        print(f"SF{sf:g} gen+load: {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
        budget_end = time.perf_counter() + float(
            os.environ.get("MTPU_BENCH_BUDGET_S", 900))
        for qn in ORDER:
            if time.perf_counter() > budget_end:
                skipped.append(qn)      # no silent caps: record the drop
                continue
            sql = QUERIES[qn]
            try:
                t0 = time.perf_counter()
                eng.query(sql)
                engine_cold_ms[f"q{qn}"] = round(
                    (time.perf_counter() - t0) * 1e3, 1)
                reps = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    eng.query(sql)
                    reps.append(time.perf_counter() - t0)
                engine_ms[f"q{qn}"] = round(sorted(reps)[1] * 1e3, 1)
                print(f"engine SF{sf:g} q{qn}: warm {engine_ms[f'q{qn}']} "
                      f"ms (cold {engine_cold_ms[f'q{qn}']} ms)",
                      file=sys.stderr)
            except Exception as ex:  # recorded; main returns 1
                print(f"engine SF{sf:g} q{qn} failed: {type(ex).__name__}: "
                      f"{str(ex)[:160]}", file=sys.stderr)
                failed[f"q{qn}"] = f"{type(ex).__name__}: {str(ex)[:80]}"
            emit()      # per-query persistence: last line wins
        if skipped:
            print(f"engine SF{sf:g} SKIPPED (time budget): {skipped}",
                  file=sys.stderr)
        print(f"engine SF{sf:g} wall ms: {engine_ms}", file=sys.stderr)
        print(f"fragment STATS: {STATS}", file=sys.stderr)

    section("engine", lambda _dev: engine())
    emit()
    return 1 if failed_sections or failed else 0


def _geomean(xs):
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def _load_cpu_baseline():
    """Measured CPU SQL-engine per-query times (ms, TPC-H SF1) from
    BASELINE.md's machine-readable table (marker
    `<!-- cpu-sf1-measured engine=NAME -->`), parsed so bench and docs
    cannot drift apart.  Returns (engine_name, {}) if not yet measured."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "BASELINE.md")
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None, {}
    engine = None
    out = {}
    in_table = False
    for line in text.splitlines():
        m = re.search(r"<!-- cpu-sf1-measured engine=(\S+) -->", line)
        if m:
            engine = m.group(1)
            in_table = True
            continue
        if in_table:
            m = re.match(r"\|\s*q(\d+)\s*\|\s*([0-9.]+)\s*\|", line)
            if m:
                out[f"q{m.group(1)}"] = float(m.group(2))
            elif out and line.strip() and not line.startswith("|"):
                break
    return engine, out


if __name__ == "__main__":
    sys.exit(main())
