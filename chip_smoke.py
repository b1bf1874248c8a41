#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (monetdb_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA (no JAX needed):

    python3 chip_smoke.py [--profile]

Phases, one or more output lines each, and a line with each phase's time:

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
6. slice   - all 22 TPC-H queries through ``Engine.query``: one cold and 5
             warm runs each; rows equal to the oracle as ordered lists
             (decimals, integers, strings, dates and counts exactly,
             floats to rel 1e-12).  Prints per query the times, peak
             device memory above the tables, seg_sum64 launches, and the
             capacity and uniqueness retries (re-lowerings after an
             overflowed bucket / a join build side found non-unique).  The
             queries in MUST_LAUNCH must launch seg_sum64.
7. executor - the same 22 queries with ``fragment_exec`` off, so that each
             runs through the op-at-a-time executor (exec/executor.py):
             one cold and 2 warm runs, rows equal to the same oracle
             (floats to rel 1e-9).  Prints per query the times, peak device
             memory above the tables and the number of times the host
             waited for the stream (the executor reads every
             data-dependent count back, by design).  The executor launches
             none of the hand-written kernels; the counts must stay 0.
8. window  - window statements over the resident SF1 tables (each falls
             back to the executor): ranking, lag/lead, a running sum,
             full-partition aggregates, a ROWS frame and a RANGE frame with
             min/max over partsupp (800,000 rows), and a running sum, a
             RANGE frame and a lag over lineitem (6,001,215 rows,
             partitioned by l_orderkey); the window sits in a derived
             table and is aggregated outside.  Expected values from numpy
             (brute force over each row's neighbours; independent of the
             port's scans and sparse-table levels).  Then the device times
             of the window primitives at 2^20 and 2^23 rows.
9. tpcds   - ``load_tpcds(2,880,404)`` (TPC-DS SF1's store_sales row count)
             on the card, all 15 queries through ``Engine.query`` with the
             default config against sqlite3 over the same arrays; Q53, Q89
             and Q98 must count as fallbacks and the other twelve not.  Q53
             selects no row at this scale, so its deviation threshold is
             lowered from 10% to 1% where sqlite3 finds none.
10. profile - only with ``--profile``: per query, 5 warm runs under
             ``torch.profiler``: host wall, device busy time, kernels per
             query, device idle share, host waits on the stream per query,
             top kernels by device time; and the host's cost per eager op;
             then the same for the executor (3 warm runs).
11. session - the SQL front door: ``load_tpch_db(SF, data=...)`` on the
             card and the 22 queries through ``Session.sql``, one cold and
             3 warm runs each: rows equal to the oracle, no fallback, per
             warm run as many seg_sum64 launches as the slice phase's run
             of the same query lowered anew (Session.sql lowers at every
             run), warm runs served by the session's plan cache, every
             table materialized on the card once.  Prints the Session
             medians beside the Engine's.
12. server - a ``Server`` over that store: one ``Client`` runs the 22
             queries in JSON and in columnar mode (rows equal to the oracle,
             seg_sum64 launches a query equal to the session phase's warm
             run; wall over the wire beside the Session median), then 8
             clients at once, each the 22 queries in a seeded shuffled
             order (rows only; peak device memory); failing statements
             leave the connection answering; ``dbapi.connect(host=...)``
             in both modes; ``python -m monetdb_tpu_torch --host`` as a
             subprocess; a remote table served by a second server on the
             card, with a shipped predicate, against the local table; TLS
             with a throwaway certificate (when openssl is there);
             challenge-response auth.
13. spmd   - the SPMD row mesh: ``row_mesh([cuda:0] * 8)``, eight shards
             of the one card, each on a thread of its own.  The 22 queries
             through ``Session(db, mesh=mesh).sql`` over the session
             phase's store at the default ``spmd_*`` thresholds, one cold
             and 3 warm runs each: rows equal to the oracle, no fallback;
             the mesh must run at least 20 of the 22 and shuffle at least
             one join and one group-by or distinct (else a second pass at
             the reference dry run's scaled thresholds must).  Prints per
             query the warm median beside the one-device Session and Engine
             medians, seg_sum64 launches, the spmd / shuffle / retry counts
             and the peak device memory above the tables.  Q1 and Q6 again
             with ``assert_props`` (every shard's outputs compared); host
             waits of a warm run of Q1, Q3, Q6, Q13 and Q18, none inside a
             shard; ``sharded_q6`` and ``sharded_q1`` over the store's
             lineitem (int32 columns) equal to the oracle's Q6 revenue and
             Q1 sums, with 8 q1_grouped_sums launches a call; ``lane_counts``,
             ``dist_group_sum``, ``dist_group_sum_auto`` and ``dist_fk_join``
             over 2^23 int64 rows, uniform and Zipf(2) keys, equal to numpy.
14. procs  - the process mesh (parallel/dist.py): 2 ranks, each a process
             of its own on the one card, joined by gloo with every
             collective staged through host memory (NCCL refuses two ranks
             on one card); bench/mesh_procs.py: each rank makes the same
             2^24 int64 rows (keys uniform in [0, 2^20) and Zipf(2), 5%
             dead rows) and 24,000,000 Q1 / Q6 rows (the kernel phase's
             ranges) from one seed and runs two_phase_sum, sharded_q6 and
             sharded_q1 (int32 and int64 columns), lane_counts, shuffle,
             dist_group_sum, dist_group_sum_auto and dist_fk_join: its
             piece of each exact against numpy, and bit-equal to the same
             shard of ``row_mesh([cuda:0] * 2)`` run here afterwards; 6
             seg_sum64 and 1 q1_grouped_sums launches a rank.  Prints warm
             walls of both meshes, collectives and bytes a rank.  Then a
             failure drill: one rank raises after a collective and every
             rank must exit non-zero.
15. hybrid - the hybrid mesh (parallel/dist.py with several shards a
             process): 2 processes of 2 shards each on the one card, a
             global mesh of 4, host-staged gloo between the processes and
             the shards handed over by reference inside each; the same
             data and primitives as procs: every global shard's piece
             exact against numpy and bit-equal to the same shard of
             ``row_mesh([cuda:0] * 4)``; 6 seg_sum64 and 1 q1_grouped_sums
             launches a shard (12 and 2 a process).  Prints warm walls of
             both meshes and the all-to-all's in-process and cross-process
             parts apart.  Then a failure drill: the last local shard
             raises after a collective and both processes must exit
             non-zero.
16. harness - monetdb_tpu_torch/harness.py: ``entry()`` on the card equal
             to the CPU, ``dryrun_multichip(8)`` on ``[cuda:0] * 8`` (the
             22 queries at SF0.002 against one device, sharded_q1 / q6,
             the shuffles; it raises on a failed check).
17. durable - a store on local disk under $TMPDIR at SF1: the eight tables
             made by SQL DDL, loaded by COPY BINARY (one .npy per numeric
             column, one text file per string column) and ``orders`` by
             COPY INTO from a CSV through the native parser; checkpoint;
             TPC-H's refresh functions at SF1 size (RF1 inserts 1,500
             orders and their lineitems, RF2 deletes 1,500) and one UPDATE
             of l_discount, each one committed transaction, then one more
             RF1 rolled back; close without a checkpoint and reopen (WAL
             replay).  Every committed change must be read back (count and
             sums of every table against numpy over the changed arrays),
             the rolled-back one must be absent, and the 22 queries must
             equal the oracle over the changed arrays.  Prints load rate,
             WAL written, checkpoint, refresh, commit-to-next-answer and
             reopen times and the peak device memory across the refresh.
             Then the closed store is database ``db`` of a ``Farm`` on the
             card: the 22 queries through its proxy (oracle over the
             changed arrays), status, stop (must checkpoint), snapshot,
             restore as ``db2`` and a ``Funnel`` counting lineitem in both.
18. sqllogic - tests/sqllogic/*.test and the pinned reference corpus
             (tests/sqllogic/ref, held to REF_LEDGER.md with the ledger
             generator's CHAINS) through ``SqlLogicRunner(Session(
             Database()))`` on the card: every pass file passes, every
             known-fail fails.
19. geom   - 1,000,000 seeded points as WKT, loaded by COPY; point in
             polygon (64 vertices with a hole; a multipolygon), distance
             sums to a polygon, multipolygon, linestring and point,
             geographic DWithin, coordinate sums, st_area over 1,000
             polygons: counts exactly and floats to rel 1e-9 against numpy
             (even-odd ray cast, segment distance, haversine, shoelace);
             peak device memory per query.
20. external - ``external_sort`` of 2^27 seeded int64 (ascending,
             descending) and of 2^26 values that are 90% one value, in
             tiles of 2^24 rows; ``streaming_cumsum`` and
             ``streaming_window_sum(w=1000)`` over the 2^27 values: equal
             to numpy, peak device memory within 8 tiles; rows/s.  The
             reference's 1B-row envelope is cut to 2^27 rows for time.
21. bench  - runs after window primitives (and profile), over the resident
             SF1 catalog: ``monetdb_tpu_torch.bench.bench.main`` at its
             full sizes (Q6 and Q1 loops over 24,000,000 rows, seg_sum64's
             over 23,986,176, the join's 10,000,000 x 100,000,000 keys,
             the group-by's 100,000,000 rows into 1,000,000 groups, the
             22 queries), with the plan cache cleared first so that its
             cold column is cold.  It must return 0; its last JSON line
             must hold every key of the reference bench.py's line, no null
             microbench value, 22 measured queries, none failed or
             skipped; seg_sum64 must launch (main checks 5 an iteration of
             its loop) and the other two kernels not.  Then one iteration
             of each of the five loops at the same sizes against numpy
             (the group-by's every group sum against np.bincount), with 5
             seg_sum64 launches for the seg_sum64 loop's iteration, and
             one more iteration of each under ``torch.profiler``: device
             busy time and the top kernels.

The launch counts are set to 0 just before phases 5, 6, 7, 8, 9, 11, 12,
13 (before its SQL, then again before the sharded kernel steps), 17
(before its replayed queries, then again before the farm's) and 21
(before ``main``, then again before each loop's iteration) and read just
after each; in phases 14 and 15 each process sets its own to 0 just before
its pass over the primitives and reads them just after, and the processes'
counts are summed (``launches_procs``, ``launches_hybrid``).  Then one JSON line with each kernel's launches
on its path, error, times and bound, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero without that line.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import inspect
import io
import json
import math
import os
import re
import shutil
import sqlite3
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

import numpy as np
import torch

from monetdb_tpu_torch import config, harness
from monetdb_tpu_torch.bench import bench as BENCH
from monetdb_tpu_torch.bench import mesh_procs as MP
from monetdb_tpu_torch.bench import tpcds, tpch_oracle
from monetdb_tpu_torch.bench.tpch_gen import SCHEMA, gen_tpch
from monetdb_tpu_torch.bench.tpch_load import load_tpch, load_tpch_db
from monetdb_tpu_torch.bench.tpch_queries import QUERIES
from monetdb_tpu_torch.column import Column, capacity_for
from monetdb_tpu_torch.dtypes import BOOL, I64
from monetdb_tpu_torch.engine import Engine, plan_cache_clear, plan_cache_stats
from monetdb_tpu_torch.exec import fragment
from monetdb_tpu_torch.farm import Farm
from monetdb_tpu_torch.ops import cuda_kernels as CK
from monetdb_tpu_torch.ops import external as X
from monetdb_tpu_torch.ops import window as W
from monetdb_tpu_torch.ops.geom import GEOD_RADIUS
from monetdb_tpu_torch.parallel import (row_mesh, shard_array, sharded_q1,
                                        sharded_q6)
from monetdb_tpu_torch.parallel import mesh as MESH
from monetdb_tpu_torch.parallel import shuffle as SH
from monetdb_tpu_torch.server import Client, ColumnarResult, Server
from monetdb_tpu_torch.session import Session
from monetdb_tpu_torch.storage import Database, csv_native
from monetdb_tpu_torch.testing import SqlLogicRunner

ROOT = os.path.dirname(os.path.abspath(__file__))

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
SLICE_QUERIES = (1, 6, 2, 3, 4, 5, 19, 20, 10, 18, 7, 8, 9, 11, 12, 13, 14,
                 15, 16, 17, 21, 22)
#: queries whose plan has a one-hot integer sum whatever the capacity memo
#: holds (a scalar aggregate, or a group-by over a handful of dictionary
#: codes); the others aggregate into more than 128 slots (scatter mode,
#: no kernel) or only after a shrunk bucket re-lowered their group-by
MUST_LAUNCH = (1, 4, 5, 6, 8, 12, 14, 17, 19, 22)
WARM_RUNS = 5
AVG_RTOL = 1e-12
#: the op-at-a-time executor: fewer warm runs (it is the slow path), and
#: floats to rel 1e-9 (its averages divide in another order than numpy's)
EXEC_WARM_RUNS = 2
EXEC_RTOL = 1e-9
#: TPC-DS SF1's store_sales row count; the generator scales the dimensions
TPCDS_ROWS = 2_880_404
TPCDS_FALLBACKS = ("53", "89", "98")
#: published peaks of one H100 SXM (NVIDIA's data sheet): device memory
#: rate, and the float32 rate outside the tensor cores, taken here as the
#: rate of the integer adds and multiplies these kernels do (the sheet has
#: no integer row; it flatters them, and bytes bound every kernel anyway)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: the keys of the reference bench.py's JSON line, and its detail's (the
#: first ten are the microbenches' values)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "detail")
BENCH_DETAIL_KEYS = (
    "q6_ms_per_iter", "q6_mrows_per_s", "q1_ms_per_iter", "q1_mrows_per_s",
    "q1_pallas_ms_per_iter", "q1_pallas_speedup", "join_gbps",
    "join_roofline_frac", "groupby_gbps", "groupby_roofline_frac",
    "hbm_roofline_gbps", "engine_sf1_wall_ms", "engine_sf1_cold_ms",
    "engine_sf1_skipped", "engine_sf1_failed", "cpu_baseline_engine",
    "cpu_baseline_sf1_ms", "vs_cpu_baseline_geomean",
    "vs_cpu_baseline_coverage", "rows")


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
    want = {}
    took = []
    for q in SLICE_QUERIES:
        t1 = time.perf_counter()
        want[q] = tpch_oracle.ORACLES[q](data)
        took.append(f"Q{q} {time.perf_counter() - t1:.1f}")
    _log(f"load: numpy oracle for {len(want)} queries "
         f"{time.perf_counter() - t0:.2f} s ({', '.join(took)})")
    return cat, resident, want, data


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


def phase_slice(dev, cat, resident: int, want: dict, entry: dict,
                per_query: dict) -> Engine:
    """The 22 queries through ``Engine.query``; fills ``per_query[q]`` with
    the warm median (ms) and the seg_sum64 launches of one run lowered
    anew, as ``Session.sql`` runs a query."""
    eng = Engine(cat)
    for name in CK.LAUNCHES:
        CK.LAUNCHES[name] = 0           # the main path starts here
    for q in SLICE_QUERIES:
        torch.cuda.reset_peak_memory_stats(dev)
        before = CK.LAUNCHES["seg_sum64"]
        stats0 = dict(fragment.STATS)
        t0 = time.perf_counter()
        rows = list(eng.query(QUERIES[q]).rows)
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(WARM_RUNS):
            last = CK.LAUNCHES["seg_sum64"]
            t0 = time.perf_counter()
            wrows = list(eng.query(QUERIES[q]).rows)
            warm.append(time.perf_counter() - t0)
            if wrows != rows:
                raise AssertionError(f"Q{q}: warm rows differ from cold")
        launched = CK.LAUNCHES["seg_sum64"] - before
        # one more run as Session.sql makes it: bound once, lowered anew
        # (plan-time subqueries run again), then run
        last = CK.LAUNCHES["seg_sum64"]
        if list(eng.execute_plan(*eng.plan(QUERIES[q])).rows) != rows:
            raise AssertionError(f"Q{q}: a fresh lowering changed the rows")
        per_query[q] = {"median_ms": statistics.median(warm) * 1e3,
                        "launches": CK.LAUNCHES["seg_sum64"] - last}
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
             f"({launched // (1 + WARM_RUNS)} a run after retries; "
             f"{per_query[q]['launches']} in a run lowered anew); "
             f"cap_retries "
             f"{fragment.STATS['cap_retries'] - stats0['cap_retries']}, "
             f"uniq_retries "
             f"{fragment.STATS['uniq_retries'] - stats0['uniq_retries']}, "
             f"fragment runs "
             f"{fragment.STATS['runs'] - stats0['runs']}; peak device "
             f"memory above the tables {peak / 2**20:.1f} MiB")
    entry["launches"] = CK.LAUNCHES["seg_sum64"]
    return eng


def host_waits(eng: Engine, sql: str):
    """One warm run of a statement with torch's sync debug mode on: (number
    of times the host waited for the stream, how many of them inside the
    plan: the fragment interpreter's ``_run_single`` / ``_run_raw`` /
    ``_run_shard`` (one shard of a mesh) or any method of
    exec/executor.py, whose join and set-operation children run on worker
    threads, below no ``Executor.run`` frame).  The interpreter's
    nodes must add none: a run waits once for the error code, count and
    totals, and once for each result array.  The executor reads every
    data-dependent count back."""
    in_plan = []

    def note(message, category, filename, lineno, file=None, line=None):
        # (a mesh shard's wait is reported on the shard's own thread,
        # whose stack starts at the shard: _run_shard)
        stack = traceback.extract_stack()
        in_plan.append(any(
            f.name in ("_run_single", "_run_raw", "_run_shard")
            or f.filename.endswith("executor.py")
            for f in stack))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            list(eng.query(sql).rows)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return len(in_plan), sum(in_plan)


def _zero_launches() -> None:
    for name in CK.LAUNCHES:
        CK.LAUNCHES[name] = 0


def _no_launches(phase: str) -> None:
    if any(CK.LAUNCHES.values()):
        raise AssertionError(f"{phase} launched a hand-written kernel: "
                             f"{CK.LAUNCHES} (the executor has none)")


def phase_executor(dev, eng: Engine, resident: int, want: dict) -> None:
    """The 22 queries through the op-at-a-time executor."""
    _zero_launches()                    # the executor path starts here
    config.set("fragment_exec", False)
    try:
        for q in SLICE_QUERIES:
            torch.cuda.reset_peak_memory_stats(dev)
            runs0 = fragment.STATS["runs"]
            times = []
            for i in range(1 + EXEC_WARM_RUNS):
                t0 = time.perf_counter()
                got = list(eng.query(QUERIES[q]).rows)
                times.append(time.perf_counter() - t0)
                if i == 0:
                    rows = got
                elif tpch_oracle.rows_differ(got, rows, 0.0):
                    raise AssertionError(f"Q{q}: warm rows differ from cold")
            diff = tpch_oracle.rows_differ(
                rows, tpch_oracle.decoded(q, want[q]), EXEC_RTOL)
            if diff or not rows:
                raise AssertionError(f"executor Q{q} != oracle: "
                                     f"{diff or 'no rows'}")
            if fragment.STATS["runs"] != runs0:
                raise AssertionError(f"executor Q{q} ran a fragment")
            peak = torch.cuda.max_memory_allocated(dev) - resident
            n_waits, n_in_plan = host_waits(eng, QUERIES[q])
            _log(f"executor: Q{q} SF{SF} rows={len(rows)} equal to oracle; "
                 f"cold {times[0] * 1e3:.1f} ms, warm "
                 f"{', '.join(f'{w * 1e3:.2f}' for w in times[1:])} ms "
                 f"(median {statistics.median(times[1:]) * 1e3:.2f} ms); "
                 f"host waits {n_waits} ({n_in_plan} inside the executor); "
                 f"peak device memory above the tables "
                 f"{peak / 2**20:.1f} MiB")
    finally:
        config.reset("fragment_exec")
    _no_launches("the executor phase")


# ---------------------------------------------------------------------------
# window statements: the numpy oracle works on rows sorted by (partition,
# order) and looks at each row's neighbours by brute force
# ---------------------------------------------------------------------------

class _Sorted:
    """Rows of a table sorted by (partition key, order key)."""

    def __init__(self, part: np.ndarray, order: np.ndarray):
        self.perm = np.lexsort((order, part))
        self.part = part[self.perm]
        self.order = order[self.perm]
        n = len(part)
        self.idx = np.arange(n)
        self.bound = np.r_[True, self.part[1:] != self.part[:-1]]
        self.start = np.maximum.accumulate(
            np.where(self.bound, self.idx, 0))
        self.pid = np.cumsum(self.bound) - 1
        self.starts = np.flatnonzero(self.bound)
        self.size = np.diff(np.r_[self.starts, n])[self.pid]

    def col(self, arr):
        return arr[self.perm]

    def neighbours(self, max_dist: int):
        """(offset, mask of rows whose neighbour at that offset lies in
        the same partition) for every offset in [-max_dist, max_dist]."""
        n = len(self.part)
        for d in range(-max_dist, max_dist + 1):
            j = self.idx + d
            ok = (j >= 0) & (j < n)
            ok[ok] &= self.pid[j[ok]] == self.pid[ok]
            yield d, ok, np.clip(j, 0, n - 1)


def _checksums(w, k):
    """(sum(w), sum(w * (k % 7)), count(w)) with None for nil (NaN)."""
    live = ~np.isnan(w) if w.dtype.kind == "f" else np.ones(len(w), bool)
    wl, kl = w[live], k[live]
    if w.dtype.kind == "f":
        return float(wl.sum()), float((wl * (kl % 7)).sum()), int(live.sum())
    return int(wl.sum()), int((wl * (kl % 7)).sum()), int(live.sum())


_CHECK = ("select sum(w) as s, sum(w * (k % 7)) as s7, count(w) as c "
          "from (select {win} as w, {key} as k from {table}) t")


def _window_cases(data):
    """[(name, SQL, expected checksum row, decimal scale of the window
    value)].  The generated arrays hold decimals as their physical
    integers (hundredths); the SQL's decimal results are compared in the
    same integers."""
    ps = data["partsupp"]
    s = _Sorted(ps["ps_partkey"], ps["ps_suppkey"])
    qty = s.col(ps["ps_availqty"]).astype(np.int64)
    cost = s.col(ps["ps_supplycost"]).astype(np.int64)
    key = s.col(ps["ps_suppkey"]).astype(np.int64)
    part = "partition by ps_partkey"
    po = part + " order by ps_suppkey"
    cases = []

    def add(name, win, w, table="partsupp", k="ps_suppkey", kv=None,
            scale=0):
        cases.append((name, _CHECK.format(win=win, key=k, table=table),
                      _checksums(w, key if kv is None else kv), scale))

    rn = s.idx - s.start + 1
    add("row_number", f"row_number() over ({po})", rn)
    # rank by availqty descending within the part: 1 + rows of the
    # partition with a larger quantity
    rk = np.ones(len(qty), np.int64)
    for d, ok, j in s.neighbours(8):
        rk += ok & (qty[j] > qty)
    add("rank", f"rank() over ({part} order by ps_availqty desc)", rk)
    lag = np.full(len(qty), np.nan)
    lead = np.full(len(qty), np.nan)
    for d, ok, j in s.neighbours(1):
        if d == -1:
            lag[ok] = qty[j][ok]
        if d == 1:
            lead[ok] = qty[j][ok]
    add("lag", f"lag(ps_availqty) over ({po})", lag)
    add("lead", f"lead(ps_availqty) over ({po})", lead)
    cs = np.cumsum(qty)
    run = cs - np.where(s.start > 0, cs[s.start - 1], 0)
    add("running_sum", f"sum(ps_availqty) over ({po})", run)
    tot = np.add.reduceat(cost, s.starts)[s.pid]
    add("full_sum_decimal", f"sum(ps_supplycost) over ({part})", tot,
        scale=2)
    add("full_avg", f"avg(ps_supplycost) over ({part})",
        tot / 100.0 / s.size)
    add("full_max", f"max(ps_supplycost) over ({part})",
        np.maximum.reduceat(cost, s.starts)[s.pid], scale=2)
    add("full_count", f"count(*) over ({part})", s.size.astype(np.int64))
    rows = np.zeros(len(qty), np.int64)
    for d, ok, j in s.neighbours(2):
        if -2 <= d <= 1:
            rows += np.where(ok, qty[j], 0)
    add("rows_frame_sum", f"sum(ps_availqty) over ({po} rows between 2 "
        f"preceding and 1 following)", rows)
    # RANGE over the order key: suppliers of a part lie 2500 apart at SF1
    span = 3000
    lo = qty.copy()
    hi = cost.copy()
    for d, ok, j in s.neighbours(8):
        near = ok & (np.abs(key[j] - key) <= span)
        lo = np.where(near, np.minimum(lo, qty[j]), lo)
        hi = np.where(near, np.maximum(hi, cost[j]), hi)
    rng = f"range between {span} preceding and {span} following"
    add("range_frame_min", f"min(ps_availqty) over ({po} {rng})", lo)
    add("range_frame_max", f"max(ps_supplycost) over ({po} {rng})", hi,
        scale=2)

    li = data["lineitem"]
    s = _Sorted(li["l_orderkey"], li["l_linenumber"])
    lq = s.col(li["l_quantity"]).astype(np.int64)     # hundredths
    ln = s.col(li["l_linenumber"]).astype(np.int64)
    cs = np.cumsum(lq)
    run = cs - np.where(s.start > 0, cs[s.start - 1], 0)
    lpo = "partition by l_orderkey order by l_linenumber"
    # the shape of TPC-DS Q89: a window in a derived table, filtered and
    # aggregated outside
    big = run > 100_00
    cases.append((
        "lineitem_running_sum_filtered",
        f"select sum(run) as s, sum(l_linenumber) as sl, count(*) as c "
        f"from (select l_linenumber, sum(l_quantity) over ({lpo}) as run "
        f"from lineitem) t where run > 100",
        (int(run[big].sum()), int(ln[big].sum()) * 100, int(big.sum())),
        2))
    lagq = np.full(len(lq), np.nan)
    for d, ok, j in s.neighbours(2):
        if d == -2:
            lagq[ok] = lq[j][ok]
    add("lineitem_lag2", f"lag(l_quantity, 2) over ({lpo})", lagq,
        table="lineitem", k="l_linenumber", kv=ln, scale=2)
    # RANGE over shipdate within the order: at most 7 lines an order
    s2 = _Sorted(li["l_orderkey"],
                 li["l_shipdate"].astype("datetime64[D]").astype(np.int64))
    ext = s2.col(li["l_extendedprice"]).astype(np.int64)
    ln2 = s2.col(li["l_linenumber"]).astype(np.int64)
    mx = ext.copy()
    for d, ok, j in s2.neighbours(7):
        near = ok & (np.abs(s2.order[j] - s2.order) <= 30)
        mx = np.where(near, np.maximum(mx, ext[j]), mx)
    add("lineitem_range_frame_max",
        "max(l_extendedprice) over (partition by l_orderkey order by "
        "l_shipdate range between 30 preceding and 30 following)", mx,
        table="lineitem", k="l_linenumber", kv=ln2, scale=2)
    return cases


def _scaled(v, scale: int):
    """A result cell as a physical number: decimals and integers times
    10^scale, floats as they are."""
    if v is None or isinstance(v, float):
        return v
    return int(v.scaleb(scale)) if hasattr(v, "scaleb") \
        else int(v) * 10 ** scale


def phase_window(dev, eng: Engine, resident: int, data) -> None:
    t0 = time.perf_counter()
    cases = _window_cases(data)
    _log(f"window: numpy oracle for {len(cases)} statements "
         f"{time.perf_counter() - t0:.2f} s")
    _zero_launches()                    # the window path starts here
    for name, sql, want, scale in cases:
        torch.cuda.reset_peak_memory_stats(dev)
        falls0 = fragment.STATS["fallbacks"]
        times = []
        for _ in range(1 + EXEC_WARM_RUNS):
            t0 = time.perf_counter()
            rows = list(eng.query(sql).rows)
            times.append(time.perf_counter() - t0)
        if fragment.STATS["fallbacks"] - falls0 != 1 + EXEC_WARM_RUNS:
            raise AssertionError(f"window {name}: expected one fallback a "
                                 f"run")
        if len(rows) != 1:
            raise AssertionError(f"window {name}: {len(rows)} rows")
        # the two sums carry the window value's scale (the second
        # multiplies it by an integer); the count is an integer
        got = tuple(_scaled(v, scale) for v in rows[0][:2]) + \
            (_scaled(rows[0][2], 0),)
        for g, w in zip(got, want):
            ok = (np.isclose(g, w, rtol=EXEC_RTOL, atol=0)
                  if isinstance(w, float) else g == w)
            if not ok:
                raise AssertionError(f"window {name}: {got} != numpy "
                                     f"{want}")
        peak = torch.cuda.max_memory_allocated(dev) - resident
        n_waits, n_in_plan = host_waits(eng, sql)
        _log(f"window: {name} equal to numpy {want}; cold "
             f"{times[0] * 1e3:.1f} ms, warm "
             f"{', '.join(f'{w * 1e3:.2f}' for w in times[1:])} ms; host "
             f"waits {n_waits} ({n_in_plan} inside the executor); peak "
             f"device memory above the tables {peak / 2**20:.1f} MiB")
    _no_launches("the window phase")


def phase_window_primitives(dev) -> None:
    """Device times of the window primitives (ops/window.py) at 2^20 and
    2^23 rows, partitions of 1 to 7 rows, by CUDA events."""
    for n in (1 << 20, 1 << 23):
        g = torch.Generator(device=dev).manual_seed(n)
        part = torch.cumsum(torch.rand(n, generator=g, device=dev) < 0.25,
                            0)
        bound = W._multi_boundary((part,), n)
        order = torch.cumsum(torch.randint(0, 40, (n,), generator=g,
                                           device=dev), 0)
        v = torch.randint(-1000, 1000, (n,), generator=g, device=dev)
        pb = Column(BOOL, bound, n)
        col = Column(I64, v, n)
        size, pid = W._part_size(bound, n)
        start = W._seg_start(bound, pid)
        end = start + size
        n_iter = math.ceil(math.log2(n)) + 1
        timed = {
            "_seg_start": lambda: W._seg_start(bound),
            "_next_start": lambda: W._next_start(bound),
            "cummax (the running max it replaces)":
                lambda: torch.cummax(torch.where(bound, torch.arange(
                    n, device=dev), 0), 0),
            "_seg_scan sum int64": lambda: W._seg_scan(v, bound, op="sum"),
            "_seg_scan max int64": lambda: W._seg_scan(v, bound, op="max"),
            "_seg_scan sum float64":
                lambda: W._seg_scan(v.double(), bound, op="sum"),
            "_part_lower_bound (RANGE bound search)":
                lambda: W._part_lower_bound(order, start, end, order - 30,
                                            n_iter=n_iter, strict=False),
            "framed_agg max RANGE 30 preceding..30 following":
                lambda: W.framed_agg("max", col, pb, order, "range", -30,
                                     30, n),
            "framed_agg max ROWS 2 preceding..1 following":
                lambda: W.framed_agg("max", col, pb, None, "rows", -2, 1,
                                     n),
            "windowed_agg max running": lambda: W.windowed_agg(
                "max", col, pb, None, "rows", n),
        }
        for name, fn in timed.items():
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            ms = time_cuda(fn, reps=5, warmup=1)
            peak = torch.cuda.max_memory_allocated(dev) - base
            _log(f"window-primitive: n={n} {name}: {ms:.3f} ms, peak "
                 f"{peak / 2**20:.0f} MiB above its inputs")


def _sqlite_of(data, queries) -> sqlite3.Connection:
    """The generated arrays as an in-memory sqlite database: only the
    columns the statements name, inserted in chunks.  A dense surrogate key
    (1..n) is declared the table's primary key, so that sqlite scans the
    fact table once and looks each dimension row up by rowid; without it
    one star join over 2,880,404 rows takes most of a minute."""
    text = " ".join(queries.values())
    con = sqlite3.connect(":memory:")
    for tname, cols in data.items():
        names = [c for c in cols if c in text] or list(cols)[:1]
        n = len(cols[names[0]])
        decl = [f"{c} integer primary key" if c == names[0] and np.array_equal(
            cols[c], np.arange(1, n + 1)) else c for c in names]
        con.execute(f"create table {tname} ({', '.join(decl)})")
        ins = f"insert into {tname} values ({','.join('?' * len(names))})"
        for lo in range(0, n, 200_000):
            con.executemany(ins, zip(*(cols[c][lo:lo + 200_000].tolist()
                                       for c in names)))
    con.commit()
    con.execute("analyze")
    return con


def _ds_cell_differs(g, w) -> bool:
    if isinstance(g, float) or isinstance(w, float):
        if g is None or w is None:
            return g is not w
        return not np.isclose(float(g), float(w), rtol=EXEC_RTOL,
                              atol=EXEC_RTOL)
    return g != w


def phase_tpcds(dev, seg_entry: dict) -> None:
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated(dev)
    cat, data = tpcds.load_tpcds(TPCDS_ROWS, device=dev)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    _log(f"tpcds: load_tpcds({TPCDS_ROWS}, device={dev}) "
         f"{time.perf_counter() - t0:.2f} s, store_sales "
         f"{cat.get('store_sales').count} rows, item "
         f"{cat.get('item').count}, customer {cat.get('customer').count}; "
         f"tables resident {(resident - base) / 2**20:.1f} MiB")
    t0 = time.perf_counter()
    con = _sqlite_of(data, tpcds.QUERIES)
    _log(f"tpcds: sqlite3 load {time.perf_counter() - t0:.2f} s")
    eng = Engine(cat)
    _zero_launches()                    # the TPC-DS path starts here
    for qid in sorted(tpcds.QUERIES, key=int):
        sql = tpcds.QUERIES[qid]
        t0 = time.perf_counter()
        want = [tuple(r) for r in con.execute(sql).fetchall()]
        if not want and qid == "53":
            # at this scale no quarter of a manufacturer lies 10% off its
            # average (each sums over a thousand sales); hold the window to
            # the oracle at 1% instead, where rows come out
            sql = sql.replace("> 0.1", "> 0.01")
            want = [tuple(r) for r in con.execute(sql).fetchall()]
        t_oracle = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        falls0 = fragment.STATS["fallbacks"]
        before = CK.LAUNCHES["seg_sum64"]
        times = []
        for _ in range(1 + EXEC_WARM_RUNS):
            t0 = time.perf_counter()
            rows = list(eng.query(sql).rows)
            times.append(time.perf_counter() - t0)
        fell = fragment.STATS["fallbacks"] - falls0
        expect = (1 + EXEC_WARM_RUNS) if qid in TPCDS_FALLBACKS else 0
        if fell != expect:
            raise AssertionError(f"tpcds Q{qid}: {fell} fallbacks, "
                                 f"expected {expect}")
        got = [tuple(float(v) if hasattr(v, "scaleb") else v for v in r)
               for r in rows]
        if len(got) != len(want) or not want or any(
                len(g) != len(w) or any(map(_ds_cell_differs, g, w))
                for g, w in zip(got, want)):
            raise AssertionError(f"tpcds Q{qid} != sqlite3: {len(got)} vs "
                                 f"{len(want)} rows; {got[:3]} vs "
                                 f"{want[:3]}")
        peak = torch.cuda.max_memory_allocated(dev) - resident
        _log(f"tpcds: Q{qid} rows={len(rows)} equal to sqlite3 "
             f"({t_oracle:.1f} s there); "
             f"{'executor (fallback)' if expect else 'fragment'}; cold "
             f"{times[0] * 1e3:.1f} ms, warm "
             f"{', '.join(f'{w * 1e3:.2f}' for w in times[1:])} ms; "
             f"seg_sum64 launches {CK.LAUNCHES['seg_sum64'] - before}; peak "
             f"device memory above the tables {peak / 2**20:.1f} MiB")
    seg_entry["launches_tpcds"] = CK.LAUNCHES["seg_sum64"]
    if seg_entry["launches_tpcds"] <= 0:
        raise AssertionError("the TPC-DS fragments launched no seg_sum64")

# ---------------------------------------------------------------------------
# Session and storage: the SQL front door over a store, in memory and on
# disk, and the sqllogic corpus
# ---------------------------------------------------------------------------

#: warm runs of each query through Session.sql (one cold run before them)
SESSION_WARM_RUNS = 3
#: TPC-H's refresh functions at their SF1 size (TPC-H Specification
#: v3.0.1, section 2.5: RF1 inserts and RF2 deletes SF * 1,500 orders with
#: their lineitems); UPDATE_ORDERS orders get their l_discount raised
REFRESH_ORDERS = 1500
UPDATE_ORDERS = 10_000
_SQL_TYPE = {"i32": "int", "dec2": "decimal(15,2)", "date": "date"}


def phase_session(dev, data, want: dict, frag: dict, seg_entry: dict):
    """The 22 queries through ``Session.sql`` over ``load_tpch_db(SF)`` on
    the card: rows equal to the oracle, no fallback, per warm run the
    fragment phase's seg_sum64 launches, warm runs served by the session's
    plan cache, and each table materialized on the card once."""
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    db = load_tpch_db(SF, data=data, device=dev)
    _log(f"session: load_tpch_db({SF}, device={dev}) "
         f"{time.perf_counter() - t0:.2f} s (host tables; uploads happen "
         f"at first use)")
    s = Session(db)
    _zero_launches()                    # the session path starts here
    falls0 = fragment.STATS["fallbacks"]
    cache0 = plan_cache_stats()
    first = {}                          # table -> its one materialization
    medians = {}
    per_run = {}                        # seg_sum64 launches a warm run
    for q in SLICE_QUERIES:
        sql = QUERIES[q]
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        rows = list(s.sql(sql).rows)
        cold = time.perf_counter() - t0
        bound = s._plan_cache.get(" ".join(sql.split()))
        for name, (_v, tbl, _oids) in db._device.items():
            first.setdefault(name, tbl)
        warm = []
        for _ in range(SESSION_WARM_RUNS):
            last = CK.LAUNCHES["seg_sum64"]
            t0 = time.perf_counter()
            wrows = list(s.sql(sql).rows)
            warm.append(time.perf_counter() - t0)
            if wrows != rows:
                raise AssertionError(f"session Q{q}: warm rows differ")
        launched = CK.LAUNCHES["seg_sum64"] - last
        per_run[q] = launched              # the last warm run's
        if bound is None or s._plan_cache.get(" ".join(sql.split())) \
                is not bound:
            raise AssertionError(f"session Q{q}: a warm run bound the "
                                 f"query again")
        diff = tpch_oracle.rows_differ(
            rows, tpch_oracle.decoded(q, want[q]), AVG_RTOL)
        if diff or not rows:
            raise AssertionError(f"session Q{q} != oracle: "
                                 f"{diff or 'no rows'}")
        if per_run[q] != frag[q]["launches"]:
            raise AssertionError(
                f"session Q{q}: {launched} seg_sum64 launches a warm run, "
                f"the fragment phase's fresh lowering "
                f"{frag[q]['launches']}")
        medians[q] = statistics.median(warm) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - base
        _log(f"session: Q{q} SF{SF} rows={len(rows)} equal to oracle; cold "
             f"{cold * 1e3:.1f} ms, warm "
             f"{', '.join(f'{w * 1e3:.2f}' for w in warm)} ms (median "
             f"{medians[q]:.2f} ms, Engine {frag[q]['median_ms']:.2f} ms); "
             f"seg_sum64 launches a warm run {launched}; peak device "
             f"memory {peak / 2**20:.1f} MiB")
    if fragment.STATS["fallbacks"] != falls0:
        raise AssertionError("the session phase fell back to the executor")
    stale = [n for n, t in first.items() if db._device[n][1] is not t]
    if stale or sorted(first) != sorted(db.tables) or any(
            v != db.tables[n].version for n, (v, _t, _o) in
            db._device.items()):
        raise AssertionError(f"tables materialized more than once: {stale}")
    seg_entry["launches_session"] = CK.LAUNCHES["seg_sum64"]
    if seg_entry["launches_session"] <= 0:
        raise AssertionError("the session path launched no seg_sum64")
    _log(f"session: 22 queries equal to the oracle, 0 fallbacks, "
         f"seg_sum64 launches {seg_entry['launches_session']}; each of "
         f"{len(first)} tables materialized once "
         f"({(torch.cuda.memory_allocated(dev) - base) / 2**20:.1f} MiB "
         f"on the card with __rowid__); bound plans cached by the session "
         f"({len(s._plan_cache)}), engine plan cache {cache0} -> "
         f"{plan_cache_stats()} (Session.sql lowers at every run)")
    _log("session: warm medians ms, Session / Engine: " + ", ".join(
        f"Q{q} {medians[q]:.2f}/{frag[q]['median_ms']:.2f}"
        for q in SLICE_QUERIES))
    return db, per_run, medians


#: the spmd phase: 8 shards on the one card (the reference's dry run uses
#: 8 devices), 3 warm runs a query, 2^23 rows for the shuffle primitives
SPMD_SHARDS = 8
SPMD_WARM_RUNS = 3
SPMD_SHUFFLE_ROWS = 1 << 23
#: queries whose host waits are counted on the mesh
SPMD_WAIT_QUERIES = (1, 3, 6, 13, 18)
#: the reference dry run's scaled thresholds (__graft_entry__.py:105-107),
#: for a second pass if SF1 at the default thresholds shuffles no group-by
SPMD_DRYRUN = {"spmd_min_shard_rows": 64, "spmd_broadcast_rows": 4096,
               "spmd_shuffle_min_rows": 64}
_SPMD_COUNTS = ("runs", "spmd_runs", "shuffle_joins", "shuffle_groupbys",
                "shuffle_distincts", "cap_retries")


def _np_group_sums(k: np.ndarray, v: np.ndarray) -> dict:
    order = np.argsort(k, kind="stable")
    ks, vs = k[order], v[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    return dict(zip(ks[starts].tolist(),
                    np.add.reduceat(vs, starts).tolist()))


def _mesh_group_sums(keys, sums, live) -> dict:
    lv = live.cpu().numpy().astype(bool)
    return dict(zip(keys.cpu().numpy()[lv].tolist(),
                    sums.cpu().numpy()[lv].tolist()))


def phase_spmd(dev, db, want: dict, frag: dict, sess_medians: dict,
               seg: dict, q1: dict, gsl: dict) -> None:
    """The SPMD row mesh on the card: ``row_mesh([cuda:0] * 8)``, one
    thread per shard (monetdb_tpu_torch/parallel/).  The 22 queries through
    ``Session(db, mesh=mesh).sql`` over the session phase's SF1 store
    (rows equal to the oracle; the mesh must run at least 20 of them,
    shuffle a join and a group-by or distinct); host waits inside the
    shards must be 0; Q1 and Q6 again with the cross-shard replication
    check (assert_props); then sharded_q6 / sharded_q1 over the store's
    lineitem (exact; 8 q1_grouped_sums launches a call) and the shuffle
    primitives over 2^23 int64 rows, uniform and Zipf, against numpy."""
    mesh = row_mesh([dev] * SPMD_SHARDS)
    s = Session(db, mesh=mesh)
    db.catalog()                        # the tables are on the card already
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tables = torch.cuda.memory_allocated(dev)
    _log(f"spmd: {mesh} over the session phase's store "
         f"({tables / 2**20:.1f} MiB on the card); {_dispatch_cost(dev)}")
    _spmd_sql(dev, s, want, frag, sess_medians, seg, tables)
    config.set("assert_props", True)    # every shard's outputs compared
    try:
        for q in (1, 6):
            r0 = fragment.STATS["spmd_runs"]
            rows = list(s.sql(QUERIES[q]).rows)
            diff = tpch_oracle.rows_differ(
                rows, tpch_oracle.decoded(q, want[q]), AVG_RTOL)
            if diff or fragment.STATS["spmd_runs"] != r0 + 1:
                raise AssertionError(f"spmd Q{q} with assert_props: "
                                     f"{diff or 'did not run on the mesh'}")
    finally:
        config.reset("assert_props")
    _log("spmd: Q1 and Q6 with assert_props: every shard's outputs equal, "
         "rows equal to the oracle")
    waits = []
    for q in SPMD_WAIT_QUERIES:
        n_waits, n_in_plan = host_waits(s._engine(), QUERIES[q])
        waits.append(f"Q{q} {n_waits} ({n_in_plan} inside the shards)")
        if n_in_plan:
            raise AssertionError(f"spmd Q{q}: {n_in_plan} host waits inside "
                                 f"the shards")
    _log(f"spmd: host waits a warm run: {', '.join(waits)}")
    li = db.table("lineitem")[0]
    _spmd_kernel_steps(dev, mesh, li, want, q1, gsl)
    del li, s
    gc.collect()
    torch.cuda.empty_cache()
    _spmd_shuffles(dev, mesh)


def _dispatch_cost(dev) -> str:
    """Host microseconds an eager op takes when 1 thread runs 2,000 of
    them, and when each of SPMD_SHARDS threads runs 2,000 at once (wall
    over all ops): what the shards of a mesh on one card pay per op."""
    x = torch.zeros(8, device=dev)
    n = 2000

    def ops():
        for _ in range(n):
            torch.where(x > 0, x, x)

    out = []
    for threads in (1, SPMD_SHARDS):
        torch.cuda.synchronize()
        workers = [threading.Thread(target=ops) for _ in range(threads)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / (n * threads) * 1e6)
    return (f"host cost per eager op: {out[0]:.2f} us from 1 thread, "
            f"{out[1]:.2f} us from {SPMD_SHARDS} threads at once")


def _spmd_sql(dev, s, want, frag, sess_medians, seg, tables) -> None:
    _zero_launches()                    # the spmd SQL path starts here
    meshed = 0
    total = dict.fromkeys(_SPMD_COUNTS, 0)
    falls0 = fragment.STATS["fallbacks"]
    for q in SLICE_QUERIES:
        sql = QUERIES[q]
        torch.cuda.reset_peak_memory_stats(dev)
        stats0 = dict(fragment.STATS)
        before = CK.LAUNCHES["seg_sum64"]
        t0 = time.perf_counter()
        rows = list(s.sql(sql).rows)
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(SPMD_WARM_RUNS):
            mesh0 = dict(MESH.STATS)    # the last warm run's collectives
            t0 = time.perf_counter()
            wrows = list(s.sql(sql).rows)
            warm.append(time.perf_counter() - t0)
            if wrows != rows:
                raise AssertionError(f"spmd Q{q}: warm rows differ")
        colls = MESH.STATS["collectives"] - mesh0["collectives"]
        sent = MESH.STATS["bytes"] - mesh0["bytes"]
        diff = tpch_oracle.rows_differ(
            rows, tpch_oracle.decoded(q, want[q]), AVG_RTOL)
        if diff or not rows:
            raise AssertionError(f"spmd Q{q} != oracle: {diff or 'no rows'}")
        d = {k: fragment.STATS[k] - stats0[k] for k in _SPMD_COUNTS}
        for k in _SPMD_COUNTS:
            total[k] += d[k]
        # on the mesh: every run of the query (a run the mesh gives up on
        # runs again on one device and counts twice under "runs")
        meshed += 0 < d["spmd_runs"] == d["runs"]
        med = statistics.median(warm) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - tables
        _log(f"spmd: Q{q} SF{SF} rows={len(rows)} equal to oracle; cold "
             f"{cold * 1e3:.1f} ms, warm "
             f"{', '.join(f'{w * 1e3:.2f}' for w in warm)} ms (median "
             f"{med:.2f} ms; one device: Session {sess_medians[q]:.2f} ms, "
             f"Engine {frag[q]['median_ms']:.2f} ms); seg_sum64 launches "
             f"{CK.LAUNCHES['seg_sum64'] - before} in {1 + SPMD_WARM_RUNS} "
             f"runs; spmd_runs {d['spmd_runs']}, shuffle joins / group-bys "
             f"/ distincts {d['shuffle_joins']} / {d['shuffle_groupbys']} / "
             f"{d['shuffle_distincts']}, cap_retries {d['cap_retries']}; "
             f"a warm run: {colls} collectives a shard, "
             f"{sent / 2**20:.1f} MiB handed to them; peak device memory "
             f"above the tables {peak / 2**20:.1f} MiB")
    seg["launches_spmd"] = CK.LAUNCHES["seg_sum64"]
    q_launch = CK.LAUNCHES["q1_grouped_sums"]
    g_launch = CK.LAUNCHES["grouped_sum_limbs"]
    _log(f"spmd: 22 queries equal to the oracle; the mesh ran {meshed} of "
         f"them; totals {total}; seg_sum64 launches {seg['launches_spmd']}")
    if fragment.STATS["fallbacks"] != falls0:
        raise AssertionError("the spmd phase fell back to the executor")
    if meshed < 20:
        raise AssertionError(f"SQL ran on the mesh only {meshed}/22 times")
    if seg["launches_spmd"] <= 0 or q_launch or g_launch:
        raise AssertionError(f"spmd SQL path launches {CK.LAUNCHES}")
    if total["shuffle_joins"] <= 0:
        raise AssertionError("no SQL join hash-repartitioned through the "
                             "all-to-all shuffle")
    if total["shuffle_groupbys"] + total["shuffle_distincts"] <= 0:
        _log("spmd: no group-by or distinct shuffled at the default "
             "thresholds; second pass at the dry run's thresholds "
             f"{SPMD_DRYRUN}")
        _spmd_dryrun_pass(s, want)


def _spmd_dryrun_pass(s, want) -> None:
    for k, v in SPMD_DRYRUN.items():
        config.set(k, v)
    try:
        stats0 = dict(fragment.STATS)
        for q in SLICE_QUERIES:
            rows = list(s.sql(QUERIES[q]).rows)
            diff = tpch_oracle.rows_differ(
                rows, tpch_oracle.decoded(q, want[q]), AVG_RTOL)
            if diff:
                raise AssertionError(f"spmd dry-run pass Q{q}: {diff}")
        d = {k: fragment.STATS[k] - stats0[k] for k in _SPMD_COUNTS}
    finally:
        for k in SPMD_DRYRUN:
            config.reset(k)
    _log(f"spmd: dry-run thresholds pass: 22 queries equal to the oracle; "
         f"totals {d}")
    if d["shuffle_groupbys"] + d["shuffle_distincts"] <= 0:
        raise AssertionError("no SQL group-by/distinct repartitioned "
                             "through the shuffle")


def _spmd_kernel_steps(dev, mesh, li, want, q1: dict, gsl: dict) -> None:
    """sharded_q6 and sharded_q1 over the store's lineitem on the card."""
    n = li.count
    rf, ls = li.col("l_returnflag"), li.col("l_linestatus")
    n_ls = len(ls.sdict.values)

    def col(name, dtype=torch.int32):
        return li.col(name).data[:n].to(dtype)

    code = (rf.data[:n].to(torch.int32) * n_ls
            + ls.data[:n].to(torch.int32))
    lo = int((np.datetime64("1994-01-01")
              - np.datetime64("1970-01-01")).astype(int))
    hi = int((np.datetime64("1995-01-01")
              - np.datetime64("1970-01-01")).astype(int))
    cutoff = int((np.datetime64("1998-12-01") - 90
                  - np.datetime64("1970-01-01")).astype(int))
    q6_args = (shard_array(col("l_shipdate"), mesh),
               shard_array(col("l_discount"), mesh, fill=-1),
               shard_array(col("l_quantity"), mesh, fill=1 << 30),
               shard_array(col("l_extendedprice"), mesh))
    q1_args = [shard_array(code, mesh, fill=-1)] + [
        shard_array(col(c), mesh) for c in (
            "l_shipdate", "l_quantity", "l_extendedprice", "l_discount",
            "l_tax")]
    step6, step1 = sharded_q6(mesh), sharded_q1(mesh, domain=FUSED_DOMAIN)
    _zero_launches()                    # the sharded kernel steps start here
    rev = step6(*q6_args, lo, hi, 5, 7, 2400)
    sums = step1(*q1_args, cutoff)
    torch.cuda.synchronize()
    q1["launches_spmd"] = CK.LAUNCHES["q1_grouped_sums"]
    gsl["launches_spmd"] = CK.LAUNCHES["grouped_sum_limbs"]
    if q1["launches_spmd"] != SPMD_SHARDS or gsl["launches_spmd"]:
        raise AssertionError(f"sharded_q1 launches {CK.LAUNCHES}, expected "
                             f"{SPMD_SHARDS} q1_grouped_sums")
    if int(rev) != want[6][0][0]:
        raise AssertionError(f"sharded_q6 {int(rev)} != oracle {want[6]}")
    sums = [x.tolist() for x in sums]
    live = [g for g in range(FUSED_DOMAIN) if sums[5][g]]
    got = [(str(rf.sdict.values[g // n_ls]), str(ls.sdict.values[g % n_ls]),
            sums[0][g], sums[1][g], sums[2][g], sums[3][g], sums[5][g])
           for g in live]
    if got != [w[:6] + w[9:] for w in want[1]]:
        raise AssertionError(f"sharded_q1 {got} != oracle {want[1]}")
    ms6 = time_cuda(lambda: step6(*q6_args, lo, hi, 5, 7, 2400), reps=10,
                    warmup=2)
    ms1 = time_cuda(lambda: step1(*q1_args, cutoff), reps=10, warmup=2)
    _log(f"spmd: sharded_q6 over {n} rows in {SPMD_SHARDS} shards equal to "
         f"the oracle's revenue, {ms6:.3f} ms (CUDA events around the "
         f"call); sharded_q1 equal to the oracle's Q1 sums and counts with "
         f"{q1['launches_spmd']} q1_grouped_sums launches, {ms1:.3f} ms")


def _spmd_shuffles(dev, mesh) -> None:
    """lane_counts, dist_group_sum, dist_group_sum_auto and dist_fk_join
    over SPMD_SHUFFLE_ROWS int64 rows against numpy, exactly."""
    n = SPMD_SHUFFLE_ROWS
    d = mesh.size
    g = torch.Generator(device=dev).manual_seed(77)
    uni = torch.randint(0, 1 << 20, (n,), generator=g, device=dev)
    # Zipf(2.0) by inverse transform over 1..2^20 (a hot key 1 of ~61%)
    ranks = torch.arange(1, (1 << 20) + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(ranks ** -2.0, 0)
    zipf = torch.searchsorted(cdf / cdf[-1], torch.rand(
        n, generator=g, device=dev, dtype=torch.float64)) + 1
    vals = torch.randint(-(1 << 40), 1 << 40, (n,), generator=g, device=dev)
    live = torch.rand(n, generator=g, device=dev) < 0.95
    v_np, lv_np = vals.cpu().numpy(), live.cpu().numpy()
    for name, keys in (("uniform", uni), ("zipf", zipf)):
        k_np = keys.cpu().numpy()
        t0 = time.perf_counter()
        counts = SH.lane_counts(mesh, keys, live)
        dest = MP.np_hash64(k_np) % d
        want_counts = np.stack([
            np.bincount(dest[r * n // d:(r + 1) * n // d][
                lv_np[r * n // d:(r + 1) * n // d]], minlength=d)
            for r in range(d)])
        if not np.array_equal(counts, want_counts):
            raise AssertionError(f"lane_counts ({name}) != numpy")
        exp = _np_group_sums(k_np[lv_np], v_np[lv_np])
        cap = capacity_for(int(counts.max()))
        got = _mesh_group_sums(*SH.dist_group_sum(mesh, keys, vals, live,
                                                  cap))
        if got != exp:
            raise AssertionError(f"dist_group_sum ({name}) != numpy")
        *out, info = SH.dist_group_sum_auto(mesh, keys, vals, live)
        if _mesh_group_sums(*out) != exp:
            raise AssertionError(f"dist_group_sum_auto ({name}) != numpy")
        torch.cuda.synchronize()
        _log(f"spmd: {name} keys over {n} rows: lane_counts, "
             f"dist_group_sum (lane {cap}) and dist_group_sum_auto "
             f"({info}) equal to numpy ({len(exp)} groups), "
             f"{time.perf_counter() - t0:.2f} s")
    nr = 1 << 20                        # build side: unique keys 0..nr-1
    rk = torch.arange(nr, device=dev)
    rv = rk * 1000 + 7
    rlive = torch.ones(nr, dtype=torch.bool, device=dev)
    lk = torch.randint(0, nr + nr // 4, (n,), generator=g, device=dev)
    t0 = time.perf_counter()
    cap = capacity_for(int(max(SH.lane_counts(mesh, lk, live).max(),
                               SH.lane_counts(mesh, rk, rlive).max())))
    ok, (olv, orv), hit = SH.dist_fk_join(mesh, lk, [vals], live, rk, [rv],
                                          rlive, cap)
    h = hit.cpu().numpy()
    got = np.stack([ok.cpu().numpy()[h], olv.cpu().numpy()[h],
                    orv.cpu().numpy()[h]])
    lk_np = lk.cpu().numpy()
    m = lv_np & (lk_np < nr)
    exp = np.stack([lk_np[m], v_np[m], lk_np[m] * 1000 + 7])
    order_g = np.lexsort(got[:2][::-1])
    order_e = np.lexsort(exp[:2][::-1])
    if not np.array_equal(got[:, order_g], exp[:, order_e]):
        raise AssertionError("dist_fk_join != numpy")
    _log(f"spmd: dist_fk_join of {n} probe rows against {nr} keys (lane "
         f"{cap}) equal to numpy ({int(m.sum())} matches), "
         f"{time.perf_counter() - t0:.2f} s")


#: the procs phase: PROCS_RANKS ranks on the one card over host-staged gloo
#: (NCCL refuses two ranks on one card), 2^24 int64 rows globally, the
#: kernel phase's 24,000,000 Q1 / Q6 rows, PROCS_WARM timed runs a primitive
PROCS_RANKS = 2
PROCS_ROWS_LOG2 = 24
PROCS_WARM = 2
#: per rank, one pass over the primitives: two_phase_sum (1) and the int64
#: sharded_q1 (one a measure, 5) launch seg_sum64, the int32 sharded_q1
#: launches q1_grouped_sums once
PROCS_LAUNCHES = {"seg_sum64": 6, "q1_grouped_sums": 1,
                  "grouped_sum_limbs": 0}


def phase_procs(dev, seg: dict, q1: dict, gsl: dict) -> None:
    """The process mesh (monetdb_tpu_torch/parallel/dist.py): PROCS_RANKS
    ranks, each a process of its own on the one card, host-staged gloo
    between them, run the parallel primitives
    (monetdb_tpu_torch/bench/mesh_procs.py); every rank's output exact
    against numpy (in the rank) and against the shard of the same rank of
    ``row_mesh([cuda:0] * PROCS_RANKS)`` (here).  The ranks' kernel
    launches of the checked run add up into the kernels line."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res = MP.compare([str(dev)] * PROCS_RANKS, "gloo", PROCS_ROWS_LOG2,
                     FUSED_NS[0], warm=PROCS_WARM)
    want = {k: v * PROCS_RANKS for k, v in PROCS_LAUNCHES.items()}
    if res["launches"] != want:
        raise AssertionError(f"procs launches {res['launches_per_rank']}, "
                             f"expected {PROCS_LAUNCHES} a rank")
    seg["launches_procs"] = res["launches"]["seg_sum64"]
    q1["launches_procs"] = res["launches"]["q1_grouped_sums"]
    gsl["launches_procs"] = res["launches"]["grouped_sum_limbs"]
    _log(f"procs: {PROCS_RANKS} ranks, {res['mesh']} (host-staged gloo "
         f"collectives between the ranks' processes on {dev}), "
         f"{res['rows']} int64 rows and {res['fused_rows']} Q1 / Q6 rows; "
         f"ranks ran {res['procs_s']:.2f} s ({res['rank_seconds']}); lane "
         f"capacities {res['caps']}; launches a rank "
         f"{res['launches_per_rank'][0]}")
    MP.report(res)
    took = MP.fail_drill([str(dev)] * PROCS_RANKS, "gloo", 30.0)
    _log(f"procs: failure drill: rank {PROCS_RANKS - 1} raised after one "
         f"collective; every rank exited non-zero within {took:.2f} s")


#: the hybrid phase: HYBRID_PROCS processes of HYBRID_LOCAL shards each on
#: the one card, the procs phase's data
HYBRID_PROCS = 2
HYBRID_LOCAL = 2


def phase_hybrid(dev, seg: dict, q1: dict, gsl: dict) -> None:
    """The hybrid mesh (monetdb_tpu_torch/parallel/dist.py with several
    shards a process): HYBRID_PROCS processes of HYBRID_LOCAL shards each
    on the one card, host-staged gloo between the processes, run the
    parallel primitives (monetdb_tpu_torch/bench/mesh_procs.py); every
    global shard's output exact against numpy (in its process) and
    against the same shard of ``row_mesh([cuda:0] * 4)`` (here).  The
    processes' kernel launches of the checked run add up into the kernels
    line."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    shards = HYBRID_PROCS * HYBRID_LOCAL
    res = MP.compare([str(dev)] * shards, "gloo", PROCS_ROWS_LOG2,
                     FUSED_NS[0], warm=PROCS_WARM, local=HYBRID_LOCAL)
    want = {k: v * shards for k, v in PROCS_LAUNCHES.items()}
    if res["launches"] != want:
        raise AssertionError(f"hybrid launches {res['launches_per_rank']}, "
                             f"expected {PROCS_LAUNCHES} a shard")
    seg["launches_hybrid"] = res["launches"]["seg_sum64"]
    q1["launches_hybrid"] = res["launches"]["q1_grouped_sums"]
    gsl["launches_hybrid"] = res["launches"]["grouped_sum_limbs"]
    _log(f"hybrid: {HYBRID_PROCS} processes of {HYBRID_LOCAL} shards, "
         f"{res['mesh']} (host-staged gloo between the processes on {dev}, "
         f"by reference inside each), {res['rows']} int64 rows and "
         f"{res['fused_rows']} Q1 / Q6 rows; processes ran "
         f"{res['procs_s']:.2f} s ({res['rank_seconds']}); lane capacities "
         f"{res['caps']}; launches a process {res['launches_per_rank'][0]}")
    MP.report(res)
    took = MP.fail_drill([str(dev)] * shards, "gloo", 30.0,
                         local=HYBRID_LOCAL)
    _log(f"hybrid: failure drill: shard {shards - 1} raised after one "
         f"collective; both processes exited non-zero within {took:.2f} s")


def phase_harness(dev) -> None:
    """monetdb_tpu_torch/harness.py on the card: ``entry()``'s Q1 step
    equal to the same step over the same columns on the CPU, and
    ``dryrun_multichip(8)`` (it raises on a failed check)."""
    fn, args = harness.entry()
    got = fn(*args)
    want = fn(*[a.cpu() for a in args])
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("harness.entry() on the card != on the CPU")
    stats = harness.dryrun_multichip(8)
    _log(f"harness: entry() equal to its CPU run; dryrun_multichip(8) on "
         f"{dev} passed: spmd_runs {stats['spmd_runs']}, shuffle joins / "
         f"group-bys / distincts {stats['shuffle_joins']} / "
         f"{stats['shuffle_groupbys']} / {stats['shuffle_distincts']}")


#: clients that run the 22 queries at once in phase_server
SERVER_CLIENTS = 8


def _check_oracle(where: str, q: int, rows, want: dict) -> None:
    diff = tpch_oracle.rows_differ(rows, tpch_oracle.decoded(q, want[q]),
                                   AVG_RTOL)
    if diff or not rows:
        raise AssertionError(f"{where} Q{q} != oracle: {diff or 'no rows'}")


def phase_server(dev, db, data, want: dict, sess_launches: dict,
                 sess_medians: dict, seg_entry: dict) -> None:
    """The network front door over the SF1 store phase_session loaded on
    the card: one Client runs the 22 queries in JSON and in columnar mode
    (rows equal to the oracle, seg_sum64 launches a query equal to the
    session phase's), then SERVER_CLIENTS clients at once in seeded
    shuffled orders; errors leave the connection answering; TLS;
    challenge-response auth; dbapi.connect(host=...); the CLI as a
    subprocess; a remote table served by a second server on the card."""
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    srv = Server(db).start()
    host, port = srv.address
    try:
        _server_queries(dev, srv, want, sess_launches, sess_medians,
                        seg_entry)
        _server_concurrent(dev, srv, want, base)
        _server_errors(srv, want)
        _server_dbapi_cli(srv, want)
        _server_remote(dev, srv, data)
        _server_tls(dev, db, want)
        _server_auth(srv, db, want)
    finally:
        srv.stop()
    held = torch.cuda.memory_allocated(dev) - base
    _log(f"server: {host}:{port} stopped; device memory above the "
         f"session's tables {held / 2**20:+.1f} MiB")


def _server_queries(dev, srv, want, sess_launches, sess_medians,
                    seg_entry) -> None:
    cl = Client(*srv.address)
    _zero_launches()                    # the server path starts here
    falls0 = fragment.STATS["fallbacks"]
    walls = {}
    as_json = []                        # columnar requests answered in JSON
    for columnar in (False, True):
        mode = "columnar" if columnar else "json"
        for q in SLICE_QUERIES:
            last = CK.LAUNCHES["seg_sum64"]
            t0 = time.perf_counter()
            res = cl.sql(QUERIES[q], columnar=columnar)
            rows = list(res.rows)
            walls[(mode, q)] = (time.perf_counter() - t0) * 1e3
            launched = CK.LAUNCHES["seg_sum64"] - last
            _check_oracle(f"server {mode}", q, rows, want)
            if columnar and not isinstance(res, ColumnarResult):
                # a result with wide (lo, hi) sums has no raw columns
                # and travels as JSON, in both packages
                as_json.append(f"Q{q}")
            if launched != sess_launches[q]:
                raise AssertionError(
                    f"server {mode} Q{q}: {launched} seg_sum64 launches, "
                    f"the session phase's warm run {sess_launches[q]}")
    cl.close()
    if fragment.STATS["fallbacks"] != falls0:
        raise AssertionError("the server path fell back to the executor")
    seg_entry["launches_server"] = CK.LAUNCHES["seg_sum64"]
    if seg_entry["launches_server"] <= 0:
        raise AssertionError("the server path launched no seg_sum64")
    _log(f"server: 22 queries in JSON and in columnar mode equal to the "
         f"oracle, seg_sum64 launches {seg_entry['launches_server']} "
         f"(each query's equal to the session phase's warm run); columnar "
         f"requests answered in JSON (wide sums): "
         f"{', '.join(as_json) or 'none'}")
    _log("server: wall ms over the wire, JSON / columnar / Session.sql "
         "warm median: " + ", ".join(
             f"Q{q} {walls[('json', q)]:.2f}/{walls[('columnar', q)]:.2f}/"
             f"{sess_medians[q]:.2f}" for q in SLICE_QUERIES))


def _server_concurrent(dev, srv, want, base) -> None:
    import threading
    torch.cuda.reset_peak_memory_stats(dev)
    errors, walls = [], []

    def client(i):
        order = list(SLICE_QUERIES)
        np.random.default_rng(100 + i).shuffle(order)
        try:
            cl = Client(*srv.address)
            t0 = time.perf_counter()
            for q in order:
                _check_oracle(f"server client {i}", q,
                              list(cl.sql(QUERIES[q]).rows), want)
            walls.append(time.perf_counter() - t0)
            cl.close()
        except Exception:               # reported by the main thread
            errors.append(f"client {i}: {traceback.format_exc()}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("server: a client did not finish in 600 s")
    if errors:
        raise AssertionError("; ".join(errors[:4]))
    peak = torch.cuda.max_memory_allocated(dev) - base
    _log(f"server: {SERVER_CLIENTS} concurrent clients x 22 queries in "
         f"seeded shuffled orders, all rows equal to the oracle, in "
         f"{wall:.2f} s ({SERVER_CLIENTS * 22 / wall:.2f} queries/s; per "
         f"client {min(walls):.2f}-{max(walls):.2f} s); peak device memory "
         f"{peak / 2**20:.1f} MiB above the session's tables")


def _server_errors(srv, want) -> None:
    cl = Client(*srv.address)
    failed = []
    for bad in ("select nope from lineitem",
                "select l_quantity / (l_linenumber - l_linenumber) "
                "from lineitem"):
        try:
            cl.sql(bad)
        except RuntimeError as ex:
            failed.append(str(ex).split(":")[0])
        else:
            raise AssertionError(f"server: {bad!r} did not fail")
    _check_oracle("server after errors", 6, list(cl.sql(QUERIES[6]).rows),
                  want)
    cl.close()
    _log(f"server: failing statements answered with errors "
         f"({', '.join(failed)}); the connection then answers Q6 right")


def _server_dbapi_cli(srv, want) -> None:
    from monetdb_tpu_torch import dbapi
    host, port = srv.address
    for columnar in (False, True):
        con = dbapi.connect(host=host, port=port, columnar=columnar)
        cur = con.cursor()
        cur.execute(QUERIES[3])
        _check_oracle(f"dbapi columnar={columnar}", 3, cur.fetchall(), want)
        con.close()
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "monetdb_tpu_torch", "--host", host,
         "--port", str(port), "-s", QUERIES[6]], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    (revenue,), = tpch_oracle.decoded(6, want[6])
    if r.returncode or f" {revenue} " not in r.stdout or \
            "1 tuple" not in r.stdout:
        raise AssertionError(f"cli: rc {r.returncode}, stdout "
                             f"{r.stdout[-400:]!r}, stderr "
                             f"{r.stderr[-400:]!r}")
    _log(f"server: dbapi.connect(host=...) Q3 equal to the oracle in JSON "
         f"and columnar mode; python -m monetdb_tpu_torch --host -s Q6 "
         f"printed revenue {revenue} in "
         f"{time.perf_counter() - t0:.2f} s (a process of its own)")


def _server_remote(dev, srv, data) -> None:
    """A second Server on the card serves orders; the first store names it
    as a remote table and a query ships its predicate."""
    data = {"orders": data["orders"]}
    wdb = load_tpch_db(SF, data=data, device=dev)
    w = Server(wdb).start()
    try:
        h, p = w.address
        s = Session(srv.db)
        s.sql(f"create remote table r_orders (o_orderkey int, "
              f"o_orderdate date, o_totalprice decimal(15,2)) on "
              f"'{h}:{p}/orders'")
        sql = ("select o_orderkey, o_orderdate, o_totalprice from {} "
               "where o_orderdate < date '1992-01-08' and "
               "o_totalprice > 100000 order by o_orderkey")
        plan = "\n".join(r[0] for r in s.sql(
            "explain " + sql.format("r_orders")).rows)
        if "RemoteScan" not in plan or "where" not in plan:
            raise AssertionError(f"remote: predicate not shipped:\n{plan}")
        t0 = time.perf_counter()
        got = s.sql(sql.format("r_orders")).rows
        t_remote = time.perf_counter() - t0
        local = s.sql(sql.format("orders")).rows
        if got != local or not got:
            raise AssertionError(f"remote: {len(got)} rows != local "
                                 f"{len(local)}")
    finally:
        w.stop()
        wdb.close()
    _log(f"server: remote table over a second server on the card "
         f"(orders, {len(data['orders']['o_orderkey'])} rows there): the "
         f"predicate ships (RemoteScan ... where), {len(got)} rows equal to "
         f"the local table's in {t_remote * 1e3:.1f} ms")


def _server_tls(dev, db, want) -> None:
    if shutil.which("openssl") is None:
        _log("server: TLS not run: no openssl on this machine")
        return
    folder = tempfile.mkdtemp(prefix="mtpu_tls_")
    try:
        cert, key = (os.path.join(folder, f) for f in ("c.pem", "k.pem"))
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", key, "-out", cert, "-days", "1", "-subj",
             "/CN=127.0.0.1"], check=True, capture_output=True, timeout=120)
        tsrv = Server(db, tls=(cert, key)).start()
        try:
            h, p = tsrv.address
            cl = Client(h, p, tls=True, tls_verify=False)
            _check_oracle("server TLS", 6, list(cl.sql(QUERIES[6]).rows),
                          want)
            cl.close()
            try:
                Client(h, p).sql("select 1")
            except Exception:
                pass
            else:
                raise AssertionError("TLS: a plaintext client got an answer")
        finally:
            tsrv.stop()
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    _log("server: TLS with a throwaway certificate: Q6 equal to the "
         "oracle, a plaintext client refused")


def _server_auth(srv, db, want) -> None:
    db.create_user("alice", "secret")
    db.grant(["select"], "lineitem", "alice")
    h, p = srv.address
    cl = Client(h, p, "alice", "secret")
    _check_oracle("server auth", 6, list(cl.sql(QUERIES[6]).rows), want)
    cl.close()
    for user, pw in (("alice", "wrong"), ("bob", "secret")):
        try:
            Client(h, p, user, pw)
        except ConnectionError:
            continue
        raise AssertionError(f"auth: {user}/{pw} was let in")
    _log("server: challenge-response auth: alice with her password gets "
         "Q6 right; a wrong password and an unknown user are refused")


def _tpch_ddl(data) -> list:
    stmts = []
    for tname, cols in SCHEMA.items():
        decl = []
        for c, tag in cols.items():
            if tag == "str":
                width = max(1, int(np.char.str_len(data[tname][c]).max()))
                decl.append(f"{c} varchar({width})")
            else:
                decl.append(f"{c} {_SQL_TYPE[tag]}")
        stmts.append(f"create table {tname} ({', '.join(decl)})")
    return stmts


def _csv_text(cols: dict, tags: dict) -> str:
    """Rows as '|'-delimited text: decimals as d.dd, dates as ISO."""
    fields = []
    for c, tag in tags.items():
        v = cols[c]
        if tag == "dec2":
            fields.append([f"{x // 100}.{x % 100:02d}" for x in v.tolist()])
        elif tag == "date":
            fields.append(v.astype("datetime64[D]").astype(str).tolist())
        else:
            fields.append(v.astype(str).tolist())
    return "".join("|".join(r) + "\n" for r in zip(*fields))


def _load_durable(s, data, folder: str) -> int:
    """DDL by SQL, then every table by COPY BINARY (one .npy per numeric
    column, one text file per string column), but orders by COPY INTO from
    a CSV through the native parser.  Returns the rows loaded."""
    for st in _tpch_ddl(data):
        s.sql(st)
    total = 0
    for tname, tags in SCHEMA.items():
        cols = data[tname]
        if tname == "orders":
            path = os.path.join(folder, "orders.csv")
            with open(path, "w") as f:
                f.write(_csv_text(cols, tags))
            n = s.sql(f"copy into orders from '{path}'")
        else:
            paths = []
            for c, tag in tags.items():
                if tag == "str":
                    paths.append(os.path.join(folder, f"{tname}.{c}.txt"))
                    with open(paths[-1], "w") as f:
                        f.write("\n".join(cols[c].tolist()) + "\n")
                else:
                    paths.append(os.path.join(folder, f"{tname}.{c}.npy"))
                    np.save(paths[-1], cols[c])
            n = s.sql(f"copy binary into {tname} from ("
                      + ", ".join(f"'{p}'" for p in paths) + ")")
        if n != len(next(iter(cols.values()))):
            raise AssertionError(f"durable: {tname} loaded {n} rows")
        total += n
    return total


def _refresh_sql(tname: str, offset: int, upto: int) -> str:
    key = "o_orderkey" if tname == "orders" else "l_orderkey"
    cols = [f"{c} + {offset}" if c == key else c for c in SCHEMA[tname]]
    return (f"insert into {tname} select {', '.join(cols)} from {tname} "
            f"where {key} <= {upto}")


def _refreshed(data, keys):
    """The generated arrays with what phase_durable commits: RF1 (the
    first REFRESH_ORDERS orders by key copied under key + max key), RF2
    (the REFRESH_ORDERS orders from the (2 * REFRESH_ORDERS)-th key on
    deleted) and the l_discount update (UPDATE_ORDERS orders from the
    (4 * REFRESH_ORDERS)-th key on); all as numpy over the same arrays."""
    r = REFRESH_ORDERS
    kmax, upto = int(keys[-1]), int(keys[r - 1])
    lo, hi = int(keys[2 * r]), int(keys[3 * r - 1])
    ulo, uhi = int(keys[4 * r]), int(keys[4 * r + UPDATE_ORDERS - 1])
    out = dict(data)
    for tname, key in (("orders", "o_orderkey"), ("lineitem", "l_orderkey")):
        cols = data[tname]
        sel = cols[key] <= upto
        new = {c: v[sel] for c, v in cols.items()}
        new[key] = new[key] + np.int32(kmax)
        both = {c: np.concatenate([cols[c], new[c]]) for c in cols}
        keep = ~((both[key] >= lo) & (both[key] <= hi))
        out[tname] = {c: v[keep] for c, v in both.items()}
    li = out["lineitem"]
    li["l_discount"] = li["l_discount"] + np.where(
        (li["l_orderkey"] >= ulo) & (li["l_orderkey"] <= uhi), 1, 0)
    return out, (kmax, upto, lo, hi, ulo, uhi)


def _table_checks(data) -> dict:
    """table -> (SQL of count(*) and the sum of every integer and decimal
    column, the same from numpy with decimals in hundredths)."""
    checks = {}
    for tname, tags in SCHEMA.items():
        num = [c for c, tag in tags.items() if tag in ("i32", "dec2")]
        sql = (f"select count(*), "
               + ", ".join(f"sum({c})" for c in num) + f" from {tname}")
        cols = data[tname]
        want = [len(cols[num[0]])] + [int(cols[c].astype(np.int64).sum())
                                      for c in num]
        checks[tname] = (sql, want)
    return checks


def phase_durable(dev, data, seg_entry: dict) -> None:
    """A store on local disk at SF1: DDL by SQL, COPY BINARY and COPY INTO
    (native CSV parser), checkpoint, TPC-H RF1 / RF2 and an UPDATE as
    committed transactions, one RF1 rolled back, then a close without a
    checkpoint and a reopen that replays the WAL.  Every committed change
    must be read back, the rolled-back one must be absent, and the 22
    queries must equal the oracle over the changed arrays."""
    if not csv_native.native_available():
        raise AssertionError("the native CSV parser did not build")
    folder = tempfile.mkdtemp(prefix="mtpu_durable_")
    try:
        _durable(dev, data, folder, seg_entry)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def _durable(dev, data, folder: str, seg_entry: dict) -> None:
    path = os.path.join(folder, "db")
    wal = os.path.join(path, "wal.log")
    torch.cuda.empty_cache()
    db = Database(path, device=dev)
    s = Session(db)
    t0 = time.perf_counter()
    rows = _load_durable(s, data, folder)
    t_load = time.perf_counter() - t0
    wal_bytes = os.path.getsize(wal)
    _log(f"durable: DDL + COPY BINARY (7 tables) + COPY INTO orders from "
         f"CSV (native parser) {rows} rows in {t_load:.2f} s: "
         f"{rows / t_load:.0f} rows/s, WAL {wal_bytes / 1e6:.1f} MB "
         f"({wal_bytes / 1e6 / t_load:.1f} MB/s written)")
    t0 = time.perf_counter()
    db.checkpoint()
    _log(f"durable: checkpoint {time.perf_counter() - t0:.2f} s, WAL now "
         f"{os.path.getsize(wal)} bytes, data/ "
         f"{sum(os.path.getsize(os.path.join(path, 'data', f)) for f in os.listdir(os.path.join(path, 'data'))) / 1e6:.1f} MB")
    keys = np.sort(data["orders"]["o_orderkey"])
    changed, (kmax, upto, lo, hi, ulo, uhi) = _refreshed(data, keys)
    s.sql("select count(*) from lineitem")      # materialized before
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    s.sql("start transaction")                   # RF1
    n1 = s.sql(_refresh_sql("orders", kmax, upto))
    n2 = s.sql(_refresh_sql("lineitem", kmax, upto))
    s.sql("commit")
    t_rf1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.sql("start transaction")                   # RF2
    d2 = s.sql(f"delete from lineitem where l_orderkey between {lo} and "
               f"{hi}")
    d1 = s.sql(f"delete from orders where o_orderkey between {lo} and {hi}")
    s.sql("commit")
    t_rf2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    u = s.sql(f"update lineitem set l_discount = l_discount + 0.01 where "
              f"l_orderkey between {ulo} and {uhi}")
    t_upd = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.sql("select count(*) from lineitem")
    t_next = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.sql("select count(*) from lineitem")
    t_again = time.perf_counter() - t0
    s.sql("start transaction")                   # RF1, rolled back
    r1 = s.sql(_refresh_sql("orders", 2 * kmax, upto))
    r2 = s.sql(_refresh_sql("lineitem", 2 * kmax, upto))
    s.sql("rollback")
    peak = torch.cuda.max_memory_allocated(dev) - before
    after = torch.cuda.memory_allocated(dev) - before
    want_counts = (REFRESH_ORDERS, len(changed["lineitem"]["l_orderkey"])
                   - len(data["lineitem"]["l_orderkey"]) + d2)
    if (n1, n2) != want_counts or d1 != REFRESH_ORDERS or (r1, r2) != \
            (n1, n2) or u <= 0:
        raise AssertionError(f"durable: affected rows RF1 {n1}/{n2}, RF2 "
                             f"{d1}/{d2}, update {u}, rolled back {r1}/{r2}")
    _log(f"durable: RF1 (+{n1} orders, +{n2} lineitems) {t_rf1:.2f} s, RF2 "
         f"(-{d1} orders, -{d2} lineitems) {t_rf2:.2f} s, UPDATE "
         f"l_discount of {u} lineitems {t_upd:.2f} s, each one committed "
         f"transaction; RF1 again, rolled back; WAL "
         f"{os.path.getsize(wal) / 1e6:.1f} MB; commit to next answer "
         f"(lineitem uploaded again) {t_next * 1e3:.1f} ms, the answer "
         f"after {t_again * 1e3:.1f} ms; device memory above the tables: "
         f"peak {peak / 2**20:.1f} MiB across the refresh, "
         f"{after / 2**20:+.1f} MiB held after it; engine plan cache "
         f"{plan_cache_stats()} (its entries pin the Table versions they "
         f"were bound to, up to 4 per SQL text)")
    db.close()
    del s, db
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    db = Database(path, device=dev)
    t_reopen = time.perf_counter() - t0
    s = Session(db)
    for tname, (sql, want) in _table_checks(changed).items():
        got = [int(v.scaleb(2)) if hasattr(v, "scaleb") else int(v)
               for v in s.sql(sql).rows[0]]
        if got != want:
            raise AssertionError(f"durable: {tname} after the replay "
                                 f"{got} != numpy {want}")
    gone = s.sql(f"select count(*) from orders where o_orderkey > "
                 f"{2 * kmax}").rows[0][0]
    if gone:
        raise AssertionError(f"durable: {gone} rolled-back orders read back")
    t0 = time.perf_counter()
    oracle = {q: tpch_oracle.ORACLES[q](changed) for q in SLICE_QUERIES}
    t_oracle = time.perf_counter() - t0
    _zero_launches()
    times = []
    for q in SLICE_QUERIES:
        t0 = time.perf_counter()
        got = list(s.sql(QUERIES[q]).rows)
        times.append(f"Q{q} {(time.perf_counter() - t0) * 1e3:.1f}")
        diff = tpch_oracle.rows_differ(
            got, tpch_oracle.decoded(q, oracle[q]), AVG_RTOL)
        if diff or not got:
            raise AssertionError(f"durable Q{q} after the replay != oracle: "
                                 f"{diff or 'no rows'}")
    db.close()
    seg = CK.LAUNCHES['seg_sum64']
    _farm(dev, folder, oracle, len(changed["lineitem"]["l_orderkey"]),
          seg_entry)
    _log(f"durable: reopen (WAL replay) {t_reopen:.2f} s; every committed "
         f"change read back (count and sums of 8 tables), the rolled-back "
         f"RF1 absent; 22 queries equal to the oracle over the changed "
         f"arrays ({t_oracle:.1f} s there), first runs ms: "
         f"{', '.join(times)}; seg_sum64 launches {seg}")


def _farm(dev, folder: str, oracle: dict, n_lineitem: int,
          seg_entry: dict) -> None:
    """The replayed SF1 store as database ``db`` of a Farm on the card:
    the 22 queries through the farm's proxy, status, stop (checkpoint),
    snapshot, restore as ``db2`` and a Funnel over both."""
    farm = Farm(folder, device=dev)
    try:
        if farm.databases() != ["db"]:
            raise AssertionError(f"farm: databases {farm.databases()}")
        host, port = farm.proxy_listen()
        t0 = time.perf_counter()
        cl = Client(host, port, database="db")   # starts db on demand
        _zero_launches()                # the farm path starts here
        times = []
        for q in SLICE_QUERIES:
            t1 = time.perf_counter()
            _check_oracle("farm", q, list(cl.sql(QUERIES[q]).rows), oracle)
            times.append(f"Q{q} {(time.perf_counter() - t1) * 1e3:.1f}")
        t_queries = time.perf_counter() - t0
        cl.close()
        launches = seg_entry["launches_farm"] = CK.LAUNCHES["seg_sum64"]
        if launches <= 0:
            raise AssertionError("the farm path launched no seg_sum64")
        st = {e["name"]: e for e in farm.status()}
        if st["db"]["state"] != "running" or \
                farm.db("db").device != torch.device(dev):
            raise AssertionError(f"farm: status {st}")
        wal = os.path.join(folder, "db", "wal.log")
        wal_before = os.path.getsize(wal)
        t0 = time.perf_counter()
        farm.stop("db")
        t_stop = time.perf_counter() - t0
        if os.path.getsize(wal) >= wal_before or \
                farm.status()[0]["state"] != "stopped":
            raise AssertionError(f"farm: stop did not checkpoint (WAL "
                                 f"{wal_before} -> {os.path.getsize(wal)})")
        _log(f"farm: the replayed store as database db on {dev}: 22 "
             f"queries through the proxy equal to the oracle over the "
             f"changed arrays in {t_queries:.2f} s with the on-demand start "
             f"(WAL replay) and first uploads (ms: {', '.join(times)}); "
             f"seg_sum64 launches {launches}; status running; stop "
             f"checkpointed in {t_stop:.2f} s (WAL {wal_before} -> "
             f"{os.path.getsize(wal)} bytes)")
        tar = os.path.join(folder, "db.tar")
        t0 = time.perf_counter()
        farm.snapshot("db", tar)
        t_snap = time.perf_counter() - t0
        t0 = time.perf_counter()
        farm.restore("db2", tar)
        t_restore = time.perf_counter() - t0
        os.remove(tar)
        f = farm.funnel(["db", "db2"])
        rows = f.sql("select count(*) from lineitem").rows
        f.close()
        if rows != [(n_lineitem,), (n_lineitem,)]:
            raise AssertionError(f"funnel: {rows}, each should be "
                                 f"{n_lineitem}")
        _log(f"farm: snapshot of db {t_snap:.2f} s, restore as db2 "
             f"{t_restore:.2f} s; a Funnel over both counts lineitem twice "
             f"({rows[0][0]} + {rows[1][0]})")
    finally:
        farm.stop_all()


def _ledger() -> dict:
    out = {}
    with open(os.path.join(ROOT, "tests", "sqllogic", "REF_LEDGER.md")) as f:
        for line in f:
            m = re.match(r"\|\s*(\S+\.test)\s*\|\s*(pass|FAIL)\s*\|", line)
            if m:
                out[m.group(1)] = m.group(2)
    return out


def phase_sqllogic(dev) -> None:
    """tests/sqllogic/*.test, then every file of the pinned reference
    corpus held to its ledger, each file on a fresh store on the card."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from gen_ref_ledger import CHAINS
    t0 = time.perf_counter()
    local = sorted(glob.glob(os.path.join(ROOT, "tests", "sqllogic",
                                          "*.test")))
    records = 0
    for path in local:
        n = SqlLogicRunner(Session(Database(device=dev))).run_file(path)
        if n <= 0:
            raise AssertionError(f"sqllogic: {path} ran no records")
        records += n
    led = _ledger()
    ref = os.path.join(ROOT, "tests", "sqllogic", "ref")
    wrong = []
    for name in sorted(led):
        db = Database(device=dev)
        prereqs, user = CHAINS.get(name, ([], None))
        for pre in prereqs:
            SqlLogicRunner(Session(db)).run_file(os.path.join(ref, pre))
        runner = SqlLogicRunner(Session(db, user=user))
        try:
            records += runner.run_file(os.path.join(ref, name))
            got = "pass"
        except Exception as ex:         # the ledger counts any failure
            records += runner.n_run
            got, why = "FAIL", f"{type(ex).__name__}: {ex}"[:200]
        if got != led[name]:
            wrong.append(f"{name}: ledger {led[name]}, got {got}"
                         + (f" ({why})" if got == "FAIL" else ""))
    secs = time.perf_counter() - t0
    if wrong:
        raise AssertionError("sqllogic: " + "; ".join(wrong[:10]))
    n_fail = sum(st == "FAIL" for st in led.values())
    _log(f"sqllogic: {len(local)} local files and {len(led)} ledger files "
         f"({len(led) - n_fail} pass, {n_fail} known-fail) as the ledger "
         f"says; {records} records in {secs:.1f} s on {dev}")



GEOM_POINTS = 1_000_000
GEOM_POLYGONS = 1000


def _geom_ring(cx, cy, r, n, phase=0.0) -> np.ndarray:
    a = np.linspace(0, 2 * math.pi, n, endpoint=False) + phase
    rr = r * (1 + 0.3 * np.sin(5 * a))
    ring = np.stack([cx + rr * np.cos(a), cy + rr * np.sin(a)], axis=1)
    ring = np.round(ring, 6)
    return np.vstack([ring, ring[:1]])


def _wkt_ring(ring: np.ndarray) -> str:
    return "(" + ", ".join(f"{x:.6f} {y:.6f}" for x, y in ring) + ")"


def _np_edges(rings, closed=True) -> np.ndarray:
    """(E, 4) edges [x1 y1 x2 y2] of rings whose last vertex repeats the
    first (closed) or of a line's consecutive vertices."""
    segs = []
    for r in rings:
        if closed:
            segs.append(np.concatenate([r, np.roll(r, -1, axis=0)], axis=1))
        else:
            segs.append(np.concatenate([r[:-1], r[1:]], axis=1))
    return np.concatenate(segs)


def _np_inside(x, y, edges) -> np.ndarray:
    """Even-odd ray cast, in blocks of points."""
    x1, y1, x2, y2 = edges.T
    out = np.empty(len(x), bool)
    for lo in range(0, len(x), 1 << 16):
        px, py = x[lo:lo + (1 << 16), None], y[lo:lo + (1 << 16), None]
        straddle = (y1 > py) != (y2 > py)
        dy = np.where(y2 == y1, 1.0, y2 - y1)
        xs = x1 + (py - y1) * (x2 - x1) / dy
        out[lo:lo + (1 << 16)] = (straddle & (px < xs)).sum(1) % 2 == 1
    return out


def _np_seg_dist(x, y, edges) -> np.ndarray:
    x1, y1, x2, y2 = edges.T
    dx, dy = x2 - x1, y2 - y1
    ln = np.where(dx * dx + dy * dy == 0, 1.0, dx * dx + dy * dy)
    out = np.empty(len(x))
    for lo in range(0, len(x), 1 << 15):
        px, py = x[lo:lo + (1 << 15), None], y[lo:lo + (1 << 15), None]
        t = np.clip(((px - x1) * dx + (py - y1) * dy) / ln, 0.0, 1.0)
        out[lo:lo + (1 << 15)] = np.hypot(px - (x1 + t * dx),
                                          py - (y1 + t * dy)).min(1)
    return out


def _haversine(x, y, bx, by) -> np.ndarray:
    rad = math.pi / 180.0
    h = (np.sin((by - y) * rad / 2) ** 2 + np.cos(y * rad)
         * math.cos(by * rad) * np.sin((bx - x) * rad / 2) ** 2)
    return 2 * GEOD_RADIUS * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))


def phase_geom(dev) -> None:
    """GEOM_POINTS seeded points as WKT on the card (COPY from a CSV), and
    point-in-polygon, distances, geographic DWithin and coordinate sums
    against one 64-vertex polygon with a hole, a multipolygon, a
    linestring and a point; st_area over GEOM_POLYGONS polygons.  Expected
    values from numpy (even-odd ray cast, segment distance, haversine,
    shoelace): counts exactly, floats to rel 1e-9."""
    rng = np.random.default_rng(77)
    x = np.round(rng.uniform(-170, 170, GEOM_POINTS), 6)
    y = np.round(rng.uniform(-80, 80, GEOM_POINTS), 6)
    outer, hole = _geom_ring(10, 5, 50, 64), _geom_ring(15, 10, 15, 12, 0.2)
    parts = [_geom_ring(-100, 30, 25, 9), _geom_ring(110, -40, 30, 11, 0.5)]
    line = np.array([[-150, -60], [-20, 10], [30, -5], [160, 70]], float)
    pt = (12.5, -7.25)
    consts = {
        "polygon": (f"POLYGON ({_wkt_ring(outer)}, {_wkt_ring(hole)})",
                    _np_edges([outer, hole])),
        "multipolygon": ("MULTIPOLYGON (" + ", ".join(
            f"({_wkt_ring(r)})" for r in parts) + ")", _np_edges(parts)),
        "linestring": ("LINESTRING (" + ", ".join(
            f"{a:g} {b:g}" for a, b in line) + ")",
            _np_edges([line], closed=False)),
        "point": (f"POINT ({pt[0]} {pt[1]})", None)}
    folder = tempfile.mkdtemp(prefix="mtpu_geom_")
    try:
        s = Session(Database(device=dev))
        s.sql("create table pts (id int, g varchar(48))")
        path = os.path.join(folder, "pts.csv")
        with open(path, "w") as f:
            f.writelines(f"{i}|POINT ({a:.6f} {b:.6f})\n"
                         for i, (a, b) in enumerate(zip(x, y)))
        t0 = time.perf_counter()
        if s.sql(f"copy into pts from '{path}'") != GEOM_POINTS:
            raise AssertionError("geom: COPY count")
        _log(f"geom: {GEOM_POINTS} points as WKT loaded by COPY in "
             f"{time.perf_counter() - t0:.2f} s")
        polys = [_geom_ring(*rng.uniform(-150, 150, 2), rng.uniform(1, 9),
                            int(rng.integers(4, 40)))
                 for _ in range(GEOM_POLYGONS)]
        s.sql("create table shapes (id int, g varchar(2000))")
        s.sql("insert into shapes values " + ", ".join(
            f"({i}, 'POLYGON ({_wkt_ring(r)})')" for i, r in
            enumerate(polys)))
        checks = []
        for name, (wkt, edges) in consts.items():
            if name in ("polygon", "multipolygon"):
                inside = _np_inside(x, y, edges)
                checks.append((f"count st_contains({name})",
                               f"select count(*) from pts where "
                               f"st_contains('{wkt}', g)",
                               int(inside.sum()), True))
                dist = np.where(inside, 0.0, _np_seg_dist(x, y, edges))
            elif edges is not None:
                dist = _np_seg_dist(x, y, edges)
            else:
                dist = np.hypot(x - pt[0], y - pt[1])
            checks.append((f"sum st_distance({name})",
                           f"select sum(st_distance(g, '{wkt}')) from pts",
                           float(dist.sum()), False))
        hv = _haversine(x, y, *pt)
        checks.append(("count st_dwithin geographic 2,000 km",
                       f"select count(*) from pts where "
                       f"st_dwithingeographic(g, '{consts['point'][0]}', "
                       f"2000000.0)", int((hv <= 2e6).sum()), True))
        checks.append(("sum st_distance_geographic",
                       f"select sum(st_distance_geographic(g, "
                       f"'{consts['point'][0]}')) from pts",
                       float(hv.sum()), False))
        checks.append(("sum st_x", "select sum(st_x(g)) from pts",
                       float(x.sum()), False))
        checks.append(("sum st_y", "select sum(st_y(g)) from pts",
                       float(y.sum()), False))
        area = sum(0.5 * abs(np.sum(r[:, 0] * np.roll(r[:, 1], -1)
                                    - np.roll(r[:, 0], -1) * r[:, 1]))
                   for r in polys)
        checks.append((f"sum st_area over {GEOM_POLYGONS} polygons",
                       "select sum(st_area(g)) from shapes", float(area),
                       False))
        for label, sql, want, exact in checks:
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            (got,), = s.sql(sql).rows
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(dev) - base
            ok = got == want if exact else math.isclose(got, want,
                                                        rel_tol=1e-9)
            if not ok:
                raise AssertionError(f"geom {label}: {got} != numpy {want}")
            _log(f"geom: {label} = {got} equal to numpy; {ms:.1f} ms, peak "
                 f"device memory {peak / 2**20:.1f} MiB above the table")
        s.db.close()
    finally:
        shutil.rmtree(folder, ignore_errors=True)


#: phase_external: 2^27 int64 values (1 GiB on the host) in tiles of
#: 2^24 rows (8 tiles), and 2^26 values that are 90% one value
EXT_ROWS = 1 << 27
EXT_TIES_ROWS = 1 << 26
EXT_TILE = 1 << 24
#: allowed peak device memory, in tiles' bytes
EXT_PEAK_TILES = 8


def phase_external(dev) -> None:
    """external_sort (ascending, descending, heavy ties) and the streaming
    cumulative and window sums over host arrays through tiles on the card:
    outputs equal numpy exactly, peak device memory within EXT_PEAK_TILES
    tiles.  The reference's 1B-row envelope (tests/test_external.py, opt-in)
    is cut to 2^27 rows to fit the script's time."""
    rng = np.random.default_rng(8)
    arr = rng.integers(-10**15, 10**15, EXT_ROWS).astype(np.int64)
    ties = np.where(rng.random(EXT_TIES_ROWS) < 0.9, 7,
                    rng.integers(-10**6, 10**6, EXT_TIES_ROWS)
                    ).astype(np.int64)
    t0 = time.perf_counter()
    want = np.sort(arr)
    want_ties = np.sort(ties)
    csum = np.cumsum(arr)
    c0 = np.concatenate([[0], csum])
    wsum = c0[1:] - c0[np.maximum(np.arange(EXT_ROWS) - 999, 0)]
    del c0
    _log(f"external: numpy oracles {time.perf_counter() - t0:.2f} s")
    tile_bytes = EXT_TILE * 8
    runs = [
        ("external_sort ascending", arr, want, lambda a: X.external_sort(
            a, chunk_rows=EXT_TILE, device=dev)),
        ("external_sort descending", arr, want[::-1],
         lambda a: X.external_sort(a, chunk_rows=EXT_TILE, descending=True,
                                   device=dev)),
        ("external_sort heavy ties", ties, want_ties,
         lambda a: X.external_sort(a, chunk_rows=EXT_TILE, device=dev)),
        ("streaming_cumsum", arr, csum, lambda a: X.streaming_cumsum(
            a, chunk_rows=EXT_TILE, device=dev)),
        ("streaming_window_sum(w=1000)", arr, wsum,
         lambda a: X.streaming_window_sum(a, 1000, chunk_rows=EXT_TILE,
                                          device=dev))]
    for label, src, expect, fn in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        got = fn(src)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        if got.dtype != expect.dtype or not np.array_equal(got, expect):
            raise AssertionError(f"external: {label} != numpy")
        if peak > EXT_PEAK_TILES * tile_bytes:
            raise AssertionError(f"external: {label} peak device memory "
                                 f"{peak} > {EXT_PEAK_TILES} tiles")
        _log(f"external: {label} over {len(src)} int64 rows in tiles of "
             f"{EXT_TILE} ({-(-len(src) // EXT_TILE)} tiles) equal to numpy; "
             f"{secs:.2f} s, {len(src) / secs / 1e6:.1f} Mrows/s; peak "
             f"device memory {peak / 2**20:.1f} MiB = "
             f"{peak / tile_bytes:.2f} tiles ({tile_bytes >> 20} MiB each)")


def phase_bench(dev, cat, resident: int, seg_entry: dict) -> None:
    """The port bench at its full sizes over the resident SF1 catalog,
    then one iteration of each loop against numpy."""
    sizes = {k: p.default for k, p in
             inspect.signature(BENCH.main).parameters.items()
             if p.kind == p.KEYWORD_ONLY and k != "catalog"}
    plan_cache_clear()
    _zero_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = BENCH.main(device=dev, catalog=cat)
    took = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - resident
    lines = out.getvalue().splitlines()
    _log(f"bench: {len(lines)} JSON lines, the last: {lines[-1]}")
    if rc != 0:
        raise AssertionError(f"bench: main returned {rc}")
    last = json.loads(lines[-1])
    d = last["detail"]
    missing = [k for k in BENCH_KEYS if k not in last] + \
        [k for k in BENCH_DETAIL_KEYS if k not in d]
    nulls = [k for k in BENCH_DETAIL_KEYS[:10] if d[k] is None]
    if missing or nulls or last["value"] is None:
        raise AssertionError(f"bench: keys missing {missing}, null {nulls}")
    if d["engine_sf1_failed"] or d["engine_sf1_skipped"] or \
            len(d["engine_sf1_wall_ms"] or {}) != 22:
        raise AssertionError("bench: not all 22 queries measured")
    launches = dict(CK.LAUNCHES)
    seg_entry["launches_bench"] = launches["seg_sum64"]
    if launches["q1_grouped_sums"] or launches["grouped_sum_limbs"] or \
            launches["seg_sum64"] < 5 * 4 * sum(sizes["q1_ks"]):
        raise AssertionError(f"bench: launches {launches}")
    _log(f"bench: main returned 0 in {took:.2f} s, peak device memory "
         f"above the tables {peak / 2**20:.1f} MiB; launches {launches} "
         f"(seg_sum64: 5 an iteration of its loop, then the queries')")
    _bench_values(dev, sizes)


def _bench_values(dev, sizes: dict) -> None:
    """One iteration (i = 0) of each bench loop at main's sizes against
    numpy; 5 seg_sum64 launches for the seg_sum64 loop's and none else."""
    qa = BENCH.q_columns(sizes["n"])
    bk, pk = BENCH.join_keys(sizes["nb"], sizes["npr"], sizes["dom"])
    sid, vals = BENCH.groupby_columns(sizes["ngr"], sizes["nseg"])
    cases = [
        ("q6", BENCH.q6_loop, lambda: BENCH.q6_args(qa, dev),
         lambda: BENCH.q6_numpy(qa, 0)),
        ("q1", BENCH.q1_loop, lambda: BENCH.q1_args(qa, dev),
         lambda: BENCH.q1_numpy(qa, 0)),
        ("q1 seg_sum64", BENCH.seg_loop, lambda: BENCH.seg_args(qa, dev),
         lambda: BENCH.seg_numpy(qa, 0)),
        ("join", BENCH.join_loop,
         lambda: BENCH.join_args(bk, pk, sizes["dom"], dev),
         lambda: BENCH.join_numpy(bk, pk, 0, sizes["dom"])),
        ("group-by", BENCH.groupby_loop,
         lambda: BENCH.groupby_args(sid, vals, sizes["nseg"], dev),
         lambda: int(BENCH.groupby_numpy(sid, vals, 0, sizes["nseg"]).sum())),
    ]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, loop, args, want in cases:
        a = args()
        _zero_launches()
        got = int(loop(*a, 1))
        launched = dict(CK.LAUNCHES)
        expect = {k: 5 if (loop is BENCH.seg_loop and k == "seg_sum64")
                  else 0 for k in launched}
        if launched != expect:
            raise AssertionError(f"bench {name}: launches {launched}, "
                                 f"expected {expect}")
        expected = want()
        if got != expected:
            raise AssertionError(f"bench {name}: {got} != numpy {expected}")
        if loop is BENCH.groupby_loop:
            sums = BENCH.groupby_sums(*a[:2], 0, sizes["nseg"]).cpu().numpy()
            if not np.array_equal(sums, BENCH.groupby_numpy(
                    sid, vals, 0, sizes["nseg"])):
                raise AssertionError("bench group-by: a group sum differs "
                                     "from np.bincount")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            int(loop(*a, 1))
        kernels = sorted(((e.key, e.self_device_time_total, e.count)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda k: -k[1])
        top = ", ".join(f"{k[:40]} {t / 1e3:.3f} ms x{c}"
                        for k, t, c in kernels[:4])
        # the profiler now and then records no device activity at all
        busy = (f"device busy {sum(k[1] for k in kernels) / 1e3:.3f} ms in "
                f"{sum(k[2] for k in kernels)} activities, top: {top}"
                if kernels else "no device activity recorded")
        _log(f"bench: {name} iteration equal to numpy ({got}); launches "
             f"{launched}; profiled iteration: {busy}")
        del a


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
    for executor, q in [(False, q) for q in SLICE_QUERIES] + \
            [(True, q) for q in SLICE_QUERIES]:
        _profile_query(eng, q, executor, profile,
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       DeviceType)


def _profile_query(eng, q, executor: bool, profile, activities,
                   DeviceType) -> None:
    runs = EXEC_WARM_RUNS + 1 if executor else WARM_RUNS
    config.set("fragment_exec", not executor)
    try:
        plain = []
        for _ in range(runs):
            t0 = time.perf_counter()
            list(eng.query(QUERIES[q]).rows)
            plain.append(time.perf_counter() - t0)
        n_waits, n_in_plan = host_waits(eng, QUERIES[q])
        if n_in_plan and not executor:
            raise AssertionError(f"Q{q}: {n_in_plan} host waits inside "
                                 f"the interpreter")
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                list(eng.query(QUERIES[q]).rows)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / runs
    finally:
        config.reset("fragment_exec")
    # device-side events only: an operator's row repeats the time of the
    # kernels it launched
    averages = prof.key_averages()
    kernels = [(a.key, a.self_device_time_total, a.count)
               for a in averages if a.device_type == DeviceType.CUDA]
    # the profiler's own count of the runtime calls behind the waits
    host = {a.key: a.count / runs for a in averages
            if a.device_type == DeviceType.CPU}
    waits = f"host waits {n_waits} ({n_in_plan} inside the plan), " + \
        ", ".join(f"{k} {host.get(k, 0):.1f}" for k in (
            "cudaStreamSynchronize", "aten::item", "cudaMemcpyAsync"))
    busy = sum(t for _k, t, _c in kernels) / runs / 1e3
    count = sum(c for _k, _t, c in kernels) / runs
    kernels.sort(key=lambda k: -k[1])
    top = ", ".join(f"{k[:48]} {t / runs / 1e3:.3f} ms x{c // runs}"
                    for k, t, c in kernels[:5])
    med = statistics.median(plain) * 1e3
    _log(f"profile: {'executor ' if executor else ''}Q{q} warm median "
         f"{med:.2f} ms unprofiled (idle share {1 - busy / med:.2f}); "
         f"profiled wall {wall * 1e3:.2f} ms (idle share "
         f"{1 - busy / (wall * 1e3):.2f}), device busy {busy:.3f} ms, "
         f"device activities {count:.0f} a query; {waits} a query; "
         f"top: {top}")


def _timed(name: str, fn, *args):
    """Run one phase and print its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    _log(f"phase {name}: {time.perf_counter() - t0:.2f} s")
    return out


def main(argv) -> int:
    if [a for a in argv if a != "--profile"]:
        raise SystemExit(__doc__)
    t_start = time.perf_counter()
    device = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _timed("build", phase_build)
    seg = _timed("kernel seg_sum64", phase_kernel_seg_sum64, dev)
    q1, gsl = _timed("kernel fused", phase_kernel_fused, dev)
    torch.cuda.empty_cache()
    cat, resident, want, data = _timed("load", phase_load, dev)
    _timed("fused", phase_fused, cat, want[1], q1, gsl)
    frag = {}
    eng = _timed("slice", phase_slice, dev, cat, resident, want, seg, frag)
    _timed("executor", phase_executor, dev, eng, resident, want)
    _timed("window", phase_window, dev, eng, resident, data)
    _timed("window primitives", phase_window_primitives, dev)
    if "--profile" in argv:
        _timed("profile", phase_profile, dev, eng)
    _timed("bench", phase_bench, dev, cat, resident, seg)
    del eng, cat
    torch.cuda.empty_cache()
    _timed("tpcds", phase_tpcds, dev, seg)
    db, sess_launches, sess_medians = _timed(
        "session", phase_session, dev, data, want, frag, seg)
    _timed("server", phase_server, dev, db, data, want, sess_launches,
           sess_medians, seg)
    _timed("spmd", phase_spmd, dev, db, want, frag, sess_medians, seg,
           q1, gsl)
    db.close()
    del db
    gc.collect()
    torch.cuda.empty_cache()
    _timed("procs", phase_procs, dev, seg, q1, gsl)
    _timed("hybrid", phase_hybrid, dev, seg, q1, gsl)
    _timed("harness", phase_harness, dev)
    _timed("durable + farm", phase_durable, dev, data, seg)
    _timed("sqllogic", phase_sqllogic, dev)
    _timed("geom", phase_geom, dev)
    _timed("external", phase_external, dev)
    _log(f"chip_smoke: all phases passed in "
         f"{time.perf_counter() - t_start:.1f} s")
    _log(json.dumps({"kernels": [seg, q1, gsl]}))
    _log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
