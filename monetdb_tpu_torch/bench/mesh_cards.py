"""The 22 TPC-H queries through ``Session.sql`` on one card and on the row
mesh that a host with several cards gives every session when config
``spmd_auto_mesh`` is on (``parallel.default_mesh()``: one shard per
visible card; the reference's default, off in the port), over one store:
warm medians side by side, the mesh's rows held equal to the one-card rows,
mesh runs and shuffles counted.

Run on a host with two or more CUDA devices:

    python -m monetdb_tpu_torch.bench.mesh_cards [--sf 1] [--warm 3]
        [--budget-s 420] [--out FILE]

Prints the cards' name and power limit, one line per query, and last one
JSON object with every number (also written to ``--out``).  Exits 1 if a
query's rows differ or a query fails, 2 on a host with fewer than two cards.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time

import torch

from .. import config
from ..exec import fragment
from ..parallel import mesh as MESH
from ..session import Session
from . import tpch_oracle
from .tpch_gen import gen_tpch
from .tpch_load import load_tpch_db
from .tpch_queries import QUERIES

#: floats of the two paths may differ in summation order
FLOAT_RTOL = 1e-9
_COUNTS = ("runs", "spmd_runs", "shuffle_joins", "shuffle_groupbys",
           "shuffle_distincts", "cap_retries", "fallbacks")


def _log(*a) -> None:
    print(*a, flush=True)


def dispatch_cost(devices) -> dict:
    """Host microseconds an eager op takes when one thread issues 2,000 of
    them on the first card, and when one thread per card issues 2,000 at
    once on its own card (wall over all ops)."""
    n = 2000

    def ops(dev):
        with torch.cuda.device(dev):
            x = torch.zeros(8, device=dev)
            for _ in range(n):
                torch.where(x > 0, x, x)

    out = {}
    for label, devs in (("one_thread", devices[:1]), ("per_card", devices)):
        for d in devs:
            torch.cuda.synchronize(d)
        workers = [threading.Thread(target=ops, args=(d,)) for d in devs]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        for d in devs:
            torch.cuda.synchronize(d)
        out[label] = (time.perf_counter() - t0) / (n * len(devs)) * 1e6
    return out


def _runs(s: Session, sql: str, warm: int):
    t0 = time.perf_counter()
    rows = list(s.sql(sql).rows)
    cold = time.perf_counter() - t0
    times = []
    for _ in range(warm):
        t0 = time.perf_counter()
        again = list(s.sql(sql).rows)
        times.append(time.perf_counter() - t0)
        if again != rows:
            raise AssertionError("warm rows differ from the cold run's")
    return rows, cold * 1e3, [t * 1e3 for t in times]


def compare(one: Session, meshed: Session, devices, queries, warm: int,
            deadline: float, result: dict) -> int:
    """Run each query through both sessions (``one`` first), record its
    numbers in ``result["queries"]`` and its failure in
    ``result["errors"]``; returns the number of queries that failed or
    whose mesh rows differ.  No query starts after ``deadline``
    (``time.perf_counter()``)."""
    cuda = [d for d in devices if d.type == "cuda"]
    bad = 0
    for q in queries:
        if time.perf_counter() > deadline:
            result["errors"][q] = "not run: time budget spent"
            continue
        sql = QUERIES[q]
        try:
            rows1, cold1, warm1 = _runs(one, sql, warm)
            s0, m0 = dict(fragment.STATS), dict(MESH.STATS)
            for d in cuda:
                torch.cuda.reset_peak_memory_stats(d)
            rows8, cold8, warm8 = _runs(meshed, sql, warm)
            delta = {k: fragment.STATS[k] - s0[k] for k in _COUNTS}
            sent = MESH.STATS["bytes"] - m0["bytes"]
            peak = [torch.cuda.max_memory_allocated(d) for d in cuda]
            diff = tpch_oracle.rows_differ(rows8, rows1, FLOAT_RTOL)
        except Exception as ex:         # noqa: BLE001 - reported, counted
            bad += 1
            result["errors"][q] = f"{type(ex).__name__}: {ex}"
            _log(f"Q{q}: FAILED {result['errors'][q]}")
            continue
        if diff:
            bad += 1
            result["errors"][q] = f"mesh rows differ: {diff}"
        m1, m8 = statistics.median(warm1), statistics.median(warm8)
        result["queries"][q] = {
            "rows": len(rows1), "one_card_ms": warm1, "mesh_ms": warm8,
            "one_card_median_ms": m1, "mesh_median_ms": m8,
            "one_card_cold_ms": cold1, "mesh_cold_ms": cold8,
            "counts": delta, "bytes_to_collectives": sent,
            "peak_bytes": peak, "rows_equal": not diff}
        _log(f"Q{q}: rows {len(rows1)} {'equal' if not diff else diff}; "
             f"warm median one card {m1:.2f} ms, mesh {m8:.2f} ms "
             f"({m8 / m1:.2f}x); cold {cold1:.1f} / {cold8:.1f} ms; "
             f"{delta}; {sent / 2**20:.1f} MiB to collectives; peak GiB "
             f"{[round(p / 2**30, 2) for p in peak]}")
    return bad


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--budget-s", type=float, default=420.0,
                    help="start no query after this many seconds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        _log(f"mesh_cards: {n_cards} CUDA device(s); needs two or more")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    cards = [ln.strip() for ln in smi.stdout.strip().splitlines()]
    for ln in cards:
        _log(ln)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    devices = [torch.device("cuda", i) for i in range(n_cards)]
    result = {"cards": cards, "sf": args.sf, "warm_runs": args.warm,
              "torch": torch.__version__, "queries": {}, "errors": {}}
    t0 = time.perf_counter()
    data = gen_tpch(args.sf)
    db = load_tpch_db(args.sf, data=data, device=dev)
    result["load_s"] = time.perf_counter() - t0
    one = Session(db)                   # the port's default: one card
    config.set("spmd_auto_mesh", True)
    try:
        meshed = Session(db)            # the reference's default
    finally:
        config.reset("spmd_auto_mesh")
    if one.mesh is not None or meshed.mesh is None or \
            meshed.mesh.size != n_cards:
        raise AssertionError(f"sessions' meshes: {one.mesh}, {meshed.mesh}")
    result["mesh"] = repr(meshed.mesh)
    result["dispatch_us"] = dispatch_cost(devices)
    _log(f"mesh_cards: SF{args.sf} loaded in {result['load_s']:.2f} s; "
         f"default mesh {meshed.mesh}; host cost per eager op "
         f"{result['dispatch_us']}")
    bad = compare(one, meshed, devices, range(1, 23), args.warm,
                  t_start + args.budget_s, result)
    ratios = [v["mesh_median_ms"] / v["one_card_median_ms"]
              for v in result["queries"].values()]
    if ratios:
        result["mesh_over_one_card"] = {
            "min": min(ratios), "median": statistics.median(ratios),
            "max": max(ratios),
            "mesh_runs": sum(v["counts"]["spmd_runs"] > 0
                             for v in result["queries"].values())}
    result["seconds"] = time.perf_counter() - t_start
    db.close()
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    _log(line if len(line) < 4000 else json.dumps(
        {k: v for k, v in result.items() if k != "queries"}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
