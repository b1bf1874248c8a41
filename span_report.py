"""Where one benchmark cell's time goes, from the program's own spans and
counters (``monetdb_tpu_torch/obs/profiler.py``).

    python3 span_report.py --workload <cell> --seed <n> [--seconds S]
        [--pairs K] [--out DIR] [--tiny]

Sets the cell up as ``python3 -m qbench.run`` does (its generator, entry
and warm-up passes, on ``cuda:0``; ``--tiny`` runs the CPU tests' cut of
the cell on the CPU instead, for a rehearsal), then:

1. *split*: passes of the mix with the profiler's recording off for
   ``--seconds``; for each query, the delta of every host-time counter of
   ``exec.fragment.STATS`` around it and its latency (issue to rows as
   tuples), as means a query, by query and over all;
2. *cost*: ``--pairs`` pairs of passes, one with recording off and one
   with it on (``PROFILER.start()`` / ``stop()`` around the pass), in
   turns; the mean latency of each side;
3. *attribution*: one pass with recording on under ``torch.profiler``
   (CPU and CUDA).  Its chrome export is joined with
   ``PROFILER.chrome_events(baseTimeNanoseconds)``; each CUDA kernel falls
   to the innermost span open at its launch (the ``cuda_runtime`` event of
   the same correlation id): the share launched inside a ``run.*`` span and
   inside a relational node (``r_*``), and the device time by node.  With
   ``--out`` the joined trace is written there (gzip).

Prints the numbers on standard error as it goes and one JSON object as the
last line of standard output.  Imports no JAX."""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

#: host-time counters of ``exec.fragment.STATS`` (ns)
LAYERS = ("sql_ns", "parse_ns", "bind_ns", "lower_ns", "dict_ns",
          "subquery_ns", "dispatch_ns", "wait_ns", "fetch_ns", "decode_ns",
          "executor_ns")
COUNTS = ("host_reads", "dict_values", "queries")


def _log(msg: str) -> None:
    print(f"span_report: {msg}", file=sys.stderr, flush=True)


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


class _Cell:
    """The cell set up and warm: ``ask(qid)`` runs one query to rows."""

    def __init__(self, workload: str, seed: int, tiny: bool):
        import torch
        from qbench import harness
        from qbench.run import _environment
        _environment()
        if tiny:
            from qbench.tests import tiny as T
            self.cell, self.device = T.cell(workload), torch.device("cpu")
        else:
            if not torch.cuda.is_available():
                raise SystemExit("span_report: needs a CUDA device "
                                 "(--tiny rehearses on the CPU)")
            with open("BENCHMARK.json") as f:
                self.cell = harness.Cell(json.load(f), workload)
            self.device = torch.device("cuda", 0)
            torch.cuda.set_device(self.device)
        self.harness = harness
        cfg = self.cell.cfg
        t = time.perf_counter()
        data = harness.load_module("gen", cfg["generator"]).generate(
            cfg, seed, self.device)
        self.entry = harness.load_module("entries", cfg["entry"]).open_entry(
            cfg, data, self.device)
        del data
        for _ in range(int(self.cell.mix["warmup_passes"])):
            for q in self.cell.qids:
                self.ask(q)
        self.sync()
        _log(f"{workload} set up in {time.perf_counter() - t:.1f} s on "
             f"{self.device}")

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ask(self, qid: str):
        a = self.harness._ask(self.entry, qid, self.cell.texts[qid], None,
                              False)
        if a.error is not None:
            raise RuntimeError(f"Q{qid}: {a.error}")
        return a


def _stats() -> dict:
    from monetdb_tpu_torch.exec.fragment import STATS
    return dict(STATS)


def split(cell: _Cell, seconds: float) -> dict:
    """Per-query counter deltas and latencies over passes with recording
    off."""
    by_q = {}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for q in cell.cell.qids:
            before = _stats()
            a = cell.ask(q)
            after = _stats()
            row = by_q.setdefault(q, {k: [] for k in
                                      LAYERS + COUNTS + ("latency",)})
            for k in LAYERS + COUNTS:
                row[k].append(after[k] - before[k])
            row["latency"].append(a.latency_s * 1e9)

    def named(k):            # ns counters and latency read in ms
        return k[:-3] + "_ms" if k in LAYERS else \
            ("latency_ms" if k == "latency" else k)

    def scale(k):
        return 1e-6 if k in LAYERS or k == "latency" else 1

    queries = {q: {named(k): _mean(v) * scale(k) for k, v in row.items()}
               for q, row in by_q.items()}
    n = sum(len(r["latency"]) for r in by_q.values())
    total = {k: sum(sum(r[k]) for r in by_q.values()) for k in
             LAYERS + COUNTS + ("latency",)}
    mean = {named(k): v * scale(k) / n for k, v in total.items()}
    counted = sum(total[k] for k in LAYERS)
    return {"queries_run": n, "mean": mean, "by_query": queries,
            "counted_over_latency": counted / total["latency"]}


def cost(cell: _Cell, pairs: int) -> dict:
    """Mean latency of passes with recording off and on, in turns."""
    from monetdb_tpu_torch.obs import PROFILER
    lat = {"off": [], "on": []}
    for i in range(2 * pairs):
        on = (i % 2 == 1) if (i // 2) % 2 == 0 else (i % 2 == 0)
        if on:
            PROFILER.start()
        try:
            for q in cell.cell.qids:
                lat["on" if on else "off"].append(cell.ask(q).latency_s)
        finally:
            if on:
                PROFILER.stop()
                PROFILER.spans = []
    off, on = _mean(lat["off"]) * 1e3, _mean(lat["on"]) * 1e3
    return {"off_ms": off, "on_ms": on, "on_over_off": on / off,
            "queries_each": len(lat["on"])}


def _inner(spans, t):
    """The innermost span (the latest to start) holding instant ``t``."""
    best = None
    for s in spans:
        if s["ts"] <= t <= s["ts"] + s["dur"] and \
                (best is None or s["ts"] >= best["ts"]):
            best = s
    return best


def attribute(cell: _Cell, out_dir) -> dict:
    """One recorded pass under ``torch.profiler``: kernels by the span
    open at their launch."""
    from torch.profiler import ProfilerActivity, profile
    from monetdb_tpu_torch.obs import PROFILER
    acts = [ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    cell.sync()
    PROFILER.start()
    try:
        with profile(activities=acts) as prof:
            for q in cell.cell.qids:
                cell.ask(q)
            cell.sync()
    finally:
        PROFILER.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    base = int(trace["baseTimeNanoseconds"])
    spans = PROFILER.chrome_events(base)
    PROFILER.spans = []
    by_id = {s["args"]["id"]: s for s in spans}
    events = trace["traceEvents"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    in_run = in_node = found = 0
    by_node, busy = {}, 0.0
    for k in kernels:
        lk = launch.get(k.get("args", {}).get("correlation"))
        busy += k["dur"]
        if lk is None:
            by_node["(no launch event)"] = \
                by_node.get("(no launch event)", 0.0) + k["dur"]
            continue
        found += 1
        s = _inner(spans, lk["ts"])
        chain = []
        while s is not None:
            chain.append(s["name"])
            s = by_id.get(s["args"]["parent"])
        in_run += any(n.startswith("run.") for n in chain)
        node = next((n for n in chain if n.startswith("r_")), None)
        in_node += node is not None
        key = node.split("#")[0] if node else \
            (chain[0] if chain else "(no span)")
        by_node[key] = by_node.get(key, 0.0) + k["dur"]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        trace["traceEvents"] = events + spans
        name = os.path.join(out_dir, f"{cell.cell.name}.spans.json.gz")
        with gzip.open(name, "wt") as f:
            json.dump(trace, f)
        _log(f"joined trace: {name}")
    n = len(kernels)
    return {"kernels": n, "with_launch": found,
            "in_run_share": in_run / n if n else None,
            "in_node_share": in_node / n if n else None,
            "spans": len(spans), "kernel_busy_ms": busy / 1e3,
            "device_ms_by_node": sorted(
                ([k, v / 1e3] for k, v in by_node.items()),
                key=lambda kv: -kv[1])}


def _card() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"card": out[0]} if out else {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="span_report.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    cell = _Cell(args.workload, args.seed, args.tiny)
    out = {"workload": args.workload, "seed": args.seed,
           "device": str(cell.device), **_card()}
    out["split"] = split(cell, args.seconds)
    _log(f"split (ms a query): {out['split']['mean']}, counted / latency "
         f"{out['split']['counted_over_latency']:.4f}")
    out["cost"] = cost(cell, args.pairs)
    _log(f"recording cost: {out['cost']}")
    out["attribution"] = attribute(cell, args.out)
    _log(f"attribution: {out['attribution']}")
    cell.entry.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
