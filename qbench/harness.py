"""One run of one cell: set-up, the measured window, the reference, the
result.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is found by its name in ``BENCHMARK.json``:

* ``qbench/configs/<config>.json``: the deployment, its schema and the
  names of its ``generator`` (``qbench/gen/<name>.py``), ``entry``
  (``qbench/entries/<name>.py``), ``queries`` (``qbench/queries/<name>.json``)
  and ``reference`` (``qbench/reference/<name>.py``);
* ``qbench/mixes/<traffic>.json``: the queries of the mix and how they
  are issued;
* ``qbench/metrics/<metric>.py``: a ``read(run)`` that returns the
  metric's value or None;
* ``qbench/tests/sizes/<config>.json``: the keys a CPU test overrides
  (``qbench/tests/tiny.py``); a run never reads it.

Each entry module exports ``open_entry(cfg, data, device)`` and, for the
tests' fault of half the batch left out, ``halve(entry)``.

An end-to-end metric named ``<quantity>.<family>`` (``qps.session``)
reports the quantity of its base name for the cells it lists: cells whose
runs spread alike share a family and its bounds.

The window is a closed loop with one client: each pass issues every query
of the mix once, in an order drawn from the seed, and passes repeat until
``seconds`` have gone by; the pass under way finishes.  A query ends when
its rows are Python tuples.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import random
import sys
import time
from typing import Callable, Dict, List, Optional

from . import compare, stats, tracing

__all__ = ["QB", "load_json", "load_module", "Cell", "Answer", "run_cell"]

QB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(QB)


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``qbench/<kind>/<name>.py`` as a module (any name a metric may have,
    dots included)."""
    modname = f"qbench.{kind}." + name.replace(".", "_").replace("-", "_")
    if modname in sys.modules:
        return sys.modules[modname]
    importlib.import_module(f"qbench.{kind}")
    spec = importlib.util.spec_from_file_location(
        modname, os.path.join(QB, kind, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration and mix."""

    def __init__(self, bench: dict, workload: str, overrides=None):
        found = [w for w in bench["workloads"] if w["name"] == workload]
        if not found:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = workload
        entry = [c for c in bench["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.cfg = load_json(entry["file"])
        self.cfg.update(overrides or {})
        self.mix = load_json(f"qbench/mixes/{self.workload['traffic']}.json")
        self.texts = load_json(
            f"qbench/queries/{self.cfg['queries']}.json")["queries"]
        self.qids = list(self.mix["queries"])
        self.chips = int(self.workload["chips"])

        def reports(m):
            return self.name in m.get("workloads", [self.name])
        self.end_to_end = [m for m in bench["end_to_end"] if reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if reports(m)]


class Answer:
    """One query of the window."""

    __slots__ = ("qid", "t0", "t1", "decode_s", "rows", "error",
                 "lower_ms", "ok", "traced")

    def __init__(self, qid: str):
        self.qid = qid
        self.rows = None
        self.error = None
        self.lower_ms = None
        self.decode_s = 0.0
        self.ok = False
        self.traced = False

    @property
    def latency_s(self) -> float:
        return self.t1 - self.t0


class Run:
    """What a per-layer metric reads: the window's answers, the traced
    passes' device trace, the program's counters (their window deltas)
    and the cell; and of set-up, its phases' seconds (``start_s``,
    ``generate_s``, ``load_s``, ``warmup_s``, which add up to ``setup_s``)
    and the program's counters as they stood at its end."""

    def __init__(self, cell: Cell, answers: List[Answer], window_s: float,
                 trace, counters: dict, table_rows: Dict[str, int],
                 device_kind: str, setup: Optional[dict] = None,
                 setup_counters: Optional[dict] = None):
        self.cell = cell
        self.answers = answers
        self.window_s = window_s
        self.trace = trace
        self.counters = counters
        self.table_rows = table_rows
        self.device_kind = device_kind
        self.setup = setup or {}
        self.setup_counters = setup_counters or {}

    def query_bytes(self, qid: str) -> int:
        return stats.query_bytes(self.cell.texts[qid], self.cell.cfg["schema"],
                                 self.table_rows)


def _table_rows(data: dict) -> Dict[str, int]:
    out = {}
    for t, cols in data.items():
        first = next(iter(cols.values()))
        first = getattr(first, "codes", first)
        out[t] = int(first.shape[0])
    return out


def _counters() -> dict:
    from monetdb_tpu_torch.exec.fragment import STATS
    from monetdb_tpu_torch.ops.cuda_kernels import LAUNCHES
    return {**{f"fragment.{k}": v for k, v in STATS.items()},
            **{f"launches.{k}": v for k, v in LAUNCHES.items()}}


def _ask(entry, qid: str, text: str, spans, traced: bool) -> Answer:
    a = Answer(qid)
    a.traced = traced
    a.t0 = time.perf_counter()
    try:
        with tracing.annotate(f"q:{qid}", traced):
            res = entry.query(text)
            t = time.perf_counter()
            with tracing.annotate("decode", traced):
                a.rows = list(res.rows)
            a.t1 = time.perf_counter()
            a.decode_s = a.t1 - t
    except Exception as exc:          # a query that raises counts as failed
        a.t1 = time.perf_counter()
        a.error = f"{type(exc).__name__}: {exc}"[:300]
    if spans is not None:
        a.lower_ms = spans.take()
    return a


class _Tracer:
    """Profiles whole passes: ``start`` turns the profiler on and runs one
    pass under it to let it settle (before the window, as set-up), then
    the first ``passes`` passes of the window run inside the
    ``qbench.window`` annotation.  When the profiler recorded no device
    activity there it starts again inside the window (three tries in
    all)."""

    def __init__(self, passes: int, settle: Callable, sync: Callable):
        self.passes, self.settle, self.sync = passes, settle, sync
        self.prof = self.win = None
        self.left = self.tries = 0
        self.result = None
        self.read_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.tries += 1
        self.settle()
        self.sync()

    def before_pass(self) -> bool:
        """True when the pass about to run is traced."""
        if self.result is not None:
            return False
        if self.prof is None:
            if self.tries >= 3:
                return False
            self.start()
        if self.win is None:
            self.win = tracing.annotate(tracing.WINDOW, True)
            self.win.__enter__()
            self.left = self.passes
        return True

    def after_pass(self, traced: bool) -> None:
        if traced:
            self.left -= 1
            if self.left <= 0:
                self.stop()

    def stop(self) -> None:
        """End the profile; read it when a traced pass ran."""
        if self.prof is None:
            return
        self.sync()
        if self.win is not None:
            self.win.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        if self.win is not None:
            t = time.perf_counter()
            self.result = tracing.read_trace(
                self.prof.profiler.kineto_results.events())
            self.read_s = time.perf_counter() - t
        self.prof = self.win = None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print, fault: Optional[Callable] = None):
    """Set up, measure, check; returns (result dict, Checks)."""
    import torch
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    cfg, mix = cell.cfg, cell.mix
    gen = load_module("gen", cfg["generator"])
    entry_mod = load_module("entries", cfg["entry"])
    ref = load_module("reference", cfg["reference"])
    texts = {q: cell.texts[q] for q in cell.qids}

    # set-up in contiguous phases: each starts where the one before ended
    t_gen = time.perf_counter()
    data = gen.generate(cfg, seed, device)
    table_rows = _table_rows(data)
    log(f"generate: {time.perf_counter() - t_gen:.3f} s, rows {table_rows}")
    t_load = time.perf_counter()
    entry = entry_mod.open_entry(cfg, data, device)
    if fault is not None:
        entry = fault(entry)
    log(f"load: {time.perf_counter() - t_load:.3f} s")
    spans = None
    if trace:
        spans = tracing.Spans()
        spans.install()
    rng = random.Random(seed)
    t_warm = time.perf_counter()
    for _ in range(int(mix["warmup_passes"])):
        for q in cell.qids:
            a = _ask(entry, q, texts[q], spans, False)
            if a.error is not None:
                log(f"warm-up: Q{q} raised {a.error}")
    sync()
    log(f"warm-up: {time.perf_counter() - t_warm:.3f} s, "
        f"{mix['warmup_passes']} passes")
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    setup = {"start_s": t_gen - t_start, "generate_s": t_load - t_gen,
             "load_s": t_warm - t_load, "warmup_s": t_end - t_warm}
    setup_counters = _counters()
    log("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items())
        + f" (setup_s {setup_s:.3f}); counters "
        + str({k: v for k, v in setup_counters.items() if v}))
    tracer = None
    if trace:
        tracer = _Tracer(int(mix["trace_passes"]), lambda: [
            _ask(entry, q, texts[q], spans, False) for q in cell.qids], sync)
        tracer.start()
    before = _counters()
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    answers: List[Answer] = []
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        traced = tracer.before_pass() if tracer else False
        for q in rng.sample(cell.qids, len(cell.qids)):
            answers.append(_ask(entry, q, texts[q], spans, traced))
        if tracer:
            tracer.after_pass(traced)
    sync()
    window_s = time.perf_counter() - w0
    if tracer:
        tracer.stop()
        for on in (True, False):
            lat = [a.latency_s for a in answers if a.traced is on]
            log(f"trace: {'traced' if on else 'untraced'} queries "
                f"{len(lat)}, mean latency "
                f"{stats.mean(lat) * 1e3 if lat else 0:.3f} ms "
                f"({tracer.tries} profiler starts, trace read in "
                f"{tracer.read_s:.3f} s)")
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    after = _counters()
    counters = {k: after[k] - before.get(k, 0) for k in after}
    if spans is not None:
        spans.remove()
    entry.close()
    del entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref_data = gen.for_reference(data, cfg, seed, device)
    del data
    want = ref.expected(ref_data, cell.qids, device)
    del ref_data
    log(f"reference: {time.perf_counter() - t:.3f} s")
    checks = compare.judge(answers, want, float(cfg["float_rel_limit"]))
    run = Run(cell, answers, window_s, tracer.result if tracer else None,
              counters, table_rows,
              torch.cuda.get_device_name(device) if cuda else "cpu",
              setup=setup, setup_counters=setup_counters)
    return _result(run, setup_s, max(peak_setup, peak_window), peak_window,
                   checks, trace, log), checks


def _result(run: Run, setup_s: float, peak: int, peak_window: int,
            checks: compare.Checks, trace: bool, log) -> dict:
    cell, answers = run.cell, run.answers
    failed = sum(not a.ok for a in answers)
    lat = [a.latency_s for a in answers]
    log(f"window: {run.window_s:.3f} s, {len(answers)} queries, "
        f"{failed} failed; counters {run.counters}")
    by_q: Dict[str, list] = {}
    for a in answers:
        by_q.setdefault(a.qid, []).append(a.latency_s * 1e3)
    log("latency ms by query (median/max): " + ", ".join(
        f"Q{q} {stats.percentile(v, 50):.2f}/{max(v):.2f}"
        for q, v in by_q.items()))
    for q, n in sorted(checks.wrong_queries.items()):
        log(f"wrong answers: Q{q} x{n}")
    for a in answers:
        if a.error is not None:
            log(f"error: Q{a.qid}: {a.error}")
            break
    values = {
        "setup_s": setup_s,
        "qps": (len(answers) - failed) / run.window_s,
        "latency_p50_ms": stats.percentile(lat, 50) * 1e3 if lat else None,
        "latency_p95_ms": stats.percentile(lat, 95) * 1e3 if lat else None,
        "peak_device_gib": peak_window / 2 ** 30,
    }
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = values.get(m["name"].split(".", 1)[0])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if run.device_kind != "cpu" else "cpu",
           "kind": run.device_kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    out = {"correct": checks.passed() and len(answers) > 0,
           "attempted": len(answers), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = checks.as_dict()
    return out
