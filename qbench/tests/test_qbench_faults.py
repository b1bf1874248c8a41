"""Whole runs of each cell at a tiny size on the CPU, skipping only the
harness's look for a card: a sound run is correct, and a run with the
timed path broken underneath is not, once for each fault a cell can have
(a cell on one card has no exchange between chips):

* ``altered``: an answer altered where it is produced (one value of the
  first row of one query, every time it runs);
* ``half``: half of the batch left out (the fact table's live rows
  halved underneath the entry, so every scan sees the first half: the
  entry module's own ``halve``);
* ``unchanged``: a step that returns its state unchanged (each query
  answers with the previous query's result).

Also the shape of the result's line, and a traced run on the CPU."""

import time
from decimal import Decimal

import pytest

from qbench import harness
from qbench.tests import tiny

SEED = 987654321


class _Res:
    def __init__(self, rows):
        self.rows = rows


class _Altered:
    def __init__(self, entry, qid_text):
        self.entry, self.text = entry, qid_text

    def query(self, text):
        res = self.entry.query(text)
        rows = list(res.rows)
        if text == self.text and rows:
            row = list(rows[0])
            for i, v in enumerate(row):
                if isinstance(v, (int, Decimal)) and not isinstance(v, bool):
                    row[i] = v + 1
                    break
            rows[0] = tuple(row)
        return _Res(rows)

    def close(self):
        self.entry.close()


class _Unchanged:
    def __init__(self, entry):
        self.entry, self.last = entry, None

    def query(self, text):
        res = _Res(list(self.entry.query(text).rows))
        prev, self.last = self.last, res
        return prev if prev is not None else res

    def close(self):
        self.entry.close()


def _run(workload, fault=None):
    cell = tiny.cell(workload)
    return harness.run_cell(cell, SEED, 0.5, False, "cpu",
                            time.perf_counter(), log=lambda m: None,
                            fault=fault)


def _faults(cell):
    # the fault goes into the query whose answer is largest-valued first
    text = cell.texts[cell.qids[0]]
    return {"altered": lambda e: _Altered(e, text),
            "half": harness.load_module("entries", cell.cfg["entry"]).halve,
            "unchanged": _Unchanged}


@pytest.mark.parametrize("workload", tiny.workloads())
def test_sound_run_is_correct(workload):
    out, checks = _run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert checks.wrong == 0 and checks.errors == 0


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("workload", tiny.workloads())
def test_broken_run_is_not_correct(workload, fault):
    cell = tiny.cell(workload)
    out, checks = _run(workload, _faults(cell)[fault])
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0 and checks.wrong > 0


def test_result_line_shape():
    out, _ = _run("ssb-sf20.flight1")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"setup_s", "qps", "latency_p50_ms",
                                   "latency_p95_ms", "peak_device_gib"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_run_reads_the_host_metrics():
    """On the CPU the profiler sees no device: the traced run is still
    correct, reads the host clock's ``lower_ms``, ``decode_ms.session``,
    ``load_s`` and ``warmup_s`` and leaves out the metrics that need a
    device trace."""
    cell = tiny.cell("tpch-sf1.power")
    out, _ = harness.run_cell(cell, SEED, 0.5, True, "cpu",
                              time.perf_counter(), log=lambda m: None)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"lower_ms", "decode_ms.session",
                                   "load_s", "warmup_s"}
    assert out["metrics"]["lower_ms"]["value"] > 0
    assert "busy_s" not in out["device"] and "breakdown" not in out
