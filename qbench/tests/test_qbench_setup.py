"""Set-up split into its phases: a tiny traced run of each cell on the CPU
reads ``load_s`` and ``warmup_s`` (host clock: with or without a device
trace), its four phases add up to ``setup_s``, and a counter the program
charges while the entry opens shows in ``Run.setup_counters`` and not in
the window's ``Run.counters``; one charged at every query holds the
warm-up's queries there (not the tracer's settling pass) and the window's
in ``Run.counters``."""

import time

import pytest

from qbench import harness
from qbench.tests import tiny

SEED = 3_000_000_019
PHASES = ("start_s", "generate_s", "load_s", "warmup_s")


@pytest.mark.parametrize("workload", tiny.workloads())
def test_setup_phases_and_counters(workload, monkeypatch):
    from monetdb_tpu_torch.exec.fragment import STATS
    cell = tiny.cell(workload)
    mod = harness.load_module("entries", cell.cfg["entry"])
    open_entry = mod.open_entry

    class Counted:
        def __init__(self, entry):
            self.entry = entry

        def query(self, text):
            STATS["qbench_asked"] += 1
            return self.entry.query(text)

        def close(self):
            self.entry.close()

    def opened(*args, **kwargs):
        STATS["qbench_probe"] += 7
        return Counted(open_entry(*args, **kwargs))

    monkeypatch.setitem(STATS, "qbench_probe", 0)
    monkeypatch.setitem(STATS, "qbench_asked", 0)
    monkeypatch.setattr(mod, "open_entry", opened)
    seen = {}
    result = harness._result

    def keep(run, setup_s, *args):
        seen.update(run=run, setup_s=setup_s)
        return result(run, setup_s, *args)

    monkeypatch.setattr(harness, "_result", keep)
    out, _ = harness.run_cell(cell, SEED, 0.3, True, "cpu",
                              time.perf_counter(), log=lambda m: None)
    assert out["correct"], out["checks"]
    run = seen["run"]
    assert set(run.setup) == set(PHASES)
    assert all(run.setup[k] >= 0 for k in PHASES)
    assert abs(sum(run.setup.values()) - seen["setup_s"]) < 1e-3
    for name in ("load_s", "warmup_s"):
        assert out["metrics"][name] == {"value": run.setup[name],
                                        "unit": "s"}
        assert out["metrics"][name]["value"] > 0
    assert run.setup_counters["fragment.qbench_probe"] == 7
    assert run.counters["fragment.qbench_probe"] == 0
    assert run.setup_counters["fragment.qbench_asked"] == \
        int(cell.mix["warmup_passes"]) * len(cell.qids)
    assert run.counters["fragment.qbench_asked"] == out["attempted"]


def test_readers_read_nothing_without_setup():
    cell = tiny.cell("ssb-sf20.flight1")
    run = harness.Run(cell, [], 1.0, None, {}, {}, "cpu")
    assert run.setup == {} and run.setup_counters == {}
    for name in ("load_s", "warmup_s"):
        assert harness.load_module("metrics", name).read(run) is None
