"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
found as a file: configurations, their CPU sizes, mixes, query sets,
generators, entries, references and per-layer metrics load by name."""

import json
import os
import re

import pytest

from qbench import harness
from qbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
B = tiny.bench()
#: what a configuration's CPU sizes may not override: only its scale
NOT_SCALE = {"name", "entry", "generator", "queries", "reference", "schema",
             "guarantees", "float_rel_limit"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["command"]) <= 32 and all(_line(w) for w in
                                                B["command"])
    assert B["paths"] == ["qbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in B["paths"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and \
            _line(c["why"])
        assert c["file"] == f"qbench/configs/{c['name']}.json"
        cfg = harness.load_json(c["file"])
        assert cfg["name"] == c["name"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in B["workloads"])
        for kind in ("gen", "entries", "reference"):
            key = {"gen": "generator", "entries": "entry"}.get(kind, kind)
            harness.load_module(kind, cfg[key])
        harness.load_json(f"qbench/queries/{cfg['queries']}.json")
        assert "guarantees" in cfg and "assumed" in cfg
        small = tiny.sizes(c["name"])
        assert small and set(small) <= set(cfg) - NOT_SCALE, small


@pytest.mark.parametrize("entry", sorted(
    f[:-3] for f in os.listdir(os.path.join(harness.QB, "entries"))
    if f.endswith(".py") and f != "__init__.py"))
def test_entries_export_open_entry_and_halve(entry):
    mod = harness.load_module("entries", entry)
    assert callable(mod.open_entry) and callable(mod.halve)


def test_workloads():
    assert 1 <= len(B["workloads"]) <= 24
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.Cell(B, w["name"])
        assert cell.qids and all(q in cell.texts for q in cell.qids)
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
        assert cell.per_layer
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= \
        max(1, len(B["workloads"]) // 4)


def test_metrics():
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    e2e = {m["name"] for m in B["end_to_end"]}
    cells = {w["name"] for w in B["workloads"]}
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        harness.load_module("metrics", m["name"])
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("mix", sorted(
    f[:-5] for f in os.listdir(os.path.join(harness.QB, "mixes"))))
def test_mix_files_load_by_name(mix):
    m = harness.load_json(f"qbench/mixes/{mix}.json")
    assert m["loop"] == "closed" and m["clients"] == 1
    assert m["queries"] and m["warmup_passes"] >= 1 and m["trace_passes"] >= 1


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(harness.QB):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_cache")]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
            assert PATH.match(rel), rel
