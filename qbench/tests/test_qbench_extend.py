"""A configuration joins the benchmark by new files and ``BENCHMARK.json``
entries alone: in a copy of ``qbench/``, a configuration ``ssb-sf20-copy``
(ssb-sf20's file under a new name), its CPU sizes, a ``configs`` entry and
a cell ``ssb-sf20-copy.flight1``, appended to the ``workloads`` list of
every metric that ``ssb-sf20.flight1`` reports, pass the copy's layout,
CPU control and fault tests, and no file the copy had changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from qbench import harness

CONFIG = "ssb-sf20-copy"
CELL = f"{CONFIG}.flight1"
LIKE = "ssb-sf20.flight1"
ADDED = {f"qbench/configs/{CONFIG}.json", f"qbench/tests/sizes/{CONFIG}.json"}


def _files(root) -> dict:
    """Relative path -> digest of every file of ``BENCHMARK.json`` and
    ``qbench/``, caches left out."""
    out = {}
    for dirpath, dirnames, files in os.walk(os.path.join(root, "qbench")):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_cache")]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    with open(os.path.join(root, "BENCHMARK.json"), "rb") as fh:
        out["BENCHMARK.json"] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _add_configuration(root) -> None:
    with open(os.path.join(root, "qbench/configs/ssb-sf20.json")) as f:
        cfg = json.load(f)
    cfg["name"] = CONFIG
    with open(os.path.join(root, f"qbench/configs/{CONFIG}.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    shutil.copy(os.path.join(root, "qbench/tests/sizes/ssb-sf20.json"),
                os.path.join(root, f"qbench/tests/sizes/{CONFIG}.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    like = [c for c in bench["configs"] if c["name"] == "ssb-sf20"][0]
    bench["configs"].append(dict(like, name=CONFIG,
                                 file=f"qbench/configs/{CONFIG}.json"))
    bench["workloads"].append(
        {"name": CELL, "config": CONFIG, "traffic": "flight1", "chips": 1,
         "why": "ssb-sf20.flight1 under a configuration of its own"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if LIKE in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)


def test_a_configuration_joins_by_files_alone(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.QB, tmp_path / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = _files(tmp_path)
    _add_configuration(tmp_path)
    env = dict(os.environ, TMPDIR=str(tmp_path),
               PYTHONPATH=os.pathsep.join([str(tmp_path), harness.ROOT]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "qbench/tests/test_qbench_layout.py",
         "qbench/tests/test_qbench_control.py",
         "qbench/tests/test_qbench_faults.py",
         "-k", f"test_qbench_layout or {CELL}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    passed = {line.split(" ", 1)[0].split("::", 1)[1]
              for line in out.stdout.splitlines() if " PASSED" in line}
    assert {"test_configs", "test_workloads", "test_metrics",
            f"test_control_fails_on_the_cpu[{CELL}]",
            f"test_sound_run_is_correct[{CELL}]",
            *(f"test_broken_run_is_not_correct[{CELL}-{f}]"
              for f in ("altered", "half", "unchanged"))} <= passed, passed
    after = _files(tmp_path)
    assert set(after) == set(before) | ADDED
    assert {p for p in before if after[p] != before[p]} == {"BENCHMARK.json"}
