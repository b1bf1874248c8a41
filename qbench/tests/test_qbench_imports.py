"""What may import what, checked in fresh processes by whole top-level
module names (``monetdb_tpu_torch`` begins with ``monetdb_tpu``, so a
prefix test would be wrong): the harness, every module it loads by name
and a whole tiny run load neither JAX nor the JAX package; the references
load nothing of the program either; and the command fails, printing no
result, in a directory that holds only ``BENCHMARK.json`` and ``qbench/``.
"""

import json
import os
import shutil
import subprocess
import sys

from qbench import harness

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "monetdb_tpu"}


def _loaded_after(code: str) -> set:
    probe = code + ("\nimport sys, json\nprint(json.dumps(sorted("
                    "{m.split('.', 1)[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _modules(kind: str) -> list:
    return sorted(f[:-3] for f in os.listdir(os.path.join(harness.QB, kind))
                  if f.endswith(".py") and f != "__init__.py")


def test_harness_and_a_whole_run_load_no_jax():
    code = "\n".join(
        ["import qbench.run, qbench.control",
         "from qbench import harness"]
        + [f"harness.load_module({k!r}, {m!r})"
           for k in ("gen", "entries", "reference", "metrics")
           for m in _modules(k)]
        + ["import time",
           "from qbench.tests import tiny",
           "harness.run_cell(tiny.cell('ssb-sf20.flight1'), 5, 0.2, False,"
           " 'cpu', time.perf_counter(), log=lambda m: None)",
           "from qbench import run",
           "assert not run.forbidden_loaded(), run.forbidden_loaded()"])
    loaded = _loaded_after(code)
    assert "monetdb_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_references_load_nothing_of_the_program():
    for m in _modules("reference"):
        loaded = _loaded_after(
            f"from qbench import harness\nharness.load_module('reference', "
            f"{m!r})")
        assert not loaded & (FORBIDDEN | {"monetdb_tpu_torch"}), (m, loaded)
    # the control and the generators share that
    loaded = _loaded_after("import qbench.control\nimport qbench.gen.tpch\n"
                           "import qbench.gen.ssb")
    assert not loaded & (FORBIDDEN | {"monetdb_tpu_torch"}), loaded


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.QB, tmp_path / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "qbench.run", "--workload", "tpch-sf1.power",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 4, out.stderr
    assert out.stdout.strip() == ""


def test_command_refuses_to_run_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        return      # on the card the command measures; see test_qbench_card
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "qbench.run", "--workload", "tpch-sf1.power",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 3, out.stderr
    assert out.stdout.strip() == ""
