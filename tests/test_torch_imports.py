"""The PyTorch port never imports JAX or the reference package: the machine
with the GPU has no JAX."""

import pathlib
import re
import subprocess
import sys

import pytest

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_PKG = _ROOT / "monetdb_tpu_torch"


def test_import_pulls_in_no_jax():
    """Importing the package and every module of the slice's path leaves
    jax and monetdb_tpu out of sys.modules."""
    code = (
        "import sys\n"
        "import monetdb_tpu_torch\n"
        "import monetdb_tpu_torch.engine\n"
        "import monetdb_tpu_torch.exec.fragment\n"
        "import monetdb_tpu_torch.bench.tpch_load\n"
        "import monetdb_tpu_torch.bench.tpch_queries\n"
        "import monetdb_tpu_torch.bench.tpch_oracle\n"
        "import monetdb_tpu_torch.ops.strfuncs\n"
        "import monetdb_tpu_torch.ops.cuda_kernels\n"
        "import monetdb_tpu_torch.exec.executor\n"
        "import monetdb_tpu_torch.exec.dataflow\n"
        "import monetdb_tpu_torch.storage.columns\n"
        "import monetdb_tpu_torch.obs\n"
        "import monetdb_tpu_torch.obs.assertprops\n"
        "import monetdb_tpu_torch.bench.tpcds\n"
        "import monetdb_tpu_torch.bench.ssbm\n"
        "from monetdb_tpu_torch.ops import (aggr, atoms, calc, datecalc, "
        "group, join, jsonfuncs, project, select, sort, window)\n"
        "from monetdb_tpu_torch import (dbapi, dump, embedded, session, "
        "testing, udf)\n"
        "from monetdb_tpu_torch.sql import distribute, psm, syscat\n"
        "from monetdb_tpu_torch.storage import csv_native, database, wal\n"
        "from monetdb_tpu_torch import cli, farm, server\n"
        "from monetdb_tpu_torch.ops import external, geom\n"
        "from monetdb_tpu_torch import parallel\n"
        "from monetdb_tpu_torch.parallel import mesh, mitosis, shuffle\n"
        "from monetdb_tpu_torch.bench import kernels\n"
        "from monetdb_tpu_torch.parallel import dist\n"
        "from monetdb_tpu_torch import harness\n"
        "from monetdb_tpu_torch.bench import mesh_procs, mesh_cards\n"
        "from monetdb_tpu_torch.bench import microbench, cpu_baseline\n"
        "from monetdb_tpu_torch.bench import bench\n"
        "assert bench.main.__defaults__ == ('cuda:0',)\n"
        "assert parallel.ProcessMesh is dist.ProcessMesh\n"
        "assert parallel.initialize is dist.initialize\n"
        "assert parallel.shutdown is dist.shutdown\n"
        "h = parallel.ProcessMesh(2, 1, ['cpu'] * 2, 'gloo')\n"
        "assert h.size == 4 and list(h.shards) == [2, 3]\n"
        "assert parallel.shard_array(list(range(8)), h).tolist() == "
        "[4, 5, 6, 7]\n"
        "assert microbench.uniform(4, 3, device='cpu').count == 4\n"
        "m = parallel.row_mesh(['cpu'] * 2)\n"
        "t = parallel.shard_array(__import__('numpy').arange(5), m)\n"
        "assert int(shuffle.lane_counts(m, t, t >= 0).sum()) == 6\n"
        "s = session.Session(database.Database(device='cpu'))\n"
        "s.sql('create table t (a int)')\n"
        "s.sql('create sequence q as integer start with 2')\n"
        "s.sql('alter sequence q restart with (select count(*) from t)')\n"
        "assert s.sql('select count(*) from sys.tables').rows[0][0] >= 1\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'monetdb_tpu' or "
        "m.startswith('monetdb_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_module_entry_point_loads_no_jax():
    """``python -m monetdb_tpu_torch -s "select 1" --device cpu`` answers,
    and running the package's __main__ loads neither jax nor monetdb_tpu."""
    r = subprocess.run(
        [sys.executable, "-m", "monetdb_tpu_torch", "-s", "select 1",
         "--device", "cpu"], cwd=_ROOT, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert "1 tuple" in r.stdout
    code = (
        "import runpy, sys\n"
        "sys.argv = ['monetdb_tpu_torch', '-s', 'select 1', "
        "'--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('monetdb_tpu_torch', run_name='__main__')\n"
        "except SystemExit as ex:\n"
        "    assert ex.code == 0, ex.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'monetdb_tpu' or "
        "m.startswith('monetdb_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_no_source_imports_jax():
    """No module of the package, and not chip_smoke.py, names jax or the
    reference package in an import statement or in a string handed to
    ``__import__`` / ``importlib``."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|monetdb_tpu)\b",
                     re.MULTILINE)
    named = re.compile(r"""["'](jax|jaxlib|monetdb_tpu)(\.[\w.]*)?["']""")
    files = sorted(_PKG.rglob("*.py")) + [_ROOT / "chip_smoke.py"]
    assert len(files) > 50
    hits = [str(f.relative_to(_ROOT)) for f in files
            if pat.search(f.read_text()) or named.search(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("module, code", [("monetdb_tpu_torch.harness", 1),
                                          ("monetdb_tpu_torch.bench."
                                           "mesh_procs", 2)])
def test_harness_and_mesh_procs_entry_points_load_no_jax(module, code):
    """``python -m monetdb_tpu_torch.harness`` and ``python -m
    monetdb_tpu_torch.bench.mesh_procs`` load neither jax nor monetdb_tpu
    (without a card the first exits 1, the second 2)."""
    if __import__("torch").cuda.is_available():
        pytest.skip("the entry points would run on the card")
    src = (
        "import runpy, sys\n"
        f"sys.argv = [{module!r}]\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__')\n"
        "except SystemExit as ex:\n"
        f"    assert ex.code == {code}, ex.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'monetdb_tpu' or "
        "m.startswith('monetdb_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", src], cwd=_ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
