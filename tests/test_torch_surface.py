"""The port's public surface where it once differed from the JAX package's:
the ``exec`` and ``ops`` package re-exports, ``cpu_baseline``'s
``sqlite_interrupted``, ``load_tpch``'s positional ``cache`` and the
reference's positional order of ``CompiledFragment.run``.  The port is
driven on the CPU; nothing of JAX is imported."""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import pathlib  # noqa: E402
import sqlite3  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parent.parent

_FRESH = {
    "exec": "from monetdb_tpu_torch.exec import Executor, Frame, Scalar\n"
            "from monetdb_tpu_torch.exec.executor import Executor as E\n"
            "assert Executor is E and Frame and Scalar\n",
    "ops": "import monetdb_tpu_torch.ops as ops\n"
           "for n in ('select', 'calc', 'project', 'group', 'aggr', 'sort',"
           " 'join', 'window'):\n"
           "    mod = getattr(ops, n)\n"
           "    assert mod.__name__ == 'monetdb_tpu_torch.ops.' + n\n",
}


@pytest.mark.parametrize("package", sorted(_FRESH))
def test_package_reexports_in_a_fresh_process(package):
    """In a process that imported nothing else of the port (so no cycle
    and no earlier submodule import hides a missing re-export), and with
    no JAX loaded afterwards."""
    code = _FRESH[package] + "import sys\nassert 'jax' not in sys.modules\n"
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sqlite_interrupted_is_operational_error():
    from monetdb_tpu_torch.bench.cpu_baseline import sqlite_interrupted
    assert sqlite_interrupted() is sqlite3.OperationalError


def test_load_tpch_takes_cache_positionally():
    from monetdb_tpu_torch.bench.tpch_load import load_tpch
    pos = load_tpch(0.01, False, device="cpu")
    kw = load_tpch(0.01, cache=False, device="cpu")
    assert pos is not kw
    assert sorted(pos.tables) == sorted(kw.tables)
    for name, t in kw.tables.items():
        for c, col in t.columns.items():
            assert np.array_equal(pos.tables[name].columns[c].data.numpy(),
                                  col.data.numpy()), (name, c)


def test_compiled_fragment_run_takes_mesh_second():
    """``run(events, mesh)`` as the reference orders it: a positional
    ``None`` mesh runs on one device with the rows of ``run()``."""
    from monetdb_tpu_torch.bench.tpch_load import load_tpch
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    from monetdb_tpu_torch.engine import Engine
    from monetdb_tpu_torch.exec import fragment as TF

    eng = Engine(load_tpch(0.01, device="cpu"))
    rel, cols = eng.plan(QUERIES[6])
    compiled = TF.compile_fragment(eng.catalog, rel, [c.name for c in cols])
    runs = TF.STATS["runs"]
    want = compiled.run()
    events = []
    got = compiled.run(events, None)
    assert TF.STATS["runs"] == runs + 2
    assert [e["algorithm"] for e in events] == ["fragment:jit"]
    assert got.count == want.count == 1
    for g, w in zip(got.arrays, want.arrays):
        assert np.array_equal(g[:got.count], w[:want.count])
