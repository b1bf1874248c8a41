"""The port's last two bench modules against the JAX package's:
``bench/microbench.py`` (seeded synthetic columns) and
``bench/cpu_baseline.py`` (TPC-H on stdlib sqlite3, a CPU figure)."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from monetdb_tpu.bench import microbench as RM
from monetdb_tpu_torch.bench import microbench as TM

_ROOT = pathlib.Path(__file__).resolve().parent.parent

#: (generator, arguments before the seed): every generator, a domain each
GENERATORS = [
    ("uniform", (1000,)),
    ("normal", (3.0, 2.5)),
    ("zipf", (500, 1.1)),
    ("skewed", (1000, 0.1, 0.9)),
    ("sorted_runs", (64,)),
]


@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("n", [1, 10_000])
@pytest.mark.parametrize("name, args", GENERATORS)
def test_microbench_equals_reference(name, args, n, seed):
    """The same values, type, capacity and column properties as the JAX
    package's generator for the same seed, on the CPU."""
    want = getattr(RM, name)(n, *args, seed=seed)
    got = getattr(TM, name)(n, *args, seed=seed, device="cpu")
    assert got.data.device.type == "cpu"
    w = np.asarray(want.data)
    g = got.data.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    # a float column's tail past the count holds its nil, NaN
    assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f")
    # SQLType of each package: equal by name
    assert repr(got.typ) == repr(want.typ)
    assert got.count == want.count == n
    for prop in ("sorted", "revsorted", "key", "nonil", "minval",
                 "maxval"):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_microbench_defaults_to_the_card():
    """Without ``device`` a generator places its column on "cuda", as
    ``load_tpch`` does (raises where there is no card)."""
    import inspect
    for name, _args in GENERATORS:
        dev = inspect.signature(getattr(TM, name)).parameters["device"]
        assert dev.default == "cuda" and dev.kind == dev.KEYWORD_ONLY


def test_cpu_baseline_prints_the_table_without_jax():
    """``python -m monetdb_tpu_torch.bench.cpu_baseline 0.01``: the marker
    naming sqlite, then one row per query (none times out at SF0.01),
    with neither jax nor monetdb_tpu loaded."""
    src = (
        "import runpy, sys\n"
        "sys.argv = ['cpu_baseline', '0.01']\n"
        "runpy.run_module('monetdb_tpu_torch.bench.cpu_baseline', "
        "run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'monetdb_tpu' or "
        "m.startswith('monetdb_tpu.'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", src], cwd=_ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("<!-- cpu-sf0.01-measured engine=sqlite-")
    assert lines[1:3] == ["| query | warm ms |", "|---|---|"]
    rows = [ln.split("|")[1:3] for ln in lines[3:]]
    assert [q.strip() for q, _ms in rows] == [f"q{i}" for i in range(1, 23)]
    assert all(float(ms) >= 0 for _q, ms in rows)
    assert "TIMEOUT" not in r.stderr
