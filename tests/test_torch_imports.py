"""The PyTorch port never imports JAX or the reference package: the machine
with the GPU has no JAX."""

import pathlib
import re
import subprocess
import sys

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
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'monetdb_tpu' or "
        "m.startswith('monetdb_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_no_source_imports_jax():
    """No module of the package, and not chip_smoke.py, names jax or the
    reference package in an import."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|monetdb_tpu)\b",
                     re.MULTILINE)
    files = sorted(_PKG.rglob("*.py")) + [_ROOT / "chip_smoke.py"]
    assert len(files) > 22
    hits = [str(f.relative_to(_ROOT)) for f in files
            if pat.search(f.read_text())]
    assert not hits, hits
