"""The port's public names against the JAX package's: every name in the
``__all__`` of a module of ``monetdb_tpu`` exists in the port's module of
the same path (``ops/pallas_kernels`` maps to ``ops/cuda_kernels``).  The
JAX modules' ``__all__`` is read from their source, so nothing of JAX is
imported for it.  Then ``run_fragment`` and ``compile_fragment`` on a TPC-H
query against the JAX package's."""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import ast  # noqa: E402
import importlib  # noqa: E402
import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_REF = _ROOT / "monetdb_tpu"


def _public(path: pathlib.Path):
    """The literal ``__all__`` of a module's source, or None."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _port_module(path: pathlib.Path) -> str:
    parts = list(path.relative_to(_REF).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    if parts == ["ops", "pallas_kernels"]:
        parts = ["ops", "cuda_kernels"]
    return ".".join(["monetdb_tpu_torch"] + parts)


_MODULES = sorted((_port_module(p), _public(p)) for p in _REF.rglob("*.py")
                  if _public(p) is not None)


def test_reference_modules_found():
    assert len(_MODULES) >= 50
    assert ("monetdb_tpu_torch.exec.fragment" in dict(_MODULES))


@pytest.mark.parametrize("module, names", _MODULES,
                         ids=[m for m, _n in _MODULES])
def test_port_module_has_every_public_name(module, names):
    mod = importlib.import_module(module)
    assert [n for n in names if not hasattr(mod, n)] == []


def test_join_result_is_the_reference_tuple_type():
    from monetdb_tpu_torch.ops.join import JoinResult
    from typing import Generic
    assert JoinResult.__mro__[1:] == (tuple, Generic, object)
    assert JoinResult((1, 2)) == (1, 2)


def test_run_fragment_equals_reference():
    """``run_fragment`` (lower + run in one call) and ``compile_fragment``
    give TPC-H Q3 at SF0.01 with the JAX package's count and columns."""
    from monetdb_tpu.bench.tpch_load import load_tpch as ref_load_tpch
    from monetdb_tpu.engine import Engine as RefEngine
    from monetdb_tpu.exec import fragment as RF
    from monetdb_tpu_torch.bench.tpch_load import load_tpch
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    from monetdb_tpu_torch.engine import Engine
    from monetdb_tpu_torch.exec import fragment as TF

    eng, ref = Engine(load_tpch(0.01, device="cpu")), \
        RefEngine(ref_load_tpch(0.01))
    rel, cols = eng.plan(QUERIES[3])
    rrel, rcols = ref.plan(QUERIES[3])
    names = [c.name for c in cols]
    assert names == [c.name for c in rcols]
    want = RF.run_fragment(ref.catalog, rrel, names)
    runs = TF.STATS["runs"]
    got = TF.run_fragment(eng.catalog, rel, names)
    assert TF.STATS["runs"] == runs + 1
    compiled = TF.compile_fragment(eng.catalog, rel, names)
    assert isinstance(compiled, TF.CompiledFragment)
    again = compiled.run()
    assert got.count == want.count == again.count > 0
    assert len(got.arrays) == len(want.arrays) == len(again.arrays)
    for g, a, w in zip(got.arrays, again.arrays, want.arrays):
        w = np.asarray(w)[:want.count]
        assert g.dtype == w.dtype
        assert np.array_equal(g[:got.count], w)
        assert np.array_equal(a[:again.count], w)
