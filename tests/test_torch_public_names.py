"""The port's public surface against the JAX package's, per module of the
same path (``ops/pallas_kernels`` maps to ``ops/cuda_kernels``):

- every name in the ``__all__`` of a module of ``monetdb_tpu``;
- every name a package ``__init__`` imports from its own modules;
- every public module-level ``def`` and ``class``;
- the positional parameters of those functions and of the classes' public
  methods (``__init__`` included): the reference's are a prefix of the
  port's, in the same order (the port may add more, and keyword-only
  ones such as ``device``).

The JAX modules are read from their source with ``ast``, so nothing of JAX
is imported for it.  Plain imports inside other modules (typing names,
helpers) are implementation detail and not held.  Then ``run_fragment``
and ``compile_fragment`` on a TPC-H query against the JAX package's."""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import ast  # noqa: E402
import importlib  # noqa: E402
import inspect  # noqa: E402
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


def _init_imports(path: pathlib.Path):
    """Names a package ``__init__`` binds by a relative import of one of
    its own modules.  An import of a module that does not exist (the
    reference's ``sql/__init__`` guards ``from .session import Session``
    with ``except ImportError``) binds nothing."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if not (isinstance(node, ast.ImportFrom) and node.level == 1):
            continue
        for alias in node.names:
            rel = (node.module or alias.name).replace(".", "/")
            target = path.parent / rel
            if target.with_suffix(".py").exists() or target.is_dir():
                names.append(alias.asname or alias.name)
    return names


def _bound_names(path: pathlib.Path):
    """Names a module's top-level statements bind."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


def _public_defs(path: pathlib.Path):
    """The public module-level ``def`` and ``class`` nodes of a source."""
    return [n for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


_PACKAGES = sorted((_port_module(p), _init_imports(p))
                   for p in _REF.rglob("__init__.py") if _init_imports(p))
_DEF_MODULES = sorted((_port_module(p), p) for p in _REF.rglob("*.py")
                      if _public_defs(p))
_NOT_CALLED = {"property", "setter", "getter", "deleter", "cached_property"}


def _decorators(fn):
    names = set()
    for d in fn.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        names.add(d.attr if isinstance(d, ast.Attribute) else
                  getattr(d, "id", ""))
    return names


def _reference_positional(fn, method: bool):
    names = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if method and "staticmethod" not in _decorators(fn):
        names = names[1:]           # self / cls
    return names


def _port_positional(obj, method: bool):
    if isinstance(obj, staticmethod):
        obj, method = obj.__func__, False
    elif isinstance(obj, classmethod):
        obj = obj.__func__
    params = [p.name for p in inspect.signature(obj).parameters.values()
              if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return params[1:] if method else params


def test_reference_modules_found():
    assert len(_MODULES) >= 50
    assert ("monetdb_tpu_torch.exec.fragment" in dict(_MODULES))


@pytest.mark.parametrize("module, names", _MODULES,
                         ids=[m for m, _n in _MODULES])
def test_port_module_has_every_public_name(module, names):
    mod = importlib.import_module(module)
    assert [n for n in names if not hasattr(mod, n)] == []


def test_reference_packages_found():
    assert dict(_PACKAGES)["monetdb_tpu_torch.ops"] == [
        "select", "calc", "project", "group", "aggr", "sort", "join",
        "window"]
    assert "monetdb_tpu_torch.sql" not in dict(_PACKAGES)
    assert len(_DEF_MODULES) >= 55


@pytest.mark.parametrize("module, names", _PACKAGES,
                         ids=[m for m, _n in _PACKAGES])
def test_port_package_binds_every_reference_import(module, names):
    """Each name a reference ``__init__`` imports is bound by the port's
    ``__init__`` itself (not left to an import of a submodule elsewhere in
    the process) and is on the package object."""
    mod = importlib.import_module(module)
    bound = _bound_names(pathlib.Path(mod.__file__))
    assert [n for n in names if n not in bound or not hasattr(mod, n)] == []


@pytest.mark.parametrize("module, path", _DEF_MODULES,
                         ids=[m for m, _p in _DEF_MODULES])
def test_port_module_has_every_public_def(module, path):
    mod = importlib.import_module(module)
    assert [n.name for n in _public_defs(path)
            if not hasattr(mod, n.name)] == []


@pytest.mark.parametrize("module, path", _DEF_MODULES,
                         ids=[m for m, _p in _DEF_MODULES])
def test_port_positional_parameters_extend_the_reference(module, path):
    """A call that passes the reference's positional arguments means the
    same to the port: per public function, and per public method and
    ``__init__`` of a public class, the reference's positional parameters
    are a prefix of the port's."""
    mod = importlib.import_module(module)
    differ = []
    for node in _public_defs(path):
        obj = getattr(mod, node.name, None)
        if obj is None:
            continue                # test_port_module_has_every_public_def
        if not isinstance(node, ast.ClassDef):
            ref = _reference_positional(node, False)
            if _port_positional(obj, False)[:len(ref)] != ref:
                differ.append(node.name)
            continue
        for meth in node.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or (meth.name.startswith("_")
                        and meth.name != "__init__") \
                    or _decorators(meth) & _NOT_CALLED:
                continue
            ref = _reference_positional(meth, True)
            try:
                port = _port_positional(
                    inspect.getattr_static(obj, meth.name), True)
            except AttributeError:
                port = None
            if port is None or port[:len(ref)] != ref:
                differ.append(f"{node.name}.{meth.name}")
    assert differ == []


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
