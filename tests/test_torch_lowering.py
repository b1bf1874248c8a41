"""The PyTorch port's copy of the fragment lowering against the reference's.

For each of the 22 TPC-H queries at SF0.01, the port's binder + ``Lowering``
(monetdb_tpu_torch/exec/fragment.py) produces the same hashable IR tuple as
the reference's (monetdb_tpu/exec/fragment.py), with input tensors equal to
the reference's input arrays.  The IR is the contract between the two
packages.  A scalar subquery is baked into the IR as a literal: the
reference computes it in its op-at-a-time executor, the port in a fragment
of its own, so a float literal (Q22's ``avg(c_acctbal)``) may differ in the
last bit and is compared to rel 1e-12; every other element of the IR,
integer and decimal literals among them, must be equal.
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import math  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from monetdb_tpu.bench.tpch_load import load_tpch as ref_load_tpch  # noqa: E402
from monetdb_tpu.exec import fragment as RF  # noqa: E402
from monetdb_tpu.sql import binder as RB  # noqa: E402
from monetdb_tpu_torch.bench.tpch_load import load_tpch  # noqa: E402
from monetdb_tpu_torch.bench.tpch_queries import QUERIES  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
from monetdb_tpu_torch.sql import binder as TB  # noqa: E402

#: queries that must lower exactly like the reference: all of TPC-H
_MUST_LOWER = set(range(1, 23))
_FLOAT_LIT_RTOL = 1e-12


def _ir_differ(a, b, path="ir"):
    """None when two IR trees are equal (floats to _FLOAT_LIT_RTOL,
    everything else exactly and of the same type), else where they part."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        if len(a) != len(b):
            return f"{path}: {len(a)} elements != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = _ir_differ(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    if isinstance(a, float) and isinstance(b, float):
        same = math.isclose(a, b, rel_tol=_FLOAT_LIT_RTOL) or \
            (math.isnan(a) and math.isnan(b))
    else:
        same = type(a) is type(b) and a == b
    return None if same else f"{path}: {a!r} != {b!r}"


def test_ir_differ_is_exact_but_for_floats():
    ir = ("cmp", "gt", ("env", "t", "a"), ("lit", 4.5, "<f8"), False)
    assert _ir_differ(ir, ir) is None
    near = ("cmp", "gt", ("env", "t", "a"), ("lit", 4.5 * (1 + 1e-14),
                                             "<f8"), False)
    assert _ir_differ(ir, near) is None
    for other in (
            ("cmp", "gt", ("env", "t", "a"), ("lit", 4.5001, "<f8"), False),
            ("cmp", "gt", ("env", "t", "a"), ("lit", 4, "<f8"), False),
            ("cmp", "gt", ("env", "t", "b"), ("lit", 4.5, "<f8"), False),
            ("cmp", "gt", ("env", "t", "a"), ("lit", 4.5, "<f8"), 0),
            ir[:-1]):
        assert _ir_differ(ir, other) is not None
    assert _ir_differ(("lit", 10 ** 15 + 1, "<i8"),
                      ("lit", 10 ** 15, "<i8")) is not None


@pytest.fixture(scope="module")
def catalogs():
    return load_tpch(0.01, device="cpu"), ref_load_tpch(0.01)


def _lower(binder_mod, fragment_mod, cat, sql):
    # generated column names ("col<N>") come from a process-wide counter:
    # start both packages from the same state, and leave it as it was
    saved = binder_mod.Binder._auto_counter
    binder_mod.Binder._auto_counter = 0
    try:
        rel, _cols = binder_mod.bind_select(cat, sql)
    finally:
        binder_mod.Binder._auto_counter = saved
    low = fragment_mod.Lowering(cat)
    low.collect_refs(rel)
    ir, penv, cap = low.rel(rel)
    return ir, penv, cap, low


def test_catalog_columns_equal(catalogs):
    """Every TPC-H column uploads with the reference's values, dtype,
    capacity and property flags."""
    tcat, rcat = catalogs
    assert set(tcat.tables) == set(rcat.tables)
    for name, rt in rcat.tables.items():
        tt = tcat.get(name)
        assert tt.names() == rt.names()
        for c in rt.names():
            tc, rc = tt.col(c), rt.col(c)
            assert tc.data.device.type == "cpu"
            ta, ra = tc.data.numpy(), np.asarray(rc.data)
            assert ta.dtype == ra.dtype and np.array_equal(ta, ra), (name, c)
            for prop in ("count", "sorted", "revsorted", "key", "nonil",
                         "minval", "maxval"):
                assert getattr(tc, prop) == getattr(rc, prop), (name, c, prop)
            if rc.sdict is not None:
                assert np.array_equal(tc.sdict.values, rc.sdict.values)


@pytest.mark.parametrize("q", sorted(_MUST_LOWER))
def test_lowering_matches_reference(catalogs, q):
    tcat, rcat = catalogs
    ir, penv, cap, low = _lower(TB, TF, tcat, QUERIES[q])
    rir, rpenv, rcap, rlow = _lower(RB, RF, rcat, QUERIES[q])
    assert _ir_differ(ir, rir) is None
    assert cap == rcap
    assert list(penv) == list(rpenv)
    assert len(low.inputs) == len(rlow.inputs)
    for t, r in zip(low.inputs, rlow.inputs):
        ta, ra = t.numpy(), np.asarray(r)
        assert ta.dtype == ra.dtype and np.array_equal(ta, ra)
