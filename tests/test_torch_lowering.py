"""The PyTorch port's copy of the fragment lowering against the reference's.

For each of the 22 TPC-H queries at SF0.01, the port's binder + ``Lowering``
(monetdb_tpu_torch/exec/fragment.py) either produces the same hashable IR
tuple as the reference's (monetdb_tpu/exec/fragment.py), with input tensors
equal to the reference's input arrays, or raises ``Unsupported`` naming
what is not ported yet.  The IR is the contract between the two packages.
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from monetdb_tpu.bench.tpch_load import load_tpch as ref_load_tpch  # noqa: E402
from monetdb_tpu.exec import fragment as RF  # noqa: E402
from monetdb_tpu.sql import binder as RB  # noqa: E402
from monetdb_tpu_torch.bench.tpch_load import load_tpch  # noqa: E402
from monetdb_tpu_torch.bench.tpch_queries import QUERIES  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
from monetdb_tpu_torch.sql import binder as TB  # noqa: E402

#: queries slice A must lower exactly like the reference
_MUST_LOWER = {1, 6}


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


@pytest.mark.parametrize("q", range(1, 23))
def test_lowering_matches_reference(catalogs, q):
    tcat, rcat = catalogs
    try:
        ir, penv, cap, low = _lower(TB, TF, tcat, QUERIES[q])
    except TF.Unsupported as exc:
        assert q not in _MUST_LOWER, exc
        assert "not ported yet" in str(exc)
        return
    rir, rpenv, rcap, rlow = _lower(RB, RF, rcat, QUERIES[q])
    assert ir == rir
    assert cap == rcap
    assert list(penv) == list(rpenv)
    assert len(low.inputs) == len(rlow.inputs)
    for t, r in zip(low.inputs, rlow.inputs):
        ta, ra = t.numpy(), np.asarray(r)
        assert ta.dtype == ra.dtype and np.array_equal(ta, ra)
