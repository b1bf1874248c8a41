"""The PyTorch port's Engine (monetdb_tpu_torch, device="cpu") against the
reference JAX Engine (monetdb_tpu) on the same generated data.

TPC-H Q1 and Q6 at SF0.01 and SF0.1 (SF0.1's lineitem capacity 2^20 is
above the 2^17 compaction threshold, so it reaches ``r_compact`` and the
count-then-retry loop), arithmetic errors, and small-domain grouped
aggregates.  Strings, decimals, integers and counts must be equal; floats
(avg) may differ by rel 1e-12: both sides divide an exact integer sum by a
power of ten and the count, but torch's CPU kernel divides by a scalar as
a multiply by its reciprocal, so the last bit can differ.
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import math  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import monetdb_tpu as R  # noqa: E402
from monetdb_tpu.bench.tpch_load import load_tpch as ref_load_tpch  # noqa: E402
from monetdb_tpu.engine import Engine as RefEngine  # noqa: E402
from monetdb_tpu.ops.calc import CalcError as RefCalcError  # noqa: E402
import monetdb_tpu_torch as T  # noqa: E402
from monetdb_tpu_torch.bench.tpch_load import load_tpch  # noqa: E402
from monetdb_tpu_torch.bench.tpch_queries import QUERIES  # noqa: E402
from monetdb_tpu_torch.engine import Engine  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
from monetdb_tpu_torch.ops import calc as TC  # noqa: E402

_FLOAT_RTOL = 1e-12


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for grow, wrow in zip(got, want):
        assert len(grow) == len(wrow)
        for g, w in zip(grow, wrow):
            if isinstance(w, float):
                assert isinstance(g, float)
                assert math.isclose(g, w, rel_tol=_FLOAT_RTOL) or \
                    (math.isnan(g) and math.isnan(w)), (grow, wrow)
            else:
                assert type(g) is type(w) and g == w, (grow, wrow)


@pytest.fixture(scope="module", params=[0.01, 0.1], ids=["sf0.01", "sf0.1"])
def engines(request):
    sf = request.param
    return (sf, Engine(load_tpch(sf, device="cpu")),
            RefEngine(ref_load_tpch(sf)))


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_matches_reference(engines, q):
    sf, eng, ref = engines
    stats0 = dict(TF.STATS)
    got = eng.query(QUERIES[q])
    want = ref.query(QUERIES[q])
    assert got.names == want.names
    assert list(map(repr, got.types)) == list(map(repr, want.types))
    _assert_rows_equal(list(got.rows), list(want.rows))
    if sf == 0.1:
        frag = eng._cached_plan(QUERIES[q]).fragment
        if q == 1:
            # 2^19-row compaction bucket < ~590k live rows: overflow,
            # re-lowered with the measured total
            assert TF.STATS["cap_retries"] > stats0["cap_retries"]
        else:
            # a few thousand live rows: compacted, then shrunk to their
            # bucket
            assert "'compact'" in repr(frag.rel_ir)
            assert max(frag.expand.values()) < (1 << 19)
    # a warm run reuses the cached plan and gives the same rows
    warm = eng.query(QUERIES[q], trace=True)
    _assert_rows_equal(list(warm.rows), list(want.rows))
    run = [e for e in warm.trace if e["op"] == "fragment.run"]
    assert run and run[0]["device"] == "cpu" and run[0]["rpcs"] >= 1


def _tables(rows_a, rows_b, k):
    """The same table t(a bigint, b bigint, k int, f boolean) in both
    packages (nil = the type's minimum)."""
    k = np.asarray(k, np.int32)
    cols = {"a": (np.asarray(rows_a, np.int64), R.I64, T.I64, {}),
            "b": (np.asarray(rows_b, np.int64), R.I64, T.I64, {}),
            # min/max let the lowering pick dense (one-hot) grouping on k
            "k": (k, R.I32, T.I32, {"minval": int(k.min()),
                                    "maxval": int(k.max())}),
            "f": (k % 2 == 1, R.BOOL, T.BOOL, {})}
    rcat, tcat = R.Catalog(), T.Catalog()
    rcat.add(R.Table.from_dict("t", {
        n: R.Column.from_numpy(a, rt, **p)
        for n, (a, rt, _, p) in cols.items()}))
    tcat.add(T.Table.from_dict("t", {
        n: T.Column.from_numpy(a, tt, device="cpu", **p)
        for n, (a, _, tt, p) in cols.items()}))
    return Engine(tcat), RefEngine(rcat)


_BIG = 1 << 62


@pytest.mark.parametrize("sql,err", [
    ("select a + b from t", TC.CalcOverflow),
    ("select a * b from t", TC.CalcOverflow),
    ("select a - b from t where k = 2", TC.CalcOverflow),
    ("select a / (b - b) from t", TC.CalcDivZero),
    ("select a % (b - b) from t", TC.CalcDivZero),
])
def test_arith_errors_match_reference(sql, err):
    """Overflow and division by zero raise as the reference raises them
    (one reduced error code per run, fragment.py _raise_err)."""
    eng, ref = _tables([1, _BIG, -_BIG, 7], [2, _BIG, _BIG + 5, -1],
                       [0, 1, 2, 3])
    with pytest.raises(RefCalcError) as want:
        ref.query(sql)
    with pytest.raises(err) as got:
        eng.query(sql)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_arith_without_error_matches_reference():
    """The same expressions over rows that do not overflow: the checks
    stay quiet, nils propagate, INT64_MIN / -1 style edges do not trap."""
    nil = int(np.iinfo(np.int64).min)
    eng, ref = _tables([1, -7, nil, 9, -9], [2, -1, 3, nil, 4],
                       [0, 1, 2, 3, 4])
    sql = ("select a + b, a - b, a * b, a / b, a % b from t "
           "order by k")
    _assert_rows_equal(list(eng.query(sql).rows), list(ref.query(sql).rows))


@pytest.mark.parametrize("sql", [
    "select k, min(a), max(a), count(a), count(*), sum(a), avg(a) "
    "from t group by k order by k",
    "select k, min(b), max(b), sum(b) from t where a > 0 "
    "group by k order by k desc",
    "select count(*), sum(a), min(b), max(b) from t",
    "select f, count(*), sum(a), max(b) from t group by f order by f",
])
def test_dense_groupby_matches_reference(sql):
    """Small-domain GROUP BY (one-hot segment reduction) with nils, empty
    groups and a scalar aggregate."""
    rng = np.random.default_rng(5)
    n = 3000
    nil = int(np.iinfo(np.int64).min)
    a = rng.integers(-10 ** 9, 10 ** 9, n)
    a[rng.random(n) < 0.1] = nil
    b = rng.integers(-(2 ** 40), 2 ** 40, n)
    k = rng.integers(0, 9, n)
    eng, ref = _tables(a, b, k)
    _assert_rows_equal(list(eng.query(sql).rows), list(ref.query(sql).rows))


def test_unported_plan_raises_unsupported():
    """No fallback executor: a plan outside the slice raises."""
    eng, _ref = _tables([1], [2], [3])
    with pytest.raises(TF.Unsupported, match="not ported yet"):
        eng.query("select a from t where k in "
                  "(select k from t where a > (select avg(b) from t))")
