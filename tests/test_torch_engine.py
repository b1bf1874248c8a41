"""The PyTorch port's Engine (monetdb_tpu_torch, device="cpu") against the
reference JAX Engine (monetdb_tpu) on the same generated data.

Synthetic joins on both strategies with unique and duplicate build keys,
LIMIT, LIKE, arithmetic errors, and grouped aggregates; the TPC-H queries
are in test_torch_tpch_paths.py.  Strings, decimals, integers and counts
must be equal; floats (avg) may differ by rel 1e-12 (tests/torch_parity.py).
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import monetdb_tpu as R  # noqa: E402
from monetdb_tpu.engine import Engine as RefEngine  # noqa: E402
from monetdb_tpu.ops.calc import CalcError as RefCalcError  # noqa: E402
import monetdb_tpu_torch as T  # noqa: E402
from monetdb_tpu_torch.engine import Engine  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
from monetdb_tpu_torch.ops import calc as TC  # noqa: E402

from test_torch_cuda import dict_codes, torch_catalog  # noqa: E402
from torch_parity import FRAGMENT_RTOL, assert_rows_close  # noqa: E402


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
    assert_rows_close(list(eng.query(sql).rows), list(ref.query(sql).rows),
                      FRAGMENT_RTOL)


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
    assert_rows_close(list(eng.query(sql).rows), list(ref.query(sql).rows),
                      FRAGMENT_RTOL)


def test_unported_plan_raises_unsupported():
    """The fragment compiler still raises ``Unsupported`` for a window
    function (it has no fragment IR), and the engine then answers the plan
    through the op-at-a-time executor; a string cast lowers in the fragment
    again.  A system table and a geometry function answer as the reference
    does (the storage layer and ops/geom.py are ported)."""
    eng, ref = _catalogs({"t": {"s": (["1", "22", None], "str", {}),
                                "k": (np.arange(3, dtype=np.int32), "I32",
                                      {})}})
    cast = "select cast(s as int) from t"
    window = "select k, sum(k) over (order by k) from t"
    rel, out_cols = eng.plan(window)
    with pytest.raises(TF.Unsupported, match="WinRef"):
        TF.CompiledFragment(eng.catalog, rel, [c.name for c in out_cols])
    falls0 = TF.STATS["fallbacks"]
    assert_rows_close(list(eng.query(cast).rows),
                      list(ref.query(cast).rows), FRAGMENT_RTOL)
    assert TF.STATS["fallbacks"] == falls0
    assert_rows_close(list(eng.query(window).rows),
                      list(ref.query(window).rows), FRAGMENT_RTOL)
    assert TF.STATS["fallbacks"] == falls0 + 1
    systab = "select name from sys.tables"
    assert_rows_close(list(eng.query(systab).rows),
                      list(ref.query(systab).rows), FRAGMENT_RTOL)
    geom = "select st_area(s) from t"
    assert_rows_close(list(eng.query(geom).rows),
                      list(ref.query(geom).rows), FRAGMENT_RTOL)


# ---------------------------------------------------------------------------
# synthetic joins, LIMIT, LIKE, wide-sum narrowing, scatter/sort group-by
# ---------------------------------------------------------------------------

_NIL32 = int(np.iinfo(np.int32).min)


def _catalogs(tables):
    """{table: {column: (array, type, props)}} as the same catalog in both
    packages (see test_torch_cuda.torch_catalog for the types)."""
    rcat = R.Catalog()
    for name, cols in tables.items():
        rcols = {}
        for cn, (arr, kind, props) in cols.items():
            if kind == "str":
                codes, uniq = dict_codes(arr)
                rcols[cn] = R.Column.from_numpy(
                    codes, R.varchar(), sdict=R.StrDict(uniq), **props)
            else:
                typ = R.dtypes.decimal(*kind[1:]) if isinstance(kind, tuple) \
                    else getattr(R.dtypes, kind)
                rcols[cn] = R.Column.from_numpy(arr, typ, **props)
        rcat.add(R.Table.from_dict(name, rcols))
    return Engine(torch_catalog(tables, "cpu")), RefEngine(rcat)


def _join_tables(span, dup):
    """Probe table p(id, x, y, v) and build table b(x, y, w) joined on the
    two-column key (x, y), each key in [0, span): the packed key domain is
    span^2, so span 10000 (10^8 > 33,554,432) takes the sort strategy and
    span 100 the dense one.  Build keys are unique unless ``dup``; one
    build key and ~5% of the probe keys are nil; about half of the probe
    rows match no build row.  No column is declared a key, so inner and
    left joins check uniqueness at run time."""
    rng = np.random.default_rng(span)
    packed = rng.choice(span * span, 400, replace=False)
    bx = (packed // span).astype(np.int32)
    by = (packed % span).astype(np.int32)
    if dup:
        bx[-1], by[-1] = bx[0], by[0]
    bx[5] = _NIL32
    bw = rng.integers(0, 100, 400).astype(np.int64)
    pick = rng.integers(0, 400, 1500)
    px = np.where(rng.random(1500) < 0.6, bx[pick],
                  rng.integers(0, span, 1500)).astype(np.int32)
    py = np.where(rng.random(1500) < 0.8, by[pick],
                  rng.integers(0, span, 1500)).astype(np.int32)
    px[rng.random(1500) < 0.05] = _NIL32
    pv = rng.integers(0, 100, 1500).astype(np.int64)
    st = {"minval": 0, "maxval": span - 1}
    return {"b": {"x": (bx, "I32", dict(st)), "y": (by, "I32", dict(st)),
                  "w": (bw, "I64", {})},
            "p": {"id": (np.arange(1500, dtype=np.int32), "I32", {}),
                  "x": (px, "I32", dict(st)), "y": (py, "I32", dict(st)),
                  "v": (pv, "I64", {})}}


#: the four join kinds with a cross-side residual (p.v < b.w)
_JOIN_SQL = {
    "inner": "select p.id, p.v, b.w from p, b "
             "where p.x = b.x and p.y = b.y and p.v < b.w order by p.id",
    "left": "select p.id, p.v, b.w from p left join b "
            "on p.x = b.x and p.y = b.y and p.v < b.w order by p.id",
    "semi": "select p.id, p.v from p where exists (select * from b "
            "where b.x = p.x and b.y = p.y and b.w > p.v) order by p.id",
    "anti": "select p.id, p.v from p where not exists (select * from b "
            "where b.x = p.x and b.y = p.y and b.w > p.v) order by p.id",
}


def _join_nodes(ir, out):
    if isinstance(ir, tuple):
        if ir and ir[0] == "join":
            out.append(ir)
        for x in ir:
            _join_nodes(x, out)
    return out


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("strategy,span", [("sort", 10000), ("dense", 100)])
def test_join_matches_reference(strategy, span, kind):
    """Each join kind on each strategy, with the run-time uniqueness check
    on and a unique build: nil keys and unmatched probes on both sides,
    and a cross-side residual."""
    eng, ref = _catalogs(_join_tables(span, dup=False))
    sql = _JOIN_SQL[kind]
    got, want = eng.query(sql), ref.query(sql)
    (node,) = _join_nodes(eng._cached_plan(sql).fragment.rel_ir, [])
    assert node[1] == kind and node[5] == strategy
    assert node[7], "uniqueness check expected"
    assert got.names == want.names
    assert_rows_close(list(got.rows), list(want.rows), FRAGMENT_RTOL)
    n = len(got.rows)
    assert 0 < n <= 1500 and (kind == "left") == (n == 1500)
    if kind == "left":
        assert 0 < sum(r[2] is None for r in got.rows) < n


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("strategy,span", [("sort", 10000), ("dense", 100)])
def test_join_duplicate_build_raises_unsupported(strategy, span, kind):
    """A build side with a duplicate key is flagged on the device and
    re-lowered as an expanding join.  (Until the expanding join was ported
    that raised Unsupported, hence the name; now it must return the
    reference's rows, among them both matches of the duplicated key.)"""
    eng, ref = _catalogs(_join_tables(span, dup=True))
    sql = _JOIN_SQL[kind]
    if kind == "left":
        # (an expanding left join takes no cross-side residual at all)
        sql = sql.replace(" and p.v < b.w", "")
    before = TF.STATS["uniq_retries"]
    got, want = eng.query(sql), ref.query(sql)
    assert TF.STATS["uniq_retries"] == before + 1
    frag = eng._cached_plan(sql).fragment
    assert not _join_nodes(frag.rel_ir, []) and \
        "'join_expand'" in repr(frag.rel_ir)
    assert got.names == want.names
    assert_rows_close(list(got.rows), list(want.rows), FRAGMENT_RTOL)
    assert_rows_close(list(eng.query(sql).rows), list(want.rows),
                      FRAGMENT_RTOL)
    if kind == "left":              # no residual to drop a match
        ids = [r[0] for r in got.rows]
        assert len(ids) > len(set(ids)), "a probe row matched twice"


def _strings_table():
    rng = np.random.default_rng(21)
    words = ["forest green", "forest", "for_est", "deforest", "f%rest",
             "FOREST", "frost", "", "50% off", "a_b", "axb"]
    s = [None if rng.random() < 0.15 else words[rng.integers(len(words))]
         for _ in range(600)]
    return {"t": {"id": (np.arange(600, dtype=np.int32), "I32", {}),
                  "s": (s, "str", {})}}


@pytest.mark.parametrize("where", [
    "s like 'forest%'", "s like '%rest'", "s like '%ore%'", "s like 'f_rest'",
    "s like 'a_b'", "s like 'a!_b' escape '!'", "s like '50!% %' escape '!'",
    "s like 'f!%rest' escape '!'", "s not like 'forest%'",
    "s not like '%o%'", "s like '%'", "s like ''",
    "s like 'forest%' or s like '%x%'",
])
def test_like_matches_reference(where):
    """LIKE with %, _, an escape and NOT LIKE over a column with nils
    (nils match neither LIKE nor NOT LIKE)."""
    eng, ref = _catalogs(_strings_table())
    sql = f"select id, s from t where {where} order by id"
    got, want = list(eng.query(sql).rows), list(ref.query(sql).rows)
    assert_rows_close(got, want, FRAGMENT_RTOL)
    assert all(r[1] is not None for r in got)


def test_like_over_all_nil_column_matches_nothing():
    """An empty dictionary: the lookup table is empty too."""
    eng, ref = _catalogs({"t": {"id": (np.arange(5, dtype=np.int32), "I32",
                                       {}),
                                "s": ([None] * 5, "str", {})}})
    sql = "select id from t where s like 'a%' or s not like 'a%'"
    assert list(eng.query(sql).rows) == list(ref.query(sql).rows) == []


@pytest.mark.parametrize("sql", [
    "select a, k from t order by a limit 5",
    "select a, k from t order by a limit 5 offset 7",
    "select a, k from t order by a limit 5 offset 38",
    "select a, k from t order by a limit 5 offset 100",
    "select a, k from t order by a offset 35",
    "select a, k from t where k > 3 limit 4",
    "select a, k from t where k > 3 limit 4 offset 6",
    "select a, k from t where k > 3 limit 50 offset 3",
    "select a, k from t where k > 3 limit 4 offset 100",
])
def test_limit_offset_matches_reference(sql):
    """Both LIMIT branches (after ORDER BY: no mask; after a filter: the
    rank-indexed scatter), with offsets inside, across and past the end."""
    rng = np.random.default_rng(8)
    eng, ref = _tables(rng.permutation(40), rng.integers(0, 9, 40),
                       rng.integers(0, 9, 40))
    assert_rows_close(list(eng.query(sql).rows), list(ref.query(sql).rows),
                      FRAGMENT_RTOL)


def test_wide_sum_narrowing_overflow_matches_reference():
    """A sum beyond int64 consumed by an expression raises the
    reference's error (code 4) with the same message; shown whole it
    decodes exactly."""
    eng, ref = _tables([_BIG, _BIG, _BIG, 5], [1, 1, 1, 1], [0, 0, 0, 1])
    sql = "select k, sum(a) + 1 from t group by k order by k"
    with pytest.raises(RefCalcError) as want:
        ref.query(sql)
    with pytest.raises(TC.CalcOverflow) as got:
        eng.query(sql)
    assert str(got.value) == str(want.value)
    assert "overflow in sum aggregate" in str(got.value)
    ok = "select k, sum(a) + 1 from t where k = 1 group by k"
    assert_rows_close(list(eng.query(ok).rows), list(ref.query(ok).rows),
                      FRAGMENT_RTOL)
    whole = "select k, sum(a) as s from t group by k order by s desc"
    got = list(eng.query(whole).rows)
    assert_rows_close(got, list(ref.query(whole).rows), FRAGMENT_RTOL)
    assert got[0] == (0, 3 * _BIG)


@pytest.mark.parametrize("sql", [
    # 1000 slots > 128: scatter-mode segment reduction
    "select g, min(a), max(a), count(a), count(*), sum(a), avg(a), min(x), "
    "sum(x) from t group by g order by g",
    # a tinyint key: 256 slots
    "select h, count(*), sum(a), max(x) from t group by h order by h",
    # no statistics on the key: sort group-by
    "select u, count(*), sum(a), min(a), max(x), avg(x) from t group by u "
    "order by u",
    "select u, h, sum(a) from t where a > 0 group by u, h order by u, h",
])
def test_scatter_and_sort_groupby_match_reference(sql):
    """Group-by beyond the one-hot bound (scatter mode) and without a
    dense domain (sort strategy), with nils, floats and empty slots.  The
    float sums add in another order than the reference's: rel 1e-12."""
    rng = np.random.default_rng(13)
    n = 5000
    nil = int(np.iinfo(np.int64).min)
    a = rng.integers(-10 ** 9, 10 ** 9, n)
    a[rng.random(n) < 0.1] = nil
    x = rng.random(n) * 100
    x[rng.random(n) < 0.1] = np.nan
    g = rng.integers(0, 1000, n).astype(np.int32)
    u = rng.integers(-50, 50, n).astype(np.int64)
    u[rng.random(n) < 0.05] = nil
    eng, ref = _catalogs({"t": {
        "a": (a, "I64", {}), "x": (x, "F64", {}),
        "g": (g, "I32", {"minval": 0, "maxval": 999}),
        "h": ((g % 7 - 3).astype(np.int8), "I8", {}),
        "u": (u, "I64", {})}})
    got, want = eng.query(sql), ref.query(sql)
    assert got.names == want.names
    assert_rows_close(list(got.rows), list(want.rows), FRAGMENT_RTOL)
