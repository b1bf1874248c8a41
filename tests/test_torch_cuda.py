"""GPU tests of the PyTorch port: the hand-written CUDA kernels against
their plain PyTorch versions, and the engine on a CUDA device (TPC-H and
the synthetic statements below, against the same catalog on the CPU).

They need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode) and skip
elsewhere.  This file imports no JAX, so it runs on a GPU machine without
it; the suite's conftest.py imports JAX, so run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import monetdb_tpu_torch as T
from monetdb_tpu_torch.bench import tpch_oracle
from monetdb_tpu_torch.ops import calc as TC
from monetdb_tpu_torch.ops import cuda_kernels as CK


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sid_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("n", [0, 1, 1000, 1 << 23, 6_001_215])
@pytest.mark.parametrize("domain", [1, 12, 32, 128])
def test_seg_sum64_kernel_vs_plain(cuda_device, n, domain, sid_dtype):
    """Exact equality at the engine's widths, ragged tails and tiny
    inputs, with excluded ids on both sides of [0, domain)."""
    g = torch.Generator(device=cuda_device).manual_seed(domain + n)
    sid = torch.randint(-1, domain + 2, (n,), generator=g,
                        device=cuda_device, dtype=sid_dtype)
    vals = torch.randint(-(1 << 45), 1 << 45, (n,), generator=g,
                         device=cuda_device, dtype=torch.int64)
    before = CK.LAUNCHES["seg_sum64"]
    ks, kc = CK.seg_sum64(sid, vals, domain=domain)
    ps, pc = CK.seg_sum64_plain(sid, vals, domain=domain)
    torch.cuda.synchronize()
    assert CK.LAUNCHES["seg_sum64"] == before + 1
    assert torch.equal(ks, ps) and torch.equal(kc, pc)


@pytest.mark.cuda
def test_seg_sum64_kernel_rejects_bad_input(cuda_device):
    sid = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    vals = torch.ones(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        CK.seg_sum64(sid, vals, domain=129)
    with pytest.raises(TypeError):
        CK.seg_sum64(sid.float(), vals, domain=4)
    with pytest.raises(ValueError):
        CK.seg_sum64(sid[::2], vals[::2], domain=4)
    with pytest.raises(ValueError):
        CK.seg_sum64(sid, vals.cpu(), domain=4)


def _fused_inputs(n, dev, seed):
    """Six int32 columns in the reference micro-benchmark's ranges, with
    codes from -1 to 13 (so every domain below excludes some)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def col(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)
    return (col(-1, 14), col(8035, 10561), col(100, 5100),
            col(9000, 2_000_000), col(0, 11), col(0, 9)), 10471


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1003, 6_001_215])
@pytest.mark.parametrize("domain", [1, 6, 8, 13, 128])
def test_q1_grouped_sums_kernel_vs_plain(cuda_device, n, domain):
    """Exact equality for small and wide domains, ragged lengths and an
    unaligned view (which takes the kernel's scalar loop)."""
    cols, cutoff = _fused_inputs(n + 1, cuda_device, n + domain)
    for view in (tuple(c[:n] for c in cols), tuple(c[1:] for c in cols)):
        before = CK.LAUNCHES["q1_grouped_sums"]
        got = CK.q1_grouped_sums(*view, cutoff, domain=domain)
        want = CK.q1_grouped_sums_plain(*view, cutoff, domain=domain)
        torch.cuda.synchronize()
        assert CK.LAUNCHES["q1_grouped_sums"] == before + 1
        assert len(got) == 6
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1003, 6_001_215])
@pytest.mark.parametrize("domain", [1, 8, 13, 128])
def test_grouped_sum_limbs_kernel_vs_plain(cuda_device, n, domain):
    cols, cutoff = _fused_inputs(n + 1, cuda_device, n + domain)
    code, ship, _qty, extp = cols[:4]
    extp = extp - 1_000_000                  # negative values too
    mask = ship <= cutoff
    for lo in (0, 1):                        # 1: unaligned views
        c, v, m = code[lo:lo + n], extp[lo:lo + n], mask[lo:lo + n]
        before = CK.LAUNCHES["grouped_sum_limbs"]
        got = CK.grouped_sum_limbs(c, v, m, domain=domain)
        want = CK.grouped_sum_limbs_plain(c, v, m, domain=domain)
        torch.cuda.synchronize()
        assert CK.LAUNCHES["grouped_sum_limbs"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_fused_kernels_reject_bad_input(cuda_device):
    cols, cutoff = _fused_inputs(64, cuda_device, 0)
    with pytest.raises(ValueError):
        CK.q1_grouped_sums(*cols, cutoff, domain=129)
    with pytest.raises(TypeError):
        CK.q1_grouped_sums(cols[0].long(), *cols[1:], cutoff)
    with pytest.raises(ValueError):
        CK.q1_grouped_sums(cols[0][::2], *cols[1:], cutoff)
    with pytest.raises(ValueError):
        CK.q1_grouped_sums(cols[0].cpu(), *cols[1:], cutoff)
    with pytest.raises(ValueError):
        CK.q1_grouped_sums(*cols, 1 << 31)
    mask = cols[1] <= cutoff
    with pytest.raises(TypeError):
        CK.grouped_sum_limbs(cols[0], cols[3], mask.to(torch.uint8),
                             domain=8)
    with pytest.raises(ValueError):
        CK.grouped_sum_limbs(cols[0], cols[3], mask[:-1], domain=8)
    with pytest.raises(ValueError):
        CK.grouped_sum_limbs(cols[0], cols[3], mask, domain=0)


@pytest.fixture(scope="module")
def engines_by_sf():
    """sf -> (generated data, engine on the card, engine on the CPU)."""
    from monetdb_tpu_torch.bench.tpch_gen import gen_tpch
    from monetdb_tpu_torch.bench.tpch_load import load_tables
    from monetdb_tpu_torch.engine import Engine
    made = {}

    def get(sf):
        if sf not in made:
            data = gen_tpch(sf)
            made[sf] = (data,
                        Engine(load_tables(data, device=torch.device("cuda"))),
                        Engine(load_tables(data, device="cpu")))
        return made[sf]
    return get


@pytest.mark.cuda
@pytest.mark.parametrize("q", range(1, 23))
@pytest.mark.parametrize("sf", [0.01, 0.1])
def test_engine_on_gpu_matches_cpu_and_oracle(cuda_device, engines_by_sf,
                                              sf, q):
    """TPC-H at SF0.01 and SF0.1 on the card: the rows equal the port's
    own CPU run (same ops, plain seg_sum64) and the numpy oracle, and the
    queries with a one-hot integer sum launch the kernel.  Exact but for
    the floats: torch's CPU kernel divides by a scalar as a multiply by
    its reciprocal, the CUDA kernel divides, and float sums add in
    another order."""
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    data, gpu, cpu = engines_by_sf(sf)
    before = CK.LAUNCHES["seg_sum64"]
    got = list(gpu.query(QUERIES[q]).rows)
    if q in (1, 4, 5, 6, 19):
        assert CK.LAUNCHES["seg_sum64"] > before
    assert got
    assert tpch_oracle.rows_differ(
        got, list(cpu.query(QUERIES[q]).rows), 1e-12) is None
    want = tpch_oracle.decoded(q, tpch_oracle.ORACLES[q](data))
    assert tpch_oracle.rows_differ(got, want, 1e-12) is None
    # a warm run (shrunk buckets, possibly another group-by strategy)
    assert list(gpu.query(QUERIES[q]).rows) == got


# ---------------------------------------------------------------------------
# synthetic tables and statements for the nodes of slices C and D.  They
# live here, in the file that imports no JAX, so that the GPU run can hold
# the card to the CPU on them; tests/test_torch_engine_cd.py holds the CPU
# to the reference engine on the same ones.
# ---------------------------------------------------------------------------

_NIL32 = int(np.iinfo(np.int32).min)
_NIL64 = int(np.iinfo(np.int64).min)
_BIG = 1 << 62


def expr_table():
    """t(id, a, b bigint with nils, values near 2^62 and zeros; k in
    [0, 4); d dates from year 874 to 2022 with a nil; x, y floats with
    NaN (nil), zeros and 1e300)."""
    n = 12
    a = np.array([1, _BIG, -_BIG, 7, _NIL64, 0, 5, 9, _BIG, 3, 2, 8], np.int64)
    b = np.array([2, _BIG, _BIG + 5, 0, 3, 0, _NIL64, -1, 1, 3, 0, 4],
                 np.int64)
    d = np.array([-400000, -366, -365, -1, 0, 1, 58, 59, 10957, 11016,
                  _NIL32, 19000], np.int32)
    x = np.array([1.5, 0.0, -2.0, np.nan, 4.0, 0.0, 7.5, 1e300, 3.0, -0.0,
                  2.0, 9.0])
    y = np.array([0.0, 2.0, 0.5, 1.0, np.nan, 3.0, 0.0, 1e300, 3.0, 1.0,
                  2.0, 0.0])
    return {"t": {
        "id": (np.arange(n, dtype=np.int32), "I32", {}),
        "a": (a, "I64", {}), "b": (b, "I64", {}),
        "k": (np.arange(n, dtype=np.int32) % 4, "I32",
              {"minval": 0, "maxval": 3}),
        "d": (d, "DATE", {}), "x": (x, "F64", {}), "y": (y, "F64", {}),
        "f": (np.arange(n) % 3 == 0, "BOOL", {})}}


_SMALL = "a < 1000 and a > -1000"      # keeps a / b and a % b in range



CASE_SQL = [
    # overflow and division by zero in a branch no row takes
    "select id, case when k = 9 then a + b else a end from t order by id",
    f"select id, case when b = 0 then 0 else a / b end from t where {_SMALL} "
    "order by id",
    f"select id, case when b <> 0 then a / b else -1 end from t "
    f"where {_SMALL} order by id",
    # nested: the inner division is guarded by both levels
    f"select id, case when k < 2 then case when b = 0 then -1 else a / b end "
    f"when k = 2 then 5 else a % b end from t "
    f"where {_SMALL} and (k < 3 or b <> 0) order by id",
    # string and decimal branches, a nil branch
    "select id, case when a > 5 then 'hi' when a is null then 'none' "
    "else 'lo' end, case when b is null then null else 1.5 end from t "
    "order by id",
    # COALESCE evaluates its fallback only where the first value is nil
    "select id, coalesce(b, 100 / (k - k)) from t where b is not null "
    "order by id",
]

#: statements whose error lies in a branch that some row takes
ERROR_SQL = [
    ("select id, case when k = 1 then a + b else a end from t",
     TC.CalcOverflow),
    (f"select id, case when b = 0 then a / b else 0 end from t "
     f"where {_SMALL}", TC.CalcDivZero),
    (f"select id, case when k < 2 then case when b = 0 then -1 else a / b "
     f"end else a % b end from t where {_SMALL}", TC.CalcDivZero),
    ("select id, coalesce(b, 100 / (k - k)) from t", TC.CalcDivZero),
    ("select id, x / y from t", TC.CalcDivZero),
    ("select id, cast(a as int) from t", TC.CalcOverflow),
]

EXPR_SQL = [
    "select id, extract(year from d), extract(month from d), "
    "extract(day from d), extract(quarter from d) from t order by id",
    "select id, year(d), dayofweek(d), dayofyear(d), weekofyear(d), "
    "extract(century from d), extract(decade from d), "
    "extract(epoch from d) from t order by id",
    "select y, count(*) from (select extract(year from d) as y from t) as s "
    "group by y order by y",
    # float division: nil operands, a guarded zero divisor
    "select id, x / y from t where y <> 0 or y is null order by id",
    f"select id, x + y, x - y, x * y, x * 2, a * 1.5, a / 4.0 from t "
    f"where {_SMALL} order by id",
    # NOT, IS [NOT] NULL, IN lists, a bare boolean column
    "select id from t where not (k = 1 or a > 5) order by id",
    "select id from t where a is null or x is null order by id",
    "select id from t where a is not null and y is not null order by id",
    "select id from t where k in (1, 3) order by id",
    "select id from t where k not in (1, 3) order by id",
    "select id from t where a in (1, 7, 5, 100) order by id",
    "select id from t where a not in (1, 7, 5, 100) order by id",
    "select id from t where f order by id",
    "select id from t where not f order by id",
    # predicates as values
    "select id, a > 3, x < 2 and k = 1, a is null from t order by id",
    # the rest of the single-device IR
    "select id, cast(k as smallint), cast(x as bigint), cast(k as double), "
    "cast(x as decimal(10,2)) from t where x < 100 or x is null order by id",
    "select id, cast(cast(y as decimal(10,2)) as int), "
    "cast(cast(y as decimal(10,2)) as double) from t where y < 100 or "
    "y is null order by id",
    "select id, coalesce(b, -1), coalesce(x, 0.5), coalesce(b, a, 3) from t "
    "order by id",
    "select id, nullif(a, 7), nullif(k, 2) from t order by id",
    "select id, -b, abs(b), -x, abs(-x) from t where b > -1000 or "
    "b is null order by id",
    "select id, sqrt(y), ln(y + 1), log10(y + 1), exp(k), sin(y), cos(y), "
    "tan(k), floor(x), ceil(x), ceiling(k / 3.0) from t where x < 100 or "
    "x is null order by id",
    "select id, power(k, 2), power(y, 0.5), power(2, k) from t "
    "where y < 100 or y is null order by id",
]

#: (statement over expr_table, a node the baked value leads to)
SUBQUERY_SQL = [
    # empty result
    ("select id from t where a > (select b from t where k > 100) "
     "order by id", "pfalse"),
    ("select id, (select b from t where k > 100) from t order by id", "nil"),
    # one nil row
    ("select id from t where a > (select max(b) from t where k > 100) "
     "order by id", "pfalse"),
    ("select id from t where a > (select min(a) from t where a is null) "
     "order by id", "pfalse"),
    ("select id, (select avg(x) from t where x is null) from t order by id",
     "nil"),
    # integer, float and decimal values
    ("select id from t where k > (select count(*) from t where k > 100) "
     "order by id", "rangesel"),
    ("select id from t where k = (select min(k) + 1 from t) order by id",
     "rangesel"),
    ("select id from t where x > (select avg(y) from t where y < 100) "
     "order by id", "cmp"),
    ("select id from t where k > (select avg(k) * 0.5 from t) order by id",
     "cmp"),
    ("select id from t where b < (select sum(k) * 1.5 from t) order by id",
     "rangesel"),
    # a bare wide sum, and a string
    ("select id from t where b < (select sum(k) from t) order by id",
     "rangesel"),
]


def agg_table():
    """4000 rows; g: 6 slots (one-hot), h: 500 slots (scatter), u: no
    statistics (sort group-by); v with nils, w multiples of 2^40 (sums
    beyond int64's half), x floats with NaN; group g = 5 holds only nils;
    c a decimal(15,2) copy of w."""
    rng = np.random.default_rng(17)
    n = 4000
    g = rng.integers(0, 6, n).astype(np.int32)
    h = rng.integers(0, 500, n).astype(np.int32)
    u = rng.integers(-30, 30, n).astype(np.int64)
    v = rng.integers(0, 40, n).astype(np.int64)
    v[rng.random(n) < 0.1] = _NIL64
    w = (rng.integers(1, 50, n) * (1 << 40)).astype(np.int64)
    w[rng.random(n) < 0.1] = _NIL64
    x = np.round(rng.random(n) * 20) / 4
    x[rng.random(n) < 0.1] = np.nan
    v[g == 5] = _NIL64
    x[g == 5] = np.nan
    s = [None if rng.random() < 0.1
         else ["ab", "cd", "ef", "gh"][rng.integers(4)] for _ in range(n)]
    return {"t": {
        "id": (np.arange(n, dtype=np.int32), "I32", {}),
        "g": (g, "I32", {"minval": 0, "maxval": 6}),
        "h": (h, "I32", {"minval": 0, "maxval": 499}),
        "u": (u, "I64", {}), "v": (v, "I64", {}), "w": (w, "I64", {}),
        "c": (w, ("decimal", 15, 2), {}),
        "x": (x, "F64", {}), "s": (s, "str", {})}}


AGG_SQL = [
    "select g, count(distinct v), sum(distinct v), avg(distinct v), "
    "count(distinct x), avg(distinct x), sum(distinct x), "
    "count(distinct s) from t group by g order by g",
    "select h, count(distinct v), sum(distinct v), avg(distinct v), "
    "count(distinct s) from t group by h order by h",
    "select u, count(distinct v), sum(distinct v), avg(distinct x), "
    "min(distinct v), max(distinct x) from t group by u order by u",
    "select count(distinct v), sum(distinct v), avg(distinct v) from t",
    "select count(distinct v), sum(distinct c) from t where v > 1000",
    # wide (lo, hi) distinct sums over a decimal, shown whole and ordered
    "select g, sum(distinct c), sum(distinct w) from t group by g order by g",
    "select g, sum(distinct c) as sc from t group by g order by sc desc, g",
    "select u, sum(distinct c) from t group by u order by u",
    "select g, avg(distinct c) from t group by g order by g",
    # moments, with an all-nil group and an empty input
    "select g, stddev_samp(v), stddev_pop(v), var_samp(v), var_pop(v), "
    "stddev_samp(x), var_pop(x), var_pop(c) from t group by g order by g",
    "select h, stddev_samp(v), var_pop(x) from t group by h order by h",
    "select u, stddev_pop(v), var_samp(x) from t where v < 3 group by u "
    "order by u",
    "select stddev_samp(v), var_pop(v) from t where v > 1000",
    "select g, prod(v) from t where v < 4 and v > 0 and id < 200 group by g "
    "order by g",
    # DISTINCT rows: dict codes, integers, floats with a nil
    "select distinct g, s from t order by g, s",
    "select distinct u from t where u > 0 order by u",
    "select distinct x from t order by x",
]


def dup_tables():
    """300 probe rows and 300 build rows over 3-4 key values with nils:
    ~17,000 matching pairs, far above the first expansion capacity."""
    rng = np.random.default_rng(5)
    pk = rng.integers(0, 4, 300).astype(np.int32)
    pk[rng.random(300) < 0.1] = _NIL32
    bk = rng.integers(0, 3, 300).astype(np.int32)
    bk[rng.random(300) < 0.1] = _NIL32
    st = {"minval": 0, "maxval": 3}
    return {"p": {"id": (np.arange(300, dtype=np.int32), "I32", {}),
                  "x": (pk, "I32", dict(st)),
                  "v": (rng.integers(0, 100, 300).astype(np.int64), "I64",
                        {})},
            "b": {"bid": (np.arange(300, dtype=np.int32), "I32", {}),
                  "x": (bk, "I32", dict(st)),
                  "w": (rng.integers(0, 100, 300).astype(np.int64), "I64",
                        {})}}


JOIN_EXPAND_SQL = [
    "select p.id, b.bid from p, b where p.x = b.x order by p.id, b.bid",
    "select p.id, b.bid from p, b where p.x = b.x and p.v < b.w "
    "order by p.id, b.bid",
    "select p.id, b.bid from p, b where p.x = b.x and b.w > 50 "
    "order by p.id, b.bid",
    "select p.id, b.bid from p left join b on p.x = b.x "
    "order by p.id, b.bid",
    # (the build-side filter leaves 1,820 pairs: no overflow here)
    "select p.id, b.bid from p left join b on p.x = b.x and b.w > 90 "
    "order by p.id, b.bid",
    "select p.id from p where exists (select * from b where b.x = p.x "
    "and b.w > p.v) order by p.id",
    "select p.id from p where not exists (select * from b where b.x = p.x "
    "and b.w > p.v) order by p.id",
    "select p.id, count(b.bid), sum(b.w) from p left join b on p.x = b.x "
    "group by p.id order by p.id",
    "select count(*) from p, b where p.x = b.x",
]


def dict_codes(arr):
    """A sequence of str (None = nil) as (int32 codes into the sorted
    distinct values, those values)."""
    isnil = np.array([v is None for v in arr])
    vals = np.array(["" if v is None else v for v in arr])
    uniq = np.unique(vals[~isnil])
    codes = np.where(isnil, _NIL32, np.searchsorted(uniq, vals))
    return codes.astype(np.int32), uniq


def torch_catalog(tables, device):
    """{table: {column: (array, type, props)}} as a catalog of the port on
    ``device``; a type is "str" (array of str, None = nil), a name in
    monetdb_tpu_torch.dtypes, or ("decimal", precision, scale)."""
    cat = T.Catalog()
    for name, cols in tables.items():
        tcols = {}
        for cn, (arr, kind, props) in cols.items():
            if kind == "str":
                codes, uniq = dict_codes(arr)
                tcols[cn] = T.Column.from_numpy(
                    codes, T.varchar(), sdict=T.StrDict(uniq), device=device,
                    **props)
            else:
                typ = T.dtypes.decimal(*kind[1:]) if isinstance(kind, tuple) \
                    else getattr(T.dtypes, kind)
                tcols[cn] = T.Column.from_numpy(arr, typ, device=device,
                                                **props)
        cat.add(T.Table.from_dict(name, tcols))
    return cat


_SYNTHETIC = ([(expr_table, sql) for sql in CASE_SQL + EXPR_SQL]
              + [(expr_table, sql) for sql, _node in SUBQUERY_SQL]
              + [(agg_table, sql) for sql in AGG_SQL]
              + [(dup_tables, sql) for sql in JOIN_EXPAND_SQL])


@pytest.mark.cuda
@pytest.mark.parametrize("tables,sql", _SYNTHETIC)
def test_synthetic_on_gpu_matches_cpu(cuda_device, tables, sql):
    """The statements of slices C and D on a CUDA catalog give the rows
    of the same catalog on the CPU, cold and warm (floats rel 1e-12)."""
    from monetdb_tpu_torch.engine import Engine
    gpu = Engine(torch_catalog(tables(), cuda_device))
    cpu = Engine(torch_catalog(tables(), "cpu"))
    want = list(cpu.query(sql).rows)
    for _ in range(2):
        assert tpch_oracle.rows_differ(list(gpu.query(sql).rows), want,
                                       1e-12) is None


@pytest.mark.cuda
@pytest.mark.parametrize("sql,err", ERROR_SQL)
def test_synthetic_errors_on_gpu(cuda_device, sql, err):
    from monetdb_tpu_torch.engine import Engine
    gpu = Engine(torch_catalog(expr_table(), cuda_device))
    cpu = Engine(torch_catalog(expr_table(), "cpu"))
    with pytest.raises(err) as want:
        cpu.query(sql)
    with pytest.raises(err) as got:
        gpu.query(sql)
    assert str(got.value) == str(want.value)


@pytest.mark.cuda
def test_load_tpch_defaults_to_the_card(cuda_device):
    from monetdb_tpu_torch.bench.tpch_load import load_tpch
    cat = load_tpch(0.01, cache=False)
    assert all(c.data.is_cuda for t in cat.tables.values()
               for c in t.columns.values())
