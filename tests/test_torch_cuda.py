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

import torch_session_scripts as S


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


# ---------------------------------------------------------------------------
# slice E: the operator library, the window functions and the op-at-a-time
# executor on the card against the port's own CPU run.  The statements live
# here (no JAX in this file); tests/test_torch_executor.py and
# tests/test_torch_window.py hold the CPU to the reference on them.
# ---------------------------------------------------------------------------

def exec_tables():
    """agg_table's t (4000 rows: g, h, u, v, w, c, x, s with nils) plus
    r(k, s, n): 9 rows with a nil key, a nil string and digit strings."""
    tables = dict(agg_table())
    tables["r"] = {
        "k": (np.array([0, 1, 2, 3, 3, _NIL64, 7, 40, 41], np.int64), "I64",
              {}),
        "s": (["ab", "cd", None, "ab", "zz", "ef", "gh", "ab", "cd"], "str",
              {}),
        "n": (["12", "-7", "300", None, "12", "0", "45", "8", "9"], "str",
              {})}
    return tables


EXECUTOR_SQL = [
    # casts between strings and values, both ways
    "select id, cast(u as varchar(10)) as us from t where id < 40 "
    "order by id",
    "select cast(n as integer) as ni, cast(n as bigint) + 1 as n1 from r "
    "order by k",
    "select cast(n as decimal(8,2)) as nd, cast(n as double) as nf from r "
    "order by k",
    "select cast(x as varchar(20)) as xs, cast(c as varchar(30)) as cs "
    "from t where id < 25 order by id",
    "select cast(cast(u as varchar(8)) as integer) as back from t "
    "where id < 30 order by id",
    # string concatenation
    "select id, s || '-' || s as ss, 'p:' || s as ps from t where id < 50 "
    "order by id",
    "select k, s || n as sn from r order by k",
    # set operations
    "select g from t union select k from r order by g",
    "select g from t where id < 30 union all select k from r order by g",
    "select u from t intersect select k from r order by u",
    "select k from r except select u from t order by k",
    "select g from t where id < 40 except all select k from r order by g",
    "select k from r intersect all select g from t order by k",
    "select s from t union select s from r order by s",
    # VALUES, generate_series, SAMPLE, LIMIT/OFFSET
    "select * from (values (1, 'a'), (2, 'b'), (3, null)) as v(i, s) "
    "order by i",
    "select value, value * value as sq from generate_series(3, 40, 4) "
    "order by value",
    "select id, u from t sample 25 seed 7",
    "select id, u from t order by u, id limit 15 offset 20",
    "select id from t limit 7 offset 3990",
    "select u, count(*) as n from t group by u order by u limit 5",
    # IN / NOT IN / EXISTS subqueries, nils on either side
    "select id, v from t where v in (select k from r) and id < 400 "
    "order by id",
    "select id, v from t where v not in (select k from r where k is not "
    "null) and id < 300 order by id",
    "select id from t where v not in (select k from r) and id < 300 "
    "order by id",
    "select id, v in (select k from r) as m from t where id < 120 "
    "order by id",
    "select id, v not in (select k from r where k < 5) as m from t "
    "where id < 120 order by id",
    "select k from r where exists (select 1 from t where t.u = r.k) "
    "order by k",
    "select k from r where not exists (select 1 from t where t.g = r.k) "
    "order by k",
    # quantiles and moments
    "select g, quantile(v, 0.25) as q1, median(v) as med from t group by g "
    "order by g",
    "select g, stddev_samp(x) as sd, stddev_pop(x) as sp, var_samp(v) as "
    "vs, var_pop(v) as vp from t group by g order by g",
    "select h, corr(x, v) as r, covar_samp(x, v) as cs, covar_pop(x, v) as "
    "cp from t where h < 12 group by h order by h",
    "select median(c) as mc, quantile(x, 0.9) as qx from t",
    "select g, group_concat(s) as ss from t where id < 60 group by g "
    "order by g",
    "select g, group_concat(s, '|') as ss, listagg(s, ';') as ls from t "
    "where id < 40 group by g order by g",
    "select g, count(distinct s) as ds, sum(distinct v) as sv, "
    "avg(distinct v) as av, prod(g + 1) as p from t where id < 50 "
    "group by g order by g",
    # greatest / least, CASE and COALESCE over strings
    "select id, greatest(u, v) as gr, least(u, v, g) as le from t "
    "where id < 60 order by id",
    "select id, greatest(s, 'cd') as gs, least(s, 'cd') as ls from t "
    "where id < 60 order by id",
    "select id, case when g < 2 then s when g < 4 then 'mid' else "
    "cast(u as varchar(8)) end as c from t where id < 80 order by id",
    "select id, coalesce(s, 'none') as cs, nullif(s, 'ab') as ns from t "
    "where id < 80 order by id",
    "select k, coalesce(s, n, '?') as c from r order by k",
    # a cross join, outer joins and a join with a residual
    "select r.k, t.id from r, t where t.id < 3 order by r.k, t.id",
    "select r.k, t.id from r left join t on t.u = r.k and t.id < 200 "
    "order by r.k, t.id",
    "select r.k, t.id from t right join r on t.u = r.k and t.id < 100 "
    "order by r.k, t.id",
    "select r.k, q.g from r full join (select distinct g from t) q "
    "on q.g = r.k order by r.k, q.g",
    "select r.k, count(*) as n from r join t on t.g = r.k and t.u > r.k "
    "group by r.k order by r.k",
    # string and date functions, rounding, math
    "select id, upper(s) as us, length(s) as ls, substring(s, 2, 1) as s2, "
    "replace(s, 'a', 'xy') as rs, lpad(s, 4, '*') as lp from t "
    "where id < 40 order by id",
    "select id, s like 'a%' as la, locate('b', s) as lb, "
    "startswith(s, 'c') as sc from t where id < 40 order by id",
    "select id, round(x, 1) as r1, round(c, 1) as rc, truncate(c, 0) as tc, "
    "floor(x) as fx, sqrt(x) as sx, power(x, 2) as px from t "
    "where id < 40 order by id",
    "select id, u % 7 as m, u / 7 as d, -u as nu, abs(u) as au from t "
    "where id < 60 order by id",
    "select distinct g, s from t order by g, s",
    "select count(*) as n, sum(v) as sv, min(s) as ms, max(x) as mx, "
    "avg(c) as ac from t where id < 0",
]


DATE_SQL = [
    "select l_orderkey, l_shipdate + interval '1' month as m, "
    "l_shipdate - interval '40' day as d, extract(dow from l_shipdate) as "
    "w, year(l_commitdate) as y from lineitem where l_orderkey < 40 "
    "order by l_orderkey, l_linenumber",
    "select o_orderkey, date_trunc('month', o_orderdate) as mo, "
    "cast(o_orderdate as varchar(10)) as ds, "
    "cast(cast(o_orderdate as varchar(10)) as date) as back from orders "
    "where o_orderkey < 100 order by o_orderkey",
    "select o_orderkey, date_to_str(o_orderdate, '%Y/%m/%d') as s, "
    "str_to_date(cast(o_orderdate as varchar(10)), '%Y-%m-%d') as d "
    "from orders where o_orderkey < 60 order by o_orderkey",
]


MORE_WINDOW_SQL = [
    # a window over an aggregate, filtered and aggregated outside (the
    # shape of TPC-DS Q89)
    """select n, count(*) as c, sum(dev) as s from (
         select l_orderkey, sum(l_quantity) as q,
                avg(sum(l_quantity)) over (partition by l_orderkey % 7) as a,
                sum(l_quantity) - min(sum(l_quantity))
                    over (partition by l_orderkey % 7) as dev,
                l_orderkey % 7 as n
         from lineitem group by l_orderkey) t
       where q > a group by n order by n""",
    # no PARTITION BY, no ORDER BY of its own: rows surface in the
    # window's order
    """select s_suppkey, sum(s_acctbal) over (order by s_suppkey) as run
       from supplier""",
    """select o_custkey, o_orderkey,
              nth_value(o_totalprice, 2) over (partition by o_custkey
                                               order by o_orderdate) as n2,
              last_value(o_orderkey) over (partition by o_custkey) as lv,
              lag(o_orderdate, 2) over (partition by o_custkey
                                        order by o_orderdate) as d2
       from orders where o_custkey < 200 order by o_custkey, o_orderkey""",
    """select l_orderkey, l_linenumber,
              max(l_extendedprice) over (partition by l_orderkey
                  order by l_linenumber rows between 1 preceding
                  and 1 following) as m3,
              min(l_quantity) over (partition by l_orderkey
                  order by l_linenumber range between 2 preceding
                  and current row) as lo,
              sum(l_extendedprice) over (partition by l_orderkey
                  order by l_shipdate desc range between 30 preceding
                  and 30 following) as near,
              count(*) over (partition by l_orderkey order by l_linenumber
                  groups between 1 preceding and 1 following) as g
       from lineitem where l_orderkey < 600
       order by l_orderkey, l_linenumber""",
]



def window_inputs(seed, n, nparts, norder):
    """n rows sorted by (partition, order) as numpy arrays: partition ids,
    order keys (with peers), int64 values with nils, floats with NaN."""
    rng = np.random.default_rng(seed)
    part = np.sort(rng.integers(0, nparts, n)).astype(np.int64)
    order = rng.integers(0, norder, n).astype(np.int64)
    idx = np.lexsort((order, part))
    v = rng.integers(-100, 100, n).astype(np.int64)
    v[rng.random(n) < 0.15] = _NIL64
    x = np.round(rng.normal(0, 50, n), 2)
    x[rng.random(n) < 0.15] = np.nan
    return part[idx], order[idx], v, x


def _columns_on(dev, seed=31, n=5000):
    part, order, v, x = window_inputs(seed, n, 60, 9)
    rng = np.random.default_rng(seed + 1)

    def col(arr, typ, **props):
        return T.Column.from_numpy(arr, typ, device=dev, **props)
    return {
        "n": n, "part": col(part, T.I64), "order": col(order, T.I64),
        "v": col(v, T.I64), "x": col(x, T.F64),
        "d": col(v, T.dtypes.decimal(12, 2)),
        "k": col(rng.integers(0, 40, n).astype(np.int64), T.I64,
                 minval=0, maxval=39),
        "u": col(rng.integers(-30, 30, n).astype(np.int64), T.I64),
        "w": col(rng.integers(-9, 10, n).astype(np.int64), T.I64),
        "s": T.Column.from_strings(
            list(rng.choice(["ab", "cd", "ef", "gh"], n)), device=dev),
        "date": col(rng.integers(-20000, 20000, n).astype(np.int32),
                    T.DATE),
        "r": col(rng.integers(10, 70, 1500).astype(np.int64), T.I64),
    }


def _flat(out):
    """Every tensor in a result (Column, Cand, GroupResult, tuple, ...);
    a host scalar (a count) stays as it is."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, T.Column):
        return [out.data]
    if isinstance(out, T.Cand):
        return [t for t in (out.mask, out.oids) if t is not None]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    if hasattr(out, "ids"):
        return [t for t in (out.ids, out.extents, out.histo)
                if t is not None]
    return [out]


def _op_cases():
    from monetdb_tpu_torch.ops import aggr, calc, datecalc, group, join, \
        project, select, sort, strfuncs, window
    c = {}
    c["select"] = lambda m: [select.select(m["v"], tl=-10, th=30),
                             select.thetaselect(m["x"], None, 1.5, "<"),
                             select.select(m["v"], tl=5, th=None, anti=True)]
    c["materialize_project"] = lambda m: [
        project.project(select.thetaselect(m["u"], None, 0, ">"), m["x"]),
        select.materialize(T.Cand.dense(m["n"], 10, 900), m["v"].cap,
                           m["v"].data.device).oids]
    for op in ("add", "sub", "mul", "div", "mod", "min", "max"):
        c[f"binop_{op}"] = lambda m, op=op: [
            calc.binop(op, m["v"], m["w"] if op not in ("div", "mod")
                       else calc.binop("add", calc.binop("mul", m["w"],
                                                         m["w"]), 1)),
            calc.binop(op, m["x"], 3.5)]
    c["convert"] = lambda m: [
        calc.convert(m["x"], T.I64), calc.convert(m["d"], T.F64),
        calc.convert(m["d"], T.dtypes.decimal(12, 1), scale_down=1),
        calc.convert(m["v"], T.dtypes.decimal(14, 2), scale_up=2)]
    c["compare_ifthenelse"] = lambda m: [
        calc.ifthenelse(calc.compare("<", m["v"], m["u"]), m["v"], m["u"],
                        T.I64), calc.isnil(m["x"]), calc.unop("neg", m["v"])]
    c["argsort"] = lambda m: list(sort.argsort(
        [m["k"], m["x"], m["s"]], [True, False, True], [None, True, False]))
    c["firstn_ties"] = lambda m: [sort.firstn([m["k"]], 77, [True])[0],
                                  sort.firstn([m["k"], m["u"]], 300)[0]]
    c["group"] = lambda m: [group.group_multi([m["k"], m["s"]]),
                            group.group_multi([m["u"], m["x"]]),
                            group.group(m["s"], T.Cand.dense(m["n"], 7, 7))]
    c["aggr_exact"] = lambda m: (lambda g: [
        aggr.group_sum(m["v"], g), aggr.group_sum(m["d"], g, False),
        aggr.group_count(m["x"], g), aggr.group_min(m["x"], g),
        aggr.group_max(m["s"], g), aggr.group_prod(m["w"], g),
        aggr.group_quantile(m["x"], g, 0.3), aggr.scalar_sum(m["v"]),
        aggr.scalar_count(None, base=m["v"])])(group.group(m["k"]))
    c["aggr_float"] = lambda m: (lambda g: [
        aggr.group_sum(m["x"], g), aggr.group_avg(m["v"], g)[0],
        aggr.group_var(m["x"], g), aggr.group_stdev(m["d"], g, False),
        aggr.group_corr(m["x"], m["v"], g),
        aggr.group_covar(m["x"], m["d"], g)])(group.group(m["k"]))
    c["join"] = lambda m: [
        join.join(m["u"], m["r"], how=how)[:2] for how in
        ("inner", "left", "outer")] + [
        join.semijoin(m["u"], m["r"])[0], join.antijoin(m["u"], m["r"])[0],
        join.markjoin(m["v"], m["r"])[:2],
        join.join(m["v"], m["v"], T.Cand.dense(m["n"], 0, 400),
                  T.Cand.dense(m["n"], 100, 300), nil_matches=True)[:2]]
    c["datecalc"] = lambda m: [
        datecalc.extract(f, m["date"]) for f in ("year", "month", "dow",
                                                 "week", "doy")] + [
        datecalc.add_interval_col(m["date"], -13, "month"),
        datecalc.add_interval_col(m["date"], 5, "hour"),
        datecalc.date_trunc("quarter", m["date"])]
    c["strfuncs"] = lambda m: [
        strfuncs.like_cand(m["s"], "%d"), strfuncs.upper(m["s"]),
        strfuncs.length(m["s"]), strfuncs.concat_cols(m["s"], m["s"])]

    def win(m):
        pb = window.diff(m["part"])
        ob = window.multi_boundary([m["order"]], m["n"])
        return pb, ob
    c["window_rank"] = lambda m: (lambda pb, ob: [
        window.row_number(pb), window.rank(pb, ob),
        window.dense_rank(pb, ob), window.percent_rank(pb, ob),
        window.cume_dist(pb, ob), window.ntile(pb, 4)])(*win(m))
    c["window_values"] = lambda m: (lambda pb, ob: [
        window.lag(m["v"], pb, 2), window.lead(m["x"], pb, 1),
        window.first_value(m["s"], pb), window.last_value(m["v"], pb),
        window.nth_value(m["d"], pb, 3),
        window.cume_window_sum(m["d"], pb)])(*win(m))
    for func in ("sum", "avg", "min", "max", "count"):
        c[f"windowed_{func}"] = lambda m, func=func: (lambda pb, ob: [
            window.windowed_agg(func, m[name], pb, ob, frame, m["n"])
            for name in ("v", "x") for frame in ("rows", "range", "full")
        ])(*win(m))
        c[f"framed_{func}"] = lambda m, func=func: (lambda pb, ob: [
            window.framed_agg(func, m[name], pb, m["order"].data, unit, lo,
                              hi, m["n"])
            for name in ("v", "x") for unit, lo, hi in (
                ("rows", -2, 1), ("rows", None, 3), ("range", -2, 2),
                ("range", 0, None), ("groups", -1, 1))])(*win(m))
    return c


#: float sums add in another order on the card (atomics), and what is
#: computed from them inherits it; everything else must be equal
_OPS_FLOAT_RTOL = {"aggr_float": 1e-9, "windowed_sum": 1e-9,
                   "windowed_avg": 1e-9, "framed_sum": 1e-9,
                   "framed_avg": 1e-9, "binop_div": 1e-15,
                   "convert": 1e-15}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_ops_on_gpu_match_cpu(cuda_device, name):
    """Each operator of ops/* and each window function on CUDA tensors
    against the same call on CPU tensors."""
    fn = _op_cases()[name]
    got = _flat(fn(_columns_on(cuda_device)))
    want = _flat(fn(_columns_on("cpu")))
    assert len(got) == len(want) and got
    rtol = _OPS_FLOAT_RTOL.get(name)
    for g, w in zip(got, want):
        if not isinstance(w, torch.Tensor):
            assert g == w, name
            continue
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        if w.dtype.is_floating_point and rtol is not None:
            assert torch.allclose(g.cpu(), w, rtol=rtol, atol=0,
                                  equal_nan=True), name
        elif w.dtype.is_floating_point:
            assert torch.equal(torch.nan_to_num(g.cpu(), nan=-7.25),
                               torch.nan_to_num(w, nan=-7.25)), name
        else:
            assert torch.equal(g.cpu(), w), name


@pytest.fixture
def executor_only():
    from monetdb_tpu_torch import config
    config.set("fragment_exec", False)
    yield
    config.reset("fragment_exec")


@pytest.mark.cuda
@pytest.mark.parametrize("q", range(1, 23))
def test_executor_on_gpu_matches_cpu_and_oracle(cuda_device, engines_by_sf,
                                                executor_only, q):
    """TPC-H at SF0.1 through the op-at-a-time executor on the card: the
    CPU executor's rows and the oracle's (floats rel 1e-9), no fragment
    run and no hand-written kernel launched."""
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    from monetdb_tpu_torch.exec import fragment
    data, gpu, cpu = engines_by_sf(0.1)
    runs0, launches0 = fragment.STATS["runs"], dict(CK.LAUNCHES)
    got = list(gpu.query(QUERIES[q]).rows)
    assert got and fragment.STATS["runs"] == runs0
    assert CK.LAUNCHES == launches0
    assert tpch_oracle.rows_differ(
        got, list(cpu.query(QUERIES[q]).rows), 1e-9) is None
    want = tpch_oracle.decoded(q, tpch_oracle.ORACLES[q](data))
    assert tpch_oracle.rows_differ(got, want, 1e-9) is None


@pytest.mark.cuda
@pytest.mark.parametrize("sql", EXECUTOR_SQL)
def test_executor_statements_on_gpu_match_cpu(cuda_device, executor_only,
                                              sql):
    from monetdb_tpu_torch.engine import Engine
    gpu = Engine(torch_catalog(exec_tables(), cuda_device))
    cpu = Engine(torch_catalog(exec_tables(), "cpu"))
    assert tpch_oracle.rows_differ(list(gpu.query(sql).rows),
                                   list(cpu.query(sql).rows), 1e-9) is None


@pytest.mark.cuda
@pytest.mark.parametrize("sql", DATE_SQL + MORE_WINDOW_SQL)
def test_window_and_date_sql_on_gpu_match_cpu(cuda_device, engines_by_sf,
                                              sql):
    """Window statements fall back to the executor on both devices."""
    from monetdb_tpu_torch.exec import fragment
    _data, gpu, cpu = engines_by_sf(0.01)
    falls0 = fragment.STATS["fallbacks"]
    got = list(gpu.query(sql).rows)
    if " over (" in sql:
        assert fragment.STATS["fallbacks"] == falls0 + 1
    assert got and tpch_oracle.rows_differ(
        got, list(cpu.query(sql).rows), 1e-9) is None


@pytest.mark.cuda
def test_tpcds_loader_defaults_to_the_card(cuda_device):
    from monetdb_tpu_torch.bench import ssbm, tpcds
    from monetdb_tpu_torch.engine import Engine
    from monetdb_tpu_torch.exec import fragment
    for mod, n in ((tpcds, 20_000), (ssbm, 20_000)):
        load = getattr(mod, "load_" + mod.__name__.rsplit(".", 1)[1])
        cat, _data = load(n)
        assert all(c.data.is_cuda for t in cat.tables.values()
                   for c in t.columns.values())
        cpu_cat, _ = load(n, device="cpu")
        gpu, cpu = Engine(cat), Engine(cpu_cat)
        for qid, sql in mod.QUERIES.items():
            falls0 = fragment.STATS["fallbacks"]
            assert tpch_oracle.rows_differ(
                list(gpu.query(sql).rows), list(cpu.query(sql).rows),
                1e-9) is None, (mod.__name__, qid)
            assert fragment.STATS["fallbacks"] - falls0 == \
                2 * (mod is tpcds and qid in ("53", "89", "98"))


# ---------------------------------------------------------------------------
# slice F: Session and storage on the card against the port's own CPU
# store.  The scripts live in tests/torch_session_scripts.py (no JAX);
# tests/test_torch_session.py holds the CPU to the reference on them.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_database_defaults_to_the_card(cuda_device):
    from monetdb_tpu_torch.session import Session
    from monetdb_tpu_torch.storage import Database
    db = Database()
    assert db.device.type == "cuda" and db.device.index is not None
    s = Session(db)
    s.sql("create table t (a int, s varchar(3))")
    s.sql("insert into t values (1, 'x'), (2, null)")
    assert s.sql("select sum(a), count(s) from t").rows == [(3, 1)]
    tbl, _oids = db.table("t")
    assert all(c.data.device == db.device for c in tbl.columns.values())
    env = dict(s.sql("select name, value from sys.env").rows)
    assert env["jax_backend"] == torch.cuda.get_device_name(db.device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(S.SCRIPTS))
def test_session_scripts_on_gpu_match_cpu(cuda_device, name, tmp_path):
    from monetdb_tpu_torch.session import Session
    from monetdb_tpu_torch.sql import binder
    from monetdb_tpu_torch.storage import Database
    out = {}
    for dev in ("cuda", "cpu"):
        (tmp_path / dev).mkdir()
        binder.Binder._auto_counter = 0
        out[dev] = S.run_script(lambda: Session(Database(device=dev)),
                                S.SCRIPTS[name], str(tmp_path / dev),
                                lambda s: Session(s.db))
    S.assert_outcomes_equal(out["cuda"], out["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("q", range(1, 23))
def test_session_tpch_on_gpu_matches_oracle(cuda_device, engines_by_sf, q):
    """The 22 queries through Session.sql over load_tpch_db(0.01) on the
    card: the numpy oracle's rows, no fallback."""
    from monetdb_tpu_torch.bench.tpch_load import load_tpch_db
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    from monetdb_tpu_torch.exec import fragment
    data = engines_by_sf(0.01)[0]
    s = _tpch_session(load_tpch_db, data)
    falls = fragment.STATS["fallbacks"]
    got = list(s.sql(QUERIES[q]).rows)
    want = tpch_oracle.decoded(q, tpch_oracle.ORACLES[q](data))
    assert tpch_oracle.rows_differ(got, want, 1e-12) is None
    assert list(s.sql(QUERIES[q]).rows) == got
    assert fragment.STATS["fallbacks"] == falls
    assert all(t.col(t.names()[0]).data.is_cuda
               for t in s.db.catalog().tables.values())


_TPCH_SESSION = {}


def _tpch_session(load_tpch_db, data):
    from monetdb_tpu_torch.session import Session
    if "s" not in _TPCH_SESSION:
        _TPCH_SESSION["s"] = Session(load_tpch_db(0.01, data))
    return _TPCH_SESSION["s"]


@pytest.mark.cuda
def test_durable_store_on_gpu(cuda_device, tmp_path):
    """Writes to a store on the card survive a close without checkpoint
    (WAL replay) and a checkpoint; a rolled-back transaction does not."""
    from monetdb_tpu_torch.session import Session
    from monetdb_tpu_torch.storage import Database
    path = str(tmp_path / "db")
    s = Session(Database(path))
    s.sql("create table t (a int, b varchar(4), c decimal(8,2))")
    s.sql("insert into t values (1, 'x', 1.25), (2, 'y', null)")
    s.sql("start transaction")
    s.sql("insert into t values (3, 'z', 9)")
    s.sql("rollback")
    s.sql("update t set c = 7.5 where a = 2")
    want = s.sql("select * from t order by a").rows
    s.db.close()
    db = Database(path)
    assert Session(db).sql("select * from t order by a").rows == want
    db.checkpoint()
    db.close()
    assert Session(Database(path)).sql(
        "select * from t order by a").rows == want
    assert Session(Database(path, device="cpu")).sql(
        "select * from t order by a").rows == want


@pytest.mark.cuda
def test_sqllogic_files_on_gpu(cuda_device):
    import glob
    import os
    from monetdb_tpu_torch.session import Session
    from monetdb_tpu_torch.storage import Database
    from monetdb_tpu_torch.testing import SqlLogicRunner
    files = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                          "sqllogic", "*.test")))
    assert len(files) == 6
    for f in files:
        assert SqlLogicRunner(Session(Database())).run_file(f) > 0


@pytest.mark.cuda
def test_server_on_gpu_matches_cpu(cuda_device):
    """A Server over a store on the card answers in JSON and columnar mode
    with the rows of the same statements over a store on the CPU; a failing
    statement leaves the connection (and the card) answering."""
    from monetdb_tpu_torch.server import Client, Server
    from monetdb_tpu_torch.storage import Database
    stmts = ["create table t (a int, b varchar(4), c decimal(8,2))",
             "insert into t values (1, 'x', 1.25), (2, 'y', null), "
             "(3, 'x', 4.5)"]
    q = "select b, count(*), sum(c) from t group by b order by b"
    out = {}
    for dev in ("cuda", "cpu"):
        srv = Server(Database(device=dev)).start()
        try:
            c = Client(*srv.address)
            for st in stmts:
                c.sql(st)
            with pytest.raises(RuntimeError):
                c.sql("select nope from t")
            out[dev] = (c.sql(q).rows, c.sql(q, columnar=True).rows)
            c.close()
        finally:
            srv.stop()
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0] == out["cuda"][1]


@pytest.mark.cuda
def test_farm_on_gpu(cuda_device, tmp_path):
    from monetdb_tpu_torch.farm import Farm
    from monetdb_tpu_torch.server import Client
    farm = Farm(str(tmp_path / "farm"))
    try:
        farm.create("db")
        host, port = farm.proxy_listen()
        c = Client(host, port, database="db")
        c.sql("create table t (a int)")
        c.sql("insert into t values (4), (5)")
        assert c.sql("select sum(a) from t").rows == [(9,)]
        assert farm.db("db").device.type == "cuda"
        c.close()
    finally:
        farm.stop_all()


@pytest.mark.cuda
def test_geom_on_gpu_matches_cpu(cuda_device):
    from monetdb_tpu_torch.session import Session
    from monetdb_tpu_torch.storage import Database
    rng = np.random.default_rng(3)
    xy = rng.uniform(-10, 10, (5000, 2))
    poly = ("POLYGON ((-8 -8, 8 -8, 8 8, -8 8, -8 -8), "
            "(-2 -2, 2 -2, 2 2, -2 2, -2 -2))")
    sqls = [f"select count(*) from p where st_contains('{poly}', g)",
            f"select id, st_distance(g, '{poly}') from p where id < 300 "
            "order by id",
            "select sum(st_distance_geographic(g, 'POINT (1 2)')) from p",
            "select sum(st_x(g)), sum(st_y(g)) from p"]
    out = {}
    for dev in ("cuda", "cpu"):
        s = Session(Database(device=dev))
        s.sql("create table p (id int, g varchar(60))")
        s.sql("insert into p values " + ", ".join(
            f"({i}, 'POINT ({x:.6f} {y:.6f})')" for i, (x, y) in
            enumerate(xy)))
        out[dev] = [s.sql(q).rows for q in sqls]
    assert out["cuda"][0] == out["cpu"][0]
    for g, w in zip(out["cuda"][1:], out["cpu"][1:]):
        for gr, wr in zip(g, w):
            assert gr == pytest.approx(wr, rel=1e-12)


@pytest.mark.cuda
def test_external_ops_on_gpu(cuda_device):
    from monetdb_tpu_torch.ops.external import (
        external_sort, streaming_cumsum, streaming_window_sum)
    rng = np.random.default_rng(9)
    arr = rng.integers(-10**15, 10**15, 1 << 20).astype(np.int64)
    ties = np.where(rng.random(1 << 20) < 0.9, 7,
                    rng.integers(0, 1000, 1 << 20)).astype(np.int64)
    assert np.array_equal(external_sort(arr.copy(), chunk_rows=1 << 17),
                          np.sort(arr))
    assert np.array_equal(external_sort(arr.copy(), chunk_rows=1 << 17,
                                        descending=True), np.sort(arr)[::-1])
    assert np.array_equal(external_sort(ties.copy(), chunk_rows=1 << 16),
                          np.sort(ties))
    small = arr // 1000
    assert np.array_equal(streaming_cumsum(small, chunk_rows=1 << 17),
                          np.cumsum(small))
    c = np.concatenate([[0], np.cumsum(small)])
    want = c[1:] - c[np.maximum(np.arange(len(small)) - 999, 0)]
    assert np.array_equal(streaming_window_sum(small, 1000,
                                               chunk_rows=1 << 17), want)


# ---------------------------------------------------------------------------
# the row mesh on the card: 8 shards of one GPU, one thread each
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_seg_sum64_launch_count_from_8_threads(cuda_device):
    """8 threads x N launches count exactly 8N, and every sum is right."""
    import threading
    n = 200
    sid = torch.arange(4096, device=cuda_device) % 12
    vals = torch.arange(4096, device=cuda_device, dtype=torch.int64)
    want = CK.seg_sum64_plain(sid, vals, domain=12)
    bad = []
    before = CK.LAUNCHES["seg_sum64"]

    def work():
        for _ in range(n):
            got = CK.seg_sum64(sid, vals, domain=12)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                bad.append(got)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    torch.cuda.synchronize()
    assert CK.LAUNCHES["seg_sum64"] - before == 8 * n and not bad


@pytest.mark.cuda
def test_sharded_q1_launches_the_kernel_once_per_shard(cuda_device):
    from monetdb_tpu_torch.parallel import row_mesh, shard_array, sharded_q1
    mesh = row_mesh([cuda_device] * 8)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    n = 100_003
    cols = [torch.randint(lo, hi, (n,), generator=g, device=cuda_device,
                          dtype=torch.int32)
            for lo, hi in ((-1, 8), (8000, 10600), (100, 5100),
                           (9000, 2_000_000), (0, 11), (0, 9))]
    before = CK.LAUNCHES["q1_grouped_sums"]
    got = sharded_q1(mesh)(*[shard_array(c, mesh, fill=-1 if i == 0 else 0)
                             for i, c in enumerate(cols)], 10_471)
    torch.cuda.synchronize()
    assert CK.LAUNCHES["q1_grouped_sums"] - before == 8
    want = CK.q1_grouped_sums_plain(*cols, 10_471, domain=8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 3, 6, 13, 18])
def test_mesh_engine_on_gpu_matches_cpu(cuda_device, q):
    """TPC-H on row_mesh([cuda] * 8) against the one-device CPU engine."""
    from monetdb_tpu_torch.bench.tpch_load import load_tpch
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    from monetdb_tpu_torch.engine import Engine
    from monetdb_tpu_torch.exec import fragment as TF
    from monetdb_tpu_torch.parallel import row_mesh
    mesh = row_mesh([cuda_device] * 8)
    s0 = TF.STATS["spmd_runs"]
    got = Engine(load_tpch(0.01, device=cuda_device),
                 mesh=mesh).query(QUERIES[q]).rows
    assert TF.STATS["spmd_runs"] > s0
    want = Engine(load_tpch(0.01, device="cpu")).query(QUERIES[q]).rows
    assert len(got) == len(want)
    for gr, wr in zip(got, want):
        for x, y in zip(gr, wr):
            assert x == (pytest.approx(y, rel=1e-9)
                         if isinstance(y, float) else y)


@pytest.mark.cuda
def test_hybrid_mesh_on_one_card(cuda_device):
    """Two processes of two shards each on cuda:0 (host-staged gloo
    between them, shards handed over by reference inside each): every
    shard of every primitive exact against numpy and bit-equal to shard g
    of row_mesh([cuda:0] * 4), with 6 seg_sum64 and 1 q1_grouped_sums
    launches a shard."""
    from monetdb_tpu_torch.bench import mesh_procs as MP
    res = MP.compare(["cuda:0"] * 4, "gloo", 16, 100_003, key_domain=500,
                     warm=0, dead=100, timeout=60, local=2)
    assert res["ranks"] == 2 and res["local"] == 2 and not res["differ"]
    assert res["launches_per_rank"] == [
        {"seg_sum64": 12, "q1_grouped_sums": 2, "grouped_sum_limbs": 0}] * 2


@pytest.mark.cuda
def test_bench_loops_on_gpu_match_numpy(cuda_device):
    """The bench's five loops (bench/bench.py) at 2^20 rows on the card:
    one iteration of each under torch's sync debug mode "error" (no
    operation of a loop waits for the device, so the slope is a device
    time), then K = 2 against numpy, 5 seg_sum64 launches an iteration
    and no other kernel's."""
    from monetdb_tpu_torch.bench import bench as B
    n, nseg, dom = 1 << 20, 1 << 14, 1 << 20
    qa = B.q_columns(n)
    bk, pk = B.join_keys(1 << 17, n, dom)
    sid, vals = B.groupby_columns(n, nseg)
    cases = [
        (B.q6_loop, B.q6_args(qa, cuda_device),
         lambda i: B.q6_numpy(qa, i)),
        (B.q1_loop, B.q1_args(qa, cuda_device),
         lambda i: B.q1_numpy(qa, i)),
        (B.seg_loop, B.seg_args(qa, cuda_device),
         lambda i: B.seg_numpy(qa, i)),
        (B.join_loop, B.join_args(bk, pk, dom, cuda_device),
         lambda i: B.join_numpy(bk, pk, i, dom)),
        (B.groupby_loop, B.groupby_args(sid, vals, nseg, cuda_device),
         lambda i: int(B.groupby_numpy(sid, vals, i, nseg).sum())),
    ]
    CK.build()
    torch.cuda.synchronize()
    for loop, args, want in cases:
        torch.cuda.set_sync_debug_mode("error")
        try:
            one = loop(*args, 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert int(one) == want(0), loop.__name__
        before = dict(CK.LAUNCHES)
        two = loop(*args, 2)
        launched = {k: CK.LAUNCHES[k] - before[k] for k in before}
        assert int(two) == want(0) + want(1), loop.__name__
        assert launched == {"seg_sum64": 10 if loop is B.seg_loop else 0,
                            "q1_grouped_sums": 0, "grouped_sum_limbs": 0}
    got = B.groupby_sums(*args[:2], 3, nseg)
    assert np.array_equal(got.cpu().numpy(),
                          B.groupby_numpy(sid, vals, 3, nseg))
