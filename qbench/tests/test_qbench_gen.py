"""The generators: the same seed gives the same tables, another seed other
tables, and SSB's cardinalities and key ranges follow the spec (at a tiny
scale on the CPU)."""

import numpy as np
import pytest
import torch

from qbench.gen import ssb, tpch

SSB_TINY = {"scale_factor": 0.01, "rows": {"lineorder": 30000}}
SEED = 2 ** 31 + 12345          # wider than 32 signed bits


def _equal(a, b) -> bool:
    if isinstance(a, ssb.Coded):
        return _equal(a.codes, b.codes) and np.array_equal(a.values,
                                                           b.values)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return np.array_equal(a, b)


def _same_tables(x, y) -> bool:
    return x.keys() == y.keys() and all(
        x[t].keys() == y[t].keys() and all(_equal(x[t][c], y[t][c])
                                           for c in x[t]) for t in x)


@pytest.fixture(scope="module")
def tpch_pair():
    return (tpch.generate({"scale_factor": 0.01}, SEED),
            tpch.generate({"scale_factor": 0.01}, SEED))


def test_tpch_repeats_for_a_seed_and_differs_across_seeds(tpch_pair):
    a, b = tpch_pair
    assert _same_tables(a, b)
    c = tpch.generate({"scale_factor": 0.01}, SEED + 1)
    for t, col in (("lineitem", "l_quantity"), ("orders", "o_custkey"),
                   ("customer", "c_acctbal"), ("part", "p_size")):
        assert not np.array_equal(a[t][col][:1000], c[t][col][:1000]), col


def test_tpch_cardinalities(tpch_pair):
    a, _ = tpch_pair
    n = {t: len(next(iter(cols.values()))) for t, cols in a.items()}
    assert n == {"region": 5, "nation": 25, "supplier": 100, "part": 2000,
                 "partsupp": 8000, "customer": 1500, "orders": 15000,
                 "lineitem": n["lineitem"]}
    assert 15000 <= n["lineitem"] <= 7 * 15000


def test_tpch_negative_and_huge_seeds_run():
    for s in (-1, 2 ** 63 + 5):
        tpch.gen_region(s)


@pytest.fixture(scope="module")
def ssb_pair():
    return (ssb.generate(SSB_TINY, SEED, "cpu"),
            ssb.generate(SSB_TINY, SEED, "cpu"))


def test_ssb_repeats_for_a_seed_and_differs_across_seeds(ssb_pair):
    a, b = ssb_pair
    assert _same_tables(a, b)
    c = ssb.generate(SSB_TINY, SEED + 1, "cpu")
    for t, col in (("lineorder", "lo_custkey"), ("lineorder", "lo_revenue"),
                   ("customer", "c_city"), ("part", "p_brand1")):
        assert not _equal(a[t][col], c[t][col]), col


def test_ssb_spec_cardinalities():
    assert ssb.part_rows(20) == 1_000_000          # 200,000 x floor(1+log2 20)
    assert ssb.part_rows(1) == 200_000
    assert ssb.part_rows(2) == 400_000
    assert len(ssb._dates()["d_datekey"]) == 2557  # 1992-01-01 .. 1998-12-31


def test_ssb_keys_and_ranges(ssb_pair):
    d, _ = ssb_pair
    lo = {c: (v.codes if isinstance(v, ssb.Coded) else v).numpy()
          for c, v in d["lineorder"].items()}
    assert len(d["lineorder"]) == 17
    assert all(len(v) == 30000 for v in lo.values())
    ncust, nsupp, npart = 300, 20, 2000
    assert len(d["customer"]["c_custkey"]) == ncust
    assert len(d["supplier"]["s_suppkey"]) == nsupp
    assert len(d["part"]["p_partkey"]) == npart
    for t, k, n in (("customer", "c_custkey", ncust),
                    ("supplier", "s_suppkey", nsupp),
                    ("part", "p_partkey", npart)):
        assert np.array_equal(d[t][k], np.arange(1, n + 1))
    for c, n in (("lo_custkey", ncust), ("lo_suppkey", nsupp),
                 ("lo_partkey", npart)):
        assert lo[c].min() >= 1 and lo[c].max() <= n
    keys = set(d["dates"]["d_datekey"].tolist())
    assert set(lo["lo_orderdate"].tolist()) <= keys
    assert set(lo["lo_commitdate"].tolist()) <= keys
    assert lo["lo_linenumber"].min() == 1 and lo["lo_linenumber"].max() <= 7
    assert lo["lo_quantity"].min() >= 1 and lo["lo_quantity"].max() <= 50
    assert lo["lo_discount"].min() >= 0 and lo["lo_discount"].max() <= 10
    assert lo["lo_tax"].min() >= 0 and lo["lo_tax"].max() <= 8
    # order keys run 1..orders with each order's lines numbered from 1
    ok = lo["lo_orderkey"]
    assert ok[0] == 1 and np.all(np.diff(ok) >= 0)
    first = np.r_[True, ok[1:] != ok[:-1]]
    assert np.all(lo["lo_linenumber"][first] == 1)
    # revenue, extended price and the order total follow their formulas
    pk = lo["lo_partkey"].astype(np.int64)
    retail = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1_000)
    assert np.array_equal(lo["lo_extendedprice"], lo["lo_quantity"] * retail)
    assert np.array_equal(lo["lo_revenue"], lo["lo_extendedprice"].astype(
        np.int64) * (100 - lo["lo_discount"]) // 100)
    assert np.array_equal(lo["lo_supplycost"], 6 * retail // 10)
    charge = (lo["lo_extendedprice"].astype(np.int64)
              * (100 - lo["lo_discount"]) * (100 + lo["lo_tax"]) // 10_000)
    total = np.bincount(ok, weights=charge).astype(np.int64)
    assert np.array_equal(lo["lo_ordtotalprice"], total[ok])
    # dictionaries are sorted; codes index them
    for c in ("lo_orderpriority", "lo_shippriority", "lo_shipmode"):
        v = d["lineorder"][c].values
        assert list(v) == sorted(v)
        assert lo[c].min() >= 0 and lo[c].max() < len(v)


def test_ssb_dimension_attributes(ssb_pair):
    d, _ = ssb_pair
    c, p, dt = d["customer"], d["part"], d["dates"]
    nations = {n: ssb.REGIONS[r] for n, r in ssb.NATIONS}
    assert all(nations[n] == r for n, r in zip(c["c_nation"], c["c_region"]))
    assert all(city[:9] == f"{n[:9]:<9}" and city[9].isdigit()
               for city, n in zip(c["c_city"], c["c_nation"]))
    assert all(b.startswith(cat) and len(b) == 9
               for cat, b in zip(p["p_category"], p["p_brand1"]))
    assert set(p["p_mfgr"]) <= {f"MFGR#{i}" for i in range(1, 6)}
    i = list(dt["d_datekey"]).index(19971225)
    assert (dt["d_yearmonth"][i], dt["d_holidayfl"][i], dt["d_year"][i]) \
        == ("Dec1997", 1, 1997)
    assert dt["d_dayofweek"][list(dt["d_datekey"]).index(19920101)] \
        == "Wednesday"
