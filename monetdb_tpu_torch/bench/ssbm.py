"""Star Schema Benchmark (SSBM) — generator, schema, and the 13 queries.

The reference ships SSBM as a benchmark suite (sql/benchmarks/ssbm/: DDL,
dbgen-produced data, queries 1.1–4.3; also used by the multi-node remote
test sql/test/remote/Tests/ssbm.SQL.py). Here the generator is a seeded
vectorized numpy producer in the *physical* domain (dates as yyyymmdd ints,
prices as integer cents — SSBM prices are integers in-spec), so the same
arrays load into both the engine and the sqlite oracle and results compare
exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["gen_ssbm", "load_ssbm", "QUERIES", "SCHEMA"]

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS_BY_REGION = {
    "AFRICA": ["ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE"],
    "AMERICA": ["ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES"],
    "ASIA": ["CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM"],
    "EUROPE": ["FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM"],
    "MIDDLE EAST": ["EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA"],
}
MONTHS = ["January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December"]


def _dim_geo(rng, n, prefix):
    region = np.array(REGIONS)[rng.integers(0, 5, n)]
    nation = np.array([NATIONS_BY_REGION[r][i % 5]
                       for i, r in enumerate(region)])
    city = np.array([f"{na[:9]:<9}{rng2}" for na, rng2 in
                     zip(nation, rng.integers(0, 10, n))])
    return region, nation, city


def gen_ssbm(n_lineorder: int = 30_000, seed: int = 11) \
        -> Dict[str, Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    nc, ns, np_ = max(n_lineorder // 40, 50), max(n_lineorder // 150, 20), \
        max(n_lineorder // 30, 80)

    # -- date dimension: 7 years of days ---------------------------------
    days = np.arange(np.datetime64("1992-01-01"), np.datetime64("1999-01-01"))
    y = days.astype("datetime64[Y]").astype(int) + 1970
    m = days.astype("datetime64[M]").astype(int) % 12 + 1
    d = (days - days.astype("datetime64[M]")).astype(int) + 1
    datekey = (y * 10000 + m * 100 + d).astype(np.int64)
    doy = (days - days.astype("datetime64[Y]")).astype(int)
    date = {
        "d_datekey": datekey,
        "d_year": y.astype(np.int64),
        "d_yearmonthnum": (y * 100 + m).astype(np.int64),
        "d_yearmonth": np.array([f"{MONTHS[mm - 1][:3]}{yy}"
                                 for mm, yy in zip(m, y)]),
        "d_month": np.array([MONTHS[mm - 1] for mm in m]),
        "d_weeknuminyear": (doy // 7 + 1).astype(np.int64),
    }

    creg, cnat, ccity = _dim_geo(rng, nc, "c")
    customer = {
        "c_custkey": np.arange(1, nc + 1, dtype=np.int64),
        "c_region": creg, "c_nation": cnat, "c_city": ccity,
    }
    sreg, snat, scity = _dim_geo(rng, ns, "s")
    supplier = {
        "s_suppkey": np.arange(1, ns + 1, dtype=np.int64),
        "s_region": sreg, "s_nation": snat, "s_city": scity,
    }

    mfgr = rng.integers(1, 6, np_)
    cat = rng.integers(1, 6, np_)
    brand = rng.integers(1, 41, np_)
    part = {
        "p_partkey": np.arange(1, np_ + 1, dtype=np.int64),
        "p_mfgr": np.array([f"MFGR#{v}" for v in mfgr]),
        "p_category": np.array([f"MFGR#{v}{c}" for v, c in zip(mfgr, cat)]),
        "p_brand1": np.array([f"MFGR#{v}{c}{b:02d}"
                              for v, c, b in zip(mfgr, cat, brand)]),
    }

    n = n_lineorder
    odate = datekey[rng.integers(0, len(datekey), n)]
    qty = rng.integers(1, 51, n).astype(np.int64)
    extp = rng.integers(90_000, 10_000_000, n).astype(np.int64)
    disc = rng.integers(0, 11, n).astype(np.int64)
    rev = extp * (100 - disc) // 100
    lineorder = {
        "lo_orderkey": np.arange(1, n + 1, dtype=np.int64),
        "lo_custkey": rng.integers(1, nc + 1, n).astype(np.int64),
        "lo_partkey": rng.integers(1, np_ + 1, n).astype(np.int64),
        "lo_suppkey": rng.integers(1, ns + 1, n).astype(np.int64),
        "lo_orderdate": odate.astype(np.int64),
        "lo_quantity": qty,
        "lo_extendedprice": extp,
        "lo_discount": disc,
        "lo_revenue": rev,
        "lo_supplycost": (extp * 6 // 10).astype(np.int64),
    }
    return {"dates": date, "customer": customer, "supplier": supplier,
            "part": part, "lineorder": lineorder}


SCHEMA = {
    "dates": {"d_datekey": "i64", "d_year": "i64", "d_yearmonthnum": "i64",
              "d_yearmonth": "str", "d_month": "str",
              "d_weeknuminyear": "i64"},
    "customer": {"c_custkey": "i64", "c_region": "str", "c_nation": "str",
                 "c_city": "str"},
    "supplier": {"s_suppkey": "i64", "s_region": "str", "s_nation": "str",
                 "s_city": "str"},
    "part": {"p_partkey": "i64", "p_mfgr": "str", "p_category": "str",
             "p_brand1": "str"},
    "lineorder": {"lo_orderkey": "i64", "lo_custkey": "i64",
                  "lo_partkey": "i64", "lo_suppkey": "i64",
                  "lo_orderdate": "i64", "lo_quantity": "i64",
                  "lo_extendedprice": "i64", "lo_discount": "i64",
                  "lo_revenue": "i64", "lo_supplycost": "i64"},
}


def load_ssbm(n_lineorder: int = 30_000, seed: int = 11, *,
              device="cuda"):
    """Generated arrays → engine Catalog with every column on ``device``:
    the card unless the caller names another device (same property
    derivation as the TPC-H loader)."""
    from ..table import Catalog, Table
    from .tpch_load import make_column
    data = gen_ssbm(n_lineorder, seed)
    cat = Catalog()
    for tname, cols in data.items():
        dev = {}
        for cname, arr in cols.items():
            dev[cname] = make_column(arr, SCHEMA[tname][cname], device)
        cat.add(Table.from_dict(tname, dev))
    return cat, data


# The 13 SSBM queries (sql/benchmarks/ssbm/*.sql), written over the
# physical domain (yyyymmdd ints / integer cents) so the same text runs on
# the engine and the sqlite oracle.
QUERIES = {
    "1.1": """select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder, dates where lo_orderdate = d_datekey
        and d_year = 1993 and lo_discount between 1 and 3
        and lo_quantity < 25""",
    "1.2": """select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder, dates where lo_orderdate = d_datekey
        and d_yearmonthnum = 199401
        and lo_discount between 4 and 6
        and lo_quantity between 26 and 35""",
    "1.3": """select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder, dates where lo_orderdate = d_datekey
        and d_weeknuminyear = 6 and d_year = 1994
        and lo_discount between 5 and 7
        and lo_quantity between 26 and 35""",
    "2.1": """select sum(lo_revenue), d_year, p_brand1
        from lineorder, dates, part, supplier
        where lo_orderdate = d_datekey and lo_partkey = p_partkey
        and lo_suppkey = s_suppkey and p_category = 'MFGR#12'
        and s_region = 'AMERICA'
        group by d_year, p_brand1 order by d_year, p_brand1""",
    "2.2": """select sum(lo_revenue), d_year, p_brand1
        from lineorder, dates, part, supplier
        where lo_orderdate = d_datekey and lo_partkey = p_partkey
        and lo_suppkey = s_suppkey
        and p_brand1 between 'MFGR#2221' and 'MFGR#2228'
        and s_region = 'ASIA'
        group by d_year, p_brand1 order by d_year, p_brand1""",
    "2.3": """select sum(lo_revenue), d_year, p_brand1
        from lineorder, dates, part, supplier
        where lo_orderdate = d_datekey and lo_partkey = p_partkey
        and lo_suppkey = s_suppkey and p_brand1 = 'MFGR#2239'
        and s_region = 'EUROPE'
        group by d_year, p_brand1 order by d_year, p_brand1""",
    "3.1": """select c_nation, s_nation, d_year, sum(lo_revenue) as revenue
        from customer, lineorder, supplier, dates
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
        and lo_orderdate = d_datekey and c_region = 'ASIA'
        and s_region = 'ASIA' and d_year >= 1992 and d_year <= 1997
        group by c_nation, s_nation, d_year
        order by d_year asc, revenue desc, c_nation, s_nation""",
    "3.2": """select c_city, s_city, d_year, sum(lo_revenue) as revenue
        from customer, lineorder, supplier, dates
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
        and lo_orderdate = d_datekey and c_nation = 'UNITED STATES'
        and s_nation = 'UNITED STATES'
        and d_year >= 1992 and d_year <= 1997
        group by c_city, s_city, d_year
        order by d_year asc, revenue desc, c_city, s_city""",
    "3.3": """select c_city, s_city, d_year, sum(lo_revenue) as revenue
        from customer, lineorder, supplier, dates
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
        and lo_orderdate = d_datekey
        and (c_city = 'UNITED KI1' or c_city = 'UNITED KI5')
        and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')
        and d_year >= 1992 and d_year <= 1997
        group by c_city, s_city, d_year
        order by d_year asc, revenue desc, c_city, s_city""",
    "3.4": """select c_city, s_city, d_year, sum(lo_revenue) as revenue
        from customer, lineorder, supplier, dates
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
        and lo_orderdate = d_datekey
        and (c_city = 'UNITED KI1' or c_city = 'UNITED KI5')
        and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')
        and d_yearmonth = 'Dec1997'
        group by c_city, s_city, d_year
        order by d_year asc, revenue desc, c_city, s_city""",
    "4.1": """select d_year, c_nation,
        sum(lo_revenue - lo_supplycost) as profit
        from dates, customer, supplier, part, lineorder
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
        and lo_partkey = p_partkey and lo_orderdate = d_datekey
        and c_region = 'AMERICA' and s_region = 'AMERICA'
        and (p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')
        group by d_year, c_nation order by d_year, c_nation""",
    "4.2": """select d_year, s_nation, p_category,
        sum(lo_revenue - lo_supplycost) as profit
        from dates, customer, supplier, part, lineorder
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
        and lo_partkey = p_partkey and lo_orderdate = d_datekey
        and c_region = 'AMERICA' and s_region = 'AMERICA'
        and (d_year = 1997 or d_year = 1998)
        and (p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')
        group by d_year, s_nation, p_category
        order by d_year, s_nation, p_category""",
    "4.3": """select d_year, s_city, p_brand1,
        sum(lo_revenue - lo_supplycost) as profit
        from dates, customer, supplier, part, lineorder
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
        and lo_partkey = p_partkey and lo_orderdate = d_datekey
        and s_nation = 'UNITED STATES'
        and (d_year = 1997 or d_year = 1998)
        and p_category = 'MFGR#14'
        group by d_year, s_city, p_brand1
        order by d_year, s_city, p_brand1""",
}
