"""Independent numpy oracle for TPC-H queries over generated data.

Plays the role of the reference's .ans files (sql/benchmarks/tpch/01.ans...):
exact expected rows computed by a deliberately simple, engine-independent
implementation (pure numpy over the generator's host arrays).  Every value
is in the physical domain: decimals as scaled integers (a product of two
decimals carries the sum of their scales), dates as days since 1970-01-01,
strings as str, counts as int; rows in the order the query orders them.
Engine results must match these row for row, value for value.  Needs no
array library but numpy, so it runs on a machine without the reference
package.
"""

from __future__ import annotations

import datetime
import math
from decimal import Decimal

import numpy as np

__all__ = ["q1", "q2", "q3", "q4", "q5", "q6", "q19", "q20", "ORACLES", "KINDS",
           "decoded", "rows_differ"]


def _days(s: str) -> int:
    return int((np.datetime64(s) - np.datetime64("1970-01-01")).astype(int))


def _by_key(keys: np.ndarray, vals: np.ndarray, fill=0) -> np.ndarray:
    """Direct-address map of a unique integer key column: out[key] = val."""
    out = np.full(int(keys.max()) + 1, fill, dtype=vals.dtype)
    out[keys] = vals
    return out


def _group_sum(keys: np.ndarray, vals: np.ndarray):
    """(distinct keys ascending, exact int64 sum of vals per key)."""
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv, vals.astype(np.int64))
    return uniq, sums


def _nations_of_region(data, region: str) -> np.ndarray:
    """bool[nationkey]: the nation lies in ``region``."""
    r, n = data["region"], data["nation"]
    rk = r["r_regionkey"][r["r_name"] == region]
    return _by_key(n["n_nationkey"], np.isin(n["n_regionkey"], rk), False)


def q1(data):
    li = data["lineitem"]
    cutoff = _days("1998-12-01") - 90
    m = li["l_shipdate"] <= cutoff
    rf = li["l_returnflag"][m]
    ls = li["l_linestatus"][m]
    qty = li["l_quantity"][m].astype(object)       # exact big ints
    extp = li["l_extendedprice"][m].astype(object)
    disc = li["l_discount"][m].astype(object)
    tax = li["l_tax"][m].astype(object)
    disc_price = extp * (100 - disc)               # scale 4
    charge = disc_price * (100 + tax)              # scale 6
    keys = np.char.add(rf.astype(str), ls.astype(str))
    rows = []
    for k in sorted(set(keys.tolist())):
        g = keys == k
        n = int(g.sum())
        rows.append((
            k[0], k[1],
            int(qty[g].sum()), int(extp[g].sum()),
            int(disc_price[g].sum()), int(charge[g].sum()),
            float(qty[g].sum()) / 100.0 / n,
            float(extp[g].sum()) / 100.0 / n,
            float(disc[g].sum()) / 100.0 / n,
            n,
        ))
    return rows


def q2(data):
    """(s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
    s_comment), first 100 by s_acctbal desc, n_name, s_name, p_partkey."""
    p, s, ps, n = (data[t] for t in ("part", "supplier", "partsupp",
                                     "nation"))
    europe = _nations_of_region(data, "EUROPE")
    s_row = _by_key(s["s_suppkey"], np.arange(len(s["s_suppkey"])), -1)
    ps_srow = s_row[ps["ps_suppkey"]]
    in_eu = europe[s["s_nationkey"][ps_srow]]
    # cheapest European offer per part
    mincost = np.full(int(p["p_partkey"].max()) + 1,
                      np.iinfo(np.int64).max, np.int64)
    np.minimum.at(mincost, ps["ps_partkey"][in_eu],
                  ps["ps_supplycost"][in_eu])
    p_ok = _by_key(p["p_partkey"],
                   (p["p_size"] == 15) & np.char.endswith(p["p_type"],
                                                          "BRASS"), False)
    pk = ps["ps_partkey"]
    hit = np.flatnonzero(in_eu & p_ok[pk] &
                         (ps["ps_supplycost"] == mincost[pk]))
    p_row = _by_key(p["p_partkey"], np.arange(len(p["p_partkey"])), -1)
    n_name = _by_key(n["n_nationkey"], n["n_name"], "")
    rows = []
    for i in hit.tolist():
        sr, pr = int(ps_srow[i]), int(p_row[pk[i]])
        rows.append((int(s["s_acctbal"][sr]), str(s["s_name"][sr]),
                     str(n_name[s["s_nationkey"][sr]]),
                     int(p["p_partkey"][pr]), str(p["p_mfgr"][pr]),
                     str(s["s_address"][sr]), str(s["s_phone"][sr]),
                     str(s["s_comment"][sr])))
    rows.sort(key=lambda r: (-r[0], r[2], r[1], r[3]))
    return rows[:100]


def q3(data):
    """(l_orderkey, revenue scale 4, o_orderdate, o_shippriority), first
    10 by revenue desc, o_orderdate (then l_orderkey, the group order)."""
    c, o, li = data["customer"], data["orders"], data["lineitem"]
    day = _days("1995-03-15")
    building = _by_key(c["c_custkey"], c["c_mktsegment"] == "BUILDING",
                       False)
    o_ok = _by_key(o["o_orderkey"],
                   building[o["o_custkey"]] & (o["o_orderdate"] < day),
                   False)
    m = (li["l_shipdate"] > day) & o_ok[li["l_orderkey"]]
    keys, rev = _group_sum(
        li["l_orderkey"][m],
        li["l_extendedprice"][m] * (100 - li["l_discount"][m]))
    o_date = _by_key(o["o_orderkey"], o["o_orderdate"])
    o_prio = _by_key(o["o_orderkey"], o["o_shippriority"])
    rows = [(int(k), int(r), int(o_date[k]), int(o_prio[k]))
            for k, r in zip(keys.tolist(), rev.tolist())]
    rows.sort(key=lambda r: (-r[1], r[2], r[0]))
    return rows[:10]


def q4(data):
    """(o_orderpriority, order_count) by o_orderpriority."""
    o, li = data["orders"], data["lineitem"]
    late = np.zeros(int(o["o_orderkey"].max()) + 1, bool)
    late[li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]] = True
    m = ((o["o_orderdate"] >= _days("1993-07-01"))
         & (o["o_orderdate"] < _days("1993-10-01"))
         & late[o["o_orderkey"]])
    prio, cnt = np.unique(o["o_orderpriority"][m], return_counts=True)
    return [(str(k), int(v)) for k, v in zip(prio.tolist(), cnt.tolist())]


def q5(data):
    """(n_name, revenue scale 4) by revenue desc."""
    c, o, li, s, n = (data[t] for t in ("customer", "orders", "lineitem",
                                        "supplier", "nation"))
    asia = _nations_of_region(data, "ASIA")
    c_nat = _by_key(c["c_custkey"], c["c_nationkey"], -1)
    s_nat = _by_key(s["s_suppkey"], s["s_nationkey"], -1)
    o_ok = _by_key(o["o_orderkey"],
                   (o["o_orderdate"] >= _days("1994-01-01"))
                   & (o["o_orderdate"] < _days("1995-01-01")), False)
    o_cnat = _by_key(o["o_orderkey"], c_nat[o["o_custkey"]], -1)
    l_snat = s_nat[li["l_suppkey"]]
    m = (o_ok[li["l_orderkey"]] & (o_cnat[li["l_orderkey"]] == l_snat)
         & asia[l_snat])
    nat, rev = _group_sum(
        l_snat[m], li["l_extendedprice"][m] * (100 - li["l_discount"][m]))
    n_name = _by_key(n["n_nationkey"], n["n_name"], "")
    rows = [(str(n_name[k]), int(r))
            for k, r in zip(nat.tolist(), rev.tolist())]
    rows.sort(key=lambda r: -r[1])
    return rows


def q6(data):
    li = data["lineitem"]
    lo, hi = _days("1994-01-01"), _days("1995-01-01")
    m = ((li["l_shipdate"] >= lo) & (li["l_shipdate"] < hi)
         & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
         & (li["l_quantity"] < 24 * 100))
    rev = (li["l_extendedprice"][m].astype(object)
           * li["l_discount"][m].astype(object)).sum()
    return [(int(rev),)]


def q19(data):
    """(revenue scale 4,): one row, None when no lineitem qualifies."""
    p, li = data["part"], data["lineitem"]
    brand = _by_key(p["p_partkey"], p["p_brand"], "")[li["l_partkey"]]
    cont = _by_key(p["p_partkey"], p["p_container"], "")[li["l_partkey"]]
    size = _by_key(p["p_partkey"], p["p_size"], -1)[li["l_partkey"]]
    qty = li["l_quantity"]                          # scale 2
    common = (np.isin(li["l_shipmode"], ["AIR", "AIR REG"])
              & (li["l_shipinstruct"] == "DELIVER IN PERSON"))
    m = np.zeros(len(qty), bool)
    for b, kinds, q_lo, s_hi in (
            ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
            ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
             10, 10),
            ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
             20, 15)):
        m |= ((brand == b) & np.isin(cont, kinds)
              & (qty >= q_lo * 100) & (qty <= (q_lo + 10) * 100)
              & (size >= 1) & (size <= s_hi))
    m &= common
    if not m.any():
        return [(None,)]
    rev = (li["l_extendedprice"][m].astype(object)
           * (100 - li["l_discount"][m].astype(object))).sum()
    return [(int(rev),)]


def q20(data):
    """(s_name, s_address) by s_name."""
    p, ps, li, s, n = (data[t] for t in ("part", "partsupp", "lineitem",
                                         "supplier", "nation"))
    forest = _by_key(p["p_partkey"], np.char.startswith(p["p_name"],
                                                        "forest"), False)
    m = ((li["l_shipdate"] >= _days("1994-01-01"))
         & (li["l_shipdate"] < _days("1995-01-01")))
    nsupp = int(s["s_suppkey"].max()) + 1
    pairs, qty = _group_sum(
        li["l_partkey"][m].astype(np.int64) * nsupp + li["l_suppkey"][m],
        li["l_quantity"][m])
    # shipped quantity (scale 2) of each partsupp row; 0 rows -> no match
    ps_pair = ps["ps_partkey"].astype(np.int64) * nsupp + ps["ps_suppkey"]
    at = np.clip(np.searchsorted(pairs, ps_pair), 0, len(pairs) - 1)
    shipped = pairs[at] == ps_pair
    # ps_availqty > 0.5 * sum(l_quantity), both sides at scale 3
    ok = (forest[ps["ps_partkey"]] & shipped
          & (ps["ps_availqty"].astype(np.int64) * 1000 > 5 * qty[at]))
    excess = np.zeros(nsupp, bool)
    excess[ps["ps_suppkey"][ok]] = True
    canada = n["n_nationkey"][n["n_name"] == "CANADA"]
    hit = excess[s["s_suppkey"]] & np.isin(s["s_nationkey"], canada)
    rows = [(str(a), str(b))
            for a, b in zip(s["s_name"][hit], s["s_address"][hit])]
    rows.sort(key=lambda r: r[0])
    return rows


#: query number -> oracle
ORACLES = {1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 19: q19, 20: q20}

#: query number -> kind of each result column: a decimal's scale (int),
#: "str", "int", "date" or "float"
KINDS = {
    1: ("str", "str", 2, 2, 4, 6, "float", "float", "float", "int"),
    2: (2, "str", "str", "int", "str", "str", "str", "str"),
    3: ("int", 4, "date", "int"),
    4: ("str", "int"),
    5: ("str", 4),
    6: (4,),
    19: (4,),
    20: ("str", "str"),
}

_EPOCH = datetime.date(1970, 1, 1)


def decoded(q: int, rows):
    """An oracle's physical rows as the SQL values an engine returns:
    decimals as decimal.Decimal, dates as datetime.date."""
    def one(kind, v):
        if v is None or kind in ("str", "int", "float"):
            return v
        if kind == "date":
            return _EPOCH + datetime.timedelta(days=v)
        return Decimal(v).scaleb(-kind)
    return [tuple(one(k, v) for k, v in zip(KINDS[q], r, strict=True))
            for r in rows]


def rows_differ(got, want, float_rtol: float):
    """None when the ordered rows ``got`` equal ``want`` (values and their
    types exactly, floats within ``float_rtol``), else a description of the
    first difference."""
    if len(got) != len(want):
        return f"{len(got)} rows, expected {len(want)}"
    for i, (g_row, w_row) in enumerate(zip(got, want)):
        if len(g_row) != len(w_row):
            return f"row {i}: {tuple(g_row)} != {tuple(w_row)}"
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                same = isinstance(g, float) and (
                    math.isclose(g, w, rel_tol=float_rtol)
                    or (math.isnan(g) and math.isnan(w)))
            else:
                same = type(g) is type(w) and g == w
            if not same:
                return f"row {i}: {tuple(g_row)} != {tuple(w_row)}"
    return None
