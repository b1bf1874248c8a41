"""The plain reference for TPC-H: a frozen copy of the port's numpy oracle.

Copied from ``monetdb_tpu_torch/bench/tpch_oracle.py`` at commit
71cd943e8ae6973a2cc337c895a48cca15b0d751 (the oracle ``chip_smoke.py``
holds the port to).  It needs nothing but numpy and imports nothing of the
program.  Exact expected rows computed by a deliberately simple,
engine-independent implementation (pure numpy over the generator's host
arrays).  Every value is in the physical domain: decimals as scaled
integers (a product of two decimals carries the sum of their scales),
dates as days since 1970-01-01, strings as str, counts as int; rows in the
order the query orders them.  ``decoded`` turns them into the SQL values an
engine returns.  Added to the copy: ``expected``, the harness's entry
point, and ``control``, the lower-precision control.
"""

from __future__ import annotations

import datetime
from decimal import Decimal

import numpy as np

__all__ = ["ORACLES", "KINDS", "decoded", "expected", "control"]


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


def _year(days: np.ndarray) -> np.ndarray:
    """Calendar year of days since 1970-01-01."""
    return (days.astype("datetime64[D]").astype("datetime64[Y]")
            .astype(np.int64) + 1970)


def _volume(li, m) -> np.ndarray:
    """l_extendedprice * (1 - l_discount) of the rows ``m``, scale 4."""
    return li["l_extendedprice"][m] * (100 - li["l_discount"][m])


def _pack(*cols) -> np.ndarray:
    """One int64 code per row from non-negative integer columns, ordered
    as the tuple of columns orders."""
    code = np.zeros(len(cols[0]), np.int64)
    for c in cols:
        code = code * (int(c.max()) + 1 if len(c) else 1) + c
    return code


def _contains_then(a: np.ndarray, first: str, then: str) -> np.ndarray:
    """LIKE '%first%then%' over a string array."""
    at = np.char.find(a, first)
    after = np.char.find(a, then, np.where(at >= 0, at + len(first), 0))
    return (at >= 0) & (after >= 0)


def _nation_key(data, name: str) -> int:
    n = data["nation"]
    return int(n["n_nationkey"][n["n_name"] == name][0])


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


def q7(data):
    """(supp_nation, cust_nation, l_year, revenue scale 4) by the first
    three."""
    s, li, o, c, n = (data[t] for t in ("supplier", "lineitem", "orders",
                                        "customer", "nation"))
    fr, de = _nation_key(data, "FRANCE"), _nation_key(data, "GERMANY")
    s_nat = _by_key(s["s_suppkey"], s["s_nationkey"], -1)
    c_nat = _by_key(c["c_custkey"], c["c_nationkey"], -1)
    o_cnat = _by_key(o["o_orderkey"], c_nat[o["o_custkey"]], -1)
    sn, cn = s_nat[li["l_suppkey"]], o_cnat[li["l_orderkey"]]
    m = ((li["l_shipdate"] >= _days("1995-01-01"))
         & (li["l_shipdate"] <= _days("1996-12-31"))
         & (((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))))
    year = _year(li["l_shipdate"][m])
    keys, rev = _group_sum(_pack(sn[m], cn[m], year), _volume(li, m))
    n_name = _by_key(n["n_nationkey"], n["n_name"], "")
    ny = int(year.max()) + 1 if len(year) else 1
    nn = int(cn[m].max()) + 1 if len(year) else 1
    rows = [(str(n_name[k // ny // nn]), str(n_name[k // ny % nn]),
             int(k % ny), int(r)) for k, r in zip(keys.tolist(), rev.tolist())]
    rows.sort(key=lambda r: r[:3])
    return rows


def q8(data):
    """(o_year, mkt_share float) by o_year."""
    p, s, li, o, c = (data[t] for t in ("part", "supplier", "lineitem",
                                        "orders", "customer"))
    america = _nations_of_region(data, "AMERICA")
    brazil = _nation_key(data, "BRAZIL")
    c_nat = _by_key(c["c_custkey"], c["c_nationkey"], -1)
    o_ok = _by_key(o["o_orderkey"],
                   america[c_nat[o["o_custkey"]]]
                   & (o["o_orderdate"] >= _days("1995-01-01"))
                   & (o["o_orderdate"] <= _days("1996-12-31")), False)
    p_ok = _by_key(p["p_partkey"], p["p_type"] == "ECONOMY ANODIZED STEEL",
                   False)
    m = o_ok[li["l_orderkey"]] & p_ok[li["l_partkey"]]
    year = _year(_by_key(o["o_orderkey"], o["o_orderdate"])
                 [li["l_orderkey"][m]])
    vol = _volume(li, m)
    from_brazil = _by_key(s["s_suppkey"], s["s_nationkey"],
                          -1)[li["l_suppkey"][m]] == brazil
    years, total = _group_sum(year, vol)
    _y, part = _group_sum(year, np.where(from_brazil, vol, 0))
    return [(int(y), (float(a) / 1e4) / (float(b) / 1e4))
            for y, a, b in zip(years.tolist(), part.tolist(), total.tolist())]


def q9(data):
    """(nation, o_year, sum_profit scale 4) by nation, o_year desc."""
    p, s, li, ps, o, n = (data[t] for t in ("part", "supplier", "lineitem",
                                            "partsupp", "orders", "nation"))
    green = _by_key(p["p_partkey"], np.char.find(p["p_name"], "green") >= 0,
                    False)
    m = green[li["l_partkey"]]
    nsupp = int(s["s_suppkey"].max()) + 1
    ps_pair = ps["ps_partkey"].astype(np.int64) * nsupp + ps["ps_suppkey"]
    order = np.argsort(ps_pair)
    l_pair = li["l_partkey"][m].astype(np.int64) * nsupp + li["l_suppkey"][m]
    at = order[np.searchsorted(ps_pair[order], l_pair)]
    assert np.array_equal(ps_pair[at], l_pair)
    amount = _volume(li, m) - ps["ps_supplycost"][at] * li["l_quantity"][m]
    nat = _by_key(s["s_suppkey"], s["s_nationkey"], -1)[li["l_suppkey"][m]]
    year = _year(_by_key(o["o_orderkey"], o["o_orderdate"])
                 [li["l_orderkey"][m]])
    keys, profit = _group_sum(_pack(nat, year), amount)
    ny = int(year.max()) + 1
    n_name = _by_key(n["n_nationkey"], n["n_name"], "")
    rows = [(str(n_name[k // ny]), int(k % ny), int(v))
            for k, v in zip(keys.tolist(), profit.tolist())]
    rows.sort(key=lambda r: (r[0], -r[1]))
    return rows


def q10(data):
    """(c_custkey, c_name, revenue scale 4, c_acctbal, n_name, c_address,
    c_phone, c_comment), first 20 by revenue desc (then c_custkey)."""
    c, o, li = data["customer"], data["orders"], data["lineitem"]
    o_ok = _by_key(o["o_orderkey"],
                   (o["o_orderdate"] >= _days("1993-10-01"))
                   & (o["o_orderdate"] < _days("1994-01-01")), False)
    m = o_ok[li["l_orderkey"]] & (li["l_returnflag"] == "R")
    o_cust = _by_key(o["o_orderkey"], o["o_custkey"], -1)
    cust, rev = _group_sum(o_cust[li["l_orderkey"][m]], _volume(li, m))
    top = sorted(zip(cust.tolist(), rev.tolist()),
                 key=lambda r: (-r[1], r[0]))[:20]
    c_row = _by_key(c["c_custkey"], np.arange(len(c["c_custkey"])), -1)
    n_name = _by_key(data["nation"]["n_nationkey"],
                     data["nation"]["n_name"], "")
    rows = []
    for k, r in top:
        i = int(c_row[k])
        rows.append((int(k), str(c["c_name"][i]), int(r),
                     int(c["c_acctbal"][i]),
                     str(n_name[c["c_nationkey"][i]]),
                     str(c["c_address"][i]), str(c["c_phone"][i]),
                     str(c["c_comment"][i])))
    return rows


def q11(data):
    """(ps_partkey, value scale 2) by value desc (then ps_partkey)."""
    ps, s = data["partsupp"], data["supplier"]
    german = _by_key(s["s_suppkey"],
                     s["s_nationkey"] == _nation_key(data, "GERMANY"), False)
    m = german[ps["ps_suppkey"]]
    parts, value = _group_sum(
        ps["ps_partkey"][m],
        ps["ps_supplycost"][m] * ps["ps_availqty"][m].astype(np.int64))
    total = int(value.astype(object).sum())
    # value > total * 0.0001, both sides at scale 6
    rows = [(int(k), int(v)) for k, v in zip(parts.tolist(), value.tolist())
            if int(v) * 10_000 > total]
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows


def q12(data):
    """(l_shipmode, high_line_count, low_line_count) by l_shipmode."""
    o, li = data["orders"], data["lineitem"]
    m = (np.isin(li["l_shipmode"], ["MAIL", "SHIP"])
         & (li["l_commitdate"] < li["l_receiptdate"])
         & (li["l_shipdate"] < li["l_commitdate"])
         & (li["l_receiptdate"] >= _days("1994-01-01"))
         & (li["l_receiptdate"] < _days("1995-01-01")))
    high = _by_key(o["o_orderkey"],
                   np.isin(o["o_orderpriority"], ["1-URGENT", "2-HIGH"]),
                   False)[li["l_orderkey"][m]]
    mode = li["l_shipmode"][m]
    return [(str(k), int((high & (mode == k)).sum()),
             int((~high & (mode == k)).sum()))
            for k in sorted(set(mode.tolist()))]


def q13(data):
    """(c_count, custdist) by custdist desc, c_count desc."""
    c, o = data["customer"], data["orders"]
    ok = ~_contains_then(o["o_comment"], "special", "requests")
    per_cust = np.bincount(o["o_custkey"][ok],
                           minlength=int(c["c_custkey"].max()) + 1)
    counts, dist = np.unique(per_cust[c["c_custkey"]], return_counts=True)
    rows = [(int(k), int(v)) for k, v in zip(counts.tolist(), dist.tolist())]
    rows.sort(key=lambda r: (-r[1], -r[0]))
    return rows


def q14(data):
    """(promo_revenue float,): 100.00 * promo / total, the decimal product
    at scale 6 and the total at scale 4 divided as floats."""
    p, li = data["part"], data["lineitem"]
    m = ((li["l_shipdate"] >= _days("1995-09-01"))
         & (li["l_shipdate"] < _days("1995-10-01")))
    if not m.any():
        return [(None,)]
    promo = _by_key(p["p_partkey"], np.char.startswith(p["p_type"], "PROMO"),
                    False)[li["l_partkey"][m]]
    vol = _volume(li, m).astype(object)
    return [((float(10_000 * int(vol[promo].sum())) / 1e6)
             / (float(int(vol.sum())) / 1e4),)]


def q15(data):
    """(s_suppkey, s_name, s_address, s_phone, total_revenue scale 4) by
    s_suppkey."""
    s, li = data["supplier"], data["lineitem"]
    m = ((li["l_shipdate"] >= _days("1996-01-01"))
         & (li["l_shipdate"] < _days("1996-04-01")))
    supp, rev = _group_sum(li["l_suppkey"][m], _volume(li, m))
    s_row = _by_key(s["s_suppkey"], np.arange(len(s["s_suppkey"])), -1)
    rows = []
    for k in supp[rev == rev.max()].tolist():
        i = int(s_row[k])
        assert i >= 0
        rows.append((int(k), str(s["s_name"][i]), str(s["s_address"][i]),
                     str(s["s_phone"][i]), int(rev.max())))
    return rows


def q16(data):
    """(p_brand, p_type, p_size, supplier_cnt) by supplier_cnt desc,
    p_brand, p_type, p_size."""
    ps, p, s = data["partsupp"], data["part"], data["supplier"]
    complaints = _by_key(s["s_suppkey"], _contains_then(
        s["s_comment"], "Customer", "Complaints"), False)
    brands, brand = np.unique(p["p_brand"], return_inverse=True)
    types, typ = np.unique(p["p_type"], return_inverse=True)
    p_ok = ((p["p_brand"] != "Brand#45")
            & ~np.char.startswith(p["p_type"], "MEDIUM POLISHED")
            & np.isin(p["p_size"], [49, 14, 23, 45, 19, 3, 36, 9]))
    nsize = int(p["p_size"].max()) + 1
    group = _by_key(p["p_partkey"],
                    np.where(p_ok, (brand * len(types) + typ) * nsize
                             + p["p_size"], -1).astype(np.int64), -1)
    g = group[ps["ps_partkey"]]
    m = (g >= 0) & ~complaints[ps["ps_suppkey"]]
    nsupp = int(s["s_suppkey"].max()) + 1
    pairs = np.unique(g[m] * nsupp + ps["ps_suppkey"][m])
    groups, cnt = np.unique(pairs // nsupp, return_counts=True)
    rows = [(str(brands[k // nsize // len(types)]),
             str(types[k // nsize % len(types)]), int(k % nsize), int(v))
            for k, v in zip(groups.tolist(), cnt.tolist())]
    rows.sort(key=lambda r: (-r[3], r[0], r[1], r[2]))
    return rows


def q17(data):
    """(avg_yearly float,): sum(l_extendedprice) / 7.0 over the small
    orders; avg(l_quantity) is a float, so the comparison is one too."""
    p, li = data["part"], data["lineitem"]
    npart = int(p["p_partkey"].max()) + 1
    cnt = np.bincount(li["l_partkey"], minlength=npart)
    qty = np.zeros(npart, np.int64)
    np.add.at(qty, li["l_partkey"], li["l_quantity"])
    avg_qty = qty.astype(np.float64) / 100.0 / np.maximum(cnt, 1)
    p_ok = _by_key(p["p_partkey"], (p["p_brand"] == "Brand#23")
                   & (p["p_container"] == "MED BOX"), False)
    m = (p_ok[li["l_partkey"]]
         & (li["l_quantity"] / 100.0 < 0.2 * avg_qty[li["l_partkey"]]))
    if not m.any():
        return [(None,)]
    total = int(li["l_extendedprice"][m].astype(object).sum())
    return [((float(total) / 100.0) / 7.0,)]


def q18(data):
    """(c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
    sum(l_quantity) scale 2), first 100 by o_totalprice desc, o_orderdate
    (then o_orderkey)."""
    o, li = data["orders"], data["lineitem"]
    qty = np.zeros(int(o["o_orderkey"].max()) + 1, np.int64)
    np.add.at(qty, li["l_orderkey"], li["l_quantity"])
    big = np.flatnonzero(qty[o["o_orderkey"]] > 300 * 100)
    c = data["customer"]
    c_row = _by_key(c["c_custkey"], np.arange(len(c["c_custkey"])), -1)
    rows = []
    for i in big.tolist():
        ck, ok = int(o["o_custkey"][i]), int(o["o_orderkey"][i])
        rows.append((str(c["c_name"][c_row[ck]]), ck, ok,
                     int(o["o_orderdate"][i]), int(o["o_totalprice"][i]),
                     int(qty[ok])))
    rows.sort(key=lambda r: (-r[4], r[3], r[2]))
    return rows[:100]


def q21(data):
    """(s_name, numwait), first 100 by numwait desc, s_name."""
    s, li, o = data["supplier"], data["lineitem"], data["orders"]
    nsupp = int(s["s_suppkey"].max()) + 1
    norder = int(o["o_orderkey"].max()) + 1
    late = li["l_receiptdate"] > li["l_commitdate"]
    pair = li["l_orderkey"].astype(np.int64) * nsupp + li["l_suppkey"]
    # distinct suppliers per order, among all lineitems and the late ones
    supps = np.bincount(np.unique(pair) // nsupp, minlength=norder)
    late_supps = np.bincount(np.unique(pair[late]) // nsupp,
                             minlength=norder)
    saudi = _by_key(s["s_suppkey"], s["s_nationkey"]
                    == _nation_key(data, "SAUDI ARABIA"), False)
    f_order = _by_key(o["o_orderkey"], o["o_orderstatus"] == "F", False)
    ok = li["l_orderkey"]
    # another supplier in the order, and no other supplier late
    m = (late & saudi[li["l_suppkey"]] & f_order[ok]
         & (supps[ok] >= 2) & (late_supps[ok] == 1))
    supp, cnt = np.unique(li["l_suppkey"][m], return_counts=True)
    s_name = _by_key(s["s_suppkey"], s["s_name"], "")
    rows = [(str(s_name[k]), int(v)) for k, v in zip(supp.tolist(),
                                                     cnt.tolist())]
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows[:100]


def q22(data):
    """(cntrycode, numcust, totacctbal scale 2) by cntrycode; the average
    balance is a float, so the comparison with it is one too."""
    c, o = data["customer"], data["orders"]
    code = c["c_phone"].astype("U2")
    wanted = np.isin(code, ["13", "31", "23", "29", "30", "18", "17"])
    bal = c["c_acctbal"]
    rich = wanted & (bal > 0)
    avg = float(int(bal[rich].astype(object).sum())) / 100.0 / int(rich.sum())
    has_order = np.bincount(o["o_custkey"],
                            minlength=int(c["c_custkey"].max()) + 1) > 0
    m = wanted & (bal / 100.0 > avg) & ~has_order[c["c_custkey"]]
    return [(str(k), int((m & (code == k)).sum()),
             int(bal[m & (code == k)].sum()))
            for k in sorted(set(code[m].tolist()))]


#: query number -> oracle
ORACLES = {1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9,
           10: q10, 11: q11, 12: q12, 13: q13, 14: q14, 15: q15, 16: q16,
           17: q17, 18: q18, 19: q19, 20: q20, 21: q21, 22: q22}

#: query number -> kind of each result column: a decimal's scale (int),
#: "str", "int", "date" or "float"
KINDS = {
    1: ("str", "str", 2, 2, 4, 6, "float", "float", "float", "int"),
    2: (2, "str", "str", "int", "str", "str", "str", "str"),
    3: ("int", 4, "date", "int"),
    4: ("str", "int"),
    5: ("str", 4),
    6: (4,),
    7: ("str", "str", "int", 4),
    8: ("int", "float"),
    9: ("str", "int", 4),
    10: ("int", "str", 4, 2, "str", "str", "str", "str"),
    11: ("int", 2),
    12: ("str", "int", "int"),
    13: ("int", "int"),
    14: ("float",),
    15: ("int", "str", "str", "str", 4),
    16: ("str", "str", "int", "int"),
    17: ("float",),
    18: ("str", "int", "int", "date", 2, 2),
    19: (4,),
    20: ("str", "str"),
    21: ("str", "int"),
    22: ("str", "int", 2),
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


def expected(data, qids, device=None):
    """{query id: rows as SQL values} for the query ids ``qids`` ("1" to
    "22") over the generated tables ``data``."""
    return {q: decoded(int(q), ORACLES[int(q)](data)) for q in qids}


def _f32(v):
    """``v`` carried in float32: the nearest float32 value, returned in the
    type the reference gives (a Decimal keeps its exponent)."""
    if isinstance(v, bool) or v is None or isinstance(
            v, (str, datetime.date)):
        return v
    r = float(np.float32(float(v)))
    if isinstance(v, float):
        return r
    if isinstance(v, int):
        return int(r)
    return Decimal(r).quantize(v)


def control(data, qids, device=None, want=None):
    """The control: the reference's rows with every number carried in
    float32, the precision below the float64 the configuration states for
    its float aggregates.  Rounding each exact result once is the least
    error a float32 computation can make, so no float32 reference reads
    closer to the exact one than this.  ``want``: ``expected``'s rows, when
    the caller has them."""
    want = want if want is not None else expected(data, qids)
    return {q: [tuple(_f32(v) for v in r) for r in want[q]] for q in qids}
