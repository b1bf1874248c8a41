"""Deterministic TPC-H-shaped data generator (host side, vectorized numpy).

The reference ships the TPC-H *schema + queries + SF-1 answer oracles*
(sql/benchmarks/tpch/) but generates table data with the external dbgen
tool, which is not available here. This generator follows the TPC-H spec
formulas for keys, dates, prices and low-cardinality attributes (so
selectivities and join fan-outs are realistic) without reproducing dbgen's
exact RNG streams — correctness is validated against an independent numpy
oracle executor over the *same* generated data (tests/tpch_oracle.py),
mirroring how the reference validates against .ans files.

All randomness is a seeded PCG64 per (table, sf): same inputs ⇒ identical
data across runs and hosts.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["gen_tpch", "SCHEMA"]

EPOCH = np.datetime64("1970-01-01")


def _days(s: str) -> int:
    return int((np.datetime64(s) - EPOCH).astype(int))


START_DATE = _days("1992-01-01")
END_DATE = _days("1998-12-01")
CURRENT = _days("1995-06-17")

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
# TPC-H spec nation list: (name, regionkey)
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
INSTRUCTIONS = ["COLLECT COD", "DELIVER IN PERSON", "NONE",
                "TAKE BACK RETURN"]
P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
    "cornsilk", "cream", "cyan", "dark", "deep", "dim", "dodger", "drab",
    "firebrick", "floral", "forest", "frosted", "gainsboro", "ghost",
    "goldenrod", "green", "grey", "honeydew", "hot", "indian", "ivory",
    "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
    "magenta", "maroon", "medium", "metallic", "midnight", "mint", "misty",
    "moccasin", "navajo", "navy", "olive", "orange", "orchid", "pale",
    "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONT_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
# word soup for comments (Q13/Q16/Q19 patterns appear at controlled rates)
COMMENT_WORDS = np.array([
    "furiously", "carefully", "quickly", "blithely", "slyly", "ironic",
    "final", "bold", "regular", "express", "special", "pending", "даже"
    .replace("даже", "even"), "requests", "deposits", "packages", "accounts",
    "theodolites", "instructions", "dependencies", "foxes", "pinto", "beans",
    "ideas", "platelets", "excuses", "asymptotes", "courts", "dolphins",
    "multipliers", "sauternes", "warthogs", "frets", "dinos", "attainments",
    "somas", "Tiresias", "patterns", "forges", "braids", "hockey", "players",
    "frays", "warhorses", "dugouts", "notornis", "epitaphs", "pearls",
    "instructions", "dependencies", "customer", "complaints", "unusual",
])


def _comments(rng, n, nwords=6):
    idx = rng.integers(0, len(COMMENT_WORDS), size=(n, nwords))
    w = COMMENT_WORDS[idx]
    out = np.empty(n, dtype=object)
    for i in range(nwords):
        if i == 0:
            out[:] = w[:, 0]
        else:
            out = np.char.add(np.char.add(out.astype(str), " "), w[:, i])
    return out.astype(str)


def _decimal(x, scale=2):
    """float → scaled int64 (round half away from zero)."""
    return np.round(np.asarray(x) * 10 ** scale).astype(np.int64)


def gen_region() -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(1001)
    return {
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": np.array(REGIONS),
        "r_comment": _comments(rng, 5),
    }


def gen_nation() -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(1002)
    return {
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": np.array([n for n, _ in NATIONS]),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int32),
        "n_comment": _comments(rng, 25),
    }


def gen_supplier(sf: float) -> Dict[str, np.ndarray]:
    n = int(10_000 * sf)
    rng = np.random.default_rng(1003)
    k = np.arange(1, n + 1, dtype=np.int32)
    nat = rng.integers(0, 25, n).astype(np.int32)
    acct = rng.uniform(-999.99, 9999.99, n)
    comment = _comments(rng, n)
    # spec: 5 per SF*2 suppliers get "Customer...Complaints"/"Recommends"
    idx = rng.choice(n, size=max(1, n // 1000), replace=False)
    half = len(idx) // 2
    comment[idx[:half]] = "fluffy Customer Complaints sleep"
    comment[idx[half:]] = "bold Customer Recommends dolphins"
    return {
        "s_suppkey": k,
        "s_name": np.char.add("Supplier#", np.char.zfill(k.astype(str), 9)),
        "s_address": _comments(rng, n, 3),
        "s_nationkey": nat,
        "s_phone": _phones(nat),
        "s_acctbal": _decimal(acct),
        "s_comment": comment,
    }


def _phones(nat):
    cc = (nat + 10).astype(str)
    rng = np.random.default_rng(77)
    n = len(nat)
    a = rng.integers(100, 1000, n).astype(str)
    b = rng.integers(100, 1000, n).astype(str)
    c = rng.integers(1000, 10000, n).astype(str)
    return np.char.add(np.char.add(np.char.add(np.char.add(np.char.add(
        np.char.add(cc, "-"), a), "-"), b), "-"), c)


def gen_part(sf: float) -> Dict[str, np.ndarray]:
    n = int(200_000 * sf)
    rng = np.random.default_rng(1004)
    k = np.arange(1, n + 1, dtype=np.int32)
    w = np.array(P_NAME_WORDS)
    widx = rng.integers(0, len(w), size=(n, 5))
    name = w[widx[:, 0]]
    for i in range(1, 5):
        name = np.char.add(np.char.add(name, " "), w[widx[:, i]])
    m = rng.integers(1, 6, n)
    brand_n = rng.integers(1, 6, n)
    mfgr = np.char.add("Manufacturer#", m.astype(str))
    brand = np.char.add("Brand#", np.char.add(m.astype(str),
                                              brand_n.astype(str)))
    t1 = rng.integers(0, 6, n)
    t2 = rng.integers(0, 5, n)
    t3 = rng.integers(0, 5, n)
    ptype = np.char.add(np.char.add(np.array(TYPE_S1)[t1], " "),
                        np.char.add(np.char.add(np.array(TYPE_S2)[t2], " "),
                                    np.array(TYPE_S3)[t3]))
    c1 = rng.integers(0, 5, n)
    c2 = rng.integers(0, 8, n)
    container = np.char.add(np.char.add(np.array(CONT_S1)[c1], " "),
                            np.array(CONT_S2)[c2])
    # spec retail price formula
    kk = k.astype(np.int64)
    retail = (90000 + (kk // 10) % 20001 + 100 * (kk % 1000))  # cents
    return {
        "p_partkey": k,
        "p_name": name,
        "p_mfgr": mfgr,
        "p_brand": brand,
        "p_type": ptype,
        "p_size": rng.integers(1, 51, n).astype(np.int32),
        "p_container": container,
        "p_retailprice": retail.astype(np.int64),
        "p_comment": _comments(rng, n, 3),
    }


def gen_partsupp(sf: float, part: Dict[str, np.ndarray],
                 nsupp: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(1005)
    npart = len(part["p_partkey"])
    pk = np.repeat(part["p_partkey"], 4).astype(np.int32)
    i = np.tile(np.arange(4), npart)
    kk = pk.astype(np.int64)
    # spec supplier spread formula
    sk = ((kk + (i * ((nsupp // 4) + (kk - 1) // nsupp))) % nsupp + 1)
    return {
        "ps_partkey": pk,
        "ps_suppkey": sk.astype(np.int32),
        "ps_availqty": rng.integers(1, 10_000, len(pk)).astype(np.int32),
        "ps_supplycost": _decimal(rng.uniform(1.0, 1000.0, len(pk))),
        "ps_comment": _comments(rng, len(pk), 8),
    }


def gen_customer(sf: float) -> Dict[str, np.ndarray]:
    n = int(150_000 * sf)
    rng = np.random.default_rng(1006)
    k = np.arange(1, n + 1, dtype=np.int32)
    nat = rng.integers(0, 25, n).astype(np.int32)
    return {
        "c_custkey": k,
        "c_name": np.char.add("Customer#", np.char.zfill(k.astype(str), 9)),
        "c_address": _comments(rng, n, 3),
        "c_nationkey": nat,
        "c_phone": _phones(nat),
        "c_acctbal": _decimal(rng.uniform(-999.99, 9999.99, n)),
        "c_mktsegment": np.array(SEGMENTS)[rng.integers(0, 5, n)],
        "c_comment": _comments(rng, n, 8),
    }


def gen_orders(sf: float, ncust: int) -> Dict[str, np.ndarray]:
    n = int(1_500_000 * sf)
    rng = np.random.default_rng(1007)
    k = np.arange(1, n + 1, dtype=np.int64)
    # spec: orderkeys are sparse (8 of each 32) — keep dense for round 1,
    # PK-density enables the fetchjoin fast path, values differ from dbgen
    cust = rng.integers(1, ncust + 1, n).astype(np.int32)
    # spec: customers with custkey % 3 == 0 place no orders
    cust = np.where(cust % 3 == 0, np.maximum(cust - 1, 1), cust)
    odate = rng.integers(START_DATE, END_DATE - 151 + 1, n).astype(np.int32)
    total = _decimal(rng.uniform(850.0, 560_000.0, n))
    return {
        "o_orderkey": k.astype(np.int32),
        "o_custkey": cust,
        "o_orderstatus": np.full(n, "O"),  # fixed up after lineitem gen
        "o_totalprice": total,
        "o_orderdate": odate,
        "o_orderpriority": np.array(PRIORITIES)[rng.integers(0, 5, n)],
        "o_clerk": np.char.add("Clerk#", np.char.zfill(
            rng.integers(1, max(2, int(1000 * sf)) + 1, n).astype(str), 9)),
        "o_shippriority": np.zeros(n, dtype=np.int32),
        "o_comment": _comments(rng, n, 8),
    }


def gen_lineitem(sf: float, orders: Dict[str, np.ndarray], npart: int,
                 nsupp: int, part_retail: np.ndarray):
    rng = np.random.default_rng(1008)
    norders = len(orders["o_orderkey"])
    nlines = rng.integers(1, 8, norders)
    okey = np.repeat(orders["o_orderkey"], nlines)
    odate = np.repeat(orders["o_orderdate"], nlines)
    n = len(okey)
    linenumber = (np.arange(n, dtype=np.int64) -
                  np.repeat(np.cumsum(nlines) - nlines, nlines) + 1)
    pk = rng.integers(1, npart + 1, n).astype(np.int32)
    i = rng.integers(0, 4, n)
    kk = pk.astype(np.int64)
    sk = ((kk + (i * ((nsupp // 4) + (kk - 1) // nsupp))) % nsupp + 1)
    qty = rng.integers(1, 51, n).astype(np.int64)
    # extendedprice = qty * p_retailprice (cents)
    extp = qty * part_retail[pk - 1]
    disc = rng.integers(0, 11, n).astype(np.int64)       # scale-2: 0.00-0.10
    tax = rng.integers(0, 9, n).astype(np.int64)         # scale-2: 0.00-0.08
    sdate = odate + rng.integers(1, 122, n).astype(np.int32)
    cdate = odate + rng.integers(30, 91, n).astype(np.int32)
    rdate = sdate + rng.integers(1, 31, n).astype(np.int32)
    returnflag = np.where(rdate <= CURRENT,
                          np.where(rng.random(n) < 0.5, "R", "A"), "N")
    linestatus = np.where(sdate > CURRENT, "O", "F")
    li = {
        "l_orderkey": okey,
        "l_partkey": pk,
        "l_suppkey": sk.astype(np.int32),
        "l_linenumber": linenumber.astype(np.int32),
        "l_quantity": _decimal(qty, 0) * 100,            # decimal(15,2)
        "l_extendedprice": extp,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": sdate,
        "l_commitdate": cdate,
        "l_receiptdate": rdate,
        "l_shipinstruct": np.array(INSTRUCTIONS)[rng.integers(0, 4, n)],
        "l_shipmode": np.array(SHIPMODES)[rng.integers(0, 7, n)],
        "l_comment": _comments(rng, n, 4),
    }
    # orderstatus: F if all lines F, O if all O, else P
    all_f = np.ones(norders, bool)
    any_f = np.zeros(norders, bool)
    oidx = np.repeat(np.arange(norders), nlines)
    isf = linestatus == "F"
    np.logical_and.at(all_f, oidx, isf)
    np.logical_or.at(any_f, oidx, isf)
    status = np.where(all_f, "F", np.where(any_f, "P", "O"))
    return li, status


# column name → (logical type tag, scale) for the loader
SCHEMA = {
    "region": {"r_regionkey": "i32", "r_name": "str", "r_comment": "str"},
    "nation": {"n_nationkey": "i32", "n_name": "str", "n_regionkey": "i32",
               "n_comment": "str"},
    "supplier": {"s_suppkey": "i32", "s_name": "str", "s_address": "str",
                 "s_nationkey": "i32", "s_phone": "str",
                 "s_acctbal": "dec2", "s_comment": "str"},
    "part": {"p_partkey": "i32", "p_name": "str", "p_mfgr": "str",
             "p_brand": "str", "p_type": "str", "p_size": "i32",
             "p_container": "str", "p_retailprice": "dec2",
             "p_comment": "str"},
    "partsupp": {"ps_partkey": "i32", "ps_suppkey": "i32",
                 "ps_availqty": "i32", "ps_supplycost": "dec2",
                 "ps_comment": "str"},
    "customer": {"c_custkey": "i32", "c_name": "str", "c_address": "str",
                 "c_nationkey": "i32", "c_phone": "str", "c_acctbal": "dec2",
                 "c_mktsegment": "str", "c_comment": "str"},
    "orders": {"o_orderkey": "i32", "o_custkey": "i32",
               "o_orderstatus": "str", "o_totalprice": "dec2",
               "o_orderdate": "date", "o_orderpriority": "str",
               "o_clerk": "str", "o_shippriority": "i32",
               "o_comment": "str"},
    "lineitem": {"l_orderkey": "i32", "l_partkey": "i32", "l_suppkey": "i32",
                 "l_linenumber": "i32", "l_quantity": "dec2",
                 "l_extendedprice": "dec2", "l_discount": "dec2",
                 "l_tax": "dec2", "l_returnflag": "str",
                 "l_linestatus": "str", "l_shipdate": "date",
                 "l_commitdate": "date", "l_receiptdate": "date",
                 "l_shipinstruct": "str", "l_shipmode": "str",
                 "l_comment": "str"},
}


def gen_tpch(sf: float = 0.01, cache: bool = None) \
        -> Dict[str, Dict[str, np.ndarray]]:
    """Generate all 8 tables at scale factor sf.  Large scale factors are
    cached on disk (deterministic generator, so the cache is pure); set
    cache=False to force regeneration."""
    if cache is None:
        cache = sf >= 0.5
    if cache:
        import os
        import tempfile
        path = os.path.join(tempfile.gettempdir(),
                            f"mtpu_tpch_sf{sf}_v1.npz")
        if os.path.exists(path):
            try:
                z = np.load(path, allow_pickle=False)
                out: Dict[str, Dict[str, np.ndarray]] = {}
                for k in z.files:
                    t, c = k.split("::", 1)
                    out.setdefault(t, {})[c] = z[k]
                return out
            except Exception:
                pass
        data = gen_tpch(sf, cache=False)
        try:
            flat = {f"{t}::{c}": a for t, cols in data.items()
                    for c, a in cols.items()}
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **flat)
            os.replace(tmp, path)
        except Exception:
            pass
        return data
    region = gen_region()
    nation = gen_nation()
    supplier = gen_supplier(sf)
    part = gen_part(sf)
    partsupp = gen_partsupp(sf, part, len(supplier["s_suppkey"]))
    customer = gen_customer(sf)
    orders = gen_orders(sf, len(customer["c_custkey"]))
    lineitem, ostatus = gen_lineitem(sf, orders, len(part["p_partkey"]),
                                     len(supplier["s_suppkey"]),
                                     part["p_retailprice"])
    orders["o_orderstatus"] = ostatus
    return {"region": region, "nation": nation, "supplier": supplier,
            "part": part, "partsupp": partsupp, "customer": customer,
            "orders": orders, "lineitem": lineitem}
