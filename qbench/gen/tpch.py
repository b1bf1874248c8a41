"""TPC-H-shaped data for the benchmark: a frozen copy of the port's
generator, seeded by the run's ``--seed``.

Copied from ``monetdb_tpu_torch/bench/tpch_gen.py`` at commit
71cd943e8ae6973a2cc337c895a48cca15b0d751 so that later changes to the
program's bench modules leave the yardstick as it is.  Changes from that
copy: every per-table PCG64 stream (and the phone-number stream) is seeded
by ``[table seed, run seed]`` instead of the table seed alone, the on-disk
cache and the schema table are gone (the configuration file holds the
schema), and ``generate`` / ``for_reference`` are the harness's entry
points.  The distributions are the original's: TPC-H spec formulas for
keys, dates, prices and low-cardinality attributes, dense order keys, and
comments drawn from a fixed word list.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["gen_tpch", "generate", "for_reference"]

#: run seeds are reduced to 64 bits before they enter a seed sequence
_SEED_MASK = (1 << 64) - 1


def _rng(stream: int, seed: int) -> np.random.Generator:
    """The PCG64 stream of one table for one run seed."""
    return np.random.default_rng([stream, seed & _SEED_MASK])

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


def gen_region(seed: int) -> Dict[str, np.ndarray]:
    rng = _rng(1001, seed)
    return {
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": np.array(REGIONS),
        "r_comment": _comments(rng, 5),
    }


def gen_nation(seed: int) -> Dict[str, np.ndarray]:
    rng = _rng(1002, seed)
    return {
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": np.array([n for n, _ in NATIONS]),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int32),
        "n_comment": _comments(rng, 25),
    }


def gen_supplier(sf: float, seed: int) -> Dict[str, np.ndarray]:
    n = int(10_000 * sf)
    rng = _rng(1003, seed)
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
        "s_phone": _phones(nat, seed),
        "s_acctbal": _decimal(acct),
        "s_comment": comment,
    }


def _phones(nat, seed: int):
    cc = (nat + 10).astype(str)
    rng = _rng(77, seed)
    n = len(nat)
    a = rng.integers(100, 1000, n).astype(str)
    b = rng.integers(100, 1000, n).astype(str)
    c = rng.integers(1000, 10000, n).astype(str)
    return np.char.add(np.char.add(np.char.add(np.char.add(np.char.add(
        np.char.add(cc, "-"), a), "-"), b), "-"), c)


def gen_part(sf: float, seed: int) -> Dict[str, np.ndarray]:
    n = int(200_000 * sf)
    rng = _rng(1004, seed)
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
                 nsupp: int, seed: int) -> Dict[str, np.ndarray]:
    rng = _rng(1005, seed)
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


def gen_customer(sf: float, seed: int) -> Dict[str, np.ndarray]:
    n = int(150_000 * sf)
    rng = _rng(1006, seed)
    k = np.arange(1, n + 1, dtype=np.int32)
    nat = rng.integers(0, 25, n).astype(np.int32)
    return {
        "c_custkey": k,
        "c_name": np.char.add("Customer#", np.char.zfill(k.astype(str), 9)),
        "c_address": _comments(rng, n, 3),
        "c_nationkey": nat,
        "c_phone": _phones(nat, seed),
        "c_acctbal": _decimal(rng.uniform(-999.99, 9999.99, n)),
        "c_mktsegment": np.array(SEGMENTS)[rng.integers(0, 5, n)],
        "c_comment": _comments(rng, n, 8),
    }


def gen_orders(sf: float, ncust: int, seed: int) -> Dict[str, np.ndarray]:
    n = int(1_500_000 * sf)
    rng = _rng(1007, seed)
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
                 nsupp: int, part_retail: np.ndarray, seed: int):
    rng = _rng(1008, seed)
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


def gen_tpch(sf: float, seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """All 8 tables at scale factor ``sf`` for run seed ``seed``."""
    region = gen_region(seed)
    nation = gen_nation(seed)
    supplier = gen_supplier(sf, seed)
    part = gen_part(sf, seed)
    partsupp = gen_partsupp(sf, part, len(supplier["s_suppkey"]), seed)
    customer = gen_customer(sf, seed)
    orders = gen_orders(sf, len(customer["c_custkey"]), seed)
    lineitem, ostatus = gen_lineitem(sf, orders, len(part["p_partkey"]),
                                     len(supplier["s_suppkey"]),
                                     part["p_retailprice"], seed)
    orders["o_orderstatus"] = ostatus
    return {"region": region, "nation": nation, "supplier": supplier,
            "part": part, "partsupp": partsupp, "customer": customer,
            "orders": orders, "lineitem": lineitem}


def generate(cfg: dict, seed: int,
             device=None) -> Dict[str, Dict[str, np.ndarray]]:
    """The configuration's tables as host numpy arrays (``device`` is not
    used: the entry uploads them)."""
    return gen_tpch(float(cfg["scale_factor"]), seed)


def for_reference(data, cfg: dict, seed: int, device=None):
    """The data the reference reads: the same host arrays, which the entry
    only copied from."""
    return data
