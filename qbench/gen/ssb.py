"""Star Schema Benchmark data for the benchmark, seeded by the run's
``--seed``.

The tables and cardinalities of SSB rev. 3 (O'Neil, O'Neil, Chen; "Star
Schema Benchmark", section 2): ``lineorder`` (``rows.lineorder`` rows, all
17 columns), ``customer`` 30,000 x SF, ``supplier`` 2,000 x SF, ``part``
200,000 x floor(1 + log2 SF), and the date dimension, one row a day of
1992-1998 (named ``dates``: ``date`` is a type name in SQL).  Value
distributions follow the TPC-H dbgen rules SSB inherits; what the spec
leaves open is listed under ``assumed`` in the configuration file.

``lineorder`` is made on the device in a few large calls, one
``torch.Generator`` stream a column, seeded from the run seed and the
column's name, so set-up does not draw 120 M values on the host.  The
dimensions are small and made on the host with numpy's PCG64, seeded the
same way.  String columns of ``lineorder`` come as ``Coded``: int32 codes
over their sorted dictionary.  Numeric columns are int32, the width of the
spec's INTEGER columns.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict

import numpy as np
import torch

__all__ = ["Coded", "generate", "for_reference", "stream_seed"]

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
#: (nation, region index), the TPC-H nation list SSB inherits
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
MONTHS = ["January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December"]
DAYS = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday",
        "Sunday"]
COLORS = [
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
_ALNUM = np.frombuffer(
    b"0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ",
    dtype=np.uint8)

#: an order's dates: order date in [first day, last day - 151] (TPC-H's
#: ENDDATE - 151), commit date 30-90 days after it
_ORDER_SPAN_CUT = 151


@dataclasses.dataclass
class Coded:
    """A string column as int32 codes (rank in ``values``) over its sorted
    dictionary ``values``."""

    codes: object            # torch.Tensor or np.ndarray of int32
    values: np.ndarray


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of run seed ``seed``."""
    h = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _host_rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, name))


def _cat(*parts) -> np.ndarray:
    out = np.asarray(parts[0])
    for p in parts[1:]:
        out = np.char.add(out, p)
    return out


def _pick(words, idx) -> np.ndarray:
    return np.asarray(words)[idx]


def _alnum(rng, n: int, lo: int, hi: int) -> np.ndarray:
    """n random alphanumeric strings of lo..hi characters."""
    length = rng.integers(lo, hi + 1, n)
    b = _ALNUM[rng.integers(0, len(_ALNUM), (n, hi))]
    b[np.arange(hi)[None, :] >= length[:, None]] = 0
    return b.view(f"S{hi}").reshape(n).astype(f"U{hi}")


def _phones(rng, nation: np.ndarray) -> np.ndarray:
    n = len(nation)
    return _cat((nation + 10).astype(str), "-",
                rng.integers(100, 1000, n).astype(str), "-",
                rng.integers(100, 1000, n).astype(str), "-",
                rng.integers(1000, 10000, n).astype(str))


def _geo(rng, n: int):
    """(nation key, city, nation, region) of n customers or suppliers."""
    nk = rng.integers(0, len(NATIONS), n)
    names = np.array([na for na, _ in NATIONS])
    region = np.array([REGIONS[r] for _, r in NATIONS])[nk]
    prefix = np.array([f"{na[:9]:<9}" for na, _ in NATIONS])[nk]
    city = _cat(prefix, rng.integers(0, 10, n).astype(str))
    return nk, city, names[nk], region


def _customer(sf: float, seed: int) -> Dict[str, np.ndarray]:
    n = int(30_000 * sf)
    rng = _host_rng(seed, "customer")
    k = np.arange(1, n + 1)
    nk, city, nation, region = _geo(rng, n)
    return {
        "c_custkey": k.astype(np.int32),
        "c_name": _cat("Customer#", np.char.zfill(k.astype(str), 9)),
        "c_address": _alnum(rng, n, 10, 25),
        "c_city": city, "c_nation": nation, "c_region": region,
        "c_phone": _phones(rng, nk),
        "c_mktsegment": _pick(SEGMENTS, rng.integers(0, 5, n)),
    }


def _supplier(sf: float, seed: int) -> Dict[str, np.ndarray]:
    n = int(2_000 * sf)
    rng = _host_rng(seed, "supplier")
    k = np.arange(1, n + 1)
    nk, city, nation, region = _geo(rng, n)
    return {
        "s_suppkey": k.astype(np.int32),
        "s_name": _cat("Supplier#", np.char.zfill(k.astype(str), 9)),
        "s_address": _alnum(rng, n, 10, 25),
        "s_city": city, "s_nation": nation, "s_region": region,
        "s_phone": _phones(rng, nk),
    }


def part_rows(sf: float) -> int:
    """200,000 x floor(1 + log2 SF) (SSB rev. 3 section 2.2)."""
    return int(200_000 * math.floor(1 + math.log2(sf))) if sf >= 1 else \
        int(200_000 * sf)


def _part(sf: float, seed: int) -> Dict[str, np.ndarray]:
    n = part_rows(sf)
    rng = _host_rng(seed, "part")
    k = np.arange(1, n + 1)
    mfgr = rng.integers(1, 6, n).astype(str)
    cat = _cat("MFGR#", mfgr, rng.integers(1, 6, n).astype(str))
    brand = _cat(cat, np.char.zfill(rng.integers(1, 41, n).astype(str), 2))
    c = rng.integers(0, len(COLORS), (n, 2))
    return {
        "p_partkey": k.astype(np.int32),
        "p_name": _cat(_pick(COLORS, c[:, 0]), " ", _pick(COLORS, c[:, 1])),
        "p_mfgr": _cat("MFGR#", mfgr),
        "p_category": cat,
        "p_brand1": brand,
        "p_color": _pick(COLORS, rng.integers(0, len(COLORS), n)),
        "p_type": _cat(_pick(TYPE_S1, rng.integers(0, 6, n)), " ",
                       _pick(TYPE_S2, rng.integers(0, 5, n)), " ",
                       _pick(TYPE_S3, rng.integers(0, 5, n))),
        "p_size": rng.integers(1, 51, n).astype(np.int32),
        "p_container": _cat(_pick(CONT_S1, rng.integers(0, 5, n)), " ",
                            _pick(CONT_S2, rng.integers(0, 8, n))),
    }


def _season(m: np.ndarray, d: np.ndarray) -> np.ndarray:
    out = np.full(len(m), "Winter", dtype="U12")
    out[(m >= 3) & (m <= 5)] = "Spring"
    out[(m >= 6) & (m <= 8)] = "Summer"
    out[(m >= 9) & (m <= 11)] = "Fall"
    out[(m == 12) & (d >= 1) & (d <= 24)] = "Christmas"
    return out


def _dates() -> Dict[str, np.ndarray]:
    """One row a day of 1992-1998 (no randomness)."""
    days = np.arange(np.datetime64("1992-01-01"), np.datetime64("1999-01-01"))
    y = days.astype("datetime64[Y]").astype(int) + 1970
    m = days.astype("datetime64[M]").astype(int) % 12 + 1
    d = (days - days.astype("datetime64[M]")).astype(int) + 1
    doy = (days - days.astype("datetime64[Y]")).astype(int)
    dow = (days.astype(int) + 3) % 7          # 1970-01-01 was a Thursday
    nxt = days + 1
    last_month = nxt.astype("datetime64[M]") != days.astype("datetime64[M]")
    holiday = ((m == 1) & (d == 1)) | ((m == 7) & (d == 4)) | \
        ((m == 12) & (d == 25))
    i32 = np.int32
    month = np.array(MONTHS)[m - 1]
    return {
        "d_datekey": (y * 10000 + m * 100 + d).astype(i32),
        "d_date": _cat(month, " ", d.astype(str), ", ", y.astype(str)),
        "d_dayofweek": np.array(DAYS)[dow],
        "d_month": month,
        "d_year": y.astype(i32),
        "d_yearmonthnum": (y * 100 + m).astype(i32),
        "d_yearmonth": _cat(np.char.ljust(month, 3).astype("U3"),
                            y.astype(str)),
        "d_daynuminweek": ((dow + 1) % 7 + 1).astype(i32),  # Sunday = 1
        "d_daynuminmonth": d.astype(i32),
        "d_daynuminyear": (doy + 1).astype(i32),
        "d_monthnuminyear": m.astype(i32),
        "d_weeknuminyear": (doy // 7 + 1).astype(i32),
        "d_sellingseason": _season(m, d),
        "d_lastdayinweekfl": (dow == 5).astype(i32),        # Saturday
        "d_lastdayinmonthfl": last_month.astype(i32),
        "d_holidayfl": holiday.astype(i32),
        "d_weekdayfl": (dow < 5).astype(i32),
    }


def _gen(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, "lineorder." + name))
    return g


def _randint(lo: int, hi: int, n: int, seed: int, name: str, device,
             dtype=torch.int32) -> torch.Tensor:
    """n values uniform in [lo, hi] from the stream ``name``."""
    return torch.randint(lo, hi + 1, (n,), generator=_gen(seed, name, device),
                         device=device, dtype=dtype)


def _lineorder(n: int, ncust: int, npart: int, nsupp: int,
               datekeys: np.ndarray, seed: int, device) -> dict:
    """The fact table: orders of 1-7 lines (the last one cut so that the
    table has exactly n rows), every column made on ``device``."""
    i32, i64 = torch.int32, torch.int64
    norders = n // 4 + n // 64 + 64
    nlines = _randint(1, 7, norders, seed, "nlines", device, i64)
    ends = torch.cumsum(nlines, 0)
    used = int(torch.searchsorted(ends, torch.tensor(n, device=device)))
    if used >= norders:
        raise ValueError("lineorder: too few orders drawn")
    nlines = nlines[:used + 1].clone()
    nlines[used] -= int(ends[used]) - n
    order = torch.repeat_interleave(
        torch.arange(used + 1, device=device), nlines, output_size=n)
    starts = torch.cumsum(nlines, 0) - nlines
    linenumber = (torch.arange(n, device=device) - starts[order] + 1)
    no = used + 1
    span = len(datekeys) - _ORDER_SPAN_CUT
    oday = _randint(0, span - 1, no, seed, "orderdate", device, i64)[order]
    keys = torch.from_numpy(datekeys.astype(np.int64)).to(device)
    cday = oday + _randint(30, 90, n, seed, "commitdate", device, i64)
    pk = _randint(1, npart, n, seed, "partkey", device, i64)
    retail = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1_000)   # cents
    qty = _randint(1, 50, n, seed, "quantity", device, i64)
    disc = _randint(0, 10, n, seed, "discount", device, i64)
    tax = _randint(0, 8, n, seed, "tax", device, i64)
    extp = qty * retail
    charge = extp * (100 - disc) * (100 + tax) // 10_000
    total = torch.zeros(no, dtype=i64, device=device)
    total.index_add_(0, order, charge)
    del charge
    prio = _randint(0, len(PRIORITIES) - 1, no, seed, "orderpriority",
                    device)[order]
    cust = _randint(1, ncust, no, seed, "custkey", device)[order]
    out = {
        "lo_orderkey": (order + 1).to(i32),
        "lo_linenumber": linenumber.to(i32),
        "lo_custkey": cust,
        "lo_partkey": pk.to(i32),
        "lo_suppkey": _randint(1, nsupp, n, seed, "suppkey", device),
        "lo_orderdate": keys[oday].to(i32),
        "lo_orderpriority": Coded(prio, np.array(PRIORITIES)),
        "lo_shippriority": Coded(torch.zeros(n, dtype=i32, device=device),
                                 np.array(["0"])),
        "lo_quantity": qty.to(i32),
        "lo_extendedprice": extp.to(i32),
        "lo_ordtotalprice": total[order].to(i32),
        "lo_discount": disc.to(i32),
        "lo_revenue": (extp * (100 - disc) // 100).to(i32),
        "lo_supplycost": (6 * retail // 10).to(i32),
        "lo_tax": tax.to(i32),
        "lo_commitdate": keys[cday].to(i32),
        "lo_shipmode": Coded(_randint(0, len(SHIPMODES) - 1, n, seed,
                                      "shipmode", device),
                             np.array(SHIPMODES)),
    }
    return out


def generate(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """The configuration's five tables: ``lineorder`` on ``device``, the
    dimensions as host numpy arrays."""
    sf = float(cfg["scale_factor"])
    dates = _dates()
    customer = _customer(sf, seed)
    supplier = _supplier(sf, seed)
    part = _part(sf, seed)
    lineorder = _lineorder(int(cfg["rows"]["lineorder"]),
                           len(customer["c_custkey"]), len(part["p_partkey"]),
                           len(supplier["s_suppkey"]), dates["d_datekey"],
                           seed, device)
    return {"lineorder": lineorder, "customer": customer,
            "supplier": supplier, "part": part, "dates": dates}


def for_reference(data, cfg: dict, seed: int, device) -> Dict[str, dict]:
    """The data the reference reads: made again from the seed, because the
    entry handed the device columns of ``data`` to the program."""
    return generate(cfg, seed, device)
