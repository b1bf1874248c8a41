"""Independent numpy oracle for the 13 SSBM queries over ``gen_ssbm``'s
arrays.

The rows each query of ``bench/ssbm.py`` must give, computed without the
engine and without SQL: every dimension key is dense (``c_custkey``,
``s_suppkey`` and ``p_partkey`` are ``1..n``; ``d_datekey`` is sorted), so
each join is an array index, and a group-by is ``np.unique`` over a packed
key with an exact int64 ``np.add.at``.  Rows come in the query's ORDER BY
order; Q1.x have no ORDER BY and give one row (``None`` over no rows, as
SQL's ``sum``).  Values are Python ints and strs, as the engine's rows.
Needs nothing but numpy (sqlite3 at SF1 takes minutes a query).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["expected", "ORDERED"]

# Queries with an ORDER BY: compare in order; the others sorted.
ORDERED = frozenset({"2.1", "2.2", "2.3", "3.1", "3.2", "3.3", "3.4",
                     "4.1", "4.2", "4.3"})

_KEYS = {"customer": ("lo_custkey", "c_custkey"),
         "supplier": ("lo_suppkey", "s_suppkey"),
         "part": ("lo_partkey", "p_partkey")}


class _Star:
    """The lineorder fact rows with each one's row in every dimension
    (-1 where the key has no dimension row: the inner join drops it)."""

    def __init__(self, data):
        self.data = data
        lo = data["lineorder"]
        self.lo = lo
        self.row = {}
        for dim, (fk, pk) in _KEYS.items():
            keys = data[dim][pk]
            if not np.array_equal(keys, np.arange(1, len(keys) + 1)):
                raise ValueError(f"{dim}.{pk} is not dense 1..n")
            i = lo[fk] - 1
            self.row[dim] = np.where((i >= 0) & (i < len(keys)), i, -1)
        dk = data["dates"]["d_datekey"]
        if np.any(np.diff(dk) <= 0):
            raise ValueError("dates.d_datekey is not sorted and unique")
        i = np.minimum(np.searchsorted(dk, lo["lo_orderdate"]), len(dk) - 1)
        self.row["dates"] = np.where(dk[i] == lo["lo_orderdate"], i, -1)

    def rows(self, dim_pred: Dict[str, np.ndarray],
             lo_pred: Optional[np.ndarray] = None) -> np.ndarray:
        """Indices of the fact rows that join every dimension of
        ``dim_pred`` (a mask over that dimension's rows) and pass
        ``lo_pred``."""
        m = np.ones(len(self.lo["lo_orderkey"]), bool) if lo_pred is None \
            else lo_pred.copy()
        for dim, pred in dim_pred.items():
            r = self.row[dim]
            m &= (r >= 0) & pred[np.maximum(r, 0)]
        return np.flatnonzero(m)


def _grouped(star: _Star, sel: np.ndarray, value: np.ndarray,
             groups: Sequence[Tuple[str, str]], select: Sequence,
             order: Callable) -> List[tuple]:
    """sum(value) over ``sel`` grouped by dimension columns; ``select``
    lists the output columns as indices into ``groups`` or "sum"."""
    codes, dicts = [], []
    for dim, col in groups:
        d, inv = np.unique(star.data[dim][col], return_inverse=True)
        codes.append(inv.reshape(-1)[star.row[dim][sel]].astype(np.int64))
        dicts.append(d)
    key = np.zeros(len(sel), np.int64)
    for c, d in zip(codes, dicts):
        key = key * len(d) + c
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv.reshape(-1), value[sel].astype(np.int64))
    cols = []
    rest = uniq
    for d in reversed(dicts):
        cols.append(d[rest % len(d)])
        rest = rest // len(d)
    cols.reverse()
    out = []
    for g in range(len(uniq)):
        out.append(tuple(int(sums[g]) if s == "sum" else _py(cols[s][g])
                         for s in select))
    return sorted(out, key=order)


def _py(v):
    return int(v) if isinstance(v, np.integer) else str(v)


def _scalar(value: np.ndarray, sel: np.ndarray) -> List[tuple]:
    return [(int(value[sel].astype(np.int64).sum()) if len(sel) else None,)]


def _between(a, lo, hi):
    return (a >= lo) & (a <= hi)


def expected(data) -> Dict[str, List[tuple]]:
    """{query id: rows} for the 13 queries of ``bench.ssbm.QUERIES``."""
    s = _Star(data)
    lo, d = s.lo, data["dates"]
    c, su, p = data["customer"], data["supplier"], data["part"]
    disc, qty = lo["lo_discount"], lo["lo_quantity"]
    q1v = lo["lo_extendedprice"] * disc
    rev = lo["lo_revenue"]
    profit = rev - lo["lo_supplycost"]
    out = {}

    out["1.1"] = _scalar(q1v, s.rows(
        {"dates": d["d_year"] == 1993},
        _between(disc, 1, 3) & (qty < 25)))
    out["1.2"] = _scalar(q1v, s.rows(
        {"dates": d["d_yearmonthnum"] == 199401},
        _between(disc, 4, 6) & _between(qty, 26, 35)))
    out["1.3"] = _scalar(q1v, s.rows(
        {"dates": (d["d_weeknuminyear"] == 6) & (d["d_year"] == 1994)},
        _between(disc, 5, 7) & _between(qty, 26, 35)))

    q2_groups = [("dates", "d_year"), ("part", "p_brand1")]
    q2_order = lambda r: (r[1], r[2])  # noqa: E731
    for qid, part_pred, region in (
            ("2.1", p["p_category"] == "MFGR#12", "AMERICA"),
            ("2.2", _between(p["p_brand1"], "MFGR#2221", "MFGR#2228"),
             "ASIA"),
            ("2.3", p["p_brand1"] == "MFGR#2239", "EUROPE")):
        sel = s.rows({"dates": np.ones(len(d["d_datekey"]), bool),
                      "part": part_pred,
                      "supplier": su["s_region"] == region})
        out[qid] = _grouped(s, sel, rev, q2_groups, ["sum", 0, 1], q2_order)

    q3_order = lambda r: (r[2], -r[3], r[0], r[1])  # noqa: E731
    years = _between(d["d_year"], 1992, 1997)
    ki = ("UNITED KI1", "UNITED KI5")
    for qid, cp, sp, dp, level in (
            ("3.1", c["c_region"] == "ASIA", su["s_region"] == "ASIA",
             years, "nation"),
            ("3.2", c["c_nation"] == "UNITED STATES",
             su["s_nation"] == "UNITED STATES", years, "city"),
            ("3.3", np.isin(c["c_city"], ki), np.isin(su["s_city"], ki),
             years, "city"),
            ("3.4", np.isin(c["c_city"], ki), np.isin(su["s_city"], ki),
             d["d_yearmonth"] == "Dec1997", "city")):
        sel = s.rows({"customer": cp, "supplier": sp, "dates": dp})
        out[qid] = _grouped(
            s, sel, rev, [("customer", f"c_{level}"),
                          ("supplier", f"s_{level}"), ("dates", "d_year")],
            [0, 1, 2, "sum"], q3_order)

    america = {"customer": c["c_region"] == "AMERICA",
               "supplier": su["s_region"] == "AMERICA"}
    mfgr12 = np.isin(p["p_mfgr"], ("MFGR#1", "MFGR#2"))
    y9798 = np.isin(d["d_year"], (1997, 1998))
    sel = s.rows({**america, "part": mfgr12,
                  "dates": np.ones(len(d["d_datekey"]), bool)})
    out["4.1"] = _grouped(s, sel, profit,
                          [("dates", "d_year"), ("customer", "c_nation")],
                          [0, 1, "sum"], lambda r: (r[0], r[1]))
    sel = s.rows({**america, "part": mfgr12, "dates": y9798})
    out["4.2"] = _grouped(s, sel, profit,
                          [("dates", "d_year"), ("supplier", "s_nation"),
                           ("part", "p_category")],
                          [0, 1, 2, "sum"], lambda r: (r[0], r[1], r[2]))
    sel = s.rows({"customer": np.ones(len(c["c_custkey"]), bool),
                  "supplier": su["s_nation"] == "UNITED STATES",
                  "part": p["p_category"] == "MFGR#14", "dates": y9798})
    out["4.3"] = _grouped(s, sel, profit,
                          [("dates", "d_year"), ("supplier", "s_city"),
                           ("part", "p_brand1")],
                          [0, 1, 2, "sum"], lambda r: (r[0], r[1], r[2]))
    return out

