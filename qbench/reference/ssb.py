"""The plain reference for the 13 SSB queries, in PyTorch on the run's
device.

The same answers as the port's numpy oracle ``bench/ssbm_oracle.py``
(commit 71cd943e8ae6973a2cc337c895a48cca15b0d751), whose plan it follows:
every dimension key is dense (``c_custkey``, ``s_suppkey``, ``p_partkey``
are 1..n) or sorted (``d_datekey``), so each join is an index; a group-by
packs its dimension codes into one dense slot number and sums into the
slots.  Written in torch so that 120 M fact rows take seconds, in blocks of
rows so that it fits beside nothing else; it imports nothing of the
program.  Sums are exact int64.  ``control`` is the same computation with
float32 sums, the precision below.

Rows come in the query's ORDER BY order; Q1.x give one row (``None`` over
no rows, as SQL's ``sum``).  Values are Python ints and strs.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

__all__ = ["expected", "control", "BLOCK"]

#: fact rows a block
BLOCK = 1 << 24

_FK = {"customer": ("lo_custkey", "c_custkey"),
       "supplier": ("lo_suppkey", "s_suppkey"),
       "part": ("lo_partkey", "p_partkey")}


def _isin(a: np.ndarray, vals) -> np.ndarray:
    return np.isin(a, list(vals))


def _between(a, lo, hi):
    return (a >= lo) & (a <= hi)


class _Star:
    """Dimension masks and codes on the device, and the fact columns."""

    def __init__(self, data, device):
        self.data, self.device = data, device
        self.lo = data["lineorder"]
        self.n = int(self.lo["lo_orderkey"].shape[0])
        for dim, (_fk, pk) in _FK.items():
            keys = np.asarray(data[dim][pk])
            if not np.array_equal(keys, np.arange(1, len(keys) + 1)):
                raise ValueError(f"{dim}.{pk} is not dense 1..n")
        dk = np.asarray(data["dates"]["d_datekey"])
        if np.any(np.diff(dk) <= 0):
            raise ValueError("dates.d_datekey is not sorted and unique")
        self.datekeys = torch.from_numpy(dk.astype(np.int64)).to(device)

    def rows(self, dim: str, sl: slice) -> torch.Tensor:
        """Each fact row's row in ``dim`` (-1 where the key has none)."""
        if dim == "dates":
            k = self.lo["lo_orderdate"][sl].to(torch.int64)
            i = torch.searchsorted(self.datekeys, k).clamp_(
                max=len(self.datekeys) - 1)
            return torch.where(self.datekeys[i] == k, i, -1)
        fk = self.lo[_FK[dim][0]][sl].to(torch.int64) - 1
        n = len(self.data[dim][_FK[dim][1]])
        return torch.where((fk >= 0) & (fk < n), fk, -1)

    def mask(self, pred: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(pred, bool)).to(self.device)


def _col(star: _Star, name: str, sl: slice) -> torch.Tensor:
    return star.lo[name][sl].to(torch.int64)


def _run(star: _Star, dims: Dict[str, np.ndarray], lo_pred: Callable,
         value: Callable, groups, acc) -> tuple:
    """(slot sums, slot row counts, dictionaries) of ``value`` over the
    fact rows that pass ``lo_pred`` and join each dimension of ``dims``
    inside its mask, grouped by the dimension columns ``groups``."""
    dev = star.device
    masks = {d: star.mask(m) for d, m in dims.items()}
    codes, dicts = [], []
    for dim, col in groups:
        d, inv = np.unique(np.asarray(star.data[dim][col]),
                           return_inverse=True)
        codes.append((dim, torch.from_numpy(
            inv.reshape(-1).astype(np.int64)).to(dev)))
        dicts.append(d)
    nslots = int(np.prod([len(d) for d in dicts])) if dicts else 1
    sums = torch.zeros(nslots, dtype=acc, device=dev)
    counts = torch.zeros(nslots, dtype=torch.int64, device=dev)
    for start in range(0, star.n, BLOCK):
        sl = slice(start, min(star.n, start + BLOCK))
        m = lo_pred(star, sl)
        rows = {}
        for dim in set(dims) | {g[0] for g in groups}:
            r = star.rows(dim, sl)
            rows[dim] = r
            m = m & (r >= 0)
            if dim in masks:
                m = m & masks[dim][r.clamp(min=0)]
        slot = torch.zeros(sl.stop - sl.start, dtype=torch.int64, device=dev)
        for (dim, code), d in zip(codes, dicts):
            slot = slot * len(d) + code[rows[dim].clamp(min=0)]
        idx = torch.nonzero(m).squeeze(1)
        sums.index_add_(0, slot[idx], value(star, sl)[idx].to(acc))
        counts.index_add_(0, slot[idx], torch.ones_like(idx))
    return sums, counts, dicts


def _num(v) -> int:
    """A slot's sum as an int (a float32 sum rounded to the nearest)."""
    return v if isinstance(v, int) else int(round(v))


def _py(v):
    return int(v) if isinstance(v, (np.integer, int)) else str(v)


def _grouped(star, dims, value, groups, select, order, acc,
             lo_pred=None) -> List[tuple]:
    sums, counts, dicts = _run(star, dims, lo_pred or _all, value, groups,
                               acc)
    live = torch.nonzero(counts).squeeze(1).cpu().numpy()
    vals = sums[torch.from_numpy(live).to(sums.device)].tolist()
    cols, rest = [], live
    for d in reversed(dicts):
        cols.append(d[rest % len(d)])
        rest = rest // len(d)
    cols.reverse()
    out = [tuple(_num(vals[g]) if s == "sum" else _py(cols[s][g])
                 for s in select)
           for g in range(len(live))]
    return sorted(out, key=order)


def _scalar(star, dims, value, lo_pred, acc) -> List[tuple]:
    sums, counts, _ = _run(star, dims, lo_pred, value, [], acc)
    if int(counts[0]) == 0:
        return [(None,)]
    return [(_num(sums[0].item()),)]


def _all(star, sl):
    return torch.ones(sl.stop - sl.start, dtype=torch.bool,
                      device=star.device)


def _lo_between(col, lo, hi):
    return lambda s, sl: (_col(s, col, sl) >= lo) & (_col(s, col, sl) <= hi)


def _answers(data, qids, device, acc) -> Dict[str, List[tuple]]:
    s = _Star(data, device)
    d, c = data["dates"], data["customer"]
    su, p = data["supplier"], data["part"]

    def q1v(st, sl):
        return _col(st, "lo_extendedprice", sl) * _col(st, "lo_discount", sl)

    def rev(st, sl):
        return _col(st, "lo_revenue", sl)

    def profit(st, sl):
        return _col(st, "lo_revenue", sl) - _col(st, "lo_supplycost", sl)

    def q1(disc, qty):
        return lambda st, sl: disc(st, sl) & qty(st, sl)

    ones = {k: np.ones(len(v[next(iter(v))]), bool)
            for k, v in (("dates", d), ("customer", c), ("supplier", su),
                         ("part", p))}
    q2_order = lambda r: (r[1], r[2])                 # noqa: E731
    q3_order = lambda r: (r[2], -r[3], r[0], r[1])    # noqa: E731
    years = _between(d["d_year"], 1992, 1997)
    ki = ("UNITED KI1", "UNITED KI5")
    america = {"customer": c["c_region"] == "AMERICA",
               "supplier": su["s_region"] == "AMERICA"}
    mfgr12 = _isin(p["p_mfgr"], ("MFGR#1", "MFGR#2"))
    y9798 = _isin(d["d_year"], (1997, 1998))
    q3_groups = {lvl: [("customer", f"c_{lvl}"), ("supplier", f"s_{lvl}"),
                       ("dates", "d_year")] for lvl in ("nation", "city")}
    plans = {
        "1.1": lambda: _scalar(
            s, {"dates": d["d_year"] == 1993}, q1v,
            q1(_lo_between("lo_discount", 1, 3),
               lambda st, sl: _col(st, "lo_quantity", sl) < 25), acc),
        "1.2": lambda: _scalar(
            s, {"dates": d["d_yearmonthnum"] == 199401}, q1v,
            q1(_lo_between("lo_discount", 4, 6),
               _lo_between("lo_quantity", 26, 35)), acc),
        "1.3": lambda: _scalar(
            s, {"dates": (d["d_weeknuminyear"] == 6) & (d["d_year"] == 1994)},
            q1v, q1(_lo_between("lo_discount", 5, 7),
                    _lo_between("lo_quantity", 26, 35)), acc),
    }
    for qid, part_pred, region in (
            ("2.1", p["p_category"] == "MFGR#12", "AMERICA"),
            ("2.2", _between(p["p_brand1"], "MFGR#2221", "MFGR#2228"),
             "ASIA"),
            ("2.3", p["p_brand1"] == "MFGR#2239", "EUROPE")):
        plans[qid] = (lambda pp=part_pred, rg=region: _grouped(
            s, {"dates": ones["dates"], "part": pp,
                "supplier": su["s_region"] == rg}, rev,
            [("dates", "d_year"), ("part", "p_brand1")], ["sum", 0, 1],
            q2_order, acc))
    for qid, cp, sp, dp, lvl in (
            ("3.1", c["c_region"] == "ASIA", su["s_region"] == "ASIA",
             years, "nation"),
            ("3.2", c["c_nation"] == "UNITED STATES",
             su["s_nation"] == "UNITED STATES", years, "city"),
            ("3.3", _isin(c["c_city"], ki), _isin(su["s_city"], ki),
             years, "city"),
            ("3.4", _isin(c["c_city"], ki), _isin(su["s_city"], ki),
             d["d_yearmonth"] == "Dec1997", "city")):
        plans[qid] = (lambda cp=cp, sp=sp, dp=dp, lvl=lvl: _grouped(
            s, {"customer": cp, "supplier": sp, "dates": dp}, rev,
            q3_groups[lvl], [0, 1, 2, "sum"], q3_order, acc))
    plans["4.1"] = lambda: _grouped(
        s, {**america, "part": mfgr12, "dates": ones["dates"]}, profit,
        [("dates", "d_year"), ("customer", "c_nation")], [0, 1, "sum"],
        lambda r: (r[0], r[1]), acc)
    plans["4.2"] = lambda: _grouped(
        s, {**america, "part": mfgr12, "dates": y9798}, profit,
        [("dates", "d_year"), ("supplier", "s_nation"),
         ("part", "p_category")], [0, 1, 2, "sum"],
        lambda r: (r[0], r[1], r[2]), acc)
    plans["4.3"] = lambda: _grouped(
        s, {"customer": ones["customer"],
            "supplier": su["s_nation"] == "UNITED STATES",
            "part": p["p_category"] == "MFGR#14", "dates": y9798}, profit,
        [("dates", "d_year"), ("supplier", "s_city"), ("part", "p_brand1")],
        [0, 1, 2, "sum"], lambda r: (r[0], r[1], r[2]), acc)
    return {q: plans[q]() for q in qids}


def expected(data, qids, device) -> Dict[str, List[tuple]]:
    """{query id: rows} for the query ids ``qids`` ("1.1" to "4.3")."""
    return _answers(data, qids, device, torch.int64)


def control(data, qids, device, want=None) -> Dict[str, List[tuple]]:
    """The control: the same plans with every sum accumulated in float32,
    the precision below the exact int64 sums the configuration states."""
    return _answers(data, qids, device, torch.float32)
