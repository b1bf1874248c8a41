"""Arithmetic of the benchmark: percentiles, intervals, bytes.

Plain Python over numbers the harness collected; nothing here imports the
program or torch.
"""

from __future__ import annotations

import re
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["percentile", "mean", "union_length", "merge", "gaps",
           "columns_of", "query_bytes"]


def percentile(values: Sequence[float], p: int) -> float:
    """The p-th percentile (1 <= p <= 99) of ``values`` by linear
    interpolation between closest ranks (``statistics.quantiles``,
    inclusive method); the value itself when there is one."""
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[p - 1]


def merge(intervals: Iterable[Tuple[float, float]]) \
        -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals covering the same points as
    ``intervals`` (empty ones dropped)."""
    out: List[List[float]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``intervals``."""
    return sum(e - s for s, e in merge(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in merge((max(s, lo), min(e, hi)) for s, e in intervals):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


_WORD = re.compile(r"[a-z_][a-z0-9_]*")


def columns_of(sql: str, schema: Dict[str, Dict[str, list]]) \
        -> List[Tuple[str, str]]:
    """(table, column) of every schema column the query text names, each
    once (a self-join reads a column once)."""
    words = set(_WORD.findall(sql.lower()))
    return [(t, c) for t, cols in schema.items() for c in cols if c in words]


def query_bytes(sql: str, schema: Dict[str, Dict[str, list]],
                rows: Dict[str, int]) -> int:
    """Bytes the query must read: the live rows of each column it names,
    at the column's width in the source schema (``schema[t][c][1]``)."""
    return sum(rows[t] * int(schema[t][c][1])
               for t, c in columns_of(sql, schema))


def mean(values: Sequence[float]) -> Optional[float]:
    return statistics.fmean(values) if values else None
