"""The comparison that decides ``correct``: every answer of the window
against the reference's rows.

A value the reference gives as a float (an average, a ratio) is compared
by its relative gap; every other value (integers, decimals, dates,
strings, NULL) must be equal and of the same type, and rows must come in
the reference's order.  Nothing here imports the program or torch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

__all__ = ["float_gap", "judge", "Checks"]


def float_gap(got, want) -> Optional[float]:
    """Largest relative gap between the float values of two row lists of
    the same shape, or None when they differ in anything but float
    values (row count, arity, an exact value, a type)."""
    if len(got) != len(want):
        return None
    worst = 0.0
    for g_row, w_row in zip(got, want):
        if len(g_row) != len(w_row):
            return None
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                if not isinstance(g, float):
                    return None
                if math.isnan(w) or math.isnan(g):
                    if not (math.isnan(w) and math.isnan(g)):
                        return math.inf
                    continue
                if g != w:
                    worst = max(worst, abs(g - w) / abs(w) if w else
                                math.inf)
            elif type(g) is not type(w) or g != w:
                return None
    return worst


class Checks:
    """The numbers compared, each beside its limit."""

    def __init__(self, float_limit: float):
        self.float_limit = float_limit
        self.wrong = 0
        self.errors = 0
        self.worst_float = 0.0
        self.wrong_queries: Dict[str, int] = {}

    def as_dict(self) -> Dict[str, dict]:
        return {
            "wrong_answers": {"value": self.wrong, "limit": 0},
            "errors": {"value": self.errors, "limit": 0},
            "float_rel_gap": {"value": self.worst_float,
                              "limit": self.float_limit},
        }

    def passed(self) -> bool:
        return (self.wrong == 0 and self.errors == 0
                and self.worst_float <= self.float_limit)


def judge(answers: Sequence, want: Dict[str, List[tuple]],
          float_limit: float) -> Checks:
    """Compare every answer (objects with ``qid``, ``rows``, ``error``)
    with the reference's rows; marks each answer's ``ok`` and returns the
    numbers compared.  Answers with the same rows are compared once."""
    checks = Checks(float_limit)
    seen: Dict[str, list] = {}      # qid -> [(rows, gap)]
    for a in answers:
        if a.error is not None:
            checks.errors += 1
            a.ok = False
            continue
        gap = None
        for rows, g in seen.setdefault(a.qid, []):
            if rows == a.rows:
                gap = g
                break
        else:
            gap = float_gap(a.rows, want[a.qid])
            seen[a.qid].append((a.rows, gap))
        if gap is None:
            checks.wrong += 1
            checks.wrong_queries[a.qid] = \
                checks.wrong_queries.get(a.qid, 0) + 1
            a.ok = False
            continue
        checks.worst_float = max(checks.worst_float, gap)
        a.ok = gap <= float_limit
    return checks
