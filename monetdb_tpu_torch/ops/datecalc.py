"""Date/time arithmetic on integer tensors: the reference's gdk_time.c
(component extraction, truncation) over epoch-day int32 (DATE) and
microseconds-since-epoch int64 (TIMESTAMP) columns.

The counterpart of the reference package's ops/datecalc.py as far as the
fragment interpreter needs it (``e_dextract``, ``e_dtrunc``): plain
functions on tensors, on whatever device holds them, under the
reference's names.  Uses the standard
civil-from-days algorithm (Howard Hinnant's public-domain date algorithms)
as branch-free integer ops, exact for the proleptic Gregorian calendar.
``//`` and ``%`` on integer tensors floor, as the algorithm needs for days
before 1970.
"""

from __future__ import annotations

import torch

_NIL32 = -(1 << 31)
_NIL64 = -(1 << 63)
_US_PER_DAY = 86_400_000_000

_FIELD_ALIASES = {
    "dayofmonth": "day", "dayofweek": "dow", "weekday": "dow",
    "dayofyear": "doy", "weekofyear": "week", "sql_second": "second",
}


def _civil(z):
    """epoch days -> (year, month, day) as int64 tensors."""
    z = z.to(torch.int64) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    """(year, month, day) -> epoch days (inverse of ``_civil``)."""
    y = torch.where(m <= 2, y - 1, y)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _nil_in(vals):
    return vals == (_NIL64 if vals.dtype == torch.int64 else _NIL32)


def _days_us(vals, is_ts: bool):
    if is_ts:
        days = vals // _US_PER_DAY
        return days, vals - days * _US_PER_DAY
    days = vals.to(torch.int64)
    return days, torch.zeros_like(days)


def _extract(vals, *, field: str, is_ts: bool):
    """EXTRACT(field FROM vals) as int64, the int64 minimum where the
    input is nil (gdk_time.c date_extract operators)."""
    days, us = _days_us(vals, is_ts)
    y, m, d = _civil(days)
    one = torch.ones_like(y)
    if field == "year":
        out = y
    elif field == "month":
        out = m
    elif field == "day":
        out = d
    elif field == "quarter":
        out = (m - 1) // 3 + 1
    elif field == "century":
        out = torch.where(y > 0, (y + 99) // 100, -((-y + 99) // 100))
    elif field == "decade":
        out = y // 10
    elif field == "dow":
        # ISO day of week 1=Monday..7=Sunday; epoch day 0 = Thursday = 4
        out = (days % 7 + 7 + 3) % 7 + 1
    elif field == "doy":
        out = days - _days_from_civil(y, one, one) + 1
    elif field == "week":
        # ISO week number: week of the Thursday of this row's week
        thursday = days - (days + 3) % 7 + 3
        ty, _tm, _td = _civil(thursday)
        out = (thursday - _days_from_civil(ty, one, one)) // 7 + 1
    elif field == "hour":
        out = us // 3_600_000_000
    elif field == "minute":
        out = (us // 60_000_000) % 60
    elif field == "second":
        out = (us // 1_000_000) % 60
    elif field == "microsecond":
        out = us % 60_000_000
    elif field == "epoch":
        out = days * 86_400 + us // 1_000_000
    else:
        raise ValueError(field)
    return torch.where(_nil_in(vals), _NIL64, out)


def _trunc(vals, *, field: str, is_ts: bool):
    """date_trunc('field', vals) as microseconds since the epoch, the int64
    minimum where the input is nil."""
    days, us = _days_us(vals, is_ts)
    if field in ("microseconds", "milliseconds", "second", "minute", "hour"):
        q = {"microseconds": 1, "milliseconds": 1_000,
             "second": 1_000_000, "minute": 60_000_000,
             "hour": 3_600_000_000}[field]
        out = days * _US_PER_DAY + (us // q) * q
    else:
        y, m, _d = _civil(days)
        one = torch.ones_like(m)
        if field == "day":
            nd = days
        elif field == "week":
            nd = days - (days + 3) % 7
        elif field == "month":
            nd = _days_from_civil(y, m, one)
        elif field == "quarter":
            nd = _days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
        elif field == "year":
            nd = _days_from_civil(y, one, one)
        elif field == "decade":
            nd = _days_from_civil((y // 10) * 10, one, one)
        elif field == "century":
            cy = torch.where(y > 0, ((y - 1) // 100) * 100 + 1, y)
            nd = _days_from_civil(cy, one, one)
        else:
            raise ValueError(field)
        out = nd * _US_PER_DAY
    return torch.where(_nil_in(vals), _NIL64, out)
