"""Date/time arithmetic on integer tensors: the reference's gdk_time.c
(date arithmetic, component extraction, truncation, month arithmetic with
day clamping) over epoch-day int32 (DATE), microseconds-since-epoch int64
(TIMESTAMP) and microseconds-of-day int64 (TIME) columns.

``_extract`` and ``_trunc`` are plain functions on tensors (the fragment
interpreter calls them for ``e_dextract``, ``e_dtrunc``); ``extract``,
``date_trunc`` and ``add_interval_col`` wrap them for Columns, as the
op-at-a-time executor calls them.  Uses the standard
civil-from-days algorithm (Howard Hinnant's public-domain date algorithms)
as branch-free integer ops, exact for the proleptic Gregorian calendar.
``//`` and ``%`` on integer tensors floor, as the algorithm needs for days
before 1970.
"""

from __future__ import annotations

import torch

from ..column import Column
from ..dtypes import DATE, I32, I64, TIMESTAMP, Kind

__all__ = ["extract", "date_trunc", "add_interval_col"]

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


def extract(field: str, col: Column) -> Column:
    """EXTRACT(field FROM col) / year(col)-family (gdk_time.c date_extract
    operators, modules/atoms/mtime.c)."""
    field = _FIELD_ALIASES.get(field, field)
    if col.typ.kind == Kind.TIME:
        # hour/minute/second over µs-of-day
        us = col.data
        if field == "hour":
            out = us // 3_600_000_000
        elif field == "minute":
            out = (us // 60_000_000) % 60
        elif field == "second":
            out = (us // 1_000_000) % 60
        elif field == "epoch":
            out = us // 1_000_000
        else:
            raise ValueError(f"cannot extract {field} from TIME")
        out = torch.where(~col.live_mask() | (us == _NIL64), _NIL64, out)
    else:
        out = _extract(col.data, field=field,
                       is_ts=col.typ.kind == Kind.TIMESTAMP)
        out = torch.where(col.live_mask(), out, _NIL64)
    if field == "epoch":
        return Column(I64, out, col.count, nonil=col.nonil)
    out32 = torch.where(out == _NIL64, _NIL32, out).to(torch.int32)
    c = Column(I32, out32, col.count, nonil=col.nonil)
    if field == "year" and col.typ.kind == Kind.DATE and \
            col.minval is not None and col.maxval is not None:
        c.minval = 1970 + int(col.minval) // 366 - 1
        c.maxval = 1970 + int(col.maxval) // 365 + 1
    return c


def date_trunc(field: str, col: Column) -> Column:
    """date_trunc('field', ts) (reference sql/scripts/39_analytics:
    sys.date_trunc over mtime)."""
    out = _trunc(col.data, field=field, is_ts=col.typ.kind == Kind.TIMESTAMP)
    out = torch.where(col.live_mask(), out, _NIL64)
    return Column(TIMESTAMP, out, col.count, nonil=col.nonil)


_MONTH_DAYS = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


def _add_months(days, live, *, months: int):
    """epoch days + months as int64; the int32 nil where the input is nil
    or the row is dead."""
    y, m, d = _civil(days)
    t = y * 12 + (m - 1) + months
    ny = t // 12
    nm = t % 12 + 1
    # clamp day to the target month's length (gdk_time.c date_add_month)
    leap = ((ny % 4 == 0) & (ny % 100 != 0)) | (ny % 400 == 0)
    mdays = torch.tensor(_MONTH_DAYS, dtype=torch.int64,
                         device=days.device)[nm - 1]
    mdays = torch.where((nm == 2) & leap, 29, mdays)
    out = _days_from_civil(ny, nm, torch.minimum(d, mdays))
    return torch.where(~live | (days == _NIL32), _NIL32, out)


def add_interval_col(col: Column, amount: int, unit: str) -> Column:
    """column ± interval (BATcalc + mtime addition operators)."""
    if unit == "quarter":
        amount, unit = amount * 3, "month"
    if unit == "week":
        amount, unit = amount * 7, "day"
    is_ts = col.typ.kind == Kind.TIMESTAMP
    live = col.live_mask()
    if unit in ("year", "month"):
        months = amount * 12 if unit == "year" else amount
        if is_ts:
            days = col.data // _US_PER_DAY
            us = col.data - days * _US_PER_DAY
            # a nil timestamp's day number is no int32 nil: clamp it and
            # restore the nil afterwards
            nil_in = col.data == _NIL64
            nd = _add_months(torch.where(nil_in, 0, days),
                             torch.ones_like(live), months=months)
            out = torch.where(nil_in, _NIL64, nd * _US_PER_DAY + us)
            return Column(TIMESTAMP, out, col.count, nonil=col.nonil)
        out = _add_months(col.data, live, months=months).to(torch.int32)
        return Column(DATE, out, col.count, nonil=col.nonil)
    if unit in ("hour", "minute", "second") or is_ts:
        us = {"day": _US_PER_DAY, "hour": 3_600_000_000,
              "minute": 60_000_000, "second": 1_000_000}[unit] * amount
        if is_ts:
            data = col.data
        else:   # DATE promotes to TIMESTAMP under sub-day arithmetic
            data = torch.where(col.data == _NIL32, _NIL64,
                               col.data.to(torch.int64) * _US_PER_DAY)
        out = torch.where(~live | (data == _NIL64), _NIL64, data + us)
        return Column(TIMESTAMP, out, col.count, nonil=col.nonil)
    # DATE ± days
    out = torch.where(~live | (col.data == _NIL32), _NIL32,
                      col.data + int(amount))
    return Column(DATE, out, col.count, nonil=col.nonil)
