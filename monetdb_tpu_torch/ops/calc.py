"""Arithmetic error types raised by the fragment's error channel
(exec/fragment.py _raise_err).  The op-at-a-time arithmetic kernels of the
reference package's ops/calc.py are not ported yet."""

from __future__ import annotations

__all__ = ["CalcError", "CalcOverflow", "CalcDivZero"]


class CalcError(Exception):
    pass


class CalcOverflow(CalcError):
    pass


class CalcDivZero(CalcError):
    pass
