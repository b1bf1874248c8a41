"""Bulk elementwise arithmetic — the reference's gdk_calc family
(gdk/gdk_calc.c, gdk_calc_addsub.c, gdk_calc_mul.c, gdk_calc_div.c,
gdk_calc_mod.c, gdk_calc_compare.h, gdk_calc_convert.c, ~16k LoC of
macro-expanded per-type loops collapsed here into a handful of tensor
functions).

Semantics preserved from the reference:

* nil propagation: any nil operand ⇒ nil result (sentinel ints / NaN floats).
* overflow: integer add/sub/mul raise ``CalcOverflow`` exactly like the
  reference's ON_OVERFLOW macros (gdk/gdk_calc_addsub.c:44-47) — detected
  on device with an exact widened/sign-trick check, reduced to one flag,
  raised on the host.
* int division/modulo truncate toward zero (C semantics; torch's // and % floor, so
  ``idiv``/``irem`` are used);
  division by zero raises ``CalcDivZero`` (SQLSTATE 22012 in the reference).
* comparisons return three-valued int8 {0, 1, nil} (the reference's bit
  type with nil, gdk_calc_compare.h).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .. import config
from ..column import Column, valid_mask
from ..dtypes import BOOL, I8, SQLType, Kind, common_numeric
from ._tensor import as_scalar, idiv, irem, nil_const, nilm, tdt

__all__ = ["CalcError", "CalcOverflow", "CalcDivZero", "binop", "compare",
           "unop", "ifthenelse", "convert", "isnil"]


class CalcError(Exception):
    pass


class CalcOverflow(CalcError):
    pass


class CalcDivZero(CalcError):
    pass


def _flag(mask, code: int):
    """0-d int32 tensor: ``code`` if any element of mask is set, else 0."""
    return mask.any().to(torch.int32) * code


# ---------------------------------------------------------------------------
# binary arithmetic kernel
# ---------------------------------------------------------------------------

def _binop(a, b, count, *, op: str, check: bool, out_dtype,
           a_nil: bool, b_nil: bool):
    cap = a.shape[0] if a.dim() else b.shape[0]
    live = valid_mask(cap, count, a.device)
    nil_in = torch.zeros_like(live)
    if a_nil:
        nil_in = nil_in | nilm(a)
    if b_nil:
        nil_in = nil_in | nilm(b)
    valid = live & ~nil_in

    ai = a.to(out_dtype)
    bi = b.to(out_dtype)
    err = None
    is_int = not out_dtype.is_floating_point and out_dtype != torch.bool

    if op == "add":
        res = ai + bi
        if check and is_int:
            err = _flag(valid & (((ai ^ res) & (bi ^ res)) < 0), 1)
    elif op == "sub":
        res = ai - bi
        if check and is_int:
            err = _flag(valid & (((ai ^ bi) & (ai ^ res)) < 0), 1)
    elif op == "mul":
        res = ai * bi
        if check and is_int:
            if out_dtype != torch.int64:
                wide = ai.to(torch.int64) * bi.to(torch.int64)
                ovf = wide != res.to(torch.int64)
            else:
                # exact check: b != 0 and res / b != a  (trunc division)
                bz = bi == 0
                q = idiv(res, torch.where(bz, 1, bi))
                ovf = (~bz) & (q != ai)
                # high-bit corner: a = min, b = -1
                ovf = ovf | ((ai == torch.iinfo(torch.int64).min) & (bi == -1))
            err = _flag(valid & ovf, 1)
    elif op == "div":
        bz = bi == 0
        if is_int:
            res = idiv(ai, torch.where(bz, 1, bi))
            err = _flag(valid & bz, 2)
            if check:
                ovf = (ai == torch.iinfo(out_dtype).min) & (bi == -1)
                err = torch.maximum(err, _flag(valid & ovf, 1))
        else:
            res = ai / torch.where(bz, 1, bi)
            err = _flag(valid & bz, 2)
    elif op == "mod":
        bz = bi == 0
        if is_int:
            res = irem(ai, torch.where(bz, 1, bi))
            err = _flag(valid & bz, 2)
        else:
            q = ai / torch.where(bz, 1.0, bi)
            # a - trunc(a / b) * b as one fused multiply-add, as XLA
            # contracts it: the separately rounded product loses the last
            # bits of the remainder
            res = torch.where(bz | torch.isnan(q), float("nan"),
                              torch.addcmul(ai, torch.trunc(q), bi,
                                            value=-1))
    elif op == "min":
        res = torch.minimum(ai, bi)
    elif op == "max":
        res = torch.maximum(ai, bi)
    elif op == "and":
        res = ai & bi
    elif op == "or":
        res = ai | bi
    elif op == "xor":
        res = ai ^ bi
    elif op == "lsh":
        res = ai << bi
    elif op == "rsh":
        res = ai >> bi
    else:  # pragma: no cover
        raise ValueError(op)

    res = torch.where(valid, res, nil_const(out_dtype))
    return res, err


def _coerce_scalar(v, dtype, device):
    return as_scalar(np.dtype(dtype).type(v), tdt(dtype), device)


def binop(op: str, a: Column, b: Union[Column, int, float],
          out_typ: Optional[SQLType] = None) -> Column:
    """BATcalc<op> (e.g. BATcalcadd gdk/gdk_calc_addsub.c:1480)."""
    if isinstance(b, Column):
        assert a.count == b.count, (a.count, b.count)
        bt, b_nonil, b_data = b.typ, b.nonil, b.data
    else:
        bt = a.typ
        b_nonil = True
        b_data = _coerce_scalar(b, a.typ.np_dtype, a.data.device)
    if out_typ is None:
        out_typ = common_numeric(a.typ, bt)
    check = bool(config.get("overflow_checks")) and op in ("add", "sub", "mul", "div")
    res, err = _binop(a.data, b_data, a.count, op=op, check=check,
                      out_dtype=tdt(out_typ.np_dtype),
                      a_nil=not a.nonil, b_nil=not b_nonil)
    if err is not None and (check or op in ("div", "mod")):
        e = int(err)
        if e == 1:
            raise CalcOverflow(f"22003!overflow in calculation ({op})")
        if e == 2:
            raise CalcDivZero("22012!division by zero")
    return Column(out_typ, res, a.count, nonil=a.nonil and b_nonil)


# ---------------------------------------------------------------------------
# comparisons → three-valued int8
# ---------------------------------------------------------------------------

def _compare(a, b, count, *, op: str, a_nil: bool, b_nil: bool):
    cap = a.shape[0] if a.dim() else b.shape[0]
    live = valid_mask(cap, count, a.device)
    nil_in = torch.zeros_like(live)
    if a_nil:
        nil_in = nil_in | nilm(a)
    if b_nil:
        nil_in = nil_in | nilm(b)
    if op == "eq":
        m = a == b
    elif op == "ne":
        m = a != b
    elif op == "lt":
        m = a < b
    elif op == "le":
        m = a <= b
    elif op == "gt":
        m = a > b
    elif op == "ge":
        m = a >= b
    else:  # pragma: no cover
        raise ValueError(op)
    out = m.to(torch.int8)
    nil8 = nil_const(torch.int8)
    return torch.where(live & ~nil_in, out, nil8)


_CMP = {"=": "eq", "==": "eq", "!=": "ne", "<>": "ne", "<": "lt",
        "<=": "le", ">": "gt", ">=": "ge"}


def compare(op: str, a: Column, b: Union[Column, int, float]) -> Column:
    if isinstance(b, Column):
        bd, b_nonil = b.data, b.nonil
    else:
        bd, b_nonil = _coerce_scalar(b, a.typ.np_dtype, a.data.device), True
    res = _compare(a.data, bd, a.count, op=_CMP[op],
                   a_nil=not a.nonil, b_nil=not b_nonil)
    return Column(I8, res, a.count, nonil=a.nonil and b_nonil)


# ---------------------------------------------------------------------------
# unary ops
# ---------------------------------------------------------------------------

def _unop(a, count, *, op: str, a_nil: bool):
    live = valid_mask(a.shape[0], count, a.device)
    nil_in = nilm(a) if a_nil else torch.zeros_like(live)
    valid = live & ~nil_in
    if op == "neg":
        # the type minimum is nil, so a valid value never overflows
        res = -a
    elif op == "abs":
        res = torch.abs(a)
    elif op == "sign":
        res = torch.sign(a).to(torch.int8)
    elif op == "not":
        res = ~a
    else:  # pragma: no cover
        raise ValueError(op)
    return torch.where(valid, res, nil_const(res.dtype))


def unop(op: str, a: Column, out_typ: Optional[SQLType] = None) -> Column:
    res = _unop(a.data, a.count, op=op, a_nil=not a.nonil)
    if out_typ is None:
        out_typ = I8 if op == "sign" else a.typ
    return Column(out_typ, res, a.count, nonil=a.nonil)


def isnil(a: Column) -> Column:
    m = nilm(a.data) & a.live_mask()
    return Column(BOOL, m, a.count, nonil=True)


# ---------------------------------------------------------------------------
# ifthenelse / convert
# ---------------------------------------------------------------------------

def _ifthenelse(c, a, b, count, out_dtype, *, c_nil: bool):
    live = valid_mask(c.shape[0], count, c.device)
    cond = c if c.dtype == torch.bool else (c == 1)
    res = torch.where(cond, a, b)
    # the nil constant carries the result type, as in the reference
    res = res.to(torch.promote_types(res.dtype, out_dtype))
    nil = nil_const(out_dtype)
    if c_nil and c.dtype != torch.bool:
        res = torch.where(nilm(c), nil, res)
    return torch.where(live, res, nil)


def ifthenelse(cond: Column, a, b, out_typ: SQLType) -> Column:
    """BATcalcifthenelse: nil condition ⇒ nil result."""
    dev = cond.data.device
    ad = a.data if isinstance(a, Column) else \
        _coerce_scalar(a, out_typ.np_dtype, dev)
    bd = b.data if isinstance(b, Column) else \
        _coerce_scalar(b, out_typ.np_dtype, dev)
    res = _ifthenelse(cond.data, ad, bd, cond.count, tdt(out_typ.np_dtype),
                      c_nil=not cond.nonil)
    nonil = ((not isinstance(a, Column)) or a.nonil) and \
            ((not isinstance(b, Column)) or b.nonil) and cond.nonil
    sd = None
    for c in (a, b):
        if isinstance(c, Column) and c.sdict is not None:
            sd = c.sdict
    return Column(out_typ, res, cond.count, nonil=nonil, sdict=sd)


def _convert(a, count, *, out_dtype, a_nil: bool, scale_up: int,
             scale_down: int, check: bool):
    live = valid_mask(a.shape[0], count, a.device)
    nil_in = nilm(a) if a_nil else torch.zeros_like(live)
    valid = live & ~nil_in
    err = None
    x = a
    a_f = a.dtype.is_floating_point
    a_i = not a_f and a.dtype != torch.bool
    out_f = out_dtype.is_floating_point
    out_i = not out_f and out_dtype != torch.bool
    if a_f and out_i:
        # round half away from zero (reference: dbl→int cast rounds)
        xs = x * (10 ** scale_up) if scale_up else x
        r = torch.where(xs >= 0, torch.floor(xs + 0.5), torch.ceil(xs - 0.5))
        if check:
            lo = float(torch.iinfo(out_dtype).min + 1)
            hi = float(torch.iinfo(out_dtype).max)
            err = _flag(valid & ((r < lo) | (r > hi)), 1)
        # nils and out-of-range values have no defined integer image
        res = torch.where(valid, r, 0).to(out_dtype)
    else:
        x = x.to(torch.int64) if (a_i and (scale_up or scale_down)) else x
        if scale_up:
            x = x * (10 ** scale_up)
        if scale_down:
            d = 10 ** scale_down
            half = d // 2
            # round half away from zero on integer downscale (// on
            # non-negative values only, so floor == trunc)
            x = torch.where(x >= 0, (x + half) // d, -((-x + half) // d))
        if check and a_i and out_i and out_dtype != torch.int64:
            lo = torch.iinfo(out_dtype).min + 1
            hi = torch.iinfo(out_dtype).max
            err = _flag(valid & ((x < lo) | (x > hi)), 1)
        if a_i and out_f and scale_down:
            res = a.to(out_dtype) / (10 ** scale_down)
        else:
            res = x.to(out_dtype)
    res = torch.where(valid, res, nil_const(out_dtype))
    return res, err


def convert(a: Column, out_typ: SQLType, scale_up: int = 0,
            scale_down: int = 0) -> Column:
    """BATcalc type conversion (gdk/gdk_calc_convert.c) with decimal
    (re)scaling: scale_up multiplies by 10^k, scale_down divides with
    round-half-away-from-zero (the reference's decimal cast rounding)."""
    dec_to_float = a.typ.kind == Kind.DECIMAL and out_typ.np_dtype.kind == "f"
    res, err = _convert(
        a.data, a.count, out_dtype=tdt(out_typ.np_dtype),
        a_nil=not a.nonil,
        scale_up=scale_up if not dec_to_float else 0,
        scale_down=scale_down,
        check=bool(config.get("overflow_checks")))
    if dec_to_float and a.typ.scale:
        res = res / (10.0 ** a.typ.scale)
    if err is not None and int(err):
        raise CalcOverflow("22003!value exceeds limits of type")
    return Column(out_typ, res, a.count, nonil=a.nonil, sdict=None)
