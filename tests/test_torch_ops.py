"""The PyTorch port's operator library (monetdb_tpu_torch/ops/*, tensors on
the CPU) against the reference JAX modules (monetdb_tpu/ops/*) on the same
numpy inputs, made from a seed.

Every result is compared on its whole padded array (the nil tail
included), with dtype, count and property flags.  Integers, decimals,
counts, codes and masks must be equal.  Floats must be equal too, except
float sums and what is computed from them (avg, var, stdev, covar, corr),
which get rel 1e-9: ``index_add_`` adds in another order than XLA's
scatter.
"""

import numpy as np
import pytest
import torch

import monetdb_tpu as R
import monetdb_tpu.config as ref_config
from monetdb_tpu.ops import aggr as RA, calc as RC, group as RG, \
    join as RJ, project as RP, select as RS, sort as RSRT, \
    strfuncs as RSF, datecalc as RDT
import monetdb_tpu_torch as T
import monetdb_tpu_torch.config as config
from monetdb_tpu_torch.ops import aggr as TA, calc as TC, group as TG, \
    join as TJ, project as TP, select as TS, sort as TSRT, \
    strfuncs as TSF, datecalc as TDT

CPU = torch.device("cpu")
NIL64 = np.iinfo(np.int64).min
NIL32 = np.iinfo(np.int32).min
SUM_RTOL = 1e-9


def both(arr, typ_name, **props):
    """The same column in both packages."""
    arr = np.asarray(arr)
    if isinstance(typ_name, tuple):
        rt = R.dtypes.decimal(*typ_name[1:])
        tt = T.dtypes.decimal(*typ_name[1:])
    else:
        rt, tt = getattr(R.dtypes, typ_name), getattr(T.dtypes, typ_name)
    return (R.Column.from_numpy(arr, rt, **props),
            T.Column.from_numpy(arr, tt, device=CPU, **props))


def both_str(strings):
    return (R.Column.from_strings(strings),
            T.Column.from_strings(strings, device=CPU))


def arr_eq(ref, got, rtol=None):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.dtype == got.dtype, (ref.dtype, got.dtype)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if rtol is not None and ref.dtype.kind == "f":
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0,
                                   equal_nan=True)
    else:
        assert np.array_equal(ref, got, equal_nan=ref.dtype.kind == "f"), \
            (ref[:20], got[:20])


def col_eq(rc, tc, rtol=None):
    assert repr(rc.typ) == repr(tc.typ)
    assert rc.count == tc.count
    assert (rc.nonil, rc.sorted, rc.revsorted, rc.key) == \
        (tc.nonil, tc.sorted, tc.revsorted, tc.key)
    assert (rc.minval, rc.maxval) == (tc.minval, tc.maxval)
    arr_eq(rc.data, tc.data, rtol)
    if rc.sdict is None:
        assert tc.sdict is None
    else:
        assert list(rc.sdict.values) == list(tc.sdict.values)


def cand_eq(rcand, tcand, cap):
    assert rcand.kind == tcand.kind
    assert rcand.count() == tcand.count()
    arr_eq(rcand.as_mask(cap), tcand.as_mask(cap, CPU))


def ints(rng, n, lo=-50, hi=50, nil_frac=0.1, dtype=np.int64):
    a = rng.integers(lo, hi, n).astype(dtype)
    a[rng.random(n) < nil_frac] = np.iinfo(dtype).min
    return a


def floats(rng, n, nil_frac=0.1):
    a = np.round(rng.normal(0, 100, n), 3)
    a[rng.random(n) < nil_frac] = np.nan
    return a


# ---------------------------------------------------------------------------
# select / candidates / project
# ---------------------------------------------------------------------------

_SEL_ARGS = [
    dict(tl=5, th=None), dict(tl=5, th=None, anti=True),
    dict(tl=-10, th=10), dict(tl=-10, th=10, li=False, hi=False),
    dict(tl=-10, th=10, anti=True), dict(tl=10, th=-10),
    dict(tl=10, th=-10, anti=True), dict(tl=7, th=7),
    dict(tl=7, th=7, li=False), dict(tl=None, th=3),
    dict(tl=None, th=3, hi=False, anti=True),
    dict(tl=NIL64, th=NIL64), dict(tl=NIL64, th=NIL64, anti=True),
    dict(tl=NIL64, th=None), dict(tl=NIL64, th=None, anti=True),
    dict(tl=NIL64, th=None, nil_matches=True),
    dict(tl=NIL64, th=None, nil_matches=True, anti=True),
    dict(tl=3, th=NIL64), dict(tl=3, th=NIL64, li=False, anti=True),
    dict(tl=5, th=None, anti=True, nil_matches=True),
]


@pytest.mark.parametrize("kw", _SEL_ARGS, ids=[str(i) for i in
                                               range(len(_SEL_ARGS))])
def test_select_truth_table(kw):
    rng = np.random.default_rng(1)
    rc, tc = both(ints(rng, 3000, -20, 20), "I64")
    cand_eq(RS.select(rc, **kw), TS.select(tc, **kw), rc.cap)
    # the same under a candidate
    m = rng.random(rc.cap) < 0.5
    rk = R.Cand.from_mask(R.column.jnp.asarray(m), rc.count)
    tk = T.Cand.from_mask(torch.from_numpy(m), tc.count)
    cand_eq(RS.select(rc, rk, **kw), TS.select(tc, tk, **kw), rc.cap)


@pytest.mark.parametrize("op", ["==", "!=", "<", "<=", ">", ">="])
@pytest.mark.parametrize("kind", ["I32", "F64", "BOOL"])
def test_thetaselect(op, kind):
    rng = np.random.default_rng(2)
    arr = {"I32": ints(rng, 2000, dtype=np.int32), "F64": floats(rng, 2000),
           "BOOL": rng.random(2000) < 0.5}[kind]
    val = {"I32": 4, "F64": 12.5, "BOOL": True}[kind]
    rc, tc = both(arr, kind)
    cand_eq(RS.thetaselect(rc, None, val, op),
            TS.thetaselect(tc, None, val, op), rc.cap)


def test_cand_algebra_materialize_project():
    rng = np.random.default_rng(3)
    n = 2500
    rc, tc = both(ints(rng, n), "I64")
    ra, ta = RS.thetaselect(rc, None, 0, ">"), TS.thetaselect(tc, None, 0, ">")
    rb, tb = RS.select(rc, tl=-5, th=20), TS.select(tc, tl=-5, th=20)
    cap = rc.cap
    cand_eq(RS.cand_and(ra, rb, cap), TS.cand_and(ta, tb, cap, CPU), cap)
    cand_eq(RS.cand_or(ra, rb, cap), TS.cand_or(ta, tb, cap, CPU), cap)
    cand_eq(RS.cand_not(ra, cap), TS.cand_not(ta, cap, CPU), cap)
    cand_eq(RS.cand_and(R.Cand.all(n), rb, cap),
            TS.cand_and(T.Cand.all(n), tb, cap, CPU), cap)
    for rk, tk in ((ra, ta), (R.Cand.all(n), T.Cand.all(n)),
                   (R.Cand.dense(n, 100, 900), T.Cand.dense(n, 100, 900)),
                   (R.Cand.dense(n, 50, 10), T.Cand.dense(n, 50, 10))):
        rm, tm = RS.materialize(rk, cap), TS.materialize(tk, cap, CPU)
        assert rm.oid_count == tm.oid_count
        arr_eq(rm.oids, tm.oids)
        arr_eq(rm.as_mask(cap), tm.as_mask(cap, CPU))     # oids -> mask
        col_eq(RP.project(rk, rc), TP.project(tk, tc))
    # a chain of two projections, with dead slots
    o1 = np.full(1024, -1, np.int64)
    o1[:700] = rng.integers(0, 1024, 700)
    o1[5] = -1
    o2 = np.full(1024, -1, np.int64)
    o2[:1000] = rng.integers(0, n, 1000)
    j = R.column.jnp.asarray
    col_eq(RP.project_chain([(j(o1), 700), (j(o2), 1000)], rc),
           TP.project_chain([(torch.from_numpy(o1), 700),
                             (torch.from_numpy(o2), 1000)], tc))


def test_select_on_strings_and_lut():
    words = ["pear", "apple", "fig", "apple", "kiwi", "fig", "plum"] * 300
    rc, tc = both_str(words)
    code = rc.sdict.code_of("fig")
    cand_eq(RS.thetaselect(rc, None, code, "=="),
            TS.thetaselect(tc, None, code, "=="), rc.cap)
    for pat, neg in (("%p%", False), ("a%", True), ("_i_i", False),
                     ("%e", False)):
        cand_eq(RSF.like_cand(rc, pat, neg), TSF.like_cand(tc, pat, neg),
                rc.cap)
    cand_eq(RSF.in_strings_cand(rc, ["fig", "plum", "x"]),
            TSF.in_strings_cand(tc, ["fig", "plum", "x"]), rc.cap)
    for fn in ("upper", "length", "reverse", "soundex", "md5_hex"):
        col_eq(getattr(RSF, fn)(rc), getattr(TSF, fn)(tc))
    col_eq(RSF.substring(rc, 2, 2), TSF.substring(tc, 2, 2))
    col_eq(RSF.concat(rc, "!"), TSF.concat(tc, "!"))
    col_eq(RSF.concat_cols(rc, rc), TSF.concat_cols(tc, tc))
    col_eq(RSF.levenshtein(rc, "apply"), TSF.levenshtein(tc, "apply"))
    col_eq(RSF.jarowinkler(rc, "pearl"), TSF.jarowinkler(tc, "pearl"))
    # a function that maps some values to nil
    f = lambda v: None if v == "fig" else v[:2]   # noqa: E731
    col_eq(RSF.map_dict(rc, f), TSF.map_dict(tc, f))


# ---------------------------------------------------------------------------
# calc
# ---------------------------------------------------------------------------

_ARITH = ["add", "sub", "mul", "div", "mod", "min", "max"]
_BITS = ["and", "or", "xor"]       # integer-only in both packages


@pytest.mark.parametrize("kind,op", [(k, o) for k in ("I32", "I64")
                                     for o in _ARITH + _BITS]
                         + [("F64", o) for o in _ARITH])
def test_binop(op, kind):
    rng = np.random.default_rng(4)
    n = 3000
    if kind == "F64":
        a, b = floats(rng, n), floats(rng, n)
        b[b == 0] = 1.0
    else:
        dt = np.int32 if kind == "I32" else np.int64
        a = ints(rng, n, -1000, 1000, dtype=dt)
        b = ints(rng, n, -9, 10, dtype=dt)
        b[b == 0] = 3          # negatives on both sides: trunc, not floor
    (ra, ta), (rb, tb) = both(a, kind), both(b, kind)
    col_eq(RC.binop(op, ra, rb), TC.binop(op, ta, tb))
    col_eq(RC.binop(op, ra, 7), TC.binop(op, ta, 7))


def test_truncating_division_of_negatives():
    a = np.array([-7, 7, -7, 7, -1, NIL64, 0, -9], np.int64)
    b = np.array([2, -2, -2, 2, 3, 2, 5, -1], np.int64)
    (ra, ta), (rb, tb) = both(a, "I64"), both(b, "I64")
    q = TC.binop("div", ta, tb)
    m = TC.binop("mod", ta, tb)
    assert q.data[:5].tolist() == [-3, -3, 3, 3, 0]
    assert m.data[:5].tolist() == [-1, 1, -1, 1, -1]
    col_eq(RC.binop("div", ra, rb), q)
    col_eq(RC.binop("mod", ra, rb), m)


@pytest.mark.parametrize("op,a,b,err", [
    ("add", [2 ** 62, 1], [2 ** 62, 1], "CalcOverflow"),
    ("sub", [-2 ** 62, 1], [2 ** 62 + 5, 1], "CalcOverflow"),
    ("mul", [2 ** 40, 1], [2 ** 40, 1], "CalcOverflow"),
    ("mul", [-2 ** 63 + 1, 1], [2, 1], "CalcOverflow"),
    ("div", [5, 1], [0, 1], "CalcDivZero"),
    ("mod", [5, 1], [0, 1], "CalcDivZero"),
])
def test_calc_errors(op, a, b, err):
    (ra, ta), (rb, tb) = both(np.array(a, np.int64), "I64"), \
        both(np.array(b, np.int64), "I64")
    with pytest.raises(getattr(RC, err)) as want:
        RC.binop(op, ra, rb)
    with pytest.raises(getattr(TC, err)) as got:
        TC.binop(op, ta, tb)
    assert str(got.value) == str(want.value)
    # a nil operand hides the error on both sides
    a2 = [NIL64, a[1]]
    (ra, ta) = both(np.array(a2, np.int64), "I64")
    col_eq(RC.binop(op, ra, rb), TC.binop(op, ta, tb))
    # with the checks off, add/sub/mul wrap on both sides
    if err == "CalcOverflow":
        config.set("overflow_checks", False)
        ref_config.set("overflow_checks", False)
        try:
            (ra, ta) = both(np.array(a, np.int64), "I64")
            col_eq(RC.binop(op, ra, rb), TC.binop(op, ta, tb))
        finally:
            config.reset("overflow_checks")
            ref_config.reset("overflow_checks")


def test_int32_mul_overflow_and_narrowing_convert():
    (ra, ta) = both(np.array([70000, 3], np.int32), "I32")
    with pytest.raises(RC.CalcOverflow):
        RC.binop("mul", ra, ra)
    with pytest.raises(TC.CalcOverflow):
        TC.binop("mul", ta, ta)
    (rb, tb) = both(np.array([2 ** 40, 3], np.int64), "I64")
    with pytest.raises(RC.CalcOverflow):
        RC.convert(rb, R.I32)
    with pytest.raises(TC.CalcOverflow):
        TC.convert(tb, T.I32)
    (rf, tf) = both(np.array([1e30, 3.0]), "F64")
    with pytest.raises(RC.CalcOverflow):
        RC.convert(rf, R.I64)
    with pytest.raises(TC.CalcOverflow):
        TC.convert(tf, T.I64)


@pytest.mark.parametrize("op", ["=", "<>", "<", "<=", ">", ">="])
def test_compare_unop_isnil_ifthenelse(op):
    rng = np.random.default_rng(5)
    n = 2000
    (ra, ta), (rb, tb) = both(ints(rng, n, -5, 5), "I64"), \
        both(ints(rng, n, -5, 5), "I64")
    rcmp, tcmp = RC.compare(op, ra, rb), TC.compare(op, ta, tb)
    col_eq(rcmp, tcmp)
    col_eq(RC.compare(op, ra, 2), TC.compare(op, ta, 2))
    (rf, tf) = both(floats(rng, n), "F64")
    col_eq(RC.compare(op, rf, 1.5), TC.compare(op, tf, 1.5))
    for u in ("neg", "abs", "sign"):
        col_eq(RC.unop(u, ra), TC.unop(u, ta))
        col_eq(RC.unop(u, rf), TC.unop(u, tf))
    col_eq(RC.isnil(ra), TC.isnil(ta))
    col_eq(RC.isnil(rf), TC.isnil(tf))
    # three-valued condition: nil -> nil
    col_eq(RC.ifthenelse(rcmp, ra, rb, R.I64),
           TC.ifthenelse(tcmp, ta, tb, T.I64))
    col_eq(RC.ifthenelse(rcmp, ra, 9, R.I64),
           TC.ifthenelse(tcmp, ta, 9, T.I64))
    col_eq(RC.ifthenelse(RC.isnil(ra), 1.5, rf, R.F64),
           TC.ifthenelse(TC.isnil(ta), 1.5, tf, T.F64))


@pytest.mark.parametrize("src,dst,up,down", [
    ("I64", "I32", 0, 0), ("I32", "I64", 0, 0), ("I64", "F64", 0, 0),
    ("F64", "I64", 0, 0), ("F64", ("dec", 12, 2), 2, 0),
    (("dec", 12, 2), ("dec", 14, 4), 2, 0),
    (("dec", 12, 3), ("dec", 12, 1), 0, 2),
    (("dec", 12, 2), "F64", 0, 0), (("dec", 12, 2), "I64", 0, 2),
    ("I32", ("dec", 10, 2), 2, 0), ("BOOL", "I32", 0, 0),
    ("F64", "F32", 0, 0),
])
def test_convert(src, dst, up, down):
    rng = np.random.default_rng(6)
    n = 2000

    def typ(pkg, t):
        return pkg.dtypes.decimal(*t[1:]) if isinstance(t, tuple) \
            else getattr(pkg.dtypes, t)
    if src == "F64":
        # halves in both signs: round half away from zero
        arr = np.concatenate([floats(rng, n - 6),
                              [0.5, -0.5, 1.5, -1.5, 2.5, -2.5]])
    elif src == "BOOL":
        arr = rng.random(n) < 0.5
    else:
        dt = np.int32 if src == "I32" else np.int64
        arr = ints(rng, n, -99999, 99999, dtype=dt)
        arr[:4] = [5, -5, 15, -15]      # halves under a /10 or /100 rescale
    rc = R.Column.from_numpy(arr, typ(R, src))
    tc = T.Column.from_numpy(arr, typ(T, src), device=CPU)
    col_eq(RC.convert(rc, typ(R, dst), scale_up=up, scale_down=down),
           TC.convert(tc, typ(T, dst), scale_up=up, scale_down=down))


def test_datecalc():
    rng = np.random.default_rng(7)
    d = ints(rng, 3000, -200000, 40000, dtype=np.int32)
    (rd, td) = both(d, "DATE")
    ts = d.astype(np.int64) * 86_400_000_000 + rng.integers(
        0, 86_400_000_000, 3000)
    ts[d == NIL32] = NIL64
    (rt, tt) = both(ts, "TIMESTAMP")
    for f in ("year", "month", "day", "quarter", "dow", "doy", "week",
              "century", "decade", "epoch"):
        col_eq(RDT.extract(f, rd), TDT.extract(f, td))
        col_eq(RDT.extract(f, rt), TDT.extract(f, tt))
    for f in ("hour", "minute", "second"):
        col_eq(RDT.extract(f, rt), TDT.extract(f, tt))
    for f in ("day", "week", "month", "quarter", "year", "hour"):
        col_eq(RDT.date_trunc(f, rt), TDT.date_trunc(f, tt))
    for amt, unit in ((1, "month"), (-13, "month"), (2, "year"),
                      (3, "quarter"), (-2, "week"), (40, "day"),
                      (5, "hour"), (-90, "second")):
        col_eq(RDT.add_interval_col(rd, amt, unit),
               TDT.add_interval_col(td, amt, unit))
        col_eq(RDT.add_interval_col(rt, amt, unit),
               TDT.add_interval_col(tt, amt, unit))
    # month ends clamp: Jan 31 + 1 month, Feb 29 + 1 year
    ends = np.array([10987, 11016, 11381, NIL32], np.int32)
    (re_, te) = both(ends, "DATE")
    col_eq(RDT.add_interval_col(re_, 1, "month"),
           TDT.add_interval_col(te, 1, "month"))
    col_eq(RDT.add_interval_col(re_, 1, "year"),
           TDT.add_interval_col(te, 1, "year"))


# ---------------------------------------------------------------------------
# sort / firstn
# ---------------------------------------------------------------------------

def _sort_inputs(rng, n):
    return [both(ints(rng, n, -4, 4), "I64"),
            both(floats(rng, n).round(0), "F64"),
            both_str(list(rng.choice(["a", "bb", "c", "dd", "e"], n)))]


@pytest.mark.parametrize("desc,nl", [
    ([False, False, False], None), ([True, False, True], None),
    ([False, True, False], [True, False, None]),
    ([True, True, True], [False, True, True]),
])
def test_argsort_multi_key(desc, nl):
    rng = np.random.default_rng(8)
    cols = _sort_inputs(rng, 3000)
    rcs, tcs = [c[0] for c in cols], [c[1] for c in cols]
    ro, rn = RSRT.argsort(rcs, desc, nl)
    to, tn = TSRT.argsort(tcs, desc, nl)
    assert rn == tn
    arr_eq(ro, to)
    for a, b in zip(RSRT.sorted_columns((ro, rn), rcs),
                    TSRT.sorted_columns((to, tn), tcs)):
        col_eq(a, b)
    # under a candidate
    m = rng.random(rcs[0].cap) < 0.3
    rk = RS.cand_and(R.Cand.from_mask(R.column.jnp.asarray(m), 3000),
                     R.Cand.dense(3000, 0, 3000), rcs[0].cap)
    tk = T.Cand.from_mask(torch.from_numpy(m) & tcs[0].live_mask(), 3000)
    rk = R.Cand.from_mask(rk.as_mask(rcs[0].cap) &
                          rcs[0].live_mask(), 3000)
    ro, rn = RSRT.argsort(rcs, desc, nl, rk)
    to, tn = TSRT.argsort(tcs, desc, nl, tk)
    assert rn == tn
    arr_eq(ro, to)


@pytest.mark.parametrize("n_top", [1, 7, 100, 2999, 5000])
@pytest.mark.parametrize("desc", [False, True])
def test_firstn_with_ties(n_top, desc):
    """Few distinct keys, so every cut falls inside a run of equal keys:
    the rows must be the reference's (lowest row id first among ties)."""
    rng = np.random.default_rng(9)
    (rc, tc) = both(ints(rng, 3000, 0, 6), "I64")
    ro, rn = RSRT.firstn([rc], n_top, [desc])
    to, tn = TSRT.firstn([tc], n_top, [desc])
    assert rn == tn
    arr_eq(ro, to)
    (rc2, tc2) = both(floats(rng, 3000).round(-2), "F64")
    ro, rn = RSRT.firstn([rc, rc2], n_top, [desc, not desc])
    to, tn = TSRT.firstn([tc, tc2], n_top, [desc, not desc])
    assert rn == tn
    arr_eq(ro, to)


# ---------------------------------------------------------------------------
# group / aggregates
# ---------------------------------------------------------------------------

def _group_eq(rg, tg):
    assert rg.ngroups == tg.ngroups and rg.base_count == tg.base_count
    arr_eq(rg.ids, tg.ids)
    if rg.extents is None:
        assert tg.extents is None
    else:
        arr_eq(rg.extents, tg.extents)
        arr_eq(rg.histo, tg.histo)


def _group_cols(rng, n):
    """Keys that take each strategy: dense (dict codes, bools, int8,
    bounded ints with statistics), sort (no statistics, floats)."""
    k = rng.integers(0, 40, n).astype(np.int64)
    return {
        "str": both_str(list(rng.choice(["x", "y", "z"], n))),
        "bool": both(rng.random(n) < 0.5, "BOOL"),
        "i8": both(ints(rng, n, -3, 3, dtype=np.int8), "I8"),
        "stats": both(k, "I64", minval=0, maxval=39),
        "plain": both(ints(rng, n, -20, 20), "I64"),
        "float": both(floats(rng, n).round(-2), "F64"),
    }


@pytest.mark.parametrize("keys", [["str"], ["bool", "i8"], ["stats"],
                                  ["plain"], ["float"], ["str", "plain"],
                                  ["plain", "float", "stats"]])
def test_group_strategies(keys):
    rng = np.random.default_rng(10)
    n = 3000
    cols = _group_cols(rng, n)
    rg = RG.group_multi([cols[k][0] for k in keys])
    tg = TG.group_multi([cols[k][1] for k in keys])
    _group_eq(rg, tg)
    # under a candidate, and an empty one
    c0 = cols[keys[0]]
    for lo, hi in ((100, 1500), (10, 10)):
        rg = RG.group_multi([cols[k][0] for k in keys],
                            R.Cand.dense(n, lo, hi))
        tg = TG.group_multi([cols[k][1] for k in keys],
                            T.Cand.dense(n, lo, hi))
        _group_eq(rg, tg)
        if hi == lo:
            assert tg.ngroups == 0
    assert c0[0].count == c0[1].count


_AGG_FLOAT = {"avg", "var", "stdev", "covar", "corr"}


@pytest.mark.parametrize("skip_nils", [True, False])
@pytest.mark.parametrize("key", ["str", "plain"])
def test_grouped_aggregates(key, skip_nils):
    rng = np.random.default_rng(11)
    n = 4000
    cols = _group_cols(rng, n)
    rg, tg = RG.group(cols[key][0]), TG.group(cols[key][1])
    v = ints(rng, n, -1000, 1000)
    x = floats(rng, n)
    # one group holds only nils
    gid = np.asarray(rg.ids)[:n]
    v[gid == 1] = NIL64
    x[gid == 1] = np.nan
    (rv, tv), (rx, tx) = both(v, "I64"), both(x, "F64")
    (rd, td) = both(v, ("dec", 15, 2))
    (r32, t32) = both(ints(rng, n, dtype=np.int32), "I32")
    for rcol, tcol in ((rv, tv), (rx, tx), (rd, td), (r32, t32)):
        is_f = rcol.typ.np_dtype.kind == "f"
        col_eq(RA.group_sum(rcol, rg, skip_nils),
               TA.group_sum(tcol, tg, skip_nils),
               SUM_RTOL if is_f else None)
        col_eq(RA.group_count(rcol, rg, skip_nils),
               TA.group_count(tcol, tg, skip_nils))
        col_eq(RA.group_min(rcol, rg, skip_nils),
               TA.group_min(tcol, tg, skip_nils))
        col_eq(RA.group_max(rcol, rg, skip_nils),
               TA.group_max(tcol, tg, skip_nils))
        for a, b in zip(RA.group_avg(rcol, rg, skip_nils),
                        TA.group_avg(tcol, tg, skip_nils)):
            col_eq(a, b, SUM_RTOL)
    col_eq(RA.group_count(None, rg), TA.group_count(None, tg))
    (rs, ts) = both_str(list(rng.choice(["p", "q", "r", "s"], n)))
    col_eq(RA.group_min(rs, rg), TA.group_min(ts, tg))
    col_eq(RA.group_max(rs, rg), TA.group_max(ts, tg))
    col_eq(RA.group_concat_host(rs, rg, "|"),
           TA.group_concat_host(ts, tg, "|"))


def test_moments_quantiles_prod():
    rng = np.random.default_rng(12)
    n = 4000
    (rk, tk) = both(rng.integers(0, 25, n).astype(np.int64), "I64",
                    minval=0, maxval=24)
    rg, tg = RG.group(rk), TG.group(tk)
    x, y = floats(rng, n), floats(rng, n)
    x[np.asarray(rg.ids)[:n] == 3] = np.nan
    (rx, tx), (ry, ty) = both(x, "F64"), both(y, "F64")
    (rd, td) = both(ints(rng, n, -500, 500), ("dec", 12, 2))
    for sample in (True, False):
        col_eq(RA.group_var(rx, rg, sample), TA.group_var(tx, tg, sample),
               SUM_RTOL)
        col_eq(RA.group_stdev(rd, rg, sample),
               TA.group_stdev(td, tg, sample), SUM_RTOL)
        col_eq(RA.group_covar(rx, ry, rg, sample),
               TA.group_covar(tx, ty, tg, sample), SUM_RTOL)
    col_eq(RA.group_corr(rx, ry, rg), TA.group_corr(tx, ty, tg), 1e-7)
    for q in (0.0, 0.25, 0.5, 0.9, 1.0):
        col_eq(RA.group_quantile(rx, rg, q), TA.group_quantile(tx, tg, q))
        col_eq(RA.group_quantile(rd, rg, q), TA.group_quantile(td, tg, q))
    col_eq(RA.group_median(rx, rg), TA.group_median(tx, tg))
    (rp, tp) = both(ints(rng, n, 1, 3, nil_frac=0.2), "I64")
    col_eq(RA.group_prod(rp, rg), TA.group_prod(tp, tg))


def test_scalar_aggregates_and_empty_candidate():
    rng = np.random.default_rng(13)
    n = 3000
    (rv, tv) = both(ints(rng, n), "I64")
    (rx, tx) = both(floats(rng, n), "F64")
    for rk, tk in ((None, None),
                   (R.Cand.dense(n, 5, 900), T.Cand.dense(n, 5, 900)),
                   (R.Cand.dense(n, 7, 7), T.Cand.dense(n, 7, 7))):
        col_eq(RA.scalar_sum(rv, rk), TA.scalar_sum(tv, tk))
        col_eq(RA.scalar_sum(rx, rk), TA.scalar_sum(tx, tk), SUM_RTOL)
        col_eq(RA.scalar_count(rv, rk), TA.scalar_count(tv, tk))
        col_eq(RA.scalar_count(None, rk, base=rv),
               TA.scalar_count(None, tk, base=tv))
        col_eq(RA.scalar_min(rx, rk), TA.scalar_min(tx, tk))
        col_eq(RA.scalar_max(rv, rk), TA.scalar_max(tv, tk))
        col_eq(RA.scalar_avg(rv, rk)[0], TA.scalar_avg(tv, tk)[0],
               SUM_RTOL)
    # the empty selection gives the nil sentinel, not 0
    assert int(TA.scalar_sum(tv, T.Cand.dense(n, 7, 7)).data[0]) == NIL64


def test_sum_overflow_raises():
    big = np.full(2000, 2 ** 62, np.int64)
    (rb, tb) = both(big, "I64")
    with pytest.raises(RC.CalcOverflow) as want:
        RA.scalar_sum(rb)
    with pytest.raises(TC.CalcOverflow) as got:
        TA.scalar_sum(tb)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def _join_sides(rng, kind):
    """Duplicates on both sides, nil keys on both sides, keys without a
    partner on both sides."""
    if kind == "str":
        words = np.array(["a", "b", "c", "d", "e", "f", "g", "h"])
        return (both_str(list(rng.choice(words[:6], 900))),
                both_str(list(rng.choice(words[:6], 300))))
    dt = {"I32": np.int32, "I64": np.int64}.get(kind)
    if kind == "F64":
        return (both(floats(rng, 900).round(-2), "F64"),
                both(floats(rng, 300).round(-2), "F64"))
    return (both(ints(rng, 900, 0, 60, dtype=dt), kind),
            both(ints(rng, 300, 20, 90, dtype=dt), kind))


@pytest.mark.parametrize("nil_matches", [False, True])
@pytest.mark.parametrize("kind", ["I64", "I32", "F64", "str"])
def test_join_family(kind, nil_matches):
    rng = np.random.default_rng(14)
    (rl, tl), (rr, tr) = _join_sides(rng, kind)
    for how in ("inner", "left", "outer"):
        r1, r2, rn = RJ.join(rl, rr, nil_matches=nil_matches, how=how)
        t1, t2, tn = TJ.join(tl, tr, nil_matches=nil_matches, how=how)
        assert rn == tn and rn > 0
        arr_eq(r1, t1)
        arr_eq(r2, t2)
    for fn in ("semijoin", "antijoin"):
        ro, rn = getattr(RJ, fn)(rl, rr, nil_matches=nil_matches)
        to, tn = getattr(TJ, fn)(tl, tr, nil_matches=nil_matches)
        assert rn == tn
        arr_eq(ro, to)
    ro, rm, rn = RJ.markjoin(rl, rr, nil_matches=nil_matches)
    to, tm, tn = TJ.markjoin(tl, tr, nil_matches=nil_matches)
    assert rn == tn
    arr_eq(ro, to)
    arr_eq(rm, tm)
    # candidates on both sides
    lc, rc_ = (R.Cand.dense(900, 50, 700), R.Cand.dense(300, 10, 200))
    tlc, trc = (T.Cand.dense(900, 50, 700), T.Cand.dense(300, 10, 200))
    r1, r2, rn = RJ.join(rl, rr, lc, rc_, nil_matches)
    t1, t2, tn = TJ.join(tl, tr, tlc, trc, nil_matches)
    assert rn == tn
    arr_eq(r1, t1)
    arr_eq(r2, t2)


def test_fetchjoin_on_dense_key():
    rng = np.random.default_rng(15)
    pk = np.arange(100, 600, dtype=np.int64)
    (rr, tr) = both(pk, "I64", sorted=True, key=True, minval=100,
                    maxval=599)
    (rl, tl) = both(ints(rng, 2000, 50, 700), "I64")
    for how in ("inner", "outer"):
        r1, r2, rn = RJ.join(rl, rr, how=how)
        t1, t2, tn = TJ.join(tl, tr, how=how)
        assert rn == tn
        arr_eq(r1, t1)
        arr_eq(r2, t2)
    ro, rn = RJ.antijoin(rl, rr)
    to, tn = TJ.antijoin(tl, tr)
    assert rn == tn
    arr_eq(ro, to)
    # empty left side
    (re_, te) = both(np.zeros(0, np.int64), "I64")
    r1, r2, rn = RJ.join(re_, rr)
    t1, t2, tn = TJ.join(te, tr)
    assert rn == tn == 0
    arr_eq(r1, t1)
