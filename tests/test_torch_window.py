"""The PyTorch port's window functions (monetdb_tpu_torch/ops/window.py,
tensors on the CPU) against the reference JAX module on the same sorted
random partitions, and window statements through both Engines (every plan
with a window function runs through the op-at-a-time executor).

Ranks, counts, integer and decimal sums, min/max, lag/lead and the value
functions must be equal on the whole padded array.  Float running sums get
rel 1e-9: the port restarts them with a doubling pass, the reference with
an associative scan, and the two add in different orders; averages divide
such sums.
"""

import numpy as np
import pytest
import torch

import monetdb_tpu.sql.binder as ref_binder
from monetdb_tpu.bench.tpch_load import load_tpch as ref_load_tpch
from monetdb_tpu.engine import Engine as RefEngine
from monetdb_tpu.ops import window as RW
import monetdb_tpu_torch.sql.binder as binder
from monetdb_tpu_torch.bench.tpch_load import load_tpch
from monetdb_tpu_torch.engine import Engine
from monetdb_tpu_torch.exec import fragment as TF
from monetdb_tpu_torch.ops import window as TW

from test_torch_engine import _catalogs
from test_torch_ops import arr_eq, both, both_str, col_eq
from test_window_frames import CASES as FRAME_CASES, ROWS, frame_sql, oracle
from test_torch_cuda import MORE_WINDOW_SQL as MORE_SQL
from test_window_sql import CASES as SQL_CASES
from torch_parity import EXECUTOR_ATOL, EXECUTOR_RTOL, assert_same_result

CPU = torch.device("cpu")
NIL64 = np.iinfo(np.int64).min
SCAN_RTOL = 1e-9


def sorted_partitions(seed, n, nparts, norder):
    """n rows sorted by (partition, order): partition sizes are random
    (some of one row), order keys repeat (peers)."""
    rng = np.random.default_rng(seed)
    part = np.sort(rng.integers(0, nparts, n)).astype(np.int64)
    order = rng.integers(0, norder, n).astype(np.int64)
    idx = np.lexsort((order, part))
    return rng, part[idx], order[idx]


@pytest.fixture(scope="module", params=[(3000, 40, 12), (1500, 1, 300),
                                        (1024, 700, 3)],
                ids=["many", "one-partition", "tiny-partitions"])
def win(request):
    n, nparts, norder = request.param
    rng, part, order = sorted_partitions(n, n, nparts, norder)
    (rp, tp), (ro, to) = both(part, "I64"), both(order, "I64")
    v = rng.integers(-100, 100, n).astype(np.int64)
    v[rng.random(n) < 0.15] = NIL64
    x = np.round(rng.normal(0, 50, n), 2)
    x[rng.random(n) < 0.15] = np.nan
    return {
        "n": n, "order": order,
        "pb": (RW.diff(rp), TW.diff(tp)),
        "ob": (RW.multi_boundary([ro], n), TW.multi_boundary([to], n)),
        "o": (ro, to), "v": both(v, "I64"), "x": both(x, "F64"),
        "d": both(v, ("dec", 12, 2)),
        "v32": both(rng.integers(-9, 9, n).astype(np.int32), "I32"),
        "s": both_str(list(rng.choice(["a", "b", "c", "d"], n))),
        "b": both(rng.random(n) < 0.5, "BOOL", nonil=True),
    }


def test_boundaries(win):
    col_eq(*win["pb"])
    col_eq(*win["ob"])
    n = win["n"]
    col_eq(RW.first_row_boundary(2048, n),
           TW.first_row_boundary(2048, n, CPU))
    (ra, ta), (rb, tb) = win["v"], win["x"]
    col_eq(RW.multi_boundary([ra, rb], n), TW.multi_boundary([ta, tb], n))
    # the primitives under the ranking functions
    rpb, tpb = win["pb"]
    arr_eq(RW._seg_start(rpb.data), TW._seg_start(tpb.data))
    nv = (rpb.data | win["ob"][0].data, tpb.data | win["ob"][1].data)
    arr_eq(RW._next_start(nv[0]), TW._next_start(nv[1]))
    rs, rpid = RW._part_size(rpb.data, n)
    ts, tpid = TW._part_size(tpb.data, n)
    arr_eq(rs, ts)
    arr_eq(rpid, tpid)


@pytest.mark.parametrize("fn", ["rank", "dense_rank", "percent_rank",
                                "cume_dist"])
def test_ranking(win, fn):
    (rpb, tpb), (rob, tob) = win["pb"], win["ob"]
    col_eq(getattr(RW, fn)(rpb, rob), getattr(TW, fn)(tpb, tob))
    # no ORDER BY: every row of a partition is a peer
    col_eq(getattr(RW, fn)(rpb, rpb), getattr(TW, fn)(tpb, tpb))


def test_row_number_ntile(win):
    rpb, tpb = win["pb"]
    col_eq(RW.row_number(rpb), TW.row_number(tpb))
    for k in (1, 3, 4, 100):
        col_eq(RW.ntile(rpb, k), TW.ntile(tpb, k))


@pytest.mark.parametrize("name", ["v", "x", "d", "v32", "s", "b"])
def test_lag_lead_and_value_functions(win, name):
    rpb, tpb = win["pb"]
    rc, tc = win[name]
    for off in (1, 2, 7):
        col_eq(RW.lag(rc, rpb, off), TW.lag(tc, tpb, off))
        col_eq(RW.lead(rc, rpb, off), TW.lead(tc, tpb, off))
    if name in ("v", "x"):
        col_eq(RW.lag(rc, rpb, 1, default=5), TW.lag(tc, tpb, 1, default=5))
    col_eq(RW.first_value(rc, rpb), TW.first_value(tc, tpb))
    col_eq(RW.last_value(rc, rpb), TW.last_value(tc, tpb))
    for k in (1, 2, 5):
        col_eq(RW.nth_value(rc, rpb, k), TW.nth_value(tc, tpb, k))


@pytest.mark.parametrize("name", ["v", "x", "d"])
def test_cume_window_sum(win, name):
    rc, tc = win[name]
    col_eq(RW.cume_window_sum(rc, win["pb"][0]),
           TW.cume_window_sum(tc, win["pb"][1]), SCAN_RTOL)


@pytest.mark.parametrize("frame", ["rows", "range", "full"])
@pytest.mark.parametrize("func", ["sum", "avg", "min", "max", "count",
                                  "count_star"])
def test_windowed_agg(win, func, frame):
    (rpb, tpb), (rob, tob), n = win["pb"], win["ob"], win["n"]
    names = [None] if func == "count_star" else \
        ["v", "x", "d", "v32"] + (["s", "b"] if func in ("min", "max",
                                                         "count") else [])
    for name in names:
        rc, tc = win[name] if name else (None, None)
        col_eq(RW.windowed_agg(func, rc, rpb, rob, frame, n),
               TW.windowed_agg(func, tc, tpb, tob, frame, n),
               SCAN_RTOL if name == "x" and func in ("sum", "avg")
               else None)


_FRAMES = [("rows", -1, 1), ("rows", -3, 0), ("rows", None, 2),
           ("rows", 1, None), ("rows", 2, 5), ("rows", -5, -2),
           ("range", -2, 2), ("range", -1, 0), ("range", None, 1),
           ("range", 0, None), ("range", 1, 3),
           ("groups", -1, 1), ("groups", None, 0), ("groups", 1, 2)]


@pytest.mark.parametrize("unit,lo,hi", _FRAMES)
@pytest.mark.parametrize("func", ["sum", "avg", "min", "max", "count"])
def test_framed_agg(win, func, unit, lo, hi):
    (rpb, tpb), n = win["pb"], win["n"]
    ro, to = win["o"]
    for name in ("v", "x", "d"):
        rc, tc = win[name]
        col_eq(RW.framed_agg(func, rc, rpb, ro.data, unit, lo, hi, n),
               TW.framed_agg(func, tc, tpb, to.data, unit, lo, hi, n),
               SCAN_RTOL if name == "x" and func in ("sum", "avg")
               else None)
    if func == "count":
        col_eq(RW.framed_agg("count_star", None, rpb, ro.data, unit, lo,
                             hi, n),
               TW.framed_agg("count_star", None, tpb, to.data, unit, lo,
                             hi, n))


def test_range_frame_on_constant_and_float_keys(win):
    """A constant order key (every row a peer) and a float order key."""
    (rpb, tpb), n = win["pb"], win["n"]
    ro, to = win["o"]
    rc, tc = win["v"]
    rconst = ro.data * 0 + 3
    tconst = to.data * 0 + 3
    col_eq(RW.framed_agg("sum", rc, rpb, rconst, "range", -1, 1, n),
           TW.framed_agg("sum", tc, tpb, tconst, "range", -1, 1, n))
    rf, tf = both(win["order"].astype(np.float64) / 2, "F64")
    col_eq(RW.framed_agg("max", rc, rpb, rf.data, "range", -1, 1, n),
           TW.framed_agg("max", tc, tpb, tf.data, "range", -1, 1, n))
    with pytest.raises(ValueError):
        TW.framed_agg("sum", tc, tpb, None, "range", -1, 1, n)


def test_segmented_scan_primitives():
    """The port's own building blocks against a plain numpy loop."""
    rng, part, _order = sorted_partitions(5, 700, 30, 5)
    bound = np.r_[True, part[1:] != part[:-1]]
    v = rng.integers(-50, 50, 700).astype(np.int64)
    f = rng.normal(0, 1, 700)
    tb = torch.from_numpy(bound)
    for op, arr, red in (("sum", v, np.add), ("min", v, np.minimum),
                         ("max", v, np.maximum), ("sum", f, np.add),
                         ("max", f, np.maximum)):
        want = arr.copy()
        for i in range(1, 700):
            if not bound[i]:
                want[i] = red(want[i - 1], arr[i])
        got = TW._seg_scan(torch.from_numpy(arr), tb, op=op).numpy()
        if arr.dtype.kind == "f" and op == "sum":
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        else:
            assert np.array_equal(got, want)
    # range min/max over arbitrary [s, e)
    s = rng.integers(0, 700, 700)
    e = np.minimum(s + rng.integers(1, 200, 700), 700)
    for op, red in (("min", np.min), ("max", np.max)):
        got = TW._range_minmax(torch.from_numpy(v), torch.from_numpy(s),
                               torch.from_numpy(e), op=op, levels=11)
        assert got.tolist() == [int(red(v[a:b])) for a, b in zip(s, e)]
    n = torch.tensor([1, 2, 3, 4, 7, 8, 1023, 1024, 2 ** 40 + 1])
    assert TW._floor_log2(n).tolist() == [0, 1, 1, 2, 2, 3, 9, 10, 40]


# ---------------------------------------------------------------------------
# SQL through both Engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch():
    return (Engine(load_tpch(0.01, device="cpu")),
            RefEngine(ref_load_tpch(0.01)))


def _same(eng, ref, sql):
    binder.Binder._auto_counter = ref_binder.Binder._auto_counter = 0
    f0 = TF.STATS["fallbacks"]
    got, want = eng.query(sql), ref.query(sql)
    assert TF.STATS["fallbacks"] == f0 + 1      # window -> executor
    assert_same_result(got, want, EXECUTOR_RTOL, EXECUTOR_ATOL)
    return list(got.rows)


@pytest.mark.parametrize("name", list(SQL_CASES))
def test_window_sql(tpch, name):
    case = SQL_CASES[name]
    sql = case[0] if isinstance(case, tuple) else case
    rows = _same(*tpch, sql)
    assert len(rows) >= 100


@pytest.mark.parametrize("sql", MORE_SQL, ids=[str(i) for i in
                                               range(len(MORE_SQL))])
def test_more_window_sql(tpch, sql):
    assert len(_same(*tpch, sql)) > 0


@pytest.fixture(scope="module")
def frames():
    """The table w(g, o, v) of the reference's explicit-frame tests, as a
    catalog in both packages."""
    g, o, v = zip(*ROWS)
    v = np.array([NIL64 if x is None else x for x in v], np.int64)
    return _catalogs({"w": {
        "g": (np.array(g, np.int64), "I64", {}),
        "o": (np.array(o, np.int64), "I64", {}),
        "v": (v, "I64", {})}})


@pytest.mark.parametrize("func,unit,lo,hi", FRAME_CASES)
def test_frame_sql(frames, func, unit, lo, hi):
    sql = (f"select {func}(v) over (partition by g order by o "
           f"{frame_sql(unit, lo, hi)}) from w order by g, o")
    got = [r[0] for r in _same(*frames, sql)]
    exp = oracle(ROWS, func, unit, lo, hi)
    if func == "avg":
        got = [None if x is None else round(x, 9) for x in got]
        exp = [None if x is None else round(x, 9) for x in exp]
    assert got == exp


@pytest.mark.parametrize("sql,lo,hi", [
    ("range between 2 preceding and 2 following", -2, 2),
    ("range between 1 preceding and 0 following", 0, 1),
])
def test_frame_sql_desc(frames, sql, lo, hi):
    got = [r[0] for r in _same(
        *frames, f"select sum(v) over (partition by g order by o desc {sql})"
        " from w order by g, o")]
    assert got == oracle(ROWS, "sum", "range", lo, hi)
