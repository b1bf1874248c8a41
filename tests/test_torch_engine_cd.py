"""Slices C and D of the PyTorch port (monetdb_tpu_torch, device="cpu")
against the reference JAX Engine (monetdb_tpu) on the same data.

Synthetic tables for what TPC-H Q7, Q8, Q9, Q11-Q17, Q21 and Q22 lean on
(the queries themselves are in test_torch_tpch_paths.py): CASE with errors
in taken and untaken branches, date extraction before 1970, float
arithmetic, distinct and moment aggregates, NOT / IS NULL / IN, scalar
subqueries that come back empty or nil, expanding joins of every kind, and
the rest of the single-device IR (DISTINCT, casts, COALESCE, NULLIF, math).
Everything must be equal but floats, which get rel 1e-12
(tests/torch_parity.py); each statement runs cold and warm.
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from monetdb_tpu.ops.calc import CalcError as RefCalcError  # noqa: E402
import monetdb_tpu.sql.binder as ref_binder  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
import monetdb_tpu_torch.sql.binder as binder  # noqa: E402

from test_torch_cuda import (  # noqa: E402
    AGG_SQL, CASE_SQL, ERROR_SQL, EXPR_SQL, JOIN_EXPAND_SQL, SUBQUERY_SQL,
    agg_table, dup_tables, expr_table)
from test_torch_engine import _catalogs  # noqa: E402
from torch_parity import (  # noqa: E402
    FRAGMENT_RTOL, assert_rows_close, assert_same_result)


@pytest.fixture(autouse=True)
def _same_generated_names():
    """Generated result names (``col<N>``) come from a process-wide counter
    in each binder; start both at 0, whatever other files of the same
    worker bound before."""
    binder.Binder._auto_counter = ref_binder.Binder._auto_counter = 0


_NIL32 = int(np.iinfo(np.int32).min)
_NIL64 = int(np.iinfo(np.int64).min)


def _ir_nodes(ir, out=None):
    """Names of the IR nodes (the first string of each tuple) in ``ir``."""
    out = set() if out is None else out
    if isinstance(ir, tuple):
        if ir and isinstance(ir[0], str):
            out.add(ir[0])
        for x in ir:
            _ir_nodes(x, out)
    return out


def _plan_nodes(eng, sql):
    return _ir_nodes(eng._cached_plan(sql).fragment.rel_ir)


def _assert_same_result(eng, ref, sql):
    """Names, types and rows of both engines, on a cold and a warm run."""
    got, want = eng.query(sql), ref.query(sql)
    assert_same_result(got, want, FRAGMENT_RTOL)
    assert_rows_close(list(eng.query(sql).rows), list(want.rows),
                      FRAGMENT_RTOL)
    return list(got.rows)


def _assert_same_error(eng, ref, sql, err):
    with pytest.raises(RefCalcError) as want:
        ref.query(sql)
    with pytest.raises(err) as got:
        eng.query(sql)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sql", CASE_SQL)
def test_case_masks_errors_of_untaken_branches(sql):
    eng, ref = _catalogs(expr_table())
    _assert_same_result(eng, ref, sql)
    assert _plan_nodes(eng, sql) & {"case", "ifnil"}


@pytest.mark.parametrize("sql,err", ERROR_SQL)
def test_errors_of_taken_branches_match_reference(sql, err):
    eng, ref = _catalogs(expr_table())
    _assert_same_error(eng, ref, sql, err)


@pytest.mark.parametrize("sql", EXPR_SQL)
def test_expressions_match_reference(sql):
    eng, ref = _catalogs(expr_table())
    _assert_same_result(eng, ref, sql)


def test_timestamp_and_time_extraction_matches_reference():
    ts = np.array([0, 1, -1, 86_400_000_000 * 365 + 3_723_000_004,
                   -86_400_000_000 * 400 - 5, _NIL64,
                   1_700_000_000_123_456, 951_782_400_000_000], np.int64)
    tm = np.array([0, 1, 3_723_000_004, 86_399_999_999, _NIL64,
                   43_200_000_000, 60_000_000, 59_999_999], np.int64)
    eng, ref = _catalogs({"t": {
        "id": (np.arange(8, dtype=np.int32), "I32", {}),
        "ts": (ts, "TIMESTAMP", {}), "tm": (tm, "TIME", {})}})
    for sql, node in [
            ("select id, extract(hour from tm), extract(minute from tm), "
             "extract(second from tm), extract(epoch from tm) from t "
             "order by id", "textract"),
            ("select id, extract(year from ts), extract(month from ts), "
             "extract(day from ts), extract(hour from ts), "
             "extract(minute from ts), extract(second from ts), "
             "extract(epoch from ts), dayofweek(ts), weekofyear(ts) from t "
             "order by id", "dextract"),
            ("select id, date_trunc('year', ts), date_trunc('quarter', ts), "
             "date_trunc('month', ts), date_trunc('week', ts), "
             "date_trunc('day', ts), date_trunc('hour', ts), "
             "date_trunc('decade', ts), date_trunc('century', ts) from t "
             "order by id", "dtrunc")]:
        _assert_same_result(eng, ref, sql)
        assert node in _plan_nodes(eng, sql)


def test_input_node_reads_the_input():
    """``("in", i)`` has no producer in today's lowering; the node stays
    because the IR is shared with the reference."""
    lut = torch.arange(5)
    live = torch.ones(5, dtype=torch.bool)
    assert TF._Interp([lut]).ev(("in", 0), {}, live) is lut


# ---------------------------------------------------------------------------
# scalar subqueries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sql,node", SUBQUERY_SQL)
def test_scalar_subquery_is_baked_as_in_reference(sql, node):
    eng, ref = _catalogs(expr_table())
    _assert_same_result(eng, ref, sql)
    assert node in _plan_nodes(eng, sql)


def test_scalar_subquery_with_string_value():
    eng, ref = _catalogs({"t": {
        "id": (np.arange(6, dtype=np.int32), "I32", {}),
        "s": (["b", "a", None, "c", "a", "b"], "str", {})}})
    for sql in ("select id from t where s = (select min(s) from t) "
                "order by id",
                "select id from t where s > (select min(s) from t where "
                "id > 100) order by id"):
        _assert_same_result(eng, ref, sql)


# ---------------------------------------------------------------------------
# aggregates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def agg_engines():
    return _catalogs(agg_table())


@pytest.mark.parametrize("sql", AGG_SQL)
def test_distinct_and_moment_aggregates_match_reference(agg_engines, sql):
    eng, ref = agg_engines
    _assert_same_result(eng, ref, sql)


# ---------------------------------------------------------------------------
# expanding joins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sql", JOIN_EXPAND_SQL)
def test_join_expand_overflows_then_matches_reference(sql):
    """Every kind, with a cross-side residual, a build-side filter and
    none: the first attempt finds the duplicates, the second overflows the
    expansion capacity, the third runs at the measured total."""
    eng, ref = _catalogs(dup_tables())
    stats0 = dict(TF.STATS)
    _assert_same_result(eng, ref, sql)
    assert "join_expand" in _plan_nodes(eng, sql)
    assert TF.STATS["uniq_retries"] == stats0["uniq_retries"] + 1
    if "b.w > 90" not in sql:
        assert TF.STATS["cap_retries"] > stats0["cap_retries"]


def test_join_expand_with_empty_sides():
    tables = dup_tables()
    for side, col in (("p", "x"), ("b", "x")):
        arr, kind, props = tables[side][col]
        empty = dict(tables)
        empty[side] = dict(tables[side])
        empty[side][col] = (np.full_like(arr, _NIL32), kind, props)
        eng, ref = _catalogs(empty)
        for sql in ("select p.id, b.bid from p, b where p.x = b.x "
                    "order by p.id, b.bid",
                    "select p.id, b.bid from p left join b on p.x = b.x "
                    "order by p.id, b.bid"):
            _assert_same_result(eng, ref, sql)
