"""The port's numpy oracle (monetdb_tpu_torch/bench/tpch_oracle.py) against
the reference JAX engine at SF0.01: the answer the GPU run is held to at
SF1, where no reference engine exists, is itself held to the reference
here, where both do.  Decimals, integers, strings, dates and counts must
be equal; floats (Q1's averages, Q8, Q14, Q17) to rel 1e-12 (the oracle
divides python ints, the engine float64 sums).  Four of the oracles with
integer, decimal and string answers are also held to the SQL of the
suite's sqlite oracle (tests/tpch_sqlite_oracle.py), a third
implementation.
"""

import datetime
from decimal import Decimal

import pytest

from monetdb_tpu.bench.tpch_load import load_tables as ref_load_tables
from monetdb_tpu.engine import Engine as RefEngine
from monetdb_tpu_torch.bench import tpch_oracle
from monetdb_tpu_torch.bench.tpch_gen import gen_tpch
from monetdb_tpu_torch.bench.tpch_queries import QUERIES

from tpch_sqlite_oracle import ORACLE as SQLITE_SQL, load_sqlite

_FLOAT_RTOL = 1e-12


@pytest.fixture(scope="module")
def data_and_engine():
    data = gen_tpch(0.01)
    return data, RefEngine(ref_load_tables(data))


@pytest.mark.parametrize("q", sorted(tpch_oracle.ORACLES))
def test_oracle_matches_reference_engine(data_and_engine, q):
    data, ref = data_and_engine
    want = list(ref.query(QUERIES[q]).rows)
    assert want, "an empty answer checks nothing"
    got = tpch_oracle.decoded(q, tpch_oracle.ORACLES[q](data))
    assert tpch_oracle.rows_differ(got, want, _FLOAT_RTOL) is None


def test_every_query_has_an_oracle():
    assert sorted(tpch_oracle.ORACLES) == sorted(QUERIES) == \
        sorted(tpch_oracle.KINDS) == list(range(1, 23))


@pytest.fixture(scope="module")
def sqlite_con(data_and_engine):
    con = load_sqlite(data_and_engine[0])
    yield con
    con.close()


@pytest.mark.parametrize("q", [12, 13, 16, 22])
def test_oracle_matches_sqlite(data_and_engine, sqlite_con, q):
    """Physical rows (strings, integers and scaled decimals only in these
    four) equal sqlite's, in order: Q12 has the CASE sums, Q13 the LIKE
    with two wildcards and a count over an outer join, Q16 the distinct
    count, Q22 the float average and NOT EXISTS.  (Q21 takes sqlite over a
    minute.)"""
    data, _ref = data_and_engine
    want = [tuple(r) for r in sqlite_con.execute(SQLITE_SQL[q]).fetchall()]
    assert want
    assert tpch_oracle.rows_differ(tpch_oracle.ORACLES[q](data), want,
                                   0.0) is None


def test_decoded_and_rows_differ():
    """The helpers the GPU run compares with: physical values become SQL
    values, and any difference in value, type, order or length is named."""
    rows = tpch_oracle.decoded(3, [(7, 123456, 9204, 0)])
    assert rows == [(7, Decimal("12.3456"), datetime.date(1995, 3, 15), 0)]
    assert tpch_oracle.decoded(19, [(None,)]) == [(None,)]
    same = [("a", Decimal("1.50"), 2.0)]
    assert tpch_oracle.rows_differ(same, same, 0.0) is None
    assert tpch_oracle.rows_differ(same, [("a", Decimal("1.50"),
                                           2.0 * (1 + 1e-13))], 1e-12) is None
    for other in ([("a", Decimal("1.51"), 2.0)], [("a", 1.5, 2.0)],
                  [("a", Decimal("1.50"), 2.1)], same + same, []):
        assert tpch_oracle.rows_differ(same, other, 1e-12) is not None
    assert tpch_oracle.rows_differ([(1,), (2,)], [(2,), (1,)], 0) is not None
