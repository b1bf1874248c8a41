"""TPC-H SF1 correctness envelope of the PyTorch port: the counterpart of
``tests/test_tpch_sf1.py``, with its three tests.  All 22 queries at SF1
against the independent sqlite oracle (``tests/tpch_sqlite_oracle.py``),
no fallback on Q1 and Q6, and a group-by, a top-k and a window over
100,000,000 rows.

Opt-in (``MTPU_SF1=1``): it generates the ~6M-row lineitem and takes
minutes.  The device is ``MTPU_TORCH_DEVICE`` (default ``cpu``).  It
imports no JAX, so on a machine with a card and no JAX it runs as

    MTPU_SF1=1 MTPU_TORCH_DEVICE=cuda python -m pytest tests/test_torch_sf1.py --noconftest
"""

import datetime
import os
from decimal import Decimal

import numpy as np
import pytest

sf1 = pytest.mark.skipif(not os.environ.get("MTPU_SF1"),
                         reason="SF1 envelope: set MTPU_SF1=1 (slow)")

_EPOCH = datetime.date(1970, 1, 1)


def _device():
    return os.environ.get("MTPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def data():
    from monetdb_tpu_torch.bench.tpch_gen import gen_tpch
    return gen_tpch(1.0)


@pytest.fixture(scope="module")
def engine(data):
    from monetdb_tpu_torch.bench.tpch_load import load_tables
    from monetdb_tpu_torch.engine import Engine
    return Engine(load_tables(data, device=_device()))


@pytest.fixture(scope="module")
def oracle_con(data):
    from tpch_sqlite_oracle import load_sqlite
    con = load_sqlite(data)
    con.execute("create index idx_l_pk on lineitem(l_partkey, l_suppkey)")
    con.execute("create index idx_l_ok on lineitem(l_orderkey)")
    con.execute("create index idx_o_ck on orders(o_custkey)")
    con.execute("analyze")
    yield con
    con.close()


def _convert_oracle_row(row, types):
    """A sqlite row in the engine's value types (``test_tpch_sql.py``'s
    conversion, over the port's dtypes)."""
    from monetdb_tpu_torch.dtypes import Kind
    out = []
    for v, t in zip(row, types):
        if v is None:
            out.append(None)
        elif t is not None and t.kind == Kind.DECIMAL:
            out.append(Decimal(int(v)).scaleb(-t.scale))
        elif t is not None and t.kind == Kind.DATE:
            out.append(_EPOCH + datetime.timedelta(days=int(v)))
        elif isinstance(v, float):
            out.append(v)
        elif t is not None and t.np_dtype.kind == "f":
            out.append(float(v))
        else:
            out.append(v)
    return tuple(out)


def _row_eq(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x is None or y is None:
            if x is not y:
                return False
        elif isinstance(x, float) or isinstance(y, float):
            if abs(float(x) - float(y)) > 1e-9 * max(1.0, abs(float(y))):
                return False
        elif x != y:
            return False
    return True


def _norm(r):
    return tuple("~" if isinstance(v, float) else v for v in r)


@sf1
@pytest.mark.parametrize("q", list(range(1, 23)))
def test_tpch_sf1_query(q, engine, oracle_con):
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    from tpch_sqlite_oracle import ORACLE

    res = engine.query(QUERIES[q])
    want_raw = oracle_con.execute(ORACLE[q]).fetchall()
    want = [_convert_oracle_row(r, res.types) for r in want_raw]
    assert len(res.rows) == len(want), \
        f"q{q}: {len(res.rows)} rows != oracle {len(want)}"
    got_sorted = sorted(res.rows, key=lambda r: str(_norm(r)))
    want_sorted = sorted(want, key=lambda r: str(_norm(r)))
    for ra, rb in zip(got_sorted, want_sorted):
        assert _row_eq(ra, rb), f"q{q}: {ra} != {rb}"


@sf1
def test_sf1_all_fused(engine):
    """No silent fallbacks at SF1."""
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    from monetdb_tpu_torch.exec.fragment import STATS
    before = dict(STATS)
    engine.query(QUERIES[1])
    engine.query(QUERIES[6])
    assert STATS["fallbacks"] == before["fallbacks"]


@sf1
def test_100m_row_sort_window_admission():
    """100M-row grouped aggregate, ORDER BY + LIMIT and window function
    (``test_tpch_sf1.py``'s statements, seed and asserts)."""
    from monetdb_tpu_torch.column import Column
    from monetdb_tpu_torch.dtypes import I32, I64
    from monetdb_tpu_torch.engine import Engine
    from monetdb_tpu_torch.table import Catalog, Table

    n = 100_000_000
    rng = np.random.default_rng(11)
    k = rng.integers(0, 1 << 30, n).astype(np.int64)
    g = (k & 7).astype(np.int32)
    cat = Catalog()
    cat.add(Table.from_dict("big", {
        "g": Column.from_numpy(g, I32, device=_device()),
        "k": Column.from_numpy(k, I64, device=_device()),
    }))
    eng = Engine(cat)
    # grouped aggregate over all 100M rows
    r = eng.query("select g, count(*), min(k), max(k) from big "
                  "group by g order by g")
    assert len(r.rows) == 8
    assert sum(row[1] for row in r.rows) == n
    # global sort + limit (top-k over 100M rows)
    r2 = eng.query("select k from big order by k desc limit 5")
    top = np.partition(k, n - 5)[n - 5:]
    assert [int(x[0]) for x in r2.rows] == sorted(
        (int(v) for v in top), reverse=True)
    # window function over partitions
    r3 = eng.query(
        "select g, mx from (select g, k, max(k) over "
        "(partition by g) as mx from big) where k = mx order by g")
    mx = {gi: int(k[g == gi].max()) for gi in range(8)}
    got = {int(a): int(b) for a, b in r3.rows}
    assert got == mx
