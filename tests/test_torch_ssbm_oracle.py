"""The numpy SSBM oracle (``bench/ssbm_oracle.py``) against sqlite3 on the
13 queries, and the port's ``Engine`` on the CPU against the oracle with
no fallback.  Two generated sizes (20,000 rows, seed 11; 3,000 rows, seed
5), and one where the dimension values the selective queries name are
made common, so that Q2.3, Q3.3 and Q3.4 have rows at a small size.
Imports no JAX."""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import sqlite3  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from monetdb_tpu_torch.bench.ssbm import (QUERIES, SCHEMA,  # noqa: E402
                                           gen_ssbm)
from monetdb_tpu_torch.bench.ssbm_oracle import (ORDERED,  # noqa: E402
                                                 expected)


def _oracle(data):
    """sqlite3 over the same arrays (as ``tests/test_ssbm.py`` loads it)."""
    con = sqlite3.connect(":memory:")
    for tname, cols in data.items():
        names = list(cols)
        con.execute(f"create table {tname} ({', '.join(names)})")
        pyarrs = [[int(v) for v in a] if a.dtype.kind in "iu"
                  else [str(v) for v in a] for a in cols.values()]
        con.executemany(
            f"insert into {tname} values ({','.join('?' * len(names))})",
            list(zip(*pyarrs)))
    return con


def _common(data, seed=3):
    """A third of the customers and suppliers moved to the cities 'UNITED
    KI1' and 'UNITED KI5', a third to 'UNITED ST1' and 'UNITED ST5' (with
    their nation and region), half the parts to brand 'MFGR#2239', half
    the orders into December 1997."""
    rng = np.random.default_rng(seed)
    for dim, p in (("customer", "c"), ("supplier", "s")):
        t = data[dim]
        pick = rng.integers(0, 3, len(t[f"{p}_city"]))
        digit = np.where(rng.random(pick.shape) < 0.5, "1", "5")
        for k, city, nation, region in (
                (1, "UNITED KI", "UNITED KINGDOM", "EUROPE"),
                (2, "UNITED ST", "UNITED STATES", "AMERICA")):
            hot = pick == k
            t[f"{p}_city"] = np.where(hot, np.char.add(city, digit),
                                      t[f"{p}_city"])
            t[f"{p}_nation"] = np.where(hot, nation, t[f"{p}_nation"])
            t[f"{p}_region"] = np.where(hot, region, t[f"{p}_region"])
    part = data["part"]
    hot = rng.random(len(part["p_brand1"])) < 0.5
    part["p_brand1"] = np.where(hot, "MFGR#2239", part["p_brand1"])
    part["p_category"] = np.where(hot, "MFGR#23", part["p_category"])
    part["p_mfgr"] = np.where(hot, "MFGR#2", part["p_mfgr"])
    dec97 = data["dates"]["d_datekey"][
        data["dates"]["d_yearmonth"] == "Dec1997"]
    lo = data["lineorder"]
    hot = rng.random(len(lo["lo_orderdate"])) < 0.5
    lo["lo_orderdate"] = np.where(
        hot, dec97[rng.integers(0, len(dec97), len(hot))], lo["lo_orderdate"])
    return data


_SIZES = {"20000-s11": lambda: gen_ssbm(20_000, 11),
          "3000-s5": lambda: gen_ssbm(3_000, 5),
          "3000-s5-common": lambda: _common(gen_ssbm(3_000, 5))}
_DATA = {}


def _data(size):
    if size not in _DATA:
        data = _SIZES[size]()
        _DATA[size] = (data, expected(data))
    return _DATA[size]


def _same(qid, got, want):
    if qid not in ORDERED:
        got, want = sorted(got, key=str), sorted(want, key=str)
    return got == want


@pytest.fixture(scope="module")
def sqlite_of():
    cons = {}

    def get(size):
        if size not in cons:
            cons[size] = _oracle(_data(size)[0])
        return cons[size]
    yield get
    for con in cons.values():
        con.close()


@pytest.mark.parametrize("size", sorted(_SIZES))
@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_oracle_equals_sqlite(sqlite_of, size, qid):
    _data_, rows = _data(size)
    want = [tuple(r) for r in sqlite_of(size).execute(QUERIES[qid])]
    assert _same(qid, rows[qid], want), (qid, rows[qid][:3], want[:3])


def test_common_values_give_rows():
    """The third size reaches the rows the two generated sizes leave
    empty (2.3, 3.3 and 3.4 at 3,000 and 20,000 rows)."""
    _d, rows = _data("3000-s5-common")
    assert all(len(r) > 0 and r[0] != (None,) for r in rows.values())


@pytest.fixture(scope="module")
def engines():
    from monetdb_tpu_torch.bench.tpch_load import make_column
    from monetdb_tpu_torch.engine import Engine
    from monetdb_tpu_torch.table import Catalog, Table
    engs = {}

    def get(size):
        if size not in engs:
            cat = Catalog()
            for tname, cols in _data(size)[0].items():
                cat.add(Table.from_dict(tname, {
                    c: make_column(a, SCHEMA[tname][c], "cpu")
                    for c, a in cols.items()}))
            engs[size] = Engine(cat)
        return engs[size]
    return get


@pytest.mark.parametrize("size", sorted(_SIZES))
@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_port_engine_equals_oracle(engines, size, qid):
    from monetdb_tpu_torch.exec import fragment
    falls = fragment.STATS["fallbacks"]
    got = list(engines(size).query(QUERIES[qid]).rows)
    assert fragment.STATS["fallbacks"] == falls
    assert _same(qid, got, _data(size)[1][qid])
