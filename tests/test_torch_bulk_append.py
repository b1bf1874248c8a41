"""The store's bulk load path (``embedded.Connection.append`` ->
``Database.insert`` -> ``TableData.append``) and its upload
(``Database._materialize``), on the CPU:

* a bulk append of numeric, categorical and ``str`` columns with NULLs
  gives the codes, dictionaries and answers of the same rows inserted
  by ``INSERT`` statements; ``to_physical_bulk`` equals the value-by-value
  ``to_physical_np``;
* a second append merges the dictionaries (new strings before, after and
  among the old ones), and code order stays string order;
* NOT NULL, PRIMARY KEY, UNIQUE, FOREIGN KEY and CHECK still raise on
  bulk input, a malformed ``Categorical`` is refused;
* a durable store reopened after a bulk append gives the same rows, and
  the WAL's string encoding is the value-by-value one;
* the upload's flags equal ``qbench/entries/engine_query.props`` and
  ``Column.from_numpy``'s on the same values;
* a table with no deleted row holds no ``__rowid__`` tensor, and DELETE,
  UPDATE and MERGE after a bulk load are right;
* the ``load.*`` counters grow by the appended rows and uploaded bytes,
  one ``load.append`` span an insert;
* the store keeps nothing of the caller's arrays: a buffer refilled or
  changed after ``append``, or before a transaction's COMMIT, changes no
  row and no WAL record.
"""

import datetime
import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from monetdb_tpu_torch import embedded  # noqa: E402
from monetdb_tpu_torch.column import Column  # noqa: E402
from monetdb_tpu_torch.dtypes import (  # noqa: E402
    DATE, F64, I16, I32, I64, TIMESTAMP, decimal, varchar)
from monetdb_tpu_torch.exec.fragment import STATS  # noqa: E402
from monetdb_tpu_torch.storage.columns import (  # noqa: E402
    NIL_CODE, Categorical, RowidColumn, device_props, make_device_column,
    to_physical_bulk, to_physical_np)
from monetdb_tpu_torch.storage.database import Database  # noqa: E402
from qbench.entries.engine_query import props as engine_props  # noqa: E402

SCHEMA = ("a int, b bigint, f double, d date, p decimal(10,2), "
          "s varchar(8), c varchar(8), n int")
COLS = ("a", "b", "f", "d", "p", "s", "c", "n")
CATS = np.array(["ant", "bee", "cat", "dog", "eel"])


def _rows(seed: int, n: int):
    """``n`` logical rows, NULLs in the text columns and ``n``."""
    rng = np.random.default_rng(seed)
    words = np.array(["kiwi", "fig", "apple", "date", "lime"])
    rows = []
    for i in range(n):
        s = None if i % 5 == 3 else str(words[rng.integers(0, 5)])
        c = None if i % 7 == 2 else str(CATS[rng.integers(1, 4)])
        rows.append((int(rng.integers(-50, 50)), int(rng.integers(0, 1 << 40)),
                     float(rng.integers(0, 1000)) / 8,
                     datetime.date(1995, 1, 1)
                     + datetime.timedelta(days=int(rng.integers(0, 900))),
                     float(rng.integers(-9999, 9999)) / 100, s, c,
                     None if i % 4 == 1 else int(rng.integers(0, 9))))
    return rows


def _bulk(rows, text: str):
    """The rows as ``Connection.append`` columns; text columns as a
    ``Categorical`` (over CATS, with unused categories), or as str /
    object arrays."""
    col = list(zip(*rows))
    c = list(col[6])
    if text == "categorical":
        codes = np.array([-1 if v is None else int(np.searchsorted(CATS, v))
                          for v in c], np.int32)
        cval = Categorical(codes, CATS)
    else:
        cval = np.array(c, object)
    return {"a": np.array(col[0], np.int64), "b": np.array(col[1]),
            "f": np.array(col[2]),
            "d": np.array([np.datetime64(v) for v in col[3]],
                          "datetime64[D]"),
            "p": np.array(col[4]), "s": np.array(col[5], object), "c": cval,
            "n": np.array(col[7], object)}


def _sql(v):
    if v is None:
        return "NULL"
    if isinstance(v, (str, datetime.date)):
        return f"'{v}'"
    return repr(v)


def _by_insert(rows):
    con = embedded.connect(device="cpu")
    con.query(f"create table t ({SCHEMA})")
    for r in rows:
        con.query("insert into t values (" + ", ".join(map(_sql, r)) + ")")
    return con


def _by_append(rows, text):
    con = embedded.connect(device="cpu")
    con.query(f"create table t ({SCHEMA})")
    assert con.append("t", _bulk(rows, text)) == len(rows)
    return con


def _state(con):
    td = con.db.tables["t"]
    return ({c: td.cols[c].tolist() for c in COLS},
            {c: td.dicts[c].tolist() for c in td.dicts})


QUERIES = ("select * from t order by a, b",
           "select c, count(*), sum(a) from t group by c order by c",
           "select s, c, max(p) from t where c > 'bee' or c is null "
           "group by s, c order by s, c",
           "select count(*) from t where s is null and n is not null")


@pytest.mark.parametrize("text", ["categorical", "str"])
@pytest.mark.parametrize("seed", [1, 2])
def test_bulk_append_equals_row_inserts(seed, text):
    rows = _rows(seed, 40)
    ref, got = _by_insert(rows), _by_append(rows, text)
    assert _state(got) == _state(ref)
    for q in QUERIES:
        assert got.query(q)[0].rows == ref.query(q)[0].rows, q


CASES = [  # (dtype of the input, column type, values)
    ("int64", I32, [3, -7, 0, 2 ** 31 - 1]),
    ("int8", I64, [1, -1, 5]),
    ("bool", I16, [True, False]),
    ("float64", I32, [2.5, 3.5, -1.5, 7.0]),
    ("int64", F64, [1, 2, 3]),
    ("float32", F64, [0.25, 1.5]),
    ("float64", decimal(12, 2), [1.005, -2.5, 3.0, 0.125]),
    ("int32", decimal(12, 3), [4, -5]),
    ("datetime64[D]", DATE, ["2020-02-29", "NaT", "1969-12-31"]),
    ("datetime64[us]", TIMESTAMP, ["2020-02-29T01:02:03.5", "NaT"]),
    ("datetime64[s]", DATE, ["2001-01-01T23:59:59"]),
]


@pytest.mark.parametrize("dtype,typ,vals", CASES,
                         ids=[f"{c[0]}-{c[1].kind.value}" for c in CASES])
def test_bulk_conversion_equals_value_by_value(dtype, typ, vals):
    arr = np.array(vals, dtype)
    got = to_physical_bulk(arr, typ)
    if arr.dtype.kind == "M":   # the value-by-value path takes date objects
        objs = [None if np.isnat(x) else x.item()
                for x in arr.astype("datetime64[us]")]
        if typ == DATE:
            objs = [v.date() if isinstance(v, datetime.datetime) else v
                    for v in objs]
        ref = to_physical_np(objs, typ)
    else:
        ref = to_physical_np(list(arr), typ)
    assert got.dtype == ref.dtype and got.tolist() == ref.tolist()


def test_bulk_conversion_overflows_as_value_by_value():
    with pytest.raises(OverflowError):
        to_physical_np([2 ** 40], I32)
    with pytest.raises(OverflowError):
        to_physical_bulk(np.array([2 ** 40]), I32)


@pytest.mark.parametrize("where", ["before", "after", "among"])
@pytest.mark.parametrize("text", ["categorical", "str"])
def test_second_append_merges_dictionaries(where, text):
    first = ["kiwi", "lime", None, "mango", "lime"]
    second = {"before": ["apple", "fig", None, "apple"],
              "after": ["pear", "plum", "pear"],
              "among": ["lemon", "kiwi", "nut", None, "aa", "zz"]}[where]
    db = Database(device="cpu")
    db.create_table("t", [("s", varchar())])
    for batch in (first, second):
        if text == "categorical":
            cats = np.array(sorted({v for v in batch if v is not None}))
            codes = np.array([-1 if v is None else
                              int(np.searchsorted(cats, v)) for v in batch])
            db.insert("t", {"s": Categorical(codes, cats)})
        else:
            db.insert("t", {"s": np.array(batch, object)})
    td = db.tables["t"]
    d, codes = td.dicts["s"], td.cols["s"]
    assert d.tolist() == sorted({v for v in first + second if v is not None})
    got = [None if k < 0 else str(d[k]) for k in codes]
    assert got == first + second
    assert (codes[codes >= 0] >= 0).all() and codes.min() == NIL_CODE
    live = codes[codes >= 0]
    assert np.array_equal(np.argsort(live, kind="stable"),
                          np.argsort(d[live], kind="stable"))


def test_categorical_drops_unused_categories_and_checks_its_input():
    db = Database(device="cpu")
    db.create_table("t", [("s", varchar())])
    db.insert("t", {"s": Categorical(np.array([3, 1, -1, 3], np.int32),
                                     np.array(["a", "b", "c", "d", "e"]))})
    td = db.tables["t"]
    assert td.dicts["s"].tolist() == ["b", "d"]
    assert td.cols["s"].tolist() == [1, 0, NIL_CODE, 1]
    # pandas' -1 and the store's own nil code mixed: both NULL
    db.insert("t", {"s": Categorical(np.array([-1, NIL_CODE, 0], np.int64),
                                     ["d"])})
    assert td.cols["s"].tolist()[4:] == [NIL_CODE, NIL_CODE, 1]
    for bad in (Categorical(np.array([0, 2]), np.array(["a", "b"])),
                Categorical(np.array([0, 1]), np.array(["b", "a"])),
                Categorical(np.array([0, 1]), np.array(["a", "a"])),
                Categorical(np.array([0.0]), np.array(["a"]))):
        with pytest.raises(ValueError):
            db.insert("t", {"s": bad})
    assert td.count == 7
    with pytest.raises(ValueError):
        to_physical_bulk(Categorical(np.array([0]), np.array(["a"])), I32)


def _con(ddl):
    con = embedded.connect(device="cpu")
    for stmt in ddl:
        con.query(stmt)
    return con


_KEYS = Categorical(np.array([0, 1], np.int32), np.array(["x", "y"]))
CONSTRAINTS = {
    "not_null_categorical": (
        ["create table t (k varchar(4) not null)"],
        {"k": Categorical(np.array([0, -1], np.int32), np.array(["x"]))}),
    "not_null_str": (["create table t (k varchar(4) not null)"],
                     {"k": np.array(["x", None], object)}),
    "not_null_int": (["create table t (k int not null)"],
                     {"k": np.array([1, np.iinfo(np.int32).min])}),
    "primary_key_int": (["create table t (k int primary key)"],
                        {"k": np.array([4, 5, 4])}),
    "primary_key_categorical": (
        ["create table t (k varchar(4) primary key)"],
        {"k": Categorical(np.array([0, 1, 0], np.int32),
                          np.array(["x", "y"]))}),
    "unique_str": (["create table t (k varchar(4) unique)"],
                   {"k": np.array(["x", "y", "x"])}),
    "foreign_key_categorical": (
        ["create table p (k varchar(4) primary key)",
         "insert into p values ('x')",
         "create table t (k varchar(4) references p (k))"],
        {"k": _KEYS}),
    "foreign_key_int": (
        ["create table p (k int primary key)", "insert into p values (1)",
         "create table t (k int references p (k))"],
        {"k": np.array([1, 2])}),
    "check_int": (["create table t (k int check (k > 0))"],
                  {"k": np.array([3, 0])}),
    "check_categorical": (
        ["create table t (k varchar(4) check (k <> 'y'))"],
        {"k": _KEYS}),
}


@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
def test_constraints_raise_on_bulk_input(name):
    ddl, data = CONSTRAINTS[name]
    con = _con(ddl)
    with pytest.raises(ValueError):
        con.append("t", data)
    assert con.query("select count(*) from t")[0].rows == [(0,)]


@pytest.mark.parametrize("checkpoint", [False, True])
def test_durable_store_reopens_with_the_same_rows(tmp_path, checkpoint):
    path = str(tmp_path / "db")
    rows = _rows(7, 30)
    con = embedded.connect(path, device="cpu")
    con.query(f"create table t ({SCHEMA})")
    con.append("t", _bulk(rows[:20], "categorical"))
    con.append("t", _bulk(rows[20:], "str"))
    if checkpoint:
        con.db.checkpoint()
    want = [con.query(q)[0].rows for q in QUERIES]
    state = _state(con)
    con.close()
    again = embedded.connect(path, device="cpu")
    assert [again.query(q)[0].rows for q in QUERIES] == want
    assert _state(again) == state == _state(_by_insert(rows))
    again.close()


@pytest.mark.parametrize("vals", [["a", None, "bcd"], [None, None], [],
                                  ["", "x"], ["é", None]])
def test_wal_string_encoding_is_the_value_by_value_one(vals):
    a = np.array(vals, object)
    enc = Database._wal_encode({"s": a})
    want = np.array(["" if v is None else str(v) for v in a], dtype=str)
    assert enc["s@s"].dtype == want.dtype
    assert enc["s@s"].tobytes() == want.tobytes()
    assert enc["s@nil"].tolist() == [v is None for v in vals]
    dec = Database._wal_decode(enc)["s"]
    assert dec.dtype == object and dec.tolist() == vals


def _flag_values():
    rng = np.random.default_rng(5)
    return {
        "ascending": np.arange(10, 40, dtype=np.int32),
        "descending": np.arange(40, 10, -1).astype(np.int64),
        "sorted_dups": np.sort(rng.integers(0, 9, 50)).astype(np.int32),
        "permutation": rng.permutation(64).astype(np.int32) + 7,
        "dense_dups": np.r_[np.arange(9), 3].astype(np.int32),
        "random": rng.integers(-1000, 1000, 70).astype(np.int32),
        "constant": np.full(5, 4, np.int32),
        "single": np.array([12], np.int64),
    }


FLAGS = ("minval", "maxval", "sorted", "revsorted", "key")


@pytest.mark.parametrize("name", sorted(_flag_values()))
def test_upload_flags_equal_the_engine_entry_props(name):
    vals = _flag_values()[name]
    typ = I64 if vals.dtype == np.int64 else I32
    col = make_device_column(vals, typ, device="cpu")
    want = engine_props(torch.from_numpy(vals))
    assert {f: getattr(col, f) for f in FLAGS} == want
    assert col.nonil is Column.from_numpy(vals, typ, device="cpu").nonil
    assert col.nonil is True
    assert col.data[:col.count].tolist() == vals.tolist()
    assert (col.data[col.count:] == int(typ.nil)).all()
    # string codes take the same flags (over the store's dictionary)
    d = np.array([f"v{i:05d}" for i in range(int(vals.max()) + 1)])
    if vals.min() >= 0 and len(d) < 100_000:
        scol = make_device_column(vals.astype(np.int32), varchar(), d,
                                  device="cpu", code_flags=True)
        assert {f: getattr(scol, f) for f in FLAGS} == engine_props(
            torch.from_numpy(vals.astype(np.int32)))
        # an operator's text result keeps none, as the reference's
        plain = make_device_column(vals.astype(np.int32), varchar(), d,
                                   device="cpu")
        assert (plain.minval, plain.sorted, plain.key) == (None, False,
                                                           False)


def test_upload_flags_compare_neighbours_without_overflow():
    """Differences of int32 neighbours can wrap (``torch.diff``); the
    upload compares the neighbours themselves."""
    vals = np.array([-2 ** 31 + 1, 2 ** 31 - 1, 0], np.int32)
    col = make_device_column(vals, I32, device="cpu")
    assert (col.sorted, col.revsorted, col.key) == (False, False, False)
    assert (col.minval, col.maxval) == (-2 ** 31 + 1, 2 ** 31 - 1)


@pytest.mark.parametrize("typ,vals", [
    (I32, np.array([1, np.iinfo(np.int32).min, 3], np.int32)),
    (F64, np.array([1.0, np.nan])), (F64, np.array([2.0, 1.0])),
    (varchar(), np.array([0, NIL_CODE], np.int32))],
    ids=["int_nil", "float_nil", "float", "str_nil"])
def test_upload_flags_with_nils_as_column_from_numpy(typ, vals):
    dv = np.array(["a"]) if typ.kind.value == "str" else None
    col = make_device_column(vals, typ, dv, device="cpu")
    ref = Column.from_numpy(vals, typ, device="cpu")
    assert col.nonil == ref.nonil
    assert (col.minval, col.sorted, col.key) == (None, False, False)
    assert device_props(torch.from_numpy(vals), typ)["nonil"] == ref.nonil


def test_database_columns_carry_the_engine_entry_flags():
    db = Database(device="cpu")
    db.create_table("t", [("k", I32), ("s", varchar())])
    vals = np.random.default_rng(3).permutation(100).astype(np.int32)
    db.insert("t", {"k": vals,
                    "s": Categorical(vals % 7, np.array(list("abcdefg")))})
    tbl, oids = db.table("t")
    assert oids is None
    for c, v in (("k", vals), ("s", vals % 7)):
        col = tbl.col(c)
        assert {f: getattr(col, f) for f in FLAGS} == engine_props(
            torch.from_numpy(v.astype(np.int32))), c
        assert col.nonil


def _loaded(n=50):
    con = embedded.connect(device="cpu")
    con.query("create table t (k int, s varchar(4), v int)")
    con.append("t", {"k": np.arange(n), "v": np.arange(n) * 10,
                     "s": Categorical(np.arange(n) % 3,
                                      np.array(["x", "y", "z"]))})
    return con


def test_no_rowid_tensor_without_deletions():
    con = _loaded()
    assert con.query("select s, sum(v) from t group by s order by s")[0] \
        .rows == [("x", 4080), ("y", 4250), ("z", 3920)]
    tbl, oids = con.db.table("t")
    rowid = tbl.col("__rowid__")
    assert isinstance(rowid, RowidColumn) and rowid._data is None
    assert oids is None and tbl.names() == ["k", "s", "v", "__rowid__"]
    assert (rowid.minval, rowid.maxval, rowid.key) == (0, 49, True)
    assert rowid.data[:50].tolist() == list(range(50))
    assert rowid.cap == tbl.col("k").cap


@pytest.mark.parametrize("stmt,want", [
    ("delete from t where s = 'y'",
     [(k, "xyz"[k % 3], k * 10) for k in range(50) if k % 3 != 1]),
    ("update t set v = -v where k > 45",
     [(k, "xyz"[k % 3], -k * 10 if k > 45 else k * 10) for k in range(50)]),
    ("merge into t using (select 3 as k2, 7 as v2) as src on t.k = src.k2 "
     "when matched then update set v = src.v2",
     [(k, "xyz"[k % 3], 7 if k == 3 else k * 10) for k in range(50)]),
])
def test_dml_after_a_bulk_load(stmt, want):
    con = _loaded()
    con.query("delete from t where k = 49")       # rows ids now mapped
    con.query(stmt)
    want = [r for r in want if r[0] != 49]
    assert con.query("select k, s, v from t order by k")[0].rows == want
    tbl, oids = con.db.table("t")
    assert oids is not None and len(oids) == len(want)
    assert tbl.col("__rowid__").data[:tbl.count].tolist() == oids.tolist()


def test_dml_on_dense_row_ids():
    con = _loaded()
    assert con.query("update t set v = 0 where k < 5")[1] == 5
    assert con.query("delete from t where k >= 40")[1] == 10
    got = con.query("select k, v from t order by k")[0].rows
    assert got == [(k, 0 if k < 5 else k * 10) for k in range(40)]


@pytest.mark.parametrize("text", ["categorical", "str"])
def test_parallel_append_equals_serial(monkeypatch, text):
    from monetdb_tpu_torch.storage import database
    rows = _rows(5, 40)
    serial = _by_append(rows, text)
    monkeypatch.setattr(database, "_PARALLEL_ROWS", 1)
    assert _state(_by_append(rows, text)) == _state(serial)
    again = _by_append(rows[:25], text)             # into a full table
    again.append("t", _bulk(rows[25:], text))
    assert _state(again) == _state(serial)


#: a column type and two chunks of one caller buffer, refilled between
#: appends: numbers of the column's own dtype, codes and categories of a
#: ``Categorical``, and a ``str`` array
BUFFERS = {
    "int": ("int", lambda buf: buf, np.array([1, 2, 3], np.int32),
            np.array([7, 8, 9], np.int32), [1, 2, 3, 7, 8, 9]),
    "double": ("double", lambda buf: buf, np.array([0.5, 1.5, 2.5]),
               np.array([4.0, 5.0, 6.0]), [0.5, 1.5, 2.5, 4.0, 5.0, 6.0]),
    "codes": ("varchar(4)",
              lambda buf: Categorical(buf, np.array(["a", "b", "c"])),
              np.array([0, 1, 2], np.int32), np.array([2, 2, 0], np.int32),
              ["a", "b", "c", "c", "c", "a"]),
    "str": ("varchar(4)", lambda buf: buf, np.array(["x", "y", "z"]),
            np.array(["u", "v", "w"]), ["x", "y", "z", "u", "v", "w"]),
}


@pytest.mark.parametrize("name", sorted(BUFFERS))
def test_append_keeps_nothing_of_the_callers_buffer(name):
    typ, wrap, first, second, want = BUFFERS[name]
    con = embedded.connect(device="cpu")
    con.query(f"create table t (i int, x {typ})")
    buf = first.copy()
    con.append("t", {"i": np.arange(3), "x": wrap(buf)})
    buf[:] = second                                 # refill, append again
    con.append("t", {"i": np.arange(3, 6), "x": wrap(buf)})
    buf[:] = first[::-1]                            # change it afterwards
    got = [r[0] for r in con.query("select x from t order by i")[0].rows]
    assert got == want


def test_categories_array_is_not_kept():
    con = embedded.connect(device="cpu")
    con.query("create table t (x varchar(4))")
    cats = np.array(["a", "b", "c"])
    con.append("t", {"x": Categorical(np.array([0, 1, 2], np.int32), cats)})
    cats[:] = ["p", "q", "r"]
    assert con.query("select x from t order by x")[0].rows == \
        [("a",), ("b",), ("c",)]


def test_transaction_logs_the_batch_as_it_was_inserted(tmp_path):
    path = str(tmp_path / "db")
    con = embedded.connect(path, device="cpu")
    con.query("create table t (i int, x varchar(4))")
    db = con.db
    codes = np.array([0, 1], np.int32)
    ids = np.array([1, 2], np.int32)
    db.begin()                      # monetdbe's transaction around appends
    con.append("t", {"i": ids, "x": Categorical(codes, np.array(["a", "b"]))})
    ids[:], codes[:] = [8, 9], [1, 1]               # reused before COMMIT
    db.update("t", "i", np.array([1]), np.array([12]))
    db.commit()
    want = [(1, "a"), (12, "b")]
    assert con.query("select i, x from t order by i")[0].rows == want
    con.close()
    again = embedded.connect(path, device="cpu")
    assert again.query("select i, x from t order by i")[0].rows == want
    again.close()


def test_one_load_append_span_an_insert():
    from monetdb_tpu_torch.obs.profiler import PROFILER
    con = embedded.connect(device="cpu")
    con.query("create table t (k int, s varchar(4))")
    with PROFILER.record():
        con.append("t", {"k": np.arange(4), "s": np.array(list("abab"))})
        names = [s.name for s in PROFILER.spans]
    assert names.count("load.append") == 1 and names.count("load.dict") == 1


def test_load_counters_grow_by_rows_and_bytes():
    keys = ("append_ns", "append_rows", "load_dict_ns", "upload_ns",
            "upload_bytes", "upload_copy_ns")
    before = {k: STATS[k] for k in keys}
    con = _loaded(1000)
    con.append("t", {"k": np.arange(24), "v": np.arange(24),
                     "s": np.array(["q"] * 24)})
    mid = {k: STATS[k] for k in keys}
    assert mid["append_rows"] - before["append_rows"] == 1024
    assert mid["append_ns"] > before["append_ns"]
    assert mid["load_dict_ns"] > before["load_dict_ns"]
    assert mid["upload_bytes"] == before["upload_bytes"]
    con.query("select count(*) from t")
    after = {k: STATS[k] for k in keys}
    assert after["upload_bytes"] - mid["upload_bytes"] == 1024 * 3 * 4
    assert after["upload_ns"] > mid["upload_ns"]
    copy_ns = after["upload_copy_ns"] - mid["upload_copy_ns"]
    assert 0 < copy_ns < after["upload_ns"] - mid["upload_ns"]
    con.query("select sum(k) from t")              # the version is cached
    assert STATS["upload_bytes"] == after["upload_bytes"]
