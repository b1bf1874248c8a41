"""The PyTorch port's storage layer (monetdb_tpu_torch ``storage``:
``Database``, ``Wal``, ``csv_native``) against the reference JAX package.

* the same statements write the same bytes: ``wal.log``, and after a
  checkpoint ``manifest.json`` and every ``data/*.npy``;
* a store written by either package opens in the other (and in its own)
  with the same rows, after a checkpoint and with the changes in the WAL
  only; a rolled-back transaction is absent after the replay;
* a store materializes each table on its device once per table version,
  with the hidden ``__rowid__`` column; ``Database()`` without a card
  raises instead of holding CPU tensors;
* snapshot/restore, and the native CSV parser built from native/csvparse.cpp
  into the port's own build directory, equal to the generated values and
  to the Python reader.
"""

import datetime
import filecmp
import os
from decimal import Decimal

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import monetdb_tpu.config as ref_config  # noqa: E402
import monetdb_tpu.sql.binder as ref_binder  # noqa: E402
from monetdb_tpu.session import Session as RefSession  # noqa: E402
from monetdb_tpu.storage import Database as RefDatabase  # noqa: E402
import monetdb_tpu_torch.sql.binder as binder  # noqa: E402
from monetdb_tpu_torch.dtypes import DATE, I64, decimal, varchar  # noqa: E402
from monetdb_tpu_torch.session import Session  # noqa: E402
from monetdb_tpu_torch.storage import Database, csv_native  # noqa: E402

from torch_session_scripts import outcome  # noqa: E402

_WRITES = [
    "create table t (a int primary key, b varchar(8), c decimal(9,2), "
    "d date, e double, big bigint)",
    "insert into t values (1, 'x', 1.5, date '2020-01-01', 0.5, "
    "5000000000), (2, null, null, null, null, 5000000900)",
    "create view v as select a, b from t where a > 1",
    "create sequence sq start with 3",
    "create function dbl(x int) returns int language python "
    "{ return x * 2 }",
    "create table u (k int, s varchar(4))",
    "insert into u values (next value for sq, 'p'), "
    "(next value for sq, 'q')",
    "start transaction",
    "insert into t values (3, 'y', 2, null, 1, 5000000001)",
    "commit",
    "update t set b = 'zz' where a = 1",
    "delete from t where a = 2",
    "start transaction",
    "insert into t values (9, 'gone', 0, null, 0, 0)",
    "delete from u",
    "rollback",
    "alter table u add column w int default 4",
    "insert into u (k, s) values (100, 'r')",
]

_READS = [
    "select * from t order by a",
    "select * from v order by a",
    "select dbl(a) from t order by a",
    "select k, s, w from u order by k",
    "select count(*), sum(c), sum(big) from t",
    "select name from sys.tables order by name",
]

_KINDS = {
    "port": (Session, lambda p: Database(p, device="cpu")),
    "ref": (RefSession, lambda p: RefDatabase(p)),
}


@pytest.fixture(autouse=True)
def _single_device_reference():
    ref_config.set("spmd_auto_mesh", False)
    yield
    ref_config.reset("spmd_auto_mesh")


def _answers(session):
    """_READS through ``session``, with the generated column names
    (``col<N>``, a process-wide counter in both packages) counted from 0."""
    binder.Binder._auto_counter = ref_binder.Binder._auto_counter = 0
    return [outcome(session.sql(q)) for q in _READS]


def _write(kind, path, checkpoint: bool):
    """Run _WRITES into a store at ``path``; returns the writer's own
    answers to _READS before it closes."""
    sess_cls, open_db = _KINDS[kind]
    db = open_db(path)
    s = sess_cls(db)
    for st in _WRITES:
        s.sql(st)
    want = _answers(s)
    if checkpoint:
        db.checkpoint()
    db.close()
    return want


def _read(kind, path):
    sess_cls, open_db = _KINDS[kind]
    db = open_db(path)
    try:
        return _answers(sess_cls(db))
    finally:
        db.close()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _dirs, fs in os.walk(root) for f in fs)


def test_same_bytes_on_disk(tmp_path):
    """WAL records, then the checkpoint's manifest and column files, are
    byte for byte the reference package's."""
    for kind in _KINDS:
        _write(kind, str(tmp_path / kind), checkpoint=False)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref") == \
        ["wal.log"]
    assert filecmp.cmp(tmp_path / "port" / "wal.log",
                       tmp_path / "ref" / "wal.log", shallow=False)
    for kind in _KINDS:
        db = _KINDS[kind][1](str(tmp_path / kind))
        db.checkpoint()
        db.close()
    names = _files(tmp_path / "ref")
    assert names == _files(tmp_path / "port")
    assert "manifest.json" in names and "data/t.big.npy" in names
    for n in names:
        assert filecmp.cmp(tmp_path / "port" / n, tmp_path / "ref" / n,
                           shallow=False), n


@pytest.mark.parametrize("checkpoint", [True, False],
                         ids=["checkpoint", "wal_only"])
@pytest.mark.parametrize("writer", sorted(_KINDS))
def test_store_opens_in_both_packages(writer, checkpoint, tmp_path):
    path = str(tmp_path / "db")
    want = _write(writer, path, checkpoint)
    assert want[0][3][0][1] == "zz" and len(want[0][3]) == 2
    for reader in sorted(_KINDS):
        assert _read(reader, path) == want, (writer, reader)


def test_reopened_store_keeps_taking_writes(tmp_path):
    """A store written by the reference package, reopened by the port
    (WAL replay), takes more writes, and the reference package reads
    them back after a checkpoint by the port."""
    path = str(tmp_path / "db")
    _write("ref", path, checkpoint=False)
    db = Database(path, device="cpu")
    s = Session(db)
    assert s.sql("insert into t values (5, 'new', 7.25, date "
                 "'2001-02-03', 2.5, 1)") == 1
    assert s.sql("update u set w = w + 1 where k >= 100") == 1
    db.checkpoint()
    assert s.sql("insert into u (k, s) values (200, 'wal')") == 1
    db.close()
    r = RefSession(RefDatabase(path))
    assert r.sql("select a, b, c from t where a = 5").rows == \
        [(5, "new", Decimal("7.25"))]
    assert r.sql("select k, w from u where k >= 100 order by k").rows == \
        [(100, 5), (200, 4)]


def test_snapshot_restore(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    s = Session(db)
    s.sql("create table t (a int, s varchar(5))")
    s.sql("insert into t values (7, 'q'), (8, null)")
    tar = str(tmp_path / "snap.tar")
    db.snapshot(tar)
    db2 = Database.restore(tar, str(tmp_path / "restored"), device="cpu")
    assert Session(db2).sql("select a, s from t order by a").rows == \
        [(7, "q"), (8, None)]
    assert db2.device == torch.device("cpu")


def test_materialized_once_per_version():
    db = Database(device="cpu")
    s = Session(db)
    s.sql("create table t (a int, s varchar(5))")
    s.sql("insert into t values (1, 'a'), (2, 'b'), (3, 'c')")
    s.sql("delete from t where a = 2")
    tbl, oids = db.table("t")
    assert tbl.names() == ["a", "s", "__rowid__"]
    assert tbl.col("__rowid__").data[:tbl.count].tolist() == [0, 2]
    assert oids.tolist() == [0, 2]
    assert {c.data.device for c in tbl.columns.values()} == \
        {torch.device("cpu")}
    for _ in range(3):
        s.sql("select sum(a) from t")
    assert db.table("t")[0] is tbl
    assert db.catalog().device == torch.device("cpu")
    s.sql("insert into t values (4, 'd')")
    assert db.table("t")[0] is not tbl
    # an open transaction reads unchanged tables through the store's cache
    s.sql("create table u (x int)")
    s.sql("start transaction")
    s.sql("insert into u values (1)")
    assert s.txn.table("t")[0] is db.table("t")[0]
    s.sql("rollback")


def test_database_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Database()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Database(device="cuda:0")
    assert Database(device="cpu").device == torch.device("cpu")


def test_csv_parser_builds_in_the_port(tmp_path):
    assert csv_native.native_available()
    assert os.path.dirname(csv_native._SO).endswith(
        os.path.join("monetdb_tpu_torch", "_build"))
    assert os.path.exists(csv_native._SO)
    rng = np.random.default_rng(5)
    n = 20_000
    a = rng.integers(-10**6, 10**6, n)
    b = rng.integers(-10**7, 10**7, n)
    d = rng.integers(0, 20000, n)
    words = np.array(["alpha", "beta gamma", "δelta", "x"], object)
    w = words[rng.integers(0, len(words), n)]
    epoch = datetime.date(1970, 1, 1)
    lines = [f"{a[i]}|{b[i] / 100:.2f}|"
             f"{(epoch + datetime.timedelta(days=int(d[i]))).isoformat()}|"
             f"{w[i]}" for i in range(n)]
    lines[3] = "7||1970-01-01|x"
    a[3], b[3], d[3], w[3] = 7, np.iinfo(np.int64).min, 0, "x"
    data = ("\n".join(lines) + "\n").encode()
    schema = [("a", I64), ("b", decimal(12, 2)), ("d", DATE),
              ("w", varchar())]
    got = csv_native.parse_csv(data, "|", schema)
    assert got["a"].tolist() == a.tolist()
    assert got["b"].tolist() == b.tolist()
    assert got["d"].dtype == np.int32 and got["d"].tolist() == d.tolist()
    assert got["w"].tolist() == w.tolist()
    p = tmp_path / "x.csv"
    p.write_bytes(data)
    outs = []
    for copy_python in (False, True):
        s = Session(Database(device="cpu"))
        s.sql("create table x (a bigint, b decimal(12,2), d date, "
              "w varchar(20))")
        if copy_python:
            n_in = s._copy_python(type("C", (), {
                "table": "x", "path": str(p), "delimiter": "|",
                "records": None})())
        else:
            n_in = s.sql(f"copy into x from '{p}'")
        assert n_in == n
        outs.append(s.sql("select count(*), sum(a), sum(b), min(d), "
                          "max(d), count(distinct w) from x").rows)
    assert outs[0] == outs[1]
