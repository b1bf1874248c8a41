"""The network front door of the PyTorch port on the CPU
(``monetdb_tpu_torch.server``, ``dbapi.connect(host=...)``, remote tables):
the reference package's server and auth / DB-API tests (tests/test_server.py,
test_auth_dbapi.py) pointed at the port, every store on ``device="cpu"``;
then the wire parity between the two packages (a client of either against a
server of the other) over the 22 TPC-H queries.  The distribution-DDL tests
(remote tables) are in test_torch_farm_cli.py."""

import datetime
import math
import os
import threading
from decimal import Decimal

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import pytest  # noqa: E402

import monetdb_tpu.config as ref_config  # noqa: E402
from monetdb_tpu.bench.tpch_load import load_tpch_db as ref_load_db  # noqa: E402
from monetdb_tpu.exec import fragment as RF  # noqa: E402
from monetdb_tpu.server import Client as RefClient, Server as RefServer  # noqa: E402
import monetdb_tpu.sql.binder as ref_binder  # noqa: E402
from monetdb_tpu.storage.columns import type_tag as ref_type_tag  # noqa: E402

from monetdb_tpu_torch import dbapi  # noqa: E402
from monetdb_tpu_torch.bench.tpch_load import load_tpch_db  # noqa: E402
from monetdb_tpu_torch.bench.tpch_queries import QUERIES  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
from monetdb_tpu_torch.server import Client, Server  # noqa: E402
from monetdb_tpu_torch.session import Session  # noqa: E402
import monetdb_tpu_torch.sql.binder as binder  # noqa: E402
from monetdb_tpu_torch.storage import Database  # noqa: E402
from monetdb_tpu_torch.storage.columns import type_tag  # noqa: E402



@pytest.fixture(autouse=True, scope="module")
def _restore_binder_counters():
    """Leave the generated-name counters (``col<N>``) of both binders as
    this file found them: other files of the same worker compare names
    across the packages."""
    saved = binder.Binder._auto_counter, ref_binder.Binder._auto_counter
    yield
    binder.Binder._auto_counter, ref_binder.Binder._auto_counter = saved

# --- tests/test_server.py ---------------------------------------------------

@pytest.fixture()
def server():
    srv = Server(Database(device="cpu")).start()
    yield srv
    srv.stop()


def test_roundtrip(server):
    host, port = server.address
    c = Client(host, port)
    assert c.sql("create table t (a int, b decimal(8,2), d date)") is None
    assert c.sql("insert into t values (1, 2.50, date '2020-01-01'), "
                 "(2, 3.25, null)") == 2
    r = c.sql("select a, b, d from t order by a")
    assert r.rows[0] == (1, Decimal("2.50"), datetime.date(2020, 1, 1))
    assert r.rows[1][2] is None
    with pytest.raises(RuntimeError):
        c.sql("select nope from t")
    # connection survives errors
    assert c.sql("select count(*) from t").rows == [(2,)]
    c.close()


def test_concurrent_clients(server):
    host, port = server.address
    boot = Client(host, port)
    boot.sql("create table c (x int)")
    boot.sql("insert into c values (0)")
    boot.close()
    errs = []

    def worker(i):
        try:
            cl = Client(host, port)
            cl.sql(f"insert into c values ({i})")
            r = cl.sql("select count(*) from c")
            assert r.rows[0][0] >= 2
            cl.close()
        except Exception as ex:   # pragma: no cover
            errs.append(ex)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(1, 9)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    check = Client(host, port)
    assert check.sql("select count(*) from c").rows == [(9,)]
    check.close()


def test_columnar_wire_parity_and_speed(tmp_path):
    """Binary columnar result mode (mvc_export_table_columnar,
    sql_result.c:1216): identical values to the JSON path, and bulk
    fetch at least an order of magnitude faster (VERDICT r2 item 9)."""
    import time

    import numpy as np

    from monetdb_tpu_torch.server import ColumnarResult

    db = Database(device="cpu")
    sess = Session(db)
    n = 300_000
    rng = np.random.default_rng(3)
    sess.sql("create table big (k bigint, d decimal(15,2), s varchar(10))")
    ks = rng.integers(0, 1 << 40, n)
    ds = rng.integers(0, 10 ** 6, n)
    csv = tmp_path / "big.csv"
    with open(csv, "w") as f:
        for i in range(n):
            f.write(f"{ks[i]}|{ds[i] / 100:.2f}|v{i % 97}\n")
    assert sess.sql(f"copy into big from '{csv}'") == n

    srv = Server(db).start()
    h, p = srv.address
    try:
        c = Client(h, p)
        t0 = time.perf_counter()
        rj = c.sql("select k, d, s from big")
        t_json = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc = c.sql("select k, d, s from big", columnar=True)
        t_col = time.perf_counter() - t0
        assert isinstance(rc, ColumnarResult) and len(rc) == n
        for i in (0, 1, n // 2, n - 1):
            assert rc.rows[i] == rj.rows[i]
        assert rc.rows == rj.rows
        speed = t_json / t_col
        print(f"columnar fetch speedup: {speed:.1f}x "
              f"(json {t_json*1e3:.0f} ms, columnar {t_col*1e3:.0f} ms)")
        assert speed > 10, f"columnar only {speed:.1f}x faster"
        c.close()
    finally:
        srv.stop()


def test_dbapi_fetchnumpy(tmp_path):
    import numpy as np

    db = Database(device="cpu")
    Session(db).sql("create table t (a int, b varchar(5))")
    Session(db).sql("insert into t values (1,'x'), (2,'y'), (3,'x')")
    srv = Server(db).start()
    h, p = srv.address
    try:
        con = dbapi.connect(host=h, port=p, columnar=True)
        cur = con.cursor()
        cur.execute("select a, b from t order by a")
        cols = cur.fetchnumpy()
        assert np.array_equal(cols["a"], np.asarray([1, 2, 3]))
        assert cur.fetchall() == [(1, "x"), (2, "y"), (3, "x")]
        con.close()
    finally:
        srv.stop()


# --- tests/test_auth_dbapi.py -----------------------------------------------

def test_auth_required():
    db = Database(device="cpu")
    db.create_user("alice", "secret")
    db.grant(["select", "insert"], "t", "alice")
    Session(db).sql("create table t (a int)")
    Session(db).sql("insert into t values (1)")
    srv = Server(db).start()
    try:
        h, p = srv.address
        c = Client(h, p, "alice", "secret")
        assert c.sql("select a from t").rows == [(1,)]
        c.close()
        with pytest.raises(Exception):
            Client(h, p, "alice", "wrong")
        with pytest.raises(Exception):
            Client(h, p, "bob", "secret")
    finally:
        srv.stop()


def test_auth_persists(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    db.create_user("u", "pw")
    db.checkpoint()
    db.close()
    db2 = Database(str(tmp_path / "db"), device="cpu")
    assert "u" in db2.users
    db2.close()


def test_dbapi_embedded():
    with dbapi.connect(device="cpu") as conn:
        cur = conn.cursor()
        cur.execute("create table t (a int, b varchar(5))")
        cur.execute("insert into t values (1, 'x'), (2, 'y')")
        assert cur.rowcount == 2
        cur.execute("select a, b from t where a > ? order by a", (0,))
        assert cur.description[0][0] == "a"
        assert cur.fetchone() == (1, "x")
        assert cur.fetchall() == [(2, "y")]
        cur.execute("select a from t where b = ?", ("y",))
        assert cur.fetchall() == [(2,)]
        cur.executemany("insert into t values (?, ?)",
                        [(3, "z"), (4, "w")])
        cur.execute("select count(*) from t")
        assert cur.fetchone() == (4,)


def test_dbapi_network():
    db = Database(device="cpu")
    db.create_user("alice", "secret")
    db.grant(["select", "insert"], "t", "alice")
    srv = Server(db).start()
    try:
        h, p = srv.address
        conn = dbapi.connect(host=h, port=p, user="alice",
                             password="secret")
        cur = conn.cursor()
        cur.execute("create table t (a int)")
        cur.execute("insert into t values (7)")
        cur.execute("select a from t")
        assert cur.fetchall() == [(7,)]
        with pytest.raises(dbapi.DatabaseError):
            cur.execute("select nope from t")
        conn.close()
    finally:
        srv.stop()


def test_tls_server_client(tmp_path):
    """TLS-wrapped connections (the reference's OpenSSL stream layer;
    testing/tlstester.py surface): handshake, query, and a plaintext
    client failing against a TLS port."""
    import subprocess
    cert, key = str(tmp_path / "c.pem"), str(tmp_path / "k.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1", "-subj",
         "/CN=127.0.0.1"], check=True, capture_output=True)
    db = Database(device="cpu")
    srv = Server(db, tls=(cert, key)).start()
    host, port = srv.address
    c = Client(host, port, tls=True, tls_verify=False)
    c.sql("create table t (x int)")
    c.sql("insert into t values (41), (1)")
    assert c.sql("select sum(x) from t").rows == [(42,)]
    import pytest as _pt
    with _pt.raises(Exception):
        plain = Client(host, port)          # plaintext against TLS port
        plain.sql("select 1")
    srv.stop()

# ---------------------------------------------------------------------------
# wire parity between the two packages
#
# A JAX ``Client`` against a port ``Server`` and a port ``Client`` against a
# JAX ``Server`` give the same names, types and rows as a JAX client against
# a JAX server, for the 22 TPC-H queries at SF0.01, in the JSON and the
# binary columnar result modes.  Both servers serve ``load_tpch_db(0.01)``
# (the port's on ``device="cpu"``); the JAX side runs with
# ``spmd_auto_mesh`` off (the suite's 8 virtual CPU devices would otherwise
# give its sessions a mesh).  Against the same server the two clients must
# agree exactly, down to the columnar buffers; across servers integers,
# decimals, strings and dates are exact and floats agree to rel 1e-12 (the
# port sums floats in another order).  Every query is one fragment run on
# the server that answers it, in both packages.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    ref_config.set("spmd_auto_mesh", False)
    port = Server(load_tpch_db(0.01, device="cpu")).start()
    ref = RefServer(ref_load_db(0.01)).start()
    try:
        yield port.address, ref.address
    finally:
        port.stop()
        ref.stop()
        ref_config.reset("spmd_auto_mesh")


def _run(client_cls, addr, q: int, columnar: bool):
    """(names, type tags, rows, buffers) of one query over one connection;
    the binders' generated-name counters start at 0 on both sides.  Each
    server runs the query's fragment once: STATS["runs"] rises by 1 on
    either side (plan-time subquery fragments of the port count under
    "subquery_runs")."""
    binder.Binder._auto_counter = ref_binder.Binder._auto_counter = 0
    runs = TF.STATS["runs"], RF.STATS["runs"]
    c = client_cls(*addr)
    try:
        res = c.sql(QUERIES[q], columnar=columnar)
    finally:
        c.close()
    assert TF.STATS["runs"] + RF.STATS["runs"] - sum(runs) == 1, \
        f"Q{q}: fragment runs {runs} -> {TF.STATS['runs']}, " \
        f"{RF.STATS['runs']}"
    tag = type_tag if client_cls is Client else ref_type_tag
    bufs = [res.numpy(n) for n in res.names] if hasattr(res, "numpy") \
        else None
    return res.names, [tag(t) for t in res.types], list(res.rows), bufs


def _rows_equal(got, want, rel: float) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if not (a == b or math.isclose(a, b, rel_tol=rel)):
                    return False
            elif a != b or type(a) is not type(b):
                return False
    return True


@pytest.mark.parametrize("columnar", [False, True], ids=["json", "columnar"])
@pytest.mark.parametrize("q", range(1, 23))
def test_cross_package_wire_parity(servers, q, columnar):
    port_addr, ref_addr = servers
    want = _run(RefClient, ref_addr, q, columnar)          # JAX to JAX
    assert want[2], f"Q{q}: no rows"
    # a port client against the JAX server: the same bytes, decoded alike
    got = _run(Client, ref_addr, q, columnar)
    assert got[:2] == want[:2]
    assert _rows_equal(got[2], want[2], 0.0)
    assert (got[3] is None) == (want[3] is None)
    if want[3] is not None:
        assert all(g.dtype == w.dtype and g.tobytes() == w.tobytes()
                   for g, w in zip(got[3], want[3]))
    # a JAX client against the port server
    got = _run(RefClient, port_addr, q, columnar)
    assert got[:2] == want[:2]
    assert _rows_equal(got[2], want[2], 1e-12), f"Q{q}"
    assert (got[3] is None) == (want[3] is None)
