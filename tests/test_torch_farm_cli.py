"""The PyTorch port's shell, farm and distributed tables on the CPU: the
reference package's CLI, farm and distribution-DDL tests (tests/test_cli.py,
test_farm.py, test_distributed_tables.py: merge, remote and replica tables
over in-process servers) pointed at ``monetdb_tpu_torch`` with every store
on ``device="cpu"``, the ``python -m monetdb_tpu_torch`` entry point, and
the port's copy of the API pin of tests/test_exports.py."""

import importlib
import io
import os
import socket
import subprocess
import sys

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import pytest  # noqa: E402
import monetdb_tpu.sql.binder as ref_binder  # noqa: E402
import monetdb_tpu_torch.sql.binder as binder  # noqa: E402

from monetdb_tpu_torch.cli import Shell, format_table, main  # noqa: E402
from monetdb_tpu_torch.farm import Farm  # noqa: E402
from monetdb_tpu_torch.server import Client, Server  # noqa: E402
from monetdb_tpu_torch.session import Session  # noqa: E402
from monetdb_tpu_torch.storage import Database  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _restore_binder_counters():
    """Leave the generated-name counters (``col<N>``) of both binders as
    this file found them: other files of the same worker compare names
    across the packages."""
    saved = binder.Binder._auto_counter, ref_binder.Binder._auto_counter
    yield
    binder.Binder._auto_counter, ref_binder.Binder._auto_counter = saved


def _free_udp_port() -> int:
    """A UDP port no other socket holds now: the reference's discovery test
    binds the fixed port 51234 and would hear these farms' announcements."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


# --- tests/test_cli.py ------------------------------------------------------

def test_format_table():
    out = format_table(["a", "bb"], [(1, "x"), (None, "yy")])
    lines = out.splitlines()
    assert lines[0] == "+---+----+" or "-" in lines[0]
    assert "NULL" in out and "2 tuples" in out


def test_shell_statements_and_backslash():
    s = Session(Database(device="cpu"))
    sh = Shell(s.sql)
    out = io.StringIO()
    sh.run_statement("create table t (a int)", out)
    sh.run_statement("insert into t values (1), (2)", out)
    sh.run_statement("select a from t order by a", out)
    text = out.getvalue()
    assert "operation successful" in text
    assert "2 affected rows" in text
    assert "2 tuples" in text
    out = io.StringIO()
    assert sh.run_backslash("\\d", out)
    assert "t" in out.getvalue()
    out = io.StringIO()
    assert sh.run_backslash("\\d t", out)
    assert "a" in out.getvalue()
    assert not sh.run_backslash("\\q", io.StringIO())


def test_shell_repl_stream():
    s = Session(Database(device="cpu"))
    sh = Shell(s.sql)
    out = io.StringIO()
    src = io.StringIO("create table t (a int);\n"
                      "insert into t values (42);\n"
                      "select a from t;\n")
    sh.repl(src, out)
    assert "42" in out.getvalue()


def test_main_oneshot(tmp_path, capsys):
    rc = main([str(tmp_path / "db"), "--device", "cpu", "-s", "create table t (a int)",
               "-s", "insert into t values (5)", "-s", "select a from t"])
    assert rc == 0
    cap = capsys.readouterr().out
    assert "5" in cap and "1 tuple" in cap


def test_module_entry_point_oneshot(tmp_path):
    """python -m monetdb_tpu_torch -s ... --device cpu: embedded store on
    the CPU, one-shot statements, mclient's table on stdout."""
    r = subprocess.run(
        [sys.executable, "-m", "monetdb_tpu_torch", str(tmp_path / "db"),
         "--device", "cpu", "-s", "create table t (a int)",
         "-s", "insert into t values (3), (4)",
         "-s", "select sum(a) from t"],
        cwd=_ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "1 tuple" in r.stdout and "| 7 " in r.stdout


def test_cli_network_mode(tmp_path, capsys):
    """--host/--port: the shell runs its statements through a Client."""
    srv = Server(Database(device="cpu")).start()
    try:
        h, p = srv.address
        assert main(["--host", h, "--port", str(p), "-s",
                     "create table t (a int)", "-s",
                     "insert into t values (5), (6)", "-s",
                     "select a from t order by a"]) == 0
    finally:
        srv.stop()
    out = capsys.readouterr().out
    assert "2 affected rows" in out and "2 tuples" in out and "| 6 " in out


# --- tests/test_farm.py -----------------------------------------------------

def test_farm_lifecycle_and_funnel(tmp_path):
    farm = Farm(str(tmp_path / "farm"), device="cpu")
    farm.create("db1")
    farm.create("db2")
    assert farm.databases() == ["db1", "db2"]
    st = {e["name"]: e["state"] for e in farm.status()}
    assert st == {"db1": "stopped", "db2": "stopped"}

    h1, p1 = farm.start("db1")
    h2, p2 = farm.start("db2")
    for h, p in ((h1, p1), (h2, p2)):
        c = Client(h, p)
        c.sql("create table t (a int)")
        c.close()
    Client(h1, p1).sql("insert into t values (1), (2)")
    Client(h2, p2).sql("insert into t values (10)")

    # funnel: scatter one query, merge results (multiplex-funnel.c)
    f = farm.funnel(["db1", "db2"])
    rows = sorted(f.sql("select a from t").rows)
    assert rows == [(1,), (2,), (10,)]
    assert f.sql("insert into t values (99)") == 2   # broadcast DML
    f.close()

    # snapshot a running db, restore into a new name
    tar = str(tmp_path / "db1.tar")
    farm.snapshot("db1", tar)
    farm.stop_all()
    st = {e["name"]: e["state"] for e in farm.status()}
    assert set(st.values()) == {"stopped"}
    farm.restore("db3", tar)
    h3, p3 = farm.start("db3")
    c = Client(h3, p3)
    assert sorted(c.sql("select a from t").rows) == [(1,), (2,), (99,)]
    c.close()
    farm.stop_all()


def test_supervisor_restarts_crashed_server(tmp_path):
    """forkmserver.c:189 analog: the babysitter restarts a dead server on
    the same port (Database reopen = WAL-replay recovery) and gives up on
    a flapping one after the restart budget."""
    import time

    farm = Farm(str(tmp_path / "farm"), device="cpu")
    farm.create("db")
    h, p = farm.start("db")
    c = Client(h, p)
    c.sql("create table t (a int)")
    c.sql("insert into t values (7)")
    c.close()

    def crash(name):
        # simulate a crash: make the accept loop die with an exception
        import socket as _s
        srv = farm._servers[name]
        def boom(*a, **k):
            raise RuntimeError("simulated crash")
        srv._srv._handle_request_noblock = boom
        try:
            _s.create_connection((h, p), timeout=2).close()
        except Exception:
            pass
        srv._thread.join(timeout=5)
        assert not srv.alive

    crash("db")
    restarted = farm.check_once()
    assert restarted == ["db"]
    st = {e["name"]: e for e in farm.status()}
    assert st["db"]["state"] == "running"
    assert st["db"]["port"] == p                 # same address
    assert st["db"]["restarts"] == 1

    c = Client(h, p)                             # data survived recovery
    assert c.sql("select a from t").rows == [(7,)]
    c.close()

    # crash-loop budget: repeated crashes within the window -> give up
    for _ in range(5):
        if "db" not in farm._servers:
            break
        crash("db")
        farm.check_once(max_restarts=3, window=60.0)
    st = {e["name"]: e for e in farm.status()}
    assert st["db"]["state"] == "crashed"

    # background babysitter thread start/stop is clean
    farm.supervise(interval=0.05)
    time.sleep(0.15)
    farm.stop_all()


def test_proxy_routes_by_database_name(tmp_path):
    """merovingian proxy.c analog: one farm port reaches every database
    by name; a stopped local db starts on demand (forkmserver.c)."""
    farm = Farm(str(tmp_path / "farm"), device="cpu")
    try:
        farm.create("alpha")
        farm.create("beta")
        farm.start("alpha")          # beta stays stopped: on-demand start
        host, port = farm.proxy_listen()
        c1 = Client(host, port, database="alpha")
        c1.sql("create table t (x int)")
        c1.sql("insert into t values (7)")
        assert c1.sql("select x from t").rows == [(7,)]
        c2 = Client(host, port, database="beta")   # auto-started
        c2.sql("create table u (y int)")
        assert c2.sql("select count(*) from u").rows == [(0,)]
        assert "beta" in farm._servers
        c3 = Client(host, port, database="nosuch")
        import pytest as _pt
        with _pt.raises(Exception, match="no such database"):
            c3.sql("select 1")
    finally:
        farm.stop_all()


def test_discovery_and_cross_farm_proxy(tmp_path):
    """discoveryrunner.c analog: two farms on one host announce their
    databases over UDP; a client on farm A's proxy reaches a database
    hosted by farm B through the discovered address."""
    import time
    a = Farm(str(tmp_path / "a"), device="cpu")
    b = Farm(str(tmp_path / "b"), device="cpu")
    port = _free_udp_port()
    try:
        b.create("remote_db")
        b.start("remote_db")
        a.enable_discovery(port=port, interval=0.1)
        b.enable_discovery(port=port, interval=0.1)
        for _ in range(60):
            if "remote_db" in a.neighbors:
                break
            time.sleep(0.1)
        assert "remote_db" in a.neighbors
        assert any(e["name"] == "remote_db" and e["state"] == "remote"
                   for e in a.status())
        host, pport = a.proxy_listen()
        c = Client(host, pport, database="remote_db")
        c.sql("create table r (x int)")
        c.sql("insert into r values (42)")
        assert c.sql("select x from r").rows == [(42,)]
    finally:
        a.stop_all()
        b.stop_all()


def test_farm_opens_its_databases_on_its_device(tmp_path):
    farm = Farm(str(tmp_path / "farm"), device="cpu")
    try:
        farm.create("d")
        farm.start("d")
        assert str(farm.db("d").device) == "cpu"
    finally:
        farm.stop_all()


# --- tests/test_distributed_tables.py ----------------------------------------

def _mk_merge(s):
    s.sql("create table p1 (k int, v int)")
    s.sql("create table p2 (k int, v int)")
    s.sql("create table p3 (k int, v int)")
    s.sql("create merge table m (k int, v int) partition by range on (k)")
    s.sql("alter table m add table p1 as partition from 0 to 9")
    s.sql("alter table m add table p2 as partition from 10 to 19")
    s.sql("alter table m add table p3 as partition from 20 to 29")


def test_merge_insert_routing_and_union():
    s = Session(Database(device="cpu"))
    _mk_merge(s)
    n = s.sql("insert into m values (1, 100), (11, 200), (21, 300), "
              "(15, 400)")
    assert n == 4
    # rows landed in the right partitions
    assert s.sql("select count(*) from p1").rows == [(1,)]
    assert s.sql("select count(*) from p2").rows == [(2,)]
    assert s.sql("select count(*) from p3").rows == [(1,)]
    # full scan unions all members
    r = s.sql("select k, v from m order by k")
    assert r.rows == [(1, 100), (11, 200), (15, 400), (21, 300)]
    # aggregation over the union
    assert s.sql("select sum(v) from m").rows == [(1000,)]


def test_merge_partition_pruning():
    s = Session(Database(device="cpu"))
    _mk_merge(s)
    s.sql("insert into m values (1, 100), (11, 200), (21, 300)")
    plan = "\n".join(r[0] for r in
                     s.sql("explain select v from m where k = 12").rows)
    assert "Scan p2" in plan
    assert "Scan p1" not in plan and "Scan p3" not in plan
    assert s.sql("select v from m where k = 12").rows == []
    assert s.sql("select v from m where k = 11").rows == [(200,)]
    # range predicate prunes to two members
    plan = "\n".join(r[0] for r in s.sql(
        "explain select v from m where k between 5 and 15").rows)
    assert "Scan p1" in plan and "Scan p2" in plan
    assert "Scan p3" not in plan
    r = s.sql("select sum(v) from m where k between 5 and 15")
    assert r.rows == [(200,)]


def test_merge_values_and_null_partition():
    s = Session(Database(device="cpu"))
    s.sql("create table ta (r varchar(2), x int)")
    s.sql("create table tb (r varchar(2), x int)")
    s.sql("create table tn (r varchar(2), x int)")
    s.sql("create merge table mv (r varchar(2), x int) "
          "partition by values on (r)")
    s.sql("alter table mv add table ta as partition in ('A', 'B')")
    s.sql("alter table mv add table tb as partition in ('C')")
    s.sql("alter table mv add table tn as partition for null values")
    s.sql("insert into mv values ('A', 1), ('C', 2), (null, 3)")
    assert s.sql("select count(*) from ta").rows == [(1,)]
    assert s.sql("select count(*) from tb").rows == [(1,)]
    assert s.sql("select count(*) from tn").rows == [(1,)]
    plan = "\n".join(r[0] for r in
                     s.sql("explain select x from mv where r = 'C'").rows)
    assert "Scan tb" in plan and "Scan ta" not in plan \
        and "Scan tn" not in plan
    assert s.sql("select x from mv where r = 'C'").rows == [(2,)]
    assert s.sql("select x from mv where r is null").rows == [(3,)]


def test_merge_routing_rejects_out_of_range():
    s = Session(Database(device="cpu"))
    _mk_merge(s)
    with pytest.raises(Exception):
        s.sql("insert into m values (99, 1)")


def test_remote_and_merge_of_remote():
    # two worker servers, each holding one partition
    w1 = Server(Database(device="cpu")).start()
    w2 = Server(Database(device="cpu")).start()
    try:
        Session(w1.db).sql("create table sales (d date, amt int)")
        Session(w2.db).sql("create table sales (d date, amt int)")
        Session(w1.db).sql("insert into sales values "
                           "(date '2024-01-05', 10), (date '2024-02-01', 20)")
        Session(w2.db).sql("insert into sales values "
                           "(date '2024-07-01', 30), (date '2024-08-09', 40)")
        sup = Session(Database(device="cpu"))
        h1, p1 = w1.address
        h2, p2 = w2.address
        sup.sql(f"create remote table r1 (d date, amt int) "
                f"on '{h1}:{p1}/sales'")
        sup.sql(f"create remote table r2 (d date, amt int) "
                f"on '{h2}:{p2}/sales'")
        # plain remote scan
        assert sup.sql("select sum(amt) from r1").rows == [(30,)]
        # predicate shipping: filter folded into the RemoteScan
        plan = "\n".join(r[0] for r in sup.sql(
            "explain select amt from r1 where amt > 15").rows)
        assert "RemoteScan" in plan and "where" in plan
        assert sup.sql("select amt from r1 where amt > 15").rows == [(20,)]
        # merge over remote partitions with range pruning
        sup.sql("create merge table sales (d date, amt int) "
                "partition by range on (d)")
        sup.sql("alter table sales add table r1 as partition "
                "from date '2024-01-01' to date '2024-06-30'")
        sup.sql("alter table sales add table r2 as partition "
                "from date '2024-07-01' to date '2024-12-31'")
        assert sup.sql("select sum(amt) from sales").rows == [(100,)]
        r = sup.sql("select sum(amt) from sales "
                    "where d >= date '2024-07-01'")
        assert r.rows == [(70,)]
        # pruning: only the H2 partition is contacted
        plan = "\n".join(r[0] for r in sup.sql(
            "explain select amt from sales "
            "where d >= date '2024-08-01'").rows)
        assert f"{h2}:{p2}" in plan and f"{h1}:{p1}" not in plan
        # INSERT routed through merge to the remote member
        sup.sql("insert into sales values (date '2024-03-03', 5)")
        assert Session(w1.db).sql("select count(*) from sales").rows \
            == [(3,)]
        # joins against remote tables
        sup.sql("create table cal (d date, nm varchar(10))")
        sup.sql("insert into cal values (date '2024-01-05', 'jan'), "
                "(date '2024-07-01', 'jul')")
        r = sup.sql("select cal.nm, sales.amt from sales "
                    "join cal on sales.d = cal.d order by cal.nm")
        assert r.rows == [("jan", 10), ("jul", 30)]
    finally:
        w1.stop()
        w2.stop()


def test_replica_prefers_local():
    w = Server(Database(device="cpu")).start()
    try:
        Session(w.db).sql("create table t (a int)")
        Session(w.db).sql("insert into t values (42)")
        s = Session(Database(device="cpu"))
        h, p = w.address
        s.sql(f"create remote table t_far (a int) on '{h}:{p}/t'")
        s.sql("create replica table rt (a int)")
        s.sql("alter table rt add table t_far")
        # remote-only replica resolves through the wire
        assert s.sql("select a from rt").rows == [(42,)]
        # add a local copy: planner must now prefer it
        s.sql("create table t_local (a int)")
        s.sql("insert into t_local values (7)")
        s.sql("alter table rt add table t_local")
        assert s.sql("select a from rt").rows == [(7,)]
        plan = "\n".join(r[0] for r in s.sql("explain select a from rt").rows)
        assert "Scan t_local" in plan and "RemoteScan" not in plan
    finally:
        w.stop()


def test_dist_defs_persist(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    s = Session(db)
    _mk_merge(s)
    s.sql("insert into m values (1, 100), (11, 200)")
    db.checkpoint()
    db.close()
    db2 = Database(str(tmp_path / "db"), device="cpu")
    s2 = Session(db2)
    assert s2.sql("select sum(v) from m").rows == [(300,)]
    assert sorted(m for m, _ in db2.merges["m"].members) \
        == ["p1", "p2", "p3"]
    # WAL-only persistence (no checkpoint after DDL)
    s2.sql("create remote table rr (a int) on 'localhost:1/x'")
    db2.close()
    db3 = Database(str(tmp_path / "db"), device="cpu")
    assert "rr" in db3.remotes
    db3.close()


def test_schema_mismatch_rejected():
    s = Session(Database(device="cpu"))
    s.sql("create merge table m2 (k int, v int) partition by range on (k)")
    s.sql("create table bad (k int, v varchar(5))")
    with pytest.raises(Exception):
        s.sql("alter table m2 add table bad as partition from 0 to 9")


def test_two_phase_aggregate_pushdown():
    """Partial GROUP BY runs on the remote servers; only group rows cross
    the wire (mergetable two-phase aggregation over the network)."""
    w1 = Server(Database(device="cpu")).start()
    w2 = Server(Database(device="cpu")).start()
    try:
        for w, vals in ((w1, "(1, 'a', 10), (2, 'b', 20), (3, 'a', 30)"),
                        (w2, "(4, 'a', 40), (5, 'b', 50)")):
            sw = Session(w.db)
            sw.sql("create table f (k int, g varchar(2), v int)")
            sw.sql(f"insert into f values {vals}")
        sup = Session(Database(device="cpu"))
        h1, p1 = w1.address
        h2, p2 = w2.address
        sup.sql(f"create remote table f1 (k int, g varchar(2), v int) "
                f"on '{h1}:{p1}/f'")
        sup.sql(f"create remote table f2 (k int, g varchar(2), v int) "
                f"on '{h2}:{p2}/f'")
        sup.sql("create merge table f (k int, g varchar(2), v int)")
        sup.sql("alter table f add table f1")
        sup.sql("alter table f add table f2")
        # plan shows shipped partial aggregates
        plan = "\n".join(r[0] for r in sup.sql(
            "explain select g, sum(v), count(*) from f group by g").rows)
        assert "RemoteQuery" in plan and "group by" in plan
        r = sup.sql("select g, sum(v), count(*), min(v), max(v) from f "
                    "group by g order by g")
        assert r.rows == [("a", 80, 3, 10, 40), ("b", 70, 2, 20, 50)]
        # scalar aggregate (no keys) also combines
        assert sup.sql("select sum(v), count(*) from f").rows \
            == [(150, 5)]
        # with a filter: predicate ships inside the partial query
        r = sup.sql("select g, sum(v) from f where k <> 3 group by g "
                    "order by g")
        assert r.rows == [("a", 50), ("b", 70)]
        # avg is not decomposed (stays correct via full rows)
        r = sup.sql("select g, avg(v) from f group by g order by g")
        assert r.rows[0][0] == "a" and abs(r.rows[0][1] - 80 / 3) < 1e-9
    finally:
        w1.stop()
        w2.stop()


# --- tests/test_exports.py (the port's copy) --------------------------------
PORT_EXPECTED = {
    "monetdb_tpu_torch": ["__version__"],
    "monetdb_tpu_torch.session": ["Session"],
    "monetdb_tpu_torch.storage": ["Database"],
    "monetdb_tpu_torch.engine": ["Engine", "Result"],
    "monetdb_tpu_torch.server": ["Server", "Client"],
    "monetdb_tpu_torch.farm": ["Farm", "Funnel"],
    "monetdb_tpu_torch.dbapi": ["connect", "Connection", "Cursor", "apilevel",
                          "paramstyle"],
    "monetdb_tpu_torch.dump": ["dump_sql", "restore_sql", "sql_type_name"],
    "monetdb_tpu_torch.udf": ["UDF", "compile_python_udf"],
    "monetdb_tpu_torch.cli": ["main", "format_table"],
    "monetdb_tpu_torch.table": ["Table", "Catalog"],
    "monetdb_tpu_torch.column": ["Column", "Cand", "StrDict"],
    "monetdb_tpu_torch.config": ["get", "set", "reset"],
    "monetdb_tpu_torch.sql.parser": ["parse", "parse_expr"],
    "monetdb_tpu_torch.sql.binder": ["bind_select", "Binder", "BindError"],
    "monetdb_tpu_torch.sql.distribute": [
        "MergeDef", "RemoteDef", "ReplicaDef", "PartSpec",
        "expand_distribution", "prune_members", "route_partition",
        "to_sql"],
    "monetdb_tpu_torch.sql.syscat": ["system_table", "is_system_table", "QUEUE",
                               "QueryKilled"],
    "monetdb_tpu_torch.ops.select": [],
    "monetdb_tpu_torch.ops.join": [],
    "monetdb_tpu_torch.ops.group": [],
    "monetdb_tpu_torch.ops.aggr": [],
    "monetdb_tpu_torch.ops.sort": [],
    "monetdb_tpu_torch.ops.window": [],
    "monetdb_tpu_torch.ops.strfuncs": ["levenshtein", "editdistance",
                                 "jarowinkler", "soundex", "difference",
                                 "qgram_normalize", "like_cand"],
    "monetdb_tpu_torch.ops.jsonfuncs": ["isvalid", "filter_path", "text",
                                  "length", "keyarray", "valuearray"],
    "monetdb_tpu_torch.parallel.shuffle": [
        "hash64", "lane_counts", "shuffle", "dist_group_sum",
        "dist_group_sum_auto", "dist_fk_join"],
    "monetdb_tpu_torch.parallel.mitosis": [
        "row_mesh", "shard_array", "two_phase_sum", "sharded_q1",
        "sharded_q6", "default_mesh", "AXIS"],
    "monetdb_tpu_torch.obs": ["PROFILER", "set_algorithm"],
    "monetdb_tpu_torch.parallel": [
        "row_mesh", "shard_array", "two_phase_sum", "sharded_q1",
        "sharded_q6", "default_mesh", "ProcessMesh", "initialize",
        "process_index", "process_count", "shutdown"],
    "monetdb_tpu_torch.parallel.dist": [
        "initialize", "process_index", "process_count", "shutdown",
        "ProcessMesh", "DistCollectives"],
    "monetdb_tpu_torch.bench.microbench": [
        "uniform", "normal", "zipf", "skewed", "sorted_runs"],
    "monetdb_tpu_torch.bench.cpu_baseline": ["main"],
}


def test_port_api_surface_pinned():
    missing = []
    for modname, symbols in PORT_EXPECTED.items():
        mod = importlib.import_module(modname)
        for sym in symbols:
            if not hasattr(mod, sym):
                missing.append(f"{modname}.{sym}")
    assert not missing, f"public API symbols removed/renamed: {missing}"
