"""The port's spans and self-time counters (``obs/profiler.py``):

* a LIKE query and a scalar-subquery query through ``Session.sql`` give the
  chain ``sql`` -> ``sql.parse`` / ``sql.bind`` / ``fragment.lower``
  (-> ``lower.dict`` / ``lower.subquery``) / ``fragment.run`` (->
  ``run.dispatch`` -> ``r_*`` nodes, ``run.wait``, ``run.fetch``), plus a
  ``result.decode`` root, all of one query id;
* a query's counters add up exactly to its root spans' durations, and to
  the wall clock around it;
* with recording off nothing is kept and the counters still move; on or
  off, the program adds nothing to ``torch.profiler``'s trace;
* ``Result.trace`` keeps its events and keys, fragment and fallback;
* the spans share ``torch.profiler``'s clock: a span lies inside an
  enclosing ``record_function`` event, in the raw events and through
  ``chrome_events`` in the profile's own chrome export.
"""

import json
import os
import time

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import pytest  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from monetdb_tpu_torch.engine import Engine  # noqa: E402
from monetdb_tpu_torch.exec.fragment import STATS  # noqa: E402
from monetdb_tpu_torch.obs import PROFILER  # noqa: E402
from monetdb_tpu_torch.session import Session  # noqa: E402
from monetdb_tpu_torch.storage import Database  # noqa: E402

LIKE = "select a, s from t where s like 'ab%' order by a"
SUBQ = "select a from t where a > (select avg(a) from t) order by a"
#: a window function: the fragment rejects it, the executor runs it
WINDOW = "select a, row_number() over (order by a) as r from t"
#: counters of host time
NS = ("sql_ns", "parse_ns", "bind_ns", "lower_ns", "dict_ns",
      "subquery_ns", "dispatch_ns", "wait_ns", "fetch_ns", "decode_ns",
      "executor_ns")
#: names of the spans the program opens (``r_*`` apart)
NAMES = {"sql", "engine.query", "sql.parse", "sql.bind", "fragment.lower",
         "lower.dict", "lower.subquery", "fragment.run", "run.dispatch",
         "run.wait", "run.fetch", "result.decode", "executor.run"}


@pytest.fixture(scope="module")
def session():
    s = Session(Database(device="cpu"))
    s.sql("create table t (a int, s varchar(20))")
    s.sql("insert into t values (1, 'abc'), (2, 'xyz'), (3, 'abd'), "
          "(4, 'qab'), (5, 'ab')")
    for q in (LIKE, SUBQ):
        list(s.sql(q).rows)
    yield s
    s.close()


@pytest.fixture
def recorded():
    PROFILER.start()
    try:
        yield PROFILER
    finally:
        PROFILER.stop()
        PROFILER.spans = []


def _run(session, q):
    before = dict(STATS)
    res = session.sql(q)
    rows = list(res.rows)
    return rows, {k: STATS[k] - before[k] for k in STATS}


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


@pytest.mark.parametrize("q, inner", [(LIKE, "lower.dict"),
                                      (SUBQ, "lower.subquery")])
def test_session_query_gives_the_span_chain(session, recorded, q, inner):
    rows, _ = _run(session, q)
    assert rows
    spans = recorded.spans
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["sql", "result.decode"]
    sql = roots[0]
    assert isinstance(sql.query, int) and sql.query > 0   # a sys.queue tag
    assert {s.query for s in spans} == {sql.query}
    by_id = {s.id: s for s in spans}
    top = [s for s in spans if s.parent == sql.id]
    assert [s.name for s in top] == ["sql.parse", "sql.bind",
                                     "fragment.lower", "fragment.run"]
    parse, bind, lower, run = top
    assert parse.end_ns <= bind.start_ns <= bind.end_ns <= lower.start_ns
    assert lower.end_ns <= run.start_ns
    assert [s.parent for s in _by_name(spans, inner)][:1] == [lower.id]
    steps = [s for s in spans if s.parent == run.id]
    assert [s.name for s in steps] == ["run.dispatch", "run.wait",
                                       "run.fetch"]
    dispatch = steps[0]
    nodes = [s for s in spans if s.name.startswith("r_")]
    assert nodes
    for n in nodes:
        # each node lies in this run's enqueue, under another node or it
        up = by_id[n.parent]
        while up.name.startswith("r_"):
            up = by_id[up.parent]
        if up.id != dispatch.id:
            assert inner == "lower.subquery"      # the subquery's own run
    assert any(by_id[n.parent].id == dispatch.id for n in nodes)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_subquery_spans_charge_subquery_ns(session, recorded):
    _rows, d = _run(session, SUBQ)
    sub = _by_name(recorded.spans, "lower.subquery")
    assert len(sub) == 1
    # the subquery's own lowering and run are inside it, and charge it
    inside = [s for s in recorded.spans if s.parent == sub[0].id]
    assert {s.name for s in inside} == {"fragment.lower", "fragment.run"}
    assert d["subquery_ns"] == sub[0].end_ns - sub[0].start_ns
    assert d["subquery_runs"] == 1 and d["runs"] == 1


@pytest.mark.parametrize("q", [LIKE, SUBQ, WINDOW])
def test_counters_add_up_to_the_root_spans(session, recorded, q):
    t0 = time.time_ns()
    _rows, d = _run(session, q)
    wall = time.time_ns() - t0
    roots = [s for s in recorded.spans if s.parent is None]
    total = sum(d[k] for k in NS)
    assert total == sum(s.end_ns - s.start_ns for s in roots)
    assert abs(wall - total) <= max(0.02 * wall, 200_000), (wall, total)
    assert d["queries"] == 1
    if q == LIKE:
        assert d["dict_ns"] > 0 and d["dict_values"] > 0
    if q == WINDOW:
        assert d["executor_ns"] > 0 and d["fallbacks"] == 1
    else:
        assert d["host_reads"] >= 2          # the scalars, one array


def test_recording_off_keeps_nothing_and_counts(session):
    PROFILER.spans = []
    assert not PROFILER.recording
    _rows, d = _run(session, LIKE)
    assert PROFILER.spans == []
    assert d["queries"] == 1 and d["lower_ns"] > 0 and d["dispatch_ns"] > 0


def _annotations(session, q, record: bool):
    """Names of the CPU events of a ``torch.profiler`` profile of ``q``."""
    if record:
        PROFILER.start()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            list(session.sql(q).rows)
    finally:
        if record:
            PROFILER.stop()
            PROFILER.spans = []
    return {e.name() for e in prof.profiler.kineto_results.events()}


@pytest.mark.parametrize("record", [False, True])
def test_program_adds_nothing_to_the_torch_profile(session, record):
    names = _annotations(session, LIKE, record)
    assert names                              # torch's own ops are there
    assert not names & NAMES
    assert not [n for n in names if n.startswith("r_")]


def test_trace_views_keep_their_events_and_keys(session):
    eng = Engine(session._catalog())
    frag = eng.query(LIKE, trace=True).trace
    assert [e["op"] for e in frag] == ["fragment.lower", "fragment.run"]
    assert set(frag[0]) == {"op", "usec"}
    assert set(frag[1]) == {"op", "algorithm", "device", "rows", "rpcs",
                            "compile", "expanding_joins", "usec"}
    assert frag[1]["algorithm"] == "fragment:jit" and frag[1]["rows"] == 3
    fb = eng.query(WINDOW, trace=True).trace
    assert fb[0]["op"] == "fragment.fallback" and set(fb[0]) == {"op",
                                                                 "reason"}
    for e in fb[1:]:
        assert {"op", "start_us", "label", "usec", "rows"} <= set(e) <= \
            {"op", "start_us", "label", "usec", "rows", "algorithm"}
    assert not PROFILER.enabled and not PROFILER.recording
    assert PROFILER.spans == []               # a traced query keeps none
    rows = session.sql("trace " + LIKE).rows
    assert [r[3] for r in rows] == ["fragment.lower", "fragment.run"]
    assert rows[1][1:3] == (3, "fragment:jit")


def _profiled_sql(session, q, tmp_path):
    """One ``sql`` span inside a ``record_function`` event: the span, the
    event's (start, end) in ns, the profile's chrome export and the kept
    spans as chrome events on the export's base."""
    with record_function("warm"):        # the first range starts late
        pass
    PROFILER.start()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("enclosing"):
                res = session.sql(q)
    finally:
        PROFILER.stop()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "enclosing"][0]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    sql = _by_name(PROFILER.spans, "sql")[0]
    chrome = PROFILER.chrome_events(int(trace["baseTimeNanoseconds"]))
    PROFILER.spans = []
    list(res.rows)
    return sql, (ev.start_ns(), ev.start_ns() + ev.duration_ns()), trace, \
        chrome


def test_a_span_lies_inside_its_record_function_event(session, tmp_path):
    for _ in range(3):
        sql, (s, e), _trace, _ch = _profiled_sql(session, LIKE, tmp_path)
        assert s <= sql.start_ns and sql.end_ns <= e
    # the clocks agree: a span opened right inside a record_function
    # starts and ends within 50 us of it (the best of ten: a busy host
    # may preempt a try between the two stamps)
    gaps = []
    for _ in range(10):
        PROFILER.start()
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with record_function("enclosing"):
                    with PROFILER.span("probe"):
                        pass
        finally:
            PROFILER.stop()
        probe = _by_name(PROFILER.spans, "probe")[0]
        PROFILER.spans = []
        ev = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "enclosing"][0]
        s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        assert s <= probe.start_ns and probe.end_ns <= e
        gaps.append(max(probe.start_ns - s, e - probe.end_ns))
    assert min(gaps) <= 50_000, gaps


def test_chrome_events_join_the_profile_export(session, tmp_path):
    sql, _ev, trace, chrome = _profiled_sql(session, LIKE, tmp_path)
    outer = [e for e in trace["traceEvents"]
             if e.get("name") == "enclosing" and e.get("ph") == "X"][0]
    ours = [e for e in chrome if e["args"]["id"] == sql.id]
    assert len(ours) == 1
    span = ours[0]
    assert span["ph"] == "X" and span["name"] == "sql"
    assert span["args"]["query"] == sql.query and span["args"]["parent"] \
        is None
    eps = 0.002                        # the export rounds to 1 ns
    assert outer["ts"] - eps <= span["ts"]
    assert span["ts"] + span["dur"] <= outer["ts"] + outer["dur"] + eps
    assert span["tid"] == outer["tid"]


def test_engine_query_root_takes_a_fresh_id(session, recorded):
    eng = Engine(session._catalog())
    list(eng.query(LIKE).rows)
    list(eng.query(LIKE).rows)
    roots = [s for s in recorded.spans if s.name == "engine.query"]
    assert len(roots) == 2 and all(s.parent is None for s in roots)
    assert roots[0].query < 0 and roots[1].query < roots[0].query
    decode = _by_name(recorded.spans, "result.decode")
    assert [s.query for s in decode] == [s.query for s in roots]
    # the plan cache serves the second: bound, not lowered
    second = [s.name for s in recorded.spans if s.parent == roots[1].id]
    assert second == ["sql.bind", "fragment.run"]
