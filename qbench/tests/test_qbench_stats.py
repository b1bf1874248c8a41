"""The benchmark's arithmetic on synthetic numbers: percentiles, the union
of intervals and idle gaps, bytes a query reads, the trace reduction over
fake profiler events, and the comparison."""

import statistics

import pytest

from qbench import compare, stats, tracing


def test_percentile_matches_statistics_inclusive():
    vals = [float(v) for v in range(1, 101)]
    assert stats.percentile(vals, 50) == statistics.median(vals)
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (9, 9)]
    assert stats.merge(iv) == [(0, 3), (5, 7)]
    assert stats.union_length(iv) == 5
    assert stats.gaps(iv, -1, 10) == [(-1, 0), (3, 5), (7, 10)]
    assert stats.gaps([], 0, 4) == [(0, 4)]
    assert stats.gaps([(-5, 20)], 0, 4) == []


SCHEMA = {"t": {"t_a": ["i32", 4], "t_b": ["dec2", 8], "t_s": ["str", 10]},
          "u": {"u_a": ["i32", 4]}}


def test_query_bytes_counts_each_named_column_once():
    rows = {"t": 100, "u": 7}
    sql = "select sum(t_b) from t, t as t2 where t.t_a = t2.t_a and t_a > 1"
    assert stats.columns_of(sql, SCHEMA) == [("t", "t_a"), ("t", "t_b")]
    assert stats.query_bytes(sql, SCHEMA, rows) == 100 * 12
    assert stats.query_bytes("select u_a, t_s from u, t", SCHEMA, rows) \
        == 7 * 4 + 100 * 10


class _Ev:
    def __init__(self, name, dev, s, d):
        self._n, self._dev, self._s, self._d = name, dev, s, d

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_read_trace_busy_idle_and_labels():
    ev = [
        _Ev("qbench.window", "CPU", 100, 1000),
        _Ev("q:6", "CPU", 100, 500), _Ev("lower", "CPU", 100, 200),
        _Ev("interp", "CPU", 300, 200), _Ev("decode", "CPU", 550, 50),
        _Ev("q:1", "CPU", 600, 500), _Ev("interp", "CPU", 600, 100),
        _Ev("q:6", "CUDA", 320, 200),          # an annotation's device copy
        _Ev("kern_a", "CUDA", 320, 100), _Ev("kern_a", "CUDA", 400, 50),
        _Ev("Memcpy DtoH", "CUDA", 500, 20), _Ev("kern_b", "CUDA", 650, 30),
        _Ev("kern_b", "CUDA", 1080, 100),      # runs past the window
        _Ev("kern_c", "CUDA", 10, 20),         # before the window
    ]
    tr = tracing.read_trace(ev)
    assert tr.window_s == pytest.approx(1000e-9)
    # busy: [320,450) + [500,520) + [650,680) + [1080,1100)
    assert tr.busy_s == pytest.approx(200e-9)
    assert tr.kernels == 4
    assert tr.device_ops[0] == ["kern_a", pytest.approx(150e-9)]
    gaps = dict(tr.idle_gaps)
    # each gap goes whole to the spans around its middle
    assert gaps == {"6:lower": pytest.approx(220e-9),    # [100, 320)
                    "6:interp": pytest.approx(50e-9),    # [450, 500)
                    "6:decode": pytest.approx(130e-9),   # [520, 650)
                    "1:other": pytest.approx(400e-9)}    # [680, 1080)


def test_label_takes_the_innermost_span():
    spans = [(0, 100, "q:2"), (0, 90, "lower"), (10, 50, "interp")]
    assert tracing._label(20, spans) == "2:interp"
    assert tracing._label(60, spans) == "2:lower"
    assert tracing._label(95, spans) == "2:other"
    assert tracing._label(150, spans) == "between"


def test_read_trace_without_device_activity_reads_nothing():
    ev = [_Ev("qbench.window", "CPU", 0, 100), _Ev("q:1", "CPU", 0, 100)]
    assert tracing.read_trace(ev) is None
    assert tracing.read_trace([_Ev("k", "CUDA", 0, 10)]) is None


def test_float_gap_and_judge():
    from decimal import Decimal
    want = {"a": [(Decimal("1.50"), 2.0, "x")], "b": [(1,)]}
    assert compare.float_gap([(Decimal("1.50"), 2.0, "x")], want["a"]) == 0.0
    assert compare.float_gap([(Decimal("1.50"), 2.000001, "x")],
                             want["a"]) == pytest.approx(5e-7)
    assert compare.float_gap([(Decimal("1.51"), 2.0, "x")], want["a"]) is None
    assert compare.float_gap([(1.5, 2.0, "x")], want["a"]) is None
    assert compare.float_gap([(1,), (2,)], want["b"]) is None

    class A:
        def __init__(self, qid, rows, error=None):
            self.qid, self.rows, self.error, self.ok = qid, rows, error, None
    answers = [A("a", [(Decimal("1.50"), 2.0, "x")]), A("b", [(1,)]),
               A("b", [(2,)]), A("a", None, "ValueError: boom"),
               A("a", [(Decimal("1.50"), 2.0 * (1 + 1e-6), "x")])]
    checks = compare.judge(answers, want, 1e-9)
    assert [a.ok for a in answers] == [True, True, False, False, False]
    assert (checks.wrong, checks.errors) == (1, 1)
    assert checks.worst_float == pytest.approx(1e-6)
    assert not checks.passed()
    assert compare.judge(answers[:2], want, 1e-9).passed()
