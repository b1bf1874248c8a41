"""The benchmark's readers of the program's counters (``qbench/metrics/``,
``source: program_counter``) over a window of the tiny ``tpch-sf1.power``
cell run through the Session on the CPU, with a stub device trace: each
reads its counters' window delta over the window's queries, and nothing
without a device trace or without its counter; and the counters of host
time add up to the window's latencies.  The readers of the load's
counters (``append_s``, ``upload_s``, ``upload_link_share``) read what
the entry's open and the first pass charged, as ``Run.setup_counters``
holds it at the end of set-up."""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import pytest  # noqa: E402

from qbench import harness, tracing  # noqa: E402
from qbench.tests import tiny  # noqa: E402

SEED = 1234567891011
#: reader -> the counters it sums and the scale of the sum
READERS = {
    "front_ms.session": (("sql_ns", "parse_ns", "bind_ns"), 1e-6),
    "lower_self_ms.session": (("lower_ns",), 1e-6),
    "dict_map_ms.session": (("dict_ns",), 1e-6),
    "subquery_ms.session": (("subquery_ns",), 1e-6),
    "dispatch_ms": (("dispatch_ns",), 1e-6),
    "dispatch_ms.session": (("dispatch_ns",), 1e-6),
    "wait_ms": (("wait_ns",), 1e-6),
    "wait_ms.session": (("wait_ns",), 1e-6),
    "host_reads_per_query": (("host_reads",), 1),
    "host_reads_per_query.session": (("host_reads",), 1),
    "decode_span_ms": (("decode_ns",), 1e-6),
    "decode_span_ms.session": (("decode_ns",), 1e-6),
}
#: reader -> the counters whose window deltas it divides
RATIOS = {"dict_device_share.session": ("dict_device_values",
                                        "dict_values"),
          "join_kernel_share": ("join_probe_kernel", "join_probes"),
          "join_kernel_share.session": ("join_probe_kernel", "join_probes"),
          "compact_kernel_share": ("compact_kernel", "compactions"),
          "compact_kernel_share.session": ("compact_kernel", "compactions")}
#: reader of the load's counters -> the counters it sums and the scale
SETUP = {"append_s": (("append_ns", "load_dict_ns"), 1e-9),
         "upload_s": (("upload_ns",), 1e-9)}
NS = ("sql_ns", "parse_ns", "bind_ns", "lower_ns", "dict_ns",
      "subquery_ns", "dispatch_ns", "wait_ns", "fetch_ns", "decode_ns",
      "executor_ns")


@pytest.fixture(scope="module")
def window():
    """The cell's queries once to warm, then once as the window: its
    answers and its counters' deltas."""
    cell = tiny.cell("tpch-sf1.power")
    cfg = cell.cfg
    data = harness.load_module("gen", cfg["generator"]).generate(
        cfg, SEED, "cpu")
    entry = harness.load_module("entries", cfg["entry"]).open_entry(
        cfg, data, "cpu")
    try:
        for q in cell.qids:
            harness._ask(entry, q, cell.texts[q], None, False)
        before = harness._counters()
        answers = [harness._ask(entry, q, cell.texts[q], None, False)
                   for q in cell.qids]
        after = harness._counters()
    finally:
        entry.close()
    assert all(a.error is None for a in answers), \
        [a.error for a in answers if a.error]
    counters = {k: after[k] - before.get(k, 0) for k in after}
    return cell, answers, counters


@pytest.fixture(scope="module")
def loaded():
    """What the tiny cell's open and one pass of its queries charged to
    the counters (the set-up's share of them)."""
    cell = tiny.cell("tpch-sf1.power")
    cfg = cell.cfg
    data = harness.load_module("gen", cfg["generator"]).generate(
        cfg, SEED, "cpu")
    before = harness._counters()
    entry = harness.load_module("entries", cfg["entry"]).open_entry(
        cfg, data, "cpu")
    try:
        for q in cell.qids:
            harness._ask(entry, q, cell.texts[q], None, False)
    finally:
        entry.close()
    after = harness._counters()
    return {k: after[k] - before.get(k, 0) for k in after}


def _setup_run(window, loaded, trace=True, drop=()):
    cell, answers, counters = window
    stub = tracing.DeviceTrace(1.0, 0.5, 1, [], []) if trace else None
    setup = {k: v for k, v in loaded.items()
             if k.split(".", 1)[1] not in drop}
    return harness.Run(cell, answers, 1.0, stub, counters, {}, "cpu",
                       setup_counters=setup)


def _run(window, trace=True, drop=()):
    cell, answers, counters = window
    stub = tracing.DeviceTrace(1.0, 0.5, 1, [], []) if trace else None
    counters = {k: v for k, v in counters.items()
                if k.split(".", 1)[1] not in drop}
    return harness.Run(cell, answers, 1.0, stub, counters, {}, "cpu")


def test_every_reader_is_in_the_benchmark():
    per_layer = {m["name"]: m for m in tiny.bench()["per_layer"]}
    load = (*SETUP, "upload_link_share")
    for name in (*READERS, *RATIOS, *load):
        assert per_layer[name]["source"] == "program_counter"
    assert {n for n, m in per_layer.items()
            if m["source"] == "program_counter"} == \
        {*READERS, *RATIOS, *load}


#: the ratio readers whose counters the tiny window moves: its tables
#: lie below the compaction barrier's threshold and no result of it
#: carries a mask, so it runs no compaction
WINDOW_RATIOS = sorted(n for n in RATIOS
                       if not n.startswith("compact_kernel_share"))


@pytest.mark.parametrize("name", WINDOW_RATIOS)
def test_ratio_reader_divides_its_counters(window, name):
    """On the CPU every map stays on the host and every dense join probe
    and every compaction takes the plain version: the share reads 0."""
    part, whole = RATIOS[name]
    _cell, _answers, counters = window
    read = harness.load_module("metrics", name).read
    assert counters[f"fragment.{whole}"] > 0
    assert read(_run(window)) == counters[f"fragment.{part}"] / \
        counters[f"fragment.{whole}"] == 0
    assert read(_run(window, trace=False)) is None
    assert read(_run(window, drop=(part,))) is None
    assert read(_run(window, drop=(whole,))) is None


@pytest.mark.parametrize("name", sorted(set(RATIOS) - set(WINDOW_RATIOS)))
def test_ratio_reader_of_counters_the_window_leaves(window, name):
    """A ratio over counters the tiny window does not move reads None
    there (no compaction ran), and divides its counters where they
    moved."""
    part, whole = RATIOS[name]
    cell, answers, counters = window
    read = harness.load_module("metrics", name).read
    assert counters[f"fragment.{whole}"] == 0
    assert read(_run(window)) is None
    moved = {**counters, f"fragment.{part}": 3, f"fragment.{whole}": 4}
    stub = tracing.DeviceTrace(1.0, 0.5, 1, [], [])
    assert read(harness.Run(cell, answers, 1.0, stub, moved, {},
                            "cpu")) == 0.75
    assert read(harness.Run(cell, answers, 1.0, None, moved, {},
                            "cpu")) is None
    del moved[f"fragment.{part}"]
    assert read(harness.Run(cell, answers, 1.0, stub, moved, {},
                            "cpu")) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_its_counters_over_the_queries(window, name):
    keys, scale = READERS[name]
    _cell, answers, counters = window
    read = harness.load_module("metrics", name).read
    want = sum(counters[f"fragment.{k}"] for k in keys) * scale / \
        len(answers)
    assert read(_run(window)) == pytest.approx(want, rel=1e-12)
    assert read(_run(window, trace=False)) is None
    assert read(_run(window, drop=keys[:1])) is None


def test_counters_add_up_to_the_latencies(window):
    _cell, answers, counters = window
    assert counters["fragment.queries"] == len(answers)
    total_s = sum(counters[f"fragment.{k}"] for k in NS) / 1e9
    lat_s = sum(a.latency_s for a in answers)
    assert abs(total_s - lat_s) <= 0.05 * lat_s, (total_s, lat_s)
    for k in ("lower_ns", "dict_ns", "subquery_ns", "dispatch_ns",
              "wait_ns", "fetch_ns", "decode_ns", "host_reads"):
        assert counters[f"fragment.{k}"] > 0, k


@pytest.mark.parametrize("name", sorted(SETUP))
def test_setup_reader_reads_the_load_counters(window, loaded, name):
    keys, scale = SETUP[name]
    read = harness.load_module("metrics", name).read
    want = sum(loaded[f"fragment.{k}"] for k in keys) * scale
    assert want > 0
    assert read(_setup_run(window, loaded)) == pytest.approx(want,
                                                             rel=1e-12)
    assert read(_setup_run(window, loaded, trace=False)) is None
    assert read(_setup_run(window, loaded, drop=keys[:1])) is None
    assert read(_run(window)) is None       # no set-up counters at all


def test_upload_link_share_divides_bytes_by_copy_time(window, loaded):
    read = harness.load_module("metrics", "upload_link_share").read
    nbytes = loaded["fragment.upload_bytes"]
    ns = loaded["fragment.upload_copy_ns"]
    assert nbytes > 0 and 0 < ns < loaded["fragment.upload_ns"]
    assert loaded["fragment.append_rows"] > 0
    assert read(_setup_run(window, loaded)) == pytest.approx(
        100 * nbytes / (ns / 1e9) / 63.0e9, rel=1e-12)
    assert read(_setup_run(window, loaded, trace=False)) is None
    for key in ("upload_bytes", "upload_copy_ns"):
        assert read(_setup_run(window, loaded, drop=(key,))) is None
