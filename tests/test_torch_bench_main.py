"""The port bench (``monetdb_tpu_torch/bench/bench.py``) against the JAX
package's root ``bench.py``, on the CPU at small sizes.

Each of the five timed loops (Q6 scan-filter, Q1 one-hot, Q1 through
``seg_sum64``, join and group-by) gives, at two K values, exactly the
integer of a JAX transcription of ``bench.py``'s scan body (its loop bodies
are closures inside its ``main`` and cannot be imported; the transcriptions
use the JAX package's ``seg_sum64`` in interpret mode, ``_lsd_argsort`` and
``_ss``) and of numpy over the same seeded arrays.  ``main`` prints the
reference's keys, one line after the microbenches, one after every query
and one at the end, and returns 1 when a section raises or a query fails.
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import ast  # noqa: E402
import functools  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402

import monetdb_tpu  # noqa: E402,F401  (enables x64)
from monetdb_tpu.exec.fragment import _lsd_argsort, _ss  # noqa: E402
from monetdb_tpu.ops.pallas_kernels import (  # noqa: E402
    SEG_SUM_BLOCK, seg_sum64 as ref_seg_sum64)
from monetdb_tpu_torch.bench import bench as B  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parent.parent

SMALL = dict(n=32_768, nb=1_000, npr=10_000, dom=1 << 14, ngr=1 << 15,
             nseg=1_000)
#: every section's two K values (the reference's)
KS = {"q6": (4, 36), "q1": (2, 10), "seg": (2, 10), "join": (1, 5),
      "groupby": (1, 3)}


# ---------------------------------------------------------------------------
# bench.py's scan bodies, transcribed (bench.py:67-81, 95-123, 147-167,
# 201-220, 246-268)
# ---------------------------------------------------------------------------


@jax.jit
def _ref_q6_loop(shipdate, disc, qty, extp, los, dlos):
    def body(acc, ld):
        lo, dlo = ld
        m = ((shipdate >= lo) & (shipdate < 9131)
             & (disc >= dlo) & (disc <= 7) & (qty < 2400))
        prod = extp * disc.astype(extp.dtype)
        return acc + jnp.sum(jnp.where(m, prod, 0).astype(jnp.int64)), None
    acc, _ = lax.scan(body, jnp.int64(0), (los, dlos))
    return acc


@functools.partial(jax.jit, static_argnames=("domain",))
def _ref_q1_loop(code, shipdate, qty, extp, disc, tax, cutoffs, *, domain=8):
    one_minus = 100 - disc
    dp = extp.astype(jnp.int64) * one_minus
    ch = dp * (100 + tax)
    ones = jnp.ones_like(qty)
    slots = jax.lax.iota(jnp.int32, domain)[None, :]

    def body(acc, cutoff):
        m = (code >= 0) & (shipdate <= cutoff)
        oh = m[:, None] & (code[:, None] == slots)

        def seg(v):
            return jnp.sum(jnp.where(oh, v[:, None], 0), axis=0)

        parts = seg(qty) + seg(extp.astype(jnp.int64)) + seg(dp) \
            + seg(ch) + seg(disc) + seg(ones)
        return acc + jnp.sum(parts), None

    acc, _ = lax.scan(body, jnp.int64(0), cutoffs)
    return acc


@jax.jit
def _ref_pallas_loop(code, shipdate, qty, extp, disc, tax, cutoffs):
    dp = extp.astype(jnp.int64) * (100 - disc)
    ch = dp * (100 + tax)

    def body(acc, cutoff):
        sid = jnp.where((code >= 0) & (shipdate <= cutoff),
                        code.astype(jnp.int64), jnp.int64(8))
        tot = jnp.int64(0)
        for v in (qty, extp.astype(jnp.int64), dp, ch, disc):
            s, c = ref_seg_sum64(sid, v, domain=8, interpret=True)
            tot = tot + jnp.sum(s) + jnp.sum(c)
        return acc + tot, None

    acc, _ = lax.scan(body, jnp.int64(0), cutoffs)
    return acc


@functools.partial(jax.jit, static_argnames=("nb", "dom"))
def _ref_join_loop(bkeys, pkeys, offs, *, nb, dom):
    rid = lax.iota(jnp.int32, nb)

    def body(acc, off):
        tmin = jnp.full(dom + 1, jnp.int32(nb), jnp.int32) \
            .at[bkeys + off].min(rid, mode="drop")
        hit = tmin[jnp.clip(pkeys + off, 0, dom)]
        return acc + jnp.sum(
            jnp.where(hit < nb, hit, -1).astype(jnp.int64)), None

    acc, _ = lax.scan(body, jnp.int64(0), offs)
    return acc


@functools.partial(jax.jit, static_argnames=("ngr", "nseg"))
def _ref_gb_loop(sid, vals, offs, *, ngr, nseg):
    def body(acc, off):
        s = (sid + off) % nseg
        perm = _lsd_argsort([s], ngr)
        ss = s[perm]
        v = vals[perm].astype(jnp.int64)
        c = jnp.concatenate([jnp.zeros(1, jnp.int64), jnp.cumsum(v)])
        ends = _ss(ss, lax.iota(jnp.int32, nseg), "right")
        starts = jnp.concatenate([jnp.zeros(1, ends.dtype), ends[:-1]])
        sums = c[ends] - c[starts]
        return acc + jnp.sum(sums), None

    acc, _ = lax.scan(body, jnp.int64(0), offs)
    return acc


# ---------------------------------------------------------------------------
# the three sides of each section
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _data():
    qa = B.q_columns(SMALL["n"])
    bk, pk = B.join_keys(SMALL["nb"], SMALL["npr"], SMALL["dom"])
    sid, vals = B.groupby_columns(SMALL["ngr"], SMALL["nseg"])
    return qa, bk, pk, sid, vals


def _port(section, k):
    qa, bk, pk, sid, vals = _data()
    args = {"q6": lambda: B.q6_args(qa, "cpu"),
            "q1": lambda: B.q1_args(qa, "cpu"),
            "seg": lambda: B.seg_args(qa, "cpu"),
            "join": lambda: B.join_args(bk, pk, SMALL["dom"], "cpu"),
            "groupby": lambda: B.groupby_args(sid, vals, SMALL["nseg"],
                                              "cpu")}[section]()
    loop = {"q6": B.q6_loop, "q1": B.q1_loop, "seg": B.seg_loop,
            "join": B.join_loop, "groupby": B.groupby_loop}[section]
    return loop(*args, k)


def _seg_rows():
    assert B.seg_rows(SMALL["n"]) == \
        (SMALL["n"] // SEG_SUM_BLOCK) * SEG_SUM_BLOCK
    return B.seg_rows(SMALL["n"])


def _jax(section, k):
    qa, bk, pk, sid, vals = _data()
    ar = np.arange(k)
    q = {key: jnp.asarray(v) for key, v in qa.items()}
    if section == "q6":
        return _ref_q6_loop(q["shipdate"], q["disc"], q["qty"], q["extp"],
                            jnp.asarray(8766 + ar % 7, jnp.int32),
                            jnp.asarray(5 + ar % 2, jnp.int64))
    cutoffs = jnp.asarray(10460 + ar % 11, jnp.int32)
    if section == "q1":
        return _ref_q1_loop(q["code"], q["shipdate"], q["qty"], q["extp"],
                            q["disc"], q["tax"], cutoffs)
    if section == "seg":
        r = _seg_rows()
        return _ref_pallas_loop(*(q[key][:r] for key in (
            "code", "shipdate", "qty", "extp", "disc", "tax")), cutoffs)
    if section == "join":
        return _ref_join_loop(jnp.asarray(bk), jnp.asarray(pk),
                              jnp.asarray(ar % 7, jnp.int32),
                              nb=SMALL["nb"], dom=SMALL["dom"])
    return _ref_gb_loop(jnp.asarray(sid), jnp.asarray(vals),
                        jnp.asarray(ar % 5, jnp.int32), ngr=SMALL["ngr"],
                        nseg=SMALL["nseg"])


def _numpy(section, k):
    qa, bk, pk, sid, vals = _data()
    if section == "q6":
        return sum(B.q6_numpy(qa, i) for i in range(k))
    if section == "q1":
        return sum(B.q1_numpy(qa, i) for i in range(k))
    if section == "seg":
        return sum(B.seg_numpy(qa, i) for i in range(k))
    if section == "join":
        return sum(B.join_numpy(bk, pk, i, SMALL["dom"]) for i in range(k))
    return sum(int(B.groupby_numpy(sid, vals, i, SMALL["nseg"]).sum())
               for i in range(k))


@pytest.mark.parametrize("section, k", [(s, k) for s, ks in KS.items()
                                        for k in ks])
def test_loop_equals_jax_and_numpy(section, k):
    got = _port(section, k)
    assert got.dtype == torch.int64 and got.dim() == 0
    want = int(_jax(section, k))
    assert int(got) == want == _numpy(section, k)


@pytest.mark.parametrize("off", [0, 4])
def test_groupby_sums_per_group(off):
    """Every group's sum, not only their total, against numpy."""
    _qa, _bk, _pk, sid, vals = _data()
    got = B.groupby_sums(torch.from_numpy(sid), torch.from_numpy(vals), off,
                         SMALL["nseg"])
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), B.groupby_numpy(sid, vals, off,
                                                       SMALL["nseg"]))


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def _reference_keys():
    """Top-level and ``detail`` keys of bench.py's JSON line, read from
    its source (its ``json.dumps`` call)."""
    tree = ast.parse((_ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "dumps":
            line = node.args[0]
            detail = next(v for k, v in zip(line.keys, line.values)
                          if k.value == "detail")
            return ({k.value for k in line.keys},
                    {k.value for k in detail.keys})
    raise AssertionError("bench.py has no json.dumps")


def _main(capsys, **kw):
    rc = B.main("cpu", **SMALL, q6_ks=(2, 3), q1_ks=(2, 3), join_ks=(1, 2),
                gb_ks=(1, 2), sf=0.01, **kw)
    return rc, [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


MICRO = ("q6_ms_per_iter", "q6_mrows_per_s", "q1_ms_per_iter",
         "q1_mrows_per_s", "q1_pallas_ms_per_iter", "q1_pallas_speedup",
         "join_gbps", "join_roofline_frac", "groupby_gbps",
         "groupby_roofline_frac")


def test_main_prints_the_reference_line(capsys, monkeypatch):
    monkeypatch.delenv("MTPU_BENCH_BUDGET_S", raising=False)
    monkeypatch.delenv("MTPU_HBM_ROOFLINE_GBPS", raising=False)
    rc, lines = _main(capsys)
    assert rc == 0
    assert len(lines) == 1 + 22 + 1
    top, detail = _reference_keys()
    assert len(detail) == 20
    last = lines[-1]
    assert top <= set(last) and detail <= set(last["detail"])
    d = last["detail"]
    assert last["value"] > 0 and last["vs_baseline"] == \
        round(last["value"] / 5.0, 2)
    assert all(d[key] is not None for key in MICRO)
    assert d["hbm_roofline_gbps"] == 3350.0
    assert d["rows"] == SMALL["n"]
    assert (d["device"], d["power_limit"]) == ("cpu", None)
    assert d["engine_sf1_failed"] is None and d["engine_sf1_skipped"] is None
    assert d["sections_failed"] is None
    assert sorted(d["engine_sf1_wall_ms"]) == sorted(
        f"q{q}" for q in range(1, 23))
    assert set(d["engine_sf1_cold_ms"]) == set(d["engine_sf1_wall_ms"])
    # BASELINE.md's table is SF1's: no ratio against SF0.01 times
    assert d["cpu_baseline_engine"].startswith("sqlite-")
    assert len(d["cpu_baseline_sf1_ms"]) == 22
    assert d["vs_cpu_baseline_coverage"] == "0/22"
    assert d["vs_cpu_baseline_geomean"] is None
    # one line after the microbenches (no query yet), one a query
    assert lines[0]["detail"]["engine_sf1_wall_ms"] is None
    assert [len(ln["detail"]["engine_sf1_wall_ms"]) for ln in lines[1:-1]] \
        == list(range(1, 23))


def test_a_failing_section_returns_1(capsys, monkeypatch):
    """The join raises: its keys are null, the failure is in the line, the
    later sections still run and main returns 1."""
    def boom(*_a):
        raise RuntimeError("boom")
    monkeypatch.setattr(B, "join_loop", boom)
    monkeypatch.setenv("MTPU_BENCH_BUDGET_S", "0")
    rc, lines = _main(capsys)
    assert rc == 1
    d = lines[-1]["detail"]
    assert d["sections_failed"] == {"join": "RuntimeError: boom"}
    assert d["join_gbps"] is None and d["join_roofline_frac"] is None
    assert d["groupby_gbps"] is not None and lines[-1]["value"] > 0
    # a zero budget skips every query, which alone is no failure
    assert d["engine_sf1_skipped"] == list(B.ORDER)


def test_a_failing_query_returns_1(capsys, monkeypatch):
    """Q6 fails and the query after it still runs (two queries of
    ``ORDER``: the full list is test_main_prints_the_reference_line's)."""
    monkeypatch.setitem(B.QUERIES, 6, "select nothing from nowhere")
    monkeypatch.setattr(B, "ORDER", (6, 14))
    monkeypatch.delenv("MTPU_BENCH_BUDGET_S", raising=False)
    rc, lines = _main(capsys)
    assert rc == 1
    d = lines[-1]["detail"]
    assert list(d["engine_sf1_failed"]) == ["q6"]
    assert list(d["engine_sf1_wall_ms"]) == ["q14"] and \
        d["sections_failed"] is None


def test_baseline_helpers_equal_the_reference():
    """The port's copies of ``_load_cpu_baseline`` and ``_geomean`` give
    what the root bench module's give (importing it loads no JAX)."""
    spec = importlib.util.spec_from_file_location("bench", _ROOT / "bench.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    engine, table = B._load_cpu_baseline()
    assert (engine, table) == ref._load_cpu_baseline()
    assert engine.startswith("sqlite-") and len(table) == 22
    xs = list(table.values())
    assert B._geomean(xs) == ref._geomean(xs)


def test_entry_point_needs_a_card():
    """``python -m monetdb_tpu_torch.bench.bench`` runs on cuda:0: without a
    card it exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("the entry point would run on the card")
    r = subprocess.run([sys.executable, "-m", "monetdb_tpu_torch.bench.bench"],
                       cwd=_ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr
