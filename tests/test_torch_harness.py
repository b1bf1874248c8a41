"""monetdb_tpu_torch/harness.py against the reference's __graft_entry__.py:
``entry()``'s Q1 step equal to the reference's under ``jax.jit`` on the
same example arguments, and ``dryrun_multichip(8, device="cpu")`` passing
its own checks on eight CPU shards."""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as ref_entry  # noqa: E402
from monetdb_tpu_torch import config, harness  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_equals_reference_entry():
    fn, args = harness.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    rfn, rargs = ref_entry.entry()
    for a, r in zip(args, rargs):
        assert np.array_equal(a.numpy(), np.asarray(r))
    want = jax.jit(rfn)(*rargs)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and np.array_equal(g.numpy(),
                                                         np.asarray(w))
    assert int(got[5].sum()) > 0


def test_dryrun_multichip_on_cpu_shards():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)            # the eight shard threads are enough
    try:
        s0 = dict(TF.STATS)
        stats = harness.dryrun_multichip(8, device="cpu")
    finally:
        torch.set_num_threads(saved)
    assert stats["spmd_runs"] >= 20
    assert stats["shuffle_joins"] > 0
    assert stats["shuffle_groupbys"] + stats["shuffle_distincts"] > 0
    assert TF.STATS["spmd_runs"] > s0["spmd_runs"] + stats["spmd_runs"]
    # the dry run's thresholds are put back
    for k in harness.DRYRUN_CONFIG:
        assert config.get(k) == config._defaults[k]


def test_dryrun_check_fails_on_wrong_rows(monkeypatch):
    """A row the mesh gets wrong fails the dry run."""
    with pytest.raises(AssertionError, match="row 0"):
        harness._rows_match([(1, "a")], [(2, "a")], "q")
    with pytest.raises(AssertionError, match="row count"):
        harness._rows_match([(1,)], [], "q")
    harness._rows_match([(1.0,)], [(1.0 + 1e-12,)], "q")


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        return                          # the card takes it
    with pytest.raises((RuntimeError, AssertionError)):
        harness.entry()


def test_main_needs_a_card():
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, "-m", "monetdb_tpu_torch.harness"],
                       cwd=_ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1 and "no CUDA device" in r.stderr
