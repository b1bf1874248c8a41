"""seg_sum64 of the PyTorch port (monetdb_tpu_torch/ops/cuda_kernels.py)
against the reference Pallas kernel (monetdb_tpu/ops/pallas_kernels.py
seg_sum64, run in interpret mode on the CPU as test_pallas_kernels.py runs
it) and a numpy oracle.  Every check is exact equality: both sides compute
exact int64 sums.

The CPU tests exercise the plain PyTorch version, which the wrapper takes
for CPU tensors.  The CUDA kernel itself is held against that plain
version on a GPU by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from monetdb_tpu.ops import pallas_kernels as PK
from monetdb_tpu_torch.ops import cuda_kernels as CK


def _pallas(sid, vals, domain):
    s, c = PK.seg_sum64(jnp.asarray(sid), jnp.asarray(vals), domain=domain,
                        interpret=True)
    return np.asarray(s), np.asarray(c)


def _port(sid, vals, domain):
    s, c = CK.seg_sum64(torch.from_numpy(sid), torch.from_numpy(vals),
                        domain=domain)
    return s.numpy(), c.numpy()


def _oracle(sid, vals, domain):
    sums = np.zeros(domain, np.int64)
    cnts = np.zeros(domain, np.int64)
    for g in range(domain):
        m = sid == g
        sums[g] = vals[m].sum()
        cnts[g] = m.sum()
    return sums, cnts


@pytest.mark.parametrize("sid_dtype", [np.int32, np.int64])
def test_seg_sum64_exact_negatives_and_excluded(sid_dtype):
    """Negative values, values beyond int32 and excluded rows (sid ==
    domain), as tests/test_pallas_kernels.py:66 checks the reference."""
    n = PK.SEG_SUM_BLOCK * 2
    domain = 5
    rng = np.random.default_rng(11)
    sid = rng.integers(0, domain + 1, n).astype(sid_dtype)
    vals = rng.integers(-(2 ** 45), 2 ** 45, n).astype(np.int64)
    ps, pc = _pallas(sid, vals, domain)
    ts, tc = _port(sid, vals, domain)
    assert np.array_equal(ts, ps) and np.array_equal(tc, pc)
    os_, oc = _oracle(sid, vals, domain)
    assert np.array_equal(ts, os_) and np.array_equal(tc, oc)


def test_seg_sum64_matches_onehot_segreduce():
    """Agreement with the one-hot form the kernel replaces under
    _SegReduce.sum (tests/test_pallas_kernels.py:82)."""
    n = PK.SEG_SUM_BLOCK
    domain = 8
    rng = np.random.default_rng(12)
    sid = rng.integers(0, domain + 1, n).astype(np.int64)
    vals = np.where(sid < domain, rng.integers(0, 10 ** 12, n), 0)
    oh = sid[:, None] == np.arange(domain)[None, :]
    want = np.where(oh, vals[:, None], 0).sum(axis=0)
    ts, _ = _port(sid, vals, domain)
    ps, _ = _pallas(sid, vals, domain)
    assert np.array_equal(ts, want) and np.array_equal(ts, ps)


# interpret-mode Pallas unrolls a loop over the domain: above 12 slots it
# takes many seconds, so the wider domains are held against numpy
@pytest.mark.parametrize("domain,ref", [(1, _pallas), (12, _pallas),
                                        (32, _oracle), (128, _oracle)])
def test_seg_sum64_domains(domain, ref):
    """The domains the engine gives the kernel (Q6: 1, Q1: 12, up to the
    one-hot bound 128), with sids outside [0, domain) on both sides."""
    n = PK.SEG_SUM_BLOCK
    rng = np.random.default_rng(domain)
    sid = rng.integers(-2, domain + 3, n).astype(np.int64)
    vals = rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64)
    rs, rc = ref(sid, vals, domain)
    ts, tc = _port(sid, vals, domain)
    assert np.array_equal(ts, rs) and np.array_equal(tc, rc)


@pytest.mark.parametrize("n", [0, 1, 6001, 16384 * 3 + 77])
def test_seg_sum64_ragged_vs_numpy(n):
    """Any length: the port takes ragged tails the TPU kernel cannot."""
    domain = 12
    rng = np.random.default_rng(n)
    sid = rng.integers(0, domain + 1, n).astype(np.int32)
    vals = rng.integers(-(2 ** 45), 2 ** 45, n).astype(np.int64)
    ts, tc = _port(sid, vals, domain)
    os_, oc = _oracle(sid, vals, domain)
    assert np.array_equal(ts, os_) and np.array_equal(tc, oc)


def test_seg_sum64_wraps_mod_2_64():
    """Sums past int64 wrap modulo 2^64 on both sides (the TPU kernel's
    limb recombination wraps the same way)."""
    n = PK.SEG_SUM_BLOCK
    sid = np.zeros(n, np.int64)
    vals = np.full(n, 2 ** 62 + 3, np.int64)
    ps, _ = _pallas(sid, vals, 1)
    ts, _ = _port(sid, vals, 1)
    assert np.array_equal(ts, ps)
    want = ((2 ** 62 + 3) * n + 2 ** 63) % 2 ** 64 - 2 ** 63
    assert int(ts[0]) == want != 0


def test_seg_sum64_cpu_takes_plain_version():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; a tensor on any other non-CUDA device is refused."""
    before = CK.SEG_SUM64_LAUNCHES
    sid = torch.tensor([0, 1, 2, 1])
    vals = torch.tensor([5, -7, 9, 11], dtype=torch.int32)
    s, c = CK.seg_sum64(sid, vals, domain=2)
    assert s.tolist() == [5, 4] and c.tolist() == [1, 2]
    assert CK.SEG_SUM64_LAUNCHES == before
    with pytest.raises(ValueError):
        CK.seg_sum64(sid.to("meta"), vals.to("meta"), domain=2)
