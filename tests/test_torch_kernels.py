"""The kernels of the PyTorch port (monetdb_tpu_torch/ops/cuda_kernels.py:
seg_sum64, q1_grouped_sums, grouped_sum_limbs) against the reference Pallas
kernels (monetdb_tpu/ops/pallas_kernels.py, run in interpret mode on the
CPU as test_pallas_kernels.py runs them) and a numpy oracle.  Every check
is exact equality: both sides compute exact int64 sums.

The CPU tests exercise the plain PyTorch versions, which the wrappers take
for CPU tensors.  The CUDA kernels themselves are held against those plain
versions on a GPU by tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

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
    before = dict(CK.LAUNCHES)
    sid = torch.tensor([0, 1, 2, 1])
    vals = torch.tensor([5, -7, 9, 11], dtype=torch.int32)
    s, c = CK.seg_sum64(sid, vals, domain=2)
    assert s.tolist() == [5, 4] and c.tolist() == [1, 2]
    assert CK.LAUNCHES == before
    with pytest.raises(ValueError):
        CK.seg_sum64(sid.to("meta"), vals.to("meta"), domain=2)


# ---------------------------------------------------------------------------
# q1_grouped_sums and grouped_sum_limbs
# ---------------------------------------------------------------------------


@pytest.fixture
def pallas_interpret(monkeypatch):
    """These two reference kernels have no ``interpret`` argument: patch
    ``pl.pallas_call`` as tests/test_pallas_kernels.py does."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(PK.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _q1_inputs(n, seed, ncodes=6):
    """Six int32 columns in the ranges of the reference's tests; about a
    hundredth of the rows carry code -1, the cutoff excludes some."""
    rng = np.random.default_rng(seed)
    code = rng.integers(0, ncodes, n).astype(np.int32)
    code[rng.random(n) < 0.01] = -1
    ship = rng.integers(8035, 10561, n).astype(np.int32)
    qty = rng.integers(100, 5100, n).astype(np.int32)
    extp = (qty.astype(np.int64) * rng.integers(90, 2000, n)).astype(np.int32)
    disc = rng.integers(0, 11, n).astype(np.int32)
    tax = rng.integers(0, 9, n).astype(np.int32)
    return (code, ship, qty, extp, disc, tax), 10471


def _q1_port(cols, cutoff, domain):
    out = CK.q1_grouped_sums(*[torch.from_numpy(a) for a in cols], cutoff,
                             domain=domain)
    return [o.numpy() for o in out]


def _q1_oracle(cols, cutoff, domain):
    """Python-int sums per group."""
    code, ship, qty, extp, disc, tax = cols
    m = (ship <= cutoff) & (code >= 0)
    dp = extp.astype(object) * (100 - disc.astype(object))
    ch = dp * (100 + tax.astype(object))
    out = [[] for _ in range(6)]
    for g in range(domain):
        mg = m & (code == g)
        for j, v in enumerate((qty, extp, dp, ch, disc)):
            out[j].append(int(v[mg].astype(object).sum()))
        out[5].append(int(mg.sum()))
    return out


def _gsl_port(code, vals, mask, domain):
    s, c = CK.grouped_sum_limbs(torch.from_numpy(code),
                                torch.from_numpy(vals),
                                torch.from_numpy(mask), domain=domain)
    return s.numpy(), c.numpy()


def _gsl_oracle(code, vals, mask, domain):
    sums, cnts = [], []
    for g in range(domain):
        mg = mask & (code == g)
        sums.append(int(vals[mg].astype(object).sum()))
        cnts.append(int(mg.sum()))
    return sums, cnts


def test_q1_grouped_sums_matches_pallas(pallas_interpret):
    """The reference kernel's own test shape (3 blocks, domain 8, padding
    rows with code -1): all six outputs equal, and equal to python ints."""
    cols, cutoff = _q1_inputs(PK._BLOCK * 3, 7)
    ref = PK.q1_grouped_sums(*[jnp.asarray(a) for a in cols],
                             np.int32(cutoff), domain=8)
    got = _q1_port(cols, cutoff, 8)
    assert len(got) == 6
    for g, r in zip(got, ref):
        assert g.dtype == np.int64 and np.array_equal(g, np.asarray(r))
    assert [g.tolist() for g in got] == _q1_oracle(cols, cutoff, 8)


@pytest.mark.parametrize("n,domain,ncodes", [
    (0, 8, 6), (1, 8, 6), (6001, 8, 6), (16384 * 2 + 77, 8, 6),
    (5000, 1, 3), (5000, 13, 15)])
def test_q1_grouped_sums_ragged_and_domains_vs_numpy(n, domain, ncodes):
    """Any length (the TPU kernel needs n % 16384 == 0), domains 1 and 13,
    codes at and beyond the domain excluded."""
    cols, cutoff = _q1_inputs(n, n + domain, ncodes)
    got = _q1_port(cols, cutoff, domain)
    assert [g.tolist() for g in got] == _q1_oracle(cols, cutoff, domain)


def test_q1_grouped_sums_all_rows_masked():
    cols, _ = _q1_inputs(4096, 3)
    got = _q1_port(cols, 0, 8)             # cutoff before every shipdate
    assert all(g.tolist() == [0] * 8 for g in got)
    cols = (np.full(4096, -1, np.int32),) + cols[1:]
    got = _q1_port(cols, 10471, 8)         # every row is padding
    assert all(g.tolist() == [0] * 8 for g in got)


def test_q1_grouped_sums_exact_beyond_int32_products():
    """disc_price beyond 2^31 (outside the TPU kernel's range notes): the
    port forms 64-bit products and stays exact."""
    n = 1000
    cols = (np.zeros(n, np.int32), np.zeros(n, np.int32),
            np.full(n, 5000, np.int32), np.full(n, 2_000_000_000, np.int32),
            np.zeros(n, np.int32), np.full(n, 8, np.int32))
    got = _q1_port(cols, 0, 8)
    assert int(got[2][0]) == 2_000_000_000 * 100 * n
    assert int(got[3][0]) == 2_000_000_000 * 100 * 108 * n


def test_grouped_sum_limbs_matches_pallas(pallas_interpret):
    """The reference kernel's own test shape (2 blocks, domain 13)."""
    n = PK._BLOCK * 2
    rng = np.random.default_rng(3)
    code = rng.integers(0, 13, n).astype(np.int32)
    vals = rng.integers(0, 2 ** 30, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    rs, rc = PK.grouped_sum_limbs(jnp.asarray(code), jnp.asarray(vals),
                                  jnp.asarray(mask), domain=13)
    ts, tc = _gsl_port(code, vals, mask, 13)
    assert ts.dtype == tc.dtype == np.int64
    assert np.array_equal(ts, np.asarray(rs))
    assert np.array_equal(tc, np.asarray(rc))
    assert (ts.tolist(), tc.tolist()) == _gsl_oracle(code, vals, mask, 13)


@pytest.mark.parametrize("n,domain", [(0, 13), (1, 13), (6001, 13),
                                      (16384 + 77, 13), (5000, 1)])
def test_grouped_sum_limbs_ragged_and_domains_vs_numpy(n, domain):
    """Any length, domains 1 and 13, codes outside [0, domain) excluded."""
    rng = np.random.default_rng(n + domain)
    code = rng.integers(-1, domain + 2, n).astype(np.int32)
    vals = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)
    mask = rng.random(n) < 0.6
    ts, tc = _gsl_port(code, vals, mask, domain)
    assert (ts.tolist(), tc.tolist()) == _gsl_oracle(code, vals, mask,
                                                     domain)


def test_grouped_sum_limbs_all_rows_masked():
    rng = np.random.default_rng(9)
    code = rng.integers(0, 13, 4096).astype(np.int32)
    vals = rng.integers(0, 2 ** 30, 4096).astype(np.int32)
    ts, tc = _gsl_port(code, vals, np.zeros(4096, bool), 13)
    assert ts.tolist() == [0] * 13 and tc.tolist() == [0] * 13


def test_fused_kernels_cpu_take_plain_version():
    """On CPU tensors both wrappers are their plain versions and launch
    nothing; tensors on another non-CUDA device are refused."""
    before = dict(CK.LAUNCHES)
    cols, cutoff = _q1_inputs(64, 1)
    t = [torch.from_numpy(a) for a in cols]
    got = CK.q1_grouped_sums(*t, cutoff)
    want = CK.q1_grouped_sums_plain(*t, cutoff)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    mask = t[1] <= cutoff
    got = CK.grouped_sum_limbs(t[0], t[3], mask, domain=8)
    want = CK.grouped_sum_limbs_plain(t[0], t[3], mask, domain=8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert CK.LAUNCHES == before
    with pytest.raises(ValueError):
        CK.q1_grouped_sums(*[x.to("meta") for x in t], cutoff)
    with pytest.raises(ValueError):
        CK.grouped_sum_limbs(t[0].to("meta"), t[3].to("meta"),
                             mask.to("meta"), domain=8)
