"""GPU tests of the PyTorch port: the hand-written CUDA kernels against
their plain PyTorch versions, and the engine on a CUDA device.

They need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode) and skip
elsewhere.  This file imports no JAX, so it runs on a GPU machine without
it; the suite's conftest.py imports JAX, so run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from monetdb_tpu_torch.bench import tpch_oracle
from monetdb_tpu_torch.ops import cuda_kernels as CK


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sid_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("n", [0, 1, 1000, 1 << 23, 6_001_215])
@pytest.mark.parametrize("domain", [1, 12, 32, 128])
def test_seg_sum64_kernel_vs_plain(cuda_device, n, domain, sid_dtype):
    """Exact equality at the engine's widths, ragged tails and tiny
    inputs, with excluded ids on both sides of [0, domain)."""
    g = torch.Generator(device=cuda_device).manual_seed(domain + n)
    sid = torch.randint(-1, domain + 2, (n,), generator=g,
                        device=cuda_device, dtype=sid_dtype)
    vals = torch.randint(-(1 << 45), 1 << 45, (n,), generator=g,
                         device=cuda_device, dtype=torch.int64)
    before = CK.LAUNCHES["seg_sum64"]
    ks, kc = CK.seg_sum64(sid, vals, domain=domain)
    ps, pc = CK.seg_sum64_plain(sid, vals, domain=domain)
    torch.cuda.synchronize()
    assert CK.LAUNCHES["seg_sum64"] == before + 1
    assert torch.equal(ks, ps) and torch.equal(kc, pc)


@pytest.mark.cuda
def test_seg_sum64_kernel_rejects_bad_input(cuda_device):
    sid = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    vals = torch.ones(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        CK.seg_sum64(sid, vals, domain=129)
    with pytest.raises(TypeError):
        CK.seg_sum64(sid.float(), vals, domain=4)
    with pytest.raises(ValueError):
        CK.seg_sum64(sid[::2], vals[::2], domain=4)
    with pytest.raises(ValueError):
        CK.seg_sum64(sid, vals.cpu(), domain=4)


def _fused_inputs(n, dev, seed):
    """Six int32 columns in the reference micro-benchmark's ranges, with
    codes from -1 to 13 (so every domain below excludes some)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def col(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)
    return (col(-1, 14), col(8035, 10561), col(100, 5100),
            col(9000, 2_000_000), col(0, 11), col(0, 9)), 10471


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1003, 6_001_215])
@pytest.mark.parametrize("domain", [1, 6, 8, 13, 128])
def test_q1_grouped_sums_kernel_vs_plain(cuda_device, n, domain):
    """Exact equality for small and wide domains, ragged lengths and an
    unaligned view (which takes the kernel's scalar loop)."""
    cols, cutoff = _fused_inputs(n + 1, cuda_device, n + domain)
    for view in (tuple(c[:n] for c in cols), tuple(c[1:] for c in cols)):
        before = CK.LAUNCHES["q1_grouped_sums"]
        got = CK.q1_grouped_sums(*view, cutoff, domain=domain)
        want = CK.q1_grouped_sums_plain(*view, cutoff, domain=domain)
        torch.cuda.synchronize()
        assert CK.LAUNCHES["q1_grouped_sums"] == before + 1
        assert len(got) == 6
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1003, 6_001_215])
@pytest.mark.parametrize("domain", [1, 8, 13, 128])
def test_grouped_sum_limbs_kernel_vs_plain(cuda_device, n, domain):
    cols, cutoff = _fused_inputs(n + 1, cuda_device, n + domain)
    code, ship, _qty, extp = cols[:4]
    extp = extp - 1_000_000                  # negative values too
    mask = ship <= cutoff
    for lo in (0, 1):                        # 1: unaligned views
        c, v, m = code[lo:lo + n], extp[lo:lo + n], mask[lo:lo + n]
        before = CK.LAUNCHES["grouped_sum_limbs"]
        got = CK.grouped_sum_limbs(c, v, m, domain=domain)
        want = CK.grouped_sum_limbs_plain(c, v, m, domain=domain)
        torch.cuda.synchronize()
        assert CK.LAUNCHES["grouped_sum_limbs"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_fused_kernels_reject_bad_input(cuda_device):
    cols, cutoff = _fused_inputs(64, cuda_device, 0)
    with pytest.raises(ValueError):
        CK.q1_grouped_sums(*cols, cutoff, domain=129)
    with pytest.raises(TypeError):
        CK.q1_grouped_sums(cols[0].long(), *cols[1:], cutoff)
    with pytest.raises(ValueError):
        CK.q1_grouped_sums(cols[0][::2], *cols[1:], cutoff)
    with pytest.raises(ValueError):
        CK.q1_grouped_sums(cols[0].cpu(), *cols[1:], cutoff)
    with pytest.raises(ValueError):
        CK.q1_grouped_sums(*cols, 1 << 31)
    mask = cols[1] <= cutoff
    with pytest.raises(TypeError):
        CK.grouped_sum_limbs(cols[0], cols[3], mask.to(torch.uint8),
                             domain=8)
    with pytest.raises(ValueError):
        CK.grouped_sum_limbs(cols[0], cols[3], mask[:-1], domain=8)
    with pytest.raises(ValueError):
        CK.grouped_sum_limbs(cols[0], cols[3], mask, domain=0)


@pytest.fixture(scope="module")
def engines_by_sf():
    """sf -> (generated data, engine on the card, engine on the CPU)."""
    from monetdb_tpu_torch.bench.tpch_gen import gen_tpch
    from monetdb_tpu_torch.bench.tpch_load import load_tables
    from monetdb_tpu_torch.engine import Engine
    made = {}

    def get(sf):
        if sf not in made:
            data = gen_tpch(sf)
            made[sf] = (data,
                        Engine(load_tables(data, device=torch.device("cuda"))),
                        Engine(load_tables(data, device="cpu")))
        return made[sf]
    return get


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 2, 3, 4, 5, 6, 19, 20])
@pytest.mark.parametrize("sf", [0.01, 0.1])
def test_engine_on_gpu_matches_cpu_and_oracle(cuda_device, engines_by_sf,
                                              sf, q):
    """TPC-H at SF0.01 and SF0.1 on the card: the rows equal the port's
    own CPU run (same ops, plain seg_sum64) and the numpy oracle, and the
    queries with a one-hot integer sum launch the kernel.  Exact but for
    the averages: torch's CPU kernel divides by a scalar as a multiply by
    its reciprocal, the CUDA kernel divides."""
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    data, gpu, cpu = engines_by_sf(sf)
    before = CK.LAUNCHES["seg_sum64"]
    got = list(gpu.query(QUERIES[q]).rows)
    if q in (1, 4, 5, 6, 19):
        assert CK.LAUNCHES["seg_sum64"] > before
    assert got
    assert tpch_oracle.rows_differ(
        got, list(cpu.query(QUERIES[q]).rows), 1e-12) is None
    if q in tpch_oracle.ORACLES:
        want = tpch_oracle.decoded(q, tpch_oracle.ORACLES[q](data))
        assert tpch_oracle.rows_differ(got, want, 1e-12) is None
    # a warm run (shrunk buckets, possibly another group-by strategy)
    assert list(gpu.query(QUERIES[q]).rows) == got
