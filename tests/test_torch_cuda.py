"""GPU tests of the PyTorch port: the hand-written CUDA kernels against
their plain PyTorch versions, and the engine on a CUDA device.

They need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode) and skip
elsewhere.  This file imports no JAX, so it runs on a GPU machine without
it; the suite's conftest.py imports JAX, so run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import importlib.util
import math
import os
from decimal import Decimal

import pytest
import torch

from monetdb_tpu_torch.ops import cuda_kernels as CK

_HERE = os.path.dirname(os.path.abspath(__file__))


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
    before = CK.SEG_SUM64_LAUNCHES
    ks, kc = CK.seg_sum64(sid, vals, domain=domain)
    ps, pc = CK.seg_sum64_plain(sid, vals, domain=domain)
    torch.cuda.synchronize()
    assert CK.SEG_SUM64_LAUNCHES == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 6])
def test_engine_on_gpu_matches_cpu_and_oracle(cuda_device, q):
    """TPC-H Q1/Q6 at SF0.01 on the card: the rows equal the port's own
    CPU run (same ops, plain seg_sum64) and launch the kernel."""
    from monetdb_tpu_torch.bench.tpch_gen import gen_tpch
    from monetdb_tpu_torch.bench.tpch_load import load_tables
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    from monetdb_tpu_torch.engine import Engine
    data = gen_tpch(0.01)
    gpu = Engine(load_tables(data, device=cuda_device))
    cpu = Engine(load_tables(data, device="cpu"))
    before = CK.SEG_SUM64_LAUNCHES
    got = list(gpu.query(QUERIES[q]).rows)
    assert CK.SEG_SUM64_LAUNCHES > before
    # exact but for the averages: torch's CPU kernel divides by a scalar
    # as a multiply by its reciprocal, the CUDA kernel divides
    for grow, crow in zip(got, cpu.query(QUERIES[q]).rows, strict=True):
        for g, c in zip(grow, crow, strict=True):
            assert math.isclose(g, c, rel_tol=1e-12) \
                if isinstance(c, float) else g == c, (grow, crow)
    spec = importlib.util.spec_from_file_location(
        "tpch_oracle", os.path.join(_HERE, "tpch_oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    want = oracle.q1(data) if q == 1 else oracle.q6(data)
    if q == 1:
        assert [r[:2] + r[-1:] for r in got] == \
            [w[:2] + w[-1:] for w in want]
    else:
        assert got == [(Decimal(want[0][0]).scaleb(-4),)]
