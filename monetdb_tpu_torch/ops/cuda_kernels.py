"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each replaces one Pallas kernel of the reference package
(monetdb_tpu/ops/pallas_kernels.py), all three exact grouped integer sums
over a small dense domain in one pass over the rows:

* ``seg_sum64`` - per-segment int64 sum and row count; the engine's
  grouped-sum kernel under ``_SegReduce.sum`` (exec/fragment.py).
* ``q1_grouped_sums`` - fused TPC-H Q1: filter, the two decimal products
  and six grouped sums over six int32 columns.
* ``grouped_sum_limbs`` - masked grouped sum and count of int32 values.

All are bound by memory (9-24 bytes read per row, nothing written but a
few atomics per block); the sources under csrc/ say what each design does
about that.  The TPU kernels split values into 16-bit limbs because Mosaic
has no 64-bit integers; Hopper has, so these add whole 64-bit values.

Each kernel has:
  * a wrapper that launches it for CUDA tensors, after checking dtype,
    device, contiguity and shape, and raises if the launch fails.  On a
    CPU tensor the wrapper runs the plain version instead; on a CUDA tensor
    there is no path to the plain version;
  * a plain PyTorch version with the same semantics (``*_plain``);
  * a launch counter (``LAUNCHES[name]``), raised by one at every launch
    and nowhere else, so a run can show that its path went through the
    kernel.

The kernels are compiled at first use with ``nvcc`` for sm_90a, one shared
library with a plain C interface per source under csrc/ (all compilers
started together), cached under ``_build/`` by a hash of all sources, and
loaded with ctypes.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

__all__ = ["seg_sum64", "seg_sum64_plain", "q1_grouped_sums",
           "q1_grouped_sums_plain", "grouped_sum_limbs",
           "grouped_sum_limbs_plain", "build", "LAUNCHES", "MAX_DOMAIN",
           "SEG_SUM_BLOCK"]

#: largest group domain the kernels take (the fragment's one-hot bound,
#: exec/fragment.py _ONEHOT_MAX)
MAX_DOMAIN = 128

#: the reference kernel's row block (pallas_kernels.py SEG_SUM_BLOCK): its
#: inputs' length is a multiple of it.  These kernels take any length; a
#: caller that cuts its rows to the reference's multiple (the bench) sums
#: the same rows as the reference.
SEG_SUM_BLOCK = 16384

#: kernel launches so far, by kernel name (see module docstring)
LAUNCHES = {"seg_sum64": 0, "q1_grouped_sums": 0, "grouped_sum_limbs": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")
_THREADS = 256
# 4 resident blocks of 256 threads per SM measured ahead of 8 and 16 at
# 12-128 slots on an H100 (the 48 KiB of shared memory at 128 slots allows
# 4 anyway)
_BLOCKS_PER_SM = 4
#: shared memory the blocks of one SM can hold together
_SHMEM_PER_SM = 227 * 1024

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry point -> argument types (every one returns the launch's
#: cudaError_t as an int); the source is csrc/<name minus "_launch">.cu
_SIGNATURES = {
    "seg_sum64_launch": [_P, _I, _P, _LL, _I, _P, _P, _I, _I, _P],
    "q1_grouped_sums_launch": [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _P, _I,
                               _I, _P],
    "grouped_sum_limbs_launch": [_P, _P, _P, _LL, _I, _P, _P, _I, _I, _P],
}

_fns = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_sm_count = {}          # device index -> multiprocessor count
#: ptxas register/shared-memory report of the last build in this process
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def build() -> dict:
    """Compile (once per hash of csrc/) and load every kernel library;
    returns {C entry point: ctypes function}."""
    global _fns, BUILD_LOG
    with _lib_lock:
        if _fns is not None:
            return _fns
        h = hashlib.sha256()
        for name in sorted(os.listdir(_CSRC)):
            with open(os.path.join(_CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read() + b"\0")
        tag = h.hexdigest()[:16]
        libs = {fn: os.path.join(_BUILD_DIR, f"lib{fn[:-7]}_{tag}.so")
                for fn in _SIGNATURES}
        jobs = []
        for fn, out in libs.items():
            if os.path.exists(out):
                continue
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                   "-Xcompiler", "-fPIC", "-o", tmp,
                   os.path.join(_CSRC, fn[:-7] + ".cu")]
            jobs.append((cmd, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, tmp, out, proc in jobs:      # wait for all, then report
            _stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{stderr}")
                continue
            BUILD_LOG += stderr
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        fns = {}
        for fn, out in libs.items():
            f = getattr(ctypes.CDLL(out), fn)
            f.argtypes = _SIGNATURES[fn]
            f.restype = ctypes.c_int
            fns[fn] = f
        _fns = fns
        return fns


def _sms(dev: torch.device) -> int:
    sms = _sm_count.get(dev.index)
    if sms is None:
        sms = _sm_count[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _check_columns(name: str, cols: dict, dtypes: dict) -> torch.device:
    """All of ``cols`` {argument: tensor} are contiguous 1-D tensors of one
    length on one CUDA device, with the dtype ``dtypes`` names for them."""
    first = next(iter(cols.values()))
    dev = first.device
    for arg, t in cols.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, "
                             f"{next(iter(cols))} on {dev}; all must be on "
                             f"one CUDA device")
        if t.dtype not in dtypes[arg]:
            raise TypeError(f"{name}: {arg} must be "
                            f"{' or '.join(map(str, dtypes[arg]))}, "
                            f"not {t.dtype}")
        if t.dim() != 1 or t.shape != first.shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} must be 1-D "
                             f"with the shape of {next(iter(cols))} "
                             f"{tuple(first.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dev


def _check_domain(name: str, domain: int) -> None:
    if not 1 <= domain <= MAX_DOMAIN:
        raise ValueError(f"{name}: domain {domain} outside "
                         f"[1, {MAX_DOMAIN}]")


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                           f"error {rc}")
    # the shards of a row mesh launch from threads of their own
    with _count_lock:
        LAUNCHES[name] += 1


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


# ---------------------------------------------------------------------------
# seg_sum64
# ---------------------------------------------------------------------------


def seg_sum64_plain(sid: torch.Tensor, vals: torch.Tensor, *, domain: int):
    """Plain PyTorch seg_sum64: rows with sid outside [0, domain) go to an
    extra slot that is cut off.  Integer index_add_ wraps modulo 2^64 like
    the kernel, so both are exact."""
    idx = torch.where((sid >= 0) & (sid < domain), sid, domain).long()
    v = vals.to(torch.int64)
    sums = torch.zeros(domain + 1, dtype=torch.int64, device=sid.device)
    counts = torch.zeros(domain + 1, dtype=torch.int64, device=sid.device)
    sums.index_add_(0, idx, v)
    counts.index_add_(0, idx, torch.ones_like(v))
    return sums[:domain], counts[:domain]


def seg_sum64(sid: torch.Tensor, vals: torch.Tensor, *, domain: int):
    """Exact per-segment sum + count of integer ``vals`` over segment ids
    ``sid`` in [0, domain) (rows with sid outside that range are excluded).
    Any length.  Returns (sums int64[domain], counts int64[domain])."""
    if _on_cpu(sid, vals):
        return seg_sum64_plain(sid, vals, domain=domain)
    if vals.dtype.is_floating_point or vals.dtype.is_complex:
        raise TypeError(f"seg_sum64: vals must be integer, not {vals.dtype}")
    if vals.shape != sid.shape:
        raise ValueError(f"seg_sum64: sid {tuple(sid.shape)} and vals "
                         f"{tuple(vals.shape)} must be equal 1-D shapes")
    v = vals.to(torch.int64)              # widen (pallas_kernels.py:176)
    dev = _check_columns("seg_sum64", {"sid": sid, "vals": v},
                         {"sid": (torch.int32, torch.int64),
                          "vals": (torch.int64,)})
    _check_domain("seg_sum64", domain)
    fn = build()["seg_sum64_launch"]
    out = torch.zeros(2, domain, dtype=torch.int64, device=dev)
    n = sid.numel()
    blocks = max(1, min(-(-n // _THREADS), _sms(dev) * _BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(dev).cuda_stream
    # a server thread's current device need not be the tensors'
    with torch.cuda.device(dev):
        _launched("seg_sum64", fn(
            sid.data_ptr(), sid.element_size(), v.data_ptr(), n, domain,
            out[0].data_ptr(), out[1].data_ptr(), blocks, _THREADS, stream))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# q1_grouped_sums
# ---------------------------------------------------------------------------

_Q1_ARGS = ("code", "shipdate", "qty", "extp", "disc", "tax")


def q1_grouped_sums_plain(code, shipdate, qty, extp, disc, tax, cutoff, *,
                          domain: int = 8):
    """Plain PyTorch q1_grouped_sums: the mask, int64 products and one
    index_add_ per measure into domain + 1 slots (the last is cut off)."""
    m = (code >= 0) & (code < domain) & (shipdate <= int(cutoff))
    idx = torch.where(m, code, domain).long()
    e = extp.to(torch.int64)
    dp = e * (100 - disc.to(torch.int64))
    ch = dp * (100 + tax.to(torch.int64))
    out = []
    for v in (qty.to(torch.int64), e, dp, ch, disc.to(torch.int64),
              torch.ones_like(e)):
        acc = torch.zeros(domain + 1, dtype=torch.int64, device=code.device)
        out.append(acc.index_add_(0, idx, v)[:domain])
    return tuple(out)


def q1_grouped_sums(code, shipdate, qty, extp, disc, tax, cutoff, *,
                    domain: int = 8):
    """Fused TPC-H Q1 aggregation over six int32 columns of any one length:
    over rows with ``0 <= code < domain`` and ``shipdate <= cutoff``, per
    group the exact sums of qty, extp, disc_price = extp * (100 - disc),
    charge = disc_price * (100 + tax) and disc, and the row count.  Returns
    int64[domain] arrays (sum_qty, sum_extp, sum_disc_price, sum_charge,
    sum_disc, count).

    The products are formed in 64 bits and sums wrap modulo 2^64, so the
    results equal the reference TPU kernel's wherever its own range notes
    hold (disc_price < 2^31, pallas_kernels.py:60-64) and stay exact beyond
    them."""
    cols = (code, shipdate, qty, extp, disc, tax)
    if _on_cpu(*cols):
        return q1_grouped_sums_plain(*cols, cutoff, domain=domain)
    _check_columns("q1_grouped_sums", dict(zip(_Q1_ARGS, cols)),
                   dict.fromkeys(_Q1_ARGS, (torch.int32,)))
    _check_domain("q1_grouped_sums", domain)
    cutoff = int(cutoff)
    if not -(1 << 31) <= cutoff < (1 << 31):
        raise ValueError(f"q1_grouped_sums: cutoff {cutoff} outside int32")
    dev = code.device
    fn = build()["q1_grouped_sums_launch"]
    out = torch.zeros(6, domain, dtype=torch.int64, device=dev)
    n = code.numel()
    # 1,536 * domain bytes of accumulators per block (+1 KiB the system
    # reserves): 192 KiB at 128 slots leaves room for one block per SM
    per_sm = max(1, min(_BLOCKS_PER_SM,
                        _SHMEM_PER_SM // (domain * 6 * 8 * 32 + 1024)))
    blocks = max(1, min(-(-n // (4 * _THREADS)), _sms(dev) * per_sm))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _launched("q1_grouped_sums", fn(
            *(c.data_ptr() for c in cols), cutoff, n, domain, out.data_ptr(),
            blocks, _THREADS, stream))
    return tuple(out[k] for k in range(6))


# ---------------------------------------------------------------------------
# grouped_sum_limbs
# ---------------------------------------------------------------------------


def grouped_sum_limbs_plain(code, values, mask, *, domain: int):
    """Plain PyTorch grouped_sum_limbs: masked-out rows and codes outside
    [0, domain) go to an extra slot that is cut off."""
    idx = torch.where(mask & (code >= 0) & (code < domain), code,
                      domain).long()
    v = values.to(torch.int64)
    sums = torch.zeros(domain + 1, dtype=torch.int64, device=code.device)
    counts = torch.zeros(domain + 1, dtype=torch.int64, device=code.device)
    sums.index_add_(0, idx, v)
    counts.index_add_(0, idx, torch.ones_like(v))
    return sums[:domain], counts[:domain]


def grouped_sum_limbs(code, values, mask, *, domain: int):
    """Exact grouped sum + count of int32 ``values`` over int32 ``code`` in
    [0, domain), rows with a false ``mask`` (bool) excluded.  Any length.
    Returns (sums int64[domain], counts int64[domain]).  (The name is the
    reference TPU kernel's, which sums 16-bit limbs; this one adds whole
    sign-extended values.)"""
    if _on_cpu(code, values, mask):
        return grouped_sum_limbs_plain(code, values, mask, domain=domain)
    dev = _check_columns(
        "grouped_sum_limbs", {"code": code, "values": values, "mask": mask},
        {"code": (torch.int32,), "values": (torch.int32,),
         "mask": (torch.bool,)})
    _check_domain("grouped_sum_limbs", domain)
    fn = build()["grouped_sum_limbs_launch"]
    out = torch.zeros(2, domain, dtype=torch.int64, device=dev)
    n = code.numel()
    blocks = max(1, min(-(-n // (4 * _THREADS)),
                        _sms(dev) * _BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _launched("grouped_sum_limbs", fn(
            code.data_ptr(), values.data_ptr(), mask.data_ptr(), n, domain,
            out[0].data_ptr(), out[1].data_ptr(), blocks, _THREADS, stream))
    return out[0], out[1]
