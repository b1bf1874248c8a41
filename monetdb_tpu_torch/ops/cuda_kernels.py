"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``seg_sum64`` replaces ``monetdb_tpu/ops/pallas_kernels.py:seg_sum64``, the
reference's grouped-sum Pallas kernel: the exact int64 sum and row count
per segment of a small dense domain, in one pass over the rows.  It is
bound by memory (12-16 bytes read per row, nothing written but the
per-block atomics); csrc/seg_sum64.cu answers that with a grid-stride loop
of coalesced loads and per-lane shared-memory accumulators (no two lanes
of a warp ever add to one address, so few live groups cost no more than
many), flushed with one global 64-bit atomicAdd per slot and block.

Each kernel has:
  * a wrapper that launches it for CUDA tensors, after checking dtype,
    device, contiguity and shape, and raises if the launch fails.  On a
    CPU tensor the wrapper runs the plain version instead; on a CUDA tensor
    there is no path to the plain version;
  * a plain PyTorch version with the same semantics (``*_plain``);
  * a launch counter (``SEG_SUM64_LAUNCHES``), raised by one at every
    launch and nowhere else, so a run can show that its path went through
    the kernel.

The kernels are compiled at first use with ``nvcc`` for sm_90a into a
shared library with a plain C interface, cached under ``_build/`` by a hash
of the source, and loaded with ctypes.  A missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

__all__ = ["seg_sum64", "seg_sum64_plain", "build", "SEG_SUM64_LAUNCHES",
           "SEG_SUM64_MAX_DOMAIN"]

#: largest segment domain seg_sum64 takes (the fragment's one-hot bound,
#: exec/fragment.py _ONEHOT_MAX)
SEG_SUM64_MAX_DOMAIN = 128

#: kernel launches so far (see module docstring)
SEG_SUM64_LAUNCHES = 0

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "seg_sum64.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
_THREADS = 256
# 4 resident blocks of 256 threads per SM measured ahead of 8 and 16 at
# 12-128 slots on an H100 (the 48 KiB of shared memory at 128 slots allows
# 4 anyway)
_BLOCKS_PER_SM = 4

_lib = None
_lib_lock = threading.Lock()
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


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        out = os.path.join(_BUILD_DIR, f"libseg_sum64_{tag}.so")
        if not os.path.exists(out):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                   "-Xcompiler", "-fPIC", "-o", tmp, _SRC]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({r.returncode}): "
                                   f"{' '.join(cmd)}\n{r.stderr}")
            BUILD_LOG = r.stderr
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        fn = lib.seg_sum64_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


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
    global SEG_SUM64_LAUNCHES
    if sid.device.type == "cpu" and vals.device.type == "cpu":
        return seg_sum64_plain(sid, vals, domain=domain)
    if sid.device.type != "cuda" or vals.device != sid.device:
        raise ValueError(f"seg_sum64: sid on {sid.device}, vals on "
                         f"{vals.device}; both must be on one CUDA device")
    if sid.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"seg_sum64: sid must be int32 or int64, "
                        f"not {sid.dtype}")
    if vals.dtype.is_floating_point or vals.dtype.is_complex:
        raise TypeError(f"seg_sum64: vals must be integer, not {vals.dtype}")
    if sid.dim() != 1 or vals.shape != sid.shape:
        raise ValueError(f"seg_sum64: sid {tuple(sid.shape)} and vals "
                         f"{tuple(vals.shape)} must be equal 1-D shapes")
    if not 1 <= domain <= SEG_SUM64_MAX_DOMAIN:
        raise ValueError(f"seg_sum64: domain {domain} outside "
                         f"[1, {SEG_SUM64_MAX_DOMAIN}]")
    v = vals.to(torch.int64)              # widen (pallas_kernels.py:176)
    if not (sid.is_contiguous() and v.is_contiguous()):
        raise ValueError("seg_sum64: sid and vals must be contiguous")
    lib = build()
    dev = sid.device
    out = torch.zeros(2, domain, dtype=torch.int64, device=dev)
    n = sid.numel()
    sms = _sm_count.get(dev.index)
    if sms is None:
        sms = _sm_count[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-n // _THREADS), sms * _BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.seg_sum64_launch(sid.data_ptr(), sid.element_size(),
                              v.data_ptr(), n, domain, out[0].data_ptr(),
                              out[1].data_ptr(), blocks, _THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"seg_sum64: kernel launch failed with CUDA "
                           f"error {rc}")
    SEG_SUM64_LAUNCHES += 1
    return out[0], out[1]
