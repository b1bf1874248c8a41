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

Four more replace no TPU kernel.  Two compute the lowering's maps over a
string dictionary on the card (ops/dictmap.py), over its UTF-8 byte heap
(column.StrHeap: ``data`` uint8, ``offsets`` int32):

* ``like_match`` - one bool a value under a SQL LIKE program
  (strfuncs.like_program);
* ``substr_keys`` - each value's substring / left / right as a sortable
  64-bit key of its bytes.

Two run relational nodes of the fragment interpreter (exec/fragment.py),
whose chains XLA fuses for the reference:

* ``join_probe`` - the dense equi-join's probe side (``_Interp.r_join``):
  liveness, key checks, the packed key's slot lookup, the output mask and
  the carried build columns in one pass over the probe rows;
* ``compact_rows`` - the compaction barrier (``_Interp.r_compact``, the
  masked result's compaction): each column's live rows to the front of a
  smaller capacity, nils behind, and the live count, in four launches.

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
import re
import shutil
import subprocess
import threading

import numpy as np
import torch

from ._tensor import gather_nil, nil_const, nilm, npdt, set_drop

__all__ = ["seg_sum64", "seg_sum64_plain", "q1_grouped_sums",
           "q1_grouped_sums_plain", "grouped_sum_limbs",
           "grouped_sum_limbs_plain", "like_match", "like_match_plain",
           "substr_keys", "substr_keys_plain", "join_probe",
           "join_probe_plain", "compact_rows", "compact_rows_plain", "build",
           "LAUNCHES", "MAX_DOMAIN", "SEG_SUM_BLOCK", "LIKE_MAX_OPS",
           "LIKE_ONE", "LIKE_ANY", "JOIN_MAX_KEYS", "JOIN_MAX_COLS",
           "COMPACT_MAX_COLS"]

#: largest group domain the kernels take (the fragment's one-hot bound,
#: exec/fragment.py _ONEHOT_MAX)
MAX_DOMAIN = 128

#: the reference kernel's row block (pallas_kernels.py SEG_SUM_BLOCK): its
#: inputs' length is a multiple of it.  These kernels take any length; a
#: caller that cuts its rows to the reference's multiple (the bench) sums
#: the same rows as the reference.
SEG_SUM_BLOCK = 16384

#: kernel launches so far, by kernel name (see module docstring)
LAUNCHES = {"seg_sum64": 0, "q1_grouped_sums": 0, "grouped_sum_limbs": 0,
            "like_match": 0, "substr_keys": 0, "join_probe": 0,
            "compact_rows": 0}

#: longest LIKE program like_match takes (csrc/like_match.cu kMaxOps)
LIKE_MAX_OPS = 1024

#: keys and carried columns one join_probe launch takes
#: (csrc/join_probe.cu kMaxKeys, kMaxCols); more keys are packed in torch
#: first, more columns take further launches over the same rows
JOIN_MAX_KEYS = 4
JOIN_MAX_COLS = 8

#: columns one compact_rows call moves (csrc/compact_rows.cu kMaxCols);
#: more take further calls over the same row indices
COMPACT_MAX_COLS = 8

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
    "like_match_launch": [_P, _P, _I, _P, _I, _I, _P, _I, _I, _P],
    "substr_keys_launch": [_P, _P, _I, _I, _I, _I, _P, _I, _I, _P],
    "join_probe_launch": [_P, _I, _I, _P],
    "compact_rows_launch": [_P, _P],
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


# ---------------------------------------------------------------------------
# like_match and substr_keys: maps over a string dictionary's byte heap
# ---------------------------------------------------------------------------

#: the two wildcard ops of a LIKE program (ops 0-255 match that byte;
#: csrc/like_match.cu kOne, kAny)
LIKE_ONE, LIKE_ANY = 256, 257

#: one UTF-8 code point (a LIKE program's ``_``) as a bytes regex
_CODE_POINT = (rb"(?:[\x00-\x7f]|[\x80-\xdf][\x80-\xbf]|"
               rb"[\xe0-\xef][\x80-\xbf]{2}|[\xf0-\xff][\x80-\xbf]{3})")
_I32_MAX = (1 << 31) - 1


def _heap_values(data: torch.Tensor, offsets: torch.Tensor) -> list:
    raw = data.cpu().numpy().tobytes()
    offs = offsets.cpu().tolist()
    return [raw[a:b] for a, b in zip(offs, offs[1:])]


def _check_heap(name: str, data: torch.Tensor,
                offsets: torch.Tensor) -> torch.device:
    """``data`` uint8 and ``offsets`` int32 (at least one), both 1-D,
    contiguous and on one CUDA device; the offsets themselves are a
    StrHeap's and are not read here (that would wait for the device)."""
    dev = data.device
    if dev.type != "cuda" or offsets.device != dev:
        raise ValueError(f"{name}: data on {dev}, offsets on "
                         f"{offsets.device}; both must be on one CUDA device")
    if data.dtype != torch.uint8 or offsets.dtype != torch.int32:
        raise TypeError(f"{name}: data must be torch.uint8 and offsets "
                        f"torch.int32, not {data.dtype} / {offsets.dtype}")
    if data.dim() != 1 or offsets.dim() != 1 or offsets.numel() < 1:
        raise ValueError(f"{name}: data and offsets must be 1-D, offsets "
                         f"with n + 1 entries")
    if not (data.is_contiguous() and offsets.is_contiguous()):
        raise ValueError(f"{name}: data and offsets must be contiguous")
    return dev


def _value_grid(dev: torch.device, n: int) -> int:
    """Blocks of a one-thread-a-value kernel: enough for every value, at
    most 16 of them an SM (a grid-stride loop does the rest)."""
    return max(1, min(-(-n // _THREADS), _sms(dev) * 16))


def like_match_plain(data, offsets, program, *, caseless: bool = False,
                     dollar_nl: bool = False, negate: bool = False):
    """Plain like_match: the program as a bytes regex (``%`` any bytes,
    ``_`` one UTF-8 code point; IGNORECASE on bytes folds ASCII alone),
    matched in full against each value, and with ``dollar_nl`` also
    against a value less its final ``\\n``."""
    parts = []
    for op in np.asarray(program).tolist():
        parts.append(b".*" if op == LIKE_ANY else _CODE_POINT
                     if op == LIKE_ONE else re.escape(bytes([op])))
    rx = re.compile(b"".join(parts),
                    re.DOTALL | (re.IGNORECASE if caseless else 0))
    out = []
    for v in _heap_values(data, offsets):
        m = rx.fullmatch(v) is not None
        if not m and dollar_nl and v.endswith(b"\n"):
            m = rx.fullmatch(v[:-1]) is not None
        out.append(m != negate)
    return torch.tensor(out, dtype=torch.bool, device=data.device)


def like_match(data, offsets, program, *, caseless: bool = False,
               dollar_nl: bool = False, negate: bool = False):
    """One bool a value of a byte heap (value i = ``data[offsets[i]:
    offsets[i + 1]]``) under a LIKE ``program`` (int16 ops, at most
    LIKE_MAX_OPS): ``caseless`` folds the values' ASCII upper case,
    ``dollar_nl`` also matches a value less its final ``\\n`` (the host
    regex's ``$``), ``negate`` inverts.  Returns bool[n]."""
    if _on_cpu(data, offsets):
        return like_match_plain(data, offsets, program, caseless=caseless,
                                dollar_nl=dollar_nl, negate=negate)
    dev = _check_heap("like_match", data, offsets)
    prog = np.ascontiguousarray(program, dtype=np.int16)
    if prog.ndim != 1 or len(prog) > LIKE_MAX_OPS:
        raise ValueError(f"like_match: program of {prog.shape} ops; at most "
                         f"{LIKE_MAX_OPS}, 1-D")
    fn = build()["like_match_launch"]
    n = offsets.numel() - 1
    out = torch.empty(n, dtype=torch.bool, device=dev)
    flags = int(caseless) | int(dollar_nl) << 1 | int(negate) << 2
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _launched("like_match", fn(
            data.data_ptr(), offsets.data_ptr(), n, prog.ctypes.data,
            len(prog), flags, out.data_ptr(), _value_grid(dev, n), _THREADS,
            stream))
    return out


def _pack_key(b: bytes) -> int:
    """Up to 8 bytes big-endian, zero-padded, top bit flipped, as int64."""
    k = int.from_bytes(b[:8].ljust(8, b"\0"), "big") ^ (1 << 63)
    return k - (1 << 64) if k >= 1 << 63 else k


def substr_keys_plain(data, offsets, *, start: int, count: int,
                      right: bool = False):
    """Plain substr_keys: each value decoded, sliced as a Python str and
    packed by ``_pack_key``."""
    out = []
    for v in _heap_values(data, offsets):
        s = v.decode("utf-8", "surrogatepass")
        if right:
            r = s[max(len(s) - count, 0):] if count else ""
        else:
            r = s[start:] if count < 0 else s[start:start + count]
        out.append(_pack_key(r.encode("utf-8", "surrogatepass")))
    return torch.tensor(out, dtype=torch.int64, device=data.device)


def substr_keys(data, offsets, *, start: int, count: int,
                right: bool = False):
    """Each value of a byte heap cut to its code points ``[start, start +
    count)`` (``count`` -1: to the end), or with ``right`` to its last
    ``count``, as an int64 key: the result's bytes big-endian, zero-padded,
    top bit flipped, so that int64 order is the results' byte order (and
    Python's str order).  Results longer than 8 bytes are cut to 8: the
    caller routes those to the host.  Returns int64[n]."""
    if _on_cpu(data, offsets):
        return substr_keys_plain(data, offsets, start=start, count=count,
                                 right=right)
    dev = _check_heap("substr_keys", data, offsets)
    if not (0 <= start <= _I32_MAX and (0 if right else -1) <= count
            <= _I32_MAX):
        raise ValueError(f"substr_keys: start {start}, count {count} out "
                         f"of range")
    fn = build()["substr_keys_launch"]
    n = offsets.numel() - 1
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _launched("substr_keys", fn(
            data.data_ptr(), offsets.data_ptr(), n, start, count, int(right),
            keys.data_ptr(), _value_grid(dev, n), _THREADS, stream))
    return keys


# ---------------------------------------------------------------------------
# join_probe: the dense equi-join's probe side
# ---------------------------------------------------------------------------

#: what join_probe returns as its mask -> csrc/join_probe.cu Mode
_PROBE_MODES = {"semi": 0, "anti": 1, "matched": 2}
_KEY_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)
#: a carried column's dtype -> its nil as the unsigned bits of its width
#: (NaN: the quiet NaN that torch.where writes for float("nan"))
_NIL_BITS = {dt: int(np.array(nil_const(dt), npdt(dt)).view(
    f"u{npdt(dt).itemsize}")) for dt in _KEY_DTYPES + (
        torch.bool, torch.float32, torch.float64)}


class _ProbeKey(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("lo", ctypes.c_longlong),
                ("span", ctypes.c_longlong), ("width", ctypes.c_int),
                ("nil", ctypes.c_int)]


class _ProbeCol(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("nil_bits", ctypes.c_ulonglong), ("width", ctypes.c_int),
                ("unused", ctypes.c_int)]


class _ProbeArgs(ctypes.Structure):
    """csrc/join_probe.cu ``Args``, field for field."""
    _fields_ = [("keys", _ProbeKey * JOIN_MAX_KEYS),
                ("cols", _ProbeCol * JOIN_MAX_COLS),
                ("slots", ctypes.c_void_p), ("count", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("nkeys", ctypes.c_int),
                ("ncols", ctypes.c_int), ("rcap", ctypes.c_int),
                ("mode", ctypes.c_int)]


def join_probe_plain(keys, specs, slots, rcap: int, count, mask, cols, *,
                     cap: int, want):
    """Plain join_probe: the interpreter's torch chain (live rows, each
    key's nil and range checks, the mixed-radix pack, the slot gather and
    ``gather_nil`` per carried column)."""
    live = torch.arange(cap, device=slots.device) < count
    if mask is not None:
        live = live & mask
    comb = None
    valid = live
    for k, (nil, lo, span, is_str) in zip(keys, specs):
        k = k.expand(cap) if k.dim() == 0 else k
        if nil and not is_str:
            valid = valid & ~nilm(k)
        k = k.to(torch.int64)
        c = k - lo
        valid = valid & (c >= 0) & (c < span)
        comb = c if comb is None else comb * span + c
    hit = slots[torch.where(valid, comb, 0)]
    matched = valid & (hit < rcap)
    rowid = torch.where(matched, hit, -1).long()
    ok = rowid >= 0
    out = [gather_nil(c, rowid, ok) for c in cols]
    if want is None or want == "matched":
        return (matched if want else None), out
    m = matched if want == "semi" else ~matched
    return (m if mask is None else (mask & m)), out


def _fold_keys(keys, specs):
    """At most JOIN_MAX_KEYS keys: the first ones packed into one int64
    key (span: the product of theirs), -1 where any of them is invalid,
    so that validity and the packed code stay the same."""
    k = len(keys) - JOIN_MAX_KEYS + 1
    if k <= 1:
        return list(keys), list(specs)
    comb, valid, width = None, None, 1
    for key, (nil, lo, span, is_str) in zip(keys[:k], specs[:k]):
        ok = ~nilm(key) if nil and not is_str else torch.ones_like(
            key, dtype=torch.bool)
        c = key.to(torch.int64) - lo
        ok = ok & (c >= 0) & (c < span)
        valid = ok if valid is None else valid & ok
        comb = c if comb is None else comb * span + c
        width *= span
    return ([torch.where(valid, comb, -1)] + list(keys[k:]),
            [(False, 0, width, False)] + list(specs[k:]))


def _check_probe(keys, slots, count, mask, cols, cap: int, rcap: int):
    dev = slots.device
    if dev.type != "cuda":
        raise ValueError(f"join_probe: slots on {dev}, not a CUDA device")
    if slots.dtype != torch.int32 or slots.dim() != 1 or \
            not slots.is_contiguous():
        raise TypeError(f"join_probe: slots must be contiguous 1-D "
                        f"torch.int32, not {slots.dtype} {tuple(slots.shape)}")
    if not 0 <= rcap <= _I32_MAX:
        raise ValueError(f"join_probe: rcap {rcap} outside int32")
    named = [("count", count)] + [(f"keys[{i}]", k)
                                  for i, k in enumerate(keys)]
    named += [("mask", mask)] if mask is not None else []
    named += [(f"cols[{i}]", c) for i, c in enumerate(cols)]
    for arg, t in named:
        if t.device != dev:
            raise ValueError(f"join_probe: {arg} on {t.device}, slots on "
                             f"{dev}; all must be on one CUDA device")
        if arg == "count":
            if t.dim() != 0 or t.dtype != torch.int64:
                raise ValueError(f"join_probe: count must be a 0-d "
                                 f"torch.int64, not {t.dtype} "
                                 f"{tuple(t.shape)}")
            continue
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"join_probe: {arg} must be contiguous 1-D")
        if arg.startswith("cols"):
            if t.dtype not in _NIL_BITS:
                raise TypeError(f"join_probe: {arg} of {t.dtype}")
            continue
        if t.shape[0] != cap:
            raise ValueError(f"join_probe: {arg} has {t.shape[0]} rows, "
                             f"not {cap}")
        ok = (torch.bool,) if arg == "mask" else _KEY_DTYPES
        if t.dtype not in ok:
            raise TypeError(f"join_probe: {arg} must be "
                            f"{' or '.join(map(str, ok))}, not {t.dtype}")


def join_probe(keys, specs, slots, rcap: int, count, mask, cols, *,
               cap: int, want):
    """The probe side of a dense equi-join over ``cap`` probe rows.

    ``keys``: the probe side's key columns (1-D of ``cap`` rows; a CPU
    tensor may be 0-d), with ``specs`` one ``(nil, lo, span, is_str)`` a
    key: a key is valid when live, not nil (``nil``: the dtype's sentinel;
    a string code's nil is negative and fails the range) and ``0 <= key -
    lo < span``; the valid keys pack into ``comb`` in [0, the product of
    the spans).  ``slots`` (int32) holds the build side's row id of each
    ``comb``, ``rcap`` where it has none.  Rows ``>= count`` (0-d int64)
    and where ``mask`` (bool, or None) is False are dead.

    Returns ``(mask, columns)``: the mask is ``mask & matched`` for
    ``want`` "semi", ``mask & ~matched`` for "anti" (without a mask:
    ``matched`` / ``~matched``), ``matched`` itself for "matched" and None
    for None; ``columns[j]`` is ``cols[j][row id]`` on matched rows and
    nil elsewhere.  On CPU tensors this is ``join_probe_plain``; on CUDA
    tensors the kernel (csrc/join_probe.cu), which reads each key at its
    own width."""
    if _on_cpu(slots, *keys, *cols, *([] if mask is None else [mask])):
        return join_probe_plain(keys, specs, slots, rcap, count, mask, cols,
                                cap=cap, want=want)
    if want is not None and want not in _PROBE_MODES:
        raise ValueError(f"join_probe: want {want!r}")
    if not keys or len(keys) != len(specs):
        raise ValueError("join_probe: one spec a key, at least one key")
    keys = [k.view(torch.int8) if k.dtype == torch.bool else k
            for k in keys]
    _check_probe(keys, slots, count, mask, cols, cap, rcap)
    keys, specs = _fold_keys(keys, specs)
    dev = slots.device
    out = None if want is None else torch.empty(cap, dtype=torch.bool,
                                                device=dev)
    got = [torch.empty(cap, dtype=c.dtype, device=dev) for c in cols]
    args = _ProbeArgs(slots=slots.data_ptr(), count=count.data_ptr(),
                      mask=None if mask is None else mask.data_ptr(),
                      n=cap, nkeys=len(keys), rcap=rcap,
                      mode=_PROBE_MODES.get(want, 0))
    for i, (k, (nil, lo, span, is_str)) in enumerate(zip(keys, specs)):
        args.keys[i] = _ProbeKey(k.data_ptr(), lo, span, k.element_size(),
                                 int(nil and not is_str))
    fn = build()["join_probe_launch"]
    # 8 rows a thread a step (csrc/join_probe.cu kRows)
    blocks = max(1, min(-(-cap // (8 * _THREADS)),
                        _sms(dev) * _BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(dev).cuda_stream
    # one launch a group of JOIN_MAX_COLS columns; the first writes the mask
    for start in range(0, max(len(cols), 1), JOIN_MAX_COLS):
        part = list(zip(cols, got))[start:start + JOIN_MAX_COLS]
        args.out = out.data_ptr() if out is not None and start == 0 \
            else None
        args.ncols = len(part)
        for j, (src, dst) in enumerate(part):
            args.cols[j] = _ProbeCol(src.data_ptr(), dst.data_ptr(),
                                     _NIL_BITS[src.dtype],
                                     src.element_size(), 0)
        with torch.cuda.device(dev):
            _launched("join_probe", fn(ctypes.addressof(args), blocks,
                                       _THREADS, stream))
    return out, got


# ---------------------------------------------------------------------------
# compact_rows: the compaction barrier
# ---------------------------------------------------------------------------

#: rows a tile of csrc/compact_rows.cu (kTile): one int64 of scratch each
_COMPACT_TILE = 8192


class _CompactCol(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("stride", ctypes.c_longlong),
                ("nil_bits", ctypes.c_ulonglong), ("width", ctypes.c_int),
                ("unused", ctypes.c_int)]


class _CompactArgs(ctypes.Structure):
    """csrc/compact_rows.cu ``Args``, field for field."""
    _fields_ = [("cols", _CompactCol * COMPACT_MAX_COLS),
                ("count", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("tiles", ctypes.c_void_p), ("oids", ctypes.c_void_p),
                ("nlive", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("out_cap", ctypes.c_longlong),
                ("ncols", ctypes.c_int), ("scan", ctypes.c_int)]


def compact_rows_plain(count, mask, cols, *, cap: int, out_cap: int):
    """Plain compact_rows: the interpreter's torch chain (live rows, their
    int64 ranks by cumsum, one rank-indexed scatter-set of the row ids,
    ranks past out_cap dropped, then ``gather_nil`` per column)."""
    dev = (mask if mask is not None else count if count is not None
           else cols[0]).device
    live = torch.ones(cap, dtype=torch.bool, device=dev) if count is None \
        else torch.arange(cap, device=dev) < count
    if mask is not None:
        live = live & mask
    if not cap:                 # no row to gather from: nils alone
        return torch.zeros((), dtype=torch.int64, device=dev), [
            torch.full((out_cap,), nil_const(c.dtype), dtype=c.dtype,
                       device=dev) for c in cols]
    csum = torch.cumsum(live.to(torch.int64), 0)
    nlive = csum[-1]
    pos = torch.where(live, csum - 1, out_cap)
    oids = set_drop(out_cap, -1, pos,
                    torch.arange(cap, dtype=torch.int64, device=dev))
    live_out = torch.arange(out_cap, device=dev) < nlive
    return nlive, [gather_nil(c, oids, live_out) for c in cols]


def _check_compact(count, mask, cols, cap: int, out_cap: int):
    """Types and shapes, on every device: a 0-d int64 count or None, a
    contiguous bool mask of cap rows or None, 1-D columns of cap rows of a
    dtype that has a nil."""
    if cap < 0 or out_cap < 0:
        raise ValueError(f"compact_rows: cap {cap}, out_cap {out_cap}")
    if count is not None and (count.dim() != 0 or
                              count.dtype != torch.int64):
        raise ValueError(f"compact_rows: count must be a 0-d torch.int64, "
                         f"not {count.dtype} {tuple(count.shape)}")
    if mask is not None:
        if mask.dtype != torch.bool:
            raise TypeError(f"compact_rows: mask must be torch.bool, not "
                            f"{mask.dtype}")
        if mask.dim() != 1 or mask.shape[0] != cap or \
                not mask.is_contiguous():
            raise ValueError(f"compact_rows: mask {tuple(mask.shape)} must "
                             f"be contiguous 1-D of {cap} rows")
    for j, c in enumerate(cols):
        if c.dtype not in _NIL_BITS:
            raise TypeError(f"compact_rows: cols[{j}] of {c.dtype}")
        if c.dim() != 1 or c.shape[0] != cap:
            raise ValueError(f"compact_rows: cols[{j}] "
                             f"{tuple(c.shape)} must be 1-D of {cap} rows")


def compact_rows(count, mask, cols, *, cap: int, out_cap: int):
    """The compaction barrier over ``cap`` rows.

    A row ``i`` is live when ``i < count`` (a 0-d int64; None: every row)
    and ``mask[i]`` (bool, or None).  Returns ``(nlive, columns)``:
    ``nlive``, a 0-d int64, counts every live row, those ranked at or past
    ``out_cap`` too; ``columns[j]`` has ``out_cap`` rows, row ``r`` the
    value of ``cols[j]``'s (r+1)-th live row, bit for bit, and the dtype's
    nil from ``nlive`` on.  A column may be a view with any stride (an
    expanded scalar: stride 0).  On CPU tensors this is
    ``compact_rows_plain``; on CUDA tensors the kernel
    (csrc/compact_rows.cu), one call a group of COMPACT_MAX_COLS columns
    (at least one), over at most 2^31 - 1 rows."""
    _check_compact(count, mask, cols, cap, out_cap)
    given = [t for t in (count, mask) if t is not None] + list(cols)
    if not given:
        raise ValueError("compact_rows: no count, mask or column")
    if _on_cpu(*given):
        return compact_rows_plain(count, mask, cols, cap=cap,
                                  out_cap=out_cap)
    dev = given[0].device
    for t in given:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"compact_rows: a tensor on {t.device}, "
                             f"another on {dev}; all must be on one CUDA "
                             f"device")
    if cap > _I32_MAX:
        raise ValueError(f"compact_rows: cap {cap} past int32 row indices")
    nlive = torch.empty((), dtype=torch.int64, device=dev)
    got = [torch.empty(out_cap, dtype=c.dtype, device=dev) for c in cols]
    tiles = torch.empty(max(-(-cap // _COMPACT_TILE), 1),
                        dtype=torch.int64, device=dev)
    oids = torch.empty(out_cap if cols else 0, dtype=torch.int32,
                       device=dev)
    args = _CompactArgs(
        count=None if count is None else count.data_ptr(),
        mask=None if mask is None else mask.data_ptr(),
        tiles=tiles.data_ptr(), oids=oids.data_ptr(),
        nlive=nlive.data_ptr(), n=cap, out_cap=out_cap)
    fn = build()["compact_rows_launch"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the first call ranks the rows and writes nlive; the others reuse them
    for start in range(0, max(len(cols), 1), COMPACT_MAX_COLS):
        part = list(zip(cols, got))[start:start + COMPACT_MAX_COLS]
        args.scan = int(start == 0)
        args.ncols = len(part)
        for j, (src, dst) in enumerate(part):
            args.cols[j] = _CompactCol(src.data_ptr(), dst.data_ptr(),
                                       src.stride(0), _NIL_BITS[src.dtype],
                                       src.element_size(), 0)
        with torch.cuda.device(dev):
            _launched("compact_rows", fn(ctypes.addressof(args), stream))
    return nlive, got
