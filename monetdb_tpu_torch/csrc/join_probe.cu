// join_probe: the probe side of the fragment interpreter's dense equi-join
// (exec/fragment.py _Interp.r_join, strategy "dense") in one pass.
// Replaces no TPU kernel: the reference package leaves this probe to XLA,
// which fuses its elementwise chain into one loop.  The port ran it as
// about 30 eager torch ops over the probe side's whole capacity (2^27 slots
// for SSB's lineorder), each writing a full-capacity temporary, mostly
// int64: about 150 bytes of device traffic a probe row plus 55 a carried
// column, three quarters of a star-join query's device time.
//
// What it computes, for each probe row i < n (ops/cuda_kernels.py
// join_probe_plain is the same function in torch):
//   live    = i < *count and (no mask or mask[i])
//   valid   = live and, for every key k: not (k.nil and key == the minimum
//             of its width), 0 <= c_k < span_k where c_k = key - lo_k
//   comb    = mixed-radix pack of the c_k (comb * span_k + c_k, int64)
//   hit     = slots[comb] (the build side's lowest row id of that key, or
//             rcap where it has none); matched = valid and hit < rcap
//   out[i]  = matched (modes semi and matched), or (mask[i] or 1) and not
//             matched (mode anti); not written when out is null
//   dst_j[i] = matched ? src_j[hit] : column j's nil bit pattern
// Keys are read at their stored width (1, 2, 4 or 8 bytes, signed);
// columns are copied by byte width, so every dtype goes through.
//
// Bound: memory.  A row reads its keys at their width and one mask byte,
// and writes one mask byte and each carried column's width: 10-14 bytes a
// row for SSB's joins (an int32 key, the mask, one or two int32 columns).
// The slot table (at most a few MB for SSB's dimensions) and the build
// columns are read at random, one 32-byte L2 sector a lookup and a gathered
// value; they stay in the 50 MB L2, but with a row in three or more valid
// the kernel takes 2-4 times the streamed bytes' time on an H100: those
// random sectors, not the streamed bytes, set its pace.  Design:
//   * no intermediate leaves registers: liveness, key checks, packing, the
//     lookup and the column gathers happen in one thread for its rows;
//   * a warp takes 32 x kRows consecutive rows a step of a grid-stride
//     loop, in groups of 128 of which each lane takes 4 consecutive rows,
//     so that every load and store instruction of the warp covers 128 x
//     width contiguous bytes; the streamed arrays (keys, mask, outputs)
//     are loaded and stored evict-first, so that the slot table and the
//     build columns, read through the read-only path, keep their place in
//     L2;
//   * a lane's kRows lookups, and its kRows gathers a column, are
//     independent loads in flight together; kRows = 8 keeps a lane at 62
//     registers (16 rows took 88, and ran slower at SSB's shapes);
//   * no atomics and no shared memory; a ragged tail and unaligned arrays
//     take scalar loads and stores.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxKeys = 4;    // ops/cuda_kernels.py JOIN_MAX_KEYS
constexpr int kMaxCols = 8;    // ops/cuda_kernels.py JOIN_MAX_COLS
constexpr int kRows = 8;       // rows a lane takes a step

enum Mode { kSemi = 0, kAnti = 1, kMatched = 2 };

struct Key {
  const void* data;
  long long lo;
  long long span;
  int width;    // bytes of a signed integer: 1, 2, 4 or 8
  int nil;      // 1: the width's minimum is nil, and no match
};

struct Col {
  const void* src;
  void* dst;
  unsigned long long nil_bits;
  int width;    // bytes: 1, 2, 4 or 8
  int unused;
};

// ops/cuda_kernels.py _ProbeArgs mirrors this layout
struct Args {
  Key keys[kMaxKeys];
  Col cols[kMaxCols];
  const int* slots;
  const long long* count;
  const unsigned char* mask;    // null: every row below count is live
  unsigned char* out;           // null: no mask is written
  long long n;
  int nkeys;
  int ncols;
  int rcap;
  int mode;
};

// A warp takes kChunk = 32 x kRows consecutive rows a step: kGroups groups
// of 128, and in each group every lane 4 consecutive rows, so that each
// load and store instruction of the warp covers 128 x width contiguous
// bytes.  Lane l's row r is row0 + (r / 4) * 128 + 4 l + r % 4.
constexpr int kGroups = kRows / 4;
constexpr int kChunk = 32 * kRows;

__device__ __forceinline__ long long row_of(long long row0, int lane,
                                            int r) {
  return row0 + (r / 4) * 128 + 4 * lane + r % 4;
}

// the 4 rows of group g, sign-extended: one load of 4 x sizeof(T) bytes
// (two for 8-byte values)
template <typename T>
__device__ __forceinline__ void load_group(const T* p,
                                           long long (&v)[kRows], int g) {
  if constexpr (sizeof(T) == 1) {
    const unsigned w = __ldcs(reinterpret_cast<const unsigned*>(p));
#pragma unroll
    for (int e = 0; e < 4; ++e) v[4 * g + e] = (signed char)(w >> (8 * e));
  } else if constexpr (sizeof(T) == 2) {
    const uint2 w = __ldcs(reinterpret_cast<const uint2*>(p));
    v[4 * g] = (short)(w.x & 0xFFFFu);
    v[4 * g + 1] = (short)(w.x >> 16);
    v[4 * g + 2] = (short)(w.y & 0xFFFFu);
    v[4 * g + 3] = (short)(w.y >> 16);
  } else if constexpr (sizeof(T) == 4) {
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(p));
    v[4 * g] = (int)w.x;
    v[4 * g + 1] = (int)w.y;
    v[4 * g + 2] = (int)w.z;
    v[4 * g + 3] = (int)w.w;
  } else {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldcs(reinterpret_cast<const uint4*>(p) + 1);
    v[4 * g] = (long long)((unsigned long long)a.y << 32 | a.x);
    v[4 * g + 1] = (long long)((unsigned long long)a.w << 32 | a.z);
    v[4 * g + 2] = (long long)((unsigned long long)b.y << 32 | b.x);
    v[4 * g + 3] = (long long)((unsigned long long)b.w << 32 | b.z);
  }
}

// the keys of this lane's rows (a row past n reads 0)
template <typename T>
__device__ __forceinline__ void load_rows(const void* data, long long row0,
                                          int lane, long long n, bool full,
                                          long long (&v)[kRows]) {
  const T* p = static_cast<const T*>(data);
  if (full) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      load_group<T>(p + row0 + g * 128 + 4 * lane, v, g);
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = row_of(row0, lane, r);
      v[r] = i < n ? p[i] : 0;
    }
  }
}

__device__ __forceinline__ void load_key(const Key& k, long long row0,
                                         int lane, long long n, bool full,
                                         long long (&v)[kRows]) {
  switch (k.width) {
    case 1: load_rows<signed char>(k.data, row0, lane, n, full, v); break;
    case 2: load_rows<short>(k.data, row0, lane, n, full, v); break;
    case 4: load_rows<int>(k.data, row0, lane, n, full, v); break;
    default: load_rows<long long>(k.data, row0, lane, n, full, v); break;
  }
}

// 4 values of type T to p as one store of 4 x sizeof(T) bytes (two for
// 8-byte values)
template <typename T>
__device__ __forceinline__ void store_group(T* p, const T (&t)[kRows],
                                            int g) {
  const T* q = t + 4 * g;
  if constexpr (sizeof(T) == 1) {
    __stcs(reinterpret_cast<unsigned*>(p),
           (unsigned)q[0] | (unsigned)q[1] << 8 | (unsigned)q[2] << 16 |
               (unsigned)q[3] << 24);
  } else if constexpr (sizeof(T) == 2) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2((unsigned)q[0] | (unsigned)q[1] << 16,
                      (unsigned)q[2] | (unsigned)q[3] << 16));
  } else if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(q[0], q[1], q[2], q[3]));
  } else {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4((unsigned)q[0], (unsigned)(q[0] >> 32), (unsigned)q[1],
                      (unsigned)(q[1] >> 32)));
    __stcs(reinterpret_cast<uint4*>(p) + 1,
           make_uint4((unsigned)q[2], (unsigned)(q[2] >> 32), (unsigned)q[3],
                      (unsigned)(q[3] >> 32)));
  }
}

// dst[row] = matched bit r ? src[hit[r]] : nil, for this lane's rows
template <typename T>
__device__ __forceinline__ void gather_rows(const Col& c, long long row0,
                                            int lane, long long n, bool full,
                                            unsigned matched,
                                            const int (&hit)[kRows]) {
  const T* src = static_cast<const T*>(c.src);
  T* dst = static_cast<T*>(c.dst);
  const T nil = static_cast<T>(c.nil_bits);
  T t[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    t[r] = (matched >> r & 1u) ? __ldg(src + hit[r]) : nil;
  if (full) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      store_group<T>(dst + row0 + g * 128 + 4 * lane, t, g);
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = row_of(row0, lane, r);
      if (i < n) dst[i] = t[r];
    }
  }
}

__global__ void __launch_bounds__(256)
    join_probe_kernel(const __grid_constant__ Args a, bool vec) {
  const int lane = threadIdx.x % 32;
  const long long chunks = (a.n + kChunk - 1) / kChunk;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  const long long count = __ldg(a.count);
  for (long long chunk = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                         / 32;
       chunk < chunks; chunk += warps) {
    const long long row0 = chunk * kChunk;
    const bool full = vec && row0 + kChunk <= a.n;

    // the probe side's mask bits (all set without a mask), then liveness
    unsigned mbits = (1u << kRows) - 1u;
    if (a.mask != nullptr) {
      mbits = 0u;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const long long i = row0 + g * 128 + 4 * lane;
        unsigned w = 0u;
        if (full) {
          w = __ldcs(reinterpret_cast<const unsigned*>(a.mask + i));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (i + e < a.n) w |= (unsigned)a.mask[i + e] << (8 * e);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mbits |= (w >> (8 * e) & 0xFFu ? 1u : 0u) << (4 * g + e);
      }
    }
    unsigned valid = 0u;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = row_of(row0, lane, r);
      if (i < a.n && i < count) valid |= 1u << r;
    }
    valid &= mbits;

    // keys: validity and the packed code
    unsigned long long comb[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) comb[r] = 0ull;
    for (int k = 0; k < a.nkeys; ++k) {
      const Key& key = a.keys[k];
      long long v[kRows];
      load_key(key, row0, lane, a.n, full, v);
      const long long nil =
          key.width == 8 ? (long long)(1ull << 63)
                         : -(1ll << (8 * key.width - 1));
      const unsigned long long lo = (unsigned long long)key.lo;
      const unsigned long long span = (unsigned long long)key.span;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // torch's int64 arithmetic wraps; so does this, unsigned
        const long long c = (long long)((unsigned long long)v[r] - lo);
        if (c < 0 || c >= key.span || (key.nil && v[r] == nil))
          valid &= ~(1u << r);
        comb[r] = comb[r] * span + (unsigned long long)c;
      }
    }

    // the lookup: a valid row's code lies in [0, domain)
    int hit[kRows];
    unsigned matched = 0u;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      hit[r] = 0;
      if (valid >> r & 1u) {
        hit[r] = __ldg(a.slots + comb[r]);
        if (hit[r] < a.rcap) matched |= 1u << r;
      }
    }

    if (a.out != nullptr) {
      const unsigned bits = a.mode == kAnti ? (mbits & ~matched) : matched;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const long long i = row0 + g * 128 + 4 * lane;
        const unsigned b = bits >> (4 * g);
        if (full) {
          __stcs(reinterpret_cast<unsigned*>(a.out + i),
                 (b & 1u) | (b >> 1 & 1u) << 8 | (b >> 2 & 1u) << 16 |
                     (b >> 3 & 1u) << 24);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (i + e < a.n) a.out[i + e] = b >> e & 1u;
        }
      }
    }

    for (int j = 0; j < a.ncols; ++j) {
      const Col& c = a.cols[j];
      switch (c.width) {
        case 1:
          gather_rows<unsigned char>(c, row0, lane, a.n, full, matched, hit);
          break;
        case 2:
          gather_rows<unsigned short>(c, row0, lane, a.n, full, matched,
                                      hit);
          break;
        case 4:
          gather_rows<unsigned int>(c, row0, lane, a.n, full, matched, hit);
          break;
        default:
          gather_rows<unsigned long long>(c, row0, lane, a.n, full, matched,
                                          hit);
          break;
      }
    }
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// Launches on `stream`; does not synchronise.  `args` is copied into the
// launch.  threads must be a multiple of 32, at most 256.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int join_probe_launch(const void* args, int blocks, int threads,
                                 void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.n < 0 || a.nkeys < 1 || a.nkeys > kMaxKeys || a.ncols < 0 ||
      a.ncols > kMaxCols || a.rcap < 0 || a.mode < kSemi ||
      a.mode > kMatched || blocks < 1 || threads < 32 || threads > 256 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  bool vec = (a.mask == nullptr || aligned16(a.mask)) &&
             (a.out == nullptr || aligned16(a.out));
  for (int k = 0; k < a.nkeys; ++k) {
    const int w = a.keys[k].width;
    if (w != 1 && w != 2 && w != 4 && w != 8)
      return (int)cudaErrorInvalidValue;
    vec = vec && aligned16(a.keys[k].data);
  }
  for (int j = 0; j < a.ncols; ++j) {
    const int w = a.cols[j].width;
    if (w != 1 && w != 2 && w != 4 && w != 8)
      return (int)cudaErrorInvalidValue;
    vec = vec && aligned16(a.cols[j].dst);
  }
  join_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a, vec);
  return (int)cudaGetLastError();
}
