// compact_rows: the fragment interpreter's compaction barrier
// (exec/fragment.py _Interp.r_compact, _root_compact, _finish_mask) in four
// launches.  Replaces no TPU kernel: the reference package leaves the
// barrier to XLA, which fuses its chain.  The port ran it as about 12
// eager torch ops over the input's whole capacity (2^27 slots for SSB's
// lineorder): two int64 aranges, an int64 cumsum, a where and a
// rank-indexed scatter, each a 1 GiB temporary, about 20 GiB of device
// traffic a compaction, then 4 more ops a carried column.
//
// What it computes (ops/cuda_kernels.py compact_rows_plain is the same
// function in torch), over rows i < n:
//   live(i)  = i < *count (every row without a count) and (no mask or
//              mask[i])
//   *nlive   = the number of live rows, those ranked past out_cap included
//              (the caller's count-retry channel reads it)
//   dst_j[r] = src_j[the (r+1)-th live row] for r < min(*nlive, out_cap),
//              column j's nil bit pattern for *nlive <= r < out_cap
// Columns are copied by byte width, so every dtype goes through bit for
// bit; a source is read with an element stride (0: one value for every
// row).
//
// Bound: memory.  The least it can do is read the 1-byte mask up to the
// count, read the 32-byte sectors of the columns that hold a live row,
// and write the outputs: about 0.25 ms at SSB's shape (2^27 slots, 3 % of
// them live, six columns of 1-8 bytes) on an H100.  Each step waits on a
// load before the next, so what paces it is how many loads are in flight
// on an SM, not the instruction count.  Design:
//   * a tile is 8192 consecutive rows, one block of 256 threads; a thread
//     takes 32 consecutive rows and reads their mask bytes as two 16-byte
//     loads (a warp: 1 KB contiguous), the liveness one bit a row in a
//     register; no index array;
//   * count_tiles writes each tile's live count; scan_tiles, one block,
//     turns the counts into each tile's offset in place and writes
//     *nlive;
//   * rank_tiles reads the mask again (0.04 ms at 2^27 slots, against the
//     scratch and flags of a single-pass scan), ranks the tile's live rows
//     (a warp scan of the threads' bit counts, then the warps' totals) and
//     writes each kept row's index at its rank: an int32 of scratch a
//     row of out_cap;
//   * gather_rows, one output row a thread, loads the row index, then
//     every column's value at it (independent loads, in flight together),
//     and stores them, or the nils from *nlive on: warp-coalesced stores,
//     and reads of the sectors that hold a live row alone.  A first
//     version moved the columns inside the ranking pass: 174 registers a
//     thread, one block an SM, a load round trip a column, and 14x the
//     bound (3.47 ms at the shape above);
//   * no atomics; a ragged end and an unaligned mask take byte loads;
//   * up to kMaxCols columns a call; a caller with more calls again with
//     scan = 0, which reuses the row indices and runs gather_rows alone.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 8;                  // ops/cuda_kernels.py
                                             // COMPACT_MAX_COLS
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                    // consecutive rows a thread
constexpr long long kTile = (long long)kThreads * kRows;  // ops/
                                             // cuda_kernels.py _COMPACT_TILE
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Col {
  const void* src;
  void* dst;
  long long stride;             // source elements from one row to the next
  unsigned long long nil_bits;
  int width;                    // bytes: 1, 2, 4 or 8
  int unused;
};

// ops/cuda_kernels.py _CompactArgs mirrors this layout
struct Args {
  Col cols[kMaxCols];
  const long long* count;       // null: every row below n counts
  const unsigned char* mask;    // null: no mask
  long long* tiles;             // scratch: a tile's live count, then offset
  int* oids;                    // scratch: the row of each rank < out_cap
  long long* nlive;
  long long n;                  // rows; below 2^31
  long long out_cap;
  int ncols;
  int scan;                     // 1: rank the rows before gathering
};

__device__ __forceinline__ long long live_limit(const Args& a) {
  if (a.count == nullptr) return a.n;
  const long long c = __ldg(a.count);
  return c < a.n ? c : a.n;
}

// bit e: byte e of w is not zero
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  w &= 0x01010101u;
  return (w | w >> 7 | w >> 14 | w >> 21) & 0xFu;
}

// bit k: row row0 + k is live
__device__ __forceinline__ unsigned live_bits(const Args& a, long long row0,
                                              long long limit, bool vec) {
  if (row0 >= limit) return 0u;
  if (a.mask == nullptr) {
    const long long k = limit - row0;
    return k >= kRows ? kFull : (1u << k) - 1u;
  }
  unsigned bits = 0u;
  if (vec && row0 + kRows <= limit) {
    const uint4* p = reinterpret_cast<const uint4*>(a.mask + row0);
    const uint4 lo = __ldg(p), hi = __ldg(p + 1);
    const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) bits |= nonzero_bytes(w[q]) << (4 * q);
  } else {
    for (int k = 0; k < kRows && row0 + k < limit; ++k)
      if (a.mask[row0 + k]) bits |= 1u << k;
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
    count_tiles(const __grid_constant__ Args a, bool vec) {
  const long long row0 =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kRows;
  const unsigned c = __reduce_add_sync(
      kFull, (unsigned)__popc(live_bits(a, row0, live_limit(a), vec)));
  __shared__ unsigned warps[kWarps];
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned s = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warps[w];
    a.tiles[blockIdx.x] = s;
  }
}

// inclusive scan of v over the warp's lanes
template <typename T>
__device__ __forceinline__ T warp_scan(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const T u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// one block of kScanThreads: tiles[i] becomes the live rows of the tiles
// before i; *nlive their total.  Thread t takes a run of consecutive
// tiles (16 at 2^27 rows).
__global__ void __launch_bounds__(kScanThreads)
    scan_tiles(long long* tiles, long long ntiles, long long* nlive) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const long long per = (ntiles + kScanThreads - 1) / kScanThreads;
  const long long b = t * per;
  const long long e = b + per < ntiles ? b + per : ntiles;
  long long s = 0;
  for (long long i = b; i < e; ++i) s += tiles[i];
  const long long incl = warp_scan(s, lane);
  __shared__ long long warps[kScanThreads / 32];
  if (lane == 31) warps[warp] = incl;
  __syncthreads();
  if (warp == 0) warps[lane] = warp_scan(warps[lane], lane);
  __syncthreads();
  long long run = (warp ? warps[warp - 1] : 0) + incl - s;
  for (long long i = b; i < e; ++i) {
    const long long c = tiles[i];
    tiles[i] = run;
    run += c;
  }
  if (t == kScanThreads - 1) *nlive = run;
}

// oids[rank] = row for the tile's live rows whose rank is below out_cap
__global__ void __launch_bounds__(kThreads)
    rank_tiles(const __grid_constant__ Args a, bool vec) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const long long base = a.tiles[blockIdx.x];
  const long long row0 = (long long)blockIdx.x * kTile + (long long)t * kRows;
  unsigned bits = live_bits(a, row0, live_limit(a), vec);
  const int c = __popc(bits);
  const int incl = warp_scan(c, lane);
  __shared__ int warps[kWarps];
  if (lane == 31) warps[warp] = incl;
  __syncthreads();
  long long p = base + incl - c;
  for (int w = 0; w < warp; ++w) p += warps[w];
  for (; bits != 0u && p < a.out_cap; ++p) {
    a.oids[p] = (int)row0 + __ffs(bits) - 1;
    bits &= bits - 1u;
  }
}

__device__ __forceinline__ unsigned long long load_bits(const Col& c,
                                                        long long row) {
  const long long i = row * c.stride;
  switch (c.width) {
    case 1: return __ldcs(static_cast<const unsigned char*>(c.src) + i);
    case 2: return __ldcs(static_cast<const unsigned short*>(c.src) + i);
    case 4: return __ldcs(static_cast<const unsigned int*>(c.src) + i);
    default:
      return __ldcs(static_cast<const unsigned long long*>(c.src) + i);
  }
}

__device__ __forceinline__ void store_bits(const Col& c, long long r,
                                           unsigned long long v) {
  switch (c.width) {
    case 1: static_cast<unsigned char*>(c.dst)[r] = (unsigned char)v; break;
    case 2: static_cast<unsigned short*>(c.dst)[r] = (unsigned short)v;
            break;
    case 4: static_cast<unsigned int*>(c.dst)[r] = (unsigned int)v; break;
    default: static_cast<unsigned long long*>(c.dst)[r] = v; break;
  }
}

// output row r of every column: its live row's value, or the nil
__global__ void __launch_bounds__(kThreads)
    gather_rows(const __grid_constant__ Args a) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.out_cap) return;
  const long long nlive = *a.nlive;
  const long long row = a.oids[r];    // read before it is known to count
  unsigned long long v[kMaxCols];
  if (r < nlive) {
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < a.ncols) v[j] = load_bits(a.cols[j], row);
  } else {
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) v[j] = a.cols[j].nil_bits;
  }
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j)
    if (j < a.ncols) store_bits(a.cols[j], r, v[j]);
}

bool launched(cudaError_t* err) {
  *err = cudaGetLastError();
  return *err == cudaSuccess;
}

}  // namespace

// Launches on `stream`; does not synchronise.  `args` is copied into the
// launches.  `tiles` holds one int64 a tile of kTile rows (at least one),
// `oids` out_cap int32.  Returns the cudaError_t of the first launch that
// failed (0 = success).
extern "C" int compact_rows_launch(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.n < 0 || a.n > 0x7FFFFFFFll || a.out_cap < 0 || a.ncols < 0 ||
      a.ncols > kMaxCols || a.tiles == nullptr || a.nlive == nullptr ||
      (a.ncols > 0 && a.out_cap > 0 && a.oids == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < a.ncols; ++j) {
    const int w = a.cols[j].width;
    if ((w != 1 && w != 2 && w != 4 && w != 8) || a.cols[j].stride < 0)
      return (int)cudaErrorInvalidValue;
  }
  const long long ntiles = (a.n + kTile - 1) / kTile;
  const bool vec = a.mask == nullptr || (uintptr_t)a.mask % 16 == 0;
  const bool gather = a.ncols > 0 && a.out_cap > 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (a.scan) {
    if (ntiles > 0) {
      count_tiles<<<(unsigned)ntiles, kThreads, 0, s>>>(a, vec);
      if (!launched(&err)) return (int)err;
    }
    scan_tiles<<<1, kScanThreads, 0, s>>>(a.tiles, ntiles, a.nlive);
    if (!launched(&err)) return (int)err;
    if (gather && ntiles > 0) {
      rank_tiles<<<(unsigned)ntiles, kThreads, 0, s>>>(a, vec);
      if (!launched(&err)) return (int)err;
    }
  }
  if (gather) {
    const long long blocks = (a.out_cap + kThreads - 1) / kThreads;
    if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
    gather_rows<<<(unsigned)blocks, kThreads, 0, s>>>(a);
    launched(&err);
  }
  return (int)err;
}
