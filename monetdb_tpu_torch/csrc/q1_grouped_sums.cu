// q1_grouped_sums: fused TPC-H Q1 aggregation in one pass over six int32
// columns.  Replaces the Pallas TPU kernel
// monetdb_tpu/ops/pallas_kernels.py:q1_grouped_sums (_q1_kernel).
//
// What it computes: over rows with 0 <= code[i] < domain and
// shipdate[i] <= cutoff, with
//   dp = extp * (100 - disc)        (disc_price, scale 4)
//   ch = dp * (100 + tax)           (charge, scale 6)
// for g in [0, domain): out[0..5][g] = sum of qty, extp, dp, ch, disc and the
// row count of group g.  The TPU kernel forms dp in int32 and carries eleven
// 16-bit limbs per group because Mosaic has no 64-bit integers; here dp and
// ch are 64-bit products and whole values are added into unsigned 64-bit
// accumulators, which wrap modulo 2^64 as the limb recombination does.  The
// results equal the TPU kernel's wherever its own range notes hold
// (dp < 2^31); beyond them this kernel stays exact where the TPU kernel's
// int32 product wraps.
//
// Bound: memory, 24 bytes per row read once, 6 * domain words written.
// Each row does six 64-bit adds into its group's accumulators, and a 64-bit
// shared-memory atomicAdd is a compare-and-swap loop on Hopper.  The
// accumulators are per-lane columns as in seg_accum.cuh, six rows per
// group: [(group * 6 + measure) * 32 + lane], so the 32 lanes of a warp
// never add to one address and the loops do not spin on each other
// (1,536 * domain bytes per block: 12 KiB at 8 groups, 192 KiB at 128).  A
// layout with private per-thread accumulators and no atomics at all
// (48 * domain bytes per thread) was measured beside it and was 3% slower
// at 8 groups, so it is gone.
// Where the six arrays are 16-byte aligned each thread takes 4 consecutive
// rows per step with six 16-byte loads; the ragged tail (and unaligned
// input) goes through a scalar grid-stride loop.  At the end each warp
// folds whole accumulator rows with shuffles and adds each non-zero total
// with one global 64-bit atomicAdd into outputs the caller zeroed.

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kMeasures = 6;
constexpr int kVec = 4;
constexpr int kLanes = 32;

__device__ inline void take(unsigned long long* acc, int lane, int domain,
                            int cutoff, int code, int ship, int qty,
                            int extp, int disc, int tax) {
  if (code < 0 || code >= domain || ship > cutoff) return;
  const long long dp = (long long)extp * (long long)(100 - disc);
  const long long ch = dp * (long long)(100 + tax);
  unsigned long long* a = acc + code * kMeasures * kLanes + lane;
  atomicAdd(a, (unsigned long long)(long long)qty);
  atomicAdd(a + kLanes, (unsigned long long)(long long)extp);
  atomicAdd(a + 2 * kLanes, (unsigned long long)dp);
  atomicAdd(a + 3 * kLanes, (unsigned long long)ch);
  atomicAdd(a + 4 * kLanes, (unsigned long long)(long long)disc);
  atomicAdd(a + 5 * kLanes, 1ull);
}

__global__ void q1_grouped_sums_kernel(
    const int* __restrict__ code, const int* __restrict__ ship,
    const int* __restrict__ qty, const int* __restrict__ extp,
    const int* __restrict__ disc, const int* __restrict__ tax, int cutoff,
    long long n, long long n_vec, int domain,
    unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long acc[];
  const int lane = threadIdx.x % kLanes;
  const int rows = domain * kMeasures;
  for (int i = threadIdx.x; i < rows * kLanes; i += blockDim.x) acc[i] = 0ull;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int4* code4 = (const int4*)code;
  const int4* ship4 = (const int4*)ship;
  const int4* qty4 = (const int4*)qty;
  const int4* extp4 = (const int4*)extp;
  const int4* disc4 = (const int4*)disc;
  const int4* tax4 = (const int4*)tax;
  for (long long i = tid; i < n_vec; i += stride) {
    const int4 c = code4[i], s = ship4[i], q = qty4[i], e = extp4[i],
               d = disc4[i], t = tax4[i];
    take(acc, lane, domain, cutoff, c.x, s.x, q.x, e.x, d.x, t.x);
    take(acc, lane, domain, cutoff, c.y, s.y, q.y, e.y, d.y, t.y);
    take(acc, lane, domain, cutoff, c.z, s.z, q.z, e.z, d.z, t.z);
    take(acc, lane, domain, cutoff, c.w, s.w, q.w, e.w, d.w, t.w);
  }
  for (long long i = n_vec * kVec + tid; i < n; i += stride)
    take(acc, lane, domain, cutoff, code[i], ship[i], qty[i], extp[i],
         disc[i], tax[i]);
  __syncthreads();

  // fold: one warp per accumulator row; row r = group * 6 + measure goes to
  // out[measure * domain + group]
  const int warp = threadIdx.x / kLanes;
  const int nwarps = blockDim.x / kLanes;
  for (int r = warp; r < rows; r += nwarps) {
    unsigned long long tot = acc[r * kLanes + lane];
    for (int off = 16; off > 0; off >>= 1)
      tot += __shfl_down_sync(0xffffffffu, tot, off);
    if (lane == 0 && tot != 0ull)
      atomicAdd(&out[(r % kMeasures) * domain + r / kMeasures], tot);
  }
}

}  // namespace

// Launches on `stream`; does not synchronise.  out is [6][domain] unsigned
// 64-bit, zeroed by the caller.  threads must be a multiple of 32.  Returns
// the cudaError_t of the launch (0 = success).
extern "C" int q1_grouped_sums_launch(
    const void* code, const void* ship, const void* qty, const void* extp,
    const void* disc, const void* tax, int cutoff, long long n, int domain,
    void* out, int blocks, int threads, void* stream) {
  if (domain < 1 || domain > 128 || n < 0 || blocks < 1 || threads < 32 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  bool aligned = true;
  for (const void* p : {code, ship, qty, extp, disc, tax})
    aligned = aligned && (uintptr_t)p % 16 == 0;
  const long long n_vec = aligned ? n / kVec : 0;
  const size_t shmem =
      (size_t)domain * kMeasures * kLanes * sizeof(unsigned long long);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        q1_grouped_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  q1_grouped_sums_kernel<<<blocks, threads, shmem, (cudaStream_t)stream>>>(
      (const int*)code, (const int*)ship, (const int*)qty, (const int*)extp,
      (const int*)disc, (const int*)tax, cutoff, n, n_vec, domain,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
