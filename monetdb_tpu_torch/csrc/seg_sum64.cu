// seg_sum64: exact per-segment int64 sum and row count over a small dense
// segment domain.  Replaces the Pallas TPU kernel
// monetdb_tpu/ops/pallas_kernels.py:seg_sum64 (_seg_sum64_kernel), the
// engine's grouped-sum kernel (BATgroupsum, gdk/gdk_aggr.c:900) under
// _SegReduce.sum in one-hot mode.
//
// What it computes: for g in [0, domain)
//   sums[g]   = sum of vals[i] over rows with sid[i] == g   (mod 2^64)
//   counts[g] = number of rows with sid[i] == g
// Rows whose sid lies outside [0, domain) are excluded.  The TPU kernel
// splits every value into 16-bit limbs held in int32 accumulators because
// Mosaic has no 64-bit types; Hopper adds 64-bit integers natively, so the
// accumulators here hold whole unsigned 64-bit sums.
// Unsigned 64-bit adds wrap modulo 2^64 exactly as the TPU kernel's limb
// recombination does, and integer addition commutes, so the result is exact
// and independent of the order of the atomics.
//
// Bound: memory.  Each row is read once (4 or 8 bytes of sid + 8 bytes of
// value) and nothing else is written to device memory but 2 * domain
// atomics per block.  Design against that bound:
//   * a grid-stride loop with coalesced loads, 4 rows per thread in flight
//     (the loads of a step are issued before its adds);
//   * per-lane accumulators in shared memory: slot g of lane l lives at
//     [g * 32 + l], so the 32 lanes of a warp always add to 32 different
//     addresses, whatever their segment ids.  Few live groups (TPC-H Q1
//     has 4, Q6 one) then cost no more than many: the adds never conflict
//     inside a warp, and warps of the block meet on an address only by
//     chance (the shared atomics resolve that).  No warp collective runs
//     per row, so the cost does not grow with the number of distinct ids;
//   * at the end each block sums its 32 lane columns per slot and adds the
//     totals with one global 64-bit atomicAdd per non-empty slot into
//     outputs the caller zeroed.
// Shared memory: domain * 32 * (8 + 4) bytes, 48 KiB at domain 128.  Row
// counts are 32-bit per (slot, lane, block): below 2^32 rows per block.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kUnroll = 4;

template <typename SidT>
__global__ void seg_sum64_kernel(const SidT* __restrict__ sid,
                                 const long long* __restrict__ vals,
                                 long long n, int domain,
                                 unsigned long long* __restrict__ sums,
                                 unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_sum = smem;                            // [domain][32]
  unsigned* s_cnt = (unsigned*)(smem + (size_t)domain * kLanes);  // [domain][32]
  for (int i = threadIdx.x; i < domain * kLanes; i += blockDim.x) {
    s_sum[i] = 0ull;
    s_cnt[i] = 0u;
  }
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       base < n; base += kUnroll * stride) {
    long long s[kUnroll];
    unsigned long long v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * stride;
      s[k] = -1;
      v[k] = 0ull;
      if (i < n) {
        s[k] = (long long)sid[i];
        v[k] = (unsigned long long)vals[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (s[k] >= 0 && s[k] < domain) {
        atomicAdd(&s_sum[s[k] * kLanes + lane], v[k]);
        atomicAdd(&s_cnt[s[k] * kLanes + lane], 1u);
      }
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < domain; g += blockDim.x) {
    unsigned long long tot = 0ull, cnt = 0ull;
    for (int l = 0; l < kLanes; ++l) {
      tot += s_sum[g * kLanes + l];
      cnt += s_cnt[g * kLanes + l];
    }
    if (cnt != 0ull) {
      atomicAdd(&sums[g], tot);
      atomicAdd(&counts[g], cnt);
    }
  }
}

}  // namespace

// Launches on `stream`; does not synchronise.  sid_bytes is 4 (int32 sid)
// or 8 (int64 sid).  threads must be a multiple of 32.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int seg_sum64_launch(const void* sid, int sid_bytes,
                                const void* vals, long long n, int domain,
                                void* sums, void* counts, int blocks,
                                int threads, void* stream) {
  if (domain < 1 || domain > 128 || n < 0 || blocks < 1 || threads < 32 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)domain * kLanes *
                       (sizeof(unsigned long long) + sizeof(unsigned));
  cudaStream_t st = (cudaStream_t)stream;
  auto* out_s = (unsigned long long*)sums;
  auto* out_c = (unsigned long long*)counts;
  const auto* v = (const long long*)vals;
  if (sid_bytes == 8) {
    seg_sum64_kernel<long long><<<blocks, threads, shmem, st>>>(
        (const long long*)sid, v, n, domain, out_s, out_c);
  } else if (sid_bytes == 4) {
    seg_sum64_kernel<int><<<blocks, threads, shmem, st>>>(
        (const int*)sid, v, n, domain, out_s, out_c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
