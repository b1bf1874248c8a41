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
//   * per-lane accumulators in shared memory (seg_accum.cuh): the adds
//     never conflict inside a warp, no warp collective runs per row, so the
//     cost does not grow with the number of distinct ids (TPC-H Q1 has 4
//     live groups, Q6 one);
//   * one global 64-bit atomicAdd per non-empty slot and block at the end.

#include "seg_accum.cuh"

namespace {

using seg_accum::kLanes;
constexpr int kUnroll = 4;

template <typename SidT>
__global__ void seg_sum64_kernel(const SidT* __restrict__ sid,
                                 const long long* __restrict__ vals,
                                 long long n, int domain,
                                 unsigned long long* __restrict__ sums,
                                 unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned long long smem[];
  const seg_accum::Acc acc = seg_accum::init(smem, domain);

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
      if (s[k] >= 0 && s[k] < domain) seg_accum::add(acc, s[k], lane, v[k]);
    }
  }
  seg_accum::flush(acc, domain, sums, counts);
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
  const size_t shmem = seg_accum::shmem_bytes(domain);
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
