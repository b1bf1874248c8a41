// Per-lane shared-memory accumulators for exact grouped 64-bit sums and row
// counts over a small dense slot domain; shared by seg_sum64.cu and
// grouped_sum_limbs.cu.
//
// Slot g of lane l lives at [g * 32 + l], so the 32 lanes of a warp always
// add to 32 different addresses, whatever their slots.  A 64-bit shared
// atomic add compiles to a compare-and-swap loop on Hopper; keeping the
// lanes of a warp apart keeps those loops from spinning on each other, so
// few live groups cost no more than many.  Warps of a block meet on an
// address only by chance (the atomics resolve that).  At the end each block
// sums its 32 lane columns per slot and adds the totals with one global
// 64-bit atomicAdd per non-empty slot into outputs the caller zeroed.
// Unsigned adds wrap modulo 2^64 and commute, so the result is exact and
// does not depend on the order of the atomics.
//
// Shared memory: domain * 32 * (8 + 4) bytes, 48 KiB at domain 128.  Row
// counts are 32-bit per (slot, lane, block): below 2^32 rows per block.

#pragma once

#include <cuda_runtime.h>

namespace seg_accum {

constexpr int kLanes = 32;

struct Acc {
  unsigned long long* sum;  // [domain][32]
  unsigned* cnt;            // [domain][32]
};

__host__ __device__ inline size_t shmem_bytes(int domain) {
  return (size_t)domain * kLanes *
         (sizeof(unsigned long long) + sizeof(unsigned));
}

// Carves the block's dynamic shared memory and zeroes it (block-wide).
__device__ inline Acc init(unsigned long long* smem, int domain) {
  Acc a;
  a.sum = smem;
  a.cnt = (unsigned*)(smem + (size_t)domain * kLanes);
  for (int i = threadIdx.x; i < domain * kLanes; i += blockDim.x) {
    a.sum[i] = 0ull;
    a.cnt[i] = 0u;
  }
  __syncthreads();
  return a;
}

__device__ inline void add(const Acc& a, long long slot, int lane,
                           unsigned long long v) {
  atomicAdd(&a.sum[slot * kLanes + lane], v);
  atomicAdd(&a.cnt[slot * kLanes + lane], 1u);
}

// Block-wide: folds the lane columns and adds each non-empty slot's totals
// into the global outputs.
__device__ inline void flush(const Acc& a, int domain,
                             unsigned long long* __restrict__ sums,
                             unsigned long long* __restrict__ counts) {
  __syncthreads();
  for (int g = threadIdx.x; g < domain; g += blockDim.x) {
    unsigned long long tot = 0ull, cnt = 0ull;
    for (int l = 0; l < kLanes; ++l) {
      tot += a.sum[g * kLanes + l];
      cnt += a.cnt[g * kLanes + l];
    }
    if (cnt != 0ull) {
      atomicAdd(&sums[g], tot);
      atomicAdd(&counts[g], cnt);
    }
  }
}

}  // namespace seg_accum
