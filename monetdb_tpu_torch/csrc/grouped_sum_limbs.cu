// grouped_sum_limbs: masked grouped sum and row count of int32 values over
// a small dense code domain.  Replaces the Pallas TPU kernel
// monetdb_tpu/ops/pallas_kernels.py:grouped_sum_limbs (_gsum_kernel).
//
// What it computes: for g in [0, domain)
//   sums[g]   = sum of values[i] over rows with mask[i] and code[i] == g
//   counts[g] = number of such rows
// Rows whose code lies outside [0, domain) are excluded.  The TPU kernel
// (and its name) splits each value into two 16-bit limbs held in int32
// accumulators because Mosaic has no 64-bit types; here each value is
// sign-extended and added whole into a 64-bit accumulator, which gives the
// same exact sums.
//
// Bound: memory, 9 bytes per row (4 of code, 4 of value, 1 of mask), read
// once by this kernel itself: no masked copy of the values is made in front
// of it.  Design against that bound:
//   * where the three arrays are aligned, each thread takes 4 consecutive
//     rows per step with two 16-byte loads and one 4-byte load, two steps in
//     flight; a ragged tail (and unaligned input) goes through a scalar
//     grid-stride loop;
//   * per-lane shared-memory accumulators (seg_accum.cuh), one global
//     64-bit atomicAdd per non-empty slot and block at the end.

#include <cstdint>

#include "seg_accum.cuh"

namespace {

using seg_accum::kLanes;
constexpr int kVec = 4;
constexpr int kUnroll = 2;

__device__ inline void take(const seg_accum::Acc& acc, int domain, int lane,
                            int code, int value, unsigned mask) {
  if (mask != 0u && code >= 0 && code < domain)
    seg_accum::add(acc, code, lane, (unsigned long long)(long long)value);
}

__global__ void grouped_sum_limbs_kernel(
    const int* __restrict__ code, const int* __restrict__ values,
    const unsigned char* __restrict__ mask, long long n, long long n_vec,
    int domain, unsigned long long* __restrict__ sums,
    unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned long long smem[];
  const seg_accum::Acc acc = seg_accum::init(smem, domain);

  const int lane = threadIdx.x % kLanes;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int4* code4 = (const int4*)code;
  const int4* val4 = (const int4*)values;
  const uchar4* mask4 = (const uchar4*)mask;
  for (long long base = tid; base < n_vec; base += kUnroll * stride) {
    int4 c[kUnroll], v[kUnroll];
    uchar4 m[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * stride;
      c[k] = make_int4(-1, -1, -1, -1);
      v[k] = make_int4(0, 0, 0, 0);
      m[k] = make_uchar4(0, 0, 0, 0);
      if (i < n_vec) {
        c[k] = code4[i];
        v[k] = val4[i];
        m[k] = mask4[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      take(acc, domain, lane, c[k].x, v[k].x, m[k].x);
      take(acc, domain, lane, c[k].y, v[k].y, m[k].y);
      take(acc, domain, lane, c[k].z, v[k].z, m[k].z);
      take(acc, domain, lane, c[k].w, v[k].w, m[k].w);
    }
  }
  for (long long i = n_vec * kVec + tid; i < n; i += stride)
    take(acc, domain, lane, code[i], values[i], mask[i]);
  seg_accum::flush(acc, domain, sums, counts);
}

}  // namespace

// Launches on `stream`; does not synchronise.  mask holds one byte per row
// (0 = excluded).  threads must be a multiple of 32.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int grouped_sum_limbs_launch(const void* code, const void* values,
                                        const void* mask, long long n,
                                        int domain, void* sums, void* counts,
                                        int blocks, int threads,
                                        void* stream) {
  if (domain < 1 || domain > 128 || n < 0 || blocks < 1 || threads < 32 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const bool aligned = (uintptr_t)code % 16 == 0 &&
                       (uintptr_t)values % 16 == 0 && (uintptr_t)mask % 4 == 0;
  const long long n_vec = aligned ? n / kVec : 0;
  grouped_sum_limbs_kernel<<<blocks, threads, seg_accum::shmem_bytes(domain),
                             (cudaStream_t)stream>>>(
      (const int*)code, (const int*)values, (const unsigned char*)mask, n,
      n_vec, domain, (unsigned long long*)sums, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}
