// substr_keys: each string-dictionary value's substring as one 64-bit
// sortable key, over the dictionary's UTF-8 byte heap (column.StrHeap).
// Replaces no TPU kernel: the reference lowering maps substring / left /
// right with a Python call per distinct value and np.unique on the host
// (exec/fragment.py _str_func), which dominated TPC-H Q22's lowering over
// the 150,000-value c_phone dictionary.
//
// What it computes, for value i = data[offsets[i] .. offsets[i + 1]) and
// code point positions as Python's str slicing counts them:
//   right == 0: code points [start, start + count) (count < 0: to the end),
//               i.e. s[start:start + count] with start, count >= 0;
//   right == 1: the last `count` code points, s[-count:] (count == 0: "").
// The result's bytes, big-endian and zero-padded, form a 64-bit word whose
// top bit is flipped, so that the signed int64 order of the keys is the
// unsigned byte order of the results: UTF-8 byte order is code point order,
// the order of Python's str and of the host's np.unique.  The caller
// guarantees that every result fits 8 bytes and that the heap holds no NUL
// (dictmap.py routes other maps to the host), so zero padding keeps
// distinct results distinct; a longer result would be cut to 8 bytes.
//
// Bound: memory.  A value's bytes up to the end of its substring are read
// once (right: all of them, to count code points), 8 bytes of offsets, 8
// bytes of key written.  Design: one thread a value over a grid-stride
// loop, as like_match.cu; no shared memory.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int cp_len(unsigned char lead) {
  return lead < 0x80 ? 1 : lead < 0xE0 ? 2 : lead < 0xF0 ? 3 : 4;
}

// byte position after skipping k code points from `pos` (at most to len)
__device__ __forceinline__ int skip(const unsigned char* __restrict__ s,
                                    int len, int pos, int k) {
  while (k > 0 && pos < len) {
    pos += cp_len(s[pos]);
    --k;
  }
  return pos < len ? pos : len;
}

__global__ void substr_keys_kernel(const unsigned char* __restrict__ data,
                                   const int* __restrict__ offsets, int n,
                                   int start, int count, int right,
                                   long long* __restrict__ keys) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int b = offsets[i];
    const int len = offsets[i + 1] - b;
    const unsigned char* s = data + b;
    int from, to = len;
    if (right) {
      int ncp = 0;
      for (int j = 0; j < len; ++j) ncp += (s[j] & 0xC0) != 0x80;
      from = skip(s, len, 0, ncp > count ? ncp - count : 0);
    } else {
      from = skip(s, len, 0, start);
      if (count >= 0) to = skip(s, len, from, count);
    }
    if (to - from > 8) to = from + 8;
    unsigned long long key = 0;
    for (int j = from; j < to; ++j) key = key << 8 | s[j];
    const int w = to - from;
    if (w > 0 && w < 8) key <<= 8 * (8 - w);
    keys[i] = (long long)(key ^ 0x8000000000000000ull);
  }
}

}  // namespace

// Launches on `stream`; does not synchronise.  start >= 0; count >= 0, or
// -1 for "to the end" when right == 0.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int substr_keys_launch(const void* data, const void* offsets, int n,
                                  int start, int count, int right, void* keys,
                                  int blocks, int threads, void* stream) {
  if (n < 0 || start < 0 || count < -1 || (right && count < 0) ||
      (right != 0 && right != 1) || blocks < 1 || threads < 32 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  substr_keys_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)data, (const int*)offsets, n, start, count, right,
      (long long*)keys);
  return (int)cudaGetLastError();
}
