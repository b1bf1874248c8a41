// like_match: one bool per string-dictionary value under a SQL LIKE
// pattern, over the dictionary's UTF-8 byte heap (column.StrHeap).
// Replaces no TPU kernel: the reference lowering maps LIKE on the host
// (exec/fragment.py _pred_like, ops/strfuncs.py _like_mask_vectorized /
// like_regex), and so did the port until the host's numpy pass over a
// 1.5 M-value dictionary (TPC-H o_comment) became most of a query's time.
//
// What it computes: out[i] = (value i matches the program) != negate, where
// value i is data[offsets[i] .. offsets[i + 1]) and the program is the
// pattern as ops/strfuncs.like_program tokenizes it (like_regex's reading
// of % _ and the escape character): ops 0-255 match that byte, kOne
// (`_`) one UTF-8 code point, kAny (`%`) any sequence.  Flags:
//   1  fold ASCII upper case of the value's bytes (ILIKE over an all-ASCII
//      heap; the program's literals are already lower case);
//   2  Python's `$`: the host's regex path also matches a value whose last
//      byte is '\n' when the value without it matches;
//   4  negate (NOT LIKE).
//
// Matching: the greedy two-pointer wildcard match with one backtrack point
// (the last `%`), which is exact for `%` and one-unit `_`; the units here
// are code points, and every position it visits starts one, because `_`
// and the backtrack step advance by a whole code point and a literal run
// is whole code points of the pattern.
//
// Bound: memory.  Each value's bytes are read once when no `%` backtracks
// (the usual case: a mismatch inside a segment retries one code point
// further), plus 8 bytes of offsets and one byte written a value.  Design:
// one thread a value over a grid-stride loop (a warp's threads read 32
// neighbouring values, whose lines L1 keeps while each thread walks its
// own); the program is copied once a block into shared memory, so the
// divergent reads of pattern positions never serialize in the constant
// cache.  The heap's upload from host memory, not this kernel, bounds the
// map (dictmap.py).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOps = 1024;    // ops/cuda_kernels.py LIKE_MAX_OPS
constexpr short kOne = 256;      // ops/strfuncs.py LIKE_ONE
constexpr short kAny = 257;      // ops/strfuncs.py LIKE_ANY

struct Program {
  int n;
  short ops[kMaxOps];
};

__device__ __forceinline__ int cp_len(unsigned char lead) {
  return lead < 0x80 ? 1 : lead < 0xE0 ? 2 : lead < 0xF0 ? 3 : 4;
}

__device__ bool match(const unsigned char* __restrict__ s, int len,
                      const short* ops, int n, bool fold) {
  int si = 0, pi = 0, star = -1, mark = 0;
  while (si < len) {
    if (pi < n) {
      const short op = ops[pi];
      if (op == kAny) {
        star = ++pi;
        mark = si;
        continue;
      }
      if (op == kOne) {
        si += cp_len(s[si]);
        ++pi;
        continue;
      }
      unsigned char c = s[si];
      if (fold && c >= 'A' && c <= 'Z') c += 'a' - 'A';
      if (c == op) {
        ++si;
        ++pi;
        continue;
      }
    }
    if (star < 0) return false;
    mark += cp_len(s[mark]);
    si = mark;
    pi = star;
  }
  while (pi < n && ops[pi] == kAny) ++pi;
  return pi == n && si == len;
}

__global__ void like_match_kernel(const unsigned char* __restrict__ data,
                                  const int* __restrict__ offsets, int n,
                                  const Program prog, int flags,
                                  bool* __restrict__ out) {
  __shared__ short ops[kMaxOps];
  for (int k = threadIdx.x; k < prog.n; k += blockDim.x) ops[k] = prog.ops[k];
  __syncthreads();
  const bool fold = flags & 1, nl = flags & 2, neg = flags & 4;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int b = offsets[i];
    const int len = offsets[i + 1] - b;
    const unsigned char* s = data + b;
    bool m = match(s, len, ops, prog.n, fold);
    if (!m && nl && len > 0 && s[len - 1] == '\n')
      m = match(s, len - 1, ops, prog.n, fold);
    out[i] = m != neg;
  }
}

}  // namespace

// Launches on `stream`; does not synchronise.  `ops` is a host array of
// `n_ops` int16 program ops (copied into the launch's parameters).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int like_match_launch(const void* data, const void* offsets, int n,
                                 const void* ops, int n_ops, int flags,
                                 void* out, int blocks, int threads,
                                 void* stream) {
  if (n < 0 || n_ops < 0 || n_ops > kMaxOps || blocks < 1 || threads < 32 ||
      threads % 32 || flags < 0 || flags > 7)
    return (int)cudaErrorInvalidValue;
  Program prog;
  prog.n = n_ops;
  const short* src = (const short*)ops;
  for (int k = 0; k < n_ops; ++k) prog.ops[k] = src[k];
  like_match_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)data, (const int*)offsets, n, prog, flags,
      (bool*)out);
  return (int)cudaGetLastError();
}
