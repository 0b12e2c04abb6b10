// Shared by viterbi_large.cu and viterbi_large4.cu: the code description,
// branch-penalty tables, the butterfly, and the per-frame shift-to-zero
// renormalisation kernels of the state-blocked large-K kernels.  Each source
// includes this file into its own anonymous namespace.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kMaxR = 8;
constexpr int kThreads = 256;

struct Code {
  int mask[kMaxR];  // poly_r >> 1: parity of a predecessor index
  int km[4];        // bit r of km[h*2 + b]: (b & poly_r) ^ (h & poly_r >> (K-1)) ^ inv_r
  int par_q;        // parities of S/4 (pair kernel: p -> p + S/4)
  int par_1;        // parities of 1 (2p -> 2p + 1)
};

__device__ __forceinline__ int parities(int s, const Code& c, int R) {
  int v = 0;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r)
    if (r < R) v |= (__popc(s & c.mask[r]) & 1) << r;
  return v;
}

// Penalty table of one step of frame b: q[x] = sum_r (sym_r - low) +
// sum_{r: bit r of x} (high + low - 2 sym_r), for x < 2^R.
template <int R>
__device__ __forceinline__ void build_table(int* q, const int* __restrict__ sym, int low, int hl,
                                            int tid, int nthreads) {
  int y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) y[r] = sym[r];
  for (int x = tid; x < (1 << R); x += nthreads) {
    int v = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) v += (y[r] - low) + (((x >> r) & 1) ? hl - 2 * y[r] : 0);
    q[x] = v;
  }
}

// One butterfly: predecessors lo (h=0) and hi (h=1) with parities pb; the
// candidates for input bit b go to out[b], their decisions to d[b].
__device__ __forceinline__ void butterfly(int lo, int hi, int pb, const int* q, const Code& c,
                                          int* out, bool* d) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int c_lo = lo + q[pb ^ c.km[b]];
    const int c_hi = hi + q[pb ^ c.km[2 + b]];
    d[b] = c_hi < c_lo;
    out[b] = d[b] ? c_hi : c_lo;
  }
}

// mn[b] = min(mn[b], min over the frame's S metrics); mn starts at INT_MAX.
__global__ void __launch_bounds__(kThreads)
frame_min_kernel(const int* __restrict__ m, int S, int* __restrict__ mn) {
  __shared__ int part[kThreads / 32];
  const int b = blockIdx.y;
  const int* f = m + (size_t)b * S;
  int v = INT_MAX;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < S; i += gridDim.x * blockDim.x)
    v = min(v, f[i]);
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < (blockDim.x >> 5) ? part[threadIdx.x] : INT_MAX;
    v = __reduce_min_sync(0xffffffffu, v);
    if (threadIdx.x == 0) atomicMin(mn + b, v);
  }
}

// m[b, :] -= sub[b]; off[b] += sub[b].
__global__ void __launch_bounds__(kThreads)
frame_sub_kernel(int* __restrict__ m, int S, const int* __restrict__ sub, int* __restrict__ off) {
  const int b = blockIdx.y;
  const int sh = sub[b];
  if (blockIdx.x == 0 && threadIdx.x == 0) off[b] += sh;
  int* f = m + (size_t)b * S;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < S; i += gridDim.x * blockDim.x)
    f[i] -= sh;
}

dim3 reduce_grid(int S, int B) {
  const int per = kThreads * 8;
  int n = (S + per - 1) / per;
  return dim3(n < 1024 ? n : 1024, B);
}

cudaError_t frame_min(const int* m, int S, int B, int* mn, cudaStream_t s) {
  frame_min_kernel<<<reduce_grid(S, B), kThreads, 0, s>>>(m, S, mn);
  return cudaGetLastError();
}

Code make_code(const int* polys, int K, int R, int inv) {
  Code c = {};
  for (int r = 0; r < R; ++r) {
    const int p = polys[r];
    c.mask[r] = p >> 1;
    for (int h = 0; h < 2; ++h)
      for (int b = 0; b < 2; ++b) {
        const int k = (b & p & 1) ^ (h & (p >> (K - 1)) & 1) ^ ((inv >> r) & 1);
        c.km[h * 2 + b] |= k << r;
      }
    const int S4 = 1 << (K - 3);
    c.par_q |= (__builtin_popcount(S4 & c.mask[r]) & 1) << r;
    c.par_1 |= (c.mask[r] & 1) << r;
  }
  return c;
}

}  // namespace
