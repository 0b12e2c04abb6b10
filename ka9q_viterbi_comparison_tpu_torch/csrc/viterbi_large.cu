// State-blocked Viterbi kernels for large trellises (K = 8..24) on Hopper
// (sm_90a), bound to Python with ctypes through the plain extern "C"
// launcher at the end of this file.
//
//   acs_large_pair_kernel  replaces ops/pallas/large_k2.py  acs_update_large2 (_pair_kernel),
//                          its optional G_2 radix planes (want_g2) included
//   acs_large_step_kernel  replaces ops/pallas/large_k.py   acs_update_large  (_step_kernel)
//   frame_min_kernel, frame_sub_kernel: the per-frame shift-to-zero
//     renormalisation (block entry and in-scan), which the JAX package does
//     in XLA around its kernels.
//
// Layouts (batch-major, as at the Python wrappers):
//   metrics  [B, S] int32, state order
//   symbols  [B, T, R] int32
//   words    int32 (uint32 bits), bit s % 32 of word s / 32 for new state s;
//            word (b, t, w) at b * wsb + t * wst + w (batch- or time-major)
//   offset   [B] int32, every shift subtracted from a frame's metrics is
//            added here
//
// Metrics live in device memory, double-buffered: one launch per trellis
// step pair (or step), and the loop over launches runs inside the launcher
// on the caller's stream.  K=24 holds 2^23 metrics per frame, far beyond a
// block's shared memory, so nothing is kept on chip between launches.
//
// Pair kernel: thread p (0 <= p < S/4) of frame b owns the predecessor quad
// {p, p + S/4, p + S/2, p + 3S/4}.  Step t makes the intermediates 2p + b1
// (from p, p + S/2) and 2p + S/2 + b1 (from p + S/4, p + 3S/4); step t+1
// pairs 2p + b1 with 2p + b1 + S/2, both held by the same thread, and makes
// the finals 4p .. 4p+3.  No intermediate leaves registers.
//
// Branch penalties: the expected bit of polynomial r for the transition
// from state s2 + h*S/2 with input bit b is parity(s2 & (poly_r >> 1)) ^
// kbit_r(h, b), so a state's R parities (one __popc each, any R) XOR a
// constant mask index a 2^R-entry table of penalty sums that each block
// builds in shared memory from the step's symbols.  Parity is linear, so
// the parities of p + S/4 and 2p + 1 follow from those of p and 2p by a
// constant XOR.
//
// Decision words: one __ballot_sync per candidate over 32 consecutive p,
// then bit spreading, gives each word in the canonical packing directly.
// The G_2 plane of a pair (ops/radix_planes.py) is the step-t decision at the
// predecessor the step-t+1 survivor came from, d1[d2][b1] in the thread's own
// registers, packed like the step-t+1 words.
//
// What bounds them on the card: at Cassini (K=15, R=6) B=64 the operations
// (a 2^R-entry penalty table a step, then 6 int32 operations per state and
// step at 16.7 TOP/s) bound a pair at about 0.76 us on paper; the metric
// streaming (one read and one write of B*S int32 per pair) and the launch
// latency of 1031 launches per frame are what the kernel really pays.  At
// K=24 the metric traffic (64 MiB a frame per pair) bounds it.
//
// Tie rule: a decision is c_hi < c_lo, strict; ties keep the low predecessor
// (ops/pallas/large_k2.py:256, ka9q viterbi27_sse2.cpp:155-156).

#include "viterbi_large.cuh"

namespace {

// Bit i of x (i < 16) to bit 2i.
__device__ __forceinline__ unsigned spread2(unsigned x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// Bit i of x (i < 8) to bit 4i.
__device__ __forceinline__ unsigned spread4(unsigned x) {
  x &= 0xffu;
  x = (x | (x << 12)) & 0x000f000fu;
  x = (x | (x << 6)) & 0x03030303u;
  x = (x | (x << 3)) & 0x11111111u;
  return x;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
acs_large_pair_kernel(const int* __restrict__ m_in, int* __restrict__ m_out,
                      const int* __restrict__ sym, int* __restrict__ words,
                      int* __restrict__ g2, const int* __restrict__ sub, int* __restrict__ off,
                      Code c, int K, int low, int hl, int T_sym, int t, long long wsb,
                      long long wst, long long gsb) {
  __shared__ int q[2][1 << R];
  const int S = 1 << (K - 1), S4 = S >> 2, W = S >> 5;
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int* y = sym + ((size_t)b * T_sym + t) * R;
  build_table<R>(&q[0][0], y, low, hl, threadIdx.x, blockDim.x);
  build_table<R>(&q[1][0], y + R, low, hl, threadIdx.x, blockDim.x);

  const int* m = m_in + (size_t)b * S;
  const int sh = sub ? sub[b] : 0;
  if (sub && blockIdx.x == 0 && threadIdx.x == 0) off[b] += sh;
  const int m0 = m[p] - sh, m1 = m[p + S4] - sh, m2 = m[p + 2 * S4] - sh,
            m3 = m[p + 3 * S4] - sh;
  __syncthreads();

  // Step t: group g's intermediates 2p + b1 + g*S/2.
  const int pb = parities(p, c, R);
  int mid[2][2];
  bool d1[2][2];
  butterfly(m0, m2, pb, q[0], c, mid[0], d1[0]);
  butterfly(m1, m3, pb ^ c.par_q, q[0], c, mid[1], d1[1]);

  // Step t+1: intermediate i = 2p + b1 pairs with i + S/2; finals 4p + 2b1 + b2.
  const int pb2 = parities(2 * p, c, R);
  int fin[4];
  bool d2[4];
  butterfly(mid[0][0], mid[1][0], pb2, q[1], c, fin, d2);
  butterfly(mid[0][1], mid[1][1], pb2 ^ c.par_1, q[1], c, fin + 2, d2 + 2);
  reinterpret_cast<int4*>(m_out + (size_t)b * S)[p] = make_int4(fin[0], fin[1], fin[2], fin[3]);

  // Words.  Lanes l of warp w hold p = 32w + l.  Step t: state 2p + b1 (+S/2)
  // is bit 2(l % 16) + b1 of word 2w + l/16 (+W/2).  Step t+1: state 4p + k
  // is bit 4(l % 8) + k of word 4w + l/8.
  unsigned v1[2][2], v2[4];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int b1 = 0; b1 < 2; ++b1) v1[g][b1] = __ballot_sync(0xffffffffu, d1[g][b1]);
#pragma unroll
  for (int k = 0; k < 4; ++k) v2[k] = __ballot_sync(0xffffffffu, d2[k]);
  const int lane = threadIdx.x & 31, w = p >> 5;
  int* wt = words + (size_t)b * wsb + (size_t)t * wst;
  if (lane < 4) {
    const int g = lane >> 1, half = lane & 1;
    const unsigned word = spread2(v1[g][0] >> (16 * half)) | (spread2(v1[g][1] >> (16 * half)) << 1);
    wt[g * (W >> 1) + 2 * w + half] = (int)word;
  } else if (lane < 8) {
    const int j = lane - 4;
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) word |= spread4(v2[k] >> (8 * j)) << k;
    wt[wst + 4 * w + j] = (int)word;
  }
  if (g2 != nullptr) {  // uniform over the grid
    unsigned vg[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      vg[k] = __ballot_sync(0xffffffffu, d2[k] ? d1[1][k >> 1] : d1[0][k >> 1]);
    if (lane >= 8 && lane < 12) {
      const int j = lane - 8;
      unsigned word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) word |= spread4(vg[k] >> (8 * j)) << k;
      g2[(size_t)b * gsb + 4 * w + j] = (int)word;
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
acs_large_step_kernel(const int* __restrict__ m_in, int* __restrict__ m_out,
                      const int* __restrict__ sym, int* __restrict__ words,
                      const int* __restrict__ sub, int* __restrict__ off, Code c, int K,
                      int low, int hl, int T_sym, int t, long long wsb, long long wst) {
  __shared__ int q[1 << R];
  const int S = 1 << (K - 1), S2 = S >> 1;
  const int b = blockIdx.y;
  const int s2 = blockIdx.x * blockDim.x + threadIdx.x;
  build_table<R>(q, sym + ((size_t)b * T_sym + t) * R, low, hl, threadIdx.x, blockDim.x);

  const int* m = m_in + (size_t)b * S;
  const int sh = sub ? sub[b] : 0;
  if (sub && blockIdx.x == 0 && threadIdx.x == 0) off[b] += sh;
  const int lo = m[s2] - sh, hi = m[s2 + S2] - sh;
  __syncthreads();

  int out[2];
  bool d[2];
  butterfly(lo, hi, parities(s2, c, R), q, c, out, d);
  reinterpret_cast<int2*>(m_out + (size_t)b * S)[s2] = make_int2(out[0], out[1]);

  // State 2 s2 + b is bit 2(l % 16) + b of word 2w + l/16.
  const unsigned v0 = __ballot_sync(0xffffffffu, d[0]), v1 = __ballot_sync(0xffffffffu, d[1]);
  const int lane = threadIdx.x & 31, w = s2 >> 5;
  if (lane < 2) {
    const unsigned word = spread2(v0 >> (16 * lane)) | (spread2(v1 >> (16 * lane)) << 1);
    words[(size_t)b * wsb + (size_t)t * wst + 2 * w + lane] = (int)word;
  }
}

// The launch loop shared by both kernels: `steps` trellis steps per launch
// (2: pair kernel, 1: step kernel), `nl` launches from step t0.  Launch j
// reads the metrics launch j-1 wrote (m_in for j = 0) and writes m_out or
// m_tmp, chosen so that the last launch writes m_out.  Every pending shift
// (the block-entry min, then each in-scan renormalisation after launch j
// with rn && j % rn == rn - 1) is taken from its own row of `mins` (rows
// pre-filled with INT_MAX) and subtracted by the next launch as it reads.
template <int R>
cudaError_t run_large(int steps, const int* m_in, const int* sym, const Code& c, int* m_out,
                      int* m_tmp, int* words, int* g2, int* off, int* mins, int nmins, int K,
                      int low, int hl, int B, int T_sym, int t0, int nl, int rn, long long wsb,
                      long long wst, long long gsb, long long gst, cudaStream_t s) {
  const int S = 1 << (K - 1);
  const int per = S / (steps == 2 ? 4 : 2);  // threads per frame
  const int threads = per < kThreads ? per : kThreads;
  const dim3 grid(per / threads, B);
  int row = 0;
  cudaError_t err = frame_min(m_in, S, B, mins, s);
  if (err != cudaSuccess) return err;
  const int* sub = mins + (size_t)B * row++;
  const int* src = m_in;
  int* dst = m_out;
  for (int j = 0; j < nl; ++j) {
    dst = ((nl - 1 - j) % 2 == 0) ? m_out : m_tmp;
    const int t = t0 + steps * j;
    if (steps == 2)
      acs_large_pair_kernel<R><<<grid, threads, 0, s>>>(
          src, dst, sym, words, g2 ? g2 + (size_t)j * gst : nullptr, sub, off, c, K, low, hl,
          T_sym, t, wsb, wst, gsb);
    else
      acs_large_step_kernel<R><<<grid, threads, 0, s>>>(src, dst, sym, words, sub, off, c, K,
                                                        low, hl, T_sym, t, wsb, wst);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sub = nullptr;
    if (rn > 0 && j % rn == rn - 1) {
      if (row >= nmins) return cudaErrorInvalidValue;
      int* mn = mins + (size_t)B * row++;
      err = frame_min(dst, S, B, mn, s);
      if (err != cudaSuccess) return err;
      sub = mn;
    }
    src = dst;
  }
  if (sub != nullptr) {  // a renormalisation after the last launch
    frame_sub_kernel<<<reduce_grid(S, B), kThreads, 0, s>>>(dst, S, sub, off);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// steps: 2 runs nl launches of the pair kernel, 1 of the step kernel, from
// trellis step t0 of the symbols [B, T_sym, R].  polys: host pointer to R
// absolute polynomials; inv: bit r set when polynomial r is inverted;
// hl = high + low.  mins: [nmins, B] int32 on the device, every entry
// INT_MAX, one row for the entry shift and one for each renormalisation
// (every rn launches; rn = 0 for none).  Words of step t of frame b start at
// words + b * wsb + t * wst.  g2 (pair kernel only; null for none): the G_2
// plane of launch j of frame b starts at g2 + b * gsb + j * gst.  Returns the
// first CUDA error, or 0.
int viterbi_acs_large(int steps, const void* m_in, const void* sym, const int* polys,
                      void* m_out, void* m_tmp, void* words, void* g2, void* off, void* mins,
                      int nmins, int K, int R, int inv, int low, int hl, int B, int T_sym, int t0,
                      int nl, int rn, long long wsb, long long wst, long long gsb, long long gst,
                      void* stream) {
  const int kmin = steps == 2 ? 8 : 7;  // a full warp of threads per frame
  if ((steps != 1 && steps != 2) || K < kmin || K > 24 || B < 1 || B > 65535 || nl < 1 ||
      nmins < 1 || rn < 0 || t0 < 0 || t0 + steps * nl > T_sym || (g2 != nullptr && steps != 2))
    return (int)cudaErrorInvalidValue;
  const Code c = make_code(polys, K, R, inv);
  const int* mi = (const int*)m_in;
  const int* sy = (const int*)sym;
  int *mo = (int*)m_out, *mt = (int*)m_tmp, *w = (int*)words, *g = (int*)g2, *of = (int*)off,
      *mn = (int*)mins;
  const cudaStream_t s = (cudaStream_t)stream;
#define LARGE_CASE(RR)                                                                       \
  case RR:                                                                                   \
    return (int)run_large<RR>(steps, mi, sy, c, mo, mt, w, g, of, mn, nmins, K, low, hl, B, \
                              T_sym, t0, nl, rn, wsb, wst, gsb, gst, s);
  switch (R) {
    LARGE_CASE(1) LARGE_CASE(2) LARGE_CASE(3) LARGE_CASE(4)
    LARGE_CASE(5) LARGE_CASE(6) LARGE_CASE(7) LARGE_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef LARGE_CASE
}

}  // extern "C"
