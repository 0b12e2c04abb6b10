// The ka9q- and SPIRAL-exact u8 replicas' update on Hopper (sm_90a), bound to
// Python with ctypes through the extern "C" launcher at the end of this file.
//
//   u8_warp_kernel<K, false>   replaces the jnp scan of ops/quantized.py quantized_update
//                              (ka9q: viterbi27_sse2.cpp's arithmetic)
//   u8_warp_kernel<K, true>    replaces the jnp scan of ops/quantized.py spiral_update
//                              (SPIRAL: spiral27.cpp's arithmetic)
//
// Neither replaces a Pallas kernel: the JAX package writes both replicas as
// one jax.jit over one lax.scan.  The wrapper is ops/cuda/u8.py; the plain
// version, one trellis step a loop iteration, is ops/quantized.py _u8_update.
// Rate 1/2, K = 2..9.
//
// Layouts (what the Python side passes; no copy is made):
//   metrics in   [B, S] uint8, any strides (msb, mss elements)
//   symbols      [B, T, 2] uint8 offset-binary, any strides (ssb, sst, ssr)
//   lanetab      [max(S, 32)] int32, ops/cuda/u8.py lane_table
//   metrics out  [B, S] uint8, contiguous
//   words        [Tp, W, B] int32, W = max(1, S/32): bit s % 32 of word s / 32
//                the decision of state s (1: the HIGH predecessor); rows
//                T .. Tp-1 written zero
//
// What bounds it on the card.  As the int32 state-order warp kernel
// (viterbi_small.cu acs_tb_warp_kernel, whose form this takes): a serial
// recurrence of T steps a frame whose bytes are small, bound on paper by its
// operations and in practice by the latency of one step at about one warp a
// scheduler, so a step costs its instruction count.  The design keeps that
// count near the int32 kernel's:
//
//  * A warp a frame, the frame's metrics in registers in state order: lane
//    n % 32 of register n / 32.  New state n = 2 s2 + b takes its low
//    predecessor s2 and its high one s2 + S/2 by two shuffles from lanes of
//    the host table; word r of a step is the ballot of register r.  Below
//    32 states lanes >= S hold no state of their own: each computes a copy
//    of state n % S (so the frame's minimum needs no mask) and the ballot
//    keeps the low S bits.
//  * Branch values.  The rail tables are 0 or 255, so a butterfly's value is
//    one of four a step, by the 2-bit pattern p = (bt0[s2] & 1) | (bt1[s2] & 1) << 1:
//    v_p = ((x0 + x1 + 1) >> 1) >> shift, x_r = sym_r or 255 - sym_r (SSE's
//    rounding average, then >> 4 for ka9q, >> 2 for SPIRAL).  Lane u of a
//    32-step stage computes step u's four values as the bytes of one word V;
//    a step shuffles V from its lane.  The low branch adds v_p where b = 0
//    and its complement top - v_p where b = 1 (top 15 or 63), the high branch
//    the other one; b = lane & 1 for every register, so a lane takes
//    V or TOP4 - V once a step and one byte_perm a state picks its byte.
//  * ka9q: adds modulo 256, decision (int8_t)(c_lo - c_hi) > 0 (ties to the
//    LOW predecessor), no renormalisation.  The metrics ride in the top byte
//    of a 32-bit register, so the wrap and the signed byte compare are the
//    register's own (byte_perm puts the branch value there).
//  * SPIRAL: saturating adds, min(a + b, 255); decision c_hi <= c_lo (ties
//    to the HIGH predecessor).  min(c_hi, 255) <= c_lo is the same decision
//    as after both clamps (a c_lo above 255 loses to any clamped c_hi), and
//    min(c_lo, that) the same metric, so one clamp a state is enough.  Then
//    a step whose metric[0] (lane 0's first register, by a shuffle: the
//    branch is warp-uniform) exceeds `threshold` subtracts the frame's
//    minimum (__reduce_min_sync) from every metric.  What that costs a step
//    is the check, fired or not: the compiler predicates the subtraction, so
//    the next step waits on it (PERF.md §6).
//  * Symbols: lane u reads step u's two bytes of the next stage while the
//    steps of this one run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kU8Threads = 64;  // two warps a block: a small batch spreads over SMs
constexpr int kU8Stage = 32;    // steps a stage: lane u holds step u's branch values
constexpr int kU8Group = 8;     // steps unrolled a group

// The four branch values of one step as the bytes of a word: byte p = v_p.
template <int SHIFT>
__device__ __forceinline__ unsigned branch_values(unsigned s0, unsigned s1) {
  const unsigned a0 = s0, a1 = 255u - s0, b0 = s1, b1 = 255u - s1;
  return ((a0 + b0 + 1) >> (1 + SHIFT)) | (((a1 + b0 + 1) >> (1 + SHIFT)) << 8) |
         (((a0 + b1 + 1) >> (1 + SHIFT)) << 16) | (((a1 + b1 + 1) >> (1 + SHIFT)) << 24);
}

template <int K, bool SPIRAL>
__global__ void __launch_bounds__(kU8Threads)
u8_warp_kernel(const uint8_t* __restrict__ m_in, long long msb, long long mss,
               const uint8_t* __restrict__ sym, long long ssb, long long sst, long long ssr,
               const int* __restrict__ lanetab, uint8_t* __restrict__ m_out,
               int* __restrict__ dec, int threshold, int B, int T, int Tp) {
  constexpr int S = 1 << (K - 1), NR = S >= 32 ? S / 32 : 1;
  constexpr unsigned TOP = SPIRAL ? 63u : 15u;
  constexpr unsigned TOP4 = TOP * 0x01010101u;
  constexpr unsigned LIVE = S >= 32 ? kFull : (1u << (S & 31)) - 1;  // ballot bits of real states
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (kU8Threads / 32) + (threadIdx.x >> 5);  // this warp's frame
  if (b >= B) return;  // a warp with no frame (whole warps only)

  unsigned m[NR], sel[NR];
  int slo[NR], shi[NR];
  bool odd = false;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int n = 32 * r + lane;
    // pattern | butterfly bit << 2 | low source lane << 16 | high source lane << 24
    const unsigned e = (unsigned)lanetab[n];
    const unsigned p = e & 3;
    odd = (e >> 2) & 1;  // n & 1 = lane & 1: the same for every register
    // ka9q: byte p of the step's word into the top byte; SPIRAL: into byte 0
    // (selector 4: byte 0 of the zero operand).
    sel[r] = SPIRAL ? (0x4440u | p) : (0x0444u | (p << 12));
    slo[r] = (e >> 16) & 0xff;
    shi[r] = e >> 24;
    const unsigned v = m_in[b * msb + (n & (S - 1)) * mss];
    m[r] = SPIRAL ? v : v << 24;
  }

  const uint8_t* ys = sym + b * ssb;
  unsigned y0 = 0, y1 = 0;  // this lane's step of the next stage
  if (lane < T) {
    y0 = ys[lane * sst];
    y1 = ys[lane * sst + ssr];
  }
  int* dp = dec + (size_t)lane * B + b;  // lane r < NR stores word r
  const size_t dstep = (size_t)NR * B;

  auto step = [&](unsigned vs, int u) {
    const unsigned V = __shfl_sync(kFull, vs, u);
    const unsigned Wv = odd ? TOP4 - V : V;  // the low branch's values for this lane's b
    unsigned lo[NR], hi[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      lo[r] = __shfl_sync(kFull, m[NR > 1 ? r >> 1 : 0], slo[r]);
      hi[r] = __shfl_sync(kFull, m[NR > 1 ? (r >> 1) + NR / 2 : 0], shi[r]);
    }
    bool d[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const unsigned la = __byte_perm(Wv, 0, sel[r]);
      const unsigned c_lo = lo[r] + la;
      if (SPIRAL) {
        const unsigned c_hi = min(hi[r] + TOP - la, 255u);
        d[r] = c_hi <= c_lo;
        m[r] = min(c_lo, c_hi);
      } else {
        const unsigned c_hi = hi[r] + (TOP << 24) - la;
        d[r] = (int)(c_lo - c_hi) > 0;
        m[r] = d[r] ? c_hi : c_lo;
      }
    }
    if (SPIRAL && (int)__shfl_sync(kFull, m[0], 0) > threshold) {  // state 0's new metric
      unsigned mn = m[0];
#pragma unroll
      for (int r = 1; r < NR; ++r) mn = min(mn, m[r]);
      mn = __reduce_min_sync(kFull, mn);
#pragma unroll
      for (int r = 0; r < NR; ++r) m[r] -= mn;
    }
    unsigned myword = __ballot_sync(kFull, d[0]) & LIVE;
#pragma unroll
    for (int r = 1; r < NR; ++r) {
      const unsigned word = __ballot_sync(kFull, d[r]);
      if (lane == r) myword = word;
    }
    if (lane < NR) *dp = (int)myword;
    dp += dstep;
  };

  for (int t0 = 0; t0 < T; t0 += kU8Stage) {
    const unsigned vs = branch_values<SPIRAL ? 2 : 4>(y0, y1);
    const int tn = t0 + kU8Stage + lane;
    if (tn < T) {
      y0 = ys[tn * sst];
      y1 = ys[tn * sst + ssr];
    }
    if (T - t0 >= kU8Stage) {
      for (int u0 = 0; u0 < kU8Stage; u0 += kU8Group) {
#pragma unroll
        for (int k = 0; k < kU8Group; ++k) step(vs, u0 + k);
      }
    } else {
      for (int u = 0; u < T - t0; ++u) step(vs, u);
    }
  }
  for (int t = T; t < Tp; ++t) {
    if (lane < NR) *dp = 0;
    dp += dstep;
  }

#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int n = 32 * r + lane;
    if (n < S) m_out[(size_t)b * S + n] = (uint8_t)(SPIRAL ? m[r] : m[r] >> 24);
  }
}

struct U8Args {
  const uint8_t* m_in;
  long long msb, mss;
  const uint8_t* sym;
  long long ssb, sst, ssr;
  const int* lanetab;
  uint8_t* m_out;
  int* dec;
  int threshold, B, T, Tp;
  cudaStream_t stream;
};

template <int K, bool SPIRAL>
cudaError_t launch_u8(const U8Args& a) {
  constexpr int warps = kU8Threads / 32;
  u8_warp_kernel<K, SPIRAL><<<(a.B + warps - 1) / warps, kU8Threads, 0, a.stream>>>(
      a.m_in, a.msb, a.mss, a.sym, a.ssb, a.sst, a.ssr, a.lanetab, a.m_out, a.dec, a.threshold,
      a.B, a.T, a.Tp);
  return cudaGetLastError();
}

template <bool SPIRAL>
cudaError_t u8_dispatch(int K, const U8Args& a) {
  switch (K) {
    case 2: return launch_u8<2, SPIRAL>(a);
    case 3: return launch_u8<3, SPIRAL>(a);
    case 4: return launch_u8<4, SPIRAL>(a);
    case 5: return launch_u8<5, SPIRAL>(a);
    case 6: return launch_u8<6, SPIRAL>(a);
    case 7: return launch_u8<7, SPIRAL>(a);
    case 8: return launch_u8<8, SPIRAL>(a);
    case 9: return launch_u8<9, SPIRAL>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One u8 replica update over T steps of B frames; spiral selects SPIRAL's
// arithmetic (else ka9q's), threshold its renormalisation threshold.
// Tp: rows of `dec`, T <= Tp < T + 32 (rows past T are written zero).
int viterbi_u8(const void* m_in, long long msb, long long mss, const void* sym, long long ssb,
               long long sst, long long ssr, const void* lanetab, void* m_out, void* dec, int K,
               int spiral, int threshold, int B, int T, int Tp, void* stream) {
  if (K < 2 || K > 9 || B < 1 || T < 0 || Tp < T || Tp - T >= kU8Stage)
    return (int)cudaErrorInvalidValue;
  const U8Args a{(const uint8_t*)m_in, msb, mss, (const uint8_t*)sym, ssb, sst, ssr,
                 (const int*)lanetab, (uint8_t*)m_out, (int*)dec, threshold, B, T, Tp,
                 (cudaStream_t)stream};
  return (int)(spiral ? u8_dispatch<true>(K, a) : u8_dispatch<false>(K, a));
}

}  // extern "C"
