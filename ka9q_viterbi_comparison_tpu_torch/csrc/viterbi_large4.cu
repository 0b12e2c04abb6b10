// Depth-4 state-blocked Viterbi kernel for large R <= 2 trellises (K = 10..24)
// on Hopper (sm_90a), bound to Python with ctypes through the plain
// extern "C" launcher at the end of this file.
//
//   acs_large_quad_kernel<R, kWords>  replaces ops/pallas/large_k4.py  acs_update_large4
//   acs_large_quad_kernel<R, kF4>     replaces ops/pallas/large_k4.py  acs_update_large4_fields
//   acs_large_quad_kernel<R, kF8>     (after a kF4 launch) replaces
//                                     ops/pallas/large_k4.py  acs_update_large4_fields8
//   (all three are the JAX package's _quad_kernel with want_fields / want_f8)
//
// Layouts (batch-major, as at the Python wrappers):
//   metrics  [B, S] int32, state order; symbols [B, T, R] int32
//   words    int32 (uint32 bits), bit s % 32 of word s / 32 for new state s;
//            word (b, t, w) at b * wsb + t * wst + w (batch- or time-major)
//   f4       [n, 4, B, W]: the 4-step survivor-path field of state s in
//            nibble (s >> 2) & 7 of word (plane s & 3, s >> 5)
//   f8       [n, 8, B, W]: the 8-step field of state s in byte s & 3 of word
//            (plane (s >> 2) & 7, s >> 5)
//   offset   [B] int32, every shift subtracted from a frame's metrics is
//            added here
//
// One launch runs four trellis steps.  Thread p (0 <= p < S/16) of frame b
// owns the sixteen predecessors p + k*S/16 and keeps all four levels in
// registers, sixteen values alive at each:
//
//   level 1 (step t):   groups m, m+8  -> states  2p + k1 + m*S/8, m < 8
//   level 2 (step t+1): groups m, m+4  -> states  4p + k2 + m*S/4, m < 4
//   level 3 (step t+2): groups m, m+2  -> states  8p + k3 + m*S/2, m < 2
//   level 4 (step t+3): groups 0, 1    -> states 16p + k4
//
// with k_l = 2 k_{l-1} + b_l the input bits so far.  The finals 16p..16p+15
// leave as four 16-byte stores.  Metrics live in device memory between
// launches, double-buffered, and cross it once per four steps.
//
// Branch penalties: as in viterbi_large.cu, the R parities of the low
// predecessor's index select an entry of the step's 2^R-entry table of
// penalty sums in shared memory (four tables a launch).  The index of level
// l is (p << (l-1)) + k_{l-1} + m * (S >> (5-l)), three disjoint bit fields,
// and parity is linear, so a thread takes one parity word per level and XORs
// constants (Quad) for k and m.
//
// Words mode: at level l a thread holds 2^l consecutive decision bits of
// each of its 16 >> l groups; 32 >> l neighbouring threads OR them into a
// word with __shfl_xor_sync and the first of them stores it.
//
// Fields mode writes no words.  Each level carries the survivor's path bits,
// pf_l = (pf_{l-1}[winner] << 1) | d_l; the sixteen 4-bit fields of the finals
// are four nibbles in each of the four planes k4 & 3 (two threads make a
// word).  The kF8 launch seeds pf_0 with the previous quad's f4 field of its
// sixteen predecessors, so its sixteen 8-bit fields are four whole words,
// plane 4 (p & 1) + (k4 >> 2), word p >> 1.
//
// What bounds it on the card: at K=24 the metric traffic, one read and one
// write of B * 32 MiB per launch; the arithmetic (about 7 int32 operations a
// state and step, 9 in fields mode) is of the same order.
//
// Tie rule: a decision is c_hi < c_lo, strict; ties keep the low predecessor
// (ops/pallas/large_k4.py:210).

#include "viterbi_large.cuh"

namespace {

enum Mode { kWords = 0, kF4 = 1, kF8 = 2 };

struct Quad {
  int par_k[8];     // parities of k, k < 8
  int par_m[4][8];  // par_m[l][m]: parities of m * (S >> (4 - l)), group m of level l + 1
};

// Level L of the quad: `in` holds (16 >> (L-1)) groups of 2^(L-1) values at
// index (m << (L-1)) | k; group m pairs with group m + (16 >> L).
template <int L, bool FIELDS>
__device__ __forceinline__ void quad_level(const int* in, int* out, const int* pf_in, int* pf_out,
                                           bool* d, int par_p, const int* q, const Code& c,
                                           const Quad& qd) {
  constexpr int G = 16 >> L, KP = 1 << (L - 1);
#pragma unroll
  for (int m = 0; m < G; ++m)
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int lo = m * KP + k, hi = (m + G) * KP + k, o = (m * KP + k) * 2;
      butterfly(in[lo], in[hi], par_p ^ qd.par_k[k] ^ qd.par_m[L - 1][m], q, c, out + o, d + o);
      if (FIELDS) {
#pragma unroll
        for (int b = 0; b < 2; ++b)
          pf_out[o + b] = ((d[o + b] ? pf_in[hi] : pf_in[lo]) << 1) | (int)d[o + b];
      }
    }
}

// Decision words of level L (step t + L - 1): group m's 2^L bits of this
// thread are bits 2^L (p mod (32 >> L)) .. of word (p >> (5-L)) + m * (W >> (4-L)).
template <int L>
__device__ __forceinline__ void quad_words(const bool* d, int* wt, int p, int W) {
  constexpr int G = 16 >> L, NB = 1 << L, SPAN = 32 >> L;
  const int sub = p & (SPAN - 1);
#pragma unroll
  for (int m = 0; m < G; ++m) {
    unsigned x = 0;
#pragma unroll
    for (int k = 0; k < NB; ++k) x |= (unsigned)d[m * NB + k] << k;
    x <<= NB * sub;
#pragma unroll
    for (int o = 1; o < SPAN; o <<= 1) x |= __shfl_xor_sync(0xffffffffu, x, o);
    if (sub == 0) wt[m * (W >> (4 - L)) + (p >> (5 - L))] = (int)x;
  }
}

// `out`: kWords, the words of step t (frame 0); kF4 / kF8, this window's
// table.  osb: frame stride (wsb; W for a table).  ost: step stride wst, or
// the plane stride B * W of a table.  f4_prev (kF8): the previous quad's f4
// table [4, B, W].
template <int R, int MODE>
__global__ void __launch_bounds__(kThreads)
acs_large_quad_kernel(const int* __restrict__ m_in, int* __restrict__ m_out,
                      const int* __restrict__ sym, int* __restrict__ out,
                      const int* __restrict__ f4_prev, const int* __restrict__ sub,
                      int* __restrict__ off, Code c, Quad qd, int K, int low, int hl, int T_sym,
                      int t, long long osb, long long ost) {
  __shared__ int q[4][1 << R];
  constexpr bool FIELDS = MODE != kWords;
  const int S = 1 << (K - 1), S16 = S >> 4, W = S >> 5;
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int* y = sym + ((size_t)b * T_sym + t) * R;
#pragma unroll
  for (int l = 0; l < 4; ++l) build_table<R>(q[l], y + l * R, low, hl, threadIdx.x, blockDim.x);

  const int* m = m_in + (size_t)b * S;
  const int sh = sub ? sub[b] : 0;
  if (sub && blockIdx.x == 0 && threadIdx.x == 0) off[b] += sh;
  int v0[16], v1[16], f0[16], f1[16];
  bool d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    v0[k] = m[p + k * S16] - sh;
    f0[k] = 0;
  }
  if (MODE == kF8) {
    // The previous quad's field of predecessor s: nibble (s >> 2) & 7 of
    // word (plane s & 3, s >> 5).
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int s = p + k * S16;
      const unsigned word = (unsigned)f4_prev[((size_t)(s & 3) * gridDim.y + b) * W + (s >> 5)];
      f0[k] = (int)((word >> (4 * ((s >> 2) & 7))) & 0xfu);
    }
  }
  __syncthreads();

  int* wt = out + (size_t)b * osb;
  quad_level<1, FIELDS>(v0, v1, f0, f1, d, parities(p, c, R), q[0], c, qd);
  if (MODE == kWords) quad_words<1>(d, wt, p, W);
  quad_level<2, FIELDS>(v1, v0, f1, f0, d, parities(2 * p, c, R), q[1], c, qd);
  if (MODE == kWords) quad_words<2>(d, wt + ost, p, W);
  quad_level<3, FIELDS>(v0, v1, f0, f1, d, parities(4 * p, c, R), q[2], c, qd);
  if (MODE == kWords) quad_words<3>(d, wt + 2 * ost, p, W);
  quad_level<4, FIELDS>(v1, v0, f1, f0, d, parities(8 * p, c, R), q[3], c, qd);
  if (MODE == kWords) quad_words<4>(d, wt + 3 * ost, p, W);

  int4* mo = reinterpret_cast<int4*>(m_out + (size_t)b * S) + 4 * (size_t)p;
#pragma unroll
  for (int j = 0; j < 4; ++j) mo[j] = make_int4(v0[4 * j], v0[4 * j + 1], v0[4 * j + 2], v0[4 * j + 3]);

  if (MODE == kF4) {
    // Final 16p + k4: nibble 4 (p & 1) + (k4 >> 2) of word (plane k4 & 3, p >> 1).
#pragma unroll
    for (int pl = 0; pl < 4; ++pl) {
      unsigned x = 0;
#pragma unroll
      for (int h = 0; h < 4; ++h) x |= (unsigned)f0[4 * h + pl] << (4 * h);
      x <<= 16 * (p & 1);
      x |= __shfl_xor_sync(0xffffffffu, x, 1);
      if ((p & 1) == 0) wt[pl * ost + (p >> 1)] = (int)x;
    }
  }
  if (MODE == kF8) {
    // Final 16p + k4: byte k4 & 3 of word (plane 4 (p & 1) + (k4 >> 2), p >> 1).
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const unsigned x = (unsigned)f0[4 * h] | ((unsigned)f0[4 * h + 1] << 8) |
                         ((unsigned)f0[4 * h + 2] << 16) | ((unsigned)f0[4 * h + 3] << 24);
      wt[(4 * (p & 1) + h) * ost + (p >> 1)] = (int)x;
    }
  }
}

Quad make_quad(const Code& c, int K, int R) {
  Quad qd = {};
  const int S = 1 << (K - 1);
  auto par = [&](int s) {
    int v = 0;
    for (int r = 0; r < R; ++r) v |= (__builtin_popcount(s & c.mask[r]) & 1) << r;
    return v;
  };
  for (int k = 0; k < 8; ++k) qd.par_k[k] = par(k);
  for (int l = 0; l < 4; ++l)
    for (int m = 0; m < (8 >> l); ++m) qd.par_m[l][m] = par(m * (S >> (4 - l)));
  return qd;
}

// The launch loop: nl launches of four steps each from step t0, with the
// ping-pong metric buffers and pending shifts of run_large in
// viterbi_large.cu (rn counts launches).  mode kWords writes words; kF4
// writes f4 window j at tab + j * 4 B W; kF8 runs launch pairs: the even
// launch writes its f4 table to f4_tmp [4, B, W], the odd one reads it and
// writes f8 window j / 2 at tab + (j / 2) * 8 B W.
template <int R>
cudaError_t run_quads(int mode, const int* m_in, const int* sym, const Code& c, const Quad& qd,
                      int* m_out, int* m_tmp, int* tab, int* f4_tmp, int* off, int* mins,
                      int nmins, int K, int low, int hl, int B, int T_sym, int t0, int nl, int rn,
                      long long wsb, long long wst, cudaStream_t s) {
  const int S = 1 << (K - 1), W = S >> 5;
  const int per = S >> 4;  // threads per frame
  const int threads = per < kThreads ? per : kThreads;
  const dim3 grid(per / threads, B);
  const long long plane = (long long)B * W;
  int row = 0;
  cudaError_t err = frame_min(m_in, S, B, mins, s);
  if (err != cudaSuccess) return err;
  const int* sub = mins + (size_t)B * row++;
  const int* src = m_in;
  int* dst = m_out;
  for (int j = 0; j < nl; ++j) {
    dst = ((nl - 1 - j) % 2 == 0) ? m_out : m_tmp;
    const int t = t0 + 4 * j;
    if (mode == kWords)
      acs_large_quad_kernel<R, kWords><<<grid, threads, 0, s>>>(
          src, dst, sym, tab + (size_t)t * wst, nullptr, sub, off, c, qd, K, low, hl, T_sym, t,
          wsb, wst);
    else if (mode == kF4 || j % 2 == 0)
      acs_large_quad_kernel<R, kF4><<<grid, threads, 0, s>>>(
          src, dst, sym, mode == kF4 ? tab + (size_t)j * 4 * plane : f4_tmp, nullptr, sub, off, c,
          qd, K, low, hl, T_sym, t, W, plane);
    else
      acs_large_quad_kernel<R, kF8><<<grid, threads, 0, s>>>(
          src, dst, sym, tab + (size_t)(j / 2) * 8 * plane, f4_tmp, sub, off, c, qd, K, low, hl,
          T_sym, t, W, plane);
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

// mode 0: nl launches writing decision words (word (b, t, w) at tab + b * wsb
// + t * wst + w); 1: nl launches writing f4 [nl, 4, B, W] at tab; 2: nl / 2
// launch pairs writing f8 [nl / 2, 8, B, W] at tab through f4_tmp [4, B, W].
// Steps t0 .. t0 + 4 nl of the symbols [B, T_sym, R].  polys, inv, hl, mins,
// nmins as viterbi_acs_large; rn counts launches.  Returns the first CUDA
// error, or 0.
int viterbi_acs_large4(int mode, const void* m_in, const void* sym, const int* polys,
                       void* m_out, void* m_tmp, void* tab, void* f4_tmp, void* off, void* mins,
                       int nmins, int K, int R, int inv, int low, int hl, int B, int T_sym, int t0,
                       int nl, int rn, long long wsb, long long wst, void* stream) {
  if (mode < kWords || mode > kF8 || K < 10 || K > 24 || R < 1 || R > 2 || B < 1 || B > 65535 ||
      nl < 1 || nmins < 1 || rn < 0 || t0 < 0 || t0 + 4 * nl > T_sym ||
      (mode == kF8 && (nl % 2 != 0 || f4_tmp == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Code c = make_code(polys, K, R, inv);
  const Quad qd = make_quad(c, K, R);
  const int* mi = (const int*)m_in;
  const int* sy = (const int*)sym;
  int *mo = (int*)m_out, *mt = (int*)m_tmp, *tb = (int*)tab, *f4 = (int*)f4_tmp, *of = (int*)off,
      *mn = (int*)mins;
  const cudaStream_t s = (cudaStream_t)stream;
  if (R == 1)
    return (int)run_quads<1>(mode, mi, sy, c, qd, mo, mt, tb, f4, of, mn, nmins, K, low, hl, B,
                             T_sym, t0, nl, rn, wsb, wst, s);
  return (int)run_quads<2>(mode, mi, sy, c, qd, mo, mt, tb, f4, of, mn, nmins, K, low, hl, B,
                           T_sym, t0, nl, rn, wsb, wst, s);
}

}  // extern "C"
