// Depth-4 and depth-8 state-blocked Viterbi kernels for large R <= 2
// trellises (K = 10..24) on Hopper (sm_90a), bound to Python with ctypes
// through the plain extern "C" launcher at the end of this file.
//
//   acs_large_octet_kernel<R, kWords, *>  replaces ops/pallas/large_k4.py acs_update_large4
//   acs_large_octet_kernel<R, kF4, *>     replaces ops/pallas/large_k4.py acs_update_large4_fields
//   acs_large_octet_kernel<R, kF8, *>     replaces ops/pallas/large_k4.py acs_update_large4_fields8
//   (all three are the JAX package's _quad_kernel with want_fields / want_f8)
//   acs_large_octet_kernel<R, kWords, *>  also ops/pallas/large_k.py acs_update_large where
//                                         a frame streams at R <= 2 (K >= 18): octets with
//                                         the entry shift only (ops/cuda/large_k.py plan)
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
// What bounds it on the card.  At K=24 (ICE) a frame holds 2^23 int32
// metrics, 32 MiB, so B=8 is 268 MB and cannot stay on chip (50 MB of L2):
// every pass through the trellis reads and writes all of them, 537 MB, 160
// us at 3.35 TB/s.  The quad kernel this replaces took 234-269 us a pass of 4
// steps, but not for its traffic: at some 20 instructions a state and step
// it was bound by instruction issue.  So the design cuts instructions and
// takes more steps a pass: an octet (8 steps) a pass, one table look-up a
// butterfly (the complement form), decisions as signs pushed into a word by
// a funnel shift, words by a transposition across lanes; and it overlaps
// the traffic with the arithmetic by staging the next tile's metrics in
// shared memory (cp.async) while a block computes the current one.
//
// The quad (4 steps).  Thread p (0 <= p < S/16) owns the sixteen predecessors
// p + k*S/16 and keeps all four levels in registers, sixteen values alive at
// each:
//
//   level 1 (step t):   groups m, m+8  -> states  2p + k1 + m*S/8, m < 8
//   level 2 (step t+1): groups m, m+4  -> states  4p + k2 + m*S/4, m < 4
//   level 3 (step t+2): groups m, m+2  -> states  8p + k3 + m*S/2, m < 2
//   level 4 (step t+3): groups 0, 1    -> states 16p + k4
//
// with k_l = 2 k_{l-1} + b_l the input bits so far.
//
// The octet (8 steps, one read and one write of the metrics).  The 256
// predecessors {g + k*S/256 : k < 256} (0 <= g < S/256) are closed under 8
// steps; their finals are 256g .. 256g+255.  Steps 1-4 are 16 quads: quad a
// is p = g + a*S/256, its finals 16g + a*S/16 + j (j < 16).  One transpose
// through shared memory regroups them into the 16 quads of steps 5-8: quad j
// is p = 16g + j, whose predecessors 16g + j + a*S/16 are element j of every
// first-half quad a.  A tile is G = min(32, S/256) octets, a block 16G
// threads: in the first half thread a*G + i runs quad a of octet g0 + i, so a
// warp holds 32 consecutive p at each k (G = 32, or the whole frame when G <
// 32: K < 14); in the second half thread 16i + j runs quad j of octet g0 + i,
// again 32 consecutive p a warp.  (With 8 or 16 octets a block a warp's
// first-half quads would not be consecutive, which the words form needs.)
// The tile's metrics arrive by cp.async as [256][G] (row k: the G
// predecessors at k S/256); once read, that buffer holds the transpose
// [G][256], swizzled: element (i, j, a) at 256 i + ((16 j + a) ^ i ^ 2 (j >>
// 1)), so the first half's stores (a warp = 32 octets at one a) and the
// second half's loads (a warp = 2 octets x 16 j) meet 32 distinct banks.
// Blocks are persistent (as many as fit the card, two an SM) and take the
// B S/(256 G) tiles in turn, two staging buffers a block.  The finals leave
// as four 16-byte stores a thread.
//
// A call of n quads runs n / 2 octets and, for odd n, one lone quad at the
// end; three more steps (the words form) join the last quad as one 7-step
// launch, a quad and a tri (three levels, finals 8p + k3 + m S/2), or run
// alone as a tri.  A lone quad or tri is a plain launch, thread p the quad p.
//
// Branch penalties: the R parities of the low predecessor's index select an
// entry of the step's 2^R-entry table of penalty sums in shared memory.  The
// index of level l is (p << (l-1)) + k_{l-1} + m * (S >> (5-l)), three
// disjoint bit fields, and parity is linear, so a thread forms one table
// address per level and XORs uniform constants (Quad) for k and m.  Where
// every polynomial taps both register ends (all six reference codes) one
// look-up serves a butterfly's four branches (viterbi_large.cuh bfly).
//
// Words form: a level's 16 decisions a thread are 16 bits; store_words
// (viterbi_large.cuh) transposes them across the warp's lanes into the
// canonical words, 4 - L shuffles and one join at level L.
//
// Fields forms write no words.  Each level carries the survivor's path bits,
// pf_l = (pf_{l-1}[winner] << 1) | d_l, from pf_0 = 0.  f4: each half of an
// octet writes its own window, four nibbles in each of the four planes k4 & 3
// (two threads make a word).  f8: the 4-bit fields of the first half ride a
// second transpose buffer and seed the second half, whose 8-bit fields are
// four whole words, plane 4 (p & 1) + (k4 >> 2), word p >> 1.
//
// Renormalisation.  The JAX package shifts every frame to a minimum of zero
// at entry and after every rn-th quad (counted within the call).  The ACS
// commutes with a uniform shift and the metrics are int32, so a launch
// subtracts a pending shift as it reads and adds it to the offset; a shift
// that falls inside a launch is taken as the frame minimum at the latest
// such point (the transpose or the end: a block minimum, then atomicMin into
// the frame's slot) and left pending for the next launch, or for
// frame_sub_kernel after the last.  Two shifts inside one launch sum to the
// later point's minimum, so one slot a launch is enough.
//
// Tie rule: a decision is c_hi < c_lo, strict; ties keep the low predecessor
// (ops/pallas/large_k4.py:210).

#include "viterbi_large.cuh"

namespace {

enum Mode { kWords = 0, kF4 = 1, kF8 = 2 };
constexpr int kOctGroups = 32;   // octets a block (fewer below K=14)
constexpr int kOctThreads = 16 * kOctGroups;  // 512

struct Quad {
  int par_k[8];     // parities of k, k < 8
  int par_m[4][8];  // par_m[l][m]: parities of m * (S >> (4 - l)), group m of level l + 1
};

// Level L of the quad: `in` holds (16 >> (L-1)) groups of 2^(L-1) values at
// index (m << (L-1)) | k; group m pairs with group m + (16 >> L).  qa: the
// address of the level's table entry at the parities of the low predecessor
// p << (L-1) XOR km[0].  Returns the level's decisions, bit j for output j =
// (m << L) | (k << 1) | b.  Fields: pf_out = (pf_in[winner] << 1) | d.
template <int L, int MODE, bool COMP>
__device__ __forceinline__ unsigned quad_level(const int* in, int* out, const int* pf_in,
                                               int* pf_out, saddr_t qa, int comp, const Code& c,
                                               const Quad& qd) {
  constexpr int G = 16 >> L, KP = 1 << (L - 1);
  unsigned bits = 0;
#pragma unroll
  for (int m = G - 1; m >= 0; --m)
#pragma unroll
    for (int k = KP - 1; k >= 0; --k) {
      const int lo = m * KP + k, hi = (m + G) * KP + k, o = (m * KP + k) * 2;
      int diff[2];
      bfly<COMP>(in[lo], in[hi], qa ^ ((qd.par_k[k] ^ qd.par_m[L - 1][m]) << 2), comp, c,
                 out + o, diff);
      bits = push_bit(push_bit(bits, diff[1]), diff[0]);
      if (MODE != kWords) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int sel = diff[b] >> 31;  // all ones where the high predecessor survives
          pf_out[o + b] = ((pf_in[lo] & ~sel) | (pf_in[hi] & sel)) * 2 - sel;
        }
      }
    }
  return bits;
}

// The block's minimum of every thread's v[0..15], atomicMin'd into *dst.
// Holds a barrier: call it uniformly.
__device__ __forceinline__ void block_min(const int* v, int* wmin, int* dst) {
  int x = v[0];
#pragma unroll
  for (int k = 1; k < 16; ++k) x = min(x, v[k]);
  x = __reduce_min_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < (blockDim.x >> 5) ? wmin[threadIdx.x] : INT_MAX;
    x = __reduce_min_sync(0xffffffffu, x);
    if (threadIdx.x == 0) atomicMin(dst, x);
  }
}

// The first NLEV levels (4: a quad, 3: a tri) of quad p from v0 / f0
// (predecessors p + k S/16); the finals end in v0 / f0: 16p + k4 (NLEV 4),
// or 8p + k3 + m S/2 at index 8m + k3 (NLEV 3).  Words form: level l's words
// at wt + l ost.  mn (null for none): the frame minimum of the values before
// the last level is atomicMin'd there (holds a barrier; uniform).  sh: a
// shift the first table (q[0]) holds subtracted from its entries.
template <int R, int MODE, bool COMP, int NLEV>
__device__ __forceinline__ void quad(int* v0, int* v1, int* f0, int* f1, int p,
                                     int (*q)[1 << R], const Code& c, const Quad& qd,
                                     int* wt, long long ost, int W, int* wmin, int* mn,
                                     int sh = 0) {
  const int lane = threadIdx.x & 31, w = p >> 5;
  unsigned d;
  d = quad_level<1, MODE, COMP>(v0, v1, f0, f1, entry(q[0], p, c, R), c.comp - 2 * sh, c, qd);
  if (MODE == kWords) store_words<1>(d, wt, lane, w, W);
  d = quad_level<2, MODE, COMP>(v1, v0, f1, f0, entry(q[1], 2 * p, c, R), c.comp,
                                c, qd);
  if (MODE == kWords) store_words<2>(d, wt + ost, lane, w, W);
  if (NLEV == 3 && mn != nullptr) block_min(v0, wmin, mn);
  d = quad_level<3, MODE, COMP>(v0, v1, f0, f1, entry(q[2], 4 * p, c, R), c.comp,
                                c, qd);
  if (MODE == kWords) store_words<3>(d, wt + 2 * ost, lane, w, W);
  if (NLEV == 3) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v0[k] = v1[k];
      f0[k] = f1[k];
    }
    return;
  }
  if (mn != nullptr) block_min(v1, wmin, mn);
  d = quad_level<4, MODE, COMP>(v1, v0, f1, f0, entry(q[3], 8 * p, c, R), c.comp,
                                c, qd);
  if (MODE == kWords) store_words<4>(d, wt + 3 * ost, lane, w, W);
}

// The finals of quad p after NLEV levels (v as `quad` leaves it) to frame m.
template <int NLEV>
__device__ __forceinline__ void store_finals(const int* v, int* m, int p, int S) {
  int4* a = reinterpret_cast<int4*>(m + (NLEV == 4 ? 16 * (size_t)p : 8 * (size_t)p));
  int4* b = NLEV == 4 ? a + 2 : reinterpret_cast<int4*>(m + (S >> 1) + 8 * (size_t)p);
  a[0] = make_int4(v[0], v[1], v[2], v[3]);
  a[1] = make_int4(v[4], v[5], v[6], v[7]);
  b[0] = make_int4(v[8], v[9], v[10], v[11]);
  b[1] = make_int4(v[12], v[13], v[14], v[15]);
}

// f4 window of quad p: final 16p + k4 in nibble 4 (p & 1) + (k4 >> 2) of word
// (plane k4 & 3, p >> 1); p and p ^ 1 are neighbouring lanes.
__device__ __forceinline__ void store_f4(const int* f, int p, int* wt, long long ost) {
#pragma unroll
  for (int pl = 0; pl < 4; ++pl) {
    unsigned x = 0;
#pragma unroll
    for (int h = 0; h < 4; ++h) x |= (unsigned)f[4 * h + pl] << (4 * h);
    x <<= 16 * (p & 1);
    x |= __shfl_xor_sync(0xffffffffu, x, 1);
    if ((p & 1) == 0) wt[pl * ost + (p >> 1)] = (int)x;
  }
}

// The f8 window of quad p: final 16p + k4 in byte k4 & 3 of word (plane 4 (p
// & 1) + (k4 >> 2), p >> 1).
__device__ __forceinline__ void store_f8(const int* f, int p, int* wt, long long ost) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const unsigned x = (unsigned)f[4 * h] | ((unsigned)f[4 * h + 1] << 8) |
                       ((unsigned)f[4 * h + 2] << 16) | ((unsigned)f[4 * h + 3] << 24);
    wt[(4 * (p & 1) + h) * ost + (p >> 1)] = (int)x;
  }
}

// Stage tile `tile` (G octets of frame tile / tiles from octet g0) into st
// [256][G]: row k holds predecessors g0 .. g0+G-1 + k S/256.  With G < 32
// the tile is the whole frame and rows are contiguous.
__device__ __forceinline__ void stage_tile(const int* m_in, int* st, int tile, int tiles, int S,
                                           int G, int lg) {
  const int b = tile / tiles;
  const int* m = m_in + (size_t)b * S + (tile - b * tiles) * G;
  for (int f = 4 * threadIdx.x; f < 256 * G; f += 4 * blockDim.x)
    cp_async16(st + f, m + (f >> lg) * (S >> 8) + (f & (G - 1)));
  cp_async_commit();
}

// A lone quad (NLEV 4) or tri (NLEV 3, words form) launch: grid (S/16 /
// threads, B), thread p the quad p, no staging (small blocks with few
// registers keep more of the traffic in flight than the persistent kernel
// does for a lone half).  Arguments as the octet kernel; mn_at 2 takes the
// frame minimum at the end, 3 before the last step, into mn[b].
template <int R, int MODE, bool COMP, int NLEV>
__global__ void __launch_bounds__(kThreads)
acs_large_quad_kernel(const int* __restrict__ m_in, int* __restrict__ m_out,
                      const int* __restrict__ sym, int* __restrict__ out,
                      const int* __restrict__ sub, int* __restrict__ off, int* __restrict__ mn,
                      int mn_at, Code c, Quad qd, int K, int low, int hl, int T_sym, int t,
                      long long osb, long long ost) {
  __shared__ __align__(16) int q[4][1 << R];
  __shared__ int wmin[kThreads / 32];
  const int S = 1 << (K - 1), S16 = S >> 4, W = S >> 5;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int* y = sym + ((size_t)b * T_sym + t) * R;
#pragma unroll
  for (int l = 0; l < NLEV; ++l) build_table<R>(q[l], y + l * R, low, hl, tid, blockDim.x);
  const int p = blockIdx.x * blockDim.x + tid;
  const int* m = m_in + (size_t)b * S;
  const int sh = sub ? sub[b] : 0;
  if (sub && blockIdx.x == 0 && tid == 0) off[b] += sh;
  int v0[16], v1[16], f0[16], f1[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    v0[k] = m[p + k * S16] - sh;
    f0[k] = 0;
  }
  __syncthreads();
  int* wt = out + (size_t)b * osb;
  quad<R, MODE, COMP, NLEV>(v0, v1, f0, f1, p, q, c, qd, wt, ost, W, wmin,
                            mn_at == 3 ? mn + b : nullptr);
  if (MODE == kF4) store_f4(f0, p, wt, ost);
  store_finals<NLEV>(v0, m_out + (size_t)b * S, p, S);
  if (mn_at == 2) block_min(v0, wmin, mn + b);
}

// One launch of 4 + NL2 steps, persistent: an octet (NL2 4) or a quad and a
// tri (NL2 3, words form).  16G threads a block, G = min(32, S/256) octets a tile, B S/(256
// G) tiles taken in turn by the blocks of the grid.  Each tile's metrics are
// staged in shared memory by cp.async while the block computes the tile
// before it, so the metric traffic overlaps the arithmetic.  Dynamic shared
// memory: two staging buffers of 256 G ints (the current one, once read, is
// the transpose buffer), and in kF8 one more for the fields' transpose.  The
// step tables of a tile are built by NS 2^R threads from symbols loaded a
// tile ahead.  `out`: kWords, the words of step t (frame 0); kF4 / kF8, the
// launch's first table window (kF4: two windows an octet).  osb: frame
// stride (wsb; W for a table).  ost: step stride wst, or the plane stride B *
// W of a table.  sub: the pending shift, subtracted at the read (null: none).
// mn_at 1 takes the frame minimum at the transpose, 2 at the end, 3 before
// the last step, into mn[b].
template <int R, int MODE, bool COMP, int NL2>
__global__ void __launch_bounds__(kOctThreads, 2)
acs_large_octet_kernel(const int* __restrict__ m_in, int* __restrict__ m_out,
                       const int* __restrict__ sym, int* __restrict__ out,
                       const int* __restrict__ sub, int* __restrict__ off, int* __restrict__ mn,
                       int mn_at, Code c, Quad qd, int K, int low, int hl, int B, int T_sym, int t,
                       long long osb, long long ost) {
  constexpr int NS = 4 + NL2;                    // steps a launch
  __shared__ __align__(16) int q[2][8][1 << R];  // a tile's step tables, by tile parity
  __shared__ int wmin[kOctThreads / 32];
  extern __shared__ int4 smem4[];
  // The buffers from the first 1 KB boundary (the launch gives 1 KB more).
  int* const smem = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) +
                                           ((1024 - (saddr(smem4) & 1023)) & 1023));
  const int S = 1 << (K - 1), W = S >> 5;
  const int tid = threadIdx.x, G = blockDim.x >> 4, lg = __ffs(G) - 1;
  const int tiles = (S >> 8) / G, ntiles = B * tiles;
  const int i = tid & (G - 1), a = tid >> lg;  // first half: quad a of octet i
  // Transpose element (i, j, a) at 256 i + ((16 j + a) ^ i ^ 2 (j >> 1)), i < 32.
  const int wbase = 256 * i + (a ^ i);
  const int rbase = 256 * (tid >> 4) + ((16 * (tid & 15)) ^ (tid >> 4) ^ (((tid & 15) >> 1) << 1));
  int* const xf = smem + 512 * G;  // kF8: the fields' transpose buffer
  const bool builder = tid < (NS << R);
  const int bl = tid >> R, be = tid & ((1 << R) - 1);
  int yb[R];

  int tile = blockIdx.x;
  stage_tile(m_in, smem, tile, tiles, S, G, lg);
  if (builder) {
#pragma unroll
    for (int r = 0; r < R; ++r) yb[r] = sym[((size_t)(tile / tiles) * T_sym + t + bl) * R + r];
  }
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int b = tile / tiles, g0 = (tile - b * tiles) * G;
    const int sh = sub ? sub[b] : 0;
    if (builder) {  // the first step's table holds the pending shift subtracted
      int v = bl == 0 ? -sh : 0;
#pragma unroll
      for (int r = 0; r < R; ++r) v += (yb[r] - low) + (((be >> r) & 1) ? hl - 2 * yb[r] : 0);
      q[it & 1][bl][be] = v;
    }
    cp_async_wait_all();
    __syncthreads();
    const int next = tile + gridDim.x;
    if (next < ntiles) {
      stage_tile(m_in, smem + ((it + 1) & 1) * 256 * G, next, tiles, S, G, lg);
      if (builder) {
#pragma unroll
        for (int r = 0; r < R; ++r) yb[r] = sym[((size_t)(next / tiles) * T_sym + t + bl) * R + r];
      }
    }
    if (sub && g0 == 0 && tid == 0) off[b] += sh;
    int* const st = smem + (it & 1) * 256 * G;
    int v0[16], v1[16], f0[16], f1[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v0[k] = st[(a + 16 * k) * G + i];
      f0[k] = 0;
    }
    __syncthreads();  // the stage is read: it becomes the transpose buffer

    int* wt = out + (size_t)b * osb;
    int p = g0 + i + a * (S >> 8);
    quad<R, MODE, COMP, 4>(v0, v1, f0, f1, p, q[it & 1], c, qd, wt, ost, W, wmin, nullptr, sh);
    if (MODE == kF4) store_f4(f0, p, wt, ost);
    if (mn_at == 1) block_min(v0, wmin, mn + b);
    // The buffers are 1 KB-aligned and the swizzle's XOR touches the low 10
    // bits, so it acts on the address.
    const saddr_t wa = saddr(st) + (wbase << 2), wf = saddr(xf) + (wbase << 2);
#pragma unroll
    for (int j = 0; j < 16; ++j) sts(wa ^ ((16 * j ^ ((j >> 1) << 1)) << 2), v0[j]);
    if (MODE == kF8) {
#pragma unroll
      for (int j = 0; j < 16; ++j) sts(wf ^ ((16 * j ^ ((j >> 1) << 1)) << 2), f0[j]);
    }
    __syncthreads();
    p = 16 * g0 + tid;  // = 16 (g0 + i2) + j2: quad j2 of octet i2 = tid / 16
    const saddr_t ra = saddr(st) + (rbase << 2), rf = saddr(xf) + (rbase << 2);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v0[k] = lds(ra ^ (k << 2));
      f0[k] = MODE == kF8 ? lds(rf ^ (k << 2)) : 0;
    }
    quad<R, MODE, COMP, NL2>(v0, v1, f0, f1, p, q[it & 1] + 4, c, qd, wt + 4 * ost, ost, W, wmin,
                             mn_at == 3 ? mn + b : nullptr);
    if (MODE == kF4) store_f4(f0, p, wt + 4 * ost, ost);
    if (MODE == kF8) store_f8(f0, p, wt, ost);
    store_finals<NL2>(v0, m_out + (size_t)b * S, p, S);
    if (mn_at == 2) block_min(v0, wmin, mn + b);
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

// One launch of NS steps (3: a lone tri, 4: a lone quad, 7: a quad and a
// tri, 8: an octet) from step t; `out`, osb, ost, sub, mn, mn_at as the
// kernel takes them.
template <int R, int MODE, bool COMP, int NS>
cudaError_t launch_one(const int* src, int* dst, const int* sym, int* o, const int* sub, int* off,
                       int* mn, int mn_at, const Code& c, const Quad& qd, int K, int low, int hl,
                       int B, int T_sym, int t, long long osb, long long ost, cudaStream_t s) {
  const int S = 1 << (K - 1);
  if constexpr (NS <= 4) {
    const int threads = (S >> 4) < kThreads ? (S >> 4) : kThreads;
    acs_large_quad_kernel<R, MODE, COMP, NS><<<dim3((S >> 4) / threads, B), threads, 0, s>>>(
        src, dst, sym, o, sub, off, mn, mn_at, c, qd, K, low, hl, T_sym, t, osb, ost);
    return cudaGetLastError();
  } else {
    const int G = (S >> 8) < kOctGroups ? (S >> 8) : kOctGroups;
    const int threads = 16 * G, ntiles = B * ((S >> 8) / G);
    const int smem = (MODE == kF8 ? 3 : 2) * 256 * G * (int)sizeof(int) + 1024;
    auto kernel = acs_large_octet_kernel<R, MODE, COMP, NS - 4>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int blocks = ntiles < sms * per_sm ? ntiles : sms * per_sm;
    kernel<<<blocks, threads, smem, s>>>(src, dst, sym, o, sub, off, mn, mn_at, c, qd, K, low, hl,
                                         B, T_sym, t, osb, ost);
    return cudaGetLastError();
  }
}

// The launch loop: nq quads from step t0, then `tail` (0 or 3) more steps,
// on ping-pong metric buffers, the ending launch writing m_out.  Launches:
// octets, a lone quad for an odd number of quads, and with tail 3 the last
// quad and the tail as one 7-step octet (or, with no quad, a lone tri).
// Shifts: the pending one at the first read is `entry` (null: the frame
// minimum of m_in into row 0 of `mins`, or none with nmins = 0); then one
// row of `mins` for each launch that holds a shift point (after quad j with
// rn && j % rn == rn - 1: the latest point of the launch), subtracted as
// the next launch reads or by frame_sub_kernel after the last.  fin (rn 0):
// 2 takes the frame minimum of the final metrics into `fmin`, left for the
// caller (the entry shift of a remainder after the quads); 3 (with the tail)
// the minimum before the last step, subtracted by frame_sub_kernel.  fresh: the entry minimum's pass zeroes
// `off` (a call's first launch).  m_tmp is read only where there are two
// launches or more.  mode kWords writes words; kF4 writes f4 window j (quad j)
// at tab + j * 4 B W; kF8 (even nq) writes f8 window j / 2 at tab + (j / 2)
// * 8 B W.
template <int R>
cudaError_t run_quads(int mode, const int* m_in, const int* sym, const Code& c, const Quad& qd,
                      int* m_out, int* m_tmp, int* tab, int* off, int* mins, int nmins,
                      const int* entry, int* fmin, int fin, int fresh, int K, int low, int hl, int B,
                      int T_sym, int t0, int nq, int tail, int rn, long long wsb, long long wst,
                      cudaStream_t s) {
  const int S = 1 << (K - 1), W = S >> 5;
  const long long plane = (long long)B * W;
  // Launch j covers quads [q0, q0 + n); with the tail, the last launch is n
  // quads and 3 steps (n = 0 or 1).
  const int lq = tail ? (nq > 0 ? nq - 1 : 0) : nq;  // quads before the tail launch
  const int nl = lq / 2 + lq % 2 + (tail ? 1 : 0);
  int row = 0;
  cudaError_t err = cudaSuccess;
  const int* sub = entry;
  if (sub == nullptr && nmins > 0) {
    err = frame_min(m_in, S, B, mins, fresh ? off : nullptr, s);
    if (err != cudaSuccess) return err;
    sub = mins + (size_t)B * row++;
  }
  const int* src = m_in;
  int* dst = m_out;
  auto shift_after = [&](int j) { return rn > 0 && j % rn == rn - 1; };
  for (int j = 0, q0 = 0; j < nl; ++j) {
    const bool last = j == nl - 1;
    const int n = (tail && last) ? nq - q0 : (q0 + 2 <= lq ? 2 : 1);
    dst = ((nl - 1 - j) % 2 == 0) ? m_out : m_tmp;
    const int t = t0 + 4 * q0;
    int at = shift_after(q0 + n - 1) ? 2 : (n == 2 && shift_after(q0) ? 1 : 0);
    int* mn = nullptr;
    if (last && fin) {
      at = fin;
      mn = fmin;
    } else if (at) {
      if (row >= nmins) return cudaErrorInvalidValue;
      mn = mins + (size_t)B * row++;
    }
    int* o;
    long long osb = W, ost = plane;
    if (mode == kWords) {
      o = tab + (size_t)t * wst;
      osb = wsb;
      ost = wst;
    } else if (mode == kF4) {
      o = tab + (size_t)q0 * 4 * plane;
    } else {
      o = tab + (size_t)(q0 / 2) * 8 * plane;
    }
#define LAUNCH(MODE, NS)                                                                     \
  (c.complement ? launch_one<R, MODE, true, NS>(src, dst, sym, o, sub, off, mn, at, c, qd, K,   \
                                                low, hl, B, T_sym, t, osb, ost, s)             \
                : launch_one<R, MODE, false, NS>(src, dst, sym, o, sub, off, mn, at, c, qd, K,  \
                                                 low, hl, B, T_sym, t, osb, ost, s))
    if (tail && last)
      err = n == 1 ? LAUNCH(kWords, 7) : LAUNCH(kWords, 3);
    else if (mode == kWords)
      err = n == 2 ? LAUNCH(kWords, 8) : LAUNCH(kWords, 4);
    else if (mode == kF4)
      err = n == 2 ? LAUNCH(kF4, 8) : LAUNCH(kF4, 4);
    else
      err = LAUNCH(kF8, 8);
#undef LAUNCH
    if (err != cudaSuccess) return err;
    sub = (last && fin == 2) ? nullptr : mn;
    src = dst;
    q0 += n;
  }
  if (sub != nullptr) {  // a renormalisation in the last launch
    frame_sub_kernel<<<reduce_grid(S, B), kThreads, 0, s>>>(dst, S, sub, off);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// mode 0: words (word (b, t, w) at tab + b * wsb + t * wst + w); 1: f4
// [nq, 4, B, W] at tab; 2: f8 [nq / 2, 8, B, W] at tab (nq even).  nq quads
// from step t0 of the symbols [B, T_sym, R], then `tail` steps (0, or 3 in
// mode 0).  polys, inv, hl as viterbi_acs_large; mins [nmins, B] (INT_MAX)
// as there, nmins = 0 for no shift of its own; rn counts quads.  entry: a [B]
// row holding the pending shift for the first read (null for none given);
// fin, fmin: see run_quads (fin 0: none; fin 2 with rn 0, fin 3 with the
// tail).  fresh: see run_quads (the entry shift taken here).  m_tmp: null
// where the plan is one launch.  Returns the first CUDA error, or 0.
int viterbi_acs_large4(int mode, const void* m_in, const void* sym, const int* polys,
                       void* m_out, void* m_tmp, void* tab, void* off, void* mins, int nmins,
                       const void* entry, void* fmin, int fin, int fresh, int K, int R, int inv,
                       int low, int hl, int B, int T_sym, int t0, int nq, int tail, int rn,
                       long long wsb, long long wst, void* stream) {
  if (mode < kWords || mode > kF8 || K < 10 || K > 24 || R < 1 || R > 2 || B < 1 || B > 65535 ||
      nq < 0 || nq + tail < 1 || (tail != 0 && tail != 3) || (tail && mode != kWords) ||
      nmins < 0 || rn < 0 || (nmins == 0 && rn != 0) || (tail && rn != 0) || fin < 0 ||
      fin == 1 || fin > 3 || (fin == 3 && !tail) || (fin && (rn != 0 || fmin == nullptr)) ||
      (fresh && (entry != nullptr || nmins == 0)) || t0 < 0 || t0 + 4 * nq + tail > T_sym ||
      (mode == kF8 && nq % 2 != 0))
    return (int)cudaErrorInvalidValue;
  const Code c = make_code(polys, K, R, inv, low, hl);
  const Quad qd = make_quad(c, K, R);
  const int* mi = (const int*)m_in;
  const int* sy = (const int*)sym;
  const int* en = (const int*)entry;
  int *mo = (int*)m_out, *mt = (int*)m_tmp, *tb = (int*)tab, *of = (int*)off, *mn = (int*)mins,
      *fm = (int*)fmin;
  const cudaStream_t s = (cudaStream_t)stream;
  if (R == 1)
    return (int)run_quads<1>(mode, mi, sy, c, qd, mo, mt, tb, of, mn, nmins, en, fm, fin, fresh, K,
                             low, hl, B, T_sym, t0, nq, tail, rn, wsb, wst, s);
  return (int)run_quads<2>(mode, mi, sy, c, qd, mo, mt, tb, of, mn, nmins, en, fm, fin, fresh, K,
                           low, hl, B, T_sym, t0, nq, tail, rn, wsb, wst, s);
}

}  // extern "C"
