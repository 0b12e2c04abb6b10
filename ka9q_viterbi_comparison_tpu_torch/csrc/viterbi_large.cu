// State-blocked Viterbi kernels for large trellises (K = 8..24) on Hopper
// (sm_90a), bound to Python with ctypes through the plain extern "C"
// launchers at the end of this file.
//
//   acs_pairs_chip_kernel  replaces ops/pallas/large_k2.py  acs_update_large2 (_pair_kernel)
//                          where a frame's metrics fit on chip (K <= 17), its
//                          odd tail and its optional G_2 radix planes (want_g2)
//                          included; and ops/pallas/large_k.py acs_update_large
//                          (_step_kernel) there: the whole call in one launch,
//                          with no shift but the entry's (tail_shift = 0)
//   acs_large_pair_kernel  the same where they do not (K >= 18: the ICE leads
//                          and remainders), one launch a step pair
//   acs_large_step_kernel  acs_update_large's step where a frame streams, one
//                          launch a step: the odd step after pairs or octets,
//                          every step at K = 7 (ops/cuda/large_k.py plan)
//   frame_min_kernel, frame_sub_kernel (viterbi_large.cuh): the streaming
//     forms' per-frame shift-to-zero renormalisation (block entry and
//     in-scan), which the JAX package does in XLA around its kernels.
//
// Layouts (batch-major, as at the Python wrappers):
//   metrics  [B, S] int32, state order
//   symbols  [B, T, R] int32
//   words    int32 (uint32 bits), bit s % 32 of word s / 32 for new state s;
//            word (b, t, w) at b * wsb + t * wst + w (batch- or time-major)
//   offset   [B] int32, every shift subtracted from a frame's metrics is
//            added here
//
// The pair: thread p (0 <= p < S/4) of frame b owns the predecessor quad
// {p, p + S/4, p + S/2, p + 3S/4}.  Step t makes the intermediates 2p + b1
// (from p, p + S/2) and 2p + S/2 + b1 (from p + S/4, p + 3S/4); step t+1
// pairs 2p + b1 with 2p + b1 + S/2, both held by the same thread, and makes
// the finals 4p .. 4p+3.  No intermediate leaves registers.
//
// What bounds it on the card.  At Cassini (K=15, R=6) B=64 the operations
// (a 2^R-entry penalty table a step, then 6 int32 operations per state and
// step at 16.7 TOP/s) bound a frame's 1031 pairs at 0.78 ms.  One frame is
// 16,384 metrics, 64 KB, and all 64 frames 4 MB, yet one launch a pair with
// the metrics in device memory (the streaming form) paid about 6 us of launch
// and L2 traffic a pair, 1031 launches a frame.  So where a frame fits on
// chip the kernel is persistent: one launch for the whole block of steps, a
// frame's metrics in the shared memory of a cluster of 1-4 blocks (double
// buffered, the predecessors of other blocks read through distributed
// shared memory), one cluster barrier a pair, the renormalisations as cluster
// reductions, the words and G_2 planes straight to device memory at the
// caller's strides.  How many blocks a frame: the caller's choice by shape
// (ops/cuda/large_k2.py chip_blocks), which the launcher checks.
// At K=24 a frame is 32 MiB and cannot stay on chip: there the metric
// traffic (64 MiB a frame a pair) bounds the streaming form, which keeps one
// launch a pair, double-buffered metrics in device memory and the launch
// loop inside the launcher.
//
// Branch penalties: the expected bit of polynomial r for the transition
// from state s2 + h*S/2 with input bit b is parity(s2 & (poly_r >> 1)) ^
// kbit_r(h, b), so a state's R parities (one __popc each, any R) XOR a
// constant mask index a 2^R-entry table of penalty sums built in shared
// memory from the step's symbols.  Parity is linear, so the parities of p +
// S/4 and 2p + 1 follow from those of p and 2p by a constant XOR.
//
// Decision words: one __ballot_sync per candidate over 32 consecutive p,
// then bit spreading, gives each word in the canonical packing directly.
// The G_2 plane of a pair (ops/radix_planes.py) is the step-t decision at the
// predecessor the step-t+1 survivor came from, d1[d2][b1] in the thread's own
// registers, packed like the step-t+1 words.
//
// Tie rule: a decision is c_hi < c_lo, strict; ties keep the low predecessor
// (ops/pallas/large_k2.py:256, ka9q viterbi27_sse2.cpp:155-156).

#include "viterbi_large.cuh"

namespace {

constexpr int kChipThreads = 1024;
constexpr int kChipStates = 16384;  // most states a block of the on-chip form holds (2 x 64 KB)
constexpr int kChipMaxQ = kChipStates / 4 / kChipThreads;  // quads a thread

// Bit i of x (i < 16) to bit 2i.
__device__ __forceinline__ unsigned spread2(unsigned x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// The pair of quad p: predecessors m0..m3 = p + k S/4; qa / qb the
// addresses of the step tables' entries at the parities of p / 2p XOR km[0]
// (tables aligned to their size).  Writes the finals 4p .. 4p+3 to fin and
// the words (and G_2 plane) of both steps.
template <bool COMP>
__device__ __forceinline__ void pair_quad(int m0, int m1, int m2, int m3, saddr_t qa, saddr_t qb,
                                          const Code& c, int* fin, int lane, int w, int W,
                                          int* wt, long long wst, int* gt) {
  // Step t: group g's intermediates 2p + b1 + g*S/2.
  int mid[2][2], d0[2], d1[2], e0[2], e1[2];
  bfly<COMP>(m0, m2, qa, c.comp, c, mid[0], d0);
  bfly<COMP>(m1, m3, qa ^ (c.par_q << 2), c.comp, c, mid[1], d1);
  // Step t+1: intermediate 2p + b1 pairs with 2p + b1 + S/2; finals 4p + 2b1 + b2.
  bfly<COMP>(mid[0][0], mid[1][0], qb, c.comp, c, fin, e0);
  bfly<COMP>(mid[0][1], mid[1][1], qb ^ (c.par_1 << 2), c.comp, c, fin + 2, e1);
  const unsigned v1 = push_bit(push_bit(push_bit(push_bit(0, d1[1]), d1[0]), d0[1]), d0[0]);
  const unsigned v2 = push_bit(push_bit(push_bit(push_bit(0, e1[1]), e1[0]), e0[1]), e0[0]);
  pair_words(v1, v2, lane, w, W, wt, wst, gt);
}

// The words of one step from its decisions (the signs of diff): state 2 s2 +
// b is bit 2(l % 16) + b of word 2w + l/16.
__device__ __forceinline__ void step_words(const int* diff, int s2, int lane, int* wt) {
  const unsigned v0 = __ballot_sync(0xffffffffu, diff[0] < 0);
  const unsigned v1 = __ballot_sync(0xffffffffu, diff[1] < 0);
  if (lane < 2) {
    const unsigned word = spread2(v0 >> (16 * lane)) | (spread2(v1 >> (16 * lane)) << 1);
    wt[2 * (s2 >> 5) + lane] = (int)word;
  }
}

template <int R, bool COMP>
__global__ void __launch_bounds__(kThreads)
acs_large_pair_kernel(const int* __restrict__ m_in, int* __restrict__ m_out,
                      const int* __restrict__ sym, int* __restrict__ words,
                      int* __restrict__ g2, const int* __restrict__ sub, int* __restrict__ off,
                      Code c, int K, int low, int hl, int T_sym, int t, long long wsb,
                      long long wst, long long gsb) {
  __shared__ __align__(1024) int q[2][1 << R];
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

  int fin[4];
  pair_quad<COMP>(m0, m1, m2, m3, entry(q[0], p, c, R), entry(q[1], 2 * p, c, R), c, fin,
                  threadIdx.x & 31, p >> 5, W,
                  words + (size_t)b * wsb + (size_t)t * wst, wst,
                  g2 != nullptr ? g2 + (size_t)b * gsb : nullptr);
  reinterpret_cast<int4*>(m_out + (size_t)b * S)[p] = make_int4(fin[0], fin[1], fin[2], fin[3]);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
acs_large_step_kernel(const int* __restrict__ m_in, int* __restrict__ m_out,
                      const int* __restrict__ sym, int* __restrict__ words,
                      const int* __restrict__ sub, int* __restrict__ off, Code c, int K,
                      int low, int hl, int T_sym, int t, long long wsb, long long wst) {
  __shared__ __align__(1024) int q[1 << R];
  const int S = 1 << (K - 1), S2 = S >> 1;
  const int b = blockIdx.y;
  const int s2 = blockIdx.x * blockDim.x + threadIdx.x;
  build_table<R>(q, sym + ((size_t)b * T_sym + t) * R, low, hl, threadIdx.x, blockDim.x);

  const int* m = m_in + (size_t)b * S;
  const int sh = sub ? sub[b] : 0;
  if (sub && blockIdx.x == 0 && threadIdx.x == 0) off[b] += sh;
  const int lo = m[s2] - sh, hi = m[s2 + S2] - sh;
  __syncthreads();

  int out[2], diff[2];
  bfly<false>(lo, hi, entry(q, s2, c, R), c.comp, c, out, diff);
  reinterpret_cast<int2*>(m_out + (size_t)b * S)[s2] = make_int2(out[0], out[1]);
  step_words(diff, s2, threadIdx.x & 31, words + (size_t)b * wsb + (size_t)t * wst);
}

// What the on-chip kernel needs of its thread-block cluster (CL blocks a
// frame; CL = 1 is a plain block).
template <int CL>
struct Cluster {
  __device__ static int rank() {
    if constexpr (CL == 1) return 0;
    else return (int)cg::this_cluster().block_rank();
  }
  __device__ static void sync() {
    if constexpr (CL == 1) __syncthreads();
    else cg::this_cluster().sync();
  }
  __device__ static int* peer(int* p, int r) {
    if constexpr (CL == 1) return p;
    else return cg::this_cluster().map_shared_rank(p, r);
  }
};

// The frame's minimum of every thread's x over the cluster, through the
// per-warp minima part[ev & 1] of each block.  Holds the cluster barrier:
// call it uniformly.  Slot ev & 1 is written again two events later, after
// an event barrier every reader of this one has passed.
template <int CL>
__device__ __forceinline__ int cluster_min(int x, int (*part)[32], int ev) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  x = __reduce_min_sync(0xffffffffu, x);
  if (lane == 0) part[ev & 1][threadIdx.x >> 5] = x;
  Cluster<CL>::sync();
  int m = INT_MAX;
#pragma unroll
  for (int r = 0; r < CL; ++r)
    m = min(m, lane < nw ? Cluster<CL>::peer(part[ev & 1], r)[lane] : INT_MAX);
  return __reduce_min_sync(0xffffffffu, m);
}

// The on-chip form: one launch for a whole block of T steps of every frame,
// grid (CL, B), CL blocks a frame as one cluster, dynamic shared memory two
// buffers of S / CL ints.  Block r of a frame owns states [r S/CL, (r+1)
// S/CL) and its threads the pair kernel's quads p in [r S/(4CL), (r+1)
// S/(4CL)), whose finals 4p .. 4p+3 are its own; the predecessors p + k S/4
// are read from the block that owns them.  One cluster barrier a pair.  The
// penalty tables of pair i+1 are built during pair i (double-buffered) from
// symbols loaded a pair before that.  Shifts: the entry minimum, the frame
// minimum after pair i with rn && i % rn == rn - 1, each subtracted as the
// next pair reads (or as the final metrics leave); an odd T ends in one step
// with its own entry shift, which with the pending one is the minimum of the
// metrics it reads (tail_shift = 0: none, for acs_update_large, whose only
// shift is the entry's).  fresh: off[b] is written, not added to.
template <int R, int CL, bool COMP>
__global__ void __launch_bounds__(kChipThreads, 1)
acs_pairs_chip_kernel(const int* __restrict__ m_in, int* __restrict__ m_out,
                      const int* __restrict__ sym, int* __restrict__ words,
                      int* __restrict__ g2, int* __restrict__ off, Code c, int K, int low,
                      int hl, int T_sym, int t0, int T, int rn, int fresh, int tail_shift,
                      long long wsb, long long wst, long long gsb, long long gst) {
  extern __shared__ int4 sm4[];    // two metric buffers of S / CL states
  __shared__ __align__(1024) int q[2][2][1 << R];  // penalty tables [pair parity][step of the pair]
  __shared__ int part[2][32];
  const int S = 1 << (K - 1), SB = S / CL, S4 = S >> 2, W = S >> 5;
  const int b = blockIdx.y, tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int rank = Cluster<CL>::rank();
  const int np = T >> 1, nq = (SB >> 2) / nt;
  const int pbase = rank * (SB >> 2) + tid;  // quad k of this thread: pbase + k nt
  int* const sm = reinterpret_cast<int*>(sm4);

  // Table builders: thread x < 2^(R+1) makes entry x & (2^R - 1) of step x >> R
  // from the step's symbols in its registers, loaded a pair ahead (the
  // launcher requires a block of at least 2^(R+1) threads).
  const bool builder = tid < (2 << R);
  const int bs = tid >> R, be = tid & ((1 << R) - 1);
  const int* ys = sym + ((size_t)b * T_sym + t0 + bs) * R;
  int yb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) yb[r] = builder && bs < T ? ys[r] : 0;
  if (builder) {
    int v = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) v += (yb[r] - low) + (((be >> r) & 1) ? hl - 2 * yb[r] : 0);
    q[0][bs][be] = v;
    if (2 + bs < T) {
#pragma unroll
      for (int r = 0; r < R; ++r) yb[r] = ys[2 * R + r];
    }
  }

  // Entry: the block's states into buffer 0; their frame minimum is the entry shift.
  const int4* mf = reinterpret_cast<const int4*>(m_in + (size_t)b * S + (size_t)rank * SB);
  int x = INT_MAX;
  for (int s = tid; s < (SB >> 2); s += nt) {
    const int4 v = mf[s];
    sm4[s] = v;
    x = min(x, min(min(v.x, v.y), min(v.z, v.w)));
  }
  int ev = 0;
  int pend = cluster_min<CL>(x, part, ev++);
  int total = 0;  // every shift applied

  int pk[kChipMaxQ], pk2[kChipMaxQ];
#pragma unroll
  for (int k = 0; k < kChipMaxQ; ++k) {
    pk[k] = parities(pbase + k * nt, c, R) ^ c.km[0];
    pk2[k] = parities(2 * (pbase + k * nt), c, R) ^ c.km[0];
  }

  for (int i = 0; i < np; ++i) {
    const int* cur = sm + (i & 1) * SB;
    int* nxt = sm + ((i + 1) & 1) * SB;
    if (builder) {  // the next pair's tables (or the odd tail's), then the symbols of the one after
      int v = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) v += (yb[r] - low) + (((be >> r) & 1) ? hl - 2 * yb[r] : 0);
      q[(i + 1) & 1][bs][be] = v;
      if (2 * (i + 2) + bs < T) {
#pragma unroll
        for (int r = 0; r < R; ++r) yb[r] = ys[(size_t)(2 * (i + 2)) * R + r];
      }
    }
    const int* src[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int r = (kk * CL) >> 2;
      src[kk] = Cluster<CL>::peer(const_cast<int*>(cur), r) + kk * S4 - r * SB;
    }
    int mv[kChipMaxQ][4];
#pragma unroll
    for (int k = 0; k < kChipMaxQ; ++k)
      if (k < nq) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mv[k][kk] = src[kk][pbase + k * nt] - pend;
      }
    int* wt = words + (size_t)b * wsb + (size_t)(t0 + 2 * i) * wst;
    int* gt = g2 != nullptr ? g2 + (size_t)b * gsb + (size_t)i * gst : nullptr;
    const bool event = rn > 0 && i % rn == rn - 1;
    x = INT_MAX;
#pragma unroll
    for (int k = 0; k < kChipMaxQ; ++k)
      if (k < nq) {
        const int p = pbase + k * nt;
        int fin[4];
        pair_quad<COMP>(mv[k][0], mv[k][1], mv[k][2], mv[k][3], saddr(q[i & 1][0]) | (pk[k] << 2),
                        saddr(q[i & 1][1]) | (pk2[k] << 2), c, fin, lane, p >> 5, W, wt, wst, gt);
        reinterpret_cast<int4*>(nxt)[p - rank * (SB >> 2)] =
            make_int4(fin[0], fin[1], fin[2], fin[3]);
        if (event || i == np - 1) x = min(x, min(min(fin[0], fin[1]), min(fin[2], fin[3])));
      }
    total += pend;
    pend = 0;
    if (event) pend = cluster_min<CL>(x, part, ev++);
    else Cluster<CL>::sync();
  }

  int* fin = sm + (np & 1) * SB;
  if (T & 1) {  // the odd tail: one step, states 2 s2 + b from s2 and s2 + S/2
    if (tail_shift && np > 0 && !(rn > 0 && (np - 1) % rn == rn - 1))
      pend = cluster_min<CL>(x, part, ev++);
    int* nxt = sm + ((np + 1) & 1) * SB;
    int* wt = words + (size_t)b * wsb + (size_t)(t0 + T - 1) * wst;
    for (int s2 = rank * (SB >> 1) + tid; s2 < (rank + 1) * (SB >> 1); s2 += nt) {
      const int hi_s = s2 + (S >> 1);
      const int lo = Cluster<CL>::peer(fin, s2 / SB)[s2 % SB] - pend;
      const int hi = Cluster<CL>::peer(fin, hi_s / SB)[hi_s % SB] - pend;
      int out[2], diff[2];
      bfly<COMP>(lo, hi, entry(q[np & 1][0], s2, c, R), c.comp, c, out, diff);
      reinterpret_cast<int2*>(nxt)[s2 - rank * (SB >> 1)] = make_int2(out[0], out[1]);
      step_words(diff, s2, lane, wt);
    }
    total += pend;
    pend = 0;
    Cluster<CL>::sync();
    fin = nxt;
  }

  int4* mo = reinterpret_cast<int4*>(m_out + (size_t)b * S + (size_t)rank * SB);
  const int4* f4 = reinterpret_cast<const int4*>(fin);
  for (int s = tid; s < (SB >> 2); s += nt) {
    const int4 v = f4[s];
    mo[s] = make_int4(v.x - pend, v.y - pend, v.z - pend, v.w - pend);
  }
  if (rank == 0 && tid == 0) off[b] = (fresh ? 0 : off[b]) + total + pend;
  Cluster<CL>::sync();  // no block leaves while a peer may still read its shared memory
}

template <int R, int CL, bool COMP>
cudaError_t launch_chip(const int* m_in, int* m_out, const int* sym, int* words, int* g2, int* off,
                        const Code& c, int K, int low, int hl, int B, int T_sym, int t0, int T,
                        int rn, int fresh, int tail_shift, long long wsb, long long wst,
                        long long gsb, long long gst, cudaStream_t s) {
  const int SB = (1 << (K - 1)) / CL;
  const int threads = (SB >> 2) < kChipThreads ? (SB >> 2) : kChipThreads;
  const int smem = 2 * SB * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(acs_pairs_chip_kernel<R, CL, COMP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, acs_pairs_chip_kernel<R, CL, COMP>, m_in, m_out, sym, words, g2,
                           off, c, K, low, hl, T_sym, t0, T, rn, fresh, tail_shift, wsb, wst,
                           gsb, gst);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The streaming launch loop shared by the pair and step kernels: `steps`
// trellis steps per launch (2: pair kernel, 1: step kernel), `nl` launches
// from step t0.  Launch j reads the metrics launch j-1 wrote (m_in for j = 0)
// and writes m_out or m_tmp, chosen so that the last launch writes m_out.
// Every pending shift (the block-entry min, then each in-scan
// renormalisation after launch j with rn && j % rn == rn - 1) is taken from
// its own row of `mins` (rows pre-filled with INT_MAX) and subtracted by the
// next launch as it reads.  entry (not null): the entry shift, taken by an
// earlier launch, and every row of `mins` is a renormalisation's.  nmins = 0
// and no entry: no shift at all (rn = 0), for a block whose shifts a later
// one subsumes: the ACS commutes with a uniform shift, so the shifts up to a
// point add up to the frame minimum there.  fresh: the entry minimum's pass
// also zeroes `off` (the call's first launch).  m_tmp is read only for nl > 1.
template <int R>
cudaError_t run_large(int steps, const int* m_in, const int* sym, const Code& c, int* m_out,
                      int* m_tmp, int* words, int* g2, int* off, int* mins, int nmins,
                      const int* entry, int fresh, int K, int low, int hl, int B, int T_sym,
                      int t0, int nl, int rn, long long wsb, long long wst, long long gsb,
                      long long gst, cudaStream_t s) {
  const int S = 1 << (K - 1);
  const int per = S / (steps == 2 ? 4 : 2);  // threads per frame
  const int threads = per < kThreads ? per : kThreads;
  const dim3 grid(per / threads, B);
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
  for (int j = 0; j < nl; ++j) {
    dst = ((nl - 1 - j) % 2 == 0) ? m_out : m_tmp;
    const int t = t0 + steps * j;
    if (steps == 2)
      if (c.complement)
        acs_large_pair_kernel<R, true><<<grid, threads, 0, s>>>(
            src, dst, sym, words, g2 ? g2 + (size_t)j * gst : nullptr, sub, off, c, K, low, hl,
            T_sym, t, wsb, wst, gsb);
      else
        acs_large_pair_kernel<R, false><<<grid, threads, 0, s>>>(
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
      err = frame_min(dst, S, B, mn, nullptr, s);
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
// hl = high + low.  mins: [nmins, B] int32 on the device (frame_min_kernel
// writes each row), one row for the entry shift (unless `entry` holds it)
// and one for each renormalisation (every rn launches; rn = 0 for none);
// nmins = 0 and no entry (with rn = 0): no shift.  entry: a [B] row of the
// entry shift computed earlier (null: none).  fresh (with the entry shift
// taken here): off is zeroed first, not read.  m_tmp: null for nl = 1.
// Words of step t of frame b start at words + b * wsb + t * wst.  g2 (pair
// kernel only; null for none): the G_2 plane of launch j of frame b starts at
// g2 + b * gsb + j * gst.  Returns the first CUDA error, or 0.
int viterbi_acs_large(int steps, const void* m_in, const void* sym, const int* polys,
                      void* m_out, void* m_tmp, void* words, void* g2, void* off, void* mins,
                      int nmins, const void* entry, int fresh, int K, int R, int inv, int low,
                      int hl, int B, int T_sym, int t0, int nl, int rn, long long wsb,
                      long long wst, long long gsb, long long gst, void* stream) {
  const int kmin = steps == 2 ? 8 : 7;  // a full warp of threads per frame
  if ((steps != 1 && steps != 2) || K < kmin || K > 24 || B < 1 || B > 65535 || nl < 1 ||
      nmins < 0 || rn < 0 || (nmins == 0 && rn != 0) || t0 < 0 || t0 + steps * nl > T_sym ||
      (g2 != nullptr && steps != 2) || (fresh && (entry != nullptr || nmins == 0)) ||
      (nl > 1 && m_tmp == nullptr))
    return (int)cudaErrorInvalidValue;
  const Code c = make_code(polys, K, R, inv, low, hl);
  const int* mi = (const int*)m_in;
  const int* sy = (const int*)sym;
  const int* en = (const int*)entry;
  int *mo = (int*)m_out, *mt = (int*)m_tmp, *w = (int*)words, *g = (int*)g2, *of = (int*)off,
      *mn = (int*)mins;
  const cudaStream_t s = (cudaStream_t)stream;
#define LARGE_CASE(RR)                                                                       \
  case RR:                                                                                   \
    return (int)run_large<RR>(steps, mi, sy, c, mo, mt, w, g, of, mn, nmins, en, fresh, K, low, \
                              hl, B, T_sym, t0, nl, rn, wsb, wst, gsb, gst, s);
  switch (R) {
    LARGE_CASE(1) LARGE_CASE(2) LARGE_CASE(3) LARGE_CASE(4)
    LARGE_CASE(5) LARGE_CASE(6) LARGE_CASE(7) LARGE_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef LARGE_CASE
}

// One launch of the on-chip pair kernel for the T steps t0 .. t0 + T of the
// symbols [B, T_sym, R], cl blocks a frame (1, 2 or 4; each block holds S /
// cl <= kChipStates states, and its S / (4 cl) quads, one a thread up to
// kChipThreads, are at least a pair's 2^(R+1) table entries): T / 2 pairs,
// renormalising after every rn-th (rn = 0: never), then for odd T the tail
// step (with its own entry shift when tail_shift is 1, as acs_update_large2
// takes it; 0: none, as acs_update_large); the entry shift first.  Metrics
// m_in -> m_out [B, S]; words of step t of frame b at words + b * wsb + t *
// wst; g2 (null for none): the G_2 plane of pair j at g2 + b * gsb + j * gst;
// off [B] accumulates the shifts (fresh: is set to them).
// polys, inv, hl as viterbi_acs_large.  Returns the first CUDA error, or 0.
int viterbi_acs_large2_chip(const void* m_in, const void* sym, const int* polys, void* m_out,
                            void* words, void* g2, void* off, int cl, int K, int R, int inv,
                            int low, int hl, int B, int T_sym, int t0, int T, int rn, int fresh,
                            int tail_shift, long long wsb, long long wst, long long gsb,
                            long long gst, void* stream) {
  if (K < 8 || K > 24 || (cl != 1 && cl != 2 && cl != 4) || R < 1 || R > 8 ||
      (1 << (K - 1)) / cl > kChipStates || (1 << (K - 1)) / cl / 4 < (2 << R) || B < 1 ||
      B > 65535 || T < 1 || rn < 0 || t0 < 0 || t0 + T > T_sym)
    return (int)cudaErrorInvalidValue;
  const Code c = make_code(polys, K, R, inv, low, hl);
  const int* mi = (const int*)m_in;
  const int* sy = (const int*)sym;
  int *mo = (int*)m_out, *w = (int*)words, *g = (int*)g2, *of = (int*)off;
  const cudaStream_t s = (cudaStream_t)stream;
#define CHIP_CASE(RR, CL)                                                                  \
  if (R == RR && cl == CL)                                                                 \
    return (int)(c.complement                                                              \
                     ? launch_chip<RR, CL, true>(mi, mo, sy, w, g, of, c, K, low, hl, B, T_sym, \
                                                 t0, T, rn, fresh, tail_shift, wsb, wst, gsb, \
                                                 gst, s)                                   \
                     : launch_chip<RR, CL, false>(mi, mo, sy, w, g, of, c, K, low, hl, B, T_sym, \
                                                  t0, T, rn, fresh, tail_shift, wsb, wst, gsb, \
                                                  gst, s));
#define CHIP_R(RR) CHIP_CASE(RR, 1) CHIP_CASE(RR, 2) CHIP_CASE(RR, 4)
  CHIP_R(1) CHIP_R(2) CHIP_R(3) CHIP_R(4) CHIP_R(5) CHIP_R(6) CHIP_R(7) CHIP_R(8)
#undef CHIP_R
#undef CHIP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
