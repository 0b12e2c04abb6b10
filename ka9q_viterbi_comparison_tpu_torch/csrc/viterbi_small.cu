// Whole-frame Viterbi kernels for Hopper (sm_90a): the five kernels of the
// small-trellis decode path, bound to Python with ctypes through the plain
// extern "C" launchers at the end of this file.
//
//   acs_tb_warp_kernel (K <= 9), acs_tb_block_kernel (K = 10..15)
//                                   replace  ops/pallas/kernels.py  acs_update_tb   (_acs_kernel)
//   acs_tb_warp_kernel (K <= 9), acs_tb2_block_kernel (K = 10..13)
//                                   replace  ops/pallas/kernels2.py acs_update_tb2  (_acs_kernel2)
//   chainback_kernel<ROT=false>     replaces ops/pallas/kernels.py  chainback_tb    (_chainback_kernel);
//                                   above K=15 (to 24) it also walks the large-K updates'
//                                   canonical words, which the JAX package walks in jnp
//   acs_inplace_warp_kernel, acs_inplace_block_kernel
//                                   replace  ops/pallas/inplace.py  acs_update_inplace (_acs_inplace_kernel)
//   chainback_kernel<ROT=true>      replaces ops/pallas/inplace.py  chainback_inplace  (_chainback_inplace_kernel)
//
// Layouts are those of the Pallas kernels (state-major, batch last):
//   metrics  [S, B] int32
//   symbols  [Tp, R, B] int32           (Tp >= t_real; steps >= t_real unread)
//   words    [Tp, W, B] int32 (uint32 bits), W = max(1, S/32); the tracebacks read any strides
//   etab     [S/2] int32, bit 8*x + r = transition_tables(code)[x, r, s2]
//   endstate [B] int32
//   bits     [NW, B] int32, bit t%32 of word t/32 = walk output at step t
//
// What bounds them on the card.  The ACS sweep is a serial recurrence over T
// steps per frame; its bytes (symbols in, words out) are small, and at the
// main path's shapes its operation count bounds it on paper.  In practice the
// latency of one step bounds it, at about one warp a scheduler: whatever sits
// between a metric and its successor (a shuffle or a shared-memory round
// trip, two adds, a compare, a barrier) is paid T times and nothing hides it,
// and a lone warp starts only an instruction every four cycles or so.
// The ACS kernels of every route (in-place and state order, K <= 9) are
// built around that: see the notes above WarpAcs and acs_tb_warp_kernel.
// The state-order block forms (acs_tb_block_kernel, acs_tb2_block_kernel)
// serve only K >= 10, which no route sends them: a block a frame, metrics in
// shared memory, symbols staged 32 steps at a time.  The traceback is T dependent steps a
// frame and is bound by the length of that chain alone: see the note above
// the traceback kernels.
//
// Tie rule: a decision is c_hi < c_lo, strict; ties keep the low predecessor
// (ops/pallas/kernels.py:169, ka9q viterbi27_sse2.cpp:155-156).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStage = 32;  // symbol steps staged per shared-memory refill

// Branch penalties of pair s2 for the four (h, b) combos of one step.
template <int R>
__device__ __forceinline__ void penalties(int e, int base, const int* coef, int* pen) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    int p = base;
#pragma unroll
    for (int r = 0; r < R; ++r) p += ((e >> (8 * x + r)) & 1) ? coef[r] : 0;
    pen[x] = p;
  }
}

// Stage symbols of steps [t, t + kStage) of frame b into ssym[u*R + r].
// Loads go up to four at a time into registers before any store, with
// addresses clamped to the frame, so that they are in flight together.
template <int R>
__device__ __forceinline__ void stage_symbols(const int* __restrict__ sym, int* ssym,
                                              int t, int t_real, int B, int b) {
  constexpr int N = kStage * R;
  for (int i0 = threadIdx.x; i0 < N; i0 += 4 * blockDim.x) {
    int v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = min(i0 + k * (int)blockDim.x, N - 1), u = i / R;
      v[k] = sym[((size_t)min(t + u, t_real - 1) * R + (i - u * R)) * B + b];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < N) ssym[i] = v[k];
    }
  }
}

// Pack the per-position decision bytes of one step into W words.
__device__ __forceinline__ void pack_decisions(const unsigned char* dd, int* __restrict__ dec,
                                               int t, int W, int B, int b) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int w = threadIdx.x >> 5; w < W; w += nwarps) {
    const unsigned word = __ballot_sync(0xffffffffu, dd[w * 32 + lane] != 0);
    if (lane == 0) dec[((size_t)t * W + w) * B + b] = (int)word;
  }
}

// Shared-memory carve-up of acs_tb_block_kernel.
struct Smem {
  int* m;             // metrics: 2*S (state order, ping-pong)
  int* et;            // S/2 packed transition table
  int* ssym;          // kStage * R staged symbols
  unsigned char* dd;  // 2 * S32 decision bytes (double-buffered by step parity)
};

__device__ __forceinline__ Smem carve(int nm, int S2, int R, int S32) {
  extern __shared__ int smem[];
  Smem s;
  s.m = smem;
  s.et = s.m + nm;
  s.ssym = s.et + S2;
  s.dd = reinterpret_cast<unsigned char*>(s.ssym + kStage * R);
  for (int i = threadIdx.x; i < 2 * S32; i += blockDim.x) s.dd[i] = 0;
  return s;
}

// State-order ACS, K = 10..15 (counterpart of kernels.py _acs_kernel; K <= 9
// runs acs_tb_warp_kernel).  Grid: one block per frame.  New state 2*s2 + b;
// its decision lands at bit s%32 of word s/32.
template <int R>
__global__ void acs_tb_block_kernel(const int* __restrict__ metrics_in, const int* __restrict__ sym,
                              const int* __restrict__ etab, int* __restrict__ metrics_out,
                              int* __restrict__ dec, int K, int low, int hl, int B,
                              int t_real) {
  const int S = 1 << (K - 1), S2 = S >> 1, W = S >= 32 ? S >> 5 : 1, S32 = W * 32;
  const int b = blockIdx.x;
  Smem sm = carve(2 * S, S2, R, S32);
  for (int s = threadIdx.x; s < S; s += blockDim.x) sm.m[s] = metrics_in[(size_t)s * B + b];
  for (int i = threadIdx.x; i < S2; i += blockDim.x) sm.et[i] = etab[i];

  for (int t = 0; t < t_real; ++t) {
    if ((t % kStage) == 0) {
      __syncthreads();
      stage_symbols<R>(sym, sm.ssym, t, t_real, B, b);
      __syncthreads();
    }
    const int* cur = sm.m + (t & 1) * S;
    int* nxt = sm.m + ((t + 1) & 1) * S;
    unsigned char* dd = sm.dd + (t & 1) * S32;
    const int* y = sm.ssym + (t % kStage) * R;
    int base = 0, coef[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      base += y[r] - low;
      coef[r] = hl - 2 * y[r];
    }
    for (int i = threadIdx.x; i < S2; i += blockDim.x) {
      int pen[4];
      penalties<R>(sm.et[i], base, coef, pen);
      const int lo = cur[i], hi = cur[i + S2];
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int c_lo = lo + pen[bb], c_hi = hi + pen[2 + bb];
        const bool d = c_hi < c_lo;
        nxt[2 * i + bb] = d ? c_hi : c_lo;
        dd[2 * i + bb] = d;
      }
    }
    __syncthreads();
    pack_decisions(dd, dec, t, W, B, b);
  }
  __syncthreads();
  const int* fin = sm.m + (t_real & 1) * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) metrics_out[(size_t)s * B + b] = fin[s];
}

// OR-reduce v over aligned groups of `width` lanes (a power of two <= 32).
// Every lane of the warp must call it.
__device__ __forceinline__ unsigned or_reduce(unsigned v, int width) {
  for (int o = 1; o < width; o <<= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One butterfly of pair entry e: predecessors lo (h=0) and hi (h=1) give new
// states 2*s2 and 2*s2 + 1; returns their two decision bits.
template <int R>
__device__ __forceinline__ unsigned butterfly(int e, int base, const int* coef, int lo, int hi,
                                              int* out) {
  int pen[4];
  penalties<R>(e, base, coef, pen);
  unsigned bits = 0;
#pragma unroll
  for (int bb = 0; bb < 2; ++bb) {
    const int c_lo = lo + pen[bb], c_hi = hi + pen[2 + bb];
    const bool d = c_hi < c_lo;
    out[bb] = d ? c_hi : c_lo;
    bits |= (unsigned)d << bb;
  }
  return bits;
}

// Depth-2 state-order ACS, K = 10..13 (counterpart of kernels2.py
// _acs_kernel2; K <= 9 runs acs_tb_warp_kernel): the contract of
// acs_tb_block_kernel, two steps a loop pass.  Grid: one block per
// frame, S/4 working threads (whole warps; lanes past S/4 only take part in
// the barriers and shuffles, so at K=7 half of the one warp works).  Thread j
// owns predecessors {j, j+S/4, j+S/2, j+3S/4}.  Step A gives it the new
// states 2j, 2j+1 (pair entry j) and 2j+S/2, 2j+S/2+1 (pair entry j+S/4) in
// registers; step B pairs (A[2j+b1], A[2j+b1+S/2]) under pair entry 2j+b1
// and yields the finals 4j..4j+3.  The intermediates never leave registers,
// the finals cross threads through ping-pong metric buffers in shared
// memory, and a pair costs one barrier.  The thread's four table entries are
// loop constants in registers.  Decision words are written per step in
// canonical order: step A's bits lie in two words (states 2j.. and
// 2j+S/2..; one word below 64 states), step B's four are adjacent; lanes
// that share a word OR their bits with shuffles and the first stores.  An
// odd t_real ends with one step A alone, whose states are stored at 2j+b.
template <int R>
__global__ void acs_tb2_block_kernel(const int* __restrict__ metrics_in, const int* __restrict__ sym,
                               const int* __restrict__ etab, int* __restrict__ metrics_out,
                               int* __restrict__ dec, int K, int low, int hl, int B,
                               int t_real) {
  const int S = 1 << (K - 1), S2 = S >> 1, n4 = S >> 2, W = S >= 32 ? S >> 5 : 1;
  const int b = blockIdx.x, j = threadIdx.x;
  const bool active = j < n4;
  extern __shared__ __align__(16) int smem2[];
  int* m = smem2;          // 2 * S metrics, ping-pong by pair
  int* ssym = m + 2 * S;   // kStage * R staged symbols
  for (int s = threadIdx.x; s < S; s += blockDim.x) m[s] = metrics_in[(size_t)s * B + b];
  const int jj = active ? j : 0;
  const int eA0 = etab[jj], eA1 = etab[jj + n4], eB0 = etab[2 * jj], eB1 = etab[2 * jj + 1];
  const int shA = (2 * j) & 31, shB = (4 * j) & 31;

  int cur = 0;
  for (int t = 0; t < t_real; t += 2) {
    if ((t % kStage) == 0) {
      // Every thread is past the barrier that ended the previous pair, so
      // the staged symbols are free to be overwritten.
      stage_symbols<R>(sym, ssym, t, t_real, B, b);
      __syncthreads();
    }
    const bool both = t + 1 < t_real;
    const int* mc = m + cur * S;
    int* mn = m + (cur ^ 1) * S;
    unsigned lo2 = 0, hi2 = 0, nib = 0;
    if (active) {
      const int* y = ssym + (t % kStage) * R;
      int base = 0, coef[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        base += y[r] - low;
        coef[r] = hl - 2 * y[r];
      }
      int a[4];  // A[2j], A[2j+1], A[2j+S/2], A[2j+S/2+1]
      lo2 = butterfly<R>(eA0, base, coef, mc[j], mc[j + S2], a);
      hi2 = butterfly<R>(eA1, base, coef, mc[j + n4], mc[j + n4 + S2], a + 2);
      if (both) {
        y += R;
        base = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          base += y[r] - low;
          coef[r] = hl - 2 * y[r];
        }
        int f[4];  // finals 4j .. 4j+3
        nib = butterfly<R>(eB0, base, coef, a[0], a[2], f);
        nib |= butterfly<R>(eB1, base, coef, a[1], a[3], f + 2) << 2;
        *reinterpret_cast<int4*>(mn + 4 * j) = make_int4(f[0], f[1], f[2], f[3]);
      } else {
        mn[2 * j] = a[0];
        mn[2 * j + 1] = a[1];
        mn[2 * j + S2] = a[2];
        mn[2 * j + S2 + 1] = a[3];
      }
    }
    // Step A's words: sixteen lanes share the word of states 2j.. and the
    // word of states 2j+S/2..
    const unsigned wl = or_reduce(lo2 << shA, 16), wh = or_reduce(hi2 << shA, 16);
    if (active && (j & 15) == 0) {
      int* row = dec + (size_t)t * W * B + b;
      if (S >= 64) {
        row[(size_t)(j >> 4) * B] = (int)wl;
        row[(size_t)((j >> 4) + (W >> 1)) * B] = (int)wh;
      } else {
        row[0] = (int)(wl | (wh << S2));
      }
    }
    if (both) {
      // Step B's words: eight lanes share the word of states 4j..
      const unsigned wb = or_reduce(nib << shB, 8);
      if (active && (j & 7) == 0) dec[((size_t)(t + 1) * W + (j >> 3)) * B + b] = (int)wb;
    }
    __syncthreads();
    cur ^= 1;
  }
  const int* fin = m + cur * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) metrics_out[(size_t)s * B + b] = fin[s];
}

// ---------------------------------------------------------------------------
// In-place ACS with rotating addresses (counterpart of inplace.py
// _acs_inplace_kernel).  At global step t = p0 + local step, state s's metric
// sits at position rotr(s, t mod (K-1)); the butterfly of phase c = t mod (K-1)
// pairs positions q and q | 2^j, j = K-2-c, and writes them back in place.
// Decisions land in position order of step t+1.
//
// What bounds it on this card: not bytes and not the operation count, but
// what one warp can execute between a metric and its successor.  At the main
// path's batches a scheduler holds about one warp (K <= 9), and a lone warp
// was measured to start an instruction every 3.5 to 4.7 cycles whatever their
// dependences: a second frame in the same warp doubles its time.  So the
// step is made of as few instructions as the recurrence allows (some 27 at
// K=7), and everything that does not depend on the metrics is taken out of
// it:
//
//  * A thread owns positions, not butterflies: position p = 32*r + lane, the
//    low five position bits are the lane.  The new metric of p needs its own
//    old metric, its partner's (p ^ 2^j: the thread's own register when bit j
//    is a register bit, one __shfl_xor_sync when it is a lane bit) and one
//    penalty for each: two adds, a compare, a min.  __ballot_sync of "took the
//    high predecessor" over the lanes IS word r of the position-order packing,
//    so no decision byte is stored and read back.
//  * The step's branch penalties take only 2^R values, P(x) = base + sum of
//    the coef_r whose bit is set in x.  They are tabulated a stage of steps
//    ahead in shared memory (row u of a stage: P(0..2^R-1)), so inside the
//    recurrence a penalty is one load.  When every polynomial taps both
//    register ends (COMP; all six reference codes) the four branches of a
//    butterfly use one pattern x and its complement, and P(~x) = 2*base + sum
//    coef - P(x) = R*(high - low) - P(x): the partner's candidate is one
//    three-input add.  Otherwise both patterns are looked up.  Rows are
//    2^R + 1 words long, an odd stride, so neither the row writes (lane =
//    step) nor the reads conflict.
//  * Which pattern a position uses at a phase comes from tables built once on
//    the host (ops/cuda/inplace.py: position_tables, pair_tables), so no
//    rotation and no dependent table load is left in the step.
//  * Symbols arrive by cp.async two stages ahead of their use; the table of
//    stage s+1 is built from them at the top of stage s.
//
// K <= 9 (acs_inplace_warp_kernel): a warp a frame, the frame's metrics in
// the warp's registers (S/32 a lane), K is a template parameter and a
// stage is a whole number of rotations of K-1 steps, unrolled, so j, the
// shuffle distance and the pattern registers are compile-time; the step loop
// has no block barrier.  Several frames a warp were measured and lost (see
// the launcher).
//
// K = 10..15 (acs_inplace_block_kernel): a block a frame, metrics in shared
// memory (64 KB at K=15).  At a step with j >= 5 a thread runs whole
// butterflies on word pairs (both positions have its lane: two ballots are
// two words, addresses are consecutive over the lanes, so no bank conflict);
// at j < 5 it owns positions, loads its own metric and takes the partner's
// by shuffle, which also needs no barrier between such steps (4 of the K-1
// barriers go).  The pattern of a butterfly is one byte load from the
// per-phase tables, which COMP keeps in shared memory where they fit (112 KB
// at K=15), else one coalesced byte or word load from device memory.
// Its instruction count bounds it too (32 warps an SM, some thirty
// instructions a butterfly).  Metrics in registers (16 a thread at K=15) were
// not built: the five steps of fourteen whose bit j falls in the warp bits
// would still cross shared memory, behind a barrier, and the block stays one
// an SM by its 1024 threads either way, which is why the pattern tables may
// fill the rest of its shared memory (196 KB in all at K=15 R=6; 84 KB
// without them, under the 113 KB that would let two blocks share an SM if a
// later form got under 32 registers a thread).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst_shared, const void* src_global) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst_shared)), "l"(src_global) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kAcsWarpThreads = 128;  // most threads of a block of the warp form
extern __shared__ int smem_w[];       // the warp forms' shared memory, by word index

// A warp's penalty tables, shared by the two warp forms (in-place and state
// order): P(x) for x < 2^R at each step u of a stage of STG steps, two
// tables (a stage's, and the next one's).  In rows (the in-place form's
// layout: row u holds P(0 .. 2^R-1), 2^R + 1 words a row) or, with COLS, in
// columns (column x holds P(x) of steps 0 .. STG-1, STG + 1 words a column:
// a look-up is one load at an immediate offset from a per-lane pointer to
// its column).  Either stride is odd, so neither the table writes (lane =
// step) nor the reads conflict.  The table of stage s+1 is built from
// symbols staged by cp.async, at the top of stage s; the symbols of stage
// s+2 are fetched then.  Step t of the frame is step t + vlo of virtual time
// (the in-place form's rotation offset; 0 in state order).
template <int STG, bool COLS = false>
struct WarpStages {
  static constexpr int XS = COLS ? STG + 1 : 1;  // words between P(x) and P(x+1) of a step
  int* tab;    // [2][table]
  int* ysm;    // [2][R][32] staged symbols, lane = step
  const int* sym;
  int R, US, BUF, low, hl, B, b, lane, vlo, t_real;

  // Words of shared memory one warp takes.
  static __host__ __device__ constexpr int words(int R) {
    return 2 * (COLS ? (1 << R) * (STG + 1) : STG * ((1 << R) + 1)) + 2 * 32 * R;
  }
  __device__ __forceinline__ WarpStages(int* base, const int* sym_, int R_, int low_, int hl_,
                                        int B_, int b_, int lane_, int vlo_, int t_real_)
      : tab(base), sym(sym_), R(R_), US(COLS ? 1 : (1 << R_) + 1),
        BUF(COLS ? (1 << R_) * (STG + 1) : STG * ((1 << R_) + 1)), low(low_), hl(hl_), B(B_),
        b(b_), lane(lane_), vlo(vlo_), t_real(t_real_) {
    ysm = tab + 2 * BUF;
  }

  // P(x) of step u of stage s is column(s, x)[u] (COLS).
  __device__ __forceinline__ const int* column(int s, int x) const {
    return tab + (s & 1) * BUF + x * XS;
  }
  __device__ __forceinline__ void fetch(int s) const {  // symbols of stage s, row = lane
    const int t = min(max(s * STG + lane - vlo, 0), t_real - 1);
    for (int r = 0; r < R; ++r)
      cp_async4(&ysm[((s & 1) * R + r) * 32 + lane], &sym[((size_t)t * R + r) * B + b]);
    cp_async_commit();
  }
  __device__ __forceinline__ void build(int s) const {  // the penalties of stage s
    if (lane < STG) {
      int* t = tab + (s & 1) * BUF + lane * US;
      const int* y = ysm + (s & 1) * R * 32 + lane;
      int base = 0;
      for (int r = 0; r < R; ++r) base += y[r * 32] - low;
      t[0] = base;
      for (int r = 0; r < R; ++r) {
        const int coef = hl - 2 * y[r * 32];
        for (int x = 0; x < (1 << r); ++x) t[(x + (1 << r)) * XS] = t[x * XS] + coef;
      }
    }
  }
  // stage(s) for s = 0 .. nstages-1, each with its table ready.
  template <class F>
  __device__ __forceinline__ void run(int nstages, F&& stage) const {
    fetch(0);
    cp_async_wait<0>();
    build(0);
    fetch(1);
    for (int s = 0; s < nstages; ++s) {
      if (s + 1 < nstages) {
        cp_async_wait<0>();
        build(s + 1);
        fetch(s + 2);
      }
      __syncwarp();
      stage(s);
      __syncwarp();
    }
    cp_async_wait<0>();
  }
};

template <int K, bool COMP>
struct WarpAcs {
  static constexpr int NROT = K - 1, S = 1 << NROT, NR = S >= 32 ? S / 32 : 1;
  static constexpr int SP = S >= 32 ? S : 32;        // row length of the position table
  static constexpr int STG = (32 / NROT) * NROT;     // steps a stage: whole rotations
  int m[NR];         // metrics of positions 32*r + lane
  // Word offsets, from the table row of a rotation's first step, of the
  // penalty of the branch from the position's own old metric at each phase,
  // and of the one from its partner's (read only without COMP).
  int ao[NROT][NR], ap[NROT][NR];
  int sgn[5];        // +1 where bit j of the lane is set, else -1 (j < 5)
  int lane, PS, csum;
  int pen;           // word index of this warp's tables [2][STG][PS] in smem_w
  int* dec;
  unsigned doff;     // lane r: where word r of the frame goes at the next step
  unsigned dstep;    // words from one step's row of `dec` to the next
  bool storer;       // whether this lane stores a word

  __device__ __forceinline__ int table(int buf, int u) const {
    return pen + (buf * STG + u) * PS;
  }

  // One rotation: steps v0 .. v0 + NROT - 1 of virtual time (phase = step
  // index in the rotation), rows u0.. of table `buf`.  GUARD: skip the steps
  // outside [vlo, vhi).  A step runs in three passes over the positions --
  // loads and shuffles, arithmetic, ballots -- because shuffles and ballots
  // keep their program order: written position by position, each shuffle
  // would wait behind the ballot of the position before it.
  template <bool GUARD>
  __device__ __forceinline__ void rotation(int buf, int u0, int v0, int vlo, int vhi) {
#pragma unroll
    for (int c = 0; c < NROT; ++c) {
      const int j = K - 2 - c, jr = j >= 5 ? j - 5 : 0;
      const int v = v0 + c;
      if (GUARD && (v < vlo || v >= vhi)) continue;
      int mp[NR], po[NR], pp[NR];
      bool d[NR];
      const int* tab = smem_w + table(buf, u0);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        po[r] = tab[ao[c][r]];
        pp[r] = COMP ? 0 : tab[ap[c][r]];
        mp[r] = j >= 5 ? m[r ^ ((1 << jr) & (NR - 1))] : __shfl_xor_sync(kFull, m[r], 1 << j);
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int oc = m[r] + po[r];
        const int pc = COMP ? mp[r] - po[r] + csum : mp[r] + pp[r];
        // The own metric is the low predecessor's when bit j of the position
        // is 0, and the decision is "high < low", strictly.  Where bit j is
        // a lane bit, the sign of (own - partner) * sgn says it without a
        // predicate a lane.
        if (j >= 5)
          d[r] = ((r >> jr) & 1) ? (oc < pc) : (pc < oc);
        else
          d[r] = (oc - pc) * sgn[j >= 5 ? 0 : j] < 0 && (S >= 32 || lane < S);
        m[r] = min(oc, pc);
      }
      unsigned myword = 0;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const unsigned word = __ballot_sync(kFull, d[r]);
        if (lane == r) myword = word;
      }
      if (storer) dec[doff] = (int)myword;
      doff += dstep;
    }
  }
};

template <int K, bool COMP>
__global__ void __launch_bounds__(kAcsWarpThreads)
acs_inplace_warp_kernel(const int* __restrict__ metrics_in, const int* __restrict__ sym,
                        const int* __restrict__ postab, int* __restrict__ metrics_out,
                        int* __restrict__ dec, int R, int low, int hl, int csum, int B,
                        int t_real, int p0) {
  using A = WarpAcs<K, COMP>;
  constexpr int NROT = A::NROT, S = A::S, NR = A::NR, STG = A::STG;
  A a;
  const int warp = threadIdx.x >> 5, wpb = blockDim.x >> 5;
  a.lane = threadIdx.x & 31;
  const int b = blockIdx.x * wpb + warp;  // this warp's frame
  a.PS = (1 << R) + 1;
  a.csum = csum;  // R * (high - low): the penalties of a pattern and its complement add to it
  a.storer = a.lane < NR && b < B;
  a.dec = dec;
  a.doff = a.storer ? (unsigned)(a.lane * B + b) : 0u;
  a.dstep = (unsigned)(NR * B);
  const int lane = a.lane, PS = a.PS;
#pragma unroll
  for (int j = 0; j < 5; ++j) a.sgn[j] = ((lane >> j) & 1) ? 1 : -1;
  a.pen = warp * WarpStages<STG>::words(R);
  if (b >= B) return;  // a warp with no frame (whole warps only)

#pragma unroll
  for (int r = 0; r < NR; ++r)
    a.m[r] = (32 * r + lane < S) ? metrics_in[(size_t)(32 * r + lane) * B + b] : 0;
#pragma unroll
  for (int c = 0; c < NROT; ++c)
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int e = postab[c * A::SP + 32 * r + lane];  // own | partner << 8
      a.ao[c][r] = c * PS + (e & 0xff);
      a.ap[c][r] = c * PS + (e >> 8);
    }

  // Virtual time v = t + p0 (p0 < K-1), so that a rotation starts at phase 0.
  const int vlo = p0, vhi = p0 + t_real;
  const WarpStages<STG> st(smem_w + a.pen, sym, R, low, hl, B, b, lane, vlo, t_real);
  st.run((vhi + STG - 1) / STG, [&](int s) {
    const int v0 = s * STG;
    if (v0 >= vlo && v0 + STG <= vhi) {
      for (int rot = 0; rot < STG / NROT; ++rot)
        a.template rotation<false>(s & 1, rot * NROT, v0 + rot * NROT, vlo, vhi);
    } else {
      for (int rot = 0; rot < STG / NROT; ++rot)
        a.template rotation<true>(s & 1, rot * NROT, v0 + rot * NROT, vlo, vhi);
    }
  });

#pragma unroll
  for (int r = 0; r < NR; ++r)
    if (32 * r + lane < S) metrics_out[(size_t)(32 * r + lane) * B + b] = a.m[r];
}

// ---------------------------------------------------------------------------
// State-order ACS, K <= 9 (counterpart of kernels.py _acs_kernel and
// kernels2.py _acs_kernel2): the function of acs_update_tb and acs_update_tb2
// below the block forms' range.  New state n takes predecessors n>>1
// (h = 0) and n>>1 + S/2 (h = 1) on input bit b = n & 1, with the patterns
// of bytes b and 2 + b of etab[n>>1].
//
// What bounds it is what bounds the in-place warp form (see the note above
// WarpAcs): one warp a frame issues an instruction every four cycles or so,
// so a step costs its instruction count.  The design:
//
//  * A warp a frame, the frame's metrics in its registers in state order:
//    lane = n % 32, register r = n / 32 (NR = S/32 registers, one below 32
//    states).  Word r of a step in the canonical packing (bit n % 32 of word
//    n / 32) is then __ballot_sync of the decisions of register r: no
//    decision byte is stored and read back, and no block barrier is left in
//    the step loop.
//  * The permutation is paid by shuffles: new register r reads its two
//    predecessors from registers r>>1 and (r>>1) + NR/2 of lane
//    16*(r & 1) + lane/2 (one register and lanes lane/2, lane/2 + S/2 below
//    64 states).  Those source lanes, and the penalty pattern of each
//    branch, are per-(lane, register) constants from a host table
//    (ops/cuda/kernels.py warp_lane_table), read once.
//  * Penalties by look-up from the per-stage tables that the in-place form
//    builds (WarpStages, 32 steps a stage), here in columns: each register's
//    pattern picks a column at the top of a stage, and a look-up is one load
//    at an immediate offset, eight steps unrolled a group.  With COMP the
//    high branch pays R*(high - low) minus the low branch's penalty, else
//    both are looked up.
//
// Two steps a pass (what acs_update_tb2 computes) was counted and not built:
// in this layout a final state's four pre-pair predecessors come by four
// shuffles, as two steps of one state each take, and step A's intermediates
// would be computed twice (once for each of the two finals that read them);
// a layout in which a lane owns the four finals of its four predecessors
// (the block form's) needs the next pair's predecessors from one source lane
// in four different registers, four shuffles a value, and leaves half the
// warp idle at K=7.  So acs_update_tb2 launches this kernel for K <= 9.
// ---------------------------------------------------------------------------

constexpr int kTbWarpThreads = 64;  // two warps a block: a small batch spreads over SMs
constexpr int kTbGroup = 8;         // steps unrolled a group

template <int K, bool COMP>
struct WarpTb {
  static constexpr int S = 1 << (K - 1), NR = S >= 32 ? S / 32 : 1;
  int m[NR];                     // metrics of states 32*r + lane
  int slo[NR], shi[NR];          // lanes of each register's low and high predecessor
  const int* pa[NR];             // this stage's column of the low branch's pattern
  const int* pb[NR];             // ... and of the high branch's (read only without COMP)
  int lane, csum;
  bool live;                     // below 32 states, lanes >= S hold no state
  bool storer;                   // lane r stores word r
  int* dp;                       // where this lane's word of the next step goes
  size_t dstep;                  // words from one step's row of `dec` to the next

  // One step, u of the stage.  Three passes over the registers -- shuffles,
  // arithmetic, ballots -- so that no shuffle waits behind the ballot of the
  // register before it.
  __device__ __forceinline__ void step(int u) {
    int lo[NR], hi[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      lo[r] = __shfl_sync(kFull, m[NR > 1 ? r >> 1 : 0], slo[r]);
      hi[r] = __shfl_sync(kFull, m[NR > 1 ? (r >> 1) + NR / 2 : 0], shi[r]);
    }
    bool d[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int po = pa[r][u];
      const int c_lo = lo[r] + po, c_hi = COMP ? hi[r] - po + csum : hi[r] + pb[r][u];
      d[r] = live && c_hi < c_lo;
      m[r] = min(c_lo, c_hi);
    }
    unsigned myword = __ballot_sync(kFull, d[0]);
#pragma unroll
    for (int r = 1; r < NR; ++r) {
      const unsigned word = __ballot_sync(kFull, d[r]);
      if (lane == r) myword = word;
    }
    if (storer) *dp = (int)myword;
    dp += dstep;
  }
};

template <int K, bool COMP>
__global__ void __launch_bounds__(kTbWarpThreads)
acs_tb_warp_kernel(const int* __restrict__ metrics_in, const int* __restrict__ sym,
                   const int* __restrict__ lanetab, int* __restrict__ metrics_out,
                   int* __restrict__ dec, int R, int low, int hl, int csum, int B, int t_real) {
  using A = WarpTb<K, COMP>;
  constexpr int S = A::S, NR = A::NR, STG = 32;
  using Stages = WarpStages<STG, true>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;  // this warp's frame
  const Stages st(smem_w + warp * Stages::words(R), sym, R, low, hl, B, b, lane, 0, t_real);
  if (b >= B) return;  // a warp with no frame (whole warps only)

  A a;
  int ao[NR], ap[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int n = 32 * r + lane;
    a.m[r] = n < S ? metrics_in[(size_t)n * B + b] : 0;
    // low pattern | high pattern << 8 | low source lane << 16 | high source lane << 24
    const unsigned e = (unsigned)lanetab[n];
    ao[r] = e & 0xff;
    ap[r] = (e >> 8) & 0xff;
    a.slo[r] = (e >> 16) & 0xff;
    a.shi[r] = e >> 24;
  }
  a.lane = lane;
  a.csum = csum;  // R * (high - low): the penalties of a pattern and its complement add to it
  a.live = S >= 32 || lane < S;
  a.storer = lane < NR;
  a.dp = dec + (size_t)lane * B + b;
  a.dstep = (size_t)NR * B;

  st.run((t_real + STG - 1) / STG, [&](int s) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      a.pa[r] = st.column(s, ao[r]);
      a.pb[r] = COMP ? a.pa[r] : st.column(s, ap[r]);
    }
    const int n = min(STG, t_real - s * STG);
    if (n == STG) {
      for (int u0 = 0; u0 < STG; u0 += kTbGroup) {
#pragma unroll
        for (int k = 0; k < kTbGroup; ++k) a.step(u0 + k);
      }
    } else {
      for (int u = 0; u < n; ++u) a.step(u);
    }
  });

#pragma unroll
  for (int r = 0; r < NR; ++r)
    if (32 * r + lane < S) metrics_out[(size_t)(32 * r + lane) * B + b] = a.m[r];
}

// The block form, K = 10..15 (KT = 0: K at run time).  Shared memory: S
// metrics, two penalty tables of 32 rows, two stages of 32*R symbols, 16
// word slots a warp and, with TABS (COMP only, where it fits: (K-1) * S/2
// bytes, 112 KB at K=15), the pattern bytes of every phase, copied once from
// `pair8`.
template <int KT, bool COMP, bool TABS>
__global__ void __launch_bounds__(1024)
acs_inplace_block_kernel(const int* __restrict__ metrics_in, const int* __restrict__ sym,
                         const int* __restrict__ pair32, const unsigned char* __restrict__ pair8,
                         int* __restrict__ metrics_out, int* __restrict__ dec, int k_arg, int R,
                         int low, int hl, int csum, int B, int t_real, int p0) {
  const int K = KT ? KT : k_arg;
  const int nrot = K - 1, S = 1 << nrot, S2 = S >> 1, W = S >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = KT == 15 ? 32 : blockDim.x >> 5;
  const int ppw = KT == 15 ? 8 : (S >> 6) / nwarps;  // word pairs a warp and step
  const int PS = (1 << R) + 1, b = blockIdx.x;
  extern __shared__ int smem_b[];
  int* m = smem_b;               // [S]
  int* pen = m + S;              // [2][32][PS]
  int* ysm = pen + 2 * 32 * PS;  // [2][32][R]
  // The step's words, one slot a ballot: lane 0 parks each ballot's result
  // here and lanes 0 .. 2*ppw-1 carry them to `dec` together (a select a
  // ballot and lane costs more than a store and a load).
  unsigned* wsh = reinterpret_cast<unsigned*>(ysm + 2 * 32 * R) + warp * 16;
  const unsigned char* pat8 = pair8;
  if (TABS) {
    int* copy = ysm + 2 * 32 * R + 32 * 16;  // [K-1][S/2] bytes
    for (int i = threadIdx.x; i < nrot * (S2 >> 2); i += blockDim.x)
      copy[i] = reinterpret_cast<const int*>(pair8)[i];
    pat8 = reinterpret_cast<const unsigned char*>(copy);  // visible after the barriers below
  }

  auto fetch = [&](int s) {
    if ((int)threadIdx.x < 32 * R) {
      const int u = threadIdx.x / R, r = threadIdx.x - u * R;
      const int t = min(32 * s + u, t_real - 1);
      cp_async4(&ysm[(s & 1) * 32 * R + threadIdx.x], &sym[((size_t)t * R + r) * B + b]);
    }
    cp_async_commit();
  };
  auto build = [&](int s) {
    int* tab = pen + (s & 1) * 32 * PS;
    for (int idx = threadIdx.x; idx < (32 << R); idx += blockDim.x) {
      const int u = idx >> R, x = idx & ((1 << R) - 1);
      int v = 0;
      for (int r = 0; r < R; ++r) {
        const int y = ysm[((s & 1) * 32 + u) * R + r];
        v += y - low + (((x >> r) & 1) ? hl - 2 * y : 0);
      }
      tab[u * PS + x] = v;
    }
  };

  for (int s = threadIdx.x; s < S; s += blockDim.x) m[s] = metrics_in[(size_t)s * B + b];
  fetch(0);
  cp_async_wait<0>();
  __syncthreads();
  build(0);
  __syncthreads();
  fetch(1);

  int phase = p0;
  for (int t = 0; t < t_real; ++t) {
    const int u = t & 31, stage = t >> 5;
    if (u == 0) {
      cp_async_wait<0>();
      __syncthreads();
      build(stage + 1);
      __syncthreads();
      fetch(stage + 2);
    }
    const int j = K - 2 - phase, half = 1 << j;
    const int* tab = pen + ((stage & 1) * 32 + u) * PS;
    const unsigned char* pat = pat8 + phase * S2;  // this phase's patterns by pair index
    const int* pat32 = pair32 + phase * S2;
    int* row = dec + (size_t)t * W * B + b;
    // Both branches run in groups of kGroup butterflies (positions), each
    // group in three passes -- loads, arithmetic and stores, ballots -- so
    // that the loads of a group are in flight together and no shuffle or
    // ballot waits behind the arithmetic of the position before it.
    constexpr int kGroup = 4;
    if (j >= 5) {
      const int jw = j - 5, hw = 1 << jw;
#pragma unroll
      for (int k0 = 0; k0 < 8; k0 += kGroup) {
        if (k0 >= ppw) break;
        int qq[kGroup], lo[kGroup], hi[kGroup], pl0[kGroup], ph0[kGroup], pl1[kGroup], ph1[kGroup];
        bool d0[kGroup], d1[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          // pair i sits at q = i with a zero put in at bit j: i + (i's bits above j)
          const int i = (warp + nwarps * min(k0 + g, ppw - 1)) * 32 + lane;
          const int q = i + (i & -half);
          qq[g] = q;
          lo[g] = m[q];
          hi[g] = m[q + half];
          if (COMP) {
            pl0[g] = tab[pat[i]];
          } else {
            const unsigned e = (unsigned)pat32[i];
            pl0[g] = tab[e & 0xff];
            pl1[g] = tab[(e >> 8) & 0xff];
            ph0[g] = tab[(e >> 16) & 0xff];
            ph1[g] = tab[e >> 24];
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          // COMP: the (h, b) = (0, 1) and (1, 0) branches pay csum - pl0, (1, 1) pl0
          const int l0 = lo[g] + pl0[g], h0 = COMP ? hi[g] - pl0[g] + csum : hi[g] + ph0[g];
          const int l1 = COMP ? lo[g] - pl0[g] + csum : lo[g] + pl1[g];
          const int h1 = COMP ? hi[g] + pl0[g] : hi[g] + ph1[g];
          d0[g] = h0 < l0;
          d1[g] = h1 < l1;
          if (k0 + g < ppw) {
            m[qq[g]] = min(l0, h0);
            m[qq[g] + half] = min(l1, h1);
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const unsigned w0 = __ballot_sync(kFull, d0[g]), w1 = __ballot_sync(kFull, d1[g]);
          if (lane == 0) {
            wsh[2 * (k0 + g)] = w0;
            wsh[2 * (k0 + g) + 1] = w1;
          }
        }
      }
      __syncwarp();
      if (lane < 2 * ppw) {
        const int wp = warp + nwarps * (lane >> 1);
        const int wq = ((wp >> jw) << (jw + 1)) | (wp & (hw - 1));
        row[(size_t)(wq + (lane & 1) * hw) * B] = (int)wsh[lane];
      }
    } else {
      const bool bb = (lane >> j) & 1;
      const int sg = bb ? 1 : -1;
      // pair index of position 32*wd + lane: bit j taken out, 16*wd + lc
      const int lc = ((lane >> (j + 1)) << j) | (lane & (half - 1));
#pragma unroll
      for (int k0 = 0; k0 < 16; k0 += kGroup) {
        if (k0 >= 2 * ppw) break;
        int pa[kGroup], mo[kGroup], mp[kGroup], po[kGroup], pp[kGroup];
        bool d[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int wd = warp + nwarps * min(k0 + g, 2 * ppw - 1);
          const int p = wd * 32 + lane, i = wd * 16 + lc;
          pa[g] = p;
          mo[g] = m[p];
          if (COMP) {
            po[g] = tab[pat[i]];
          } else {
            const unsigned e = (unsigned)pat32[i];
            po[g] = tab[bb ? e >> 24 : e & 0xff];
            pp[g] = tab[bb ? (e >> 8) & 0xff : (e >> 16) & 0xff];
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) mp[g] = __shfl_xor_sync(kFull, mo[g], half);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int oc = mo[g] + po[g], pc = COMP ? mp[g] - po[g] + csum : mp[g] + pp[g];
          d[g] = (oc - pc) * sg < 0;  // "high < low": own is low where bit j is 0
          if (k0 + g < 2 * ppw) m[pa[g]] = min(oc, pc);
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const unsigned wv = __ballot_sync(kFull, d[g]);
          if (lane == 0) wsh[k0 + g] = wv;
        }
      }
      __syncwarp();
      if (lane < 2 * ppw) row[(size_t)(warp + nwarps * lane) * B] = (int)wsh[lane];
    }
    // Between two steps with j < 5 a warp touches only its own words.
    if (j >= 1 && j <= 4) __syncwarp(); else __syncthreads();
    phase = (phase + 1 == nrot) ? 0 : phase + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) metrics_out[(size_t)s * B + b] = m[s];
}

// ---------------------------------------------------------------------------
// Reverse traceback (counterpart of kernels.py _chainback_kernel, and with
// ROT of inplace.py _chainback_inplace_kernel, where state s's decision at
// global step t sits at position rotr(s, (t + 1 + p0) mod (K-1))).
//
// What bounds it: T dependent steps a frame, each "position -> word -> bit ->
// next position"; its bytes and operations are nothing.  So the design
// shortens the chain and runs every frame's chain at once: a warp a frame,
// eight adjacent frames a block (one 32-byte sector of every [t, w] row), the
// blocks spread over all SMs.
//
//  * ROT walks in position space: going back a step replaces one bit of the
//    position (bit jj, which moves up by one a step), so no rotation is left
//    in the chain.
//  * STAGED (K <= 9): all W words of a chunk of 32 steps, for the block's
//    eight frames, are copied into shared memory by cp.async, two chunks in
//    flight behind the one being walked (three buffers, one barrier a chunk).
//    Lane 0 walks.  It loads all W words of a step, which needs no position
//    and so runs ahead, and picks the word by a tree of selects; the step's
//    chain is then selects, one funnel shift and a mask that make the
//    decision 0 or 1, and one multiply-add that puts it at its place in the
//    next position: no memory access is left in the chain, and the only
//    bookkeeping a step is the mask of the bit to replace.
//    (Resolving five steps a round from the staged words, as below, was
//    built and measured on an H100: 0.52 ms against 0.39 ms at K=7, B=512,
//    T=8198 -- a
//    round's forty-odd dependent instructions cost more than five short
//    steps -- so the staged form walks step by step.)
//  * Not staged (K = 10..24; ROT only to 15): W is 16..2^18 words a step and
//    does not stage.
//    The position d steps back has only 2^d candidates (its unknown bits are
//    the d decisions between).  Lane L, with L + 1 = 1 k_0 k_1 .. k_{d-1} in
//    binary, fetches the word of the candidate that the decisions k_0.. lead
//    to and extracts its bit; one ballot hands all 31 bits to every lane, and
//    five steps resolve in registers (the child of node L on decision k is
//    node 2L + 1 + k): one round trip to device memory for five steps.
//
// Element (t, w, b) of dec is at t*st + w*sw + b*sb (64-bit strides), so a
// batch-major [B, T, W] or time-major [T, B, W] tensor walks where it lies:
// at K=24 a frame holds 2^18 words a step, and a copy into [Tp, W, B] would
// cost more than the walk.
//
// Considered and not built: walking every 32-step segment from all S entry
// states in parallel and stitching the segments.  It is exact, but multiplies
// the operations by S: 268 M state-steps at K=7, B=512, T=8198, which is 0.19
// ms at the card's full int32 rate -- no better than a chain of 8198 steps of
// about 45 cycles (0.19 ms) and hopeless at K=15.
// ---------------------------------------------------------------------------
constexpr int kCbFrames = 8;  // frames (warps) a block
constexpr int kCbBufs = 3;    // chunk buffers of the staged form
constexpr int kCbChunk = 32;  // steps a staged chunk: one word of output bits
constexpr int kCbDepth = 5;   // steps a round

__device__ __forceinline__ int rotr_bits(int x, int r, int nbits, int mask) {
  return ((x >> r) | (x << (nbits - r))) & mask;
}

// The position `d` steps back from `pos` when the d decisions between are the
// bits of `cb` (bit e: the decision of the e-th step back); d <= K-1, which
// holds for the rounds of five steps at K >= 10.
template <bool ROT>
__device__ __forceinline__ int walk_back(int pos, int d, int cb, int jj, int K) {
  const int nrot = K - 1, mask = (1 << nrot) - 1;
  if (!ROT) return (pos >> d) | (cb << (K - 1 - d));
  // bits jj, jj+1, .. (cyclic) of the position take the decisions
  int r = rotr_bits(pos, jj, nrot, mask);
  r = (r & ~((1 << d) - 1)) | cb;
  return rotr_bits(r, jj ? nrot - jj : 0, nrot, mask);
}

// Word `idx` of the WT words of a step held in registers: a tree of selects
// (an indexed register array would live in local memory).
template <int WT>
__device__ __forceinline__ unsigned pick_word(const unsigned* wv, int idx) {
  if constexpr (WT == 1) {
    return wv[0];
  } else {
    const unsigned lo = pick_word<WT / 2>(wv, idx), hi = pick_word<WT / 2>(wv + WT / 2, idx);
    return (idx & (WT / 2)) ? hi : lo;
  }
}

// WT: the words a step (1, 2, 4, 8) of the staged form; 0: not staged.
template <bool ROT, int WT>
__global__ void __launch_bounds__(kCbFrames * 32)
chainback_kernel(const int* __restrict__ dec, long long st, long long sw, long long sb,
                 const int* __restrict__ endstate, int* __restrict__ bits, int K, int B,
                 int t_real, int nw, int p0) {
  extern __shared__ unsigned stage_cb[];
  constexpr bool STAGED = WT > 0;
  const int nrot = K - 1, S = 1 << nrot, mask = S - 1, W = STAGED ? WT : S >> 5;
  const int lane = threadIdx.x & 31, f = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kCbFrames, b = b0 + f;
  const bool valid = b < B;  // whole warps
  const int bl = min(b, B - 1);
  const int c = ROT ? (t_real + p0) % nrot : 0;  // rotation of the last step's decisions
  const int state = endstate[bl] & mask;
  int pos = c ? rotr_bits(state, c, nrot, mask) : state;
  int jj = c ? nrot - c : 0;  // ROT: the position bit that the next decision replaces
  if (valid && lane == 0)
    for (int w = (t_real + 31) >> 5; w < nw; ++w) bits[(size_t)w * B + b] = 0;

  if (STAGED) {
    const int FS = kCbChunk * W + 4;  // a frame's stride: the copies' stores spread over banks
    const int nchunks = (t_real + kCbChunk - 1) / kCbChunk;
    auto copy = [&](int seq) {  // chunk nchunks-1-seq into buffer seq % kCbBufs
      if (seq < nchunks) {
        const int t_lo = (nchunks - 1 - seq) * kCbChunk;
        unsigned* buf = stage_cb + (size_t)(seq % kCbBufs) * kCbFrames * FS;
        for (int idx = threadIdx.x; idx < kCbChunk * W * kCbFrames; idx += blockDim.x) {
          const int ff = idx & (kCbFrames - 1), rw = idx >> 3, u = rw / W, w = rw - u * W;
          const int tt = min(t_lo + u, t_real - 1);
          cp_async4(&buf[ff * FS + rw], &dec[tt * st + w * sw + min(b0 + ff, B - 1) * sb]);
        }
      }
      cp_async_commit();
    };
    // ROT: the mask of position bit jj, which the step's decision replaces;
    // else the state bit K-2 at which it enters.
    unsigned bm = 1u << (ROT ? jj : K - 2);
    copy(0);
    copy(1);
    for (int seq = 0; seq < nchunks; ++seq) {
      cp_async_wait<1>();
      __syncthreads();  // chunk seq has landed; every walk of chunk seq-1 is over
      copy(seq + 2);
      if (valid && lane == 0) {
        const int chunk = nchunks - 1 - seq, t_lo = chunk * kCbChunk;
        const int last = min(kCbChunk - 1, t_real - 1 - t_lo);
        const unsigned* st =
            stage_cb + (size_t)(seq % kCbBufs) * kCbFrames * FS + f * FS + last * W;
        unsigned acc = 0, ubit = 1u << last;
#pragma unroll 8
        for (int u = last; u >= 0; --u, st -= W, ubit >>= 1) {
          // All W words of the step, whichever the walk will want: the loads
          // do not depend on the position, so they run ahead of the chain.
          unsigned wv[STAGED ? WT : 1];
          if constexpr (WT == 2) {
            const uint2 v = *reinterpret_cast<const uint2*>(st);
            wv[0] = v.x, wv[1] = v.y;
          } else if constexpr (WT >= 4) {
#pragma unroll
            for (int i = 0; i < WT; i += 4) {
              const uint4 v = *reinterpret_cast<const uint4*>(st + i);
              wv[i] = v.x, wv[i + 1] = v.y, wv[i + 2] = v.z, wv[i + 3] = v.w;
            }
          } else {
            wv[0] = st[0];
          }
          const unsigned word = pick_word<STAGED ? WT : 1>(wv, pos >> 5);
          // The decision as 0 or 1, then a multiply-add puts it in its place:
          // fewer instructions than shifting it there and masking.
          const unsigned k = __funnelshift_r(word, word, pos) & 1u;
          acc += k * ubit;
          if (ROT) {
            pos = (pos & ~bm) + k * bm;
            bm = (bm << 1) > (unsigned)mask ? 1u : bm << 1;
          } else {
            pos = (pos >> 1) + k * bm;
          }
        }
        bits[(size_t)chunk * B + b] = (int)acc;
      }
    }
    cp_async_wait<0>();
    return;
  }

  if (!valid) return;
  // This lane's candidate: d steps back on the decisions cb (lane 31: none).
  const int d = 31 - __clz(lane + 1);
  const int cb = d ? (int)(__brev((unsigned)(lane + 1) ^ (1u << d)) >> (32 - d)) : 0;
  int t = t_real - 1, cw = t >> 5;
  unsigned acc = 0;
  while (t >= 0) {
    const int n = min(kCbDepth, t + 1);
    int kc = 0;
    if (d < n) {
      const int cand = walk_back<ROT>(pos, d, cb, jj, K);
      const unsigned word = (unsigned)dec[(t - d) * st + (cand >> 5) * sw + b * sb];
      kc = (word >> (cand & 31)) & 1;
    }
    const unsigned bal = __ballot_sync(kFull, kc);
    unsigned node = 0;
#pragma unroll
    for (int e = 0; e < kCbDepth; ++e)
      if (e < n) node = 2 * node + 1 + ((bal >> node) & 1);
    // node + 1 = 1 k_0 .. k_{n-1}: k_e is the output of step t - e, so the
    // field's bit 0 belongs to step t - n + 1.
    const unsigned path = (node + 1) ^ (1u << n);
    const int t0 = t - n + 1, sh = t0 & 31;
    if ((t0 >> 5) != cw) {  // the round reaches into the word below
      acc |= path >> (32 - sh);
      if (lane == 0) bits[(size_t)cw * B + b] = (int)acc;
      acc = 0;
      cw = t0 >> 5;
    }
    acc |= path << sh;
    pos = walk_back<ROT>(pos, n, (int)(__brev(path) >> (32 - n)), jj, K);
    if (ROT) {
      jj += n;
      if (jj >= nrot) jj -= nrot;
    }
    t -= n;
  }
  if (lane == 0) bits[(size_t)cw * B + b] = (int)acc;
}

int acs_threads(int K) {
  const int S2 = 1 << (K - 2);
  const int n = S2 < 32 ? 32 : (S2 > 1024 ? 1024 : S2);
  return (n + 31) / 32 * 32;
}

// ---- the state-order ACS launchers ------------------------------------------
struct TbArgs {
  const int *m_in, *sym, *etab, *lanetab;
  int *m_out, *dec;
  int K, R, low, hl, B, t_real;
  cudaStream_t stream;
};

int tb_warp_smem(int R) { return kTbWarpThreads / 32 * 4 * WarpStages<32, true>::words(R); }

// Dynamic shared memory of one block of the state-order ACS launch, depth 1
// or 2 (what ops/cuda/kernels.py acs_smem_bytes and kernels2.py
// tb2_smem_bytes mirror).
int tb_smem(int K, int R, int depth) {
  const int S = 1 << (K - 1), W = S >= 32 ? S >> 5 : 1;
  if (K <= 9) return tb_warp_smem(R);
  if (depth == 2) return 4 * (2 * S + kStage * R);  // two metric buffers, staged symbols
  return 4 * (2 * S + S / 2 + kStage * R) + 2 * W * 32;  // the carve-up of Smem
}

template <int K, bool COMP>
cudaError_t launch_tb_warp(const TbArgs& a) {
  const int wpb = kTbWarpThreads / 32, smem = tb_warp_smem(a.R);
  auto kernel = acs_tb_warp_kernel<K, COMP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.B + wpb - 1) / wpb, kTbWarpThreads, smem, a.stream>>>(
      a.m_in, a.sym, a.lanetab, a.m_out, a.dec, a.R, a.low, a.hl, a.R * (a.hl - 2 * a.low), a.B,
      a.t_real);
  return cudaGetLastError();
}

template <bool COMP>
cudaError_t tb_warp_dispatch(const TbArgs& a) {
  switch (a.K) {
    case 2: return launch_tb_warp<2, COMP>(a);
    case 3: return launch_tb_warp<3, COMP>(a);
    case 4: return launch_tb_warp<4, COMP>(a);
    case 5: return launch_tb_warp<5, COMP>(a);
    case 6: return launch_tb_warp<6, COMP>(a);
    case 7: return launch_tb_warp<7, COMP>(a);
    case 8: return launch_tb_warp<8, COMP>(a);
    case 9: return launch_tb_warp<9, COMP>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int R>
cudaError_t launch_tb_block(const TbArgs& a, int depth) {
  const int smem = tb_smem(a.K, R, depth);
  auto kernel = depth == 2 ? acs_tb2_block_kernel<R> : acs_tb_block_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // Depth 2: S/4 threads a frame, in whole warps.
  const int threads = depth == 2 ? ((1 << (a.K - 3)) + 31) / 32 * 32 : acs_threads(a.K);
  kernel<<<a.B, threads, smem, a.stream>>>(a.m_in, a.sym, a.etab, a.m_out, a.dec, a.K, a.low,
                                           a.hl, a.B, a.t_real);
  return cudaGetLastError();
}

cudaError_t tb_dispatch(const TbArgs& a, bool comp, int depth) {
  // Depth 2's block form holds S/4 threads (K <= 13) and needs four
  // predecessors a thread (K >= 3).
  if (a.K < (depth == 2 ? 3 : 2) || a.K > (depth == 2 ? 13 : 15) || a.R < 1 || a.R > 8 ||
      a.B < 1 || a.t_real < 1)
    return cudaErrorInvalidValue;
  if (a.K <= 9) return comp ? tb_warp_dispatch<true>(a) : tb_warp_dispatch<false>(a);
  switch (a.R) {
    case 1: return launch_tb_block<1>(a, depth);
    case 2: return launch_tb_block<2>(a, depth);
    case 3: return launch_tb_block<3>(a, depth);
    case 4: return launch_tb_block<4>(a, depth);
    case 5: return launch_tb_block<5>(a, depth);
    case 6: return launch_tb_block<6>(a, depth);
    case 7: return launch_tb_block<7>(a, depth);
    default: return launch_tb_block<8>(a, depth);
  }
}

// ---- the in-place ACS launcher -------------------------------------------
// Geometry of the warp form (K <= 9), mirrored by ops/cuda/inplace.py
// inplace_warps_per_block and inplace_smem_bytes.  A warp carries one frame
// at every K and batch: its time grows with the frames it carries (its
// instruction stream bounds it, not a latency a second frame could fill).
// Measured on an H100 at K=7, two frames a warp cost twice one up to B=512,
// 1.6 times at 1024, 1.2 times at 2048, the same at 4096 and 2 % less at
// 8192.
constexpr int kSmemCap = 220 * 1024;

int acs_warp_bytes(int K, int R) {  // shared memory of one warp
  const int stg = (32 / (K - 1)) * (K - 1), ps = (1 << R) + 1;
  return 4 * (2 * stg * ps + 2 * 32 * R);
}

int acs_warp_wpb(int K, int R) {  // warps a block
  const int fit = kSmemCap / acs_warp_bytes(K, R);
  return fit >= 4 ? 4 : (fit < 1 ? 1 : fit);
}

int acs_block_base_bytes(int K, int R) {  // metrics, penalty tables, symbols, a step's words
  return 4 * ((1 << (K - 1)) + 2 * 32 * ((1 << R) + 1) + 2 * 32 * R + 32 * 16);
}

bool acs_block_tabs(int K, int R, bool comp) {  // whether the pattern bytes go to shared memory
  return comp && acs_block_base_bytes(K, R) + (K - 1) * (1 << (K - 2)) <= kSmemCap;
}

int acs_inplace_smem(int K, int R, bool comp) {
  if (K >= 10)
    return acs_block_base_bytes(K, R) + (acs_block_tabs(K, R, comp) ? (K - 1) * (1 << (K - 2)) : 0);
  return acs_warp_wpb(K, R) * acs_warp_bytes(K, R);
}

struct InplaceArgs {
  const int *m_in, *sym, *postab, *pair32;
  const unsigned char* pair8;
  int *m_out, *dec;
  int K, R, low, hl, B, t_real, p0;
  cudaStream_t stream;
};

template <int K, bool COMP>
cudaError_t launch_inplace_warp(const InplaceArgs& a) {
  const int wpb = acs_warp_wpb(K, a.R), smem = wpb * acs_warp_bytes(K, a.R);
  const int blocks = (a.B + wpb - 1) / wpb;
  auto kernel = acs_inplace_warp_kernel<K, COMP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, wpb * 32, smem, a.stream>>>(a.m_in, a.sym, a.postab, a.m_out, a.dec, a.R, a.low,
                                               a.hl, a.R * (a.hl - 2 * a.low), a.B, a.t_real,
                                               a.p0);
  return cudaGetLastError();
}

template <int KT, bool COMP, bool TABS>
cudaError_t launch_inplace_block(const InplaceArgs& a) {
  const int smem = acs_inplace_smem(a.K, a.R, COMP);
  auto kernel = acs_inplace_block_kernel<KT, COMP, TABS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.B, acs_threads(a.K), smem, a.stream>>>(a.m_in, a.sym, a.pair32, a.pair8, a.m_out,
                                                    a.dec, a.K, a.R, a.low, a.hl,
                                                    a.R * (a.hl - 2 * a.low), a.B, a.t_real, a.p0);
  return cudaGetLastError();
}

template <bool COMP>
cudaError_t inplace_dispatch(const InplaceArgs& a) {
  switch (a.K) {
    case 2: return launch_inplace_warp<2, COMP>(a);
    case 3: return launch_inplace_warp<3, COMP>(a);
    case 4: return launch_inplace_warp<4, COMP>(a);
    case 5: return launch_inplace_warp<5, COMP>(a);
    case 6: return launch_inplace_warp<6, COMP>(a);
    case 7: return launch_inplace_warp<7, COMP>(a);
    case 8: return launch_inplace_warp<8, COMP>(a);
    case 9: return launch_inplace_warp<9, COMP>(a);
    default:
      if (COMP && acs_block_tabs(a.K, a.R, true))
        return a.K == 15 ? launch_inplace_block<15, COMP, COMP>(a)
                         : launch_inplace_block<0, COMP, COMP>(a);
      return a.K == 15 ? launch_inplace_block<15, COMP, false>(a)
                       : launch_inplace_block<0, COMP, false>(a);
  }
}

template <bool ROT>
cudaError_t launch_chainback(const int* dec, long long st, long long sw, long long sb,
                             const int* endstate, int* bits, int K, int B, int t_real, int nw,
                             int p0, cudaStream_t stream) {
  if (K < 2 || K > (ROT ? 15 : 24) || B < 1 || t_real < 1 || nw < (t_real + 31) / 32)
    return cudaErrorInvalidValue;
  const int blocks = (B + kCbFrames - 1) / kCbFrames, threads = kCbFrames * 32;
  const int W = K >= 7 ? 1 << (K - 6) : 1;
  const int smem = 4 * kCbBufs * kCbFrames * (kCbChunk * W + 4);
  if (W == 1)
    chainback_kernel<ROT, 1><<<blocks, threads, smem, stream>>>(dec, st, sw, sb, endstate, bits, K, B, t_real, nw, p0);
  else if (W == 2)
    chainback_kernel<ROT, 2><<<blocks, threads, smem, stream>>>(dec, st, sw, sb, endstate, bits, K, B, t_real, nw, p0);
  else if (W == 4)
    chainback_kernel<ROT, 4><<<blocks, threads, smem, stream>>>(dec, st, sw, sb, endstate, bits, K, B, t_real, nw, p0);
  else if (W == 8)
    chainback_kernel<ROT, 8><<<blocks, threads, smem, stream>>>(dec, st, sw, sb, endstate, bits, K, B, t_real, nw, p0);
  else
    chainback_kernel<ROT, 0><<<blocks, threads, 0, stream>>>(dec, st, sw, sb, endstate, bits, K, B, t_real, nw, p0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// State-order ACS, depth 1 (acs_update_tb) and depth 2 (acs_update_tb2).
// etab: packed_transition_table (the block forms); lanetab: warp_lane_table
// (ops/cuda/kernels.py; the warp form); comp: every polynomial taps both
// register ends (complement_form).
int viterbi_acs_tb(const void* m_in, const void* sym, const void* etab, const void* lanetab,
                   void* m_out, void* dec, int K, int R, int comp, int low, int hl, int B,
                   int t_real, void* stream) {
  const TbArgs a{(const int*)m_in, (const int*)sym, (const int*)etab, (const int*)lanetab,
                 (int*)m_out, (int*)dec, K, R, low, hl, B, t_real, (cudaStream_t)stream};
  return (int)tb_dispatch(a, comp != 0, 1);
}

int viterbi_acs_tb2(const void* m_in, const void* sym, const void* etab, const void* lanetab,
                    void* m_out, void* dec, int K, int R, int comp, int low, int hl, int B,
                    int t_real, void* stream) {
  const TbArgs a{(const int*)m_in, (const int*)sym, (const int*)etab, (const int*)lanetab,
                 (int*)m_out, (int*)dec, K, R, low, hl, B, t_real, (cudaStream_t)stream};
  return (int)tb_dispatch(a, comp != 0, 2);
}

// Dynamic shared memory of one block of the state-order ACS launch (what
// ops/cuda/kernels.py acs_smem_bytes mirrors).
int viterbi_acs_tb_smem(int K, int R, int depth) { return tb_smem(K, R, depth); }

// postab, pair32, pair8: the host tables of ops/cuda/inplace.py
// (position_tables, pair_tables and the low byte of pair_tables); comp: every
// polynomial taps both register ends (complement_form).  p0 < K-1.
int viterbi_acs_inplace(const void* m_in, const void* sym, const void* postab,
                        const void* pair32, const void* pair8, void* m_out, void* dec, int K,
                        int R, int comp, int low, int hl, int B, int t_real, int p0,
                        void* stream) {
  if (K < 2 || K > 15 || R < 1 || R > 8 || B < 1 || t_real < 1 || p0 < 0 || p0 >= K - 1)
    return (int)cudaErrorInvalidValue;
  const InplaceArgs a{(const int*)m_in, (const int*)sym, (const int*)postab, (const int*)pair32,
                      (const unsigned char*)pair8, (int*)m_out, (int*)dec, K, R, low, hl, B,
                      t_real, p0, (cudaStream_t)stream};
  return (int)(comp ? inplace_dispatch<true>(a) : inplace_dispatch<false>(a));
}

// Dynamic shared memory of one block of the in-place ACS launch (what
// ops/cuda/inplace.py inplace_smem_bytes mirrors).
int viterbi_acs_inplace_smem(int K, int R, int comp) { return acs_inplace_smem(K, R, comp != 0); }

// The tracebacks over dec, element (t, w, b) at t*st + w*sw + b*sb: state
// order up to K=24, position order (ROT) up to K=15.
int viterbi_chainback_tb(const void* dec, long long st, long long sw, long long sb,
                         const void* endstate, void* bits, int K, int B, int t_real, int nw,
                         void* stream) {
  return (int)launch_chainback<false>((const int*)dec, st, sw, sb, (const int*)endstate,
                                      (int*)bits, K, B, t_real, nw, 0, (cudaStream_t)stream);
}

int viterbi_chainback_inplace(const void* dec, long long st, long long sw, long long sb,
                              const void* endstate, void* bits, int K, int B, int t_real, int nw,
                              int p0, void* stream) {
  return (int)launch_chainback<true>((const int*)dec, st, sw, sb, (const int*)endstate,
                                     (int*)bits, K, B, t_real, nw, p0, (cudaStream_t)stream);
}

}  // extern "C"
