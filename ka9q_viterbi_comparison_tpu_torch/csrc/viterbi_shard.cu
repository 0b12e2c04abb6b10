// The state-sharded decode on Hopper (sm_90a): its trellis step and its
// traceback, bound to Python with ctypes through the extern "C" launchers at
// the end of this file.
//
//   sharded_acs_step_kernel   one step of the jnp scan of parallel/statewise.py
//                             _sharded_acs_scan (the JAX package's line 90), for
//                             every local target shard and every frame
//   sharded_walk_kernel       the whole traceback of parallel/statewise.py
//                             _sharded_traceback (the JAX package's lax.scan at
//                             lines 120-137) where every state line lies in
//                             this process: a warp a (line, frame)
//   sharded_walk_step_kernel  one step of it where a line spans processes: the
//                             owner's bit, summed by the caller's psum
//
// They replace no Pallas kernel: the JAX package runs the scan and the
// traceback as jnp inside a shard_map, fused by XLA.  The wrapper is
// ops/cuda/shard.py; the plain versions, rounds of PyTorch operations a
// step, are parallel/statewise.py _sharded_acs_scan_ref and
// _sharded_traceback_ref.  The exchange between steps stays outside: in one
// process the launcher is handed each target's source chunks where they lie
// (halves of the old metrics), across processes the buffers that NCCL
// received them into (parallel/mesh.py ppermute_sources).
//
// What it computes.  Shard j owns new states [base_j, base_j + 2 chunk); its
// predecessor pairs s2 = base_j / 2 + s2_loc, s2_loc in [0, chunk), have their
// low metric in lo_j[b, s2_loc] and their high one in hi_j[b, s2_loc].  The
// expected-bit pattern of output r is parity(s2 & (poly_r >> 1)) xor a
// constant of (h, bit), so the penalty is table[j, b, t, pidx ^ c(h, bit)]
// with pidx = sum_r parity(s2 & mask_r) << r (mask_r = |poly_r| >> 1) and the
// four constants c of _pattern_offsets.  New state 2 s2_loc + bit takes
// min(lo + pen(0, bit), hi + pen(1, bit)), ties to the LOW predecessor, int32
// adds wrapping as the plain version's do; no renormalisation (the JAX scan
// has none).
//
// Layouts (what the Python side passes; no copy is made):
//   lo_j, hi_j   [B, chunk] int32, unit stride along s2, batch stride lo_bs[j]
//   table        [n, B, T, 2^R] int32, contiguous (_symbol_tables of the scan)
//   m_out        half-major [n, 2, B, chunk] int32 (target, half, frame, state),
//                contiguous: new local state k of target j and frame b at ((2 j +
//                h) B + b) chunk + k - h chunk, h = k >= chunk -- the scan's
//                ping-pong buffers, so that each half the next step sends is one
//                contiguous block; or interleaved [n, B, 2 chunk], contiguous
//                (the one-step entry point's)
//   dec          [n, B, W] int32 (row t of the scan's [T, n, B, W] words),
//                W = ceil(2 chunk / 32): bit i % 32 of word i / 32 the decision
//                of local new state i (1: the HIGH predecessor); null: no words
//
// What bounds it on the card.  Bytes: a state's two old metrics in, its new
// metric out and an eighth of a byte of decision, (4 + 4 + 1/8) B S / n bytes
// a shard and step (harness/comms.py statewise_model's count).  At ICE (K=24)
// B=8 on four shards of one card that is 545 MB a step, 0.163 ms at 3.35 TB/s;
// its operations (some 6 a state: two adds, a compare, two selects, the
// packing) take 0.024 ms at the int32 issue rate.  So the design streams:
//
//  * A thread takes one s2 (two new states, one 8-byte store); a warp takes 32
//    consecutive s2, so its loads of lo and hi are 128 coalesced bytes each
//    and its store of the new metrics 256.  A warp's 64 new states are two
//    words: the ballots of the two decisions, interleaved (bit 2 l + bit of
//    the word from lane l of its half).  A warp that crosses the end of a
//    shard's range (chunk < 32: K=9 on state=8 has chunk 16) masks its lanes.
//  * The grid is (s2 blocks, frames, targets), so a thread finds its place
//    with no division (a first form divided 64-bit warp indices and ran at
//    29 % of the bound, PERF.md §6).
//  * The step's table row (2^R ints a frame) is read through L1; pidx is up
//    to eight popcounts (unrolled: masks past R are 0), so no [n, chunk]
//    index table is read.
//  * Offsets are 64-bit: the words reach 87 x 4 x 8 x 65536 at ICE B=8.
//  * A launch covers at most 65535 frames (the grid's y extent); the launcher
//    issues one for each run of 65535 frames, frame0 the run's first frame.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kShardThreads = 256;  // eight warps a block
constexpr int kMaxTargets = 64;     // local target shards a launch
constexpr int kMaxR = 8;            // outputs a symbol group
constexpr int kMaxFrames = 65535;   // frames a launch (the grid's y extent)

// Each local target's sources and place on the state axis, by value.
struct ShardTargets {
  const int* lo[kMaxTargets];
  const int* hi[kMaxTargets];
  long long lo_bs[kMaxTargets];  // batch strides, elements
  long long hi_bs[kMaxTargets];
  long long s2_base[kMaxTargets];  // base_j / 2
};

struct ShardCode {
  unsigned mask[kMaxR];  // |poly_r| >> 1
  int off[4];            // c(h, bit) at index 2 h + bit
  int R;
};

// The 16 bits of x spread to the even bits of a word.
__device__ __forceinline__ unsigned spread16(unsigned x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

template <bool kHalfMajor>
__global__ void __launch_bounds__(kShardThreads)
sharded_acs_step_kernel(const ShardTargets tg, const ShardCode cd, const int* __restrict__ table,
                        int* __restrict__ m_out, int* __restrict__ dec, int B, int frame0, int T,
                        int t, long long chunk, int W) {
  // Grid (s2 blocks, frames frame0.., n): no division a thread; a block is 8 whole warps of one
  // row.
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.z, b = frame0 + blockIdx.y;
  const long long row = (long long)j * B + b;
  const long long s2_loc = (long long)blockIdx.x * kShardThreads + threadIdx.x;
  bool d0 = false, d1 = false;
  if (s2_loc < chunk) {
    const unsigned s2 = (unsigned)(tg.s2_base[j] + s2_loc);
    unsigned pidx = 0;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) pidx |= (__popc(s2 & cd.mask[r]) & 1u) << r;  // masks past R are 0
    const int* trow = table + (((long long)row * T + t) << cd.R);
    const unsigned lo = (unsigned)__ldg(tg.lo[j] + b * tg.lo_bs[j] + s2_loc);
    const unsigned hi = (unsigned)__ldg(tg.hi[j] + b * tg.hi_bs[j] + s2_loc);
    const int lo0 = (int)(lo + (unsigned)__ldg(trow + (pidx ^ cd.off[0])));
    const int lo1 = (int)(lo + (unsigned)__ldg(trow + (pidx ^ cd.off[1])));
    const int hi0 = (int)(hi + (unsigned)__ldg(trow + (pidx ^ cd.off[2])));
    const int hi1 = (int)(hi + (unsigned)__ldg(trow + (pidx ^ cd.off[3])));
    d0 = hi0 < lo0;
    d1 = hi1 < lo1;
    // New state k of (j, b) lies at hrow chunk + k, plus hs from k = chunk on: hrow = 2 row
    // and hs = 0 interleaved; hrow = 2 j B + b (half 0's row) and hs = (B - 1) chunk
    // half-major.  States i = 2 s2_loc and i + 1: one 8-byte store, both in one half where
    // chunk is even; at chunk = 1 (half-major) one store a half.
    const long long i = 2 * s2_loc;
    const long long hrow = kHalfMajor ? row + (long long)j * B : 2 * row;
    const long long hs = kHalfMajor ? (long long)(B - 1) * chunk : 0;
    int* out = m_out + hrow * chunk + i;
    const int n0 = d0 ? hi0 : lo0, n1 = d1 ? hi1 : lo1;
    if (kHalfMajor && (chunk & 1)) {
      out[0] = n0;
      out[1 + hs] = n1;
    } else {
      *reinterpret_cast<int2*>(out + (i >= chunk ? hs : 0)) = make_int2(n0, n1);
    }
  }
  if (dec == nullptr) return;
  const unsigned b0 = __ballot_sync(kFull, d0), b1 = __ballot_sync(kFull, d1);
  // Lane 0 writes the word of the warp's states 0-31, lane 1 that of 32-63.
  const long long w = 2 * (s2_loc >> 5) + lane;
  if (lane < 2 && w < W) {
    const int sh = 16 * lane;
    dec[row * W + w] = (int)(spread16(b0 >> sh) | (spread16(b1 >> sh) << 1));
  }
}

// ---------------------------------------------------------------------------
// The traceback over the scan's words.  For each state line (the local shards
// that share every coordinate but the state axis's; line[d] is the local index
// of the line's shard d) and frame b: from s = end[line[0], b], for t = T-1
// down to 0, the decision of state s at step t is bit s & 31 of word
// dec[t, line[s >> lg], b, (s & (2^lg - 1)) >> 5] (2^lg = S / n_state states a
// shard, a power of two: a shift and a mask, no division), and s becomes
// (s >> 1) | (k << (K-2)).  k is written to bits[line[q], b, t] for every shard
// q of the line: the [n, B, T] bits of the plain version, where every shard of
// a line holds the line's bits.
//
// What bounds it: T dependent fetches a (line, frame), each a word of a 2^16-
// word row at ICE, so a chain of load latencies; its bytes and operations are
// nothing.  The design is chainback_kernel<false, 0>'s (viterbi_small.cu): a
// warp a (line, frame); lane L, with L + 1 = 1 k_0 .. k_{d-1} in binary,
// fetches the word of the state d steps back that the decisions k_0.. lead to
// (the shard split applied to the candidate's address) and extracts its bit;
// one ballot hands the 31 bits to every lane, and up to five steps resolve in
// registers: one round trip to device memory for five steps, 18 rounds at ICE
// (T = 87), 73 for state x time's 364-step blocks.  Words are read where the
// scan wrote them ([T, n, B, W], 64-bit strides: 87 x 4 x 8 x 65536 words at
// ICE B=8); the line table comes by value.
// ---------------------------------------------------------------------------
constexpr int kWalkFrames = 8;  // (line, frame) warps a block
constexpr int kWalkDepth = 5;   // steps a round

struct WalkLines {
  int shard[kMaxTargets];  // shard[l * n_state + d]: local index of shard d of line l
};

__global__ void __launch_bounds__(kWalkFrames * 32)
sharded_walk_kernel(const int* __restrict__ dec, long long st, long long sn, long long sb,
                    const int* __restrict__ end, unsigned char* __restrict__ bits,
                    const WalkLines ln, int n_lines, int n_state, int lg, int K, int B, int T) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * kWalkFrames + (threadIdx.x >> 5);
  if (wid >= n_lines * B) return;  // whole warps
  const int l = wid / B, b = wid - l * B;
  const int* line = ln.shard + l * n_state;
  const int nrot = K - 1, lmask = (1 << lg) - 1;
  const int depth = min(kWalkDepth, nrot);  // a candidate d steps back needs d <= K-1
  int pos = end[(long long)line[0] * B + b] & ((1 << nrot) - 1);
  // This lane's candidate: d steps back on the decisions cb (lane 31: none).
  const int d = 31 - __clz(lane + 1);
  const int cb = d ? (int)(__brev((unsigned)(lane + 1) ^ (1u << d)) >> (32 - d)) : 0;
  for (int t = T - 1; t >= 0;) {
    const int n = min(depth, t + 1);
    int kc = 0;
    if (d < n) {
      const int cand = (pos >> d) | (cb << (nrot - d));
      const int loc = cand & lmask;
      const unsigned word = (unsigned)__ldg(dec + (t - d) * st + line[cand >> lg] * sn + b * sb +
                                            (loc >> 5));
      kc = (word >> (loc & 31)) & 1;
    }
    const unsigned bal = __ballot_sync(kFull, kc);
    unsigned node = 0;
#pragma unroll
    for (int e = 0; e < kWalkDepth; ++e)
      if (e < n) node = 2 * node + 1 + ((bal >> node) & 1);
    // node + 1 = 1 k_0 .. k_{n-1}: bit i of path is the decision of step t - n + 1 + i.
    const unsigned path = (node + 1) ^ (1u << n);
    if (lane < n) {
      const unsigned char k = (path >> lane) & 1;
      for (int q = 0; q < n_state; ++q)
        bits[((long long)line[q] * B + b) * T + t - n + 1 + lane] = k;
    }
    pos = (pos >> n) | ((int)(__brev(path) >> (32 - n)) << (nrot - n));
    t -= n;
  }
}

// One step t of the traceback for every local shard j and frame b (thread j B
// + b), as the plain version's step: the state first takes the previous step's
// sum ksum (null at t = T-1), which is also that step's bit; then the shard's
// own decision bit of the state, 0 where another shard owns it, goes to
// bit_out for the caller's psum.  The state and the sums stay on the card.
struct WalkCoords {
  int c[kMaxTargets];  // each local shard's coordinate along the state axis
};

__global__ void sharded_walk_step_kernel(const int* __restrict__ dec, long long st, long long sn,
                                         long long sb, int* __restrict__ state,
                                         const int* __restrict__ ksum,
                                         unsigned char* __restrict__ bits, int* __restrict__ bit_out,
                                         const WalkCoords cs, int n, int lg, int K, int B, int T,
                                         int t) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * B) return;
  const int j = idx / B, b = idx - j * B;
  int s = state[idx];
  if (ksum != nullptr) {
    const int k = ksum[idx];
    bits[(long long)idx * T + t + 1] = (unsigned char)k;
    s = (s >> 1) | (k << (K - 2));
    state[idx] = s;
  }
  int k = 0;
  if ((s >> lg) == cs.c[j]) {  // the plain version's 0 <= s - base_j < 2^lg
    const int loc = s & ((1 << lg) - 1);
    k = ((unsigned)dec[t * st + j * sn + b * sb + (loc >> 5)] >> (loc & 31)) & 1;
  }
  bit_out[idx] = k;
}

}  // namespace

extern "C" {

// One step t of the state-sharded scan over n local target shards of B
// frames.  lo, hi, lo_bs, hi_bs, s2_base: host arrays of n entries (device
// addresses of each target's [B, chunk] sources, their batch strides, base/2);
// masks: R host entries; offs: the four c(h, bit); m_out half-major (half_major
// = 1) or interleaved (0); dec may be null.  One kernel launch for each run of
// up to 65535 frames; *launches: the launches made.
int viterbi_shard_step(const long long* lo, const long long* lo_bs, const long long* hi,
                       const long long* hi_bs, const long long* s2_base, int n,
                       const unsigned* masks, int R, const int* offs, const void* table, int T,
                       int t, void* m_out, int half_major, void* dec, int B, long long chunk,
                       int* launches, void* stream) {
  *launches = 0;
  if (n < 1 || n > kMaxTargets || R < 1 || R > kMaxR || B < 1 || chunk < 1 || t < 0 || t >= T)
    return (int)cudaErrorInvalidValue;
  ShardTargets tg;
  for (int j = 0; j < n; ++j) {
    tg.lo[j] = (const int*)lo[j];
    tg.hi[j] = (const int*)hi[j];
    tg.lo_bs[j] = lo_bs[j];
    tg.hi_bs[j] = hi_bs[j];
    tg.s2_base[j] = s2_base[j];
  }
  ShardCode cd;
  for (int r = 0; r < R; ++r) cd.mask[r] = masks[r];
  for (int r = R; r < kMaxR; ++r) cd.mask[r] = 0;
  for (int k = 0; k < 4; ++k) cd.off[k] = offs[k];
  cd.R = R;
  const long long blocks = (chunk + kShardThreads - 1) / kShardThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int W = (int)((2 * chunk + 31) / 32);
  for (int b0 = 0; b0 < B; b0 += kMaxFrames) {
    const int nb = B - b0 < kMaxFrames ? B - b0 : kMaxFrames;
    const dim3 grid((unsigned)blocks, nb, n);
    if (half_major)
      sharded_acs_step_kernel<true><<<grid, kShardThreads, 0, (cudaStream_t)stream>>>(
          tg, cd, (const int*)table, (int*)m_out, (int*)dec, B, b0, T, t, chunk, W);
    else
      sharded_acs_step_kernel<false><<<grid, kShardThreads, 0, (cudaStream_t)stream>>>(
          tg, cd, (const int*)table, (int*)m_out, (int*)dec, B, b0, T, t, chunk, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return (int)cudaSuccess;
}

// The whole traceback over the words dec (element (t, j, b, w) at t st + j sn
// + b sb + w) from end [n, B] (contiguous) into bits [n, B, T] uint8
// (contiguous): n_lines lines of n_state local shards, line_shards their
// n_lines * n_state local indices, line-major; 2^lg states a shard.
int viterbi_shard_walk(const void* dec, long long st, long long sn, long long sb, const void* end,
                       void* bits, const int* line_shards, int n_lines, int n_state, int lg, int K,
                       int B, int T, void* stream) {
  if (n_lines < 1 || n_state < 1 || n_lines * n_state > kMaxTargets || K < 2 || K > 32 ||
      lg < 0 || B < 1 || T < 1 || (long long)n_lines * B > 0x7fffffffLL - kWalkFrames)
    return (int)cudaErrorInvalidValue;
  WalkLines ln;
  for (int i = 0; i < n_lines * n_state; ++i) ln.shard[i] = line_shards[i];
  const int warps = n_lines * B;
  sharded_walk_kernel<<<(warps + kWalkFrames - 1) / kWalkFrames, kWalkFrames * 32, 0,
                        (cudaStream_t)stream>>>((const int*)dec, st, sn, sb, (const int*)end,
                                                (unsigned char*)bits, ln, n_lines, n_state, lg, K,
                                                B, T);
  return (int)cudaGetLastError();
}

// Step t of the traceback for n local shards of B frames: state [n, B] int32
// (updated in place), ksum [n, B] int32 or null, bits [n, B, T] uint8, bit_out
// [n, B] int32, all contiguous; coords: n host entries.
int viterbi_shard_walk_step(const void* dec, long long st, long long sn, long long sb,
                            void* state, const void* ksum, void* bits, void* bit_out,
                            const int* coords, int n, int lg, int K, int B, int T, int t,
                            void* stream) {
  if (n < 1 || n > kMaxTargets || K < 2 || K > 32 || lg < 0 || B < 1 || t < 0 || t >= T ||
      (ksum != nullptr && t + 1 >= T) || (long long)n * B > 0x7fffffffLL - 256)
    return (int)cudaErrorInvalidValue;
  WalkCoords cs;
  for (int j = 0; j < n; ++j) cs.c[j] = coords[j];
  const int threads = 256, blocks = (n * B + threads - 1) / threads;
  sharded_walk_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)dec, st, sn, sb, (int*)state, (const int*)ksum, (unsigned char*)bits,
      (int*)bit_out, cs, n, lg, K, B, T, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
