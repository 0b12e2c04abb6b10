// One trellis step of the state-sharded butterfly on Hopper (sm_90a), bound to
// Python with ctypes through the extern "C" launcher at the end of this file.
//
//   sharded_acs_step_kernel   one step of the jnp scan of parallel/statewise.py
//                             _sharded_acs_scan (the JAX package's line 90), for
//                             every local target shard and every frame
//
// It replaces no Pallas kernel: the JAX package runs the scan as jnp inside a
// shard_map, fused by XLA.  The wrapper is ops/cuda/shard.py; the plain
// version, a round of PyTorch operations a step, is parallel/statewise.py
// _sharded_acs_scan_ref.  The exchange between steps stays outside: in one
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
//   m_out        [n, B, 2 chunk] int32, contiguous
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kShardThreads = 256;  // eight warps a block
constexpr int kMaxTargets = 64;     // local target shards a launch
constexpr int kMaxR = 8;            // outputs a symbol group

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

__global__ void __launch_bounds__(kShardThreads)
sharded_acs_step_kernel(const ShardTargets tg, const ShardCode cd, const int* __restrict__ table,
                        int* __restrict__ m_out, int* __restrict__ dec, int B, int T, int t,
                        long long chunk, int W) {
  // Grid (s2 blocks, B, n): no division a thread; a block is 8 whole warps of one row.
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.z, b = blockIdx.y;
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
    *reinterpret_cast<int2*>(m_out + row * 2 * chunk + 2 * s2_loc) =
        make_int2(d0 ? hi0 : lo0, d1 ? hi1 : lo1);
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

}  // namespace

extern "C" {

// One step t of the state-sharded scan over n local target shards of B
// frames.  lo, hi, lo_bs, hi_bs, s2_base: host arrays of n entries (device
// addresses of each target's [B, chunk] sources, their batch strides, base/2);
// masks: R host entries; offs: the four c(h, bit); dec may be null.
int viterbi_shard_step(const long long* lo, const long long* lo_bs, const long long* hi,
                       const long long* hi_bs, const long long* s2_base, int n,
                       const unsigned* masks, int R, const int* offs, const void* table, int T,
                       int t, void* m_out, void* dec, int B, long long chunk, void* stream) {
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
  if (blocks > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  const int W = (int)((2 * chunk + 31) / 32);
  sharded_acs_step_kernel<<<dim3((unsigned)blocks, B, n), kShardThreads, 0, (cudaStream_t)stream>>>(
      tg, cd, (const int*)table, (int*)m_out, (int*)dec, B, T, t, chunk, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
