// Shared by viterbi_large.cu and viterbi_large4.cu: the code description,
// branch-penalty tables, the butterfly, the decision-word packing, the quad's
// four radix-2 levels in a thread's registers, and the per-frame
// shift-to-zero renormalisation kernels of the state-blocked large-K
// kernels.  Each source includes this file into its own anonymous
// namespace.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxR = 8;
constexpr int kThreads = 256;
constexpr int kMinThreads = 1024;  // frame_min_kernel's blocks

struct Code {
  int mask[kMaxR];  // poly_r >> 1: parity of a predecessor index
  int km[4];        // bit r of km[h*2 + b]: (b & poly_r) ^ (h & poly_r >> (K-1)) ^ inv_r
  int par_q;        // parities of S/4 (pair kernel: p -> p + S/4)
  int par_1;        // parities of 1 (2p -> 2p + 1)
  int comp;         // R (high - low): q[x] + q[x ^ (2^R - 1)] for every x
  bool complement;  // every polynomial taps both register ends (all six reference codes)
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

// A shared-memory address as the 32-bit offset ld.shared takes.  A penalty
// table of 2^R entries aligned to its size turns the index XOR of a look-up
// into an XOR of the address: the row's address OR (pk << 2), XOR (x << 2).
typedef unsigned saddr_t;
__device__ __forceinline__ saddr_t saddr(const void* p) {
  return (saddr_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ int lds(saddr_t a) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts(saddr_t a, int v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// 16 or 4 bytes from device memory into shared memory without a register,
// and the wait for every such copy of the thread.
__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(saddr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(saddr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// One butterfly: predecessors lo (h=0) and hi (h=1), `a` the address of its
// (0,0) branch's table entry (the low predecessor's parities XOR km[0],
// `entry`); the survivors for input bit b go to out[b],
// c_hi - c_lo to diff[b], whose sign is the decision (ties keep the low
// predecessor).  COMP (Code::complement): the branches (0,1) and (1,0) carry
// the complement of (0,0)'s pattern and (1,1) the same, so one look-up
// serves all four, the complement's penalty being comp (R (high - low), less
// twice a shift the table holds subtracted) minus it.
template <bool COMP>
__device__ __forceinline__ void bfly(int lo, int hi, saddr_t a, int comp, const Code& c,
                                     int* out, int* diff) {
  int l0, h0, l1, h1;
  if (COMP) {
    const int bm = lds(a);
    l0 = lo + bm;
    h0 = hi + comp - bm;
    l1 = lo + comp - bm;
    h1 = hi + bm;
  } else {
    l0 = lo + lds(a);
    h0 = hi + lds(a ^ ((c.km[0] ^ c.km[2]) << 2));
    l1 = lo + lds(a ^ ((c.km[0] ^ c.km[1]) << 2));
    h1 = hi + lds(a ^ ((c.km[0] ^ c.km[3]) << 2));
  }
  out[0] = min(l0, h0);
  out[1] = min(l1, h1);
  diff[0] = h0 - l0;
  diff[1] = h1 - l1;
}

// The address of a table row's entry at the parities of state s XOR km[0].
__device__ __forceinline__ saddr_t entry(const int* row, int s, const Code& c, int R) {
  return saddr(row) | ((parities(s, c, R) ^ c.km[0]) << 2);
}

// Bits `d` (a decision in bit 0) below `bits`: bits * 2 + d.
__device__ __forceinline__ unsigned push_bit(unsigned bits, int diff) {
  return (bits << 1) | ((unsigned)diff >> 31);
}

// Decision words from bits a lane holds for 32 lanes of consecutive p
// (p >> 5 = w).  Lane l holds 16 bits, bit j = m NB + k the decision of
// state k of its group m (NB = 2^L states a group, 16 / NB groups); the word
// of group m holding lane l's bits is m * (W >> (4 - L)) + w NB + (l >> (5 -
// L)), at bit NB (l mod 32/NB) + k.  The bits cross lanes as a transposition:
// 4 - L stages swap lane bit s with bit L + s of the data (a shuffle each),
// after which lane l holds the low or high half (lane bit 4 - L) of the word
// of group m = l mod 2^(4-L); one more shuffle joins the halves and 16 lanes
// store.
template <int L>
__device__ __forceinline__ void store_words(unsigned v, int* wt, int lane, int w, int W) {
  constexpr int NB = 1 << L;
#pragma unroll
  for (int s = 0; s < 4 - L; ++s) {
    constexpr unsigned kM1[4] = {0xAAAAu, 0xCCCCu, 0xF0F0u, 0xFF00u};  // bit b of j set
    const int sh = 1 << (L + s);
    const unsigned m1 = kM1[L + s], m0 = m1 ^ 0xFFFFu;
    const bool up = (lane >> s) & 1;  // sends its bit-b-clear half up, keeps the set half
    const unsigned send = v & (up ? m0 : m1);
    const unsigned t = __shfl_xor_sync(0xffffffffu, (send << sh) >> (up ? 0 : 2 * sh), 1 << s);
    v = (v & (up ? m1 : m0)) | t;
  }
  const unsigned t = __shfl_xor_sync(0xffffffffu, v, 1 << (4 - L));
  if (((lane >> (4 - L)) & 1) == 0)
    wt[(lane & ((1 << (4 - L)) - 1)) * (W >> (4 - L)) + w * NB + (lane >> (5 - L))] =
        (int)(v | (t << 16));
}

// The words of the pair kernel's two steps from its lanes' decision bits
// (lanes hold p = 32 w + l).  v1: step t, bit 2g + b1 for state 2p + b1 +
// g S/2: word g (W/2) + 2w + l/16, bit 2 (l mod 16) + b1.  v2: step t+1, bit
// k for state 4p + k: word 4w + l/8, bit 4 (l mod 8) + k, at wt + wst; the
// G_2 plane (gt, null for none) alike, bit k the step-t decision at the
// predecessor state 4p + k's survivor came from.
__device__ __forceinline__ void pair_words(unsigned v1, unsigned v2, int lane, int w, int W,
                                           int* wt, long long wst, int* gt) {
  // Step t: swap g with lane bit 0, then OR 8 lanes' 4 bits into a word.
  const bool up = lane & 1;
  const unsigned t = __shfl_xor_sync(0xffffffffu, ((v1 & (up ? 3u : 12u)) << 2) >> (up ? 0 : 4), 1);
  unsigned x = ((v1 & (up ? 12u : 3u)) | t) << (4 * ((lane >> 1) & 7));
#pragma unroll
  for (int o = 2; o < 16; o <<= 1) x |= __shfl_xor_sync(0xffffffffu, x, o);
  if ((lane & 14) == 0) wt[(lane & 1) * (W >> 1) + 2 * w + (lane >> 4)] = (int)x;
  // Step t+1 (and G_2): OR 8 lanes' 4 bits into a word.
  unsigned y = v2 << (4 * (lane & 7));
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) y |= __shfl_xor_sync(0xffffffffu, y, o);
  if ((lane & 7) == 0) wt[wst + 4 * w + (lane >> 3)] = (int)y;
  if (gt != nullptr) {
    // bit k: v1 bit 2 d + (k >> 1), d = bit k of v2
    const unsigned a = (v1 & 1u) * 3u | ((v1 >> 1) & 1u) * 12u;         // g = 0
    const unsigned b = ((v1 >> 2) & 1u) * 3u | ((v1 >> 3) & 1u) * 12u;  // g = 1
    unsigned z = ((a & ~v2) | (b & v2)) << (4 * (lane & 7));
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) z |= __shfl_xor_sync(0xffffffffu, z, o);
    if ((lane & 7) == 0) gt[4 * w + (lane >> 3)] = (int)z;
  }
}

// The quad (viterbi_large4.cu's octet kernel; the on-chip kernel's
// four-step body in viterbi_large.cu): thread p (0 <= p < S/16) owns the
// predecessors p + k S/16 (k < 16) and runs four steps on them in registers,
// the finals 16p .. 16p+15.  What a level writes besides the metrics: words,
// or the fields of viterbi_large4.cu's walk tables.
enum Mode { kWords = 0, kF4 = 1, kF8 = 2 };

// The parities of the uniform parts of a level's predecessor indices.
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

// A trellis's Quad, on the host.
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

// mn[b] = the minimum of frame b's S metrics, written (no prefilled row);
// with `off`, also off[b] = 0, so that a call's first launch needs no
// zero-filled offset.  One cluster of blockDim.x-thread blocks a frame,
// grid (cluster size, B): each block takes the frame minimum of its share
// (four 16-byte loads in flight a thread), block rank 0 joins the blocks'
// minima through distributed shared memory.  S is a multiple of 4.
__global__ void __launch_bounds__(kMinThreads)
frame_min_kernel(const int* __restrict__ m, int S, int* __restrict__ mn, int* __restrict__ off) {
  __shared__ int part[kMinThreads / 32];
  __shared__ int bmin;
  cg::cluster_group cl = cg::this_cluster();
  const int b = blockIdx.y, rank = (int)cl.block_rank(), ncl = (int)cl.num_blocks();
  const int4* f = reinterpret_cast<const int4*>(m + (size_t)b * S);
  const int n = S >> 2, stride = ncl * blockDim.x;
  int v = INT_MAX;
  int i = rank * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n; i += 4 * stride) {
    const int4 x0 = f[i], x1 = f[i + stride], x2 = f[i + 2 * stride], x3 = f[i + 3 * stride];
    v = min(v, min(min(min(x0.x, x0.y), min(x0.z, x0.w)), min(min(x1.x, x1.y), min(x1.z, x1.w))));
    v = min(v, min(min(min(x2.x, x2.y), min(x2.z, x2.w)), min(min(x3.x, x3.y), min(x3.z, x3.w))));
  }
  for (; i < n; i += stride) {
    const int4 x = f[i];
    v = min(v, min(min(x.x, x.y), min(x.z, x.w)));
  }
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < (blockDim.x >> 5) ? part[threadIdx.x] : INT_MAX;
    v = __reduce_min_sync(0xffffffffu, v);
    if (threadIdx.x == 0) bmin = v;
  }
  cl.sync();
  if (rank == 0 && threadIdx.x < 32) {
    v = (int)threadIdx.x < ncl ? *cl.map_shared_rank(&bmin, (int)threadIdx.x) : INT_MAX;
    v = __reduce_min_sync(0xffffffffu, v);
    if (threadIdx.x == 0) {
      mn[b] = v;
      if (off != nullptr) off[b] = 0;
    }
  }
  cl.sync();  // no block leaves while rank 0 may still read its minimum
}

// m[b, :] -= sub[b]; off[b] += sub[b].
__global__ void __launch_bounds__(kThreads)
frame_sub_kernel(int* __restrict__ m, int S, const int* __restrict__ sub, int* __restrict__ off) {
  const int b = blockIdx.y;
  const int sh = sub[b];
  if (blockIdx.x == 0 && threadIdx.x == 0) off[b] += sh;
  int4* f = reinterpret_cast<int4*>(m + (size_t)b * S);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < (S >> 2); i += gridDim.x * blockDim.x) {
    const int4 x = f[i];
    f[i] = make_int4(x.x - sh, x.y - sh, x.z - sh, x.w - sh);
  }
}

dim3 reduce_grid(int S, int B) {
  const int per = kThreads * 8;
  int n = ((S >> 2) + per - 1) / per;
  return dim3(n < 1024 ? n : 1024, B);
}

// Blocks a frame of frame_min_kernel: up to 16 (a non-portable cluster,
// which Hopper allows), at least 16 int4 loads a thread.
cudaError_t frame_min(const int* m, int S, int B, int* mn, int* off, cudaStream_t s) {
  int cl = 1;
  while (cl < 16 && (S >> 2) >= 2 * cl * kMinThreads * 16) cl *= 2;
  cudaError_t err = cudaFuncSetAttribute(frame_min_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, B);
  cfg.blockDim = dim3(kMinThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, frame_min_kernel, m, S, mn, off);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Code make_code(const int* polys, int K, int R, int inv, int low, int hl) {
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
  const int full = (1 << R) - 1;
  c.comp = R * (hl - 2 * low);
  c.complement = c.km[1] == (c.km[0] ^ full) && c.km[2] == (c.km[0] ^ full) && c.km[3] == c.km[0];
  return c;
}

}  // namespace
