// Whole-frame Viterbi kernels for Hopper (sm_90a): the four kernels of the
// small-trellis decode path, bound to Python with ctypes through the plain
// extern "C" launchers at the end of this file.
//
//   acs_tb_kernel         replaces ops/pallas/kernels.py  acs_update_tb   (_acs_kernel)
//   chainback_kernel<ROT=false>  replaces ops/pallas/kernels.py  chainback_tb    (_chainback_kernel)
//   acs_inplace_kernel    replaces ops/pallas/inplace.py  acs_update_inplace (_acs_inplace_kernel)
//   chainback_kernel<ROT=true>   replaces ops/pallas/inplace.py  chainback_inplace  (_chainback_inplace_kernel)
//
// Layouts are those of the Pallas kernels (state-major, batch last):
//   metrics  [S, B] int32
//   symbols  [Tp, R, B] int32           (Tp >= t_real; steps >= t_real unread)
//   words    [Tp, W, B] int32 (uint32 bits), W = max(1, S/32)
//   etab     [S/2] int32, bit 8*x + r = transition_tables(code)[x, r, s2]
//   endstate [B] int32
//   bits     [NW, B] int32, bit t%32 of word t/32 = walk output at step t
//
// What bounds them on the card.  The ACS sweep is a serial recurrence over T
// steps per frame; its bytes (symbols in, words out) are small, and at the
// main path's shapes its operation count bounds it on paper.  In practice the
// per-step latency of one block (penalties, compare-select, a barrier, the
// ballot) bounds it: one block per frame, S/2 threads (K=7: one warp) each
// owning butterfly pairs, metrics and decisions in shared memory.  Symbols
// are staged 32 steps at a time into shared memory so that no global load
// sits on the per-step critical path.  The traceback is one thread per
// frame walking T dependent steps; it is bound by the latency of that chain,
// and for W <= 2 (K <= 7) it copies all words of 32 steps into shared memory
// ahead of the walk so that their loads overlap.
//
// Tie rule: a decision is c_hi < c_lo, strict; ties keep the low predecessor
// (ops/pallas/kernels.py:169, ka9q viterbi27_sse2.cpp:155-156).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStage = 32;  // symbol steps staged per shared-memory refill

__device__ __forceinline__ int rotl_bits(int x, int t, int nbits, int mask) {
  return t ? (((x << t) | (x >> (nbits - t))) & mask) : x;
}

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

// Shared-memory carve-up common to both ACS kernels.
struct Smem {
  int* m;             // metrics: 2*S (state order, ping-pong) or S (in place)
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

// State-order ACS (counterpart of kernels.py _acs_kernel).  Grid: one block
// per frame.  New state 2*s2 + b; its decision lands at bit s%32 of word s/32.
template <int R>
__global__ void acs_tb_kernel(const int* __restrict__ metrics_in, const int* __restrict__ sym,
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

// In-place ACS with rotating addresses (counterpart of inplace.py
// _acs_inplace_kernel).  At global step t = p0 + local step, state s's
// metric sits at position rotr(s, t mod (K-1)); the butterfly of compressed
// pair i reads and writes positions q and q | 2^j, so one metric buffer
// suffices.  Decisions land in position order of step t+1.
template <int R>
__global__ void acs_inplace_kernel(const int* __restrict__ metrics_in,
                                   const int* __restrict__ sym, const int* __restrict__ etab,
                                   int* __restrict__ metrics_out, int* __restrict__ dec, int K,
                                   int low, int hl, int B, int t_real, int p0) {
  const int nrot = K - 1, S = 1 << nrot, S2 = S >> 1, mask = S - 1;
  const int W = S >= 32 ? S >> 5 : 1, S32 = W * 32;
  const int b = blockIdx.x;
  Smem sm = carve(S, S2, R, S32);
  for (int s = threadIdx.x; s < S; s += blockDim.x) sm.m[s] = metrics_in[(size_t)s * B + b];
  for (int i = threadIdx.x; i < S2; i += blockDim.x) sm.et[i] = etab[i];

  int phase = p0 % nrot;
  for (int t = 0; t < t_real; ++t) {
    if ((t % kStage) == 0) {
      __syncthreads();
      stage_symbols<R>(sym, sm.ssym, t, t_real, B, b);
      __syncthreads();
    }
    unsigned char* dd = sm.dd + (t & 1) * S32;
    const int* y = sm.ssym + (t % kStage) * R;
    int base = 0, coef[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      base += y[r] - low;
      coef[r] = hl - 2 * y[r];
    }
    int j = K - 2 - phase;
    if (j < 0) j += nrot;
    const int half = 1 << j;
    for (int i = threadIdx.x; i < S2; i += blockDim.x) {
      const int q = ((i >> j) << (j + 1)) | (i & (half - 1));
      const int s2 = rotl_bits(q, phase, nrot, mask);
      int pen[4];
      penalties<R>(sm.et[s2], base, coef, pen);
      const int lo = sm.m[q], hi = sm.m[q | half];
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int c_lo = lo + pen[bb], c_hi = hi + pen[2 + bb];
        const bool d = c_hi < c_lo;
        sm.m[q | (bb * half)] = d ? c_hi : c_lo;
        dd[q | (bb * half)] = d;
      }
    }
    __syncthreads();
    pack_decisions(dd, dec, t, W, B, b);
    phase = (phase + 1 == nrot) ? 0 : phase + 1;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) metrics_out[(size_t)s * B + b] = sm.m[s];
}

// Reverse traceback, one thread per frame (counterpart of kernels.py
// _chainback_kernel, and with ROT of inplace.py _chainback_inplace_kernel,
// where state s's decision at global step t sits at position
// rotr(s, (t + 1 + p0) mod (K-1))).  PF > 0 (W == PF <= 2): before walking a
// 32-step chunk, each thread copies all PF words of its 32 steps into its own
// column of shared memory, so the chunk's loads are in flight together and
// the walk reads shared memory.  PF == 0: one dependent load per step.
constexpr int kCbThreads = 128;

template <bool ROT, int PF>
__global__ void __launch_bounds__(kCbThreads)
chainback_kernel(const int* __restrict__ dec, const int* __restrict__ endstate,
                 int* __restrict__ bits, int K, int B, int t_real, int nw, int p0) {
  __shared__ unsigned stage[PF > 0 ? 32 * PF : 1][kCbThreads];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int nrot = K - 1, S = 1 << nrot, mask = S - 1, W = S >= 32 ? S >> 5 : 1;
  int state = endstate[b] & mask;
  for (int w = (t_real + 31) >> 5; w < nw; ++w) bits[(size_t)w * B + b] = 0;
  // Rotation of the last step's decisions: (t_real - 1 + 1 + p0) mod nrot.
  int c = ROT ? (t_real + p0) % nrot : 0;

  for (int chunk = (t_real - 1) >> 5; chunk >= 0; --chunk) {
    const int t_lo = chunk << 5;
    const int last = min(31, t_real - 1 - t_lo);
    if (PF > 0) {
      // All loads first (addresses clamped to the frame), then the stores:
      // a store right behind its load would stall the thread on each one.
      unsigned v[32 * (PF > 0 ? PF : 1)];
#pragma unroll
      for (int u = 0; u < 32; ++u) {
#pragma unroll
        for (int w = 0; w < PF; ++w)
          v[u * PF + w] = (unsigned)dec[((size_t)min(t_lo + u, t_real - 1) * W + w) * B + b];
      }
#pragma unroll
      for (int i = 0; i < 32 * PF; ++i) stage[i][threadIdx.x] = v[i];
    }
    unsigned acc = 0;
    for (int u = last; u >= 0; --u) {
      int pos = state;
      if (ROT) pos = ((state >> c) | (state << (nrot - c))) & mask;
      const unsigned word =
          PF > 0 ? stage[u * PF + (pos >> 5)][threadIdx.x]
                 : (unsigned)dec[((size_t)(t_lo + u) * W + (pos >> 5)) * B + b];
      const int k = (word >> (pos & 31)) & 1;
      state = (state >> 1) | (k << (K - 2));
      acc |= (unsigned)k << u;
      if (ROT) c = c ? c - 1 : nrot - 1;
    }
    bits[(size_t)chunk * B + b] = (int)acc;
  }
}

int acs_threads(int K) {
  const int S2 = 1 << (K - 2);
  const int n = S2 < 32 ? 32 : (S2 > 1024 ? 1024 : S2);
  return (n + 31) / 32 * 32;
}

template <int R>
cudaError_t launch_acs(bool inplace, const int* m_in, const int* sym, const int* etab,
                       int* m_out, int* dec, int K, int low, int hl, int B, int t_real,
                       int p0, int smem, cudaStream_t stream) {
  const int threads = acs_threads(K);
  if (inplace) {
    cudaError_t err = cudaFuncSetAttribute(
        acs_inplace_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    acs_inplace_kernel<R><<<B, threads, smem, stream>>>(m_in, sym, etab, m_out, dec, K, low,
                                                        hl, B, t_real, p0);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        acs_tb_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    acs_tb_kernel<R><<<B, threads, smem, stream>>>(m_in, sym, etab, m_out, dec, K, low, hl, B,
                                                   t_real);
  }
  return cudaGetLastError();
}

template <bool ROT>
cudaError_t launch_chainback(const int* dec, const int* endstate, int* bits, int K, int B,
                             int t_real, int nw, int p0, cudaStream_t stream) {
  if (K < 2 || K > 15 || B < 1 || t_real < 1) return cudaErrorInvalidValue;
  const int threads = kCbThreads, blocks = (B + threads - 1) / threads;
  const int W = K - 1 >= 5 ? 1 << (K - 6) : 1;
  if (W == 1)
    chainback_kernel<ROT, 1><<<blocks, threads, 0, stream>>>(dec, endstate, bits, K, B,
                                                             t_real, nw, p0);
  else if (W == 2)
    chainback_kernel<ROT, 2><<<blocks, threads, 0, stream>>>(dec, endstate, bits, K, B,
                                                             t_real, nw, p0);
  else
    chainback_kernel<ROT, 0><<<blocks, threads, 0, stream>>>(dec, endstate, bits, K, B,
                                                             t_real, nw, p0);
  return cudaGetLastError();
}

cudaError_t acs_dispatch(bool inplace, const int* m_in, const int* sym, const int* etab,
                         int* m_out, int* dec, int K, int R, int low, int hl, int B, int t_real,
                         int p0, int smem, cudaStream_t s) {
  if (K < 2 || K > 15 || B < 1 || t_real < 1) return cudaErrorInvalidValue;
  switch (R) {
    case 1: return launch_acs<1>(inplace, m_in, sym, etab, m_out, dec, K, low, hl, B, t_real, p0, smem, s);
    case 2: return launch_acs<2>(inplace, m_in, sym, etab, m_out, dec, K, low, hl, B, t_real, p0, smem, s);
    case 3: return launch_acs<3>(inplace, m_in, sym, etab, m_out, dec, K, low, hl, B, t_real, p0, smem, s);
    case 4: return launch_acs<4>(inplace, m_in, sym, etab, m_out, dec, K, low, hl, B, t_real, p0, smem, s);
    case 5: return launch_acs<5>(inplace, m_in, sym, etab, m_out, dec, K, low, hl, B, t_real, p0, smem, s);
    case 6: return launch_acs<6>(inplace, m_in, sym, etab, m_out, dec, K, low, hl, B, t_real, p0, smem, s);
    case 7: return launch_acs<7>(inplace, m_in, sym, etab, m_out, dec, K, low, hl, B, t_real, p0, smem, s);
    case 8: return launch_acs<8>(inplace, m_in, sym, etab, m_out, dec, K, low, hl, B, t_real, p0, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// smem: dynamic shared-memory bytes of one ACS block, computed by the Python
// wrapper (ops/cuda/kernels.py acs_smem_bytes) from the carve-up above.
int viterbi_acs_tb(const void* m_in, const void* sym, const void* etab, void* m_out, void* dec,
                   int K, int R, int low, int hl, int B, int t_real, int smem, void* stream) {
  return (int)acs_dispatch(false, (const int*)m_in, (const int*)sym, (const int*)etab,
                           (int*)m_out, (int*)dec, K, R, low, hl, B, t_real, 0, smem,
                           (cudaStream_t)stream);
}

int viterbi_acs_inplace(const void* m_in, const void* sym, const void* etab, void* m_out,
                        void* dec, int K, int R, int low, int hl, int B, int t_real, int p0,
                        int smem, void* stream) {
  return (int)acs_dispatch(true, (const int*)m_in, (const int*)sym, (const int*)etab,
                           (int*)m_out, (int*)dec, K, R, low, hl, B, t_real, p0, smem,
                           (cudaStream_t)stream);
}

int viterbi_chainback_tb(const void* dec, const void* endstate, void* bits, int K, int B,
                         int t_real, int nw, void* stream) {
  return (int)launch_chainback<false>((const int*)dec, (const int*)endstate, (int*)bits, K, B,
                                      t_real, nw, 0, (cudaStream_t)stream);
}

int viterbi_chainback_inplace(const void* dec, const void* endstate, void* bits, int K, int B,
                              int t_real, int nw, int p0, void* stream) {
  return (int)launch_chainback<true>((const int*)dec, (const int*)endstate, (int*)bits, K, B,
                                     t_real, nw, p0, (cudaStream_t)stream);
}

}  // extern "C"
