// The table walk for large trellises (K > 15) on Hopper (sm_90a), bound to
// Python with ctypes through the extern "C" launchers at the end of this file.
//
//   plane_walk_kernel   the table walk of ops/radix_planes.py
//                       chainback_plane_bits: 8 or 4 steps a fetch from the f8 /
//                       f4 walk tables (wrapper: ops/cuda/walk.py chainback_planes)
//
// It replaces no Pallas kernel: the JAX package runs the walk as jnp.  (The
// canonical words of the large-K updates walk on chainback_kernel in
// viterbi_small.cu, up to K=24.)  The walk is a chain of dependent loads a
// frame: the address of each fetch is the state that the fetch before it
// produced, so a frame's time is its fetches times the card's load latency,
// and frames run side by side.
//
// Layouts (int32 words holding uint32 bits, as the Python side makes them):
//   f8     [n8, 8, B, W]   byte s&3 of word (plane (s>>2)&7, s>>5): state s's
//                          8-step field of its window
//   f4     [n4, 4, B, W]   nibble (s>>2)&7 of word (plane s&3, s>>5)
//   g2     [n2, B, W]      bit s&31 of word s>>5: the G_2 plane of a step pair
//   words  [T, B, W]       time-major decision words (any t and b strides)
// W = 2^(K-6) words a step.  Windows are anchored at step `anchor`: window p
// of width w covers steps [anchor + w p, anchor + w (p + 1)).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPlaneThreads = 32;  // frames a block of the table walk

// The end state of frame b: a scalar, or an int32 or uint8 tensor read with
// `stride` elements between frames (0: one value for all).
__device__ __forceinline__ int end_state(const void* ptr, int kind, long long stride, int value,
                                         int b) {
  if (kind == 1) return reinterpret_cast<const int*>(ptr)[b * stride];
  if (kind == 2) return reinterpret_cast<const unsigned char*>(ptr)[b * stride];
  return value;
}

// ---------------------------------------------------------------------------
// Table walk: a thread a frame.  The plan is plane_plan's: from t = T down to
// `anchor`, the widest window (maxw, then 4, 2, 1) that stays above the
// anchor and ends on a multiple of its width; a width-8 or width-4 window is
// one fetch, a width-2 window two independent ones (g2 and the step's word),
// a width-1 window one.  Window [t0, t0 + w) yields the field F of the state
// s at t0 + w: step t0 + j takes bit w-1-j of F, and the walk moves to
// s = (s >> w) | (F << (K-1-w)).  Kept bits are the steps K-1 .. K-1+nbits-1
// (data bit i is step K-1+i); `packed` writes them MSB-first into bytes,
// else one byte a bit.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kPlaneThreads)
plane_walk_kernel(const int* __restrict__ f8, const int* __restrict__ f4,
                  const int* __restrict__ g2, const int* __restrict__ words, long long wst,
                  long long wsb, const void* end_ptr, int end_kind, long long end_stride,
                  int end_value, unsigned char* __restrict__ out, int* __restrict__ state_out,
                  int K, int B, int T, int anchor, int maxw, int nbits, int packed) {
  const int b = blockIdx.x * kPlaneThreads + threadIdx.x;
  if (b >= B) return;
  const int n = K - 1, W = 1 << (n - 5), mask = (1 << n) - 1;
  const size_t BW = (size_t)B * W;
  int s = end_state(end_ptr, end_kind, end_stride, end_value, b) & mask;
  const int nbytes = nbits >> 3;
  int cur = -1;  // the byte being filled (packed), walked from the top down
  unsigned acc = 0;
  int t = T;
  while (t > anchor) {
    int w = maxw;
    while (w > 1 && (t - w < anchor || (t - anchor) % w)) w >>= 1;
    const int t0 = t - w, a0 = t0 - anchor;
    unsigned F;
    if (w == 8) {
      const unsigned word =
          (unsigned)f8[(size_t)((a0 >> 3) * 8 + ((s >> 2) & 7)) * BW + (size_t)b * W + (s >> 5)];
      F = (word >> ((s & 3) * 8)) & 0xFFu;
    } else if (w == 4) {
      const unsigned word =
          (unsigned)f4[(size_t)((a0 >> 2) * 4 + (s & 3)) * BW + (size_t)b * W + (s >> 5)];
      F = (word >> (((s >> 2) & 7) * 4)) & 0xFu;
    } else if (w == 2) {
      const unsigned g = (unsigned)g2[(size_t)(a0 >> 1) * BW + (size_t)b * W + (s >> 5)];
      const unsigned d = (unsigned)words[(t0 + 1) * wst + b * wsb + (s >> 5)];
      F = (((g >> (s & 31)) & 1u) << 1) | ((d >> (s & 31)) & 1u);
    } else {
      const unsigned d = (unsigned)words[t0 * wst + b * wsb + (s >> 5)];
      F = (d >> (s & 31)) & 1u;
    }
    s = (s >> w) | (int)(F << (n - w));
    for (int j = w - 1; j >= 0; --j) {
      const int i = t0 + j - n;  // data bit of step t0 + j
      if (i < 0 || i >= nbits) continue;
      const unsigned bit = (F >> (w - 1 - j)) & 1u;
      if (packed) {
        if ((i >> 3) != cur) {
          if (cur >= 0) out[(size_t)b * nbytes + cur] = (unsigned char)acc;
          cur = i >> 3;
          acc = 0;
        }
        acc |= bit << (7 - (i & 7));
      } else {
        out[(size_t)b * nbits + i] = (unsigned char)bit;
      }
    }
    t = t0;
  }
  if (packed && cur >= 0) out[(size_t)b * nbytes + cur] = (unsigned char)acc;
  if (state_out) state_out[b] = s;
}

// A measurement, not a port kernel: one thread follows `n` links of the
// cycle `next` (a random permutation of a buffer larger than L2), so each
// load waits for the one before; the time over the links is the card's
// dependent-load latency, the unit of the walks' bound.
__global__ void chase_kernel(const int* __restrict__ next, int n, int* __restrict__ out) {
  int p = 0;
  for (int i = 0; i < n; ++i) p = next[p];
  *out = p;
}

}  // namespace

extern "C" {

// The table walk.  f8, f4, g2 and words may be null where the plan does not
// reach them (ops/cuda/walk.py checks what it needs); end_kind 0 takes
// end_value for every frame, 1 an int32 and 2 a uint8 tensor at end_ptr with
// end_stride elements between frames.  state_out may be null.
int viterbi_plane_walk(const void* f8, const void* f4, const void* g2, const void* words,
                       long long wst, long long wsb, const void* end_ptr, int end_kind,
                       long long end_stride, int end_value, void* out, void* state_out, int K,
                       int B, int T, int anchor, int maxw, int nbits, int packed,
                       void* stream) {
  if (K < 10 || K > 31 || B < 1 || T < 0 || anchor < 0 || anchor > K - 1 || nbits < 0 ||
      (maxw != 4 && maxw != 8) || (packed && nbits % 8))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kPlaneThreads - 1) / kPlaneThreads;
  plane_walk_kernel<<<blocks, kPlaneThreads, 0, (cudaStream_t)stream>>>(
      (const int*)f8, (const int*)f4, (const int*)g2, (const int*)words, wst, wsb, end_ptr,
      end_kind, end_stride, end_value, (unsigned char*)out, (int*)state_out, K, B, T, anchor,
      maxw, nbits, packed);
  return (int)cudaGetLastError();
}

// The load-latency measurement (harness/probe_walk.py load_latency_ns).
int viterbi_chase(const void* next, int n, void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, n, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
