// K-warp-b: the backward of the augmentation warp's bilinear sampling, for
// sm_90a, with no atomics.
//
// Replaces no Pallas kernel. The JAX package warps each augmented cutout
// with jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")
// (cgd_tpu/guidance/cutouts.py:151), whose transpose XLA lowers to a
// scatter that is deterministic on the TPU and the CPU. The port's forward
// gathers four taps (kernels/warp.py), and autograd's backward of a gather
// on a card is scatter_add_ with float atomics: the order of the additions,
// and so the rounded gradient, changes from run to run, and a resumed
// use_augs run could not equal the uninterrupted one.
//
// The (tap, output pixel) pairs come sorted by their bin
// (cutout * h * w + source pixel) * 4 + tap, in a stable order
// (kernels/warp.py warp_index, once per call): a source pixel's segment
// holds its four taps' bins one after another, each in output pixel order,
// and `offsets` gives every bin's first pair. For each (source pixel,
// channel) and tap t,
//   S_t = sum_j w[j] * g[pair[j], ch]   over the pairs j of bin (pixel, t),
// each product rounded, then added in f32 one after another (no FMA
// contraction), and dx = ((S3 + S2) + S1) + S0: the order of a gather's
// autograd backward on the CPU (each tap's scatter in output order, the
// taps' gradients summed from the last), and of the plain version. The
// kernel, the plain version run on the CPU and that backward agree bit for
// bit on the same inputs, and reruns are identical.
//
// Bound: bytes. It reads g (n*h*w*c f32), the sorted weights and pairs
// (4*n*h*w each, f32 and int32), the bins' starts and the long segments'
// list, and writes dx (n*h*w*c f32): a few FLOPs a byte. What limits it is
// the dependent load chain start -> pair -> g row, and the segments' skew:
// at 16 cutouts of 224^2 the average segment holds 4 pairs, but a clamped
// corner collects ~3,500 (walked by one thread, a dependent load chain of
// ~160 ns a pair, the longest segment alone would set the kernel's time).
// Design, one launch with two kinds of block:
//  * the first LONG_BLOCKS blocks take the segments longer than long_pairs,
//    from the list warp_index made, in turn: a warp per tap, its lanes
//    loading 32 * LONG_R pairs at once (pairs and weights coalesced, the
//    next round's in flight while this round is summed), each lane forming
//    its rounded products into shared memory, which one lane per channel
//    then adds in order: the additions stay one chain per (tap, channel),
//    only the loads run in parallel. These blocks come first, so the
//    longest chains start at once.
//  * the other blocks take one source pixel a thread, all its channels
//    (up to CG at a time, so the index entries are read once for c <= 4):
//    SHORT_K pairs' loads issued before their additions; a thread whose
//    segment is long leaves it to the first kind.
#include <cuda_runtime.h>

namespace cgd {
namespace warpb {

constexpr int TAPS = 4;
constexpr int THREADS = 128;  // a long segment's block: one warp per tap
constexpr int CG = 4;         // channels a thread carries at once
constexpr int SHORT_K = 8;    // pairs of a short segment loaded at once
constexpr int LONG_R = 4;     // pairs each lane loads in a round of a long bin
constexpr int ROUND = 32 * LONG_R;
constexpr int LONG_BLOCKS = 1024;

// one round's pairs and weights of bin [.., end) from `base`, lane-strided
__device__ __forceinline__ void load_round(const int* __restrict__ pair,
                                           const float* __restrict__ w, int base, int end,
                                           int lane, int (&p)[LONG_R], float (&wv)[LONG_R]) {
#pragma unroll
  for (int r = 0; r < LONG_R; ++r) {
    const int j = base + r * 32 + lane;
    p[r] = j < end ? pair[j] : 0;
    wv[r] = j < end ? w[j] : 0.0f;
  }
}

// The long segments: block i takes list entries i, i + long_blocks, ...; warp
// t sums bin (s, t) over every channel group, and the block adds the taps.
__device__ void long_segments(const float* __restrict__ g, const float* __restrict__ w,
                              const int* __restrict__ pair, const int* __restrict__ offsets,
                              const int* __restrict__ long_list, int n_long,
                              float* __restrict__ dx, int c, int long_blocks) {
  __shared__ float4 tile[TAPS][ROUND];  // a round's products, (pair, channel group)
  __shared__ float part[TAPS][CG];      // each tap's sums
  const int tap = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* mine = tile[tap];
  const float* flat = reinterpret_cast<const float*>(mine);
  for (int i = blockIdx.x; i < n_long; i += long_blocks) {
    const int s = long_list[i];
    const int a = offsets[s * TAPS + tap], b = offsets[s * TAPS + tap + 1];
    for (int c0 = 0; c0 < c; c0 += CG) {
      const int cg = min(CG, c - c0);
      float acc = 0.0f;  // lane ch < cg: this tap's sum of channel c0 + ch
      int pn[LONG_R];
      float wn[LONG_R];
      load_round(pair, w, a, b, lane, pn, wn);
      for (int base = a; base < b; base += ROUND) {
        float gv[LONG_R][CG];  // the pairs' g rows
#pragma unroll
        for (int r = 0; r < LONG_R; ++r) {
          const bool in = base + r * 32 + lane < b;
          const float* row = g + (long long)pn[r] * c + c0;
#pragma unroll
          for (int ch = 0; ch < CG; ++ch) gv[r][ch] = in && ch < cg ? row[ch] : 0.0f;
        }
        float wv[LONG_R];
#pragma unroll
        for (int r = 0; r < LONG_R; ++r) wv[r] = wn[r];
        load_round(pair, w, base + ROUND, b, lane, pn, wn);  // in flight through the sum
#pragma unroll
        for (int r = 0; r < LONG_R; ++r)
          mine[r * 32 + lane] =
              make_float4(__fmul_rn(wv[r], gv[r][0]), __fmul_rn(wv[r], gv[r][1]),
                          __fmul_rn(wv[r], gv[r][2]), __fmul_rn(wv[r], gv[r][3]));
        __syncwarp();
        if (lane < cg) {
          const int count = min(ROUND, b - base);
#pragma unroll 8
          for (int k = 0; k < count; ++k) acc = __fadd_rn(acc, flat[k * CG + lane]);
        }
        __syncwarp();
      }
      if (lane < cg) part[tap][lane] = acc;
      __syncthreads();
      if (threadIdx.x < cg) {
        const int ch = threadIdx.x;
        dx[(long long)s * c + c0 + ch] =
            __fadd_rn(__fadd_rn(__fadd_rn(part[3][ch], part[2][ch]), part[1][ch]), part[0][ch]);
      }
      __syncthreads();
    }
  }
}

// A short segment: one thread, every channel group, SHORT_K pairs at a time.
__device__ void short_segment(const float* __restrict__ g, const float* __restrict__ w,
                              const int* __restrict__ pair, const int* __restrict__ offsets,
                              float* __restrict__ dx, int s, int c, int long_pairs) {
  const int4 o = reinterpret_cast<const int4*>(offsets)[s];  // bins (s, 0..3)
  const int end = offsets[s * TAPS + TAPS];
  if (end - o.x > long_pairs) return;  // a long segment: the first blocks' work
  for (int c0 = 0; c0 < c; c0 += CG) {
    const int cg = min(CG, c - c0);
    float sum[TAPS][CG];
#pragma unroll
    for (int t = 0; t < TAPS; ++t)
#pragma unroll
      for (int ch = 0; ch < CG; ++ch) sum[t][ch] = 0.0f;
    for (int base = o.x; base < end; base += SHORT_K) {
      int p[SHORT_K];
      float wv[SHORT_K], gv[SHORT_K][CG];
#pragma unroll
      for (int k = 0; k < SHORT_K; ++k) {
        const bool in = base + k < end;
        p[k] = in ? pair[base + k] : 0;
        wv[k] = in ? w[base + k] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < SHORT_K; ++k) {
        const bool in = base + k < end;
        const float* row = g + (long long)p[k] * c + c0;
#pragma unroll
        for (int ch = 0; ch < CG; ++ch) gv[k][ch] = in && ch < cg ? row[ch] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < SHORT_K; ++k) {
        const int j = base + k;
        if (j < end) {
          const int t = (j >= o.y) + (j >= o.z) + (j >= o.w);
#pragma unroll
          for (int ch = 0; ch < CG; ++ch) {
            const float v = __fmul_rn(wv[k], gv[k][ch]);
#pragma unroll
            for (int u = 0; u < TAPS; ++u)  // registers, not a local array indexed at run time
              if (u == t) sum[u][ch] = __fadd_rn(sum[u][ch], v);
          }
        }
      }
    }
#pragma unroll
    for (int ch = 0; ch < CG; ++ch)
      if (ch < cg)
        dx[(long long)s * c + c0 + ch] = __fadd_rn(
            __fadd_rn(__fadd_rn(sum[3][ch], sum[2][ch]), sum[1][ch]), sum[0][ch]);
  }
}

__global__ void __launch_bounds__(THREADS) warp_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ w, const int* __restrict__ pair,
    const int* __restrict__ offsets, const int* __restrict__ long_list,
    const int* __restrict__ n_long, float* __restrict__ dx, int nsrc, int c, int long_pairs,
    int long_blocks) {
  if ((int)blockIdx.x < long_blocks) {  // uniform per block: the barriers inside are safe
    long_segments(g, w, pair, offsets, long_list, *n_long, dx, c, long_blocks);
    return;
  }
  const int s = ((int)blockIdx.x - long_blocks) * THREADS + (int)threadIdx.x;
  if (s < nsrc) short_segment(g, w, pair, offsets, dx, s, c, long_pairs);
}

}  // namespace warpb
}  // namespace cgd

// g, dx: [nsrc, c] f32; w, pair: [4 * nsrc] f32 and int32 (pair: the output
// pixel); offsets: [4 * nsrc + 1] int32, each (source pixel, tap) bin's
// first pair; long_list: [nsrc] int32, the source pixels whose segment holds
// more than long_pairs pairs first, ascending; n_long: [1] int32, their
// number (read on the device: no host sync).
extern "C" int cgd_warp_bwd(const void* g, const void* w, const void* pair, const void* offsets,
                            const void* long_list, const void* n_long, void* dx, int nsrc, int c,
                            int long_pairs, void* stream) {
  using namespace cgd::warpb;
  if (nsrc <= 0 || c <= 0 || long_pairs < 0) return (int)cudaErrorInvalidValue;
  const int long_blocks = nsrc < LONG_BLOCKS ? nsrc : LONG_BLOCKS;
  const unsigned blocks = (unsigned)(long_blocks + (nsrc + THREADS - 1) / THREADS);
  warp_bwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(w), static_cast<const int*>(pair),
      static_cast<const int*>(offsets), static_cast<const int*>(long_list),
      static_cast<const int*>(n_long), static_cast<float*>(dx), nsrc, c, long_pairs, long_blocks);
  return (int)cudaGetLastError();
}
