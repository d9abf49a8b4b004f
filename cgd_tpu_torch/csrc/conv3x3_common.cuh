// Shared implicit-GEMM main loop for the 3x3, stride-1, pad-1 NHWC convs.
//
// GEMM view: M = output pixels of one image (H*W), N = output channels,
// K = 9*Cin, ordered tap-major exactly like an HWIO weight flattened to
// [9*Cin, Cout]. A block owns a BM x BN output tile of one image
// (blockIdx.z = batch index, so an M tile never straddles two images and a
// per-tile reduction over M stays per-image). Each BK-wide K slice lies
// inside one tap (Cin % BK == 0; the wrapper zero-pads skinny Cin), so the
// A rows of a slice are one shifted, masked read of the NHWC input: the pad-1
// halo is built here by masked loads, with no padded copy of x.
//
// Bound on the H100: for Cin >= 256 these convs are compute-bound
// (about 2*9*Cin FLOP per output element against a few bytes of traffic),
// so the design keeps the tensor cores fed simply: bf16 WMMA 16x16x16 tiles
// with f32 accumulators, and a ring of STAGES shared-memory stages filled by
// cp.async, so that STAGES-1 K slices are in flight from L2 while one is
// multiplied (the loads, not the MMAs, bound a one-deep prefetch). The
// prologue's activation is applied in shared memory, by the thread that
// copied the chunk, once the chunk has landed. wgmma, TMA and warp
// specialisation are left for later work.
//
// Small images (the 16x16 and 8x8 levels: one or two M tiles) give too few
// blocks to fill 132 SMs, so the launchers split K across blocks
// (blockIdx.z = split * batch + b): each split writes its f32 partial tile
// to a workspace, and a second pass sums the splits in a fixed order before
// the epilogue, which keeps the result deterministic.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace cgd {

using namespace nvcuda;

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 128;  // output channels per block
constexpr int BK = 32;   // K slice: 32 input channels of one tap
constexpr int NTHREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int WARP_M = 32;     // per-warp tile: 2 x 4 WMMA fragments
constexpr int WARP_N = 64;
constexpr int FM = WARP_M / 16;
constexpr int FN = WARP_N / 16;
constexpr int A_LD = BK + 8;  // shared-memory pitches (bf16), padded against
constexpr int B_LD = BN + 8;  // bank conflicts; multiples of 8 as WMMA needs

constexpr int STAGES = 4;  // cp.async ring depth
constexpr int A_BYTES = BM * A_LD * 2;  // one A stage
constexpr int B_BYTES = BK * B_LD * 2;  // one B stage
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int C_BYTES = (NTHREADS / 32) * 16 * 16 * 4;  // per-warp epilogue tile
constexpr int SMEM_A = 0;  // stage 0's A tile; reused for the K-dx column sums
constexpr int SMEM_C = STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = SMEM_C + C_BYTES;  // 83968: dynamic shared memory
static_assert(STAGE_BYTES % 128 == 0 && A_BYTES % 128 == 0, "stage alignment");
static_assert(2 * SMEM_BYTES <= 227 * 1024, "two blocks per SM");

// Dynamic shared memory above 48 KB must be allowed once per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// Fast sigmoid (a few ulp): the prologue evaluates it once per loaded element
// per tap and N tile, so a full-precision division dominated its cost.
// exp(-v) = inf for very negative v gives __fdividef(1, inf) = 0, as wanted.
__device__ __forceinline__ float sigmoidf_(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

// Output pixel (oy, ox) of row `row` of M tile `mt` in an h x w image, and
// whether it lies inside. TILE_W == 0: a tile is BM consecutive pixels in
// row-major order (K-fwd, K-dx). TILE_W > 0: a tile is a (BM / TILE_W) x
// TILE_W patch, tiles row-major over the image (K-dx-w): at W = 512 a
// 128-pixel row segment reads a 3 x 130-pixel halo, an 8 x 16 patch 10 x 18.
template <int TILE_W>
__device__ __forceinline__ bool tile_pixel(int mt, int row, int h, int w, int& oy, int& ox) {
  if constexpr (TILE_W == 0) {
    const int p = mt * BM + row;
    oy = p / w;
    ox = p - oy * w;
    return p < h * w;
  } else {
    static_assert(BM % TILE_W == 0, "whole rows per tile");
    const int tiles_x = (w + TILE_W - 1) / TILE_W;
    const int ty = mt / tiles_x, tx = mt - ty * tiles_x;
    oy = ty * (BM / TILE_W) + row / TILE_W;
    ox = tx * TILE_W + row % TILE_W;
    return oy < h && ox < w;
  }
}

// One block's K loop over K slices [kt_begin, kt_end) for M tile m0 / BM
// (pixels mapped by tile_pixel<TILE_W>). src: NHWC bf16 [batch, hs, ws, cin] (hs/ws are the
// SOURCE dims; with UP the conv runs on the nearest-2x image of size
// 2hs x 2ws, read as src[oy/2, ox/2]). w: [9*cin, cout] bf16. With PROLOGUE
// each loaded element becomes bf16(silu(x*A + B)) (A/B: [batch, cin] f32),
// and taps outside the image load zero AFTER the activation, which is the
// conv's zero padding of the activated tensor.
template <bool PROLOGUE, bool UP, int TILE_W = 0>
__device__ __forceinline__ void conv_mainloop(
    const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ Avec, const float* __restrict__ Bvec,
    int hs, int ws, int cin, int cout, int b, int m0, int n0, int kt_begin, int kt_end,
    unsigned char* smem, AccFrag (&acc)[FM][FN]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int ho = UP ? 2 * hs : hs;
  const int wo = UP ? 2 * ws : ws;

  // A loader: rows (tid>>2) and (tid>>2)+64, one 8-channel chunk each
  const int a_chunk = (tid & 3) * 8;
  int a_oy[2], a_ox[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    a_ok[r] = tile_pixel<TILE_W>(m0 / BM, (tid >> 2) + r * 64, ho, wo, a_oy[r], a_ox[r]);
    if (!a_ok[r]) a_oy[r] = a_ox[r] = 0;
  }
  // B loader: K rows (tid>>4) and (tid>>4)+16, one 8-channel chunk each
  const int b_row = tid >> 4;
  const int b_col = n0 + (tid & 15) * 8;
  const bool b_ok = b_col < cout;

  const size_t img = (size_t)b * hs * ws;
  const int kpt = cin / BK;  // K slices per tap

  auto stage_a = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * STAGE_BYTES);
  };
  auto stage_b = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * STAGE_BYTES + A_BYTES);
  };
  // is row r's tap of slice kt inside the (upsampled) image? and where
  auto tap_src = [&](int kt, int r, int& ci0, bool& inb) {
    const int tap = kt / kpt;
    ci0 = (kt - tap * kpt) * BK + a_chunk;
    const int ky = tap / 3, kx = tap - ky * 3;
    const int iy = a_oy[r] + ky - 1, ix = a_ox[r] + kx - 1;
    inb = a_ok[r] && iy >= 0 && iy < ho && ix >= 0 && ix < wo;
    const int sy = UP ? (iy >> 1) : iy, sx = UP ? (ix >> 1) : ix;
    return inb ? src + (img + (size_t)sy * ws + sx) * cin + ci0 : src;
  };
  auto issue = [&](int kt, int st) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int ci0;
      bool inb;
      const __nv_bfloat16* g = tap_src(kt, r, ci0, inb);
      cp_async16(stage_a(st) + ((tid >> 2) + r * 64) * A_LD + a_chunk, g, inb);
      const int k = kt * BK + b_row + r * 16;
      cp_async16(stage_b(st) + (b_row + r * 16) * B_LD + (tid & 15) * 8,
                 b_ok ? w + (size_t)k * cout + b_col : w, b_ok);
    }
  };
  // the prologue, in place on this thread's own landed chunks: out-of-image
  // taps stay zero (the zero padding of the activated tensor)
  auto activate = [&](int kt, int st) {
    int ci0;
    bool inb[2];
    tap_src(kt, 0, ci0, inb[0]);
    tap_src(kt, 1, ci0, inb[1]);
    if (!inb[0] && !inb[1]) return;
    const float4* ap = reinterpret_cast<const float4*>(Avec + (size_t)b * cin + ci0);
    const float4* bp = reinterpret_cast<const float4*>(Bvec + (size_t)b * cin + ci0);
    const float4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!inb[r]) continue;
      uint4* q = reinterpret_cast<uint4*>(stage_a(st) + ((tid >> 2) + r * 64) * A_LD + a_chunk);
      float f[8];
      unpack8(*q, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float pre = f[e] * av[e] + bv[e];
        f[e] = pre * sigmoidf_(pre);
      }
      *q = pack8(f);
    }
  };

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = kt_end - kt_begin;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(kt_begin + s, s);
    cp_async_commit();  // one group per slot, empty or not, keeps the count uniform
  }
  for (int i = 0; i < nk; ++i) {
    const int st = i % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice i have landed
    if constexpr (PROLOGUE) activate(kt_begin + i, st);
    __syncthreads();  // everyone's slice i is in; everyone is done with slice i-1
    if (i + STAGES - 1 < nk) issue(kt_begin + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* As = stage_a(st);
    const __nv_bfloat16* Bs = stage_b(st);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i2 = 0; i2 < FM; ++i2)
        wmma::load_matrix_sync(fa[i2], As + (wm * WARP_M + i2 * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wn * WARP_N + j * 16, B_LD);
#pragma unroll
      for (int i2 = 0; i2 < FM; ++i2)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i2][j], fa[i2], fb[j], acc[i2][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free for the caller
}

// K range of split s of ksplit over ktiles slices (balanced, never empty
// while ksplit <= ktiles).
__device__ __forceinline__ void split_range(int s, int ksplit, int ktiles, int& begin, int& end) {
  begin = (int)((long long)s * ktiles / ksplit);
  end = (int)((long long)(s + 1) * ktiles / ksplit);
}

// Store one warp's raw f32 accumulators (a split-K partial) to ws, laid out
// [hw, ncols] for this (split, image), masking rows >= hw and cols >= ncols.
__device__ __forceinline__ void store_partial(AccFrag (&acc)[FM][FN], float* cs, float* ws,
                                              int hw, int ncols, int m0, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int p = m0 + wm * WARP_M + i * 16 + r;
      const int n = n0 + wn * WARP_N + j * 16 + c8;
      if (p < hw && n < ncols) {
        float4* dst = reinterpret_cast<float4*>(ws + (size_t)p * ncols + n);
        const float4* src = reinterpret_cast<const float4*>(cs + r * 16 + c8);
        dst[0] = src[0];
        dst[1] = src[1];
      }
      __syncwarp();
    }
  }
}

// Sum of the ksplit partials of element i (of per-split size `stride`), in
// split order.
__device__ __forceinline__ float sum_splits(const float* __restrict__ ws, size_t i, size_t stride,
                                            int ksplit) {
  float v = 0.f;
  for (int s = 0; s < ksplit; ++s) v += ws[s * stride + i];
  return v;
}

}  // namespace cgd
