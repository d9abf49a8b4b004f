// K-fwd, K-halo and K-dx at f32 operands: the 3x3, stride-1, pad-1 NHWC
// conv family for sm_90a, in every mode that compute_dtype="float32" reaches.
//
// Replaces the Pallas TPU kernels of cgd_tpu/kernels/conv_pallas.py at f32
// operands (itemsize 4, cgd_tpu/ops/nn.py:169-178 and :274-327):
// - K-fwd (_conv3x3_pallas -> _conv_kernel): out = conv3x3(h, w) + bias
//   [+ skip], h = x, or with the prologue h = silu(x*A + B) (GroupNorm apply
//   and emb scale-shift folded into per-(batch, channel) A/B), or with up
//   h = nearest_2x(silu(x*A + B)). The plain mode is also where the LPIPS
//   VGG16 reaches it (cgd_tpu/models/vgg_lpips.py:60), and the input
//   gradient of a conv is the same conv with flipped, transposed weights
//   and a zero bias (conv_pallas.py:553-558).
// - K-halo (the same launcher in explicit_halo mode, conv_pallas.py:335-337,
//   :397-399, :507-513, reached from cgd_tpu/kernels/conv_spmd.py:139, which
//   plans it at the activation's own itemsize): K-fwd on one shard of a
//   height-split image, rows -1 and H taken from etop / ebot, the
//   neighbouring shards' boundary rows, already activated. The height-split
//   UNet at compute_dtype="float32" runs every 3x3 conv on it, forward and
//   (plain mode, flipped weights, zero bias) input gradient.
// - K-dx (_conv3x3_dx_pallas -> _conv_dx_kernel), and its W >= 512 class
//   (_conv3x3_dx_wtiled -> _conv_dx_kernel_wtiled), the backward of the
//   prologue conv: acc = conv3x3(g, wt), pre = x*A + B,
//   dpre = acc * silu'(pre), dx = dpre * A, dA = sum_hw dpre*x,
//   dB = sum_hw dpre (conv_pallas.py:595-607). There is no split K here, so
//   both classes are one launch shape over 8 x 16 output patches.
//
// Bound: operations (tensor cores at TF32; the scheme below spends three
// MMAs per product) for Cin >= 64; the 3-channel first conv, the 3-channel
// input gradient of it and the 6-channel eps/sigma conv are bound by bytes.
//
// Design: an implicit GEMM on mma.sync.m16n8k8 at TF32, f32 accumulators,
// in the 3xTF32 scheme: each f32 operand is split, as it leaves shared
// memory, into a TF32 high part (cvt.rna) and the TF32 rounding of the
// residual, and a product is hi*hi + hi*lo + lo*hi (the lo*lo term left
// out), at three times the MMAs. The tensor cores add into their f32
// accumulator with truncation, a bias of up to one ulp per MMA, which over
// the thousands of MMAs of a 512-channel output costs more than the split
// gains. So the MMAs of one tap accumulate into a zeroed fragment, which is
// then added to the f32 accumulators in registers (round to nearest): f32's
// precision (chip_smoke.py phases 3 and 9 hold it against f64). Plain
// TF32 (one MMA) held every conv to 3.5e-4 of its f32 plain version's max,
// but not the LPIPS distance's input gradient through the thirteen convs
// (relative L2 6.9e-2 at 256^2, NVIDIA H100): the per-channel unit
// normalisation of the taps divides by norms that are small where few
// channels are active, and amplifies the operands' rounding there.
// The bf16 TMA + wgmma loop of conv3x3_common.cuh does not carry over: its
// 128-byte swizzled boxes hold 64 bf16 channels, and its B operand is
// MN-major, which wgmma allows only for 16-bit types. A block computes an
// 8 x 16 output patch (M = 128 pixels) by BN = 64 output channels with eight
// warps, 4 (M: two patch rows each) x 2 (N: 32 channels each). K = 9 taps x
// Cin walks Cin in chunks of BK = 32 channels. Per chunk, cp.async stages
// the input window of the patch (the pad-1 halo and channels past Cin
// zero-filled) as [pixel][BK + 4] and the chunk's weights as
// [tap][BK][BN + 8], rows of output channels straight from the HWIO layout
// (16-byte copies, no transposition); the row paddings make every fragment
// read conflict-free. Two stages: the copy of chunk c + 1 runs under the
// MMAs of chunk c. Cin and Cout are padded to multiples of 4 by the caller
// (kernels/conv3x3.py), for the 16-byte copies.
//
// The modes are template flags on that one body, so that a later redesign
// replaces one main loop:
// - PRO: once a chunk's window has landed, the block applies
//   silu(x*A + B) to it in shared memory, in f32, each element once, before
//   any hi/lo split. Cells outside the image stay 0: the Pallas kernel
//   activates its halo and then zeroes the image border
//   (conv_pallas.py:339-340), so a pad cell is 0, not silu(B).
// - UP: the window is staged at source resolution, (8/2 + 2) x (16/2 + 2)
//   = 6 x 10 pixels, and the fragment reads map output row oy + dy - 1 to
//   window row (oy + dy + 1) / 2 (the same for columns): nearest-2x is only
//   an address. The output image is 2H x 2W, so its pad rows and columns
//   are the source image's (conv_pallas.py:341-344).
// - HALO: window rows -1 and h are staged from etop / ebot ([batch, 1, w,
//   cin]) at the columns inside the image; their pad columns stay 0, as the
//   Pallas kernel's zero columns (conv_pallas.py:346-347). The prologue
//   skips every row outside [0, h), so the halo rows, post-activation, are
//   not activated again. Window rows past h (a shard shorter than the 8-row
//   patch) stay 0: they feed only outputs that are never written. No up:
//   the Pallas kernel takes no halo with a resample (conv_pallas.py:388),
//   and the split UNet upsamples before its conv.
// - EPI_SKIP adds the residual in the f32 epilogue, after the bias, as the
//   plain version's (acc + bias) + skip.
// - EPI_DX is K-dx's epilogue: dpre and dx per output element, and the
//   block's dA/dB column sums over its 128 pixels in a fixed order (each
//   thread's 4 pixels, a butterfly over the 8 lanes of a column, the 4 warp
//   rows in order through shared memory) into a [batch, patches, 2, cx]
//   buffer that a second launch sums over the patches in order: no float
//   atomics, so reruns are bit-identical.
#include "common.cuh"

namespace cgd {
namespace f32conv {

constexpr int PH = 8, PW = 16;                        // output patch of one block
constexpr int NPIX = (PH + 2) * (PW + 2);             // its input window (pad-1 halo)
constexpr int BK = 32, BN = 64;                       // Cin chunk, Cout tile
constexpr int A_STRIDE = BK + 4, B_STRIDE = BN + 8;   // floats per smem row
constexpr int A_FLOATS = NPIX * A_STRIDE;
constexpr int B_FLOATS = 9 * BK * B_STRIDE;
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
constexpr int STAGES = 2;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
constexpr int NTHREADS = 256;
static_assert(SMEM_BYTES <= 232448, "one block's shared memory on the H100");

enum Epilogue { EPI_BIAS = 0, EPI_SKIP = 1, EPI_DX = 2 };

// The staged window of one output patch: rows x cols, in source pixels.
template <bool UP>
struct Window {
  static constexpr int H = UP ? PH / 2 + 2 : PH + 2;
  static constexpr int W = UP ? PW / 2 + 2 : PW + 2;
  static_assert(H * W <= NPIX, "window");
};

struct Params {
  const float* x;     // input [batch, h, w, cin] (K-dx: the cotangent g)
  const float* w;     // [3, 3, cin, cout] HWIO (K-dx: flipped, transposed)
  const float* bias;  // [cout] (K-fwd)
  const float* A;     // [batch, cin] prologue scale (K-dx: [batch, cout])
  const float* B;     // [batch, cin] prologue shift (K-dx: [batch, cout])
  const float* skip;  // [batch, ho, wo, cout] (EPI_SKIP)
  const float* xpre;  // K-dx: the pre-activation input [batch, h, w, cout]
  const float* etop;  // HALO: the row above the shard [batch, 1, w, cin]
  const float* ebot;  // HALO: the row below the shard [batch, 1, w, cin]
  float* out;         // [batch, ho, wo, cout] (K-dx: dx)
  float* partial;     // K-dx: [batch, patches, 2, cout] dA / dB column sums
  int h, wd;          // the input image (the output is 2h x 2wd with up)
  int cin, cout;
};

// sigmoid in full f32 (expf and a true division, no fast intrinsics), as
// the plain version's torch.sigmoid
__device__ __forceinline__ float sigmoid_f32(float v) { return 1.f / (1.f + expf(-v)); }

// Stage chunk [c0, c0 + BK) of the input window and of the weights. The
// window's top-left pixel is source pixel (sy0, sx0). With HALO, rows -1
// and h come from etop / ebot; every other cell outside the image is 0.
template <bool UP, bool HALO>
__device__ __forceinline__ void load_stage(float* sA, float* sB, const Params& p, int b, int sy0,
                                           int sx0, int n0, int c0) {
  using Win = Window<UP>;
  for (int i = threadIdx.x; i < Win::H * Win::W * (BK / 4); i += NTHREADS) {
    const int pix = i / (BK / 4), v = i % (BK / 4);
    const int gy = sy0 + pix / Win::W, gx = sx0 + pix % Win::W, c = c0 + 4 * v;
    const bool in_row = gx >= 0 && gx < p.wd && c < p.cin;
    const float* src = p.x;
    bool ok = false;
    if (gy >= 0 && gy < p.h) {
      ok = in_row;
      if (ok) src = p.x + (((size_t)b * p.h + gy) * p.wd + gx) * p.cin + c;
    } else if (HALO && (gy == -1 || gy == p.h)) {
      ok = in_row;
      if (ok) src = (gy < 0 ? p.etop : p.ebot) + ((size_t)b * p.wd + gx) * p.cin + c;
    }
    cp_async16(sA + pix * A_STRIDE + 4 * v, src, ok);
  }
  for (int i = threadIdx.x; i < 9 * BK * (BN / 4); i += NTHREADS) {
    const int row = i / (BN / 4), v = i % (BN / 4);  // row = tap * BK + k
    const int tap = row / BK, c = c0 + row % BK, n = n0 + 4 * v;
    const bool ok = c < p.cin && n < p.cout;
    const float* src = ok ? p.w + ((size_t)tap * p.cin + c) * p.cout + n : p.w;
    cp_async16(sB + row * B_STRIDE + 4 * v, src, ok);
  }
}

// The prologue on a landed window: act = silu(x*A + B) in place, each
// element once; cells outside the image and channels past Cin stay 0, and
// K-halo's rows -1 and h (outside the image too) keep their activated values.
template <bool UP>
__device__ __forceinline__ void activate(float* sA, const Params& p, int b, int sy0, int sx0,
                                         int c0) {
  using Win = Window<UP>;
  for (int i = threadIdx.x; i < Win::H * Win::W * (BK / 4); i += NTHREADS) {
    const int pix = i / (BK / 4), v = i % (BK / 4);
    const int gy = sy0 + pix / Win::W, gx = sx0 + pix % Win::W, c = c0 + 4 * v;
    if (gy < 0 || gy >= p.h || gx < 0 || gx >= p.wd || c >= p.cin) continue;
    float4* cell = reinterpret_cast<float4*>(sA + pix * A_STRIDE + 4 * v);
    const float4 a = *reinterpret_cast<const float4*>(p.A + (size_t)b * p.cin + c);
    const float4 s = *reinterpret_cast<const float4*>(p.B + (size_t)b * p.cin + c);
    float4 xv = *cell;
    float pre;
    pre = xv.x * a.x + s.x; xv.x = pre * sigmoid_f32(pre);
    pre = xv.y * a.y + s.y; xv.y = pre * sigmoid_f32(pre);
    pre = xv.z * a.z + s.z; xv.z = pre * sigmoid_f32(pre);
    pre = xv.w * a.w + s.w; xv.w = pre * sigmoid_f32(pre);
    *cell = xv;
  }
}

template <bool PRO, bool UP, bool HALO, int EPI>
__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_f32_kernel(const __grid_constant__ Params p) {
  static_assert(!(HALO && (UP || EPI == EPI_DX)), "K-halo takes no up and is no K-dx");
  extern __shared__ __align__(16) float smem[];
  using Win = Window<UP>;
  const int ho = UP ? 2 * p.h : p.h, wo = UP ? 2 * p.wd : p.wd;
  const int tiles_w = (wo + PW - 1) / PW;
  const int y0 = (blockIdx.x / tiles_w) * PH, x0 = (blockIdx.x % tiles_w) * PW;
  // the window's first source pixel: output row y0 - 1 (its source row
  // (y0 - 1) / 2 rounded down, y0 even, with up)
  const int sy0 = UP ? y0 / 2 - 1 : y0 - 1, sx0 = UP ? x0 / 2 - 1 : x0 - 1;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;  // patch rows 2wm, 2wm + 1; channels 32wn ..
  const int g = lane / 4, t = lane % 4;
  constexpr int PIX8 = UP ? 4 : 8;  // window pixels from patch column g to g + 8

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int chunks = (p.cin + BK - 1) / BK;
  load_stage<UP, HALO>(smem, smem + A_FLOATS, p, b, sy0, sx0, n0, 0);
  cp_async_commit();
  for (int ck = 0; ck < chunks; ++ck) {
    if (ck + 1 < chunks) {
      float* next = smem + ((ck + 1) % STAGES) * STAGE_FLOATS;
      load_stage<UP, HALO>(next, next + A_FLOATS, p, b, sy0, sx0, n0, (ck + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* sA = smem + (ck % STAGES) * STAGE_FLOATS;
    const float* sB = sA + A_FLOATS;
    if constexpr (PRO) {
      activate<UP>(sA, p, b, sy0, sx0, ck * BK);
      __syncthreads();
    }
    const int ksteps = (min(BK, p.cin - ck * BK) + 7) / 8;  // k8 steps holding channels < cin
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // window pixel of patch pixel (2wm + i, g) under this tap
      const int col = UP ? (g + dx + 1) >> 1 : g + dx;
      float part[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int k = ks * 8 + t;
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // A rows g, g + 8 of m-tile i: pixels (2wm + i, g) and (2wm + i, g + 8)
          const int row = UP ? (2 * wm + i + dy + 1) >> 1 : 2 * wm + i + dy;
          const float* pa = sA + (row * Win::W + col) * A_STRIDE + k;
          split_tf32(pa[0], ah[i][0], al[i][0]);
          split_tf32(pa[PIX8 * A_STRIDE], ah[i][1], al[i][1]);
          split_tf32(pa[4], ah[i][2], al[i][2]);
          split_tf32(pa[PIX8 * A_STRIDE + 4], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* pb = sB + (tap * BK + k) * B_STRIDE + 32 * wn + 8 * j + g;
          split_tf32(pb[0], bh[j][0], bl[j][0]);
          split_tf32(pb[4 * B_STRIDE], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // the small terms first
            mma_tf32(part[i][j], al[i], bh[j]);
            mma_tf32(part[i][j], ah[i], bl[j]);
            mma_tf32(part[i][j], ah[i], bh[j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
    __syncthreads();  // the stage is refilled in the next iteration
  }

  // Accumulator rows g / g + 8 are patch columns g / g + 8, its columns 2t,
  // 2t + 1 two neighbouring output channels.
  if constexpr (EPI != EPI_DX) {
    // out = acc + bias [+ skip]
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int oy = y0 + 2 * wm + i;
      if (oy >= ho) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 32 * wn + 8 * j + 2 * t;
        if (n >= p.cout) continue;
        const float2 bv = *reinterpret_cast<const float2*>(p.bias + n);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ox = x0 + g + 8 * r;
          if (ox >= wo) continue;
          const size_t o = (((size_t)b * ho + oy) * wo + ox) * p.cout + n;
          float2 v = make_float2(acc[i][j][2 * r] + bv.x, acc[i][j][2 * r + 1] + bv.y);
          if constexpr (EPI == EPI_SKIP) {
            const float2 s = *reinterpret_cast<const float2*>(p.skip + o);
            v.x += s.x;
            v.y += s.y;
          }
          *reinterpret_cast<float2*>(p.out + o) = v;
        }
      }
    }
  } else {
    // K-dx: dpre = acc * silu'(pre), dx = dpre * A; each thread sums dpre*x
    // and dpre over its 4 pixels for each of its 8 channels
    float sa[4][2], sb[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * wn + 8 * j + 2 * t;
      sa[j][0] = sa[j][1] = sb[j][0] = sb[j][1] = 0.f;
      if (n >= p.cout) continue;
      const float2 av = *reinterpret_cast<const float2*>(p.A + (size_t)b * p.cout + n);
      const float2 bv = *reinterpret_cast<const float2*>(p.B + (size_t)b * p.cout + n);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int oy = y0 + 2 * wm + i;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ox = x0 + g + 8 * r;
          if (oy >= ho || ox >= wo) continue;
          const size_t o = (((size_t)b * ho + oy) * wo + ox) * p.cout + n;
          const float2 xv = *reinterpret_cast<const float2*>(p.xpre + o);
          const float xs[2] = {xv.x, xv.y}, as[2] = {av.x, av.y}, bs[2] = {bv.x, bv.y};
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pre = xs[e] * as[e] + bs[e];
            const float sg = sigmoid_f32(pre);
            const float dpre = acc[i][j][2 * r + e] * (sg * (1.f + pre * (1.f - sg)));
            d[e] = dpre * as[e];
            sa[j][e] += dpre * xs[e];
            sb[j][e] += dpre;
          }
          *reinterpret_cast<float2*>(p.out + o) = make_float2(d[0], d[1]);
        }
      }
    }
    // over the 8 lanes of one channel pair (lane bits 2-4), in a fixed order
#pragma unroll
    for (int m = 4; m <= 16; m <<= 1)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sa[j][e] += __shfl_xor_sync(0xffffffffu, sa[j][e], m);
          sb[j][e] += __shfl_xor_sync(0xffffffffu, sb[j][e], m);
        }
    // then the 4 warp rows in order, through the (free) stage buffers
    float* colA = smem;  // [4][BN]
    float* colB = smem + 4 * BN;
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 32 * wn + 8 * j + 2 * t + e;
          colA[wm * BN + c] = sa[j][e];
          colB[wm * BN + c] = sb[j][e];
        }
    }
    __syncthreads();
    if (threadIdx.x < BN && n0 + threadIdx.x < p.cout) {
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa += colA[r * BN + threadIdx.x];
        pb += colB[r * BN + threadIdx.x];
      }
      const size_t base = ((size_t)b * gridDim.x + blockIdx.x) * 2 * p.cout + n0 + threadIdx.x;
      p.partial[base] = pa;
      p.partial[base + p.cout] = pb;
    }
  }
}

// dA[b, c] / dB[b, c]: the per-patch partials of image b summed in a fixed
// order. A block owns 32 channels of one image: thread (lane, row) sums
// patches row, row + 32, ... of channel lane in order, then row 0 sums the
// 32 rows in order. 32 x 32 threads, grid (ceil(cx / 32), batch).
constexpr int RED_ROWS = 32;

__global__ void conv3x3_dx_f32_reduce(const float* __restrict__ partial, float* __restrict__ dA,
                                      float* __restrict__ dB, int patches, int cx) {
  __shared__ float sa_rows[RED_ROWS][32], sb_rows[RED_ROWS][32];
  const int lane = threadIdx.x, row = threadIdx.y, b = blockIdx.y;
  const int c = blockIdx.x * 32 + lane;
  float sa = 0.f, sb = 0.f;
  if (c < cx) {
    for (int t = row; t < patches; t += RED_ROWS) {
      const size_t base = ((size_t)b * patches + t) * 2 * cx + c;
      sa += partial[base];
      sb += partial[base + cx];
    }
  }
  sa_rows[row][lane] = sa;
  sb_rows[row][lane] = sb;
  __syncthreads();
  if (row == 0 && c < cx) {
    float ta = 0.f, tb = 0.f;
    for (int r = 0; r < RED_ROWS; ++r) {
      ta += sa_rows[r][lane];
      tb += sb_rows[r][lane];
    }
    dA[(size_t)b * cx + c] = ta;
    dB[(size_t)b * cx + c] = tb;
  }
}

inline int patches(int ho, int wo) { return ((ho + PH - 1) / PH) * ((wo + PW - 1) / PW); }

template <bool PRO, bool UP, bool HALO, int EPI>
static int launch(const Params& p, int batch, cudaStream_t s) {
  auto kernel = conv3x3_f32_kernel<PRO, UP, HALO, EPI>;
  static const cudaError_t smem_ok =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  const int ho = UP ? 2 * p.h : p.h, wo = UP ? 2 * p.wd : p.wd;
  const dim3 grid(patches(ho, wo), (p.cout + BN - 1) / BN, batch);
  kernel<<<grid, NTHREADS, SMEM_BYTES, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace f32conv
}  // namespace cgd

// K-fwd f32 (K-halo f32 with etop / ebot). x [batch, h, w, cin] f32; w [3,
// 3, cin, cout] f32 (HWIO); bias [cout] f32; A, Bv [batch, cin] f32 (the
// prologue) or both null; skip [batch, ho, wo, cout] f32 or null; up != 0:
// nearest-2x between the activation and the taps (needs A/Bv, takes no skip
// and no halo); etop, ebot [batch, 1, w, cin] f32, both or neither: the
// (activated) rows above and below x -> out [batch, ho, wo, cout] f32, (ho,
// wo) = (2h, 2w) with up. Requires cin % 4 == 0, cout % 4 == 0 and 16-byte
// aligned pointers (kernels/conv3x3.py f32_plan pads and plans the same).
// Returns the launch status (a cudaError_t).
extern "C" int cgd_conv3x3_f32(const void* x, const void* w, const void* bias, const void* A,
                               const void* Bv, const void* skip, const void* etop,
                               const void* ebot, void* out, int batch, int h, int wd, int cin,
                               int cout, int up, void* stream) {
  using namespace cgd::f32conv;
  const bool pro = A != nullptr, halo = etop != nullptr;
  if (batch <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || cin % 4 || cout % 4 ||
      pro != (Bv != nullptr) || (up && (!pro || skip != nullptr)) ||
      halo != (ebot != nullptr) || (halo && up))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(x), static_cast<const float*>(w),
           static_cast<const float*>(bias), static_cast<const float*>(A),
           static_cast<const float*>(Bv), static_cast<const float*>(skip), nullptr,
           static_cast<const float*>(etop), static_cast<const float*>(ebot),
           static_cast<float*>(out), nullptr, h, wd, cin, cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (up) return launch<true, true, false, EPI_BIAS>(p, batch, s);
  if (halo) {
    if (pro) return skip ? launch<true, false, true, EPI_SKIP>(p, batch, s)
                         : launch<true, false, true, EPI_BIAS>(p, batch, s);
    return skip ? launch<false, false, true, EPI_SKIP>(p, batch, s)
                : launch<false, false, true, EPI_BIAS>(p, batch, s);
  }
  if (pro) return skip ? launch<true, false, false, EPI_SKIP>(p, batch, s)
                       : launch<true, false, false, EPI_BIAS>(p, batch, s);
  return skip ? launch<false, false, false, EPI_SKIP>(p, batch, s)
              : launch<false, false, false, EPI_BIAS>(p, batch, s);
}

// K-dx f32. g [batch, h, w, cg] f32 cotangent; wt [3, 3, cg, cx] f32 (the
// forward weight flipped in both taps, channel axes swapped); x [batch, h,
// w, cx] f32 pre-activation input; A, Bv [batch, cx] f32 -> dx [batch, h, w,
// cx] f32, dA, dB [batch, cx] f32. partial: [batch,
// cgd_conv3x3_dx_f32_chunks(h, w), 2, cx] f32 scratch. Requires cg % 4 ==
// 0, cx % 4 == 0, 16-byte aligned pointers. Two launches (the conv with its
// epilogue, then the fixed-order dA/dB sum). Returns the launch status.
extern "C" int cgd_conv3x3_dx_f32(const void* g, const void* wt, const void* x, const void* A,
                                  const void* Bv, void* dx, void* partial, void* dA, void* dB,
                                  int batch, int h, int wd, int cg, int cx, void* stream) {
  using namespace cgd::f32conv;
  if (batch <= 0 || h <= 0 || wd <= 0 || cg <= 0 || cx <= 0 || cg % 4 || cx % 4)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(g), static_cast<const float*>(wt), nullptr,
           static_cast<const float*>(A), static_cast<const float*>(Bv), nullptr,
           static_cast<const float*>(x), nullptr, nullptr, static_cast<float*>(dx),
           static_cast<float*>(partial), h, wd, cg, cx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int err = launch<false, false, false, EPI_DX>(p, batch, s)) return err;
  conv3x3_dx_f32_reduce<<<dim3((cx + 31) / 32, batch), dim3(32, RED_ROWS), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dA), static_cast<float*>(dB),
      patches(h, wd), cx);
  return (int)cudaGetLastError();
}

// Rows of K-dx f32's dA/dB partials for an h x w image: its 8 x 16 patches.
extern "C" int cgd_conv3x3_dx_f32_chunks(int h, int w) { return cgd::f32conv::patches(h, w); }

// Dynamic shared memory of one block, every mode (what f32_plan computes).
extern "C" int cgd_conv3x3_f32_smem_bytes() { return cgd::f32conv::SMEM_BYTES; }
