// K-dx: one-pass backward of the prologue conv, for sm_90a.
//
// Replaces the Pallas TPU kernel cgd_tpu/kernels/conv_pallas.py
// (_conv3x3_dx_pallas -> _conv_dx_kernel), the backward of conv3x3_gn_silu
// and conv3x3_gn_silu_add. For act = silu(pre), pre = x*A + B:
//   acc = conv3x3(g, wt)                       (transpose conv, f32)
//   dpre = acc * sig(pre) * (1 + pre*(1 - sig(pre)))
//   dx = bf16(dpre * A),  dA[b,c] = sum_hw dpre*x,  dB[b,c] = sum_hw dpre
// (conv_pallas.py:595-607). wt is the forward weight flipped in both taps
// and transposed in its channel axes.
//
// dA/dB are reduced deterministically, with no float atomics: each block
// writes its per-column partial sums over its BM pixels (a fixed shuffle
// tree, then the four M-warps summed in order) to a [batch, mtiles, 2, cx]
// buffer, and a second small kernel sums the tiles of each image in order.
// Repeated runs are bit-identical. With split K (small images) the main
// loop's partials go to a workspace and conv3x3_dx_splitk_epilogue sums them
// in order, applies the same epilogue and writes the same per-tile partials.
//
// Bound: compute (tensor cores), as K-fwd; the epilogue reads x once per
// output element. Design: the shared main loop of conv3x3_common.cuh.
//
// K-dx-w (TILE_W = 16) is the same kernel over 8 x 16 spatial tiles instead
// of 128 consecutive pixels. It replaces the Pallas TPU kernel
// conv_pallas.py (_conv3x3_dx_wtiled -> _conv_dx_kernel_wtiled), which
// assembled a W-tiled halo from nine clamped block streams to satisfy
// Mosaic's block-shape rule; here the tile is only a different pixel map
// (tile_pixel), with the same masked halo loads, the same epilogue and the
// same per-tile dA/dB partials summed in tile order. At W = 512 a 128-pixel
// row segment loads a 3 x 130 halo (3x its pixels), an 8 x 16 tile 10 x 18
// (1.4x). The wrapper picks it for the 512^2 classes.
#include "conv3x3_common.cuh"

namespace cgd {

template <int TILE_W>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_dx_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ wt,
                  const __nv_bfloat16* __restrict__ x, const float* __restrict__ Avec,
                  const float* __restrict__ Bvec, __nv_bfloat16* __restrict__ dx,
                  float* __restrict__ partial, float* __restrict__ ws, int batch, int h, int w,
                  int cg, int cx, int ksplit) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z % batch, split = blockIdx.z / batch;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int hw = h * w;
  int kt0, kt1;
  split_range(split, ksplit, 9 * (cg / BK), kt0, kt1);
  AccFrag acc[FM][FN];
  conv_mainloop<false, false, TILE_W>(g, wt, nullptr, nullptr, h, w, cg, cx, b, m0, n0, kt0,
                                      kt1, smem, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cs = reinterpret_cast<float*>(smem + SMEM_C) + warp * 256;
  if (ksplit > 1) {  // partial sums; conv3x3_dx_splitk_epilogue finishes
    store_partial(acc, cs, ws + ((size_t)split * batch + b) * hw * cx, hw, cx, m0, n0);
    return;
  }
  // the main loop ends drained and on a barrier: stage 0 is free for column sums
  float* colA = reinterpret_cast<float*>(smem + SMEM_A);  // [4][BN]
  float* colB = colA + 4 * BN;                             // [4][BN]
  const int wm = warp >> 1, wn = warp & 1;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < FN; ++j) {
    const int n = n0 + wn * WARP_N + j * 16 + c8;
    float sa[8], sb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sa[e] = sb[e] = 0.f;
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      int oy, ox;
      const bool inside = tile_pixel<TILE_W>(blockIdx.x, wm * WARP_M + i * 16 + r, h, w, oy, ox);
      if (inside && n < cx) {
        const size_t p = (size_t)oy * w + ox;
        const size_t o = ((size_t)b * hw + p) * cx + n;
        float xv[8], d[8];
        unpack8(*reinterpret_cast<const uint4*>(x + o), xv);
        const float* ap = Avec + (size_t)b * cx + n;
        const float* bp = Bvec + (size_t)b * cx + n;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float a = ap[e];
          const float pre = xv[e] * a + bp[e];
          const float sg = sigmoidf_(pre);
          const float dpre = cs[r * 16 + c8 + e] * (sg * (1.f + pre * (1.f - sg)));
          d[e] = dpre * a;
          sa[e] += dpre * xv[e];
          sb[e] += dpre;
        }
        *reinterpret_cast<uint4*>(dx + o) = pack8(d);
      }
      __syncwarp();
    }
    // sum the 16 rows of each column: lanes of equal parity share columns
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sa[e] += __shfl_xor_sync(0xffffffffu, sa[e], off);
        sb[e] += __shfl_xor_sync(0xffffffffu, sb[e], off);
      }
    }
    if (lane < 2) {
      const int col = wn * WARP_N + j * 16 + c8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        colA[wm * BN + col + e] = sa[e];
        colB[wm * BN + col + e] = sb[e];
      }
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < BN && n0 + t < cx) {
    const float pa = ((colA[t] + colA[BN + t]) + colA[2 * BN + t]) + colA[3 * BN + t];
    const float pb = ((colB[t] + colB[BN + t]) + colB[2 * BN + t]) + colB[3 * BN + t];
    const size_t base = ((size_t)b * gridDim.x + blockIdx.x) * 2 * cx + n0 + t;
    partial[base] = pa;
    partial[base + cx] = pb;
  }
}

constexpr int DX_TILE_W = 16;  // K-dx-w: 8 x 16 pixel tiles

// M tiles of an h x w image: runs of BM pixels, or K-dx-w's patches.
inline int dx_mtiles(int h, int w, int wtiled) {
  if (!wtiled) return (h * w + BM - 1) / BM;
  constexpr int rows = BM / DX_TILE_W;
  return ((h + rows - 1) / rows) * ((w + DX_TILE_W - 1) / DX_TILE_W);
}

// Split-K second pass: one thread per channel n of one EPI_ROWS-pixel chunk
// sums the splits of each pixel in order, applies the K-dx epilogue, and
// writes the chunk's dA/dB partial sums (pixels in order).
constexpr int EPI_ROWS = 16;

__global__ void conv3x3_dx_splitk_epilogue(const float* __restrict__ ws,
                                           const __nv_bfloat16* __restrict__ x,
                                           const float* __restrict__ Avec,
                                           const float* __restrict__ Bvec,
                                           __nv_bfloat16* __restrict__ dx,
                                           float* __restrict__ partial, int hw, int cx,
                                           int ksplit) {
  const int chunk = blockIdx.x, b = blockIdx.z;
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  if (n >= cx) return;
  const size_t stride = (size_t)gridDim.z * hw * cx;  // one split's size
  const float a = Avec[(size_t)b * cx + n], bb = Bvec[(size_t)b * cx + n];
  float sa = 0.f, sb = 0.f;
  const int p_end = min(hw, (chunk + 1) * EPI_ROWS);
  for (int p = chunk * EPI_ROWS; p < p_end; ++p) {
    const size_t o = ((size_t)b * hw + p) * cx + n;
    const float xv = __bfloat162float(x[o]);
    const float pre = xv * a + bb;
    const float sg = sigmoidf_(pre);
    const float dpre = sum_splits(ws, o, stride, ksplit) * (sg * (1.f + pre * (1.f - sg)));
    dx[o] = __float2bfloat16(dpre * a);
    sa += dpre * xv;
    sb += dpre;
  }
  const size_t base = ((size_t)b * gridDim.x + chunk) * 2 * cx + n;
  partial[base] = sa;
  partial[base + cx] = sb;
}

// dA[b, c] / dB[b, c]: the per-tile partials of image b summed in tile order.
__global__ void conv3x3_dx_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dA,
                                         float* __restrict__ dB, int batch, int mtiles, int cx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * cx) return;
  const int b = i / cx, c = i - b * cx;
  float sa = 0.f, sb = 0.f;
  for (int t = 0; t < mtiles; ++t) {
    const size_t base = ((size_t)b * mtiles + t) * 2 * cx + c;
    sa += partial[base];
    sb += partial[base + cx];
  }
  dA[i] = sa;
  dB[i] = sb;
}

}  // namespace cgd

// g [batch, h, w, cg] bf16 cotangent; wt [3,3,cg,cx] bf16; x [batch, h, w, cx]
// bf16 pre-activation input; A, Bv [batch, cx] f32 -> dx [batch, h, w, cx]
// bf16, dA, dB [batch, cx] f32. partial: [batch, cgd_conv3x3_dx_chunks(h, w,
// ksplit, wtiled), 2, cx] f32 scratch. ksplit > 1 splits K over that many blocks per tile and needs ws:
// [ksplit, batch, h, w, cx] f32 scratch (null when ksplit == 1). wtiled != 0
// selects K-dx-w's 8 x 16 tiles (with ksplit == 1 only). Requires
// cg % 32 == 0, cx % 8 == 0, 1 <= ksplit <= 9*cg/32, 16-byte aligned pointers.
extern "C" int cgd_conv3x3_dx(const void* g, const void* wt, const void* x, const void* A,
                              const void* Bv, void* dx, void* partial, void* ws, void* dA,
                              void* dB, int batch, int h, int w, int cg, int cx, int ksplit,
                              int wtiled, void* stream) {
  using namespace cgd;
  if (cg % BK || cx % 8 || batch <= 0 || h <= 0 || w <= 0 || ksplit < 1 ||
      ksplit > 9 * (cg / BK) || (ksplit > 1 && ws == nullptr) || (wtiled && ksplit > 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mtiles = dx_mtiles(h, w, wtiled);
  static const cudaError_t smem_ok = allow_smem(conv3x3_dx_kernel<0>);
  static const cudaError_t smem_ok_w = allow_smem(conv3x3_dx_kernel<DX_TILE_W>);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  if (smem_ok_w != cudaSuccess) return (int)smem_ok_w;
  dim3 grid(mtiles, (cx + BN - 1) / BN, batch * ksplit);
  auto kernel = wtiled ? conv3x3_dx_kernel<DX_TILE_W> : conv3x3_dx_kernel<0>;
  kernel<<<grid, NTHREADS, SMEM_BYTES, s>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(A),
      static_cast<const float*>(Bv), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(partial), static_cast<float*>(ws), batch, h, w, cg, cx, ksplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int chunks = mtiles;  // rows of the dA/dB partials
  if (ksplit > 1) {
    chunks = (h * w + EPI_ROWS - 1) / EPI_ROWS;
    dim3 egrid(chunks, (cx + 127) / 128, batch);
    conv3x3_dx_splitk_epilogue<<<egrid, 128, 0, s>>>(
        static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(A), static_cast<const float*>(Bv),
        static_cast<__nv_bfloat16*>(dx), static_cast<float*>(partial), h * w, cx, ksplit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n = batch * cx;
  conv3x3_dx_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dA), static_cast<float*>(dB),
      batch, chunks, cx);
  return (int)cudaGetLastError();
}

// Pixel chunks of the dA/dB partials buffer for an h x w image.
extern "C" int cgd_conv3x3_dx_chunks(int h, int w, int ksplit, int wtiled) {
  using namespace cgd;
  return ksplit > 1 ? (h * w + EPI_ROWS - 1) / EPI_ROWS : dx_mtiles(h, w, wtiled);
}
