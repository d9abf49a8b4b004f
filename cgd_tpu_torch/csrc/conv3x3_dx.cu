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
// writes its per-column partial sums over its 128 pixels (each thread's
// pixels in order, then the threads of a channel group in order) to a
// [batch, mtiles, 2, cx] buffer, and a second small kernel sums the tiles of
// each image in a fixed order. Repeated runs are bit-identical. With split K
// (small images) the main loop's partials go to a workspace and
// conv3x3_dx_splitk_epilogue sums them in order, applies the same epilogue
// and writes the same per-chunk partials.
//
// Bound: compute (tensor cores), as K-fwd; the epilogue reads x once per
// output element. Design: the shared main loop of conv3x3_common.cuh (no
// prologue: the taps read the cotangent's patch as the TMA staged it).
//
// K-dx-w is the launch class that replaces the Pallas TPU kernel
// conv_pallas.py (_conv3x3_dx_wtiled -> _conv_dx_kernel_wtiled), which
// assembled a W-tiled halo from nine clamped block streams to satisfy
// Mosaic's block-shape rule: W >= 512 (the 512^2 classes) without split K.
// Every launch now tiles the image in 8 x 16 patches (a 10 x 18 halo, 1.4x
// its pixels), so K-dx-w is this same kernel, counted apart by the wrapper.
#include "conv3x3_common.cuh"

namespace cgd {

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_dx_kernel(const __grid_constant__ ConvMaps maps, const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ Avec, const float* __restrict__ Bvec,
                  __nv_bfloat16* __restrict__ dx, float* __restrict__ partial,
                  float* __restrict__ ws, int batch, int h, int w, int cg, int cx, int ksplit) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ Barriers bar;
  unsigned char* smem = conv_setup(smem_raw, bar, false);
  const ConvGeom g = make_geom(batch, h, w, cg, 0, BN, ksplit);
  if (threadIdx.x < NTHREADS - NCONSUMERS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) conv_producer<BN, false, false, false>(maps, g, bar, smem);
  } else {
    setmaxnreg_inc<232>();
    float acc[BN / 2];
    conv_mainloop<BN, false, false>(g, bar, smem, nullptr, nullptr, acc);
    static_assert(Epi<BN>::TILE_BYTES + 2 * NCONSUMERS * 8 * 4 <=
                      Layout<BN, false>::SMEM_BYTES - SMEM_ALIGN,
                  "staged tile and column sums");
    const float* c = stage_acc<BN>(acc, smem);
    const size_t hw = (size_t)h * w;
    if (ksplit > 1) {  // partial sums; conv3x3_dx_splitk_epilogue finishes
      store_partial<BN>(c, g, ws + ((size_t)(blockIdx.z / batch) * batch + g.b) * hw * cx, cx);
      return;
    }
    // dpre = acc * silu'(pre), dx = bf16(dpre * A) for 8 channels of a pixel
    // per thread; each thread sums dpre*x and dpre over its pixels in order
    const int ct = threadIdx.x - (NTHREADS - NCONSUMERS);
    const int grp = ct % Epi<BN>::GROUPS, po = ct / Epi<BN>::GROUPS;
    const int n = g.n0 + grp * 8;
    float sa[8], sb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sa[e] = sb[e] = 0.f;
    if (n < cx) {
      const float4* ap = reinterpret_cast<const float4*>(Avec + (size_t)g.b * cx + n);
      const float4* bp = reinterpret_cast<const float4*>(Bvec + (size_t)g.b * cx + n);
      const float4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll 4
      for (int pass = 0; pass < Epi<BN>::PASSES; ++pass) {
        const int p = pass * Epi<BN>::PIX_PER_PASS + po;
        const int oy = g.y0 + p / PATCH_W, ox = g.x0 + p % PATCH_W;
        if (oy >= h || ox >= w) continue;
        const size_t o = ((size_t)g.b * hw + (size_t)oy * w + ox) * cx + n;
        const float* src = c + p * Epi<BN>::PITCH + grp * 8;
        float xv[8], d[8];
        unpack8(*reinterpret_cast<const uint4*>(x + o), xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float pre = xv[e] * av[e] + bv[e];
          const float sg = sigmoidf_(pre);
          const float dpre = src[e] * (sg * (1.f + pre * (1.f - sg)));
          d[e] = dpre * av[e];
          sa[e] += dpre * xv[e];
          sb[e] += dpre;
        }
        *reinterpret_cast<uint4*>(dx + o) = pack8(d);
      }
    }
    // the block's column sums: the PIX_PER_PASS threads of each channel
    // group, summed in order through shared memory after the staged tile
    float* colA = reinterpret_cast<float*>(smem + Epi<BN>::TILE_BYTES);  // [PIX_PER_PASS][BN]
    float* colB = colA + Epi<BN>::PIX_PER_PASS * BN;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      colA[po * BN + grp * 8 + e] = sa[e];
      colB[po * BN + grp * 8 + e] = sb[e];
    }
    named_barrier(1, NCONSUMERS);
    if (ct < BN && g.n0 + ct < cx) {
      float pa = 0.f, pb = 0.f;
      for (int k = 0; k < Epi<BN>::PIX_PER_PASS; ++k) {
        pa += colA[k * BN + ct];
        pb += colB[k * BN + ct];
      }
      const size_t base = ((size_t)g.b * gridDim.x + blockIdx.x) * 2 * cx + g.n0 + ct;
      partial[base] = pa;
      partial[base + cx] = pb;
    }
  }
}

// Output patches of an h x w image (rows of the dA/dB partials).
inline int dx_mtiles(int h, int w) {
  return ((h + PATCH_H - 1) / PATCH_H) * ((w + PATCH_W - 1) / PATCH_W);
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

// dA[b, c] / dB[b, c]: the per-tile partials of image b summed in a fixed
// order. A block owns 32 channels of one image: thread (lane, row) sums
// tiles row, row + 32, ... of channel lane in order, then row 0 sums the 32
// rows in order. 32 x 32 threads, grid (ceil(cx / 32), batch).
constexpr int RED_ROWS = 32;

__global__ void conv3x3_dx_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dA,
                                         float* __restrict__ dB, int mtiles, int cx) {
  __shared__ float sa_rows[RED_ROWS][32], sb_rows[RED_ROWS][32];
  const int lane = threadIdx.x, row = threadIdx.y, b = blockIdx.y;
  const int c = blockIdx.x * 32 + lane;
  float sa = 0.f, sb = 0.f;
  if (c < cx) {
    for (int t = row; t < mtiles; t += RED_ROWS) {
      const size_t base = ((size_t)b * mtiles + t) * 2 * cx + c;
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

template <int BN>
static int launch(const ConvMaps& maps, const void* x, const void* A, const void* Bv, void* dx,
                  void* partial, void* ws, int batch, int h, int w, int cg, int cx, int ksplit,
                  cudaStream_t s) {
  constexpr int smem = Layout<BN, false>::SMEM_BYTES;
  static const cudaError_t smem_ok = allow_smem(conv3x3_dx_kernel<BN>, smem);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  const dim3 grid(dx_mtiles(h, w), (cx + BN - 1) / BN, batch * ksplit);
  conv3x3_dx_kernel<BN><<<grid, NTHREADS, smem, s>>>(
      maps, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(A),
      static_cast<const float*>(Bv), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(partial), static_cast<float*>(ws), batch, h, w, cg, cx, ksplit);
  return (int)cudaGetLastError();
}

}  // namespace cgd

// g [batch, h, w, cg] bf16 cotangent; wt [3,3,cg,cx] bf16; x [batch, h, w, cx]
// bf16 pre-activation input; A, Bv [batch, cx] f32 -> dx [batch, h, w, cx]
// bf16, dA, dB [batch, cx] f32. partial: [batch, cgd_conv3x3_dx_chunks(h, w,
// ksplit, wtiled), 2, cx] f32 scratch. bn: the N tile (16, 128 or 256).
// ksplit > 1 splits the Cg chunks over that many blocks per tile and needs
// ws: [ksplit, batch, h, w, cx] f32 scratch (null when ksplit == 1). wtiled
// != 0 marks the K-dx-w class (ksplit == 1 only; the same 8 x 16 patches).
// Requires cg % 64 == 0, cx % 8 == 0, 1 <= ksplit <= cg/64, 16-byte aligned
// pointers. Returns the launch status, as cgd_conv3x3_fwd.
extern "C" int cgd_conv3x3_dx(const void* g, const void* wt, const void* x, const void* A,
                              const void* Bv, void* dx, void* partial, void* ws, void* dA,
                              void* dB, int batch, int h, int w, int cg, int cx, int bn,
                              int ksplit, int wtiled, void* stream) {
  using namespace cgd;
  if (cg % BK || cx % 8 || batch <= 0 || h <= 0 || w <= 0 || ksplit < 1 || ksplit > cg / BK ||
      (ksplit > 1 && ws == nullptr) || (wtiled && ksplit > 1) ||
      (bn != 16 && bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  ConvMaps maps;
  if (int st = make_conv_maps(&maps, g, nullptr, nullptr, wt, batch, h, w, cg, cx, bn, false))
    return st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = bn == 16    ? launch<16>(maps, x, A, Bv, dx, partial, ws, batch, h, w, cg, cx, ksplit, s)
            : bn == 128 ? launch<128>(maps, x, A, Bv, dx, partial, ws, batch, h, w, cg, cx, ksplit, s)
                        : launch<256>(maps, x, A, Bv, dx, partial, ws, batch, h, w, cg, cx, ksplit, s);
  if (err != cudaSuccess) return err;
  int chunks = dx_mtiles(h, w);  // rows of the dA/dB partials
  if (ksplit > 1) {
    chunks = (h * w + EPI_ROWS - 1) / EPI_ROWS;
    dim3 egrid(chunks, (cx + 127) / 128, batch);
    conv3x3_dx_splitk_epilogue<<<egrid, 128, 0, s>>>(
        static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(A), static_cast<const float*>(Bv),
        static_cast<__nv_bfloat16*>(dx), static_cast<float*>(partial), h * w, cx, ksplit);
    err = (int)cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  conv3x3_dx_reduce_kernel<<<dim3((cx + 31) / 32, batch), dim3(32, RED_ROWS), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dA), static_cast<float*>(dB),
      chunks, cx);
  return (int)cudaGetLastError();
}

// Pixel chunks of the dA/dB partials buffer for an h x w image.
extern "C" int cgd_conv3x3_dx_chunks(int h, int w, int ksplit, int wtiled) {
  (void)wtiled;
  return ksplit > 1 ? (h * w + cgd::EPI_ROWS - 1) / cgd::EPI_ROWS : cgd::dx_mtiles(h, w);
}
