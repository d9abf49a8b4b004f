// K-fwd: 3x3, stride-1, pad-1 NHWC conv with optional fusions, for sm_90a.
//
// Replaces the Pallas TPU kernel cgd_tpu/kernels/conv_pallas.py
// (_conv3x3_pallas -> _conv_kernel) behind conv3x3, conv3x3_gn_silu,
// conv3x3_gn_silu_add and conv3x3_gn_silu_up:
//   out = conv3x3(up?(act(x)), w) + bias [+ skip]
//   act(x) = bf16(silu(x*A + B)) with the PROLOGUE, x otherwise;
//   up = nearest-2x between the activation and the taps.
// The epilogue adds bias (and skip) in f32 and rounds once to bf16, as the
// Pallas kernel does (conv_pallas.py:358-361).
//
// K-halo (etop / ebot given): the same kernel on one shard of an image split
// by height over a mesh, replacing _conv3x3_pallas's explicit_halo mode
// (conv_pallas.py:335-337, reached from conv_spmd.py:139). The taps of the
// rows above and below the shard read the neighbours' boundary rows, which
// the caller has activated already, instead of the zero pad. A template
// flag, so the unsplit launches compile exactly as before; no up fusion.
//
// Bound: compute (tensor cores) for Cin >= 256; the prologue's sigmoid runs
// once per loaded element and N tile, a small fraction of the MMA work.
// Design: see conv3x3_common.cuh (implicit GEMM, WMMA bf16 -> f32, a
// four-stage cp.async ring in shared memory, in-kernel pad-1 halo, split K
// for the small images).
#include "conv3x3_common.cuh"

namespace cgd {

template <bool PROLOGUE, bool SKIP, bool UP, bool HALO>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ bias, const float* __restrict__ Avec,
                   const float* __restrict__ Bvec, const __nv_bfloat16* __restrict__ skip,
                   const __nv_bfloat16* __restrict__ etop, const __nv_bfloat16* __restrict__ ebot,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int batch, int hs,
                   int ws_dim, int cin, int cout, int ksplit) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z % batch, split = blockIdx.z / batch;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int hw = (UP ? 4 : 1) * hs * ws_dim;
  int kt0, kt1;
  split_range(split, ksplit, 9 * (cin / BK), kt0, kt1);
  AccFrag acc[FM][FN];
  conv_mainloop<PROLOGUE, UP, 0, HALO>(x, w, Avec, Bvec, hs, ws_dim, cin, cout, b, m0, n0, kt0,
                                       kt1, smem, acc, etop, ebot);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cs = reinterpret_cast<float*>(smem + SMEM_C) + warp * 256;
  if (ksplit > 1) {  // partial sums; conv3x3_splitk_epilogue finishes
    store_partial(acc, cs, ws + ((size_t)split * batch + b) * hw * cout, hw, cout, m0, n0);
    return;
  }
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
      if (p < hw && n < cout) {
        float v[8], t[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = cs[r * 16 + c8 + e];
        unpack8(*reinterpret_cast<const uint4*>(bias + n), t);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += t[e];
        const size_t o = ((size_t)b * hw + p) * cout + n;
        if constexpr (SKIP) {
          unpack8(*reinterpret_cast<const uint4*>(skip + o), t);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += t[e];
        }
        *reinterpret_cast<uint4*>(out + o) = pack8(v);
      }
      __syncwarp();
    }
  }
}

// Split-K second pass: out = bf16(sum of the splits in order + bias [+ skip]).
// One thread per 8 consecutive output channels of one pixel.
__global__ void conv3x3_splitk_epilogue(const float* __restrict__ ws,
                                        const __nv_bfloat16* __restrict__ bias,
                                        const __nv_bfloat16* __restrict__ skip,
                                        __nv_bfloat16* __restrict__ out, size_t total, int cout,
                                        int ksplit) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= total) return;
  const int n = (int)(i % cout);
  float v[8], t[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = sum_splits(ws, i + e, total, ksplit);
  unpack8(*reinterpret_cast<const uint4*>(bias + n), t);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] += t[e];
  if (skip != nullptr) {
    unpack8(*reinterpret_cast<const uint4*>(skip + i), t);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += t[e];
  }
  *reinterpret_cast<uint4*>(out + i) = pack8(v);
}

template <bool P, bool S, bool U, bool H>
static cudaError_t launch(const void* x, const void* w, const void* bias, const void* A,
                          const void* Bv, const void* skip, const void* etop, const void* ebot,
                          void* out, void* ws, int batch, int hs, int ws_dim, int cin, int cout,
                          int ksplit, cudaStream_t stream) {
  const int hw = (U ? 4 : 1) * hs * ws_dim;
  static const cudaError_t smem_ok = allow_smem(conv3x3_fwd_kernel<P, S, U, H>);
  if (smem_ok != cudaSuccess) return smem_ok;
  dim3 grid((hw + BM - 1) / BM, (cout + BN - 1) / BN, batch * ksplit);
  conv3x3_fwd_kernel<P, S, U, H><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const float*>(A),
      static_cast<const float*>(Bv), static_cast<const __nv_bfloat16*>(skip),
      static_cast<const __nv_bfloat16*>(etop), static_cast<const __nv_bfloat16*>(ebot),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), batch, hs, ws_dim, cin, cout,
      ksplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  const size_t total = (size_t)batch * hw * cout;
  const unsigned threads = 256, blocks = (unsigned)((total / 8 + threads - 1) / threads);
  conv3x3_splitk_epilogue<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(skip), static_cast<__nv_bfloat16*>(out), total, cout,
      ksplit);
  return cudaGetLastError();
}

}  // namespace cgd

// x [batch, hs, ws, cin] bf16; w [3,3,cin,cout] bf16 (HWIO = [9*cin, cout]);
// bias [cout] bf16; A, Bv [batch, cin] f32 or null (no prologue); skip
// [batch, ho, wo, cout] bf16 or null; etop, ebot [batch, 1, ws, cin] bf16, both
// or neither (K-halo: the rows above and below this shard, post-activation;
// no up); out [batch, ho, wo, cout] bf16 with
// (ho, wo) = (2hs, 2ws) when up else (hs, ws). ksplit > 1 splits K over that
// many blocks per output tile and needs ws: [ksplit, batch, ho, wo, cout]
// f32 scratch (null when ksplit == 1). Requires cin % 32 == 0,
// cout % 8 == 0, 1 <= ksplit <= 9*cin/32 and 16-byte aligned pointers.
// Returns the launch status.
extern "C" int cgd_conv3x3_fwd(const void* x, const void* w, const void* bias, const void* A,
                               const void* Bv, const void* skip, const void* etop,
                               const void* ebot, void* out, void* ws, int batch, int hs,
                               int ws_dim, int cin, int cout, int up, int ksplit, void* stream) {
  using namespace cgd;
  const bool halo = etop != nullptr;
  if (cin % BK || cout % 8 || batch <= 0 || hs <= 0 || ws_dim <= 0 || ksplit < 1 ||
      ksplit > 9 * (cin / BK) || (ksplit > 1 && ws == nullptr) || halo != (ebot != nullptr) ||
      (halo && up))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pro = A != nullptr, sk = skip != nullptr;
#define CGD_LAUNCH(P, S, U, H)                                                                 \
  return (int)launch<P, S, U, H>(x, w, bias, A, Bv, skip, etop, ebot, out, ws, batch, hs, ws_dim, \
                                 cin, cout, ksplit, s)
  if (!pro && !sk && !up && !halo) CGD_LAUNCH(false, false, false, false);
  if (pro && !sk && !up && !halo) CGD_LAUNCH(true, false, false, false);
  if (pro && sk && !up && !halo) CGD_LAUNCH(true, true, false, false);
  if (pro && !sk && up) CGD_LAUNCH(true, false, true, false);
  if (!pro && !sk && halo) CGD_LAUNCH(false, false, false, true);
  if (pro && !sk && halo) CGD_LAUNCH(true, false, false, true);
  if (pro && sk && halo) CGD_LAUNCH(true, true, false, true);
#undef CGD_LAUNCH
  return (int)cudaErrorNotSupported;
}

extern "C" int cgd_conv3x3_tile_m() { return cgd::BM; }

extern "C" const char* cgd_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
