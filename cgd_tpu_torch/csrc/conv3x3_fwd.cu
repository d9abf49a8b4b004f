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
// the caller has activated already, instead of the zero pad: the staged
// rows -1 and H of a patch at the shard's top or bottom come from etop and
// ebot. A template flag; no up fusion.
//
// Bound: compute (tensor cores) for Cin >= 128; the prologue's sigmoid runs
// once per staged input element (and N tile). Design: see
// conv3x3_common.cuh (TMA-staged input patches, wgmma bf16 -> f32 with a
// producer warpgroup, the pad-1 halo from the TMA's zero fill, split K for
// the small images).
#include <chrono>

#include "conv3x3_common.cuh"

namespace cgd {

template <int BN, bool PROLOGUE, bool SKIP, bool UP, bool HALO>
__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_fwd_kernel(const __grid_constant__ ConvMaps maps, const __nv_bfloat16* __restrict__ bias,
                   const float* __restrict__ Avec, const float* __restrict__ Bvec,
                   const __nv_bfloat16* __restrict__ skip, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ ws, int batch, int hs, int ws_dim, int cin, int cout,
                   int ksplit) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ Barriers bar;
  unsigned char* smem = conv_setup(smem_raw, bar, PROLOGUE);
  const ConvGeom g = make_geom(batch, hs, ws_dim, cin, UP, BN, ksplit);
  if (threadIdx.x < NTHREADS - NCONSUMERS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) conv_producer<BN, PROLOGUE, UP, HALO>(maps, g, bar, smem);
  } else {
    setmaxnreg_inc<232>();
    float acc[BN / 2];
    conv_mainloop<BN, PROLOGUE, UP>(g, bar, smem, Avec, Bvec, acc);
    static_assert(Epi<BN>::TILE_BYTES <= Layout<BN, UP>::SMEM_BYTES - SMEM_ALIGN,
                  "staged tile");
    const float* c = stage_acc<BN>(acc, smem);
    const size_t hw = (size_t)g.ho * g.wo;
    if (ksplit > 1) {  // partial sums; conv3x3_splitk_epilogue finishes
      store_partial<BN>(c, g, ws + ((size_t)(blockIdx.z / batch) * batch + g.b) * hw * cout, cout);
      return;
    }
    // out = bf16(acc + bias [+ skip]), 8 channels of a pixel per thread
    const int ct = threadIdx.x - (NTHREADS - NCONSUMERS);
    const int grp = ct % Epi<BN>::GROUPS, po = ct / Epi<BN>::GROUPS;
    const int n = g.n0 + grp * 8;
    if (n >= cout) return;
    float bv[8];
    unpack8(*reinterpret_cast<const uint4*>(bias + n), bv);
#pragma unroll 4
    for (int pass = 0; pass < Epi<BN>::PASSES; ++pass) {
      const int p = pass * Epi<BN>::PIX_PER_PASS + po;
      const int oy = g.y0 + p / PATCH_W, ox = g.x0 + p % PATCH_W;
      if (oy >= g.ho || ox >= g.wo) continue;
      const size_t o = ((size_t)g.b * hw + (size_t)oy * g.wo + ox) * cout + n;
      const float4* src = reinterpret_cast<const float4*>(c + p * Epi<BN>::PITCH + grp * 8);
      const float4 s0 = src[0], s1 = src[1];
      float v[8] = {s0.x + bv[0], s0.y + bv[1], s0.z + bv[2], s0.w + bv[3],
                    s1.x + bv[4], s1.y + bv[5], s1.z + bv[6], s1.w + bv[7]};
      if constexpr (SKIP) {
        float sv[8];
        unpack8(*reinterpret_cast<const uint4*>(skip + o), sv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += sv[e];
      }
      *reinterpret_cast<uint4*>(out + o) = pack8(v);
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

template <int BN, bool P, bool S, bool U, bool H>
static int launch(const ConvMaps& maps, const void* bias, const void* A, const void* Bv,
                  const void* skip, void* out, void* ws, int batch, int hs, int ws_dim, int cin,
                  int cout, int ksplit, cudaStream_t stream) {
  const int ho = U ? 2 * hs : hs, wo = U ? 2 * ws_dim : ws_dim;
  constexpr int smem = Layout<BN, U>::SMEM_BYTES;
  static const cudaError_t smem_ok = allow_smem(conv3x3_fwd_kernel<BN, P, S, U, H>, smem);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  const dim3 grid(((ho + PATCH_H - 1) / PATCH_H) * ((wo + PATCH_W - 1) / PATCH_W),
                  (cout + BN - 1) / BN, batch * ksplit);
  conv3x3_fwd_kernel<BN, P, S, U, H><<<grid, NTHREADS, smem, stream>>>(
      maps, static_cast<const __nv_bfloat16*>(bias), static_cast<const float*>(A),
      static_cast<const float*>(Bv), static_cast<const __nv_bfloat16*>(skip),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), batch, hs, ws_dim, cin, cout,
      ksplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const size_t total = (size_t)batch * ho * wo * cout;
  const unsigned threads = 256, blocks = (unsigned)((total / 8 + threads - 1) / threads);
  conv3x3_splitk_epilogue<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(skip), static_cast<__nv_bfloat16*>(out), total, cout,
      ksplit);
  return (int)cudaGetLastError();
}

template <bool P, bool S, bool U, bool H>
static int launch_bn(int bn, const ConvMaps& maps, const void* bias, const void* A,
                     const void* Bv, const void* skip, void* out, void* ws, int batch, int hs,
                     int ws_dim, int cin, int cout, int ksplit, cudaStream_t stream) {
  if (bn == 16)
    return launch<16, P, S, U, H>(maps, bias, A, Bv, skip, out, ws, batch, hs, ws_dim, cin, cout,
                                  ksplit, stream);
  if (bn == 128)
    return launch<128, P, S, U, H>(maps, bias, A, Bv, skip, out, ws, batch, hs, ws_dim, cin, cout,
                                   ksplit, stream);
  return launch<256, P, S, U, H>(maps, bias, A, Bv, skip, out, ws, batch, hs, ws_dim, cin, cout,
                                 ksplit, stream);
}

}  // namespace cgd

// x [batch, hs, ws, cin] bf16; w [3,3,cin,cout] bf16 (HWIO = [9*cin, cout]);
// bias [cout] bf16; A, Bv [batch, cin] f32 or null (no prologue); skip
// [batch, ho, wo, cout] bf16 or null; etop, ebot [batch, 1, ws, cin] bf16, both
// or neither (K-halo: the rows above and below this shard, post-activation;
// no up); out [batch, ho, wo, cout] bf16 with
// (ho, wo) = (2hs, 2ws) when up else (hs, ws). bn: the N tile (16, 128 or
// 256). ksplit > 1 splits the Cin chunks over that many blocks per output
// tile and needs ws: [ksplit, batch, ho, wo, cout] f32 scratch (null when
// ksplit == 1). Requires cin % 64 == 0, cout % 8 == 0, 1 <= ksplit <=
// cin/64 and 16-byte aligned pointers (kernels/conv3x3.py conv_plan makes
// the same plan). Returns the launch status (cudaError_t, or
// cgd::ENCODE_ERROR + the CUresult of a failed tensor-map encode).
extern "C" int cgd_conv3x3_fwd(const void* x, const void* w, const void* bias, const void* A,
                               const void* Bv, const void* skip, const void* etop,
                               const void* ebot, void* out, void* ws, int batch, int hs,
                               int ws_dim, int cin, int cout, int up, int bn, int ksplit,
                               void* stream) {
  using namespace cgd;
  const bool halo = etop != nullptr;
  const bool pro = A != nullptr, sk = skip != nullptr;
  if (cin % BK || cout % 8 || batch <= 0 || hs <= 0 || ws_dim <= 0 || ksplit < 1 ||
      ksplit > cin / BK || (ksplit > 1 && ws == nullptr) || halo != (ebot != nullptr) ||
      (halo && up) || (up && !pro) || (bn != 16 && bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  ConvMaps maps;
  if (int st = make_conv_maps(&maps, x, etop, ebot, w, batch, hs, ws_dim, cin, cout, bn, up))
    return st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CGD_LAUNCH(P, S, U, H) \
  return launch_bn<P, S, U, H>(bn, maps, bias, A, Bv, skip, out, ws, batch, hs, ws_dim, cin, cout, \
                               ksplit, s)
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

// Dynamic shared memory of one block of the conv family's kernels for N tile
// bn, with or without up (what conv_plan computes).
extern "C" int cgd_conv3x3_smem_bytes(int bn, int up) { return cgd::smem_bytes(bn, up != 0); }

// Host seconds per launch to encode the tensor maps of one K-halo launch
// (four maps, the most any launch encodes) over a 256 x 256 x 256 bf16 image
// at `buf` (a device buffer of at least 32 MiB), averaged over `reps`
// launches; negative if an encode fails.
extern "C" double cgd_conv3x3_encode_seconds(const void* buf, int reps) {
  using namespace cgd;
  ConvMaps maps;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (make_conv_maps(&maps, buf, buf, buf, buf, 1, 256, 256, 256, 256, 256, false))
      return -1.0;
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count() / reps;
}

extern "C" const char* cgd_error_string(int status) {
  if (status >= cgd::ENCODE_ERROR) return "cuTensorMapEncodeTiled failed (CUresult = status - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
