// K-fwd at f32 operands: 3x3, stride-1, pad-1 NHWC conv with a fused bias,
// for sm_90a.
//
// Replaces the Pallas TPU kernel cgd_tpu/kernels/conv_pallas.py
// (_conv3x3_pallas -> _conv_kernel) in its plain mode (no prologue, residual,
// up or halo) at f32 operands, where the JAX package's LPIPS VGG16 reaches it:
// its thirteen 3x3 convs (cgd_tpu/models/vgg_lpips.py:60 through
// cgd_tpu/ops/nn.py:169-178) and their input gradients, the same conv with
// flipped, transposed weights and a zero bias (conv_pallas.py:553-558):
//   out = conv3x3(x, w) + bias; x, w, bias f32; f32 accumulate; f32 out.
//
// Bound: operations (tensor cores at TF32; the scheme below spends three
// MMAs per product) for Cin >= 64; the 3-channel first conv and the
// 3-channel input gradient of it are bound by bytes.
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
// precision (chip_smoke.py phase 3 holds it against f64). Plain
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
// the 10 x 18 input window of the patch (the pad-1 halo and channels past
// Cin zero-filled) as [pixel][BK + 4] and the chunk's weights as
// [tap][BK][BN + 8], rows of output channels straight from the HWIO layout
// (16-byte copies, no transposition); the row paddings make every fragment
// read conflict-free. Two stages: the copy of chunk c + 1 runs under the
// MMAs of chunk c. Cin and Cout are padded to multiples of 4 by the caller
// (kernels/conv3x3.py), for the 16-byte copies.
#include "common.cuh"

namespace cgd {
namespace f32conv {

constexpr int PH = 8, PW = 16;                        // output patch of one block
constexpr int WIN_H = PH + 2, WIN_W = PW + 2;         // its input window (pad-1 halo)
constexpr int NPIX = WIN_H * WIN_W;
constexpr int BK = 32, BN = 64;                       // Cin chunk, Cout tile
constexpr int A_STRIDE = BK + 4, B_STRIDE = BN + 8;   // floats per smem row
constexpr int A_FLOATS = NPIX * A_STRIDE;
constexpr int B_FLOATS = 9 * BK * B_STRIDE;
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
constexpr int STAGES = 2;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
constexpr int NTHREADS = 256;
static_assert(SMEM_BYTES <= 232448, "one block's shared memory on the H100");

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(f));
  return u;
}

// f = hi + lo + O(2^-22 |f|): hi its TF32 rounding (an f32 bit pattern with
// the low 13 mantissa bits zero), lo the TF32 rounding of what is left
__device__ __forceinline__ void split_tf32(float f, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(f);
  lo = to_tf32(f - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage chunk [c0, c0 + BK) of the input window and of the weights.
__device__ __forceinline__ void load_stage(float* sA, float* sB, const float* __restrict__ x,
                                           const float* __restrict__ w, int b, int y0, int x0,
                                           int n0, int c0, int h, int wd, int cin, int cout) {
  for (int i = threadIdx.x; i < NPIX * (BK / 4); i += NTHREADS) {
    const int pix = i / (BK / 4), v = i % (BK / 4);
    const int gy = y0 - 1 + pix / WIN_W, gx = x0 - 1 + pix % WIN_W, c = c0 + 4 * v;
    const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < wd && c < cin;
    const float* src = ok ? x + (((size_t)b * h + gy) * wd + gx) * cin + c : x;
    cp_async16(sA + pix * A_STRIDE + 4 * v, src, ok);
  }
  for (int i = threadIdx.x; i < 9 * BK * (BN / 4); i += NTHREADS) {
    const int row = i / (BN / 4), v = i % (BN / 4);  // row = tap * BK + k
    const int tap = row / BK, c = c0 + row % BK, n = n0 + 4 * v;
    const bool ok = c < cin && n < cout;
    const float* src = ok ? w + ((size_t)tap * cin + c) * cout + n : w;
    cp_async16(sB + row * B_STRIDE + 4 * v, src, ok);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int h, int wd,
                   int cin, int cout) {
  extern __shared__ __align__(16) float smem[];
  const int tiles_w = (wd + PW - 1) / PW;
  const int y0 = (blockIdx.x / tiles_w) * PH, x0 = (blockIdx.x % tiles_w) * PW;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;  // patch rows 2wm, 2wm + 1; channels 32wn ..
  const int g = lane / 4, t = lane % 4;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int chunks = (cin + BK - 1) / BK;
  load_stage(smem, smem + A_FLOATS, x, w, b, y0, x0, n0, 0, h, wd, cin, cout);
  cp_async_commit();
  for (int ck = 0; ck < chunks; ++ck) {
    if (ck + 1 < chunks) {
      float* next = smem + ((ck + 1) % STAGES) * STAGE_FLOATS;
      load_stage(next, next + A_FLOATS, x, w, b, y0, x0, n0, (ck + 1) * BK, h, wd, cin, cout);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sA = smem + (ck % STAGES) * STAGE_FLOATS;
    const float* sB = sA + A_FLOATS;
    const int ksteps = (min(BK, cin - ck * BK) + 7) / 8;  // k8 steps holding channels < cin
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
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
          const float* pa = sA + ((2 * wm + i + dy) * WIN_W + g + dx) * A_STRIDE + k;
          split_tf32(pa[0], ah[i][0], al[i][0]);
          split_tf32(pa[8 * A_STRIDE], ah[i][1], al[i][1]);
          split_tf32(pa[4], ah[i][2], al[i][2]);
          split_tf32(pa[8 * A_STRIDE + 4], ah[i][3], al[i][3]);
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

  // out = acc + bias: accumulator rows g / g + 8 are patch columns g / g + 8,
  // its columns 2t, 2t + 1 two neighbouring output channels
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int oy = y0 + 2 * wm + i;
    if (oy >= h) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * wn + 8 * j + 2 * t;
      if (n >= cout) continue;
      const float2 bv = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ox = x0 + g + 8 * r;
        if (ox >= wd) continue;
        *reinterpret_cast<float2*>(out + (((size_t)b * h + oy) * wd + ox) * cout + n) =
            make_float2(acc[i][j][2 * r] + bv.x, acc[i][j][2 * r + 1] + bv.y);
      }
    }
  }
}

}  // namespace f32conv
}  // namespace cgd

// x [batch, h, w, cin] f32; w [3, 3, cin, cout] f32 (HWIO); bias [cout] f32;
// out [batch, h, w, cout] f32. Requires cin % 4 == 0, cout % 4 == 0 and
// 16-byte aligned pointers (kernels/conv3x3.py f32_plan pads and plans the
// same). Returns the launch status (a cudaError_t).
extern "C" int cgd_conv3x3_f32(const void* x, const void* w, const void* bias, void* out,
                               int batch, int h, int wd, int cin, int cout, void* stream) {
  using namespace cgd::f32conv;
  if (batch <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || cin % 4 || cout % 4)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      conv3x3_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  const dim3 grid(((h + PH - 1) / PH) * ((wd + PW - 1) / PW), (cout + BN - 1) / BN, batch);
  conv3x3_f32_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), h, wd, cin, cout);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block (what f32_plan computes).
extern "C" int cgd_conv3x3_f32_smem_bytes() { return cgd::f32conv::SMEM_BYTES; }
