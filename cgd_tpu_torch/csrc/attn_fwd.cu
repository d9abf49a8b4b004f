// K-attn-f: multi-head self-attention forward, for sm_90a.
//
// Replaces the Pallas TPU kernel cgd_tpu/kernels/attention_pallas.py
// (_run_fwd -> _fwd_kernel): out = softmax(q.k^T / sqrt(d)) . v per
// (batch, head), softmax in f32 (the ADM q, k * d^-1/4 double scaling is the
// same 1/sqrt(d), applied here in f32 to the f32 logits).
//
// The TPU kernel holds one (batch, head)'s whole T x T logits in VMEM; at
// T = 1024 the 64 rows of one block's logits alone are 256 KB of f32, more
// than a block's shared memory. So this is a flash-attention forward: one
// block per (64-row q tile, batch*head), looping over 64-row K/V tiles
// (double-buffered with cp.async) with an online softmax in f32 (running max
// and sum per row), and writes the per-row log-sum-exp for the backward.
// S = Q.K^T and O += P.V run on the tensor cores (WMMA, bf16 in, f32
// accumulate). P is rounded to bf16 for its MMA: the Pallas kernel keeps P in
// f32, and this is the one rounding the port adds. O accumulates in f32 in
// shared memory and is rescaled there when the running max moves.
//
// Bound: at T <= 1024, d = 64 the work is small (4*T*T*d FLOP per head) and
// latency-bound; the design keeps the logits out of device memory, reads
// q, k, v in place from the fused [B, T, 3C] qkv and writes [B, T, C] (no
// head transposes).
#include "attn_common.cuh"

namespace cgd {
namespace attn {

template <int D>
constexpr int fwd_smem() {
  using C = Cfg<D>;
  return 5 * C::TILE_BYTES + C::S_BYTES + C::P_BYTES + C::ACC_BYTES;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse, int T,
                int heads, int in_stride, int out_stride, float scale) {
  using C = Cfg<D>;
  constexpr int NT = C::NT, R = C::ROWS, KT = C::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                          // [R][LD]
  bf16* Ks = Qs + R * C::LD;                                         // [2][KT][LD]
  bf16* Vs = Ks + 2 * KT * C::LD;                                    // [2][KT][LD]
  float* Ss = reinterpret_cast<float*>(Vs + 2 * KT * C::LD);         // [R][LDS]
  bf16* Ps = reinterpret_cast<bf16*>(Ss + R * C::LDS);               // [R][LDP]
  float* Os = reinterpret_cast<float*>(Ps + R * C::LDP);             // [R][LDF]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.y, b = n / heads, h = n - b * heads;
  const int q0 = blockIdx.x * R;
  const size_t in_head = (size_t)b * T * in_stride + (size_t)h * D;
  const int ntiles = (T + KT - 1) / KT;

  load_tile<D, R, NT>(Qs, q + in_head, q0, T, in_stride);
  load_tile<D, KT, NT>(Ks, k + in_head, 0, T, in_stride);
  load_tile<D, KT, NT>(Vs, v + in_head, 0, T, in_stride);
  cp_async_commit();
  for (int i = tid; i < R * C::LDF; i += NT) Os[i] = 0.f;

  // softmax state of one row, held by its two lanes; m in log2 units
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  float m = -INFINITY, l = 0.f;
  const float sl2 = scale * LOG2E;
  float* srow = Ss + row * C::LDS;
  bf16* prow = Ps + row * C::LDP;
  float* orow = Os + row * C::LDF;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it is in; every warp is done with tile it-1's buffers
    if (it + 1 < ntiles) {
      load_tile<D, KT, NT>(Ks + (buf ^ 1) * KT * C::LD, k + in_head, (it + 1) * KT, T, in_stride);
      load_tile<D, KT, NT>(Vs + (buf ^ 1) * KT * C::LD, v + in_head, (it + 1) * KT, T, in_stride);
    }
    cp_async_commit();
    const bf16* Kb = Ks + buf * KT * C::LD;
    const bf16* Vb = Vs + buf * KT * C::LD;

    // S (this warp's 16 rows) = Q . K^T
    warp_abt<D, KT>(Ss + warp * 16 * C::LDS, C::LDS, Qs + warp * 16 * C::LD, C::LD, Kb, C::LD);
    __syncwarp();

    // online softmax over this tile's columns (half of them per lane)
    const int c0 = half * (KT / 2), kv0 = it * KT;
    float mx = -INFINITY;
    for (int c = c0; c < c0 + KT / 2; ++c) {
      const float s = kv0 + c < T ? srow[c] * sl2 : -INFINITY;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // finite: column 0 of tile 0 is valid
    const float alpha = exp2f(m - m_new);
    float sum = 0.f;
    for (int c = c0; c < c0 + KT / 2; ++c) {
      const float p = exp2f(srow[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) orow[c] *= alpha;
    __syncwarp();

    // O (this warp's rows) += P . V
    warp_acc_ab<KT, D>(Os + warp * 16 * C::LDF, C::LDF, Ps + warp * 16 * C::LDP, C::LDP, Vb,
                       C::LD);
    __syncwarp();
  }

  const int t = q0 + row;
  if (t < T) {
    const size_t out_row = ((size_t)b * T + t) * out_stride + (size_t)h * D;
    store_row(o + out_row + half * (D / 2), orow + half * (D / 2), D / 2, 1.f / l);
    if (half == 0) lse[(size_t)n * T + t] = (m + log2f(l)) * LN2;
  }
}

template <int D>
static cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int batch, int T, int heads, int in_stride, int out_stride,
                              cudaStream_t s) {
  constexpr int bytes = fwd_smem<D>();
  static_assert(bytes <= 227 * 1024, "shared memory");
  static const cudaError_t ok = allow_smem(attn_fwd_kernel<D>, bytes);
  if (ok != cudaSuccess) return ok;
  dim3 grid((T + Cfg<D>::ROWS - 1) / Cfg<D>::ROWS, batch * heads);
  attn_fwd_kernel<D><<<grid, Cfg<D>::NT, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), T, heads, in_stride, out_stride,
      1.f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace cgd

// q, k, v: one [batch, T, *] bf16 activation per operand, head h of row t at
// ptr + (b*T + t)*in_stride + h*d; o [batch, T, *] bf16 (out_stride); lse
// [batch*heads, T] f32. d in {64, 128, 192, 256}; strides multiples of 8 and
// 16-byte aligned pointers. Returns the launch status.
extern "C" int cgd_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int batch, int T, int heads, int d, int in_stride, int out_stride,
                            void* stream) {
  using namespace cgd::attn;
  if (batch <= 0 || T <= 0 || heads <= 0 || in_stride % 8 || out_stride % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return (int)launch_fwd<64>(q, k, v, o, lse, batch, T, heads, in_stride, out_stride, s);
    case 128: return (int)launch_fwd<128>(q, k, v, o, lse, batch, T, heads, in_stride, out_stride, s);
    case 192: return (int)launch_fwd<192>(q, k, v, o, lse, batch, T, heads, in_stride, out_stride, s);
    case 256: return (int)launch_fwd<256>(q, k, v, o, lse, batch, T, heads, in_stride, out_stride, s);
  }
  return (int)cudaErrorNotSupported;
}
