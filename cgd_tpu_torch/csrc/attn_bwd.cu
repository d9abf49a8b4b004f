// K-attn-b: multi-head self-attention backward, for sm_90a.
//
// Replaces the Pallas TPU kernel cgd_tpu/kernels/attention_pallas.py
// (_run_bwd -> _bwd_kernel): given dO, with P = softmax(S), S = q.k^T/sqrt(d),
//   dV = P^T.dO,  dP = dO.V^T,  dS = P o (dP - D),  D = rowsum(dO o O),
//   dQ = dS.K/sqrt(d),  dK = dS^T.Q/sqrt(d).
// The TPU kernel recomputes one head's whole P in VMEM; here P is recomputed
// tile by tile from Q, K and the forward's per-row log-sum-exp, in three
// launches with no float atomics, so reruns are bit-identical (the guided
// step's gradient feeds a sampler whose resume is promised bit-exact):
//   1. attn_bwd_dot: D per row (f32; from the bf16 O the forward wrote);
//   2. attn_bwd_dkdv: one block per (kv tile, batch*head), looping over q
//      tiles; dK and dV accumulate in f32 in shared memory;
//   3. attn_bwd_dq: one block per (q tile, batch*head), looping over kv
//      tiles; dQ accumulates in f32 in shared memory.
// Every product runs on the tensor cores (WMMA, bf16 in, f32 accumulate),
// with P and dS rounded to bf16 as their MMA operands; D, the softmax
// recompute and dS are f32. Streamed tiles are double-buffered with cp.async.
//
// Bound: as the forward, small and latency-bound at the UNet's T <= 1024.
#include "attn_common.cuh"

namespace cgd {
namespace attn {

// D[n, t] = sum_c dO[n, t, c] * O[n, t, c]; one thread per row.
__global__ void attn_bwd_dot(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                             float* __restrict__ Dvec, int T, int heads, int d, int out_stride,
                             int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int n = i / T, t = i - n * T, b = n / heads, h = n - b * heads;
  const size_t off = ((size_t)b * T + t) * out_stride + (size_t)h * d;
  float s = 0.f;
  for (int c = 0; c < d; c += 8) {
    float a[8], g[8];
    unpack8(*reinterpret_cast<const uint4*>(o + off + c), a);
    unpack8(*reinterpret_cast<const uint4*>(dout + off + c), g);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += a[e] * g[e];
  }
  Dvec[i] = s;
}

template <int D>
constexpr int dkdv_smem() {
  using C = Cfg<D>;
  return 6 * C::TILE_BYTES + 4 * C::TILE * 4 + 2 * C::S_BYTES + 2 * C::P_BYTES +
         2 * C::ACC_BYTES;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
attn_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ Dvec, bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
              int heads, int in_stride, int out_stride, int grad_stride, float scale) {
  using C = Cfg<D>;
  constexpr int NT = C::NT, R = C::ROWS, QT = C::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);                   // [R][LD]
  bf16* Vs = Ks + R * C::LD;                                  // [R][LD]
  bf16* Qs = Vs + R * C::LD;                                  // [2][QT][LD]
  bf16* dOs = Qs + 2 * QT * C::LD;                            // [2][QT][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * QT * C::LD);  // [2][QT] lse * log2(e)
  float* Dl = Ls + 2 * QT;                                    // [2][QT]
  float* Ss = Dl + 2 * QT;                                    // [R][LDS]: P^T, f32
  float* dPs = Ss + R * C::LDS;                               // [R][LDS]: dP^T
  bf16* Pb = reinterpret_cast<bf16*>(dPs + R * C::LDS);       // [R][LDP]
  bf16* dSb = Pb + R * C::LDP;                                // [R][LDP]
  float* dKs = reinterpret_cast<float*>(dSb + R * C::LDP);    // [R][LDF]
  float* dVs = dKs + R * C::LDF;                              // [R][LDF]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.y, b = n / heads, h = n - b * heads;
  const int kv0 = blockIdx.x * R;
  const size_t in_head = (size_t)b * T * in_stride + (size_t)h * D;
  const size_t out_head = (size_t)b * T * out_stride + (size_t)h * D;
  const float* lse_n = lse + (size_t)n * T;
  const float* D_n = Dvec + (size_t)n * T;
  const int ntiles = (T + QT - 1) / QT;

  // rows past T: lse = +inf makes their P exactly 0
  auto load_q = [&](int it, int buf) {
    load_tile<D, QT, NT>(Qs + buf * QT * C::LD, q + in_head, it * QT, T, in_stride);
    load_tile<D, QT, NT>(dOs + buf * QT * C::LD, dout + out_head, it * QT, T, out_stride);
    for (int i = tid; i < QT; i += NT) {
      const int t = it * QT + i;
      Ls[buf * QT + i] = t < T ? lse_n[t] * LOG2E : INFINITY;
      Dl[buf * QT + i] = t < T ? D_n[t] : 0.f;
    }
  };
  load_tile<D, R, NT>(Ks, k + in_head, kv0, T, in_stride);
  load_tile<D, R, NT>(Vs, v + in_head, kv0, T, in_stride);
  load_q(0, 0);
  cp_async_commit();
  for (int i = tid; i < 2 * R * C::LDF; i += NT) dKs[i] = 0.f;

  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const float sl2 = scale * LOG2E;
  float* srow = Ss + row * C::LDS;
  float* dprow = dPs + row * C::LDS;
  bf16* pbrow = Pb + row * C::LDP;
  bf16* dsrow = dSb + row * C::LDP;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) load_q(it + 1, buf ^ 1);
    cp_async_commit();
    const bf16* Qb = Qs + buf * QT * C::LD;
    const bf16* dOb = dOs + buf * QT * C::LD;
    const float* Lb = Ls + buf * QT;
    const float* Db = Dl + buf * QT;

    // S^T = K . Q^T and dP^T = V . dO^T for this warp's 16 kv rows
    warp_abt<D, QT>(Ss + warp * 16 * C::LDS, C::LDS, Ks + warp * 16 * C::LD, C::LD, Qb, C::LD);
    warp_abt<D, QT>(dPs + warp * 16 * C::LDS, C::LDS, Vs + warp * 16 * C::LD, C::LD, dOb, C::LD);
    __syncwarp();
    for (int c = half * (QT / 2); c < (half + 1) * (QT / 2); ++c) {
      const float p = exp2f(srow[c] * sl2 - Lb[c]);
      pbrow[c] = __float2bfloat16(p);
      dsrow[c] = __float2bfloat16(p * (dprow[c] - Db[c]));
    }
    __syncwarp();
    // dV += P^T . dO ; dK += dS^T . Q
    warp_acc_ab<QT, D>(dVs + warp * 16 * C::LDF, C::LDF, Pb + warp * 16 * C::LDP, C::LDP, dOb,
                       C::LD);
    warp_acc_ab<QT, D>(dKs + warp * 16 * C::LDF, C::LDF, dSb + warp * 16 * C::LDP, C::LDP, Qb,
                       C::LD);
    __syncwarp();
  }

  const int t = kv0 + row;
  if (t < T) {
    const size_t g_row = ((size_t)b * T + t) * grad_stride + (size_t)h * D + half * (D / 2);
    store_row(dk + g_row, dKs + row * C::LDF + half * (D / 2), D / 2, scale);
    store_row(dv + g_row, dVs + row * C::LDF + half * (D / 2), D / 2, 1.f);
  }
}

template <int D>
constexpr int dq_smem() {
  using C = Cfg<D>;
  return 6 * C::TILE_BYTES + 2 * C::S_BYTES + C::P_BYTES + C::ACC_BYTES;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
attn_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ Dvec, bf16* __restrict__ dq, int T, int heads,
            int in_stride, int out_stride, int grad_stride, float scale) {
  using C = Cfg<D>;
  constexpr int NT = C::NT, R = C::ROWS, KT = C::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                  // [R][LD]
  bf16* dOs = Qs + R * C::LD;                                // [R][LD]
  bf16* Ks = dOs + R * C::LD;                                // [2][KT][LD]
  bf16* Vs = Ks + 2 * KT * C::LD;                            // [2][KT][LD]
  float* Ss = reinterpret_cast<float*>(Vs + 2 * KT * C::LD);  // [R][LDS]
  float* dPs = Ss + R * C::LDS;                              // [R][LDS]
  bf16* dSb = reinterpret_cast<bf16*>(dPs + R * C::LDS);     // [R][LDP]
  float* dQs = reinterpret_cast<float*>(dSb + R * C::LDP);   // [R][LDF]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.y, b = n / heads, h = n - b * heads;
  const int q0 = blockIdx.x * R;
  const size_t in_head = (size_t)b * T * in_stride + (size_t)h * D;
  const size_t out_head = (size_t)b * T * out_stride + (size_t)h * D;
  const int ntiles = (T + KT - 1) / KT;

  load_tile<D, R, NT>(Qs, q + in_head, q0, T, in_stride);
  load_tile<D, R, NT>(dOs, dout + out_head, q0, T, out_stride);
  load_tile<D, KT, NT>(Ks, k + in_head, 0, T, in_stride);
  load_tile<D, KT, NT>(Vs, v + in_head, 0, T, in_stride);
  cp_async_commit();
  for (int i = tid; i < R * C::LDF; i += NT) dQs[i] = 0.f;

  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int t = q0 + row;
  const float l2 = t < T ? lse[(size_t)n * T + t] * LOG2E : INFINITY;
  const float Drow = t < T ? Dvec[(size_t)n * T + t] : 0.f;
  const float sl2 = scale * LOG2E;
  float* srow = Ss + row * C::LDS;
  float* dprow = dPs + row * C::LDS;
  bf16* dsrow = dSb + row * C::LDP;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) {
      load_tile<D, KT, NT>(Ks + (buf ^ 1) * KT * C::LD, k + in_head, (it + 1) * KT, T, in_stride);
      load_tile<D, KT, NT>(Vs + (buf ^ 1) * KT * C::LD, v + in_head, (it + 1) * KT, T, in_stride);
    }
    cp_async_commit();
    const bf16* Kb = Ks + buf * KT * C::LD;
    const bf16* Vb = Vs + buf * KT * C::LD;

    // S = Q . K^T and dP = dO . V^T for this warp's 16 q rows
    warp_abt<D, KT>(Ss + warp * 16 * C::LDS, C::LDS, Qs + warp * 16 * C::LD, C::LD, Kb, C::LD);
    warp_abt<D, KT>(dPs + warp * 16 * C::LDS, C::LDS, dOs + warp * 16 * C::LD, C::LD, Vb, C::LD);
    __syncwarp();
    const int kv0 = it * KT;
    for (int c = half * (KT / 2); c < (half + 1) * (KT / 2); ++c) {
      const float p = kv0 + c < T ? exp2f(srow[c] * sl2 - l2) : 0.f;
      dsrow[c] = __float2bfloat16(p * (dprow[c] - Drow));
    }
    __syncwarp();
    // dQ += dS . K
    warp_acc_ab<KT, D>(dQs + warp * 16 * C::LDF, C::LDF, dSb + warp * 16 * C::LDP, C::LDP, Kb,
                       C::LD);
    __syncwarp();
  }

  if (t < T) {
    const size_t g_row = ((size_t)b * T + t) * grad_stride + (size_t)h * D + half * (D / 2);
    store_row(dq + g_row, dQs + row * C::LDF + half * (D / 2), D / 2, scale);
  }
}

template <int D>
static cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* Dvec, void* dq, void* dk, void* dv,
                              int batch, int T, int heads, int in_stride, int out_stride,
                              int grad_stride, cudaStream_t s) {
  constexpr int b1 = dkdv_smem<D>(), b2 = dq_smem<D>();
  static_assert(b1 <= 227 * 1024 && b2 <= 227 * 1024, "shared memory");
  static const cudaError_t ok1 = allow_smem(attn_bwd_dkdv<D>, b1);
  static const cudaError_t ok2 = allow_smem(attn_bwd_dq<D>, b2);
  if (ok1 != cudaSuccess) return ok1;
  if (ok2 != cudaSuccess) return ok2;
  const float scale = 1.f / sqrtf((float)D);
  dim3 grid((T + Cfg<D>::ROWS - 1) / Cfg<D>::ROWS, batch * heads);
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v), *g_ = static_cast<const bf16*>(dout);
  const float *l_ = static_cast<const float*>(lse), *D_ = static_cast<const float*>(Dvec);
  attn_bwd_dkdv<D><<<grid, Cfg<D>::NT, b1, s>>>(q_, k_, v_, g_, l_, D_, static_cast<bf16*>(dk),
                                                static_cast<bf16*>(dv), T, heads, in_stride,
                                                out_stride, grad_stride, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq<D><<<grid, Cfg<D>::NT, b2, s>>>(q_, k_, v_, g_, l_, D_, static_cast<bf16*>(dq), T,
                                              heads, in_stride, out_stride, grad_stride, scale);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace cgd

// q, k, v as cgd_attn_fwd's inputs (in_stride); o, dout [batch, T, *] bf16
// (out_stride: the forward's output and its cotangent); lse [batch*heads, T]
// f32 from cgd_attn_fwd; Dvec [batch*heads, T] f32 scratch; dq, dk, dv
// [batch, T, *] bf16 outputs (grad_stride, same head layout). d in
// {64, 128, 192, 256}. Returns the launch status.
extern "C" int cgd_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* Dvec, void* dq, void* dk,
                            void* dv, int batch, int T, int heads, int d, int in_stride,
                            int out_stride, int grad_stride, void* stream) {
  using namespace cgd::attn;
  if (batch <= 0 || T <= 0 || heads <= 0 || in_stride % 8 || out_stride % 8 || grad_stride % 8)
    return (int)cudaErrorInvalidValue;
  if (d != 64 && d != 128 && d != 192 && d != 256) return (int)cudaErrorNotSupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * heads * T;
  attn_bwd_dot<<<(rows + 255) / 256, 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(Dvec), T,
      heads, d, out_stride, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define CGD_BWD(D)                                                                              \
  return (int)launch_bwd<D>(q, k, v, dout, lse, Dvec, dq, dk, dv, batch, T, heads, in_stride, \
                            out_stride, grad_stride, s)
  switch (d) {
    case 64: CGD_BWD(64);
    case 128: CGD_BWD(128);
    case 192: CGD_BWD(192);
    default: CGD_BWD(256);
  }
#undef CGD_BWD
}
