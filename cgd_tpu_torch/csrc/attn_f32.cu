// K-attn-f and K-attn-b at f32 operands, for sm_90a: multi-head
// self-attention of the UNet at compute_dtype="float32", head dims 64, 128,
// 192 and 256.
//
// Replaces the Pallas TPU kernels cgd_tpu/kernels/attention_pallas.py
// (_run_fwd -> _fwd_kernel, _run_bwd -> _bwd_kernel) at f32 operands
// (flash_mha is generic over the dtype, attention_pallas.py:39, 56-61):
//   out = softmax(q.k^T / sqrt(d)) . v   per (batch, head), everything f32,
// and its backward, given dO, with P recomputed:
//   dV = P^T.dO, dP = dO.V^T, dS = P o (dP - D), D = rowsum(dO o O),
//   dQ = dS.K / sqrt(d), dK = dS^T.Q / sqrt(d).
// They read q, k and v in place from the UNet's fused qkv [B, T, 3C] (q heads
// | k heads | v heads; head h is the d channels at h*d of each third) and
// write out [B, T, C], the per-row log-sum-exp [B*heads, T] and dqkv
// [B, T, 3C].
//
// Bound: operations, 4*T^2*d FLOP forward and 10*T^2*d backward (S twice,
// dP, dV, dK, dQ) against 4*T*d*4 bytes; at the UNet's shapes (4-16 heads,
// T <= 1024) latency. The attention is a small share of a guided step
// (PERF.md), so this is a simple, exact body and not a fast one: f32 FMA on
// the CUDA cores, no operand split and no tensor cores, each product in
// full f32 (the TF32 tensor cores would need the 3xTF32 split of
// conv3x3_f32.cu to keep f32's precision).
//
// Layout: one block per (64-row tile, batch*head), 256 threads, 4 per row of
// the block's tile: thread (r, p) owns row r and the column share
// {4q .. 4q+3 : q = p, p + 4, ...} of the row's d-wide accumulators (d/4
// floats). The streamed tiles (K/V rows in the forward and the dQ kernel,
// Q/dO rows in the dK/dV kernel) come by cp.async into two stages, the copy
// of tile i + 1 under the products of tile i; rows past T are zero-filled.
// Shared rows are d + 4 floats, so the 16-byte reads of 8 rows (one per
// row of a warp) fall in 8 distinct bank groups. For one streamed tile a
// thread takes the scores of every fourth row (4jj + p) over the full
// depth, the row's 4 threads combine them with shuffles, stage them in
// shared memory ([64][tile + 4]), and each thread then accumulates its
// column share from all of them.
// - Forward: online softmax per row (running max and sum in f32; a row's 4
//   threads keep one m and a partial l each, summed at the end in a fixed
//   order), O rescaled by exp(m_old - m_new); columns at or past T set to
//   -inf. Writes O / l and lse = m + log(l).
// - Backward, two launches, no float atomics, so reruns are bit-identical:
//   1. dQ (one block per q tile): D for its rows from O and dO (written for
//      launch 2), then over the K/V tiles P = exp(S - lse), dS, dQ += dS.K;
//      rows past T take lse = +inf (P = 0), keys past T P = 0;
//   2. dK/dV (one block per kv tile): over the Q/dO tiles, P^T and dS^T
//      from the same lse and D, dV += P^T.dO, dK += dS^T.Q.
// Shared memory per block (f32 tiles are 4x their bf16 size): the block's
// tile(s), two stages of the streamed tile(s), the staged scores. The
// streamed tile is 32 rows, 16 for the backward at d = 256
// (kernels/attention.py f32_attn_plan, checked here): at most 219,136 of
// the 232,448 bytes a block may take.
#include <math.h>

#include "common.cuh"

namespace cgd {
namespace attn32 {

constexpr int ROWS = 64;                 // the block's own rows
constexpr int TPR = 4;                   // threads per row
constexpr int NTHREADS = ROWS * TPR;
constexpr int SMEM_MAX = 232448;

// the streamed tile of each kernel at head dim D (f32_attn_plan mirrors it)
__host__ __device__ constexpr int fwd_tile(int) { return 32; }
__host__ __device__ constexpr int bwd_tile(int d) { return d >= 256 ? 16 : 32; }

template <int D>
struct Row {
  static constexpr int S = D + 4;        // floats per shared row
  static constexpr int V4 = D / 4;       // float4 columns of a row
  static constexpr int OWN = D / 16;     // float4 columns a thread owns
};

template <int D, int KV>
struct FwdLayout {
  static constexpr int Q = 0, K = ROWS * Row<D>::S, V = K + 2 * KV * Row<D>::S;
  static constexpr int P = V + 2 * KV * Row<D>::S;
  static constexpr int SMEM = (P + ROWS * (KV + 4)) * 4;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

template <int D, int KV>
struct DqLayout {
  static constexpr int Q = 0, DO = ROWS * Row<D>::S, K = 2 * ROWS * Row<D>::S;
  static constexpr int V = K + 2 * KV * Row<D>::S, P = V + 2 * KV * Row<D>::S;
  static constexpr int SMEM = (P + ROWS * (KV + 4)) * 4;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

template <int D, int QT>
struct DkdvLayout {
  static constexpr int K = 0, V = ROWS * Row<D>::S, Q = 2 * ROWS * Row<D>::S;
  static constexpr int DO = Q + 2 * QT * Row<D>::S, P = DO + 2 * QT * Row<D>::S;
  static constexpr int DS = P + ROWS * (QT + 4);
  static constexpr int SMEM = (DS + ROWS * (QT + 4)) * 4;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

// Rows [t0, t0 + n) of one d-wide slice (at channel col) of a [B, T, width]
// tensor of image b, into shared rows of Row<D>::S floats; rows past T
// zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int b, int t0,
                                          int n, int T, int width, int col) {
  for (int i = threadIdx.x; i < n * Row<D>::V4; i += NTHREADS) {
    const int r = i / Row<D>::V4, c = (i % Row<D>::V4) * 4;
    const bool ok = t0 + r < T;
    const float* s = ok ? src + ((size_t)b * T + t0 + r) * width + col + c : src;
    cp_async16(dst + r * Row<D>::S + c, s, ok);
  }
}

// dot product of two d-wide shared rows
template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// acc (the thread's column share of a row) += sum_j w[j] * rows[j], j < n
template <int D>
__device__ __forceinline__ void accumulate(float4* acc, const float* w, const float* rows, int n,
                                           int p) {
  for (int j = 0; j < n; ++j) {
    const float wj = w[j];
    const float* row = rows + j * Row<D>::S;
#pragma unroll
    for (int m = 0; m < Row<D>::OWN; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(row + 4 * (p + TPR * m));
      acc[m].x = fmaf(wj, v.x, acc[m].x);
      acc[m].y = fmaf(wj, v.y, acc[m].y);
      acc[m].z = fmaf(wj, v.z, acc[m].z);
      acc[m].w = fmaf(wj, v.w, acc[m].w);
    }
  }
}

// the thread's column share of a row to global memory, times scale
template <int D>
__device__ __forceinline__ void store_share(float* dst, const float4* acc, int p, float scale) {
#pragma unroll
  for (int m = 0; m < Row<D>::OWN; ++m) {
    const float4 a = acc[m];
    *reinterpret_cast<float4*>(dst + 4 * (p + TPR * m)) =
        make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
  }
}

// over the 4 threads of a row (neighbouring lanes), in a fixed order
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D, int KV>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                    float* __restrict__ lse, int T, int heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  using L = FwdLayout<D, KV>;
  constexpr int S = Row<D>::S, J = KV / TPR;
  const int n = blockIdx.y, b = n / heads, h = n - b * heads, q0 = blockIdx.x * ROWS;
  const int C = heads * D, W = 3 * C;
  const int r = threadIdx.x / TPR, p = threadIdx.x % TPR;
  const int ntiles = (T + KV - 1) / KV;

  load_rows<D>(smem + L::Q, qkv, b, q0, ROWS, T, W, h * D);
  load_rows<D>(smem + L::K, qkv, b, 0, KV, T, W, C + h * D);
  load_rows<D>(smem + L::V, qkv, b, 0, KV, T, W, 2 * C + h * D);
  cp_async_commit();
  float4 o[Row<D>::OWN];
#pragma unroll
  for (int m = 0; m < Row<D>::OWN; ++m) o[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  float mrow = -INFINITY, l = 0.f;  // l: this thread's keys only
  const float* qrow = smem + L::Q + r * S;
  float* prow = smem + L::P + r * (KV + 4);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      const int s = (i + 1) & 1;
      load_rows<D>(smem + L::K + s * KV * S, qkv, b, (i + 1) * KV, KV, T, W, C + h * D);
      load_rows<D>(smem + L::V + s * KV * S, qkv, b, (i + 1) * KV, KV, T, W, 2 * C + h * D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = smem + L::K + (i & 1) * KV * S;
    const float* vt = smem + L::V + (i & 1) * KV * S;
    float sc[J], mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int j = jj * TPR + p;
      sc[jj] = i * KV + j < T ? dot_rows<D>(qrow, kt + j * S) * scale : -INFINITY;
      mx = fmaxf(mx, sc[jj]);
    }
    const float mn = fmaxf(mrow, row_max(mx));  // finite: every tile has a key < T
    const float alpha = expf(mrow - mn);
    mrow = mn;
    l *= alpha;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const float e = expf(sc[jj] - mn);
      l += e;
      prow[jj * TPR + p] = e;
    }
#pragma unroll
    for (int m = 0; m < Row<D>::OWN; ++m) {
      o[m].x *= alpha;
      o[m].y *= alpha;
      o[m].z *= alpha;
      o[m].w *= alpha;
    }
    __syncwarp();  // the row's 4 threads share a warp
    accumulate<D>(o, prow, vt, KV, p);
    __syncthreads();  // the stage is refilled in the next iteration
  }
  l = row_sum(l);
  const int t = q0 + r;
  if (t < T) {
    store_share<D>(out + ((size_t)b * T + t) * C + h * D, o, p, 1.f / l);
    if (p == 0) lse[(size_t)n * T + t] = mrow + logf(l);
  }
}

// ---------------------------------------------------------------------------
// backward 1: dQ, and D = rowsum(dO o O)
// ---------------------------------------------------------------------------

template <int D, int KV>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ o_,
                       const float* __restrict__ dout, const float* __restrict__ lse,
                       float* __restrict__ Dvec, float* __restrict__ dqkv, int T, int heads,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  using L = DqLayout<D, KV>;
  constexpr int S = Row<D>::S, J = KV / TPR;
  const int n = blockIdx.y, b = n / heads, h = n - b * heads, q0 = blockIdx.x * ROWS;
  const int C = heads * D, W = 3 * C;
  const int r = threadIdx.x / TPR, p = threadIdx.x % TPR, t = q0 + r;
  const int ntiles = (T + KV - 1) / KV;

  load_rows<D>(smem + L::Q, qkv, b, q0, ROWS, T, W, h * D);
  load_rows<D>(smem + L::DO, dout, b, q0, ROWS, T, C, h * D);
  load_rows<D>(smem + L::K, qkv, b, 0, KV, T, W, C + h * D);
  load_rows<D>(smem + L::V, qkv, b, 0, KV, T, W, 2 * C + h * D);
  cp_async_commit();
  // D for this row from its O and dO (the thread's columns, then the row)
  float dsum = 0.f;
  if (t < T) {
    const float* orow = o_ + ((size_t)b * T + t) * C + h * D;
    const float* grow = dout + ((size_t)b * T + t) * C + h * D;
#pragma unroll
    for (int m = 0; m < Row<D>::OWN; ++m) {
      const float4 a = *reinterpret_cast<const float4*>(orow + 4 * (p + TPR * m));
      const float4 g = *reinterpret_cast<const float4*>(grow + 4 * (p + TPR * m));
      dsum = fmaf(a.x, g.x, dsum);
      dsum = fmaf(a.y, g.y, dsum);
      dsum = fmaf(a.z, g.z, dsum);
      dsum = fmaf(a.w, g.w, dsum);
    }
  }
  dsum = row_sum(dsum);
  if (t < T && p == 0) Dvec[(size_t)n * T + t] = dsum;
  const float lrow = t < T ? lse[(size_t)n * T + t] : INFINITY;  // rows past T: P = 0

  float4 dq[Row<D>::OWN];
#pragma unroll
  for (int m = 0; m < Row<D>::OWN; ++m) dq[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* qrow = smem + L::Q + r * S;
  const float* grow = smem + L::DO + r * S;
  float* srow = smem + L::P + r * (KV + 4);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      const int s = (i + 1) & 1;
      load_rows<D>(smem + L::K + s * KV * S, qkv, b, (i + 1) * KV, KV, T, W, C + h * D);
      load_rows<D>(smem + L::V + s * KV * S, qkv, b, (i + 1) * KV, KV, T, W, 2 * C + h * D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = smem + L::K + (i & 1) * KV * S;
    const float* vt = smem + L::V + (i & 1) * KV * S;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int j = jj * TPR + p;
      float ds = 0.f;
      if (i * KV + j < T) {
        const float pr = expf(dot_rows<D>(qrow, kt + j * S) * scale - lrow);
        ds = pr * (dot_rows<D>(grow, vt + j * S) - dsum);
      }
      srow[j] = ds;
    }
    __syncwarp();
    accumulate<D>(dq, srow, kt, KV, p);
    __syncthreads();
  }
  if (t < T) store_share<D>(dqkv + ((size_t)b * T + t) * W + h * D, dq, p, scale);
}

// ---------------------------------------------------------------------------
// backward 2: dK and dV
// ---------------------------------------------------------------------------

template <int D, int QT>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bwd_dkdv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ Dvec,
                         float* __restrict__ dqkv, int T, int heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  using L = DkdvLayout<D, QT>;
  constexpr int S = Row<D>::S, J = QT / TPR;
  const int n = blockIdx.y, b = n / heads, h = n - b * heads, k0 = blockIdx.x * ROWS;
  const int C = heads * D, W = 3 * C;
  const int r = threadIdx.x / TPR, p = threadIdx.x % TPR, t = k0 + r;
  const int ntiles = (T + QT - 1) / QT;

  load_rows<D>(smem + L::K, qkv, b, k0, ROWS, T, W, C + h * D);
  load_rows<D>(smem + L::V, qkv, b, k0, ROWS, T, W, 2 * C + h * D);
  load_rows<D>(smem + L::Q, qkv, b, 0, QT, T, W, h * D);
  load_rows<D>(smem + L::DO, dout, b, 0, QT, T, C, h * D);
  cp_async_commit();
  float4 dk[Row<D>::OWN], dv[Row<D>::OWN];
#pragma unroll
  for (int m = 0; m < Row<D>::OWN; ++m)
    dk[m] = dv[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* krow = smem + L::K + r * S;
  const float* vrow = smem + L::V + r * S;
  float* prow = smem + L::P + r * (QT + 4);
  float* srow = smem + L::DS + r * (QT + 4);
  const float* lse_n = lse + (size_t)n * T;
  const float* d_n = Dvec + (size_t)n * T;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      const int s = (i + 1) & 1;
      load_rows<D>(smem + L::Q + s * QT * S, qkv, b, (i + 1) * QT, QT, T, W, h * D);
      load_rows<D>(smem + L::DO + s * QT * S, dout, b, (i + 1) * QT, QT, T, C, h * D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = smem + L::Q + (i & 1) * QT * S;
    const float* gt = smem + L::DO + (i & 1) * QT * S;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int j = jj * TPR + p, tq = i * QT + j;
      float pr = 0.f, ds = 0.f;
      if (tq < T) {
        pr = expf(dot_rows<D>(krow, qt + j * S) * scale - lse_n[tq]);
        ds = pr * (dot_rows<D>(vrow, gt + j * S) - d_n[tq]);
      }
      prow[j] = pr;
      srow[j] = ds;
    }
    __syncwarp();
    accumulate<D>(dv, prow, gt, QT, p);
    accumulate<D>(dk, srow, qt, QT, p);
    __syncthreads();
  }
  if (t < T) {
    float* base = dqkv + ((size_t)b * T + t) * W + h * D;
    store_share<D>(base + C, dk, p, scale);
    store_share<D>(base + 2 * C, dv, p, 1.f);
  }
}

template <typename Kernel>
static cudaError_t allow(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
static int launch_fwd(const float* qkv, float* out, float* lse, int batch, int T, int heads,
                      cudaStream_t s) {
  constexpr int KV = fwd_tile(D), smem = FwdLayout<D, KV>::SMEM;
  static const cudaError_t ok = allow(attn_fwd_f32_kernel<D, KV>, smem);
  if (ok != cudaSuccess) return (int)ok;
  const dim3 grid((T + ROWS - 1) / ROWS, batch * heads);
  attn_fwd_f32_kernel<D, KV><<<grid, NTHREADS, smem, s>>>(qkv, out, lse, T, heads,
                                                          1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
static int launch_bwd(const float* qkv, const float* out, const float* dout, const float* lse,
                      float* Dvec, float* dqkv, int batch, int T, int heads, cudaStream_t s) {
  constexpr int TL = bwd_tile(D);
  constexpr int smem_dq = DqLayout<D, TL>::SMEM, smem_dkdv = DkdvLayout<D, TL>::SMEM;
  static const cudaError_t ok1 = allow(attn_bwd_dq_f32_kernel<D, TL>, smem_dq);
  static const cudaError_t ok2 = allow(attn_bwd_dkdv_f32_kernel<D, TL>, smem_dkdv);
  if (ok1 != cudaSuccess) return (int)ok1;
  if (ok2 != cudaSuccess) return (int)ok2;
  const dim3 grid((T + ROWS - 1) / ROWS, batch * heads);
  const float scale = 1.f / sqrtf((float)D);
  attn_bwd_dq_f32_kernel<D, TL><<<grid, NTHREADS, smem_dq, s>>>(qkv, out, dout, lse, Dvec, dqkv,
                                                                T, heads, scale);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  attn_bwd_dkdv_f32_kernel<D, TL><<<grid, NTHREADS, smem_dkdv, s>>>(qkv, dout, lse, Dvec, dqkv,
                                                                    T, heads, scale);
  return (int)cudaGetLastError();
}

static bool shape_ok(int batch, int T, int heads, int d) {
  return batch > 0 && T > 0 && heads > 0 && (d == 64 || d == 128 || d == 192 || d == 256);
}

}  // namespace attn32
}  // namespace cgd

// qkv [batch, T, 3*heads*d] f32 (q heads | k heads | v heads) -> out [batch,
// T, heads*d] f32 and lse [batch*heads, T] f32 (natural log). d in {64, 128,
// 192, 256}; tile is the launch plan's streamed K/V tile (kernels/
// attention.py f32_attn_plan: 32), checked against this build. Pointers
// 16-byte aligned. Returns the launch status (a cudaError_t).
extern "C" int cgd_attn_fwd_f32(const void* qkv, void* out, void* lse, int batch, int T,
                                int heads, int d, int tile, void* stream) {
  using namespace cgd::attn32;
  if (!shape_ok(batch, T, heads, d) || tile != fwd_tile(d)) return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(qkv);
  float *o = static_cast<float*>(out), *l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(q, o, l, batch, T, heads, s);
  if (d == 128) return launch_fwd<128>(q, o, l, batch, T, heads, s);
  if (d == 192) return launch_fwd<192>(q, o, l, batch, T, heads, s);
  return launch_fwd<256>(q, o, l, batch, T, heads, s);
}

// The backward of cgd_attn_fwd_f32: qkv, its out and lse, the cotangent dout
// [batch, T, heads*d] f32 -> dqkv [batch, T, 3*heads*d] f32. Dvec: [batch*heads,
// T] f32 scratch (rowsum(dout o out), from launch 1 to launch 2). tile_dq /
// tile_dkdv: the plan's streamed tiles (32, 16 at d = 256), checked. Two
// launches. Returns the launch status.
extern "C" int cgd_attn_bwd_f32(const void* qkv, const void* out, const void* dout,
                                const void* lse, void* Dvec, void* dqkv, int batch, int T,
                                int heads, int d, int tile_dq, int tile_dkdv, void* stream) {
  using namespace cgd::attn32;
  if (!shape_ok(batch, T, heads, d) || tile_dq != bwd_tile(d) || tile_dkdv != bwd_tile(d))
    return (int)cudaErrorInvalidValue;
  const float *q = static_cast<const float*>(qkv), *o = static_cast<const float*>(out);
  const float *g = static_cast<const float*>(dout), *l = static_cast<const float*>(lse);
  float *dv = static_cast<float*>(Dvec), *dq = static_cast<float*>(dqkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_bwd<64>(q, o, g, l, dv, dq, batch, T, heads, s);
  if (d == 128) return launch_bwd<128>(q, o, g, l, dv, dq, batch, T, heads, s);
  if (d == 192) return launch_bwd<192>(q, o, g, l, dv, dq, batch, T, heads, s);
  return launch_bwd<256>(q, o, g, l, dv, dq, batch, T, heads, s);
}

// Dynamic shared memory of one block (kernel 0 = the forward, 1 = the
// backward's dQ kernel, 2 = its dK/dV kernel) at head dim d, what
// f32_attn_plan computes; -1 for another d.
extern "C" int cgd_attn_f32_smem_bytes(int kernel, int d) {
  using namespace cgd::attn32;
#define CGD_SMEM32(D)                                                              \
  if (d == D)                                                                      \
    return kernel == 0 ? FwdLayout<D, fwd_tile(D)>::SMEM                           \
           : kernel == 1 ? DqLayout<D, bwd_tile(D)>::SMEM                          \
                         : DkdvLayout<D, bwd_tile(D)>::SMEM;
  CGD_SMEM32(64)
  CGD_SMEM32(128)
  CGD_SMEM32(192)
  CGD_SMEM32(256)
#undef CGD_SMEM32
  return -1;
}
