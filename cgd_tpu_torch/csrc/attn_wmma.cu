// PR 2's attention bodies on WMMA, kept for head dims 192 and 256 (the
// 128px model only; kernels/attention.py attn_plan routes them here): a
// flash-attention forward (K-attn-f) and a three-launch deterministic
// backward (K-attn-b), replacing the Pallas TPU kernels of
// cgd_tpu/kernels/attention_pallas.py (_run_fwd -> _fwd_kernel, _run_bwd ->
// _bwd_kernel). Head dims 64 and 128 run on the Hopper bodies of
// attn_fwd.cu / attn_bwd.cu.
//
// Forward: one block per (q tile, batch*head), looping over K/V tiles
// double-buffered with cp.async, with an online softmax in f32 and the
// per-row log-sum-exp written for the backward. S = Q.K^T and O += P.V on
// the tensor cores (WMMA, bf16 in, f32 accumulate; P rounded to bf16 for its
// MMA); O accumulates in f32 in shared memory.
// Backward, three launches, no float atomics (bit-identical reruns):
//   1. attn_bwd_dot: D = rowsum(dO o O) per row;
//   2. attn_bwd_dkdv: one block per (kv tile, batch*head), looping over q
//      tiles; dK and dV accumulate in f32 in shared memory;
//   3. attn_bwd_dq: one block per (q tile, batch*head), looping over kv
//      tiles.
//
// Layout: q, k and v are read in place, one head at a time, from row-major
// activations whose row t of batch b starts at base + (b*T + t) * stride; head
// h is the D columns at h*D. The per-row log-sum-exp is [B*heads, T] f32.
// Tiles: WARPS warps own 16 rows each (the block's rows), and the loop
// streams tiles of the other operand with the same number of rows.
//
// Bound: small and latency-bound at the 128px model's T <= 256.
#include <math.h>
#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cgd {
namespace attn_wmma {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static_assert(D == 192 || D == 256, "head dims 192, 256");
  static constexpr int WARPS = 2;
  static constexpr int NT = 32 * WARPS;
  static constexpr int ROWS = 16 * WARPS;  // the block's own rows
  static constexpr int TILE = ROWS;        // rows of each streamed tile
  static constexpr int LD = D + 8;         // bf16 pitch of a [rows][D] tile
  static constexpr int LDF = D + 4;        // f32 pitch of a [rows][D] accumulator
  static constexpr int LDS = TILE + 4;     // f32 pitch of a [rows][TILE] score tile
  static constexpr int LDP = TILE + 8;     // bf16 pitch of a [rows][TILE] probability tile
  static constexpr int TILE_BYTES = ROWS * LD * 2;
  static constexpr int ACC_BYTES = ROWS * LDF * 4;
  static constexpr int S_BYTES = ROWS * LDS * 4;
  static constexpr int P_BYTES = ROWS * LDP * 2;
  static_assert(TILE_BYTES % 128 == 0 && ACC_BYTES % 128 == 0 && S_BYTES % 128 == 0 &&
                    P_BYTES % 128 == 0, "region alignment");
};

// Copy rows [t0, t0 + ROWS) of one head (D columns from `head`, row stride
// `stride`) into a [ROWS][D + 8] shared tile; rows at or past T read zero.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* head, int t0, int T, int stride) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool ok = t0 + r < T;
    cp_async16(dst + r * (D + 8) + c, ok ? head + (size_t)(t0 + r) * stride + c : head, ok);
  }
}

// acc (16 x 16) += A (16 x K, row-major, lda) . B (K x 16, row-major, ldb)
template <int K>
__device__ __forceinline__ void mma_ab(Acc& acc, const bf16* a, int lda, const bf16* b, int ldb) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    FragA fa;
    FragB fb;
    wmma::load_matrix_sync(fa, a + kk, lda);
    wmma::load_matrix_sync(fb, b + kk * ldb, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// acc (16 x 16) += A (16 x K, row-major, lda) . Bt^T, Bt (16 x K, row-major, ldb)
template <int K>
__device__ __forceinline__ void mma_abt(Acc& acc, const bf16* a, int lda, const bf16* bt,
                                        int ldb) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    FragA fa;
    FragBt fb;
    wmma::load_matrix_sync(fa, a + kk, lda);
    wmma::load_matrix_sync(fb, bt + kk, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// Warp's 16 x N f32 tile (pitch lds) = A (16 x K) . Bt^T for Bt [N][K]
template <int K, int N>
__device__ __forceinline__ void warp_abt(float* s, int lds, const bf16* a, int lda, const bf16* bt,
                                         int ldb) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
    mma_abt<K>(acc, a, lda, bt + j * 16 * ldb, ldb);
    wmma::store_matrix_sync(s + j * 16, acc, lds, wmma::mem_row_major);
  }
}

// Warp's 16 x N f32 accumulator in shared memory (pitch ldf) += A (16 x K) . B (K x N)
template <int K, int N>
__device__ __forceinline__ void warp_acc_ab(float* c, int ldf, const bf16* a, int lda,
                                            const bf16* b, int ldb) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    Acc acc;
    wmma::load_matrix_sync(acc, c + j * 16, ldf, wmma::mem_row_major);
    mma_ab<K>(acc, a, lda, b + j * 16, ldb);
    wmma::store_matrix_sync(c + j * 16, acc, ldf, wmma::mem_row_major);
  }
}

// Write `cols` f32 values (multiple of 8) times `mul` as bf16.
__device__ __forceinline__ void store_row(bf16* dst, const float* src, int cols, float mul) {
  for (int c = 0; c < cols; c += 8) {
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = src[c + e] * mul;
    *reinterpret_cast<uint4*>(dst + c) = pack8(f);
  }
}

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

}  // namespace attn_wmma
}  // namespace cgd

extern "C" int cgd_attn_fwd_wmma(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int batch, int T, int heads, int d, int in_stride,
                                 int out_stride, void* stream) {
  using namespace cgd::attn_wmma;
  if (batch <= 0 || T <= 0 || heads <= 0 || in_stride % 8 || out_stride % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 192: return (int)launch_fwd<192>(q, k, v, o, lse, batch, T, heads, in_stride, out_stride, s);
    case 256: return (int)launch_fwd<256>(q, k, v, o, lse, batch, T, heads, in_stride, out_stride, s);
  }
  return (int)cudaErrorNotSupported;
}

extern "C" int cgd_attn_bwd_wmma(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, void* Dvec, void* dq, void* dk,
                                 void* dv, int batch, int T, int heads, int d, int in_stride,
                                 int out_stride, int grad_stride, void* stream) {
  using namespace cgd::attn_wmma;
  if (batch <= 0 || T <= 0 || heads <= 0 || in_stride % 8 || out_stride % 8 || grad_stride % 8)
    return (int)cudaErrorInvalidValue;
  if (d != 192 && d != 256) return (int)cudaErrorNotSupported;
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
  if (d == 192) CGD_BWD(192);
  CGD_BWD(256);
#undef CGD_BWD
}

// Dynamic shared memory of one block: kernel 0 = the forward, 1 = the
// backward's dQ kernel, 2 = its dK/dV kernel (what attn_plan computes).
extern "C" int cgd_attn_wmma_smem_bytes(int kernel, int d) {
  using namespace cgd::attn_wmma;
#define CGD_SMEM(D) \
  if (d == D) return kernel == 0 ? fwd_smem<D>() : kernel == 1 ? dq_smem<D>() : dkdv_smem<D>();
  CGD_SMEM(192)
  CGD_SMEM(256)
#undef CGD_SMEM
  return -1;
}
