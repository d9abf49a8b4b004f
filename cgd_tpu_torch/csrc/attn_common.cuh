// Shared pieces of K-attn-f and K-attn-b: tile sizes per head dim, the
// strided head layout, and the tile loader.
//
// Layout: q, k and v are read in place, one head at a time, from row-major
// activations whose row t of batch b starts at base + (b*T + t) * stride; head
// h is the D columns at h*D. The fused UNet qkv [B, T, 3C] gives q, k, v at
// base offsets 0, C, 2C with stride 3C; the output [B, T, C] has stride C; a
// plain [N, T, D] tensor is heads = 1, stride = D. The per-row log-sum-exp
// is [B*heads, T] f32.
//
// Tiles: WARPS warps own 16 rows each (the block's rows), and the loop
// streams tiles of the other operand with the same number of rows. Every
// warp works on its own rows of the score, probability and accumulator tiles
// in shared memory, so only the streamed tiles need block barriers.
#pragma once

#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace cgd {
namespace attn {

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
  static_assert(D % 64 == 0 && D <= 256, "head dims 64, 128, 192, 256");
  static constexpr int WARPS = D <= 64 ? 4 : 2;  // larger D: fewer rows, same shared memory
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

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace attn
}  // namespace cgd
