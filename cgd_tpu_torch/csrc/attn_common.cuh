// Shared pieces of the Hopper attention kernels, K-attn-f (attn_fwd.cu) and
// K-attn-b (attn_bwd.cu), for head dims 64, 128, 192 and 256: the block's
// roles, the ring's stages, the swizzled tile layout and its wgmma
// descriptors, the accumulator layout and its repacking into A fragments,
// the epilogue, and the host's tensor maps.
//
// Device memory: the UNet's fused qkv [B, T, 3C] (q heads | k heads | v
// heads; head h is the D channels at h*D of each third), the output and its
// cotangent [B, T, C], the per-row log-sum-exp [B*heads, T] f32. The TMA
// reads each bf16 tensor through one 3-D map, {channels, T, B}, with a box
// of 64 channels x 64 rows x 1 image, 128B-swizzled; q, k and v are the same
// qkv map at channel offsets h*D, C + h*D and 2C + h*D. A box that runs past
// row T of its image is zero-filled: a 2-D [B*T, channels] view would read
// the next image's rows instead.
//
// Shared memory: a tile of 64 rows x D channels is D/64 boxes of 64 rows x
// 128 bytes (8 KB each, 1 KB aligned); 16-byte chunk c of row r lies at
// (c / 8) * 8 KB + r * 128 + ((c % 8) ^ (r % 8)) * 16.
//
// Roles: 384 threads. Warpgroup 0 is the producer (thread 0 issues every TMA
// load; setmaxnreg.dec); warpgroups 1 and 2 are the consumers
// (setmaxnreg.inc), each running the block's whole 64-row tile through wgmma
// with its accumulators in registers. The consumers split the work one of two
// ways:
// - at d = 64 / 128, the streamed tiles: tile i goes to consumer i % split,
//   and the partial results combine at the end in a fixed order: consumer 1
//   writes, consumer 0 merges and stores. These rings have an even number
//   of stages, so stage s always serves consumer s % 2: a consumer never
//   waits on a stage whose previous phase is the other one's (with an odd
//   count it could, and the parity wait would pass a phase early);
// - at d = 192 / 256, D, in column shares (COLS): with whole-D accumulators
//   (d/2 f32 a thread, d for dK and dV) beside S and dP, ptxas spilled and
//   serialized the wgmmas even within the 240 registers a consumer has. The
//   forward and the dQ kernel give consumer 0 columns [0, 128) of the output
//   and consumer 1 the rest; the dK/dV kernel takes 64-column shares in two
//   passes (attn_bwd.cu). Shares are whole 64-channel boxes, since a
//   swizzled MN-major B operand starts at a box. Each consumer sees every
//   streamed tile and computes the same full-depth S (and dP), the products
//   two (four in the dK/dV kernel's passes) times over, which these
//   latency-bound shapes afford; each stores its own
//   share, with no merge, and releases each stage itself (the empty
//   barriers count two arrivals).
// The splits depend on the shape only, so reruns are bit-identical.
#pragma once

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cgd {
namespace attn {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int ROWS = 64;    // rows of every tile: the block's own, and each streamed one
constexpr int BOX = 64;     // channels of a TMA box: 128 bytes, one swizzle row
constexpr int BOX_BYTES = ROWS * BOX * 2;
constexpr int MAX_STAGES = 4;
constexpr int NTHREADS = 384, NCONSUMERS = 256;
constexpr int SMEM_ALIGN = 1024;
constexpr int SMEM_MAX = 232448;  // dynamic + static shared memory of one block

// one 64-row tile of a head
template <int D>
struct Tile {
  static_assert(D == 64 || D == 128 || D == 192 || D == 256, "head dims 64, 128, 192, 256");
  static constexpr int BYTES = ROWS * D * 2;
  static constexpr int BOXES = D / BOX;
};

// Stages of each ring, the most that fit one block's shared memory in even
// counts: the forward's (K, V) ring takes 4 up to d = 192 (216 KB there) and
// 2 at 256 (a (K, V) stage is 64 KB); the backward's rings beside its block
// tiles take 4 up to d = 128 and 2 above (dQ at 256: Q, dO and O are 96 KB,
// two (K, V) stages 128 KB).
constexpr int fwd_stages(int d) { return d == 256 ? 2 : 4; }
constexpr int bwd_stages(int d) { return d <= 128 ? 4 : 2; }
// where the consumers split D (COLS above), and consumer 0's share in the
// forward and the dQ kernel: 128 + 64 at d = 192 keeps 384 threads and the
// registers of the d = 128 kernels (three one-box consumers would need 512
// threads and 160 registers each)
constexpr bool split_cols(int d) { return d > 128; }
constexpr int COLS0 = 128;

template <int V>
struct Int {
  static constexpr int value = V;
};

// Runs f(W, C0) (Int<>s) for this consumer warpgroup: all D columns where
// the consumers split the streamed tiles, its share [C0, C0 + W) where they
// split D.
template <int D, bool COLS, typename F>
__device__ __forceinline__ void by_share(F&& f) {
  if constexpr (!COLS) {
    f(Int<D>{}, Int<0>{});
  } else if (threadIdx.x < NTHREADS - NCONSUMERS + 128) {
    f(Int<COLS0>{}, Int<0>{});
  } else {
    f(Int<D - COLS0>{}, Int<COLS0>{});
  }
}

// Shared-memory layouts (the dynamic part; the mbarriers are static) and
// mbarriers of the three kernels. Each stage of a ring is the streamed
// tiles of one loop step.
struct Bars {
  uint64_t tile_full;  // the block's own tiles
  uint64_t full[MAX_STAGES], empty[MAX_STAGES];
};

// K-attn-f: Q, then the ring of (K, V)
template <int D>
struct FwdLayout {
  static constexpr int STAGES = fwd_stages(D);
  static constexpr bool COLS = split_cols(D);
  static constexpr int OFF_STAGES = Tile<D>::BYTES;
  static constexpr int STAGE = 2 * Tile<D>::BYTES;
  static constexpr int SMEM = OFF_STAGES + STAGES * STAGE + SMEM_ALIGN;  // + alignment slack
  static_assert(STAGES % 2 == 0 && STAGES <= MAX_STAGES, "an even ring");
  static_assert(COLS || (D / 2 + 4) * 128 * 4 <= STAGES * STAGE, "combine buffer");
};

// K-attn-b's dQ kernel: Q, dO, O, the row vectors (lse*log2(e) and D, 64
// f32 each), then the ring of (K, V)
template <int D>
struct DqLayout {
  static constexpr int STAGES = bwd_stages(D);
  static constexpr bool COLS = split_cols(D);
  static constexpr int OFF_DO = Tile<D>::BYTES, OFF_O = 2 * Tile<D>::BYTES;
  static constexpr int OFF_VEC = 3 * Tile<D>::BYTES;
  static constexpr int OFF_STAGES = OFF_VEC + SMEM_ALIGN;
  static constexpr int STAGE = 2 * Tile<D>::BYTES;
  static constexpr int SMEM = OFF_STAGES + STAGES * STAGE + SMEM_ALIGN;
  static_assert(STAGES % 2 == 0 && STAGES <= MAX_STAGES, "an even ring");
  static_assert(COLS || (D / 2) * 128 * 4 <= STAGES * STAGE, "combine buffer");
};

// K-attn-b's dK/dV kernel: K, V, then the ring of (Q, dO, the row vectors)
template <int D>
struct DkdvLayout {
  static constexpr int STAGES = bwd_stages(D);
  static constexpr bool COLS = split_cols(D);
  static constexpr int PASSES = COLS ? 2 : 1;  // over the q tiles (dkdv_consumer)
  static constexpr int OFF_STAGES = 2 * Tile<D>::BYTES;
  static constexpr int OFF_VEC = 2 * Tile<D>::BYTES;  // in a stage
  static constexpr int STAGE = OFF_VEC + SMEM_ALIGN;
  static constexpr int SMEM = OFF_STAGES + STAGES * STAGE + SMEM_ALIGN;
  static_assert(STAGES % 2 == 0 && STAGES <= MAX_STAGES, "an even ring");
  static_assert(COLS || D * 128 * 4 <= STAGES * STAGE, "combine buffer");
};

__device__ __forceinline__ int chunk_off(int r, int c) {
  return (c >> 3) * BOX_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma descriptors of k16 step kk over a tile (hopper.cuh, make_desc):
// K-major, the reduction along the channels (Q.K^T, dO.V^T and their
// transposes); MN-major, the reduction down the rows (P.V, dS.K, P^T.dO,
// dS^T.Q).
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int kk) {
  return make_desc(tile + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024, 1);
}
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int kk) {
  return make_desc(tile + kk * 16 * 128, BOX_BYTES, 1024, 1);
}

// acc = A.B^T over the D channels of two K-major 64-row tiles, one m64n64k16
// wgmma per k16 step.
template <int D>
__device__ __forceinline__ void gemm_k(float (&acc)[ROWS / 2], const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<ROWS, 0>(acc, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// The A fragment of k16 step kk of a tile for this warp's 16 rows.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const unsigned char* tile, int kk) {
  const int lane = threadIdx.x & 31, r = 16 * ((threadIdx.x >> 5) & 3) + (lane & 15);
  ldmatrix_x4(a, smem_addr(tile) + chunk_off(r, 2 * kk + (lane >> 4)));
}

// wgmma's m64nN f32 accumulator: element r of a consumer thread (warp w of
// its warpgroup, lane l) is row 16w + l/4 + 8*((r/2) % 2), column
// 8*(r/4) + 2*(l%4) + r%2. So a thread holds two rows (half = (r/2) % 2),
// each shared with the three other lanes of its quad.
__device__ __forceinline__ int acc_row(int r) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * ((r >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int r) { return 8 * (r >> 2) + 2 * (threadIdx.x & 3) + (r & 1); }

// An accumulator of N columns as the A operand of a product over those
// columns, in registers: the pairs {8j, 8j+1}, {8j+2, 8j+3}, {8j+4, 8j+5},
// {8j+6, 8j+7} are the four registers of k16 step j (low half = lower
// column), rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = pack_bf16x2(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Consumer 1's partial result for consumer 0: element r of consumer thread
// t at [r][t], so each thread of consumer 0 reads what its twin wrote.
template <int R>
__device__ __forceinline__ void put_partial(float* buf, const float (&v)[R]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int r = 0; r < R; ++r) buf[r * 128 + t] = v[r];
}
template <int R>
__device__ __forceinline__ void add_partial(const float* buf, float (&v)[R]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] += buf[r * 128 + t];
}

// A consumer's epilogue: its 64 x W accumulator, times mul[half] on each of
// its rows, as bf16 rows row0.. (those below T) of dst (row stride `stride`
// elements), staged through free boxes of shared memory (`stage`, W / 64 of
// them) so that each thread writes 16 bytes; `bar` is the warpgroup's own
// named barrier.
template <int W>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 2], const float (&mul)[2],
                                           unsigned char* stage, bf16* __restrict__ dst, int row0,
                                           int T, int stride, int bar) {
#pragma unroll
  for (int r = 0; r < W / 2; r += 2) {
    const int row = acc_row(r), col = acc_col(r);
    const float m = mul[(r >> 1) & 1];
    *reinterpret_cast<uint32_t*>(stage + chunk_off(row, col >> 3) + (col & 7) * 2) =
        pack_bf16x2(acc[r] * m, acc[r + 1] * m);
  }
  named_barrier(bar, 128);
  constexpr int CH = W / 8;
  for (int i = threadIdx.x & 127; i < ROWS * CH; i += 128) {
    const int r = i / CH, c = i - r * CH;
    if (row0 + r < T)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + chunk_off(r, c));
  }
}

// A consumer's 64 x W accumulator, times mul, as bf16 rows row0.. (those
// below T) of dst (row stride `stride` elements), straight from registers:
// each thread its pairs of adjacent columns.
template <int W>
__device__ __forceinline__ void store_regs(const float (&acc)[W / 2], float mul,
                                           bf16* __restrict__ dst, int row0, int T, int stride) {
#pragma unroll
  for (int r = 0; r < W / 2; r += 2) {
    const int row = row0 + acc_row(r);
    if (row < T)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * stride + acc_col(r)) =
          pack_bf16x2(acc[r] * mul, acc[r + 1] * mul);
  }
}

// 1 KB-aligned dynamic shared memory
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + SMEM_ALIGN - 1) &
                                          ~(uintptr_t)(SMEM_ALIGN - 1));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// [batch, T, width] bf16 as the 3-D map {width, T, batch}, box 64 channels x
// 64 rows x 1, 128B-swizzled, zero-filled outside.
inline int map_rows(CUtensorMap* m, const void* p, int batch, int T, int width) {
  EncodeTiledFn f;
  if (int st = encode_fn(&f)) return st;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)T, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)T * width * 2};
  const cuuint32_t box[3] = {BOX, ROWS, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides,
                       box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// The launch plan the wrapper made (kernels/attention.py attn_plan): the
// tile, the stages (`want`: this build's for the kernel and d) and the split
// of the streamed tiles this build takes for this shape.
inline bool plan_ok(int batch, int T, int heads, int d, int tile, int stages, int want,
                    int split) {
  const int tiles = (T + ROWS - 1) / ROWS;
  return batch > 0 && T > 0 && heads > 0 && (d == 64 || d == 128 || d == 192 || d == 256) &&
         tile == ROWS && stages == want && split >= 1 && split <= 2 && split <= tiles;
}

}  // namespace attn
}  // namespace cgd
