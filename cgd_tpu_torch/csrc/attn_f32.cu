// K-attn-f and K-attn-b at f32 operands, for sm_90a: multi-head
// self-attention of the UNet at compute_dtype="float32", head dims 64, 128,
// 192 and 256, on the TF32 tensor cores with the 3xTF32 split.
//
// Replaces the Pallas TPU kernels cgd_tpu/kernels/attention_pallas.py
// (_run_fwd -> _fwd_kernel, _run_bwd -> _bwd_kernel) at f32 operands
// (flash_mha is generic over the dtype, attention_pallas.py:39, 56-61):
//   out = softmax(q.k^T / sqrt(d)) . v   per (batch, head), everything f32,
// and its backward, given dO, with P recomputed from the forward's lse:
//   D = rowsum(dO o O), dV = P^T.dO, dS = P o (dO.V^T - D),
//   dQ = dS.K / sqrt(d), dK = dS^T.Q / sqrt(d).
// They read q, k and v in place from the UNet's fused qkv [B, T, 3C] (q heads
// | k heads | v heads; head h is the d channels at h*d of each third) and
// write out [B, T, C], the per-row log-sum-exp [B*heads, T] and dqkv
// [B, T, 3C].
//
// Bound: operations, 4*T^2*d FLOP forward and 10*T^2*d backward against
// 16*T*d bytes, on paper the TF32 rate (three MMAs a product here); at the
// UNet's shapes (4-16 heads, T <= 1024) the issue rate of the split and the
// fragment loads beside the MMAs, and latency at the short-T shapes.
//
// Precision: every product runs on the tensor cores at TF32 in the 3xTF32
// scheme (common.cuh): each f32 operand splits, in registers as it leaves
// shared memory, into hi + lo (split_tf32_trunc: a bit mask and an f32
// subtraction, two instructions where the rounding split_tf32 takes four;
// on the card 5-8% faster at the same error against the plain version),
// and a product is lo*hi + hi*lo + hi*hi, the small terms first: f32's
// precision at three MMAs a product (plain TF32 keeps three decimal digits;
// the f32 kernels are held to 1e-5 of the reference's max). The tensor
// cores truncate as they add into their accumulator, so no partial sum runs
// long in one fragment: S and dP sum each 64-channel chunk in fresh
// fragments (the hi*hi terms and the small terms apart, 8 and 16 MMAs)
// added to S in f32, and each streamed tile's P.V, dS.K, P^T.dO and dS^T.Q
// (12 MMAs at a 32-row tile) goes to a fresh fragment added to O, dQ, dV or
// dK in f32 (in the forward this is the online softmax's
// O = alpha*O + PV_tile).
//
// The instruction: mma.sync.m16n8k8 at TF32 for every product. wgmma at
// TF32 reads a shared-memory operand K-major only (the transpose bits are
// for 16-bit types): S = Q.K^T and dP = dO.V^T would fit, but the products
// over tokens (P.V, dS.K, P^T.dO, dS^T.Q) take a token-major B operand,
// which would have to be staged transposed, in hi and lo copies (twice the
// f32 footprint: a 64-row d = 256 tile is 64 KB raw, 128 KB split) in a
// block that already holds its own tiles and a ring. mma.sync loads its
// fragments from shared memory in any layout and splits them in registers,
// so every operand stays as the TMA wrote it, and one body serves every
// head dim. The products over tokens take their A operand (P, dS, P^T, dS^T)
// straight from the accumulator of the product before: an m16n8 accumulator
// holds columns 2t, 2t+1 of rows g, g+8 (g = lane/4, t = lane%4), an m16k8
// A fragment columns t, t+4; the k index of one MMA is a sum, so k = t
// stands for the token of column 2t and k = t + 4 for that of 2t + 1, and
// the B fragment reads those tokens to match. The same freedom (which
// channel, row or output column a fragment index stands for) lets every
// operand load 16 bytes a lane without bank conflicts (perm, acc_col,
// gemm_nt, gemm_pv below): a third of the shared-memory loads of 4-byte
// fragment loads, 15-25% faster on the card. S, P, dP and dS never leave
// the registers; the softmax's running max and sum (forward) and the rows'
// lse and D (dQ kernel) stay in registers too.
//
// Layout: a producer and one or two halves of four consumer warps, each
// warp owning 16 of the block's 64 rows (its mma.sync m16). With two halves
// (an even ring) streamed tile i goes to half i % 2, and half 1's sums merge
// into half 0's at the end, in a fixed order, through the free ring. The
// producer's lane 0 loads the block's own tiles once and streams the others
// through a ring of STAGES (3-4) stages by TMA, one 3-D map {channels, T,
// B} per tensor at f32, boxes of 32 channels (128 bytes, one swizzle row) x
// the streamed tile's rows, 128B-swizzled: float c of row r of a tile of R
// rows lies at (c/32)*R*32 + r*32 + 4*((c/4 % 8) ^ (r % 8)) + c%4. Rows
// past T come zero-filled; keys past T are masked to -inf (P = 0), queries
// past T get lse = +inf (P = 0). Consumers wait on a stage's full barrier
// and release it (one arrival a warp) when their products are done.
//
// The grid: one block per (64-row tile, batch*head, 64-column share of the
// output). Every block of a row tile recomputes the full-depth S (and dP) for
// its share of O, dQ, dK and dV: (4, 256, 192) runs 48 blocks, (4, 64, 256)
// 16, where one block per row tile gave 16 and 4. Every output element has
// one owner and no float atomics, so reruns are bit-identical.
// - Forward: per K/V tile, S = Q.K^T (Q and K full depth), the online
//   softmax in registers (exp2 of log2(e)/sqrt(d)-scaled logits; a row's
//   max over the quad of lanes holding it), O = alpha*O + P.V over the
//   block's 64 columns of V (the ring carries only those). Writes O / l and
//   (share 0) lse = m*ln2 + ln(l).
// - Backward, two launches:
//   1. dQ (own Q, dO; streams K, V): D for its rows from O (global) and dO
//      (written by share 0 for launch 2); per K/V tile S, dP = dO.V^T,
//      P = exp2(S*c - lse*log2(e)), dS = P o (dP - D), dQ += dS.K over its
//      share of K's columns.
//   2. dK/dV (own K, V; streams Q, dO and the tile's lse and D, which the
//      producer warp's 32 lanes stage beside each box pair): S^T = K.Q^T,
//      dP^T = V.dO^T, P^T, dS^T, dV += P^T.dO and dK += dS^T.Q over its
//      share.
// Tiles, stages and shared memory per kernel and head dim are below and in
// kernels/attention.py f32_attn_plan, which the entry points check.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cgd {
namespace attn32 {

constexpr int ROWS = 64;                  // the block's own rows
constexpr int WARPS = 4;                  // consumer warps of a half, 16 rows each
constexpr int COLS = 64;                  // output columns of one block
constexpr int MAX_STAGES = 4;
constexpr int SMEM_ALIGN = 1024;          // a 128B-swizzled TMA box starts 1 KB aligned
constexpr int SMEM_MAX = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// rows of the streamed tile and stages of the ring, forward and backward
// (both kernels), by head dim (f32_attn_plan mirrors them): the most stages
// that fit one block beside its own tiles, at least three. Above d = 128
// the backward's own tiles (Q and dO, or K and V: 96-128 KB) leave room for
// 16-row tiles only.
__host__ __device__ constexpr int fwd_tile(int) { return 32; }
__host__ __device__ constexpr int fwd_stages(int) { return 4; }
__host__ __device__ constexpr int bwd_tile(int d) { return d <= 128 ? 32 : 16; }
__host__ __device__ constexpr int bwd_stages(int d) { return d == 256 ? 3 : 4; }
// Two halves of four consumer warps where the ring has an even number of
// stages: tile i goes to half i % 2, so stage s always serves half s % 2 (a
// half never waits on a stage whose previous phase was the other half's:
// with an odd count it could, and the parity wait would pass a phase early).
// At d = 256 the backward's three stages run one half.
__host__ __device__ constexpr int halves(int stages) { return stages % 2 == 0 ? 2 : 1; }
// With two halves the producer is a whole warpgroup (warp 0 works; 384
// threads) and hands registers to the consumers with setmaxnreg (40 and 232
// a thread): ptxas compiles such a block to 168 registers a thread (it
// spills a few hundred bytes at d = 64), and on the card this beat a
// single producer warp (288 threads, 168 registers too) by 8-10% and the same
// block without setmaxnreg by 3-5%. One half runs a producer warp beside
// its four consumer warps, 160 threads, 255 registers.
__host__ __device__ constexpr int producer_warps(int stages) { return halves(stages) == 2 ? 4 : 1; }
__host__ __device__ constexpr int threads(int stages) {
  return 32 * (producer_warps(stages) + WARPS * halves(stages));
}
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536, "the SM's registers");

// Shared memory, in floats from the 1 KB-aligned base (the mbarriers are
// static). Every tile offset is a multiple of 256 floats (1 KB).
template <int D>
struct FwdLayout {  // Q, then the ring of (K, the block's 64 columns of V)
  static constexpr int ST = fwd_tile(D), STAGES = fwd_stages(D);
  static constexpr int HALVES = halves(STAGES), THREADS = threads(STAGES);
  static constexpr int PWARPS = producer_warps(STAGES);
  static constexpr int Q = 0, RING = ROWS * D;
  static constexpr int V = ST * D, STAGE = ST * D + ST * COLS;
  static constexpr int SMEM = (RING + STAGES * STAGE) * 4 + SMEM_ALIGN;
  static constexpr int STAGE_BYTES = STAGE * 4;
};

template <int D>
struct DqLayout {  // Q, dO, then the ring of (K, V)
  static constexpr int ST = bwd_tile(D), STAGES = bwd_stages(D);
  static constexpr int HALVES = halves(STAGES), THREADS = threads(STAGES);
  static constexpr int PWARPS = producer_warps(STAGES);
  static constexpr int Q = 0, DO = ROWS * D, RING = 2 * ROWS * D;
  static constexpr int V = ST * D, STAGE = 2 * ST * D;
  static constexpr int SMEM = (RING + STAGES * STAGE) * 4 + SMEM_ALIGN;
  static constexpr int STAGE_BYTES = STAGE * 4;
};

template <int D>
struct DkdvLayout {  // K, V, the ring of (Q, dO), then each stage's lse and D
  static constexpr int ST = bwd_tile(D), STAGES = bwd_stages(D);
  static constexpr int HALVES = halves(STAGES), THREADS = threads(STAGES);
  static constexpr int PWARPS = producer_warps(STAGES);
  static constexpr int K = 0, V = ROWS * D, RING = 2 * ROWS * D;
  static constexpr int DO = ST * D, STAGE = 2 * ST * D;
  static constexpr int VEC = RING + STAGES * STAGE;  // stage s: lse at s*2*ST, D after
  static constexpr int SMEM = (VEC + STAGES * 2 * ST) * 4 + SMEM_ALIGN;
  static constexpr int STAGE_BYTES = STAGE * 4;
};

template <typename L>
struct Check {
  static_assert(L::STAGES >= 3 && L::STAGES <= MAX_STAGES, "a ring of 3-4 stages");
  static_assert(L::SMEM + 8 * (2 * MAX_STAGES + 1) <= SMEM_MAX, "one block's shared memory");
  // the merge of the halves passes 36 floats a consumer thread of half 1
  // (64 in two rounds in the dK/dV kernel) through the ring
  static_assert(L::HALVES == 1 || L::STAGES * L::STAGE >= 36 * 128, "merge buffer");
  static constexpr bool ok = true;
};

// float c of row r of a swizzled tile of R rows (TMA boxes of 32 channels x
// R rows side by side)
template <int R>
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 5) * (R * 32) + r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// Rows [t0, t0 + R) and channels [c0, c0 + W) of image b through `map`
// (boxes of 32 channels x BR rows) into a swizzled tile at dst; R * W * 4
// bytes complete on `bar`.
template <int R, int W, int BR>
__device__ __forceinline__ void load_tile(float* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int t0, int b) {
#pragma unroll 1
  for (int cb = 0; cb < W / 32; ++cb)
#pragma unroll 1
    for (int rb = 0; rb < R / BR; ++rb)
      tma_load_3d(dst + cb * R * 32 + rb * BR * 32, map, bar, c0 + 32 * cb, t0 + rb * BR, b);
}

// three MMAs of a 3xTF32 product, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// Fragment rows are permuted within each 8-row group: the lanes of quad g
// hold row perm(g) (A's rows r0 + perm(g) and r0 + 8 + perm(g), B's row 8j +
// perm(g)), so that gemm_nt's 16-byte loads fall in distinct bank groups
// (two quads per quarter-warp read rows whose swizzle differs in bit 2) and
// gemm_pv's token-major B loads stay conflict-free. An accumulator's rows
// are then the tile's rows r0 + perm(g), + 8, and its columns 2t, 2t + 1 of
// n8 tile j the streamed rows 8j + perm(2t) and 8j + perm(2t + 1).
__device__ __forceinline__ int perm(int g) { return g ^ ((g & 1) << 2); }
__device__ __forceinline__ int acc_col(int j, int t, int e) { return 8 * j + perm(2 * t + (e & 1)); }

// acc[16 x N] = A[rows r0.., D channels] . B[N rows, D channels]^T, A from a
// swizzled tile of AR rows, B from one of N rows. Each lane loads 16 bytes,
// channels 4t .. 4t + 3 of a 16-channel group, for two k8 steps: k = t and
// t + 4 stand for channels 4t and 4t + 1 in the first, 4t + 2 and 4t + 3 in
// the second (A and B alike, so the sum over k runs over every channel).
// Each 64-channel chunk is summed in fresh fragments and added in f32: the
// hi*hi terms in one, the small terms in another (two chains of MMAs for the
// tensor cores to overlap, and the small terms summed apart from the large
// ones, which halved the error against f64 on the card).
template <int D, int AR, int N>
__device__ __forceinline__ void gemm_nt(float (&acc)[N / 8][4], const float* a, const float* b,
                                        int r0) {
  const int pg = perm((threadIdx.x & 31) >> 2), t = threadIdx.x & 3;
#pragma unroll 1
  for (int c = 0; c < D; c += 64) {
    float part[N / 8][4], small[N / 8][4];  // hi*hi, and lo*hi + hi*lo
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = small[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      const float4 x = *reinterpret_cast<const float4*>(a + sw<AR>(r0 + pg, c + kk + 4 * t));
      const float4 y = *reinterpret_cast<const float4*>(a + sw<AR>(r0 + pg + 8, c + kk + 4 * t));
      uint32_t ah[2][4], al[2][4];
      split_tf32_trunc(x.x, ah[0][0], al[0][0]);
      split_tf32_trunc(y.x, ah[0][1], al[0][1]);
      split_tf32_trunc(x.y, ah[0][2], al[0][2]);
      split_tf32_trunc(y.y, ah[0][3], al[0][3]);
      split_tf32_trunc(x.z, ah[1][0], al[1][0]);
      split_tf32_trunc(y.z, ah[1][1], al[1][1]);
      split_tf32_trunc(x.w, ah[1][2], al[1][2]);
      split_tf32_trunc(y.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float4 z = *reinterpret_cast<const float4*>(b + sw<N>(8 * j + pg, c + kk + 4 * t));
        uint32_t bh[2][2], bl[2][2];
        split_tf32_trunc(z.x, bh[0][0], bl[0][0]);
        split_tf32_trunc(z.y, bh[0][1], bl[0][1]);
        split_tf32_trunc(z.z, bh[1][0], bl[1][0]);
        split_tf32_trunc(z.w, bh[1][1], bl[1][1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_tf32(small[j], al[h], bh[h]);
          mma_tf32(small[j], ah[h], bl[h]);
          mma_tf32(part[j], ah[h], bh[h]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[j][e] += small[j][e];
        if (c == 0) acc[j][e] = part[j][e];
        else acc[j][e] += part[j][e];
      }
  }
}

// acc[16 x W] = P[16 x N] . B[N rows, columns cb.. cb + W) of a swizzled
// tile of N rows. P is the accumulator of a gemm_nt (columns 2t, 2t + 1 of
// n8 tile j: streamed rows acc_col(j, t, 0 / 1)), used as A fragments with
// k = t and t + 4 standing for those two rows; the B fragment reads them.
// The output columns are permuted too, so that B loads 16 bytes a lane: n8
// tile 4q + m, column n of the MMA is column cb + 32q + 4n + m; a thread's
// accumulator then holds columns 32q + 8t .. 32q + 8t + 7 of its two rows
// (out_col), which store_acc writes 16 bytes at a time.
template <int N, int W>
__device__ __forceinline__ void gemm_pv(float (&acc)[W / 8][4], const float (&p)[N / 8][4],
                                        const float* b, int cb) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32_trunc(p[j][0], ah[0], al[0]);  // row g, k = t
    split_tf32_trunc(p[j][2], ah[1], al[1]);  // row g + 8, k = t
    split_tf32_trunc(p[j][1], ah[2], al[2]);  // row g, k = t + 4
    split_tf32_trunc(p[j][3], ah[3], al[3]);  // row g + 8, k = t + 4
    const int k0 = acc_col(j, t, 0), k1 = acc_col(j, t, 1);
#pragma unroll
    for (int q = 0; q < W / 32; ++q) {
      const float4 z0 = *reinterpret_cast<const float4*>(b + sw<N>(k0, cb + 32 * q + 4 * g));
      const float4 z1 = *reinterpret_cast<const float4*>(b + sw<N>(k1, cb + 32 * q + 4 * g));
      const float b0[4] = {z0.x, z0.y, z0.z, z0.w}, b1[4] = {z1.x, z1.y, z1.z, z1.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t bh[2], bl[2];
        split_tf32_trunc(b0[m], bh[0], bl[0]);
        split_tf32_trunc(b1[m], bh[1], bl[1]);
        mma3(acc[4 * q + m], ah, al, bh, bl);
      }
    }
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

// A warp's 16 x 64 accumulator of a gemm_pv (rows row0 + perm(g), + 8;
// element e of tile 4q + m is column 32q + 8t + 4(e % 2) + m), times
// mul[half], into rows below T of dst (row stride `stride` floats), 16 bytes
// a store.
__device__ __forceinline__ void store_acc(const float (&acc)[COLS / 8][4], const float (&mul)[2],
                                          float* __restrict__ dst, int row0, int T, int stride) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + perm(g) + 8 * hh;
    if (row >= T) continue;
    const float x = mul[hh];
#pragma unroll
    for (int q = 0; q < COLS / 32; ++q)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 2 * hh + u;
        *reinterpret_cast<float4*>(dst + (size_t)row * stride + 32 * q + 8 * t + 4 * u) =
            make_float4(acc[4 * q][e] * x, acc[4 * q + 1][e] * x, acc[4 * q + 2][e] * x,
                        acc[4 * q + 3][e] * x);
      }
  }
}

__device__ __forceinline__ float* align_smem(unsigned char* p) {
  return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(p) + SMEM_ALIGN - 1) &
                                  ~(uintptr_t)(SMEM_ALIGN - 1));
}

__device__ __forceinline__ void init_bars(uint64_t* tile_full, uint64_t* full, uint64_t* empty,
                                          int stages, int full_count) {
  if (threadIdx.x == 0) {
    mbar_init(tile_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// a consumer warp is done with stage s
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// With two halves: half 1's accumulator added to its twin's in half 0, in
// that order, through `buf` (free once both halves are past their loops).
template <int HALVES>
__device__ __forceinline__ void add_half1(float (&acc)[COLS / 8][4], float* buf, int half) {
  if constexpr (HALVES == 2) {
    const int tid = threadIdx.x & 127;
    named_barrier(1, 32 * WARPS * 2);
    if (half == 1) {
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) buf[(4 * j + e) * 128 + tid] = acc[j][e];
    }
    named_barrier(1, 32 * WARPS * 2);
    if (half == 0) {
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += buf[(4 * j + e) * 128 + tid];
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(FwdLayout<D>::THREADS, 1)
attn_fwd_f32_kernel(const __grid_constant__ CUtensorMap qkv, float* __restrict__ out,
                    float* __restrict__ lse, int T, int heads, int dh) {
  using L = FwdLayout<D>;
  static_assert(Check<L>::ok, "layout");
  constexpr int ST = L::ST, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t tile_full, full[STAGES], empty[STAGES];
  float* smem = align_smem(smem_raw);
  const int n = blockIdx.y, b = n / heads, h = n - b * heads;
  const int q0 = blockIdx.x * ROWS, c0 = blockIdx.z * COLS, C = heads * D;
  const int warp = threadIdx.x >> 5, ntiles = (T + ST - 1) / ST;
  init_bars(&tile_full, full, empty, STAGES, 1);

  if (warp < L::PWARPS) {  // the producer
    if constexpr (L::HALVES == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&tile_full, ROWS * D * 4);
      load_tile<ROWS, D, ST>(smem + L::Q, &qkv, &tile_full, h * D, q0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) + 1) & 1);
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
        float* st = smem + L::RING + s * L::STAGE;
        load_tile<ST, D, ST>(st, &qkv, &full[s], C + h * D, i * ST, b);
        load_tile<ST, COLS, ST>(st + L::V, &qkv, &full[s], 2 * C + h * D + c0, i * ST, b);
      }
    }
    return;
  }

  if constexpr (L::HALVES == 2) setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = warp - L::PWARPS, half = cw / WARPS, r0 = 16 * (cw % WARPS);
  const int t = threadIdx.x & 3;
  const float sl2 = LOG2E / sqrtf((float)dh);
  float o[COLS / 8][4];
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's columns only
  mbar_wait(&tile_full, 0);
#pragma unroll 1
  for (int i = half; i < ntiles; i += L::HALVES) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const float* sk = smem + L::RING + s * L::STAGE;
    float sc[ST / 8][4];
    gemm_nt<D, ROWS, ST>(sc, smem + L::Q, sk, r0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < ST / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = i * ST + acc_col(j, t, e);
        sc[j][e] = key < T ? sc[j][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // finite: every tile has a key below T
      const float mn = fmaxf(m[hh], quad_max(mx[hh]));
      alpha[hh] = exp2f(m[hh] - mn);
      m[hh] = mn;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int j = 0; j < ST / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(sc[j][e] - m[e >> 1]);
        l[e >> 1] += sc[j][e];
      }
    float pv[COLS / 8][4];
    gemm_pv<ST, COLS>(pv, sc, sk + L::V, 0);
    release(&empty[s]);
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = o[j][e] * alpha[e >> 1] + pv[j][e];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(l[hh]);
  if constexpr (L::HALVES == 2) {  // half 1 hands (m, l, O) to its twin, which merges
    float* buf = smem + L::RING;
    const int tid = threadIdx.x & 127;
    named_barrier(1, 32 * WARPS * 2);
    if (half == 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        buf[hh * 128 + tid] = m[hh];
        buf[(2 + hh) * 128 + tid] = l[hh];
      }
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) buf[(4 + 4 * j + e) * 128 + tid] = o[j][e];
    }
    named_barrier(1, 32 * WARPS * 2);
    if (half == 1) return;
    float a0[2], a1[2];  // half 1 has no tile where T <= 32: m = -inf, l = 0, O = 0
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m1 = buf[hh * 128 + tid], mn = fmaxf(m[hh], m1);
      a0[hh] = exp2f(m[hh] - mn);
      a1[hh] = exp2f(m1 - mn);
      m[hh] = mn;
      l[hh] = l[hh] * a0[hh] + buf[(2 + hh) * 128 + tid] * a1[hh];
    }
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[j][e] = o[j][e] * a0[e >> 1] + buf[(4 + 4 * j + e) * 128 + tid] * a1[e >> 1];
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_acc(o, inv, out + (size_t)b * T * C + h * D + c0, q0 + r0, T, C);
  if (blockIdx.z == 0 && t == 0) {
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + perm(g) + 8 * hh;
      if (row < T) lse[(size_t)n * T + row] = m[hh] * LN2 + logf(l[hh]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 1: dQ, and D = rowsum(dO o O)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(DqLayout<D>::THREADS, 1)
attn_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap qkv,
                       const __grid_constant__ CUtensorMap dout, const float* __restrict__ o_,
                       const float* __restrict__ lse, float* __restrict__ Dvec,
                       float* __restrict__ dqkv, int T, int heads, int dh) {
  using L = DqLayout<D>;
  static_assert(Check<L>::ok, "layout");
  constexpr int ST = L::ST, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t tile_full, full[STAGES], empty[STAGES];
  float* smem = align_smem(smem_raw);
  const int n = blockIdx.y, b = n / heads, h = n - b * heads;
  const int q0 = blockIdx.x * ROWS, c0 = blockIdx.z * COLS, C = heads * D;
  const int warp = threadIdx.x >> 5, ntiles = (T + ST - 1) / ST;
  init_bars(&tile_full, full, empty, STAGES, 1);

  if (warp < L::PWARPS) {  // the producer
    if constexpr (L::HALVES == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&tile_full, 2 * ROWS * D * 4);
      load_tile<ROWS, D, ST>(smem + L::Q, &qkv, &tile_full, h * D, q0, b);
      load_tile<ROWS, D, ST>(smem + L::DO, &dout, &tile_full, h * D, q0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) + 1) & 1);
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
        float* st = smem + L::RING + s * L::STAGE;
        load_tile<ST, D, ST>(st, &qkv, &full[s], C + h * D, i * ST, b);
        load_tile<ST, D, ST>(st + L::V, &qkv, &full[s], 2 * C + h * D, i * ST, b);
      }
    }
    return;
  }

  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  if constexpr (L::HALVES == 2) setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = warp - L::PWARPS, half = cw / WARPS, r0 = 16 * (cw % WARPS);
  const float sl2 = LOG2E / sqrtf((float)dh);
  mbar_wait(&tile_full, 0);
  // D and lse*log2(e) of rows g, g + 8 (rows past T: D = 0, lse = +inf, so P = 0)
  float dd[2], l2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + perm(g) + 8 * hh, row = q0 + r;
    float sum = 0.f;
    if (row < T) {
      const float* orow = o_ + ((size_t)b * T + row) * C + h * D;
#pragma unroll 4
      for (int c = 4 * t; c < D; c += 16) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(smem + L::DO + sw<ROWS>(r, c));
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
        sum = fmaf(x.z, y.z, sum);
        sum = fmaf(x.w, y.w, sum);
      }
    }
    dd[hh] = quad_sum(sum);
    l2[hh] = row < T ? lse[(size_t)n * T + row] * LOG2E : INFINITY;
    if (blockIdx.z == 0 && half == 0 && t == 0 && row < T) Dvec[(size_t)n * T + row] = dd[hh];
  }

  float dq[COLS / 8][4];
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
#pragma unroll 1
  for (int i = half; i < ntiles; i += L::HALVES) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const float* sk = smem + L::RING + s * L::STAGE;
    float sc[ST / 8][4], dp[ST / 8][4];
    gemm_nt<D, ROWS, ST>(sc, smem + L::Q, sk, r0);
    gemm_nt<D, ROWS, ST>(dp, smem + L::DO, sk + L::V, r0);
#pragma unroll
    for (int j = 0; j < ST / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = i * ST + acc_col(j, t, e), hh = e >> 1;
        const float p = key < T ? exp2f(sc[j][e] * sl2 - l2[hh]) : 0.f;
        sc[j][e] = p * (dp[j][e] - dd[hh]);
      }
    float part[COLS / 8][4];
    gemm_pv<ST, COLS>(part, sc, sk, c0);
    release(&empty[s]);
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] += part[j][e];
  }
  add_half1<L::HALVES>(dq, smem + L::RING, half);
  if (half == 1) return;
  const float scale = 1.f / sqrtf((float)dh), mul[2] = {scale, scale};
  store_acc(dq, mul, dqkv + (size_t)b * T * 3 * C + h * D + c0, q0 + r0, T, 3 * C);
}

// ---------------------------------------------------------------------------
// backward 2: dK and dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(DkdvLayout<D>::THREADS, 1)
attn_bwd_dkdv_f32_kernel(const __grid_constant__ CUtensorMap qkv,
                         const __grid_constant__ CUtensorMap dout, const float* __restrict__ lse,
                         const float* __restrict__ Dvec, float* __restrict__ dqkv, int T,
                         int heads, int dh) {
  using L = DkdvLayout<D>;
  static_assert(Check<L>::ok, "layout");
  constexpr int ST = L::ST, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t tile_full, full[STAGES], empty[STAGES];
  float* smem = align_smem(smem_raw);
  const int n = blockIdx.y, b = n / heads, h = n - b * heads;
  const int k0 = blockIdx.x * ROWS, c0 = blockIdx.z * COLS, C = heads * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ntiles = (T + ST - 1) / ST;
  // a stage is full when the TMA's bytes have landed and each of the
  // producer's 32 lanes has staged its share of the tile's lse and D
  init_bars(&tile_full, full, empty, STAGES, 32);

  if (warp < L::PWARPS) {  // the producer: warp 0
    if constexpr (L::HALVES == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > 0) return;
    if (lane == 0) {
      mbar_expect_tx(&tile_full, 2 * ROWS * D * 4);
      load_tile<ROWS, D, ST>(smem + L::K, &qkv, &tile_full, C + h * D, k0, b);
      load_tile<ROWS, D, ST>(smem + L::V, &qkv, &tile_full, 2 * C + h * D, k0, b);
    }
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) + 1) & 1);
      float* vec = smem + L::VEC + s * 2 * ST;
      for (int x = lane; x < ST; x += 32) {  // queries past T: lse = +inf (P = 0), D = 0
        const int q = i * ST + x;
        vec[x] = q < T ? lse[(size_t)n * T + q] * LOG2E : INFINITY;
        vec[ST + x] = q < T ? Dvec[(size_t)n * T + q] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
        float* st = smem + L::RING + s * L::STAGE;
        load_tile<ST, D, ST>(st, &qkv, &full[s], h * D, i * ST, b);
        load_tile<ST, D, ST>(st + L::DO, &dout, &full[s], h * D, i * ST, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  if constexpr (L::HALVES == 2) setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = warp - L::PWARPS, half = cw / WARPS, r0 = 16 * (cw % WARPS);
  const int t = lane & 3;
  const float sl2 = LOG2E / sqrtf((float)dh);
  float dk[COLS / 8][4], dv[COLS / 8][4];
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  mbar_wait(&tile_full, 0);
#pragma unroll 1
  for (int i = half; i < ntiles; i += L::HALVES) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const float* sq = smem + L::RING + s * L::STAGE;
    const float* vec = smem + L::VEC + s * 2 * ST;
    float sc[ST / 8][4], dp[ST / 8][4];
    gemm_nt<D, ROWS, ST>(sc, smem + L::K, sq, r0);
    gemm_nt<D, ROWS, ST>(dp, smem + L::V, sq + L::DO, r0);
#pragma unroll
    for (int j = 0; j < ST / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = acc_col(j, t, e);
        const float p = exp2f(sc[j][e] * sl2 - vec[x]);
        sc[j][e] = p;
        dp[j][e] = p * (dp[j][e] - vec[ST + x]);
      }
    float part[COLS / 8][4];
    gemm_pv<ST, COLS>(part, sc, sq + L::DO, c0);
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[j][e] += part[j][e];
    gemm_pv<ST, COLS>(part, dp, sq, c0);
    release(&empty[s]);
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[j][e] += part[j][e];
  }
  add_half1<L::HALVES>(dv, smem + L::RING, half);
  add_half1<L::HALVES>(dk, smem + L::RING, half);
  if (half == 1) return;
  const float scale = 1.f / sqrtf((float)dh), ks[2] = {scale, scale}, one[2] = {1.f, 1.f};
  float* base = dqkv + (size_t)b * T * 3 * C + h * D + c0;
  store_acc(dk, ks, base + C, k0 + r0, T, 3 * C);
  store_acc(dv, one, base + 2 * C, k0 + r0, T, 3 * C);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// [batch, T, width] f32 as the 3-D map {width, T, batch}, boxes of 32
// channels x `rows` rows x 1, 128B-swizzled, zero-filled outside.
static int map_rows(CUtensorMap* m, const void* p, int batch, int T, int width, int rows) {
  EncodeTiledFn f;
  if (int st = encode_fn(&f)) return st;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)T, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 4, (cuuint64_t)T * width * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p), dims, strides,
                       box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

static dim3 grid_of(int batch, int T, int heads, int d) {
  return dim3((T + ROWS - 1) / ROWS, batch * heads, d / COLS);
}

template <int D>
static int launch_fwd(const void* qkv, float* out, float* lse, int batch, int T, int heads,
                      int dh, cudaStream_t s) {
  using L = FwdLayout<D>;
  static const cudaError_t ok = allow_smem(attn_fwd_f32_kernel<D>, L::SMEM);
  if (ok != cudaSuccess) return (int)ok;
  CUtensorMap map;
  if (int st = map_rows(&map, qkv, batch, T, 3 * heads * D, L::ST)) return st;
  attn_fwd_f32_kernel<D><<<grid_of(batch, T, heads, D), L::THREADS, L::SMEM, s>>>(map, out, lse,
                                                                                  T, heads, dh);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_bwd(const void* qkv, const float* out, const void* dout, const float* lse,
                      float* Dvec, float* dqkv, int batch, int T, int heads, int dh,
                      cudaStream_t s) {
  using L1 = DqLayout<D>;
  using L2 = DkdvLayout<D>;
  static const cudaError_t ok1 = allow_smem(attn_bwd_dq_f32_kernel<D>, L1::SMEM);
  static const cudaError_t ok2 = allow_smem(attn_bwd_dkdv_f32_kernel<D>, L2::SMEM);
  if (ok1 != cudaSuccess) return (int)ok1;
  if (ok2 != cudaSuccess) return (int)ok2;
  static_assert(L1::ST == L2::ST, "one box shape for both kernels' maps");
  CUtensorMap mq, mg;
  if (int st = map_rows(&mq, qkv, batch, T, 3 * heads * D, L1::ST)) return st;
  if (int st = map_rows(&mg, dout, batch, T, heads * D, L1::ST)) return st;
  const dim3 grid = grid_of(batch, T, heads, D);
  attn_bwd_dq_f32_kernel<D><<<grid, L1::THREADS, L1::SMEM, s>>>(mq, mg, out, lse, Dvec, dqkv, T,
                                                                heads, dh);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  attn_bwd_dkdv_f32_kernel<D><<<grid, L2::THREADS, L2::SMEM, s>>>(mq, mg, lse, Dvec, dqkv, T,
                                                                  heads, dh);
  return (int)cudaGetLastError();
}

static bool shape_ok(int batch, int T, int heads, int d, int dh) {
  return batch > 0 && T > 0 && heads > 0 && (d == 64 || d == 128 || d == 192 || d == 256) &&
         dh >= 1 && dh <= d;
}

}  // namespace attn32
}  // namespace cgd

// qkv [batch, T, 3*heads*d] f32 (q heads | k heads | v heads) -> out [batch,
// T, heads*d] f32 and lse [batch*heads, T] f32 (natural log). d in {64, 128,
// 192, 256}; dh <= d the head dim whose 1/sqrt(dh) scales the logits (d
// itself, or the true head dim of heads zero-padded to d by the wrapper);
// tile, stages and cols are the launch plan's streamed K/V tile,
// ring stages and output columns per block (kernels/attention.py
// f32_attn_plan), checked against this build. Pointers 16-byte aligned.
// Returns the launch status (a cudaError_t, or ENCODE_ERROR + a CUresult).
extern "C" int cgd_attn_fwd_f32(const void* qkv, void* out, void* lse, int batch, int T,
                                int heads, int d, int dh, int tile, int stages, int cols,
                                void* stream) {
  using namespace cgd::attn32;
  if (!shape_ok(batch, T, heads, d, dh) || tile != fwd_tile(d) || stages != fwd_stages(d) ||
      cols != COLS)
    return (int)cudaErrorInvalidValue;
  float *o = static_cast<float*>(out), *l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(qkv, o, l, batch, T, heads, dh, s);
  if (d == 128) return launch_fwd<128>(qkv, o, l, batch, T, heads, dh, s);
  if (d == 192) return launch_fwd<192>(qkv, o, l, batch, T, heads, dh, s);
  return launch_fwd<256>(qkv, o, l, batch, T, heads, dh, s);
}

// The backward of cgd_attn_fwd_f32: qkv, its out and lse, the cotangent dout
// [batch, T, heads*d] f32 -> dqkv [batch, T, 3*heads*d] f32 (d and dh as
// cgd_attn_fwd_f32's). Dvec: [batch*heads,
// T] f32 scratch (rowsum(dout o out), from launch 1 to launch 2). tile,
// stages, cols: the plan's streamed tile and ring stages of both kernels and
// its output columns per block, checked. Two launches. Returns the launch
// status.
extern "C" int cgd_attn_bwd_f32(const void* qkv, const void* out, const void* dout,
                                const void* lse, void* Dvec, void* dqkv, int batch, int T,
                                int heads, int d, int dh, int tile, int stages, int cols,
                                void* stream) {
  using namespace cgd::attn32;
  if (!shape_ok(batch, T, heads, d, dh) || tile != bwd_tile(d) || stages != bwd_stages(d) ||
      cols != COLS)
    return (int)cudaErrorInvalidValue;
  const float *o = static_cast<const float*>(out), *l = static_cast<const float*>(lse);
  float *dv = static_cast<float*>(Dvec), *dq = static_cast<float*>(dqkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_bwd<64>(qkv, o, dout, l, dv, dq, batch, T, heads, dh, s);
  if (d == 128) return launch_bwd<128>(qkv, o, dout, l, dv, dq, batch, T, heads, dh, s);
  if (d == 192) return launch_bwd<192>(qkv, o, dout, l, dv, dq, batch, T, heads, dh, s);
  return launch_bwd<256>(qkv, o, dout, l, dv, dq, batch, T, heads, dh, s);
}

// Dynamic shared memory of one block (kernel 0 = the forward, 1 = the
// backward's dQ kernel, 2 = its dK/dV kernel) at head dim d, what
// f32_attn_plan computes; -1 for another d.
extern "C" int cgd_attn_f32_smem_bytes(int kernel, int d) {
  using namespace cgd::attn32;
#define CGD_SMEM32(D)                                                                \
  if (d == D)                                                                        \
    return kernel == 0 ? FwdLayout<D>::SMEM                                          \
           : kernel == 1 ? DqLayout<D>::SMEM                                         \
                         : DkdvLayout<D>::SMEM;
  CGD_SMEM32(64)
  CGD_SMEM32(128)
  CGD_SMEM32(192)
  CGD_SMEM32(256)
#undef CGD_SMEM32
  return -1;
}
