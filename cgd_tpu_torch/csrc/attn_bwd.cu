// K-attn-b: multi-head self-attention backward on Hopper (sm_90a), head dims
// 64, 128, 192 and 256.
//
// Replaces the Pallas TPU kernel cgd_tpu/kernels/attention_pallas.py
// (_run_bwd -> _bwd_kernel): given dO, with P = softmax(S), S = q.k^T/sqrt(d),
//   dV = P^T.dO,  dP = dO.V^T,  dS = P o (dP - D),  D = rowsum(dO o O),
//   dQ = dS.K/sqrt(d),  dK = dS^T.Q/sqrt(d).
// The TPU kernel recomputes one head's whole P in VMEM; here P is recomputed
// tile by tile from Q, K and the forward's per-row log-sum-exp, in two
// launches with no float atomics, so reruns are bit-identical (the guided
// step's gradient feeds a sampler whose resume is promised bit-exact):
//   1. attn_bwd_dq: one block per (64-row q tile, batch*head). It loads its
//      rows of Q, dO and O, computes D for them (f32, from the bf16 O the
//      forward wrote) and writes it for launch 2, then loops over the K/V
//      tiles: S = Q.K^T and dP = dO.V^T (wgmma, A = Q / dO from shared memory,
//      B = K / V K-major), P = exp2(S*log2(e)/sqrt(d) - lse*log2(e)) and
//      dS = P o (dP - D) in registers, dQ += dS.K (A = dS repacked from the
//      accumulator, B = K MN-major);
//   2. attn_bwd_dkdv: one block per (64-row kv tile, batch*head), looping
//      over the q tiles: S^T = K.Q^T and dP^T = V.dO^T (A = K / V from shared
//      memory, B = Q / dO K-major), P^T and dS^T in registers, dV += P^T.dO
//      and dK += dS^T.Q (A from the accumulators, B = dO / Q MN-major: the
//      same swizzled tiles read the other way).
// At d = 64 / 128 both kernels split their loop between the two consumer
// warpgroups and combine in a fixed order (attn_common.cuh). At d = 192 /
// 256 the consumers split D instead, since whole-D accumulators beside S and
// dP spilled: in the dQ kernel consumer 0 owns columns [0, 128) of dQ and
// consumer 1 the rest; in the dK/dV kernel, where dK and dV together are two
// accumulators, each consumer takes one 64-column share of both in each of
// two passes over the q tiles (shares 0 and 2 to consumer 0, 1 and 3 to
// consumer 1), storing it straight from registers at the pass's end. A
// 128-column share of dK and dV (128 f32 a thread) beside S^T and dP^T
// still spilled and serialized the wgmmas once S^T's reduction ran over
// 192 or 256 channels, in every arrangement tried (split chains, 32-column
// S^T halves, 64-column accumulator blocks, one code path for both
// consumers). Both consumers compute S (S^T) and dP (dP^T) over the full
// depth for every tile of every pass: the products two to four times over,
// which these latency-bound shapes afford. Every accumulator stays in
// registers; P and dS round to bf16 as operands, D, the softmax recompute
// and dS are f32. The A operands that lie in shared memory anyway (Q, dO,
// K, V) are read there by descriptor (wgmma's SS form), as register
// fragments would not fit beside the accumulators.
//
// Rows past T: their lse reads +inf, so their P is exactly 0; columns past T
// in the dQ kernel are masked to P = 0 (the TMA zero-fills K there).
//
// Bound: 10*T^2*d FLOP per head (S recomputed twice, dP twice, dV, dK, dQ),
// tensor cores on paper; at the UNet's shapes, latency, as the forward.
#include "attn_common.cuh"

namespace cgd {
namespace attn {

struct BwdMaps {
  CUtensorMap qkv, out, dout;
};

// ---------------------------------------------------------------------------
// 1. dQ (and D)
// ---------------------------------------------------------------------------

template <int D>
__device__ __forceinline__ void dq_producer(const BwdMaps& m, Bars& bar, unsigned char* smem, int b,
                                            int h, int q0, int C, int ntiles) {
  using L = DqLayout<D>;
  constexpr int STAGES = L::STAGES;
  mbar_expect_tx(&bar.tile_full, 3 * Tile<D>::BYTES);
  for (int x = 0; x < Tile<D>::BOXES; ++x) {
    const int ch = h * D + x * BOX;
    tma_load_3d(smem + x * BOX_BYTES, &m.qkv, &bar.tile_full, ch, q0, b);
    tma_load_3d(smem + L::OFF_DO + x * BOX_BYTES, &m.dout, &bar.tile_full, ch, q0, b);
    tma_load_3d(smem + L::OFF_O + x * BOX_BYTES, &m.out, &bar.tile_full, ch, q0, b);
  }
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(&bar.empty[s], ((i / STAGES) + 1) & 1);
    mbar_expect_tx(&bar.full[s], L::STAGE);
    unsigned char* st = smem + L::OFF_STAGES + s * L::STAGE;
    for (int x = 0; x < Tile<D>::BOXES; ++x) {
      tma_load_3d(st + x * BOX_BYTES, &m.qkv, &bar.full[s], C + h * D + x * BOX, i * ROWS, b);
      tma_load_3d(st + Tile<D>::BYTES + x * BOX_BYTES, &m.qkv, &bar.full[s],
                  2 * C + h * D + x * BOX, i * ROWS, b);
    }
  }
}

// Columns [C0, C0 + W) of the block's dQ: all of them (W = D) where the
// consumers split the K/V tiles and merge; this consumer's share where they
// split D.
template <int D, int W, int C0>
__device__ __forceinline__ void dq_consumer(Bars& bar, unsigned char* smem,
                                            const float* __restrict__ lse,
                                            float* __restrict__ Dvec, bf16* __restrict__ dqkv,
                                            int T, int split, float sl2, float scale, int n, int b,
                                            int h, int q0, int C, int ntiles) {
  using L = DqLayout<D>;
  constexpr int STAGES = L::STAGES, BOX0 = C0 / BOX * BOX_BYTES;
  static_assert(L::COLS == (W < D) && C0 % BOX == 0 && W % BOX == 0, "column share");
  const int wg = threadIdx.x / 128 - 1;
  const int first = L::COLS ? 0 : wg, step = L::COLS ? 1 : split;
  float* vec = reinterpret_cast<float*>(smem + L::OFF_VEC);  // [0, 64): lse*log2(e); [64, 128): D
  mbar_wait(&bar.tile_full, 0);
  {  // D = rowsum(dO o O) for the block's rows, four threads a row
    const int ct = threadIdx.x - (NTHREADS - NCONSUMERS), row = ct >> 2, part = ct & 3;
    float acc = 0.f;
#pragma unroll
    for (int c = part * (D / 32); c < (part + 1) * (D / 32); ++c) {
      float o[8], g[8];
      unpack8(*reinterpret_cast<const uint4*>(smem + L::OFF_O + chunk_off(row, c)), o);
      unpack8(*reinterpret_cast<const uint4*>(smem + L::OFF_DO + chunk_off(row, c)), g);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += o[e] * g[e];
    }
    acc = quad_sum(acc);
    if (part == 0) {
      const int t = q0 + row;
      vec[row] = t < T ? lse[(size_t)n * T + t] * LOG2E : INFINITY;  // P = 0 on rows past T
      vec[ROWS + row] = acc;
      if (t < T) Dvec[(size_t)n * T + t] = acc;
    }
  }
  named_barrier(1, NCONSUMERS);
  float dq[W / 2];
#pragma unroll
  for (int r = 0; r < W / 2; ++r) dq[r] = 0.f;
  if (L::COLS || wg < split) {
    float l2[2], dd[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l2[e] = vec[acc_row(2 * e)];
      dd[e] = vec[ROWS + acc_row(2 * e)];
    }
    for (int i = first; i < ntiles; i += step) {
      const int s = i % STAGES, kv0 = i * ROWS;
      const unsigned char* kt = smem + L::OFF_STAGES + s * L::STAGE;
      const unsigned char* vt = kt + Tile<D>::BYTES;
      mbar_wait(&bar.full[s], (i / STAGES) & 1);
      float sc[ROWS / 2], dp[ROWS / 2];
      wgmma_fence();
      gemm_k<D>(sc, smem, kt);
      gemm_k<D>(dp, smem + L::OFF_DO, vt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool ragged = kv0 + ROWS > T;
#pragma unroll
      for (int r = 0; r < ROWS / 2; ++r) {
        const int e = (r >> 1) & 1;
        const float p = ragged && kv0 + acc_col(r) >= T ? 0.f : exp2f(sc[r] * sl2 - l2[e]);
        sc[r] = p * (dp[r] - dd[e]);
      }
      uint32_t dsf[ROWS / 16][4];
      acc_to_a<ROWS>(sc, dsf);
      fence_regs(dq);
      fence_frags(dsf);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < ROWS / 16; ++j) wgmma_rs<W, 1>(dq, dsf[j], desc_mn(kt + BOX0, j), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (threadIdx.x % 128 == 0) mbar_arrive(&bar.empty[s]);
    }
  }
  if constexpr (L::COLS) {
    named_barrier(1, NCONSUMERS);  // both consumers' reads of Q are done
  } else if (split > 1) {
    float* cmb = reinterpret_cast<float*>(smem + L::OFF_STAGES);
    named_barrier(1, NCONSUMERS);
    if (wg == 1) put_partial(cmb, dq);
    named_barrier(1, NCONSUMERS);
    if (wg == 0) add_partial(cmb, dq);
  }
  if (L::COLS || wg == 0) {  // staged in the share's boxes of the Q tile
    const float mul[2] = {scale, scale};
    store_rows<W>(dq, mul, smem + BOX0, dqkv + (size_t)b * T * 3 * C + h * D + C0, q0, T, 3 * C,
                  2 + wg);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bwd_dq(const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
            float* __restrict__ Dvec, bf16* __restrict__ dqkv, int T, int heads, int split,
            float sl2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ Bars bar;
  unsigned char* smem = align_smem(smem_raw);
  const int n = blockIdx.y, b = n / heads, h = n - b * heads, q0 = blockIdx.x * ROWS;
  const int C = heads * D, ntiles = (T + ROWS - 1) / ROWS;
  using L = DqLayout<D>;
  if (threadIdx.x == 0) {
    mbar_init(&bar.tile_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], L::COLS ? 2 : 1);  // each consumer that reads the stage
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < NTHREADS - NCONSUMERS) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) dq_producer<D>(maps, bar, smem, b, h, q0, C, ntiles);
  } else {
    setmaxnreg_inc<240>();
    by_share<D, L::COLS>([&](auto w, auto c0) {
      dq_consumer<D, decltype(w)::value, decltype(c0)::value>(bar, smem, lse, Dvec, dqkv, T, split,
                                                              sl2, scale, n, b, h, q0, C, ntiles);
    });
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV
// ---------------------------------------------------------------------------

// Thread 0 loads the block's K and V, then the (Q, dO) ring; warp 1 writes
// each stage's row vectors (lse*log2(e), +inf past T; D, 0 past T).
template <int D>
__device__ __forceinline__ void dkdv_producer(const BwdMaps& m, Bars& bar, unsigned char* smem,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ Dvec, int T, int n, int b,
                                              int h, int kv0, int C, int ntiles) {
  using L = DkdvLayout<D>;
  constexpr int STAGES = L::STAGES;
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar.tile_full, 2 * Tile<D>::BYTES);
    for (int x = 0; x < Tile<D>::BOXES; ++x) {
      tma_load_3d(smem + x * BOX_BYTES, &m.qkv, &bar.tile_full, C + h * D + x * BOX, kv0, b);
      tma_load_3d(smem + Tile<D>::BYTES + x * BOX_BYTES, &m.qkv, &bar.tile_full,
                  2 * C + h * D + x * BOX, kv0, b);
    }
  }
  const bool vectors = threadIdx.x / 32 == 1;
  if (threadIdx.x != 0 && !vectors) return;
  for (int it = 0; it < L::PASSES * ntiles; ++it) {  // q tile i of each pass
    const int s = it % STAGES, i = it % ntiles;
    if (it >= STAGES) mbar_wait(&bar.empty[s], ((it / STAGES) + 1) & 1);
    unsigned char* st = smem + L::OFF_STAGES + s * L::STAGE;
    if (vectors) {
      float* vec = reinterpret_cast<float*>(st + L::OFF_VEC);
      for (int j = threadIdx.x & 31; j < ROWS; j += 32) {
        const int t = i * ROWS + j;
        vec[j] = t < T ? lse[(size_t)n * T + t] * LOG2E : INFINITY;
        vec[ROWS + j] = t < T ? Dvec[(size_t)n * T + t] : 0.f;
      }
      mbar_arrive(&bar.full[s]);
    } else {
      mbar_expect_tx(&bar.full[s], 2 * Tile<D>::BYTES);
      for (int x = 0; x < Tile<D>::BOXES; ++x) {
        const int ch = h * D + x * BOX;
        tma_load_3d(st + x * BOX_BYTES, &m.qkv, &bar.full[s], ch, i * ROWS, b);
        tma_load_3d(st + Tile<D>::BYTES + x * BOX_BYTES, &m.dout, &bar.full[s], ch, i * ROWS, b);
      }
    }
  }
}

// The block's dK and dV. At d = 64 / 128: all D columns in one pass over
// the q tiles, which the consumers split (tile i to consumer i % split) and
// merge. At d = 192 / 256: 64-column shares in two passes over every q tile
// (the producer streams them twice), share 2p + c in pass p to consumer c
// (none for consumer 1's second pass at d = 192, which only releases the
// stages), each stored by its consumer straight from registers; S^T and
// dP^T are computed over the full depth in every pass.
template <int D>
__device__ __forceinline__ void dkdv_consumer(Bars& bar, unsigned char* smem,
                                              bf16* __restrict__ dqkv, int T, int split,
                                              float sl2, float scale, int b, int h, int kv0, int C,
                                              int ntiles) {
  using L = DkdvLayout<D>;
  constexpr int STAGES = L::STAGES, W = L::COLS ? BOX : D;  // columns of a pass
  const int wg = threadIdx.x / 128 - 1;
  const int first = L::COLS ? 0 : wg, step = L::COLS ? 1 : split;
  if (!L::COLS && wg >= split) return;
  bf16* rows = dqkv + (size_t)b * T * 3 * C + h * D;
  float dk[W / 2], dv[W / 2];
  mbar_wait(&bar.tile_full, 0);
#pragma unroll 1
  for (int pass = 0; pass < L::PASSES; ++pass) {
    const int col = L::COLS ? (2 * pass + wg) * BOX : 0;  // the pass's first column
    const bool mine = col < D;
#pragma unroll
    for (int r = 0; r < W / 2; ++r) dk[r] = dv[r] = 0.f;
    for (int i = first; i < ntiles; i += step) {
      const int it = pass * ntiles + i, s = it % STAGES;
      const unsigned char* qt = smem + L::OFF_STAGES + s * L::STAGE;
      const unsigned char* gt = qt + Tile<D>::BYTES;
      const float* vec = reinterpret_cast<const float*>(qt + L::OFF_VEC);
      mbar_wait(&bar.full[s], (it / STAGES) & 1);
      if (mine) {
        float sc[ROWS / 2], dp[ROWS / 2];
        wgmma_fence();
        gemm_k<D>(sc, smem, qt);
        gemm_k<D>(dp, smem + Tile<D>::BYTES, gt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // P^T and dS^T: rows are kv, columns q (their lse and D from the stage)
#pragma unroll
        for (int r = 0; r < ROWS / 2; ++r) {
          const int c = acc_col(r);
          const float p = exp2f(sc[r] * sl2 - vec[c]);
          sc[r] = p;
          dp[r] = p * (dp[r] - vec[ROWS + c]);
        }
        uint32_t pf[ROWS / 16][4], dsf[ROWS / 16][4];
        acc_to_a<ROWS>(sc, pf);
        acc_to_a<ROWS>(dp, dsf);
        fence_regs(dv);
        fence_regs(dk);
        fence_frags(pf);
        fence_frags(dsf);
        const int box = col / BOX * BOX_BYTES;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < ROWS / 16; ++j) wgmma_rs<W, 1>(dv, pf[j], desc_mn(gt + box, j), 1);
#pragma unroll
        for (int j = 0; j < ROWS / 16; ++j) wgmma_rs<W, 1>(dk, dsf[j], desc_mn(qt + box, j), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      if (threadIdx.x % 128 == 0) mbar_arrive(&bar.empty[s]);
    }
    if (L::COLS && mine) {
      store_regs<W>(dk, scale, rows + C + col, kv0, T, 3 * C);
      store_regs<W>(dv, 1.f, rows + 2 * C + col, kv0, T, 3 * C);
    }
  }
  if constexpr (!L::COLS) {
    if (split > 1) {
      float* cmb = reinterpret_cast<float*>(smem + L::OFF_STAGES);
      named_barrier(1, NCONSUMERS);
      if (wg == 1) {
        put_partial(cmb, dk);
        put_partial(cmb + (D / 2) * 128, dv);
      }
      named_barrier(1, NCONSUMERS);
      if (wg == 1) return;
      add_partial(cmb, dk);
      add_partial(cmb + (D / 2) * 128, dv);
    }
    // staged in the K and V tiles: every consumer's products over them are done
    const float mk[2] = {scale, scale}, mv[2] = {1.f, 1.f};
    store_rows<D>(dk, mk, smem, rows + C, kv0, T, 3 * C, 2);
    store_rows<D>(dv, mv, smem + Tile<D>::BYTES, rows + 2 * C, kv0, T, 3 * C, 2);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bwd_dkdv(const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
              const float* __restrict__ Dvec, bf16* __restrict__ dqkv, int T, int heads,
              int split, float sl2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ Bars bar;
  unsigned char* smem = align_smem(smem_raw);
  const int n = blockIdx.y, b = n / heads, h = n - b * heads, kv0 = blockIdx.x * ROWS;
  const int C = heads * D, ntiles = (T + ROWS - 1) / ROWS;
  using L = DkdvLayout<D>;
  if (threadIdx.x == 0) {
    mbar_init(&bar.tile_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&bar.full[s], 1 + 32);  // thread 0's TMA, warp 1's vectors
      mbar_init(&bar.empty[s], L::COLS ? 2 : 1);  // each consumer that reads the stage
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < NTHREADS - NCONSUMERS) {
    setmaxnreg_dec<24>();
    dkdv_producer<D>(maps, bar, smem, lse, Dvec, T, n, b, h, kv0, C, ntiles);
  } else {
    setmaxnreg_inc<240>();
    dkdv_consumer<D>(bar, smem, dqkv, T, split, sl2, scale, b, h, kv0, C, ntiles);
  }
}

template <int D>
static int launch_bwd(const BwdMaps& maps, const void* lse, void* Dvec, void* dqkv, int batch,
                      int T, int heads, int split, cudaStream_t s) {
  constexpr int b1 = DqLayout<D>::SMEM, b2 = DkdvLayout<D>::SMEM;
  static_assert(b1 + sizeof(Bars) <= SMEM_MAX && b2 + sizeof(Bars) <= SMEM_MAX, "shared memory");
  static const cudaError_t ok1 = allow_smem(attn_bwd_dq<D>, b1);
  static const cudaError_t ok2 = allow_smem(attn_bwd_dkdv<D>, b2);
  if (ok1 != cudaSuccess) return (int)ok1;
  if (ok2 != cudaSuccess) return (int)ok2;
  const float scale = 1.f / sqrtf((float)D), sl2 = scale * LOG2E;
  const dim3 grid((T + ROWS - 1) / ROWS, batch * heads);
  const float* l = static_cast<const float*>(lse);
  bf16* g = static_cast<bf16*>(dqkv);
  attn_bwd_dq<D><<<grid, NTHREADS, b1, s>>>(maps, l, static_cast<float*>(Dvec), g, T, heads, split,
                                            sl2, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv<D><<<grid, NTHREADS, b2, s>>>(maps, l, static_cast<const float*>(Dvec), g, T,
                                              heads, split, sl2, scale);
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace cgd

// qkv [batch, T, 3*heads*d] bf16 and the forward's out [batch, T, heads*d]
// bf16 and lse [batch*heads, T] f32; dout [batch, T, heads*d] bf16, the
// cotangent of out; Dvec [batch*heads, T] f32 scratch (D, written by launch
// 1, read by launch 2) -> dqkv [batch, T, 3*heads*d] bf16 (dq | dk | dv in
// qkv's layout). d in {64, 128, 192, 256}; tile and split as cgd_attn_fwd's,
// stages bwd_stages(d).
// Pointers 16-byte aligned. Two launches on `stream`; returns the status.
extern "C" int cgd_attn_bwd(const void* qkv, const void* out, const void* dout, const void* lse,
                            void* Dvec, void* dqkv, int batch, int T, int heads, int d, int tile,
                            int stages, int split, void* stream) {
  using namespace cgd::attn;
  if (!plan_ok(batch, T, heads, d, tile, stages, bwd_stages(d), split))
    return (int)cudaErrorInvalidValue;
  BwdMaps maps;
  const int c = heads * d;
  if (int st = map_rows(&maps.qkv, qkv, batch, T, 3 * c)) return st;
  if (int st = map_rows(&maps.out, out, batch, T, c)) return st;
  if (int st = map_rows(&maps.dout, dout, batch, T, c)) return st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_bwd<64>(maps, lse, Dvec, dqkv, batch, T, heads, split, s);
  if (d == 128) return launch_bwd<128>(maps, lse, Dvec, dqkv, batch, T, heads, split, s);
  if (d == 192) return launch_bwd<192>(maps, lse, Dvec, dqkv, batch, T, heads, split, s);
  return launch_bwd<256>(maps, lse, Dvec, dqkv, batch, T, heads, split, s);
}

// Dynamic shared memory of one block of the Hopper bodies (kernel 0 = the
// forward, 1 = the backward's dQ kernel, 2 = its dK/dV kernel) at head dim
// d, what attn_plan computes; -1 for another d.
extern "C" int cgd_attn_smem_bytes(int kernel, int d) {
  using namespace cgd::attn;
#define CGD_SMEM(D)                                                            \
  if (d == D)                                                                  \
    return kernel == 0 ? FwdLayout<D>::SMEM : kernel == 1 ? DqLayout<D>::SMEM \
                                                          : DkdvLayout<D>::SMEM;
  CGD_SMEM(64)
  CGD_SMEM(128)
  CGD_SMEM(192)
  CGD_SMEM(256)
#undef CGD_SMEM
  return -1;
}
