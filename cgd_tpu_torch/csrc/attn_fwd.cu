// K-attn-f: multi-head self-attention forward on Hopper (sm_90a), head dims
// 64, 128, 192 and 256.
//
// Replaces the Pallas TPU kernel cgd_tpu/kernels/attention_pallas.py
// (_run_fwd -> _fwd_kernel): out = softmax(q.k^T / sqrt(d)) . v per
// (batch, head), softmax in f32 (the ADM q, k * d^-1/4 double scaling is the
// same 1/sqrt(d), applied here in f32 to the f32 logits).
//
// The TPU kernel holds one (batch, head)'s whole T x T logits in VMEM; a
// block's shared memory cannot, so this is a flash-attention forward that
// writes the per-row log-sum-exp for the backward. One block per (64-row q
// tile, batch*head), laid out and split as attn_common.cuh says:
// - the producer loads the block's Q once and streams 64-row K/V tiles into
//   a ring of four stages (two at d = 256: a (K, V) stage is 64 KB there);
// - each consumer keeps Q as register A fragments (ldmatrix, once; from d =
//   128 up it reads Q's tile by descriptor instead) and, for each K/V tile of
//   its share (every tile at d = 192 / 256, where it owns a column share of
//   O instead: [0, 128) for consumer 0, the rest for consumer 1):
//     S = Q.K^T: wgmma m64n64, K read K-major from the ring, into registers;
//     columns at or past T set to -inf (the TMA zero-fills K's rows there,
//     which would give S = 0), scaled by log2(e)/sqrt(d); the online softmax
//     per row: max and sum over the quad of lanes that holds the row, exp2,
//     the running (m, l) and the rescale of O by exp2(m_old - m_new), all in
//     registers;
//     O += P.V: P repacked from the S accumulator into bf16 A fragments
//     (acc_to_a, no shared memory), V's columns of the consumer's share
//     read MN-major from the ring, one m64nW wgmma per k16 step (W = D up to
//     128, the share's 128 or 64 above; O is W/2 f32 a thread);
// - at d = 64 / 128, consumer 1's (m, l, O) merges into consumer 0's, which
//   writes O/l as bf16 with 16-byte stores and the lse per row; at 192 /
//   256, each consumer writes its columns of O/l (both hold the same m, l),
//   and consumer 0 the lse.
// P rounds to bf16 for its product: the Pallas kernel keeps P in f32, and
// this is the one rounding the port adds.
//
// Bound: 4*T^2*d FLOP per head against 4*T*d*2 bytes moved, so the tensor
// cores bound it on paper (at T = 1024, d = 64: 2.2 us for 8 heads); at the
// UNet's small shapes (4-16 heads, T <= 1024: 4-128 blocks; the 128px
// model's d = 256 level is 4 blocks of one tile) it is latency: the ring
// keeps one or two tiles in flight for each consumer, and the two
// consumers' softmax and products interleave on the SM.
#include "attn_common.cuh"

namespace cgd {
namespace attn {

template <int D>
__device__ __forceinline__ void fwd_producer(const CUtensorMap& qkv, Bars& bar, unsigned char* smem,
                                             int b, int h, int q0, int C, int ntiles) {
  using L = FwdLayout<D>;
  constexpr int STAGES = L::STAGES;
  mbar_expect_tx(&bar.tile_full, Tile<D>::BYTES);
  for (int x = 0; x < Tile<D>::BOXES; ++x)
    tma_load_3d(smem + x * BOX_BYTES, &qkv, &bar.tile_full, h * D + x * BOX, q0, b);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(&bar.empty[s], ((i / STAGES) + 1) & 1);
    mbar_expect_tx(&bar.full[s], L::STAGE);
    unsigned char* st = smem + L::OFF_STAGES + s * L::STAGE;
    for (int x = 0; x < Tile<D>::BOXES; ++x) {
      tma_load_3d(st + x * BOX_BYTES, &qkv, &bar.full[s], C + h * D + x * BOX, i * ROWS, b);
      tma_load_3d(st + Tile<D>::BYTES + x * BOX_BYTES, &qkv, &bar.full[s], 2 * C + h * D + x * BOX,
                  i * ROWS, b);
    }
  }
}

// Columns [C0, C0 + W) of the block's O: all of them (W = D) where the
// consumers split the K/V tiles and merge; this consumer's share where they
// split D (both then see every tile and compute the same S, softmax and row
// statistics; consumer 0 writes the lse).
template <int D, int W, int C0>
__device__ __forceinline__ void fwd_consumer(Bars& bar, unsigned char* smem, bf16* __restrict__ out,
                                             float* __restrict__ lse, int T, int split, float sl2,
                                             int n, int b, int h, int q0, int C, int ntiles) {
  using L = FwdLayout<D>;
  constexpr int STAGES = L::STAGES, BOX0 = C0 / BOX * BOX_BYTES;
  static_assert(L::COLS == (W < D) && C0 % BOX == 0 && W % BOX == 0, "column share");
  const int wg = threadIdx.x / 128 - 1;
  const int first = L::COLS ? 0 : wg, step = L::COLS ? 1 : split;
  float o[W / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in log2 units
#pragma unroll
  for (int r = 0; r < W / 2; ++r) o[r] = 0.f;
  if (L::COLS || wg < split) {
    mbar_wait(&bar.tile_full, 0);
    // Q as register A fragments at d = 64; from d = 128 up they would take
    // d/4 more registers beside O's (ptxas then spills and serializes the
    // wgmmas), so the product reads Q from its tile by descriptor
    constexpr bool Q_REGS = D == 64;
    uint32_t qf[Q_REGS ? D / 16 : 1][4];
    if constexpr (Q_REGS) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], smem, kk);
    }
    for (int i = first; i < ntiles; i += step) {
      const int s = i % STAGES, kv0 = i * ROWS;
      const unsigned char* kt = smem + L::OFF_STAGES + s * L::STAGE;
      const unsigned char* vt = kt + Tile<D>::BYTES;
      mbar_wait(&bar.full[s], (i / STAGES) & 1);
      float sc[ROWS / 2];
      wgmma_fence();
      if constexpr (Q_REGS) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_rs<ROWS, 0>(sc, qf[kk], desc_k(kt, kk), kk > 0);
      } else {
        gemm_k<D>(sc, smem, kt);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const bool ragged = kv0 + ROWS > T;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < ROWS / 2; ++r) {
        sc[r] = ragged && kv0 + acc_col(r) >= T ? -INFINITY : sc[r] * sl2;
        mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[r]);
      }
      float alpha[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float mn = fmaxf(m[e], quad_max(mx[e]));  // finite: every tile has a column < T
        alpha[e] = exp2f(m[e] - mn);
        m[e] = mn;
        l[e] *= alpha[e];
      }
#pragma unroll
      for (int r = 0; r < ROWS / 2; ++r) {
        sc[r] = exp2f(sc[r] - m[(r >> 1) & 1]);
        l[(r >> 1) & 1] += sc[r];
      }
#pragma unroll
      for (int r = 0; r < W / 2; ++r) o[r] *= alpha[(r >> 1) & 1];
      uint32_t pf[ROWS / 16][4];
      acc_to_a<ROWS>(sc, pf);
      fence_regs(o);
      fence_frags(pf);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < ROWS / 16; ++j) wgmma_rs<W, 1>(o, pf[j], desc_mn(vt + BOX0, j), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (threadIdx.x % 128 == 0) mbar_arrive(&bar.empty[s]);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = quad_sum(l[e]);  // a thread summed its own columns

  if constexpr (L::COLS) {
    named_barrier(1, NCONSUMERS);  // both consumers' reads of Q are done
  } else if (split > 1) {  // consumer 1's (O, m, l) into consumer 0's; the ring is free by then
    float* cmb = reinterpret_cast<float*>(smem + L::OFF_STAGES);
    named_barrier(1, NCONSUMERS);
    if (wg == 1) {
      put_partial(cmb, o);
      put_partial(cmb + (W / 2) * 128, m);
      put_partial(cmb + (W / 2 + 2) * 128, l);
    }
    named_barrier(1, NCONSUMERS);
    if (wg == 0) {
      const int t = threadIdx.x & 127;
      float a0[2], a1[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float m1 = cmb[(W / 2 + e) * 128 + t], l1 = cmb[(W / 2 + 2 + e) * 128 + t];
        const float mn = fmaxf(m[e], m1);
        a0[e] = exp2f(m[e] - mn);
        a1[e] = exp2f(m1 - mn);
        l[e] = l[e] * a0[e] + l1 * a1[e];
        m[e] = mn;
      }
#pragma unroll
      for (int r = 0; r < W / 2; ++r)
        o[r] = o[r] * a0[(r >> 1) & 1] + cmb[r * 128 + t] * a1[(r >> 1) & 1];
    }
  }
  if (L::COLS || wg == 0) {
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    // staged in the share's boxes of the Q tile: every consumer's reads of
    // it are done
    store_rows<W>(o, inv, smem + BOX0, out + (size_t)b * T * C + h * D + C0, q0, T, C, 2 + wg);
    if (wg == 0 && (threadIdx.x & 3) == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = q0 + acc_row(2 * e);
        if (t < T) lse[(size_t)n * T + t] = (m[e] + log2f(l[e])) * LN2;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap qkv, bf16* __restrict__ out,
                float* __restrict__ lse, int T, int heads, int split, float sl2) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ Bars bar;
  unsigned char* smem = align_smem(smem_raw);
  const int n = blockIdx.y, b = n / heads, h = n - b * heads, q0 = blockIdx.x * ROWS;
  const int C = heads * D, ntiles = (T + ROWS - 1) / ROWS;
  using L = FwdLayout<D>;
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
    if (threadIdx.x == 0) fwd_producer<D>(qkv, bar, smem, b, h, q0, C, ntiles);
  } else {
    setmaxnreg_inc<240>();
    by_share<D, L::COLS>([&](auto w, auto c0) {
      fwd_consumer<D, decltype(w)::value, decltype(c0)::value>(bar, smem, out, lse, T, split, sl2,
                                                               n, b, h, q0, C, ntiles);
    });
  }
}

template <int D>
static int launch_fwd(const CUtensorMap& map, void* out, void* lse, int batch, int T, int heads,
                      int dh, int split, cudaStream_t s) {
  constexpr int smem = FwdLayout<D>::SMEM;
  static_assert(smem + sizeof(Bars) <= SMEM_MAX, "shared memory");
  static const cudaError_t ok = allow_smem(attn_fwd_kernel<D>, smem);
  if (ok != cudaSuccess) return (int)ok;
  const dim3 grid((T + ROWS - 1) / ROWS, batch * heads);
  attn_fwd_kernel<D><<<grid, NTHREADS, smem, s>>>(map, static_cast<bf16*>(out),
                                                  static_cast<float*>(lse), T, heads, split,
                                                  LOG2E / sqrtf((float)dh));
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace cgd

// qkv [batch, T, 3*heads*d] bf16 (q heads | k heads | v heads) -> out [batch,
// T, heads*d] bf16 and lse [batch*heads, T] f32 (natural log). d in {64,
// 128, 192, 256}; dh <= d the head dim whose 1/sqrt(dh) scales the logits (d
// itself, or the true head dim of heads zero-padded to d by the wrapper);
// tile, stages and split are the launch plan
// (kernels/attention.py attn_plan: 64, fwd_stages(d), and 2 where T > 64,
// else 1), checked against this build.
// Pointers 16-byte aligned. Returns the launch status (cudaError_t, or
// cgd::ENCODE_ERROR + the CUresult of a failed tensor-map encode).
extern "C" int cgd_attn_fwd(const void* qkv, void* out, void* lse, int batch, int T, int heads,
                            int d, int dh, int tile, int stages, int split, void* stream) {
  using namespace cgd::attn;
  if (!plan_ok(batch, T, heads, d, tile, stages, fwd_stages(d), split) || dh < 1 || dh > d)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (int st = map_rows(&map, qkv, batch, T, 3 * heads * d)) return st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(map, out, lse, batch, T, heads, dh, split, s);
  if (d == 128) return launch_fwd<128>(map, out, lse, batch, T, heads, dh, split, s);
  if (d == 192) return launch_fwd<192>(map, out, lse, batch, T, heads, dh, split, s);
  return launch_fwd<256>(map, out, lse, batch, T, heads, dh, split, s);
}
