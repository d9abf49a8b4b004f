// Shared implicit-GEMM main loop for the 3x3, stride-1, pad-1 NHWC convs on
// Hopper: TMA loads completed on mbarriers, a producer warpgroup, and wgmma
// on two consumer warpgroups.
//
// GEMM view: M = output pixels, N = output channels, K = 9*Cin, ordered
// tap-major like an HWIO weight flattened to [9*Cin, Cout]. A block owns an
// 8 x 16 output patch (BM = 128 pixels) of one image and BN output channels
// (blockIdx.x = patch, row-major over the image; blockIdx.y = N tile;
// blockIdx.z = split * batch + image).
//
// Bound on the H100: for Cin >= 128 these convs are compute-bound (about
// 2*9*Cin FLOP per output element against a few bytes), so the loop is
// built to keep wgmma fed:
//
// - K is walked chunk by chunk: BK = 64 input channels (128 bytes, one
//   128B-swizzle row) for all nine taps. Per chunk the input patch with its
//   pad-1 halo (10 x 18 pixels) is staged ONCE in shared memory, by the TMA,
//   one image row per load into rows of 24 pixel slots (3 KB, so every row
//   starts 1 KB aligned and keeps the swizzle's phase). The pad comes from
//   the TMA, which zero-fills coordinates outside the tensor; K-halo's rows
//   -1 and H come from etop / ebot, row by row, so no two loads write the
//   same bytes.
// - With the prologue (act = bf16(silu(x*A + B))) the consumers activate
//   the staged patch in place, each element ONCE per chunk: taps outside the
//   image stay zero (silu(0*A + B) != 0), K-halo's rows from the neighbours
//   pass through as they are. With up (nearest-2x between the activation
//   and the taps) the staged patch is the 6 x 10 source patch: each source
//   element is activated once and read by the taps of its 2 x 2 outputs.
//   The activation of chunk c+1 runs while chunk c's wgmmas run: each
//   consumer warpgroup activates its half of the patch after its own taps
//   (3-5 and 6-8), so the other one keeps the tensor cores fed.
// - A goes to wgmma from registers: per tap, each warp (one patch row of 16
//   pixels) loads its fragment with ldmatrix, one row address per lane, so
//   the tap's shift (and up's halving) is only an address, and one staged
//   patch serves all nine taps. (Three kx-shifted copies read by a
//   shared-memory descriptor were the first design; they take 120 KB for
//   two stages, which left room for only two 32 KB B stages at BN = 256
//   with the prologue's raw patch beside them, too few to hide the weight
//   loads.)
// - B (the weight rows of one tap and chunk, BK x BN, output channels
//   contiguous) comes by TMA into its own ring of B_STAGES stages and is
//   read by descriptor as an MN-major operand (trans-b), with no copy of
//   the weight.
// - 384 threads: warpgroup 0 is the producer (one thread issues every TMA
//   load; setmaxnreg.dec), warpgroups 1 and 2 are consumers (64 pixels x BN
//   each, f32 accumulators in registers; setmaxnreg.inc).
//
// - The epilogues stage the f32 tile in shared memory (the main loop's
//   buffers, free by then) and read and write global memory 16 bytes a
//   thread, a pixel's channels on consecutive threads.
//
// Shared memory per block: three A stages of 10 x 3 KB = 90 KB (up: 6 x 2 KB
// = 36 KB) and the B ring (BN = 256: 32 KB a stage, 4 stages, 5 with up;
// BN = 128: 16 KB x 6; BN = 16: 2 KB x 6): at most 219 KB of the 227 KB a
// block may take, one block per SM.
//
// Known limit: at BN = 256 a consumer thread holds 128 f32 accumulators, and
// ptxas reports that it serializes the wgmmas for want of registers (C7512);
// BN = 128 and 16 keep them in flight.
//
// Small images (the 16x16 and 8x8 levels) give too few blocks to fill 132
// SMs, so the launchers split the chunks across blocks: each split writes
// its f32 partial tile to a workspace, and a second pass sums the splits in
// a fixed order before the epilogue, which keeps the result deterministic.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace cgd {

constexpr int PATCH_H = 8, PATCH_W = 16;  // output patch: the M tile
constexpr int BM = PATCH_H * PATCH_W;     // 128 output pixels per block
constexpr int BK = 64;                    // input channels per K chunk
constexpr int NTHREADS = 384;             // producer warpgroup + 2 consumer warpgroups
constexpr int NCONSUMERS = 256;
constexpr int PIX_BYTES = BK * 2;  // one pixel's chunk: 128 B
constexpr int A_STAGES = 3;  // chunk i+2 loads while chunk i+1 is activated and i multiplied
constexpr int B_STAGES_MAX = 6;
constexpr int SMEM_MAX = 232448;  // dynamic + static shared memory of one block
constexpr int SMEM_STATIC = 256;  // the mbarriers (static shared memory)
constexpr int SMEM_ALIGN = 1024;  // swizzled tiles start 1 KB aligned
// the prologue of chunk c+1 runs after taps ACT_TAP[wg].. of chunk c, each
// consumer warpgroup on its half of the patch at its own taps, so that the
// other one keeps the tensor cores fed meanwhile
constexpr int ACT_TAP0 = 3, ACT_TAP1 = 6;

// Shared-memory layout of one instance (the prologue activates in place and
// takes no memory of its own).
template <int BN, bool UP>
struct Layout {
  static_assert(BN == 16 || BN == 128 || BN == 256, "N tile");
  static constexpr int BOX_N = BN >= 64 ? 64 : BN;  // weight box width (channels)
  static constexpr int B_ROW = BOX_N * 2;           // bytes of one K row in a box
  static constexpr int B_BYTES = BK * BN * 2;       // one B stage
  static constexpr uint32_t B_LBO = BK * B_ROW;     // next box of BOX_N channels
  static constexpr uint32_t B_SBO = 8 * B_ROW;      // next 8 K rows
  static constexpr uint32_t B_SWIZZLE = BN >= 64 ? 1 : 3;  // 128B or 32B
  // the staged input patch: output rows / cols -1 .. 8 / 16, halved with up
  static constexpr int RAW_H = UP ? PATCH_H / 2 + 2 : PATCH_H + 2;
  static constexpr int RAW_W = UP ? PATCH_W / 2 + 2 : PATCH_W + 2;
  static constexpr int ROW_BYTES = (RAW_W * PIX_BYTES + SMEM_ALIGN - 1) / SMEM_ALIGN * SMEM_ALIGN;
  static constexpr int A_BYTES = RAW_H * ROW_BYTES;  // one A stage
  static constexpr int A_TX = RAW_H * RAW_W * PIX_BYTES;  // bytes the TMA writes into it
  static constexpr int OFF_B = A_STAGES * A_BYTES;
  static constexpr int B_STAGES_FIT = (SMEM_MAX - SMEM_STATIC - SMEM_ALIGN - OFF_B) / B_BYTES;
  static constexpr int B_STAGES = B_STAGES_FIT < B_STAGES_MAX ? B_STAGES_FIT : B_STAGES_MAX;
  static constexpr int SMEM_BYTES = OFF_B + B_STAGES * B_BYTES + SMEM_ALIGN;  // + alignment slack
  // the prologue: 16-byte vectors of the staged patch per consumer thread,
  // activated in pieces of ACT_PER_PIECE after taps ACT_TAP0..
  static constexpr int RAW_VECS = RAW_H * RAW_W * (BK / 8);
  static constexpr int ACT_ITERS = (RAW_VECS + NCONSUMERS - 1) / NCONSUMERS;
  static constexpr int ACT_PER_PIECE = 2;
  static constexpr int ACT_PIECES = (ACT_ITERS + ACT_PER_PIECE - 1) / ACT_PER_PIECE;
  static_assert(B_STAGES >= 2, "shared memory budget");
  static_assert(ACT_TAP0 + ACT_PIECES <= ACT_TAP1 && ACT_TAP1 + ACT_PIECES <= 9, "prologue taps");
};

struct Barriers {
  uint64_t a_loaded[A_STAGES];  // the TMA's writes of an A stage (prologue only)
  uint64_t a_full[A_STAGES];    // an A stage ready for the taps
  uint64_t a_empty[A_STAGES];
  uint64_t b_full[B_STAGES_MAX], b_empty[B_STAGES_MAX];
};
static_assert(sizeof(Barriers) <= SMEM_STATIC, "barriers");

// Where one block works: image b, output patch origin (y0, x0) in an
// (ho, wo) output image, output channels n0.., K chunks [c0, c1).
struct ConvGeom {
  int hs, ws;  // source image (x is [batch, hs, ws, cin]); (2hs, 2ws) output with up
  int ho, wo;
  int cin;
  int b, y0, x0, n0;
  int c0, c1;
};

__device__ __forceinline__ ConvGeom make_geom(int batch, int hs, int ws, int cin, int up, int bn,
                                              int ksplit) {
  ConvGeom g;
  g.hs = hs;
  g.ws = ws;
  g.ho = up ? 2 * hs : hs;
  g.wo = up ? 2 * ws : ws;
  g.cin = cin;
  g.b = blockIdx.z % batch;
  const int split = blockIdx.z / batch;
  const int tiles_x = (g.wo + PATCH_W - 1) / PATCH_W;
  g.y0 = (blockIdx.x / tiles_x) * PATCH_H;
  g.x0 = (blockIdx.x % tiles_x) * PATCH_W;
  g.n0 = blockIdx.y * bn;
  const int chunks = cin / BK;
  g.c0 = (int)((long long)split * chunks / ksplit);  // balanced, never empty while
  g.c1 = (int)((long long)(split + 1) * chunks / ksplit);  // ksplit <= chunks
  return g;
}

// Fast sigmoid (a few ulp). exp(-v) = inf for very negative v gives
// __fdividef(1, inf) = 0, as wanted.
__device__ __forceinline__ float sigmoidf_(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

// The tensor maps of one launch: x, etop and ebot (K-halo only; x again
// otherwise) with a box of one staged row (BK channels x RAW_W pixels), and
// the weight with a box of BK rows x BOX_N channels.
struct ConvMaps {
  CUtensorMap x, top, bot, w;
};

// The producer: one thread issues every load of the block, in the order the
// consumers take them: A of chunks 0 and 1, then per chunk i the weights of
// tap 0, A of chunk i+2 (its stage is freed once tap 0 of chunk i is
// issued), the weights of taps 1-8.
template <int BN, bool PRO, bool UP, bool HALO>
__device__ __forceinline__ void conv_producer(const ConvMaps& m, const ConvGeom& g, Barriers& bar,
                                              unsigned char* smem) {
  using L = Layout<BN, UP>;
  const int n = g.c1 - g.c0;
  const int ys = (UP ? g.y0 / 2 : g.y0) - 1, xs = (UP ? g.x0 / 2 : g.x0) - 1;
  auto load_a = [&](int i) {
    const int s = i % A_STAGES;
    if (i >= A_STAGES) mbar_wait(&bar.a_empty[s], ((i / A_STAGES) + 1) & 1);
    uint64_t* done = PRO ? &bar.a_loaded[s] : &bar.a_full[s];
    mbar_expect_tx(done, L::A_TX);
    unsigned char* dst = smem + s * L::A_BYTES;
    const int ch = (g.c0 + i) * BK;
    for (int r = 0; r < L::RAW_H; ++r) {
      const int iy = ys + r;  // rows outside x are zero-filled, or K-halo's neighbours
      const bool top = HALO && iy == -1, bot = HALO && iy == g.hs;
      tma_load_4d(dst + r * L::ROW_BYTES, top ? &m.top : bot ? &m.bot : &m.x, done, ch, xs,
                  top || bot ? 0 : iy, g.b);
    }
  };
  for (int i = 0; i < A_STAGES - 1 && i < n; ++i) load_a(i);
  for (int i = 0; i < n; ++i) {
    const int ch = (g.c0 + i) * BK;
    for (int t = 0; t < 9; ++t) {
      if (t == 1 && i + A_STAGES - 1 < n) load_a(i + A_STAGES - 1);
      const int j = i * 9 + t, s = j % L::B_STAGES;
      if (j >= L::B_STAGES) mbar_wait(&bar.b_empty[s], ((j / L::B_STAGES) + 1) & 1);
      mbar_expect_tx(&bar.b_full[s], L::B_BYTES);
      unsigned char* bs = smem + L::OFF_B + s * L::B_BYTES;
#pragma unroll
      for (int box = 0; box < BN / L::BOX_N; ++box)
        tma_load_2d(bs + box * L::B_LBO, &m.w, &bar.b_full[s], g.n0 + box * L::BOX_N,
                    t * g.cin + ch);
    }
  }
}

// Piece `piece` of the prologue for chunk i (0-based in the block's range),
// in place in A stage i % A_STAGES, on this thread's vectors (each consumer
// warpgroup activates half the patch). The first piece waits for the TMA's
// writes; the last one publishes the stage to the taps.
template <int BN, bool UP>
__device__ __forceinline__ void activate(const ConvGeom& g, Barriers& bar, unsigned char* smem,
                                         const float* __restrict__ Avec,
                                         const float* __restrict__ Bvec, int i, int piece) {
  using L = Layout<BN, UP>;
  const int ct = threadIdx.x - (NTHREADS - NCONSUMERS);  // 0..255
  const int cg = ct & 7;  // this thread's channel group (8 channels)
  const int s = i % A_STAGES;
  const int ch = (g.c0 + i) * BK + cg * 8;
  const float4* ap = reinterpret_cast<const float4*>(Avec + (size_t)g.b * g.cin + ch);
  const float4* bp = reinterpret_cast<const float4*>(Bvec + (size_t)g.b * g.cin + ch);
  const float4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];  // in flight during the wait
  if (piece == 0) mbar_wait(&bar.a_loaded[s], (i / A_STAGES) & 1);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const int ys = (UP ? g.y0 / 2 : g.y0) - 1, xs = (UP ? g.x0 / 2 : g.x0) - 1;
  unsigned char* a = smem + s * L::A_BYTES;
#pragma unroll
  for (int k = 0; k < L::ACT_PER_PIECE; ++k) {
    const int v = ct + (piece * L::ACT_PER_PIECE + k) * NCONSUMERS;
    if (v >= L::RAW_VECS) break;
    const int q = v >> 3;  // staged pixel
    const int rr = q / L::RAW_W, cc = q - rr * L::RAW_W;
    const int sy = ys + rr, sx = xs + cc;
    // outside the image the TMA's zeros stay (the zero pad), and K-halo's
    // neighbour rows (activated by the caller) stay as they came
    if (sy < 0 || sy >= g.hs || sx < 0 || sx >= g.ws) continue;
    uint4* p = reinterpret_cast<uint4*>(a + rr * L::ROW_BYTES + cc * PIX_BYTES +
                                        ((cg ^ (cc & 7)) << 4));
    float f[8];
    unpack8(*p, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float pre = f[e] * av[e] + bv[e];
      f[e] = pre * sigmoidf_(pre);
    }
    *p = pack8(f);
  }
  if (piece == L::ACT_PIECES - 1) mbar_arrive(&bar.a_full[s]);
}

// The consumers' K loop: acc (this warpgroup's 64 x BN f32 tile) = the sum
// over the block's chunks and the nine taps. Consumer warpgroup wg (0, 1)
// holds patch rows 4wg..4wg+3, one per warp.
template <int BN, bool PRO, bool UP>
__device__ __forceinline__ void conv_mainloop(const ConvGeom& g, Barriers& bar, unsigned char* smem,
                                              const float* __restrict__ Avec,
                                              const float* __restrict__ Bvec,
                                              float (&acc)[BN / 2]) {
  using L = Layout<BN, UP>;
  const int wg = threadIdx.x / 128 - 1, lane = threadIdx.x & 31;
  const int prow = 4 * wg + ((threadIdx.x / 32) & 3);  // this warp's patch row
  const int pcol = lane & 15, kg = lane >> 4;          // this lane's ldmatrix row, k half
  const bool leader = threadIdx.x % 128 == 0;
  const int n = g.c1 - g.c0;
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
  if constexpr (PRO) {
#pragma unroll
    for (int p = 0; p < L::ACT_PIECES; ++p) activate<BN, UP>(g, bar, smem, Avec, Bvec, 0, p);
  }
  // A fragments: two register sets, one per half tap (k16 steps 0-1 and
  // 2-3); each half is its own wgmma group, and a set is loaded again only
  // once the group that read it has completed (ptxas serializes wgmmas whose
  // input registers are written while they may be in flight)
  uint32_t frag[2][2][4];
  for (int i = 0; i < n; ++i) {
    const int s = i % A_STAGES;
    mbar_wait(&bar.a_full[s], (i / A_STAGES) & 1);
    const uint32_t a_base = smem_addr(smem + s * L::A_BYTES);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int ky = t / 3, kx = t % 3;
      // the staged pixel this lane's output pixel reads for tap (ky, kx)
      const int rr = UP ? ((prow + ky - 1) >> 1) + 1 : prow + ky;
      const int cc = UP ? ((pcol + kx - 1) >> 1) + 1 : pcol + kx;
      const uint32_t arow = a_base + rr * L::ROW_BYTES + cc * PIX_BYTES;
      const int j = i * 9 + t, sb = j % L::B_STAGES;
      const unsigned char* bt = smem + L::OFF_B + sb * L::B_BYTES;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint64_t bdesc[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int kk = 2 * half + k;
          ldmatrix_x4(frag[half][k], arow + (((2 * kk + kg) ^ (cc & 7)) << 4));
          bdesc[k] = make_desc(bt + kk * 16 * L::B_ROW, L::B_LBO, L::B_SBO, L::B_SWIZZLE);
          asm volatile("" : "+l"(bdesc[k]));  // computed before the group opens
        }
        if (half == 0) mbar_wait(&bar.b_full[sb], (j / L::B_STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 2; ++k) wgmma_rs<BN, 1>(acc, frag[half][k], bdesc[k], 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous half tap is done: its registers and stages are free
        if (half == 0 && leader && j > 0) {
          mbar_arrive(&bar.b_empty[(j - 1) % L::B_STAGES]);
          if (t == 0) mbar_arrive(&bar.a_empty[(i - 1) % A_STAGES]);
        }
      }
      if constexpr (PRO) {
        if (i + 1 < n) {
          if (wg == 0 && t >= ACT_TAP0 && t < ACT_TAP0 + L::ACT_PIECES)
            activate<BN, UP>(g, bar, smem, Avec, Bvec, i + 1, t - ACT_TAP0);
          if (wg == 1 && t >= ACT_TAP1 && t < ACT_TAP1 + L::ACT_PIECES)
            activate<BN, UP>(g, bar, smem, Avec, Bvec, i + 1, t - ACT_TAP1);
        }
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// Block setup shared by the kernels: barriers initialised, then the roles
// split. Returns the 1 KB-aligned dynamic shared memory.
__device__ __forceinline__ unsigned char* conv_setup(unsigned char* smem_raw, Barriers& bar,
                                                     bool pro) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(&bar.a_loaded[s], 1);
      mbar_init(&bar.a_full[s], pro ? NCONSUMERS : 1);
      mbar_init(&bar.a_empty[s], 2);
    }
    for (int s = 0; s < B_STAGES_MAX; ++s) {
      mbar_init(&bar.b_full[s], 1);
      mbar_init(&bar.b_empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) & ~(uintptr_t)(SMEM_ALIGN - 1));
}

// Accumulator element r of a consumer thread: its pixel in the patch (prow,
// pcol) and its column in the N tile. wgmma's m64nN layout: warp w of the
// warpgroup holds rows 16w.., lane l rows l/4 and l/4 + 8, columns
// 8*(r/4) + 2*(l%4) + r%2; with 16-wide patch rows, warp w is one patch row.
__device__ __forceinline__ void acc_coord(int r, int& prow, int& pcol, int& col) {
  const int wg = threadIdx.x / 128 - 1, w = (threadIdx.x / 32) & 3, l = threadIdx.x & 31;
  prow = 4 * wg + w;
  pcol = (l >> 2) + 8 * ((r >> 1) & 1);
  col = 8 * (r >> 2) + 2 * (l & 3) + (r & 1);
}

// The epilogues work on the block's tile staged in shared memory, so that
// they read and write global memory 16 bytes a thread, a pixel's channels
// on consecutive threads. A consumer thread owns 8 channels (channel group
// `grp`) of pixels po, po + PIX_PER_PASS, ...
template <int BN>
struct Epi {
  static constexpr int PITCH = BN + 8;  // f32 row pitch of the staged tile (bank spread)
  static constexpr int GROUPS = BN / 8;
  static constexpr int PIX_PER_PASS = NCONSUMERS / GROUPS;
  static constexpr int PASSES = BM / PIX_PER_PASS;
  static constexpr int TILE_BYTES = BM * PITCH * 4;
};

// Stage this thread's accumulators as the block's [BM][BN] f32 tile (row =
// patch pixel, row-major over the 8 x 16 patch) at the start of shared
// memory, once both consumer warpgroups are past the main loop (whose
// buffers it overwrites). Returns the tile, complete for every consumer.
template <int BN>
__device__ __forceinline__ const float* stage_acc(const float (&acc)[BN / 2], unsigned char* smem) {
  float* c = reinterpret_cast<float*>(smem);
  named_barrier(1, NCONSUMERS);
#pragma unroll
  for (int r = 0; r < BN / 2; r += 2) {
    int prow, pcol, col;
    acc_coord(r, prow, pcol, col);
    *reinterpret_cast<float2*>(c + (prow * PATCH_W + pcol) * Epi<BN>::PITCH + col) =
        make_float2(acc[r], acc[r + 1]);
  }
  named_barrier(1, NCONSUMERS);
  return c;
}

// Store the staged tile raw (a split-K partial) to ws, laid out [ho*wo,
// ncols] for this (split, image), masking outside pixels and columns.
template <int BN>
__device__ __forceinline__ void store_partial(const float* c, const ConvGeom& g,
                                              float* __restrict__ ws, int ncols) {
  const int ct = threadIdx.x - (NTHREADS - NCONSUMERS);
  const int grp = ct % Epi<BN>::GROUPS, po = ct / Epi<BN>::GROUPS;
  const int n = g.n0 + grp * 8;
  if (n >= ncols) return;
#pragma unroll 4
  for (int pass = 0; pass < Epi<BN>::PASSES; ++pass) {
    const int p = pass * Epi<BN>::PIX_PER_PASS + po;
    const int oy = g.y0 + p / PATCH_W, ox = g.x0 + p % PATCH_W;
    if (oy >= g.ho || ox >= g.wo) continue;
    const float4* src = reinterpret_cast<const float4*>(c + p * Epi<BN>::PITCH + grp * 8);
    float4* dst = reinterpret_cast<float4*>(ws + ((size_t)oy * g.wo + ox) * ncols + n);
    dst[0] = src[0];
    dst[1] = src[1];
  }
}

// Sum of the ksplit partials of element i (of per-split size `stride`), in
// split order.
__device__ __forceinline__ float sum_splits(const float* __restrict__ ws, size_t i, size_t stride,
                                            int ksplit) {
  float v = 0.f;
  for (int s = 0; s < ksplit; ++s) v += ws[s * stride + i];
  return v;
}

// ---------------------------------------------------------------------------
// host side: tensor maps, encoded per call (they hold the tensors' pointers;
// the encoder is hopper.cuh's)
// ---------------------------------------------------------------------------

// NHWC bf16 [n, h, w, c] as a 4-D map; box BK channels x box_w x box_h x 1,
// 128B-swizzled (a pixel's 128 bytes are one swizzle row).
inline int map_nhwc(CUtensorMap* m, const void* p, int n, int h, int w, int c, int box_w,
                    int box_h) {
  EncodeTiledFn f;
  if (int st = encode_fn(&f)) return st;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {BK, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides,
                       box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// The HWIO weight as [9*cin rows, cout channels]; box BK rows x box_n.
inline int map_weight(CUtensorMap* m, const void* p, int cin, int cout, int box_n) {
  EncodeTiledFn f;
  if (int st = encode_fn(&f)) return st;
  const cuuint64_t dims[2] = {(cuuint64_t)cout, (cuuint64_t)9 * cin};
  const cuuint64_t strides[1] = {(cuuint64_t)cout * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_n, BK};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides,
                       box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       box_n >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// The maps of one conv launch over input x [batch, hs, ws, cin] (etop / ebot
// [batch, 1, ws, cin] or null) and weight w [9*cin, cout].
inline int make_conv_maps(ConvMaps* m, const void* x, const void* etop, const void* ebot,
                          const void* w, int batch, int hs, int ws, int cin, int cout, int bn,
                          bool up) {
  const int bw = up ? PATCH_W / 2 + 2 : PATCH_W + 2;  // one staged row
  if (int st = map_nhwc(&m->x, x, batch, hs, ws, cin, bw, 1)) return st;
  if (etop != nullptr) {
    if (int st = map_nhwc(&m->top, etop, batch, 1, ws, cin, bw, 1)) return st;
    if (int st = map_nhwc(&m->bot, ebot, batch, 1, ws, cin, bw, 1)) return st;
  } else {
    m->top = m->bot = m->x;
  }
  return map_weight(&m->w, w, cin, cout, bn >= 64 ? 64 : bn);
}

inline int smem_bytes(int bn, bool up) {
#define CGD_SMEM(BN) \
  if (bn == BN) return up ? Layout<BN, true>::SMEM_BYTES : Layout<BN, false>::SMEM_BYTES;
  CGD_SMEM(16)
  CGD_SMEM(128)
  CGD_SMEM(256)
#undef CGD_SMEM
  return -1;
}

}  // namespace cgd
