// K-fwd, K-halo and K-dx at f32 operands: the 3x3, stride-1, pad-1 NHWC
// conv family for sm_90a, in every mode that compute_dtype="float32" reaches.
//
// Replaces the Pallas TPU kernels of cgd_tpu/kernels/conv_pallas.py at f32
// operands (itemsize 4, cgd_tpu/ops/nn.py:169-178 and :274-327):
// - K-fwd (_conv3x3_pallas -> _conv_kernel): out = conv3x3(h, w) + bias
//   [+ skip], h = x, or with the prologue h = silu(x*A + B) (GroupNorm apply
//   and emb scale-shift folded into per-(batch, channel) A/B), or with up
//   h = nearest_2x(silu(x*A + B)). The plain mode is also where the LPIPS
//   VGG16 reaches it (cgd_tpu/models/vgg_lpips.py:60), and the input
//   gradient of a conv is the same conv with flipped, transposed weights
//   and a zero bias (conv_pallas.py:553-558).
// - K-halo (the same launcher in explicit_halo mode, conv_pallas.py:335-337,
//   :397-399, :507-513, reached from cgd_tpu/kernels/conv_spmd.py:139, which
//   plans it at the activation's own itemsize): K-fwd on one shard of a
//   height-split image, rows -1 and H taken from etop / ebot, the
//   neighbouring shards' boundary rows, already activated.
// - K-dx (_conv3x3_dx_pallas -> _conv_dx_kernel), and its W >= 512 class
//   (_conv3x3_dx_wtiled -> _conv_dx_kernel_wtiled), the backward of the
//   prologue conv: acc = conv3x3(g, wt), pre = x*A + B,
//   dpre = acc * silu'(pre), dx = dpre * A, dA = sum_hw dpre*x,
//   dB = sum_hw dpre (conv_pallas.py:595-607).
//
// Bound: operations (tensor cores at TF32; three MMAs a product here) for
// Cin >= 64 on the large images; bytes for the 3-channel first conv, its
// input gradient, the 6-channel eps/sigma conv, K-dx into those 6 channels
// (dx and the pre-activation input stream through the epilogue) and the
// small images' wide convs (the weights).
//
// Precision: 3xTF32. Each f32 operand is split into a TF32 high part and a
// residual, and a product is lo*hi + hi*lo + hi*hi (the lo*lo term left
// out). The weights are split once per call by
// conv3x3_f32_split_weights (hi the TF32 rounding of w, lo the TF32
// rounding of w - hi: split_tf32); the activations as they leave shared
// memory by split_tf32_trunc (a mask and a subtraction). The tensor cores add
// into their f32 accumulator with truncation, so the products of one tap
// (one 32-channel chunk) go to zeroed fragments, which are then added to the
// f32 accumulators in registers: f32's precision (chip_smoke.py phases 3, 9
// and 10 hold it against f64). Plain TF32 held every conv to 3.5e-4 of its
// plain version's max, but not the LPIPS distance's input gradient through
// the thirteen convs (relative L2 6.9e-2 at 256^2).
//
// Design (kernels/conv3x3.py f32_plan is the same geometry; the entry points
// refuse any other):
// - An implicit GEMM on wgmma.m64nNk8 at TF32: M = an output patch of 128
//   pixels (8 x 16; 4 x 32 or 2 x 64 on outputs shorter than 8 rows), two
//   consumer warpgroups of 64; N = 64 output channels (8 for the eps/sigma
//   conv and the 3-channel input gradient); K = 9 taps x Cin in 32-channel
//   chunks, each 4 k8 steps (2 where Cin <= 16, 1 where Cin <= 8: the
//   3-channel first conv and K-dx's 6-channel cotangent carry no zero
//   steps). A comes from registers: each lane loads its m16 tile's rows
//   from the staged window and splits them; B is the weight slab in shared
//   memory, K-major ([Cout][Cin] rows of the split weights, which is what
//   wgmma takes at TF32), read through a descriptor. A 128-wide N tile's
//   accumulators and per-tap sums spill at the 168 registers a thread of a
//   384-thread block gets, so N stays 64.
// - Warp specialisation and a TMA ring: warp 0 is the producer (one lane
//   issues every copy), warps 1-3 apply the prologue, warps 4-11 are the
//   two consumer warpgroups. Two rings: the chunk's input window (the
//   patch's pad-1 halo, one 4-D TMA box of 32 channels x the window's width
//   per row, 128B-swizzled, each row in a 1 KB-aligned slot; zero-filled
//   outside the image by the TMA unit; with HALO rows -1 and h come from
//   etop / ebot) and, one tap at a time, the weight slab of 64 rows x 32
//   channels, hi and lo (two 3-D boxes of the split weights). No block-wide
//   barrier stands in the main loop (mbarriers, one arrival per consumer
//   warp), and the producer runs ahead by the ring's depth.
// - Persistent blocks: min(tiles, SMs) blocks, each taking a contiguous run
//   of output tiles (patch, K range, image, N tile), so that the producer
//   loads the next tile while the consumers finish the last one's
//   epilogue. With one chunk (Cin <= 32) a run's nine weight slabs are
//   loaded once per N tile and stay resident.
// - The prologue: silu(x*A + B) in f32 (expf and a true division) on a
//   landed window, in place, by the activation warps, each element once and
//   off the consumers' critical path; cells outside the image and K-halo's
//   rows -1 / h (post-activation already) are left as they are.
// - Fragments: every lane loads 16 bytes (channels 4t..4t+3 of a k16 group
//   serve two k8 steps: k = t / t + 4 stand for channels 4t + 2s / 4t + 2s
//   + 1 of step s; the split weights store their channels in that order);
//   fragment rows g and g + 8 are patch columns pxl(g) / pxh(g), permuted
//   so that the two rows a quarter-warp reads lie in different halves of
//   the 128B swizzle: conflict-free.
// - Split K where the tiles alone do not fill the SMs (the 16^2 and 8^2
//   levels, the VGG's 16^2, K-halo's short shards): the chunks are cut into
//   ksplit ranges, each tile writing its raw sums to a workspace, and
//   conv3x3_f32_finish sums the ranges in order and applies the epilogue.
//   No float atomics anywhere, so reruns are bit-identical.
// - Modes: UP (a template flag: the window is staged at source resolution,
//   (ph/2 + 2) x (pw/2 + 2), and output row oy + dy - 1 reads window row
//   (oy + dy + 1) / 2, the same for columns: nearest-2x is only an address),
//   the prologue and HALO (runtime flags of the producer side), the
//   epilogues OUT (bias, and the residual when given, as the plain version's
//   (acc + bias) + skip), DX (K-dx: dpre and dx per element, and the tile's
//   dA/dB column sums over its pixels in a fixed order into a [batch,
//   patches, 2, cx] buffer that conv3x3_dx_f32_reduce sums over the patches
//   in order) and PART (split K's raw sums).
#include "common.cuh"
#include "hopper.cuh"

namespace cgd {
namespace f32conv {

constexpr int BM = 128;             // output pixels of one block
constexpr int BK = 32;              // channels of one chunk (one 128-byte swizzle row)
constexpr int CWARPS = 8;           // consumer warps
constexpr int MAX_WS = 4, MAX_SS = 36, MAX_SPLIT = 16;
constexpr int SMEM_ALIGN = 1024;
constexpr int SMEM_MAX = 232448;    // one block's shared memory on the H100
constexpr int STATIC_RESERVE = 5120;  // the mbarriers and K-dx's column sums
constexpr unsigned TF32_MASK = 0xffffe000u;

enum Epilogue { EPI_OUT = 0, EPI_DX = 1, EPI_PART = 2 };

// A block: warp 0 the producer, warps 1-3 the activation warps (the
// producer's warpgroup), warps 4-11 two consumer warpgroups, each warp one
// m16 tile of the 128-pixel patch; wgmma's m64 is a warpgroup's four.
constexpr int AW = 3;
constexpr int THREADS = 32 * (4 + CWARPS);

// wgmma.m64nNk8 at TF32, A (this warp's m16 x k8 fragment, laid out as
// mma.m16n8k8's) from registers, B (N x k8, K-major, 128B-swizzled) from
// shared memory through its descriptor, f32 accumulators; scale_d = 0
// overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The k8 steps of wgmma a chunk takes: 1 where Cin <= 8 (the 3-channel
// first conv, K-dx into 6 channels), 2 where Cin <= 16, else 4.
__host__ __device__ inline int k8_steps(int cin) { return cin <= 8 ? 1 : cin <= 16 ? 2 : 4; }

// The split weights keep each output channel's row K-major. Where a chunk
// takes two or four k8 steps its channels are permuted within each group of
// 16: position 8s + t + 4h holds channel 4t + 2s + h, so that wgmma's k8 step
// s of a group reads at k = t / t + 4 the channels 4t + 2s / + 1, the two of
// the A fragment's 16-byte load of channels 4t..4t + 3 that step s takes.
// With one k8 step (Cin <= 8) the order is natural: k = t / t + 4 are
// channels t / t + 4, loaded 4 bytes each. channel_at(pos) is that map, and
// cin_k the row's length.
__host__ __device__ inline int channel_at(int pos, int cin) {
  if (k8_steps(cin) == 1) return pos;
  return (pos & ~15) + 4 * (pos & 3) + 2 * ((pos >> 3) & 1) + ((pos >> 2) & 1);
}
__host__ __device__ inline int cin_k(int cin) {
  return k8_steps(cin) == 1 ? 8 : (cin + 15) / 16 * 16;
}

// The launch plan (kernels/conv3x3.py f32_plan computes the same).
struct Plan {
  int bn, ph, pw, ks, chunks, ksplit, ws, ss, smem, patches, tiles_x, ho, wo, wr, wc, slot;
  int tiles, blocks;
};

// wgmma's N: 8 for Cout <= 8, else 64 (a 128-wide N tile's accumulators and
// per-tap sums spill at the 168 registers a thread of a 384-thread block has)
__host__ __device__ inline int tile_bn(int cout) { return cout <= 8 ? 8 : 64; }

inline Plan make_plan(int batch, int h, int w, int cin, int cout, bool up, int sms) {
  Plan p;
  p.ho = up ? 2 * h : h;
  p.wo = up ? 2 * w : w;
  p.ph = (up || p.ho >= 8) ? 8 : p.ho >= 4 ? 4 : 2;
  p.pw = BM / p.ph;
  p.ks = k8_steps(cin);
  p.chunks = (cin + BK - 1) / BK;
  p.bn = tile_bn(cout);
  p.tiles_x = (p.wo + p.pw - 1) / p.pw;
  p.patches = ((p.ho + p.ph - 1) / p.ph) * p.tiles_x;
  const int tiles = p.patches * ((cout + p.bn - 1) / p.bn) * batch;
  p.ksplit = 1;
  if (tiles < sms) {
    p.ksplit = sms / tiles;
    if (p.ksplit > p.chunks) p.ksplit = p.chunks;
    if (p.ksplit > MAX_SPLIT) p.ksplit = MAX_SPLIT;
    if (p.ksplit < 1) p.ksplit = 1;
  }
  p.wr = up ? p.ph / 2 + 2 : p.ph + 2;
  p.wc = up ? p.pw / 2 + 2 : p.pw + 2;
  p.slot = (p.wc * 128 + SMEM_ALIGN - 1) / SMEM_ALIGN * SMEM_ALIGN;
  const int win = p.wr * p.slot, slab = 2 * p.bn * 128;
  p.ws = p.bn == 8 ? 4 : 2;
  p.ss = (SMEM_MAX - STATIC_RESERVE - SMEM_ALIGN - p.ws * win) / slab;
  if (p.ss > MAX_SS) p.ss = MAX_SS;
  p.smem = p.ws * win + p.ss * slab + SMEM_ALIGN;
  p.tiles = tiles * p.ksplit;
  p.blocks = p.tiles < sms ? p.tiles : sms;
  return p;
}

struct Params {
  const float* bias;  // [cout] (OUT)
  const float* A;     // [batch, cin] prologue scale (K-dx: [batch, cout])
  const float* B;     // [batch, cin] prologue shift (K-dx: [batch, cout])
  const float* skip;  // [batch, ho, wo, cout] or null (OUT)
  const float* xpre;  // K-dx: the pre-activation input [batch, h, w, cout]
  float* out;         // [batch, ho, wo, cout] (K-dx: dx; PART: the workspace)
  float* partial;     // K-dx: [batch, patches, 2, cout] dA / dB column sums
  int batch, h, wd, cin, cout, ho, wo;
  int ph, pw, tiles_x, wr, wc, slot_lines, chunks, ksplit, ws, ss, win_floats;
  int patches, tiles, pro, halo;
};

// sigmoid in full f32 (expf and a true division), as the plain version's
__device__ __forceinline__ float sigmoid_f32(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ uint32_t lo_part(float v) {
  return __float_as_uint(v - __uint_as_float(__float_as_uint(v) & TF32_MASK));
}

// One output tile: a patch of an image, its N tile, its K range (split K).
// Tiles are numbered patch fastest, then K range, image and N tile; a block
// takes a contiguous run of them.
struct TileIdx {
  int patch, split, b, nt, k0, k1, y0, x0;
};

__device__ __forceinline__ TileIdx tile_of(int t, const Params& p) {
  TileIdx q;
  q.patch = t % p.patches;
  int r = t / p.patches;
  q.split = r % p.ksplit;
  r /= p.ksplit;
  q.b = r % p.batch;
  q.nt = r / p.batch;
  q.k0 = q.split * p.chunks / p.ksplit;
  q.k1 = (q.split + 1) * p.chunks / p.ksplit;
  q.y0 = (q.patch / p.tiles_x) * p.ph;
  q.x0 = (q.patch % p.tiles_x) * p.pw;
  return q;
}

// A consumer warp's epilogue of one tile. Accumulator rows g / g + 8 are
// patch pixels (pr, pxl) and (pr, pxh); acc[4nj + 2r + e] is channel
// n0 + 8nj + 2t + e of row r.
template <int BN, bool UP, int EPI>
__device__ __forceinline__ void epilogue(const Params& p, const TileIdx& tl,
                                         const float (&acc)[BN / 2], int pr, int pxl, int pxh,
                                         int cw, int g, int t) {
  constexpr int NJ = BN / 8, GROUP = NJ < 8 ? NJ : 8;  // n8 tiles, handled 8 at a time
  const int oy = tl.y0 + pr, n0 = tl.nt * BN + 2 * t, b = tl.b;
  const bool valid = oy < p.ho && tl.x0 + (pxl & ~15) < p.wo;
  const int img = EPI == EPI_PART ? tl.split * p.batch + b : b;
  // this thread's two output pixels (rows g and g + 8), channel n0 of each
  bool in_px[2];
  size_t base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ox = tl.x0 + (r ? pxh : pxl);
    in_px[r] = valid && ox < p.wo;
    base[r] = (((size_t)img * p.ho + oy) * p.wo + ox) * p.cout + n0;
  }
  // the inputs read where an output is written (the residual, K-dx's
  // pre-activation input), a group of n8 tiles loaded before any is written
  const float* src = EPI == EPI_DX ? p.xpre : EPI == EPI_OUT ? p.skip : nullptr;
  float sa[NJ][2], sb[NJ][2];
#pragma unroll
  for (int j0 = 0; j0 < NJ; j0 += GROUP) {
    float2 in[GROUP][2];
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        in[j][r] = make_float2(0.f, 0.f);
        if (src != nullptr && in_px[r] && n0 + 8 * (j0 + j) < p.cout)
          in[j][r] = __ldg(reinterpret_cast<const float2*>(src + base[r] + 8 * (j0 + j)));
      }
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const int nj = j0 + j, n = n0 + 8 * nj;
      if constexpr (EPI != EPI_DX) {
        if (n >= p.cout) continue;
        float2 bv = make_float2(0.f, 0.f);
        if (EPI == EPI_OUT) bv = __ldg(reinterpret_cast<const float2*>(p.bias + n));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!in_px[r]) continue;
          // (acc + bias) + skip, as the plain version adds them
          *reinterpret_cast<float2*>(p.out + base[r] + 8 * nj) =
              make_float2(acc[4 * nj + 2 * r] + bv.x + in[j][r].x,
                          acc[4 * nj + 2 * r + 1] + bv.y + in[j][r].y);
        }
      } else {
        // K-dx: dpre = acc * silu'(pre), dx = dpre * A; each thread sums
        // dpre*x and dpre over its two pixels for each of its channels
        sa[nj][0] = sa[nj][1] = sb[nj][0] = sb[nj][1] = 0.f;
        if (n >= p.cout) continue;
        const float2 av = __ldg(reinterpret_cast<const float2*>(p.A + (size_t)b * p.cout + n));
        const float2 bv = __ldg(reinterpret_cast<const float2*>(p.B + (size_t)b * p.cout + n));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!in_px[r]) continue;
          const float xs[2] = {in[j][r].x, in[j][r].y}, as[2] = {av.x, av.y};
          const float bs[2] = {bv.x, bv.y};
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pre = xs[e] * as[e] + bs[e];
            const float sg = sigmoid_f32(pre);
            const float dpre = acc[4 * nj + 2 * r + e] * (sg * (1.f + pre * (1.f - sg)));
            d[e] = dpre * as[e];
            sa[nj][e] += dpre * xs[e];
            sb[nj][e] += dpre;
          }
          *reinterpret_cast<float2*>(p.out + base[r] + 8 * nj) = make_float2(d[0], d[1]);
        }
      }
    }
  }
  if constexpr (EPI == EPI_DX) {
    __shared__ float colA[CWARPS * BN], colB[CWARPS * BN];
    static_assert(2 * CWARPS * BN * 4 + 1024 <= STATIC_RESERVE, "column sums");
    // over the 8 lanes of one channel pair (lane bits 2-4), in a fixed order
#pragma unroll
    for (int m = 4; m <= 16; m <<= 1)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sa[nj][e] += __shfl_xor_sync(0xffffffffu, sa[nj][e], m);
          sb[nj][e] += __shfl_xor_sync(0xffffffffu, sb[nj][e], m);
        }
    named_barrier(1, 32 * CWARPS);  // the previous tile's sums are read
    if (g == 0) {
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          colA[cw * BN + 8 * nj + 2 * t + e] = sa[nj][e];
          colB[cw * BN + 8 * nj + 2 * t + e] = sb[nj][e];
        }
    }
    named_barrier(1, 32 * CWARPS);
    // then the eight m16 tiles in order
    const int ct = threadIdx.x - 128, c = tl.nt * BN + ct;
    if (ct < BN && c < p.cout) {
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int r = 0; r < CWARPS; ++r) {
        pa += colA[r * BN + ct];
        pb += colB[r * BN + ct];
      }
      const size_t at = ((size_t)b * p.patches + tl.patch) * 2 * p.cout + c;
      p.partial[at] = pa;
      p.partial[at + p.cout] = pb;
    }
  }
}

// A fragments of one tap's KS k8 steps for a consumer warp: rows g / g + 8
// of its m16 tile read window pixels (wrow, cl) and (wrow, ch). hi is the raw
// bits (the tensor cores read a TF32 operand's top 19 bits: the truncation
// split_tf32_trunc masks out), lo split here, once.
template <int KS>
struct Frags {
  uint32_t hi[KS][4], lo[KS][4];
};

template <bool UP, int KS>
__device__ __forceinline__ void load_frags(Frags<KS>& f, const float* win, const Params& p, int tap,
                                           int pr, int pxl, int pxh, int t) {
  const int dy = tap / 3, dx = tap % 3;
  const int wrow = UP ? (pr + dy + 1) >> 1 : pr + dy;
  const int cl = UP ? (pxl + dx + 1) >> 1 : pxl + dx;
  const int ch = UP ? (pxh + dx + 1) >> 1 : pxh + dx;
  const float* rowl = win + (wrow * p.slot_lines + cl) * 32;
  const float* rowh = win + (wrow * p.slot_lines + ch) * 32;
  float v[KS][4];
  if constexpr (KS == 1) {  // channels t and t + 4, natural order
    v[0][0] = rowl[((0 ^ (cl & 7)) << 2) + t];
    v[0][1] = rowh[((0 ^ (ch & 7)) << 2) + t];
    v[0][2] = rowl[((1 ^ (cl & 7)) << 2) + t];
    v[0][3] = rowh[((1 ^ (ch & 7)) << 2) + t];
  } else {  // channels 16kg + 4t..4t + 3 serve k8 steps 2kg and 2kg + 1
#pragma unroll
    for (int kg = 0; kg < KS / 2; ++kg) {
      const int lc = 4 * kg + t;
      const float4 vl = *reinterpret_cast<const float4*>(rowl + ((lc ^ (cl & 7)) << 2));
      const float4 vh = *reinterpret_cast<const float4*>(rowh + ((lc ^ (ch & 7)) << 2));
      v[2 * kg][0] = vl.x, v[2 * kg][1] = vh.x, v[2 * kg][2] = vl.y, v[2 * kg][3] = vh.y;
      v[2 * kg + 1][0] = vl.z, v[2 * kg + 1][1] = vh.z, v[2 * kg + 1][2] = vl.w;
      v[2 * kg + 1][3] = vh.w;
    }
  }
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f.hi[s][e] = __float_as_uint(v[s][e]);
      f.lo[s][e] = lo_part(v[s][e]);
    }
}

// One tap's products as one wgmma group, into two fragments zeroed by their
// first product: part[s % 2] takes k8 step s, per step lo*hi, hi*lo, then
// hi*hi, the small terms first. (On an H100 80GB HBM3 a warpgroup's
// wgmmas run one after another whatever their accumulators, each m64n64k8
// at TF32 ~100 ns: the tap's time is its count of wgmmas.)
template <int BN, int KS>
__device__ __forceinline__ void tap_mmas(float (&part)[2][BN / 2], const Frags<KS>& f,
                                         const float* slab) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    // K-major B: the k8 step's 32 bytes of each 128-byte row
    const uint64_t dh = make_desc(slab + 8 * s, 16, 1024, 1);
    const uint64_t dl = make_desc(slab + BN * 32 + 8 * s, 16, 1024, 1);
    wgmma_tf32<BN>(part[s & 1], f.lo[s], dh, s >> 1);
    wgmma_tf32<BN>(part[s & 1], f.hi[s], dl, 1);
    wgmma_tf32<BN>(part[s & 1], f.hi[s], dh, 1);
  }
  wgmma_commit();
}

template <int BN, int KS>
__device__ __forceinline__ void add_part(float (&acc)[BN / 2], float (&part)[2][BN / 2]) {
  fence_regs(part[0]);
  if constexpr (KS == 1) {
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] += part[0][r];
  } else {
    fence_regs(part[1]);
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] += part[0][r] + part[1][r];
  }
}

// The nine taps of one chunk into acc, each tap's sum in fresh fragments
// added to acc in f32. Tap k reads slab stage (st0 + k) % ss (the resident
// slabs: stage k) at phase ph0, flipping where the ring wraps.
template <int BN, bool UP, int KS>
__device__ __forceinline__ void chunk_taps(const Params& p, const float* win, float* slabs,
                                           uint64_t* slab_full, uint64_t* slab_empty,
                                           bool resident, int st0, int ph0, int pr, int pxl,
                                           int pxh, int t, int lane, float (&acc)[BN / 2]) {
  constexpr int SLAB = 2 * BN * 32;
  float part[2][BN / 2];
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    Frags<KS> f;
    load_frags<UP, KS>(f, win, p, tap, pr, pxl, pxh, t);
    int st = tap, ph = ph0;
    if (!resident) {
      st = st0 + tap;
      if (st >= p.ss) st -= p.ss, ph ^= 1;
    }
    mbar_wait(&slab_full[st], ph);
    tap_mmas<BN, KS>(part, f, slabs + st * SLAB);
    wgmma_wait<0>();
    if (!resident) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&slab_empty[st]);
    }
    add_part<BN, KS>(acc, part);
  }
}

template <int BN, int KS, bool UP, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap tmap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ CUtensorMap wmap, const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t win_full[MAX_WS], win_ready[MAX_WS], win_empty[MAX_WS];
  __shared__ uint64_t slab_full[MAX_SS], slab_empty[MAX_SS];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) & ~(uintptr_t)(SMEM_ALIGN - 1));
  float* wins = smem;
  float* slabs = smem + p.ws * p.win_floats;
  constexpr int SLAB = 2 * BN * 32;  // floats: hi rows, then lo rows
  // the block's tiles; with one chunk (Cin <= 32) the nine slabs of an N
  // tile stay resident over the run of tiles that share it
  const int t0 = blockIdx.x * p.tiles / gridDim.x, t1 = (blockIdx.x + 1) * p.tiles / gridDim.x;
  const bool resident = p.chunks == 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.ws; ++s) {
      mbar_init(&win_full[s], 1);
      mbar_init(&win_ready[s], AW);
      mbar_init(&win_empty[s], CWARPS);
    }
    for (int s = 0; s < p.ss; ++s) {
      mbar_init(&slab_full[s], 1);
      mbar_init(&slab_empty[s], CWARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {  // the producer
    if (lane != 0) return;
    const uint32_t win_tx = p.wr * p.wc * 128, slab_tx = SLAB * 4;
    int wi = 0, sj = 0, runs = 0, prev_nt = -1;
    for (int tt = t0; tt < t1; ++tt) {
      const TileIdx tl = tile_of(tt, p);
      // the window's first source pixel (output row / col -1, halved with up)
      const int sy0 = UP ? tl.y0 / 2 - 1 : tl.y0 - 1, sx0 = UP ? tl.x0 / 2 - 1 : tl.x0 - 1;
      for (int ck = tl.k0; ck < tl.k1; ++ck, ++wi) {
        const int s = wi % p.ws, c = ck * BK;
        if (wi >= p.ws) mbar_wait(&win_empty[s], ((wi / p.ws) + 1) & 1);
        mbar_expect_tx(&win_full[s], win_tx);
        float* dst = wins + s * p.win_floats;
        for (int r = 0; r < p.wr; ++r) {
          const int gy = sy0 + r;
          const CUtensorMap* m = &xmap;
          int row = gy;
          if (p.halo && gy == -1) m = &tmap, row = 0;
          if (p.halo && gy == p.h) m = &bmap, row = 0;
          tma_load_4d(dst + r * p.slot_lines * 32, m, &win_full[s], c, sx0, row, tl.b);
        }
        if (resident && tl.nt == prev_nt) continue;
        for (int tap = 0; tap < 9; ++tap) {
          int st = tap;
          if (resident) {
            if (runs > 0) mbar_wait(&slab_empty[tap], (runs - 1) & 1);
          } else {
            st = sj % p.ss;
            if (sj >= p.ss) mbar_wait(&slab_empty[st], ((sj / p.ss) + 1) & 1);
            ++sj;
          }
          mbar_expect_tx(&slab_full[st], slab_tx);
          float* sd = slabs + st * SLAB;
          tma_load_3d(sd, &wmap, &slab_full[st], c, tl.nt * BN, tap);
          tma_load_3d(sd + BN * 32, &wmap, &slab_full[st], c, tl.nt * BN, 9 + tap);
        }
        if (resident) ++runs;
      }
      prev_nt = tl.nt;
    }
    return;
  }

  if (warp <= AW) {  // the activation warps: silu(x*A + B) on each landed window
    if (!p.pro) return;
    const int at = threadIdx.x - 32, q = at & 7;
    const int npix = p.wr * p.wc;
    int wi = 0;
    for (int tt = t0; tt < t1; ++tt) {
      const TileIdx tl = tile_of(tt, p);
      const int sy0 = UP ? tl.y0 / 2 - 1 : tl.y0 - 1, sx0 = UP ? tl.x0 / 2 - 1 : tl.x0 - 1;
      for (int ck = tl.k0; ck < tl.k1; ++ck, ++wi) {
        const int s = wi % p.ws;
        mbar_wait(&win_full[s], (wi / p.ws) & 1);
        const int c = ck * BK + 4 * q;
        if (c < p.cin) {
          const float4 a = *reinterpret_cast<const float4*>(p.A + (size_t)tl.b * p.cin + c);
          const float4 sh = *reinterpret_cast<const float4*>(p.B + (size_t)tl.b * p.cin + c);
          float* win = wins + s * p.win_floats;
          for (int pix = at >> 3; pix < npix; pix += 4 * AW) {
            const int r = pix / p.wc, col = pix - r * p.wc;
            const int gy = sy0 + r, gx = sx0 + col;
            if (gy < 0 || gy >= p.h || gx < 0 || gx >= p.wd) continue;
            float4* cell = reinterpret_cast<float4*>(win + (r * p.slot_lines + col) * 32 +
                                                     ((q ^ (col & 7)) << 2));
            float4 v = *cell;
            float pre;
            pre = v.x * a.x + sh.x; v.x = pre * sigmoid_f32(pre);
            pre = v.y * a.y + sh.y; v.y = pre * sigmoid_f32(pre);
            pre = v.z * a.z + sh.z; v.z = pre * sigmoid_f32(pre);
            pre = v.w * a.w + sh.w; v.w = pre * sigmoid_f32(pre);
            *cell = v;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(&win_ready[s]);
      }
    }
    return;
  }

  // the consumers: two warpgroups, warp cw owning m16 tile cw of the patch
  const int cw = warp - 4;
  const int g = lane >> 2, t = lane & 3;
  // fragment rows g / g + 8: patch row pr, columns pxl / pxh
  const int base = cw * 16, pr = base / p.pw, cb = base % p.pw;
  const int pxl = cb + (UP ? (g >> 1) + 8 * (g & 1) : (g >> 1) + 4 * (g & 1));
  const int pxh = UP ? pxl + 4 : pxl + 8;
  uint64_t* ready = p.pro ? win_ready : win_full;
  int wi = 0, sj = 0, runs = 0, prev_nt = -1;

#pragma unroll 1
  for (int tt = t0; tt < t1; ++tt) {
    const TileIdx tl = tile_of(tt, p);
    if (resident && tl.nt != prev_nt) ++runs;
    float acc[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
#pragma unroll 1
    for (int ck = tl.k0; ck < tl.k1; ++ck, ++wi) {
      const int ws_i = wi % p.ws;
      mbar_wait(&ready[ws_i], (wi / p.ws) & 1);
      const float* win = wins + ws_i * p.win_floats;
      // the slab of tap 0 of this chunk and its phase; the taps follow in order
      const int st0 = resident ? 0 : sj % p.ss, ph0 = resident ? (runs - 1) & 1 : (sj / p.ss) & 1;
      if (!resident) sj += 9;
      chunk_taps<BN, UP, KS>(p, win, slabs, slab_full, slab_empty, resident, st0, ph0, pr, pxl,
                             pxh, t, lane, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&win_empty[ws_i]);
    }
    // a run of resident slabs ends: the producer may load the next N tile's
    if (resident && (tt + 1 == t1 || tile_of(tt + 1, p).nt != tl.nt)) {
      __syncwarp();
      if (lane == 0)
        for (int tap = 0; tap < 9; ++tap) mbar_arrive(&slab_empty[tap]);
    }
    prev_nt = tl.nt;
    epilogue<BN, UP, EPI>(p, tl, acc, pr, pxl, pxh, cw, g, t);
  }
}

// Split K's second pass: the ksplit ranges' raw sums of each output element
// added in order, then the epilogue (OUT: bias and the residual; DX: dpre,
// dx and the patch's dA/dB column sums in a fixed order). A block owns 32
// channels of one patch of one image: thread (lane, row) walks the patch's
// pixels row, row + 8, ... Grid (ceil(cout / 32), patches, batch), 32 x 8.
constexpr int FIN_ROWS = 8;

template <int EPI>
__global__ void conv3x3_f32_finish(const float* __restrict__ ws, const Params p) {
  __shared__ float sa_rows[FIN_ROWS][32], sb_rows[FIN_ROWS][32];
  const int lane = threadIdx.x, row = threadIdx.y, patch = blockIdx.y, b = blockIdx.z;
  const int n = blockIdx.x * 32 + lane;
  const int y0 = (patch / p.tiles_x) * p.ph, x0 = (patch % p.tiles_x) * p.pw;
  const size_t plane = (size_t)p.batch * p.ho * p.wo * p.cout;
  float sa = 0.f, sb = 0.f, av = 0.f, bv = 0.f, bias = 0.f;
  if (n < p.cout) {
    if constexpr (EPI == EPI_DX) {
      av = p.A[(size_t)b * p.cout + n];
      bv = p.B[(size_t)b * p.cout + n];
    } else {
      bias = p.bias[n];
    }
    for (int px = row; px < p.ph * p.pw; px += FIN_ROWS) {
      const int oy = y0 + px / p.pw, ox = x0 + px % p.pw;
      if (oy >= p.ho || ox >= p.wo) continue;
      const size_t o = (((size_t)b * p.ho + oy) * p.wo + ox) * p.cout + n;
      float acc = 0.f;
      for (int s = 0; s < p.ksplit; ++s) acc += ws[s * plane + o];
      if constexpr (EPI == EPI_DX) {
        const float xs = p.xpre[o], pre = xs * av + bv, sg = sigmoid_f32(pre);
        const float dpre = acc * (sg * (1.f + pre * (1.f - sg)));
        p.out[o] = dpre * av;
        sa += dpre * xs;
        sb += dpre;
      } else {
        float v = acc + bias;
        if (p.skip != nullptr) v += p.skip[o];
        p.out[o] = v;
      }
    }
  }
  if constexpr (EPI == EPI_DX) {
    sa_rows[row][lane] = sa;
    sb_rows[row][lane] = sb;
    __syncthreads();
    if (row == 0 && n < p.cout) {
      float ta = 0.f, tb = 0.f;
      for (int r = 0; r < FIN_ROWS; ++r) {
        ta += sa_rows[r][lane];
        tb += sb_rows[r][lane];
      }
      const size_t base = ((size_t)b * gridDim.y + patch) * 2 * p.cout + n;
      p.partial[base] = ta;
      p.partial[base + p.cout] = tb;
    }
  }
}

// dA[b, c] / dB[b, c]: the per-patch partials of image b summed in a fixed
// order. A block owns 32 channels of one image: thread (lane, row) sums
// patches row, row + 32, ... of channel lane in order, then row 0 sums the
// 32 rows in order. 32 x 32 threads, grid (ceil(cx / 32), batch).
constexpr int RED_ROWS = 32;

__global__ void conv3x3_dx_f32_reduce(const float* __restrict__ partial, float* __restrict__ dA,
                                      float* __restrict__ dB, int patches, int cx) {
  __shared__ float sa_rows[RED_ROWS][32], sb_rows[RED_ROWS][32];
  const int lane = threadIdx.x, row = threadIdx.y, b = blockIdx.y;
  const int c = blockIdx.x * 32 + lane;
  float sa = 0.f, sb = 0.f;
  if (c < cx) {
    for (int t = row; t < patches; t += RED_ROWS) {
      const size_t base = ((size_t)b * patches + t) * 2 * cx + c;
      sa += partial[base];
      sb += partial[base + cx];
    }
  }
  sa_rows[row][lane] = sa;
  sb_rows[row][lane] = sb;
  __syncthreads();
  if (row == 0 && c < cx) {
    float ta = 0.f, tb = 0.f;
    for (int r = 0; r < RED_ROWS; ++r) {
      ta += sa_rows[r][lane];
      tb += sb_rows[r][lane];
    }
    dA[(size_t)b * cx + c] = ta;
    dB[(size_t)b * cx + c] = tb;
  }
}

// The weights split once per call: w [3, 3, cin, cout] HWIO -> ws [2, 9,
// cout8, cink] K-major (cout8, cink: cout and cin rounded up to 8 and 16), a
// row per output channel, its channels placed by channel_at; ws[0] the TF32
// rounding hi of w, ws[1] the TF32 rounding of w - hi (split_tf32); rows
// past cout and channels past cin are 0. A block transposes a 32 x 32 tile of
// one tap through shared memory (reads along cout, writes along the row).
__global__ void conv3x3_f32_split_weights(const float* __restrict__ w, float* __restrict__ out,
                                          int cin, int cout, int cout8, int cink) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, n0 = blockIdx.y * 32, tap = blockIdx.z;
  for (int k = threadIdx.y; k < 32; k += 8) {  // load: channel c0 + k, outputs n0 + lane
    const int c = c0 + k, n = n0 + threadIdx.x;
    tile[k][threadIdx.x] = (c < cin && n < cout) ? w[((size_t)tap * cin + c) * cout + n] : 0.f;
  }
  __syncthreads();
  const size_t half = (size_t)9 * cout8 * cink;
  for (int k = threadIdx.y; k < 32; k += 8) {  // store: row n0 + k, positions c0 + lane
    const int n = n0 + k, pos = c0 + threadIdx.x;
    if (n >= cout8 || pos >= cink) continue;
    const float v = tile[channel_at(threadIdx.x, cin)][k];
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const size_t o = ((size_t)tap * cout8 + n) * cink + pos;
    out[o] = __uint_as_float(hi);
    out[half + o] = __uint_as_float(lo);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// [batch, rows, w, cin] f32 as the 4-D map {cin, w, rows, batch}, boxes of 32
// channels x wc columns x 1 x 1, 128B-swizzled, zero-filled outside.
static int map_image(CUtensorMap* m, const void* ptr, int batch, int rows, int w, int cin, int wc) {
  EncodeTiledFn f;
  if (int st = encode_fn(&f)) return st;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 4, (cuuint64_t)w * cin * 4,
                                 (cuuint64_t)rows * w * cin * 4};
  const cuuint32_t box[4] = {32, (cuuint32_t)wc, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides,
                       box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// the split weights [18, cout8, cink] as the 3-D map {cink, cout8, 18},
// boxes of 32 channels x bn rows x 1, 128B-swizzled
static int map_weights(CUtensorMap* m, const void* ptr, int cink, int cout8, int bn) {
  EncodeTiledFn f;
  if (int st = encode_fn(&f)) return st;
  const cuuint64_t dims[3] = {(cuuint64_t)cink, (cuuint64_t)cout8, 18};
  const cuuint64_t strides[2] = {(cuuint64_t)cink * 4, (cuuint64_t)cout8 * cink * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)bn, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
                       box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

inline int cout8_of(int cout) { return (cout + 7) / 8 * 8; }

// the current device's SMs (read once per device)
static int sms() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return count[dev];
}

static int split_weights(const void* w, void* wsplit, int cin, int cout, cudaStream_t s) {
  const int cout8 = cout8_of(cout), cink = cin_k(cin);
  conv3x3_f32_split_weights<<<dim3((cink + 31) / 32, (cout8 + 31) / 32, 9), dim3(32, 8), 0,
                              s>>>(static_cast<const float*>(w), static_cast<float*>(wsplit),
                                   cin, cout, cout8, cink);
  return (int)cudaGetLastError();
}

template <int BN, int KS, bool UP, int EPI>
static int launch_main(const Plan& pl, const CUtensorMap& xm, const CUtensorMap& tm,
                       const CUtensorMap& bm, const CUtensorMap& wm, const Params& p,
                       cudaStream_t s) {
  auto kernel = conv3x3_f32_kernel<BN, KS, UP, EPI>;
  // the plan's largest dynamic shared memory, allowed once per kernel
  static const cudaError_t ok = allow_smem(kernel, SMEM_MAX - STATIC_RESERVE);
  if (ok != cudaSuccess) return (int)ok;
  kernel<<<pl.blocks, THREADS, pl.smem, s>>>(xm, tm, bm, wm, p);
  return (int)cudaGetLastError();
}

template <bool UP, int EPI>
static int launch_bn(const Plan& pl, const CUtensorMap& xm, const CUtensorMap& tm,
                     const CUtensorMap& bm, const CUtensorMap& wm, const Params& p,
                     cudaStream_t s) {
#define CGD_KS(BN)                                                                       \
  return pl.ks == 1   ? launch_main<BN, 1, UP, EPI>(pl, xm, tm, bm, wm, p, s)                \
         : pl.ks == 2 ? launch_main<BN, 2, UP, EPI>(pl, xm, tm, bm, wm, p, s)                \
                      : launch_main<BN, 4, UP, EPI>(pl, xm, tm, bm, wm, p, s);
  if (pl.bn == 8) CGD_KS(8)
  CGD_KS(64)
#undef CGD_KS
}

static Params params_of(const Plan& pl, int batch, int h, int wd, int cin, int cout, bool pro,
                        bool halo) {
  Params p{};
  p.batch = batch, p.h = h, p.wd = wd, p.cin = cin, p.cout = cout, p.ho = pl.ho, p.wo = pl.wo;
  p.ph = pl.ph, p.pw = pl.pw, p.tiles_x = pl.tiles_x, p.wr = pl.wr, p.wc = pl.wc;
  p.slot_lines = pl.slot / 128, p.chunks = pl.chunks, p.ksplit = pl.ksplit;
  p.ws = pl.ws, p.ss = pl.ss, p.win_floats = pl.wr * pl.slot / 4;
  p.patches = pl.patches, p.tiles = pl.tiles, p.pro = pro, p.halo = halo;
  return p;
}

// The main launch and, with split K, the finish; for K-dx (dx != 0) then the
// dA/dB reduce.
static int run(const Plan& pl, const void* x, const void* etop, const void* ebot,
               const void* wsplit, Params p, bool up, bool dx, float* out, float* ws,
               float* dA, float* dB, cudaStream_t s) {
  CUtensorMap xm, tm, bm, wm;
  if (int st = map_image(&xm, x, p.batch, p.h, p.wd, p.cin, pl.wc)) return st;
  tm = bm = xm;
  if (p.halo) {
    if (int st = map_image(&tm, etop, p.batch, 1, p.wd, p.cin, pl.wc)) return st;
    if (int st = map_image(&bm, ebot, p.batch, 1, p.wd, p.cin, pl.wc)) return st;
  }
  if (int st = map_weights(&wm, wsplit, cin_k(p.cin), cout8_of(p.cout), pl.bn)) return st;
  const int batch = p.batch;
  if (pl.ksplit > 1) {
    Params q = p;
    q.out = ws;
    const int st = up ? launch_bn<true, EPI_PART>(pl, xm, tm, bm, wm, q, s)
                      : launch_bn<false, EPI_PART>(pl, xm, tm, bm, wm, q, s);
    if (st) return st;
    p.out = out;
    const dim3 grid((p.cout + 31) / 32, pl.patches, batch), block(32, FIN_ROWS);
    if (dx)
      conv3x3_f32_finish<EPI_DX><<<grid, block, 0, s>>>(ws, p);
    else
      conv3x3_f32_finish<EPI_OUT><<<grid, block, 0, s>>>(ws, p);
    if (cudaError_t err = cudaGetLastError()) return (int)err;
  } else {
    p.out = out;
    const int st = dx ? launch_bn<false, EPI_DX>(pl, xm, tm, bm, wm, p, s)
                   : up ? launch_bn<true, EPI_OUT>(pl, xm, tm, bm, wm, p, s)
                        : launch_bn<false, EPI_OUT>(pl, xm, tm, bm, wm, p, s);
    if (st) return st;
  }
  if (dx) {
    conv3x3_dx_f32_reduce<<<dim3((p.cout + 31) / 32, batch), dim3(32, RED_ROWS), 0, s>>>(
        p.partial, dA, dB, pl.patches, p.cout);
    return (int)cudaGetLastError();
  }
  return 0;
}

// the geometry the caller planned (bn, ph, ksplit) against this build's
static bool plan_matches(const Plan& pl, int bn, int ph, int ksplit) {
  // one chunk keeps its nine weight slabs resident: the ring must hold them
  return pl.bn == bn && pl.ph == ph && pl.ksplit == ksplit && (pl.chunks > 1 || pl.ss >= 9);
}

}  // namespace f32conv
}  // namespace cgd

// K-fwd f32 (K-halo f32 with etop / ebot). x [batch, h, w, cin] f32; w [3,
// 3, cin, cout] f32 (HWIO); bias [cout] f32; A, Bv [batch, cin] f32 (the
// prologue) or both null; skip [batch, ho, wo, cout] f32 or null; up != 0:
// nearest-2x between the activation and the taps (needs A/Bv, takes no skip
// and no halo); etop, ebot [batch, 1, w, cin] f32, both or neither: the
// (activated) rows above and below x -> out [batch, ho, wo, cout] f32, (ho,
// wo) = (2h, 2w) with up. wsplit: [2, 9, cout8, cink] f32 scratch (cout8,
// cink = cout, cin rounded up to 8, 16) for the split weights; ws: [ksplit, batch, ho, wo,
// cout] f32 scratch, or null when ksplit is 1. bn, ph, ksplit: the caller's
// plan (kernels/conv3x3.py f32_plan), checked against this build's. Requires
// cin % 4 == 0, cout % 4 == 0 and 16-byte aligned pointers. Returns the
// launch status (a cudaError_t, or ENCODE_ERROR + a CUresult).
extern "C" int cgd_conv3x3_f32(const void* x, const void* w, const void* bias, const void* A,
                               const void* Bv, const void* skip, const void* etop,
                               const void* ebot, void* out, void* wsplit, void* ws, int batch,
                               int h, int wd, int cin, int cout, int up, int bn, int ph,
                               int ksplit, void* stream) {
  using namespace cgd::f32conv;
  const bool pro = A != nullptr, halo = etop != nullptr;
  if (batch <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || cin % 4 || cout % 4 ||
      pro != (Bv != nullptr) || (up && (!pro || skip != nullptr)) ||
      halo != (ebot != nullptr) || (halo && up))
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(batch, h, wd, cin, cout, up != 0, sms());
  if (!plan_matches(pl, bn, ph, ksplit) || (pl.ksplit > 1) != (ws != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int st = split_weights(w, wsplit, cin, cout, s)) return st;
  Params p = params_of(pl, batch, h, wd, cin, cout, pro, halo);
  p.bias = static_cast<const float*>(bias);
  p.A = static_cast<const float*>(A);
  p.B = static_cast<const float*>(Bv);
  p.skip = static_cast<const float*>(skip);
  return run(pl, x, etop, ebot, wsplit, p, up != 0, false, static_cast<float*>(out),
             static_cast<float*>(ws), nullptr, nullptr, s);
}

// K-dx f32. g [batch, h, w, cg] f32 cotangent; wt [3, 3, cg, cx] f32 (the
// forward weight flipped in both taps, channel axes swapped); x [batch, h,
// w, cx] f32 pre-activation input; A, Bv [batch, cx] f32 -> dx [batch, h, w,
// cx] f32, dA, dB [batch, cx] f32. wsplit [2, 9, cx8, cg16] and ws [ksplit,
// batch, h, w, cx] (or null) f32 scratch as for cgd_conv3x3_f32; partial:
// [batch, patches, 2, cx] f32 scratch (the plan's partial rows). bn, ph,
// ksplit: the caller's plan, checked. Requires cg % 4 == 0, cx % 4 == 0,
// 16-byte aligned pointers. Launches: the weight split, the conv with its
// epilogue (with split K: the conv's ranges, then the finish), then the
// fixed-order dA/dB sum. Returns the launch status.
extern "C" int cgd_conv3x3_dx_f32(const void* g, const void* wt, const void* x, const void* A,
                                  const void* Bv, void* dx, void* wsplit, void* ws,
                                  void* partial, void* dA, void* dB, int batch, int h, int wd,
                                  int cg, int cx, int bn, int ph, int ksplit, void* stream) {
  using namespace cgd::f32conv;
  if (batch <= 0 || h <= 0 || wd <= 0 || cg <= 0 || cx <= 0 || cg % 4 || cx % 4)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(batch, h, wd, cg, cx, false, sms());
  if (!plan_matches(pl, bn, ph, ksplit) || (pl.ksplit > 1) != (ws != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int st = split_weights(wt, wsplit, cg, cx, s)) return st;
  Params p = params_of(pl, batch, h, wd, cg, cx, false, false);
  p.A = static_cast<const float*>(A);
  p.B = static_cast<const float*>(Bv);
  p.xpre = static_cast<const float*>(x);
  p.partial = static_cast<float*>(partial);
  return run(pl, g, nullptr, nullptr, wsplit, p, false, true, static_cast<float*>(dx),
             static_cast<float*>(ws), static_cast<float*>(dA), static_cast<float*>(dB), s);
}

// The weight split alone (w [3, 3, cin, cout] -> wsplit [2, 9, cout8, cink]),
// for the card test against its plain version. Returns the launch status.
extern "C" int cgd_conv3x3_f32_split(const void* w, void* wsplit, int cin, int cout,
                                     void* stream) {
  if (cin <= 0 || cout <= 0 || cin % 4 || cout % 4) return (int)cudaErrorInvalidValue;
  return cgd::f32conv::split_weights(w, wsplit, cin, cout, static_cast<cudaStream_t>(stream));
}

// The plan of one call on the current device, what f32_plan computes:
// out[0..17] = bn, ph, pw, k8 steps, chunks, ksplit, window stages, slab stages,
// dynamic shared memory, patches, threads, window rows, window cols, slot
// bytes, the shared memory a block may take (227 KB less the static
// reserve), the device's SMs, tiles, blocks.
extern "C" int cgd_conv3x3_f32_plan(int batch, int h, int wd, int cin, int cout, int up,
                                    int* out) {
  using namespace cgd::f32conv;
  const int n = sms();
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(batch, h, wd, cin, cout, up != 0, n);
  const int v[18] = {pl.bn, pl.ph, pl.pw, pl.ks, pl.chunks, pl.ksplit, pl.ws, pl.ss, pl.smem,
                     pl.patches, THREADS, pl.wr, pl.wc, pl.slot, SMEM_MAX - STATIC_RESERVE, n,
                     pl.tiles, pl.blocks};
  for (int i = 0; i < 18; ++i) out[i] = v[i];
  return 0;
}
