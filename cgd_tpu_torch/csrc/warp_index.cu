// K-warp-i: the index K-warp-b reads (kernels/warp.py warp_index), built on
// the card as a stable counting sort, for sm_90a.
//
// Replaces no Pallas kernel: the port's own, beside K-warp-b (see
// warp_bwd.cu). The warp's 4 * n * h * w (tap, output pixel) pairs, in their
// order i = tap * nsrc + output pixel, are sorted stably by their bin
// (cutout * h * w + source pixel) * 4 + tap: each bin's pairs keep their
// output pixel order. The plain version is a library sort (torch.sort,
// stable) with a histogram; this kernel gives the same index bit for bit.
//
// Bound: bytes. It reads the taps' source pixels (int64) and weights once
// and writes the sorted pairs and weights; the bins' starts come from a
// histogram and an exclusive scan. A library radix sort of the 22-bit keys
// makes four passes over 32 bits with 64-bit values (0.21 ms at 16 cutouts
// of 224^2 on an H100 80GB HBM3 at 700 W). Here each step is one pass, the
// bins being as many as the pairs (one pair a bin on average):
//  1. count: each pair takes a slot in its bin with an integer atomic (the
//     counts, and so the starts, do not depend on the order; the slots do);
//  2. (the wrapper: an exclusive scan of the counts, the bins' starts);
//  3. place: each pair's original position goes to its bin's start + slot:
//     every bin now holds its pairs, in an order that varies from run to run;
//  4. rank: each pair's rank in its bin is the number of the bin's pairs
//     with a smaller original position (a bin is read whole by each of its
//     pairs: most hold one pair, a clamped corner's up to ~1,200, read from
//     cache by a warp at once), and the pair and its weight are written at
//     the bin's start + rank. That is the stable order, whatever the slots.
// Then the long segments' list, a stable partition of the source pixels
// (those whose four bins hold more than long_pairs pairs first), in two
// passes over blocks of PIX pixels: each block counts its long ones; each
// block then sums the counts before it (and all of them: n_long), ranks its
// pixels by a block scan, and writes each to its place.
#include <cuda_runtime.h>

namespace cgd {
namespace warpi {

constexpr int TAPS = 4;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) count_kernel(const long long* __restrict__ idx,
                                                        int* __restrict__ bins,
                                                        int* __restrict__ slot,
                                                        int* __restrict__ counts, int pairs,
                                                        int nsrc, int hw) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= pairs) return;
  const int tap = i / nsrc, q = i - tap * nsrc;
  const int bin = ((q / hw) * hw + (int)idx[i]) * TAPS + tap;
  bins[i] = bin;
  slot[i] = atomicAdd(counts + bin, 1);
}

__global__ void __launch_bounds__(THREADS) place_kernel(const int* __restrict__ bins,
                                                        const int* __restrict__ slot,
                                                        const int* __restrict__ offsets,
                                                        int* __restrict__ held, int pairs) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= pairs) return;
  held[offsets[bins[i]] + slot[i]] = i;
}

__global__ void __launch_bounds__(THREADS) rank_kernel(const int* __restrict__ held,
                                                       const int* __restrict__ bins,
                                                       const int* __restrict__ offsets,
                                                       const float* __restrict__ weight,
                                                       int* __restrict__ pair,
                                                       float* __restrict__ weight_out, int pairs,
                                                       int nsrc) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= pairs) return;
  const int i = held[j], bin = bins[i];
  const int lo = offsets[bin], hi = offsets[bin + 1];
  int rank = 0;
  for (int k = lo; k < hi; ++k) rank += held[k] < i;
  pair[lo + rank] = i - (bin % TAPS) * nsrc;
  weight_out[lo + rank] = weight[i];
}

constexpr int PER_THREAD = 4;                 // pixels a thread classes
constexpr int PIX = THREADS * PER_THREAD;      // pixels a block classes

// how many of this thread's pixels (base + k, k < PER_THREAD) are long
__device__ __forceinline__ unsigned long_flags(const int* __restrict__ offsets, int base,
                                               int nsrc, int long_pairs) {
  unsigned flags = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int s = base + k;
    if (s < nsrc && offsets[(s + 1) * TAPS] - offsets[s * TAPS] > long_pairs) flags |= 1u << k;
  }
  return flags;
}

// the sum over the block of v; every thread gets it
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += scratch[w];
  return total;
}

__global__ void __launch_bounds__(THREADS) long_count_kernel(const int* __restrict__ offsets,
                                                             int* __restrict__ block_counts,
                                                             int nsrc, int long_pairs) {
  __shared__ int scratch[THREADS / 32];
  const int base = blockIdx.x * PIX + threadIdx.x * PER_THREAD;
  const int n = block_sum(__popc(long_flags(offsets, base, nsrc, long_pairs)), scratch);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = n;
}

__global__ void __launch_bounds__(THREADS) long_place_kernel(
    const int* __restrict__ offsets, const int* __restrict__ block_counts,
    int* __restrict__ long_list, int* __restrict__ n_long, int nsrc, int long_pairs,
    int blocks) {
  __shared__ int scratch[THREADS / 32];
  __shared__ int warp_before[THREADS / 32];
  int before = 0, all = 0;  // this thread's share of the blocks' counts
  for (int b = threadIdx.x; b < blocks; b += THREADS) {
    const int v = block_counts[b];
    all += v;
    if (b < (int)blockIdx.x) before += v;
  }
  before = block_sum(before, scratch);  // long pixels in the blocks before this one
  all = block_sum(all, scratch);        // in every block: n_long
  const int base = blockIdx.x * PIX + threadIdx.x * PER_THREAD;
  const unsigned flags = long_flags(offsets, base, nsrc, long_pairs);
  // this thread's long pixels before it in the block: a warp scan, then
  // the warps before it
  const int mine = __popc(flags), lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_before[warp] = incl;
  __syncthreads();
  int rank = before + incl - mine;
  for (int w = 0; w < warp; ++w) rank += warp_before[w];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int s = base + k;
    if (s >= nsrc) break;
    if (flags >> k & 1u) {
      long_list[rank++] = s;
    } else {
      long_list[all + s - rank] = s;  // after the long ones: s minus the long ones before it
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_long = all;
}

inline unsigned blocks_for(int pairs) { return (unsigned)((pairs + THREADS - 1) / THREADS); }

}  // namespace warpi
}  // namespace cgd

// idx: [4 * nsrc] int64, each (tap, output pixel)'s source pixel in
// [0, hw); bins, slot: [4 * nsrc] int32 scratch; counts: [4 * nsrc] int32,
// zero on entry, the bins' sizes on return.
extern "C" int cgd_warp_index_count(const void* idx, void* bins, void* slot, void* counts,
                                    int nsrc, int hw, void* stream) {
  using namespace cgd::warpi;
  if (nsrc <= 0 || hw <= 0 || nsrc % hw) return (int)cudaErrorInvalidValue;
  const int pairs = TAPS * nsrc;
  count_kernel<<<blocks_for(pairs), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(idx), static_cast<int*>(bins), static_cast<int*>(slot),
      static_cast<int*>(counts), pairs, nsrc, hw);
  return (int)cudaGetLastError();
}

// offsets: [4 * nsrc + 1] int32, the exclusive scan of the counts; held:
// [4 * nsrc] int32 scratch; weight: [4 * nsrc] f32 in pair order -> pair,
// weight_out: [4 * nsrc], sorted stably by bin.
extern "C" int cgd_warp_index_sort(const void* bins, const void* slot, const void* offsets,
                                   void* held, const void* weight, void* pair, void* weight_out,
                                   int nsrc, void* stream) {
  using namespace cgd::warpi;
  if (nsrc <= 0) return (int)cudaErrorInvalidValue;
  const int pairs = TAPS * nsrc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  place_kernel<<<blocks_for(pairs), THREADS, 0, s>>>(
      static_cast<const int*>(bins), static_cast<const int*>(slot),
      static_cast<const int*>(offsets), static_cast<int*>(held), pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rank_kernel<<<blocks_for(pairs), THREADS, 0, s>>>(
      static_cast<const int*>(held), static_cast<const int*>(bins),
      static_cast<const int*>(offsets), static_cast<const float*>(weight),
      static_cast<int*>(pair), static_cast<float*>(weight_out), pairs, nsrc);
  return (int)cudaGetLastError();
}

// The length of cgd_warp_index_long's block_counts scratch for nsrc source
// pixels: one entry per block of PIX pixels.
extern "C" int cgd_warp_index_long_blocks(int nsrc) {
  using namespace cgd::warpi;
  return nsrc <= 0 ? 0 : (nsrc + PIX - 1) / PIX;
}

// offsets: [4 * nsrc + 1] int32, the bins' starts; block_counts:
// [cgd_warp_index_long_blocks(nsrc)] int32 scratch -> long_list: [nsrc] int32, the source
// pixels whose segment holds more than long_pairs pairs, ascending, then
// the others, ascending; n_long: [1] int32, how many are long.
extern "C" int cgd_warp_index_long(const void* offsets, void* block_counts, void* long_list,
                                   void* n_long, int nsrc, int long_pairs, void* stream) {
  using namespace cgd::warpi;
  if (nsrc <= 0 || long_pairs < 0) return (int)cudaErrorInvalidValue;
  const int blocks = cgd_warp_index_long_blocks(nsrc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long_count_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const int*>(offsets),
                                               static_cast<int*>(block_counts), nsrc, long_pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long_place_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(block_counts),
      static_cast<int*>(long_list), static_cast<int*>(n_long), nsrc, long_pairs, blocks);
  return (int)cudaGetLastError();
}
