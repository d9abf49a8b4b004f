// K-warp-b: the backward of the augmentation warp's bilinear sampling, for
// sm_90a, with no atomics.
//
// Replaces no Pallas kernel. The JAX package warps each augmented cutout
// with jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")
// (cgd_tpu/guidance/cutouts.py:151), whose transpose XLA lowers to a
// scatter that is deterministic on the TPU and the CPU. The port's forward
// gathers four taps (kernels/warp.py), and autograd's backward of a gather
// on a card is scatter_add_ with float atomics: the order of the additions,
// and so the rounded gradient, changes from run to run, and a resumed
// use_augs run could not equal the uninterrupted one.
//
// The (tap, output pixel) pairs come sorted by the key
// cutout * h * w + source pixel, in a stable order (kernels/warp.py
// warp_index, once per call), with each segment's start in `offsets`; a
// pair's entry `pair` is tap * nsrc + output pixel. One thread per (source
// pixel, channel) walks its segment in that order and keeps one sum per tap,
//   S_t = sum_j w[j] * g[output pixel of j, ch]   over the pairs j of tap t,
// each product rounded, then added in f32 (no FMA contraction), and writes
// dx = ((S3 + S2) + S1) + S0: the order of a gather's autograd backward on
// the CPU (each tap's scatter in output order, the taps' gradients summed
// from the last), and of the plain version. The kernel, the plain version
// run on the CPU and that backward agree bit for bit on the same inputs, and
// reruns are identical.
//
// Bound: bytes. It reads g (n*h*w*c f32), the sorted weights and pairs
// (4*n*h*w each, f32 and int32) and the segment starts, and writes dx
// (n*h*w*c f32): a few FLOPs a byte. Design: the three channel threads of a
// pixel are neighbours and read the same index entries; most segments hold
// four pairs or fewer, the clamped border's pixels collect up to ~22 rows or
// columns of samples, and their threads run long (a segment is not split:
// that would need a second pass to keep the order fixed).
#include <cuda_runtime.h>

namespace cgd {

__global__ void warp_bwd_kernel(const float* __restrict__ g, const float* __restrict__ w,
                                const int* __restrict__ pair, const int* __restrict__ offsets,
                                float* __restrict__ dx, int nsrc, int c) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nsrc * c) return;
  const int s = (int)(t / c), ch = (int)(t - (long long)s * c);
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int end = offsets[s + 1];
  for (int j = offsets[s]; j < end; ++j) {
    const int q = pair[j], tap = q / nsrc;
    const float v = __fmul_rn(w[j], g[(long long)(q - tap * nsrc) * c + ch]);
#pragma unroll
    for (int k = 0; k < 4; ++k)  // registers, not a local array indexed at run time
      if (k == tap) sum[k] = __fadd_rn(sum[k], v);
  }
  dx[t] = __fadd_rn(__fadd_rn(__fadd_rn(sum[3], sum[2]), sum[1]), sum[0]);
}

}  // namespace cgd

// g, dx: [nsrc, c] f32; w, pair: [4 * nsrc] f32 and int32 (pair: tap * nsrc
// + output pixel); offsets: [nsrc + 1] int32.
extern "C" int cgd_warp_bwd(const void* g, const void* w, const void* pair, const void* offsets,
                            void* dx, int nsrc, int c, void* stream) {
  if (nsrc <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = (long long)nsrc * c;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cgd::warp_bwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(w), static_cast<const int*>(pair),
      static_cast<const int*>(offsets), static_cast<float*>(dx), nsrc, c);
  return (int)cudaGetLastError();
}
