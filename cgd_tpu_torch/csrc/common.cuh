// Small device helpers shared by the port's kernels: bf16 packing and
// cp.async copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cgd {

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  float2 a = unpack_bf16x2(u.x), b = unpack_bf16x2(u.y);
  float2 c = unpack_bf16x2(u.z), d = unpack_bf16x2(u.w);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  u.x = pack_bf16x2(f[0], f[1]);
  u.y = pack_bf16x2(f[2], f[3]);
  u.z = pack_bf16x2(f[4], f[5]);
  u.w = pack_bf16x2(f[6], f[7]);
  return u;
}

// 16-byte global -> shared copy; when !pred the destination is zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace cgd
