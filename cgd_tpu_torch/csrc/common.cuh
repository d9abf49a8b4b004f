// Small device helpers shared by the port's kernels: bf16 packing,
// cp.async copies, and the 3xTF32 pieces of the f32 kernels (the operand
// split and mma.sync at TF32).
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

// --- 3xTF32 ----------------------------------------------------------------
// An f32 operand x is split into a TF32 high part hi and a residual lo, and
// a product is lo*hi + hi*lo + hi*hi on the TF32 tensor cores (the lo*lo
// term left out): f32's precision at three MMAs.

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(f));
  return u;
}

// f = hi + lo + O(2^-22 |f|): hi its TF32 rounding (an f32 bit pattern with
// the low 13 mantissa bits zero), lo the TF32 rounding of what is left
__device__ __forceinline__ void split_tf32(float f, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(f);
  lo = to_tf32(f - __uint_as_float(hi));
}

// The same split in two instructions, no conversion: hi is x with its 13 low
// mantissa bits cleared (TF32 by truncation), lo = x - hi exactly in f32,
// |lo| < 2^-10 |x|, passed with its low bits set: the tensor cores read a
// TF32 operand's top 19 bits and drop the rest, so lo loses less than 2^-10
// of itself, 2^-20 |x|.
__device__ __forceinline__ void split_tf32_trunc(float f, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(f) & 0xffffe000u;
  lo = __float_as_uint(f - __uint_as_float(hi));
}

// c += a.b on one m16n8k8 TF32 tile (row-major A fragment, column-major B)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace cgd
