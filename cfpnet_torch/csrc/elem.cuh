// Element types of the kernels' inputs and outputs: f32, or bf16 computed in
// f32. A kernel is a template on T = float or __nv_bfloat16; it loads four
// elements at a time into a float4 (16 bytes of f32, 8 of bf16), does its
// arithmetic in f32, and rounds back to T where it stores. bf16 to f32 is
// exact (the 16 bits shifted up); f32 to bf16 rounds to nearest even, as
// torch's .to(torch.bfloat16) does.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace cfp {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and read back as f32: x itself for f32
template <class T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// elements p[0..3], p 16-byte (f32) or 8-byte (bf16) aligned, read through
// the read-only cache
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

}  // namespace cfp
