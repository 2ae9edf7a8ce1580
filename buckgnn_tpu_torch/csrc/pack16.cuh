// 16 bytes of a row as floats: the vector loads and stores of the
// elementwise and gather kernels (csr_segment.cu, epilogue.cu). N values
// of T per 16 bytes; `round` is the rounding of an f32 value to T (as a
// float), `one` that value as a T.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pack16 {

template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* a) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      a[2 * i] = f.x;
      a[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* a) {
    uint4 v;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
    return v;
  }
  __device__ __forceinline__ static float round(float a) {
    return __bfloat162float(__float2bfloat16_rn(a));
  }
  __device__ __forceinline__ static __nv_bfloat16 one(float a) {
    return __float2bfloat16_rn(a);
  }
};

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* a) {
    a[0] = __uint_as_float(v.x);
    a[1] = __uint_as_float(v.y);
    a[2] = __uint_as_float(v.z);
    a[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* a) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                      __float_as_uint(a[2]), __float_as_uint(a[3]));
  }
  __device__ __forceinline__ static float round(float a) { return a; }
  __device__ __forceinline__ static float one(float a) { return a; }
};

}  // namespace pack16
