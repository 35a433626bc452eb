// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel source in this directory is compiled separately with
// `nvcc -gencode arch=compute_90a,code=sm_90a` and linked into one shared
// library with a plain C interface (kernels/build.py).  Each `extern "C"`
// entry launches on the caller's stream, allocates nothing, and returns
// `cudaGetLastError()` so that a refused launch surfaces in the wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// The reference's finite mask value (repro layers/attention.py NEG_INF):
// fully masked rows stay finite and softmax to a uniform row.
#define RT_NEG_INF (-2.3819763e38f)

// dtype codes passed from Python (kernels/build.py DTYPE_CODES)
enum RtDType { RT_F32 = 0, RT_BF16 = 1 };

__device__ __forceinline__ float rt_to_f32(float x) { return x; }
__device__ __forceinline__ float rt_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T rt_from_f32(float x);
template <>
__device__ __forceinline__ float rt_from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 rt_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch casts
}

// x rounded to T and widened back: where the reference casts an
// intermediate to the input dtype before using it again.
template <typename T>
__device__ __forceinline__ float rt_round(float x) {
  return rt_to_f32(rt_from_f32<T>(x));
}

__device__ __forceinline__ float rt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float rt_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Runs the statement given after `T` with `T` bound to the element type named by `code`.
#define RT_DISPATCH(code, T, ...)              \
  switch (code) {                              \
    case RT_F32: {                             \
      using T = float;                         \
      __VA_ARGS__;                             \
      break;                                   \
    }                                          \
    case RT_BF16: {                            \
      using T = __nv_bfloat16;                 \
      __VA_ARGS__;                             \
      break;                                   \
    }                                          \
    default:                                   \
      return (int)cudaErrorInvalidValue;       \
  }
