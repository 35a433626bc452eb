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

// 16 bytes of T as f32 values
template <typename T>
struct RtVec16;

template <>
struct RtVec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct RtVec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {          // bf16 is the high half of f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Warp reduce-scatter of V values a lane (V a power of two, >= 32): on
// return, v[q] for q < V / 32 holds the sum over the warp's 32 lanes of
// value lane * (V / 32) + q.  V - V / 32 shuffles in all, against 5 V for a
// butterfly sum of every value.
template <int H>
__device__ __forceinline__ void rt_reduce_scatter_step(float* v, int lane,
                                                       int o) {
  const bool hi = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = hi ? v[i] : v[i + H];
    const float keep = hi ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

template <int V>
__device__ __forceinline__ void rt_warp_reduce_scatter(float (&v)[V],
                                                       int lane) {
  static_assert(V >= 32 && (V & (V - 1)) == 0, "V: a power of two >= 32");
  rt_reduce_scatter_step<V / 2>(v, lane, 16);
  rt_reduce_scatter_step<V / 4>(v, lane, 8);
  rt_reduce_scatter_step<V / 8>(v, lane, 4);
  rt_reduce_scatter_step<V / 16>(v, lane, 2);
  rt_reduce_scatter_step<V / 32>(v, lane, 1);
}

static inline bool rt_aligned(const void* p, int bytes = 16) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Shared-memory address, cp.async, ldmatrix and mma.sync (bf16 in, f32
// accumulate) for the kernels that use the tensor cores.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool fill) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
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
