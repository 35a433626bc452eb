// Residual add + RMSNorm over rows, shared by residual_rmsnorm.cu (the
// fused pair's kernel) and rmsnorm.cu (the legacy two-output kernel).
//
// Per row of x (N, D): s = x + r in f32 (r optional), then
// normed = s * rsqrt(mean(s^2) + eps) * w from the unrounded f32 sum, and
// writes normed and (only with a residual) s, each cast to x's dtype.
//
// Bound on Hopper: bytes.  A row does 4D flops against 3-4 D-element
// loads/stores, far below the card's ~295 flop/byte balance point.  At the
// decode shapes (N <= max_batch rows of D = 960 or 2560) the whole call
// moves a few tens of KB, so one launch costs more than the bound.  Design:
// one CTA per row (the TPU kernel's row block becomes a block reduction),
// so a row is read once for the statistics and once more, from L1/L2, to
// normalise; no intermediate goes to device memory and one launch replaces
// the add, square, mean, rsqrt and two multiplies of the unfused path.
#pragma once

#include "common.cuh"

template <typename T>
__global__ void residual_rmsnorm_kernel(const T* __restrict__ x,
                                        const T* __restrict__ r,
                                        const T* __restrict__ w,
                                        T* __restrict__ out,
                                        T* __restrict__ sum_out, int d,
                                        float eps) {
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const T* xr = x + base;
  const T* rr = r != nullptr ? r + base : nullptr;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float s = rt_to_f32(xr[i]);
    if (rr != nullptr) s += rt_to_f32(rr[i]);
    ss += s * s;
  }
  ss = rt_block_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float s = rt_to_f32(xr[i]);
    if (rr != nullptr) s += rt_to_f32(rr[i]);
    out[base + i] = rt_from_f32<T>(s * inv * rt_to_f32(w[i]));
    if (rr != nullptr) sum_out[base + i] = rt_from_f32<T>(s);
  }
}

// x, r, out, sum_out: (n, d) contiguous; w: (d,).  r and sum_out may both
// be null (the bare-norm form writes only `out`).
static inline int residual_rmsnorm_run(const void* x, const void* r,
                                       const void* w, void* out,
                                       void* sum_out, int n, int d,
                                       float eps, int dtype, void* stream) {
  if (n <= 0 || d <= 0 || (r == nullptr) != (sum_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = d >= 1024 ? 256 : (d >= 256 ? 128 : 64);
  auto st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(dtype, T,
              residual_rmsnorm_kernel<T><<<n, threads, 0, st>>>(
                  static_cast<const T*>(x), static_cast<const T*>(r),
                  static_cast<const T*>(w), static_cast<T*>(out),
                  static_cast<T*>(sum_out), d, eps));
  return static_cast<int>(cudaGetLastError());
}
