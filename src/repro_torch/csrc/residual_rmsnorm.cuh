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
// moves a few tens of KB, so one launch costs more than the bound, and what
// is left above the empty-kernel floor is memory latency: the kernel is
// built to wait for one HBM round trip, not two.
//  * Every global load of a row (x, r and w) is issued at once, as 16-byte
//    vectors (8 bf16 or 4 f32 a thread), before the reduction; the row and
//    the weight stay in registers until the store, so no input is read
//    twice and w is not a second dependent round trip after the sum.
//  * One CTA per row, of one warp at the port's widths (up to 32 x 10
//    vectors: D 2560 in bf16, 1280 in f32), whose sum is warp shuffles only,
//    with no barrier.  Wider rows take up to 256 threads (D up to 20480
//    bf16, 10240 f32), with one shared-memory exchange for the sum.
//  * Normalised rows leave as 16-byte stores.  Where D is not a multiple of
//    the vector width or a pointer is not 16-byte aligned, the same kernel
//    loads and stores element by element (w then read after the sum).
#pragma once

#include "common.cuh"

constexpr int NORM_MAX_THREADS = 256;  // threads of one row, at most
constexpr int NORM_MAX_NV = 10;        // 16-byte vectors a thread, at most

// Row blockIdx.x, over blockDim.x threads (a multiple of 32, at most
// NORM_MAX_THREADS); vec: every row start and w 16-byte aligned and d a
// multiple of the vector width.
template <typename T, int NV>
__global__ void __launch_bounds__(NORM_MAX_THREADS)
residual_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                        const T* __restrict__ w, T* __restrict__ out,
                        T* __restrict__ sum_out, int d, float eps, int vec) {
  using V = RtVec16<T>;
  constexpr int E = NV * V::N;            // values a thread holds
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const bool res = r != nullptr;

  float s[E];
  uint4 wv[NV];
  float ss = 0.f;
  if (vec) {
    const int nvec = d / V::N;
    uint4 xv[NV], rv[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {        // every load in flight at once
      const int c = tid + k * nt;
      if (c < nvec) {
        xv[k] = __ldg(reinterpret_cast<const uint4*>(x + base) + c);
        if (res) rv[k] = __ldg(reinterpret_cast<const uint4*>(r + base) + c);
        wv[k] = __ldg(reinterpret_cast<const uint4*>(w) + c);
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = tid + k * nt;
      if (c < nvec) {
        V::unpack(xv[k], s + k * V::N);
        if (res) {
          float t[V::N];
          V::unpack(rv[k], t);
#pragma unroll
          for (int e = 0; e < V::N; ++e) s[k * V::N + e] += t[e];
        }
#pragma unroll
        for (int e = 0; e < V::N; ++e) ss = fmaf(s[k * V::N + e],
                                                 s[k * V::N + e], ss);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int i = tid + k * nt;
      if (i < d) {
        float v = rt_to_f32(x[base + i]);
        if (res) v += rt_to_f32(r[base + i]);
        s[k] = v;
        ss = fmaf(v, v, ss);
      }
    }
  }

  ss = rt_warp_sum(ss);
  if (nt > 32) {                          // one exchange between the warps
    __shared__ float partial[NORM_MAX_THREADS / 32];
    if ((tid & 31) == 0) partial[tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < nt / 32; ++i) ss += partial[i];
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  if (vec) {
    const int nvec = d / V::N;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = tid + k * nt;
      if (c < nvec) {
        float wf[V::N], o[V::N];
        V::unpack(wv[k], wf);
#pragma unroll
        for (int e = 0; e < V::N; ++e) o[e] = s[k * V::N + e] * inv * wf[e];
        reinterpret_cast<uint4*>(out + base)[c] = V::pack(o);
        if (res) reinterpret_cast<uint4*>(sum_out + base)[c] =
            V::pack(s + k * V::N);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int i = tid + k * nt;
      if (i < d) {
        out[base + i] = rt_from_f32<T>(s[k] * inv * rt_to_f32(w[i]));
        if (res) sum_out[base + i] = rt_from_f32<T>(s[k]);
      }
    }
  }
}

// The widest row the kernel holds in registers, for elements of `es` bytes.
static inline int residual_rmsnorm_max_d(int es) {
  return NORM_MAX_THREADS * NORM_MAX_NV * (16 / es);
}

// x, r, out, sum_out: (n, d) contiguous; w: (d,).  r and sum_out may both
// be null (the bare-norm form writes only `out`).
static inline int residual_rmsnorm_run(const void* x, const void* r,
                                       const void* w, void* out,
                                       void* sum_out, int n, int d,
                                       float eps, int dtype, void* stream) {
  const int es = dtype == RT_F32 ? 4 : 2;
  if (n <= 0 || d <= 0 || (r == nullptr) != (sum_out == nullptr) ||
      d > residual_rmsnorm_max_d(es))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_vec = 16 / es;
  const int nvec = (d + per_vec - 1) / per_vec;
  int threads = 32;
  while ((nvec + threads - 1) / threads > NORM_MAX_NV) threads *= 2;
  const int nv = (nvec + threads - 1) / threads;
  const int vec = d % per_vec == 0 && rt_aligned(x) && rt_aligned(r) &&
                  rt_aligned(w) && rt_aligned(out) &&
                  rt_aligned(sum_out);
  auto st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(dtype, T, {
    const auto kernel = nv <= 4 ? residual_rmsnorm_kernel<T, 4>
                                : residual_rmsnorm_kernel<T, NORM_MAX_NV>;
    kernel<<<n, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const T*>(w), static_cast<T*>(out),
        static_cast<T*>(sum_out), d, eps, vec);
  });
  return static_cast<int>(cudaGetLastError());
}
