// Fused RMSNorm + projection matmul.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused/rmsnorm_matmul/kernel.py::rmsnorm_matmul_kernel
//   (_rms_mm_kernel).
// Computes normed = (x * rsqrt(mean(x^2) + eps) * w) rounded to x's dtype,
// then proj = normed @ W with f32 accumulation, stored in W's dtype.
// Returns both, as the reference does (the normed rows feed wk and wv).
//
// Bound on Hopper: bytes.  At decode N <= max_batch rows, so the product is
// a GEMV: 2*N*D*F flops against D*F weight elements, i.e. about N flops per
// byte in bf16, two orders of magnitude under the tensor-core balance
// point.  The whole of W has to stream through once; nothing else matters.
// Design: grid (row tile, F tile).  Each CTA recomputes its rows'
// statistics (D elements per row, negligible next to its D x 32 slice of
// W), keeps the rounded normed rows in shared memory, and has each of its 8
// warps walk an interleaved eighth of the K dimension with one output
// column per lane, so a warp reads 32 adjacent columns of one W row per
// step.  The 8 partial sums meet in shared memory.  Only CTAs of F tile 0
// write `normed`.  Simple first: no tensor cores, no TMA; at prefill
// (N = 16) the same loop serves, since the call is launch-bound there too.
#include "common.cuh"

constexpr int RM_COLS = 32;    // output columns per CTA, one per lane
constexpr int RM_SLICES = 8;   // warps per CTA, each an eighth of K
constexpr int RM_MAX_ROWS = 8; // rows per CTA (register accumulators)
constexpr int RM_PART_FLOATS = RM_SLICES * RM_MAX_ROWS * RM_COLS;

template <typename T>
__global__ void rmsnorm_matmul_kernel(const T* __restrict__ x,
                                      const T* __restrict__ w,
                                      const T* __restrict__ wp,
                                      T* __restrict__ proj,
                                      T* __restrict__ normed, int n, int d,
                                      int f, int rows_per_cta, float eps) {
  extern __shared__ float smem[];
  float* nrm = smem;                          // rows_per_cta x d
  float* part = smem + rows_per_cta * d;      // RM_SLICES x RM_MAX_ROWS x 32
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * rows_per_cta;
  const int rows = min(rows_per_cta, n - row0);
  const bool write_normed = blockIdx.y == 0;

  // 1. statistics and normed rows, one warp per row
  for (int r = warp; r < rows; r += RM_SLICES) {
    const T* xr = x + static_cast<size_t>(row0 + r) * d;
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float v = rt_to_f32(xr[i]);
      ss += v * v;
    }
    ss = rt_warp_sum(ss);
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    for (int i = lane; i < d; i += 32) {
      const T nv = rt_from_f32<T>(rt_to_f32(xr[i]) * inv * rt_to_f32(w[i]));
      nrm[r * d + i] = rt_to_f32(nv);
      if (write_normed) normed[static_cast<size_t>(row0 + r) * d + i] = nv;
    }
  }
  __syncthreads();

  // 2. partial dot products: warp = K slice, lane = output column
  const int col = blockIdx.y * RM_COLS + lane;
  float acc[RM_MAX_ROWS];
#pragma unroll
  for (int r = 0; r < RM_MAX_ROWS; ++r) acc[r] = 0.f;
  if (col < f) {
#pragma unroll 4
    for (int k = warp; k < d; k += RM_SLICES) {
      const float wv = rt_to_f32(wp[static_cast<size_t>(k) * f + col]);
#pragma unroll
      for (int r = 0; r < RM_MAX_ROWS; ++r)
        if (r < rows) acc[r] = fmaf(nrm[r * d + k], wv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RM_MAX_ROWS; ++r)
    part[(warp * RM_MAX_ROWS + r) * RM_COLS + lane] = acc[r];
  __syncthreads();

  // 3. sum the K slices and store
  for (int idx = threadIdx.x; idx < rows * RM_COLS; idx += blockDim.x) {
    const int r = idx / RM_COLS, c = idx % RM_COLS;
    const int oc = blockIdx.y * RM_COLS + c;
    if (oc >= f) continue;
    float s = 0.f;
#pragma unroll
    for (int sl = 0; sl < RM_SLICES; ++sl)
      s += part[(sl * RM_MAX_ROWS + r) * RM_COLS + c];
    proj[static_cast<size_t>(row0 + r) * f + oc] = rt_from_f32<T>(s);
  }
}

// Shared memory a CTA needs for `rows_per_cta` rows of width d.
static size_t rm_smem_bytes(int rows_per_cta, int d) {
  return sizeof(float) *
         (static_cast<size_t>(rows_per_cta) * d + RM_PART_FLOATS);
}

// x: (n, d), w: (d,), wp: (d, f), proj: (n, f), normed: (n, d), all
// contiguous and of one dtype.  rows_per_cta in [1, 8] is chosen by the
// wrapper so that the normed rows fit the 48 KB static shared budget.
extern "C" int rmsnorm_matmul_launch(const void* x, const void* w,
                                     const void* wp, void* proj,
                                     void* normed, int n, int d, int f,
                                     int rows_per_cta, float eps, int dtype,
                                     void* stream) {
  if (n <= 0 || d <= 0 || f <= 0 || rows_per_cta < 1 ||
      rows_per_cta > RM_MAX_ROWS || rm_smem_bytes(rows_per_cta, d) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + rows_per_cta - 1) / rows_per_cta,
                  (f + RM_COLS - 1) / RM_COLS);
  const size_t smem = rm_smem_bytes(rows_per_cta, d);
  auto st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(dtype, T,
              rmsnorm_matmul_kernel<T><<<grid, RM_SLICES * 32, smem, st>>>(
                  static_cast<const T*>(x), static_cast<const T*>(w),
                  static_cast<const T*>(wp), static_cast<T*>(proj),
                  static_cast<T*>(normed), n, d, f, rows_per_cta, eps));
  return static_cast<int>(cudaGetLastError());
}
