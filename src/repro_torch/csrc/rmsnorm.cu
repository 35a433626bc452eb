// The legacy residual add + RMSNorm with two outputs: the RWKV block's
// norm windows (norm1, norm2 and the final norm on the residual stream).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py::rmsnorm_kernel (_rms_kernel).
// It computes (normed, x + residual) with f32 statistics and the norm of
// the unrounded f32 sum, or (normed, x) without a residual: the function of
// residual_rmsnorm.cuh, whose kernel it launches (bytes-bound, then
// latency: one CTA per row, all loads issued before the reduction; see
// there).  Without a residual this entry writes only the normed
// rows and the wrapper returns x itself as the second output, where the
// TPU kernel copies x into a second buffer.
#include "residual_rmsnorm.cuh"

extern "C" int rmsnorm_launch(const void* x, const void* r, const void* w,
                              void* out, void* sum_out, int n, int d,
                              float eps, int dtype, void* stream) {
  return residual_rmsnorm_run(x, r, w, out, sum_out, n, d, eps, dtype,
                              stream);
}
