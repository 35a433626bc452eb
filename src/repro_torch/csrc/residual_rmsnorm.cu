// Fused residual add + RMSNorm: the fused pair's norm.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused/residual_rmsnorm/kernel.py::residual_rmsnorm_kernel
//   (_res_rms_kernel).
// The kernel, its bound and its design are in residual_rmsnorm.cuh, shared
// with the legacy two-output norm (rmsnorm.cu).
#include "residual_rmsnorm.cuh"

extern "C" int residual_rmsnorm_launch(const void* x, const void* r,
                                       const void* w, void* out,
                                       void* sum_out, int n, int d,
                                       float eps, int dtype, void* stream) {
  return residual_rmsnorm_run(x, r, w, out, sum_out, n, d, eps, dtype,
                              stream);
}
