// Runtime helpers of the kernel library: error text for the codes the
// kernel entries return, and an empty kernel that measures what one launch
// costs on this card (the floor under every kernel of the decode step).
#include "common.cuh"

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__global__ void rt_null_kernel() {}

extern "C" int rt_null_launch(void* stream) {
  rt_null_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
