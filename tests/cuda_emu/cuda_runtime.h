// A CPU stand-in for the parts of cuda_runtime.h that the site-resident
// kernels (ttnx_torch/csrc/als_sweep_site.cu, local_cg_site.cu and their
// site_engine.cuh) use, so that they run on the CPU under
// tests/cuda_emu/emulate_site.cpp and emulate_matfree.cpp. The runtime
// half (threads and barriers) is emu_block.h.
#pragma once
#include <cmath>
#include <cstddef>

struct float4 {
  float x, y, z, w;
};
struct float2 {
  float x, y;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)

struct emu_dim3 {
  unsigned x, y, z;
};
extern thread_local emu_dim3 threadIdx;
extern emu_dim3 blockIdx;
float __shfl_xor_sync(unsigned mask, float v, int lane_mask);
void __syncthreads();

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
