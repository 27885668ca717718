// A CPU stand-in for the parts of cuda_runtime.h that the emulated kernels
// use: the site-resident kernels (ttnx_torch/csrc/als_sweep_site.cu,
// local_cg_site.cu and their site_engine.cuh) under
// tests/cuda_emu/emulate_site.cpp and emulate_matfree.cpp, and the
// cluster routes of B10 and B3 (local_cg.cu with dense_cluster.cuh)
// under emulate_cluster.cpp, of B9 (lanczos.cu) under emulate_lanczos.cpp,
// every route of env_chain_site.cu (B6, B2 and B8) under emulate_env.cpp,
// and B1's cooperative grid route (gram_chain_grid.cu) under
// emulate_gram.cpp. The runtime half (threads, barriers, clusters, grids)
// is emu_block.h; cooperative_groups.h is the cluster and grid API on top
// of it.
#pragma once
#include <cmath>
#include <cstddef>
#include <functional>

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
extern thread_local emu_dim3 blockIdx;
extern thread_local emu_dim3 blockDim;
extern thread_local emu_dim3 gridDim;
float __shfl_xor_sync(unsigned mask, float v, int lane_mask);
double emu_shfl_down(double v, int delta);
template <typename T>
T __shfl_down_sync(unsigned, T v, int delta) {
  return (T)emu_shfl_down((double)v, delta);
}
void __syncthreads();
template <typename T>
T __ldg(const T* p) {
  return *p;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaErrorInvalidConfiguration = 9,
  cudaLaunchAttributeClusterDimension = 4,
  cudaLaunchAttributeCooperative = 2,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 10,
  cudaErrorCooperativeLaunchTooLarge = 82,
  cudaDevAttrMultiProcessorCount = 16
};
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}
// an emulated device of emu_sm_count SMs (4 unless a driver sets it
// before the first launch), one block of each kernel an SM
inline int emu_sm_count = 4;
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = emu_sm_count;
  return 0;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return 0;
}

// Cluster and cooperative launches: cudaLaunchKernelEx runs the grid as
// one cluster of emulated blocks, all at once, each with its own dynamic
// shared memory (a cooperative grid's barrier is the cluster's).
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct cudaLaunchAttribute {
  int id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
    int cooperative;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* clusters, F,
                                           const cudaLaunchConfig_t*) {
  *clusters = 1;
  return 0;
}
inline unsigned emu_last_grid = 0;  // the blocks of the last launch
void emu_run_cluster(int blocks, int threads, size_t smem_bytes,
                     const std::function<void()>& body);
unsigned char* emu_dynamic_smem();
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(P...), A&&... args) {
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension &&
        cfg->attrs[i].val.clusterDim.x != cfg->gridDim.x)
      return cudaErrorInvalidConfiguration;  // one cluster a grid only
  emu_last_grid = cfg->gridDim.x;
  emu_run_cluster(cfg->gridDim.x, cfg->blockDim.x, cfg->dynamicSmemBytes,
                  [&] { kernel(args...); });
  return 0;
}
