// Thread-block-cluster engine of the dense-K solvers: K's rows split over
// a cluster of C CTAs, each holding its share in shared memory for the
// whole solve, so an iteration reads K from shared memory on C SMs
// instead of from L2 on one. The vectors a matvec reads are kept
// full-length in every CTA; a CTA updates its own slice and pushes it
// into every partner's copy through distributed shared memory (DSMEM).
// An inner product is a partial a CTA, pushed into a slot array [C] in
// every CTA and summed there in rank order after the cluster barrier, so
// every CTA computes bit-identical scalars and a call is deterministic.
// Used by B10 and B3 (local_cg.cu: bicgstab_cluster_kernel,
// cg_cluster_kernel) and B9 (lanczos.cu, lanczos_cluster_kernel, whose
// K at M = 1024 is larger than a cluster's shared memory: each CTA keeps
// as many of its rows as fit and streams the rest from L2 on every
// matvec, streamed_matvec).
//
// The hardware primitives (rank, DSMEM pointer, barrier) go through
// cooperative groups and the copy through one small wrapper, so that a
// CPU emulation of a cluster (tests/cuda_emu) can stand in for them and
// run the solvers' index arithmetic unchanged.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace ttnx_cluster {
namespace cg = cooperative_groups;

__device__ __forceinline__ int cluster_rank() {
  return (int)cg::this_cluster().block_rank();
}

// The address of `p` (a shared-memory address of this CTA) in CTA `rank`.
template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

// Barrier of every thread of the cluster; a CTA's shared-memory and DSMEM
// writes before it are visible to every thread of the cluster after it.
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// 16 bytes global -> shared, asynchronous, bypassing L1 and marked for
// early eviction from L2 (read once); copy_wait() waits for all of them.
__device__ __forceinline__ void copy16(void* s, const void* g) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "{\n"
      ".reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, pol;\n"
      "}\n" ::"r"((uint32_t)__cvta_generic_to_shared(s)),
      "l"(g)
      : "memory");
#else
  memcpy(s, g, 16);
#endif
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
#endif
}

// a[i] = v in every CTA of the cluster, this one included.
template <int C>
__device__ __forceinline__ void push_all(float* a, int i, float v) {
#pragma unroll
  for (int c = 0; c < C; ++c) cluster_map(a, c)[i] = v;
}

// slot[rank] = partial in every CTA: lane c of the calling warp stores
// into CTA c (the partial the same in every lane).
template <int C>
__device__ __forceinline__ void push_partial(float* slot, float partial,
                                             int rank) {
  static_assert(C <= 32, "one lane a partner");
  const int lane = threadIdx.x & 31;
  if (lane < C) cluster_map(slot, lane)[rank] = partial;
}

// The C partials in rank order: the same bits in every CTA.
template <int C>
__device__ __forceinline__ float cluster_sum(const float* slot) {
  float s = slot[0];
#pragma unroll
  for (int c = 1; c < C; ++c) s += slot[c];
  return s;
}

// sum_i a[i] b[i] over i < n by one warp: lane-strided partial sums, then
// a butterfly, which leaves the same bits in every lane.
__device__ __forceinline__ float warp_dot(const float* a, const float* b,
                                          int n) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int i = lane; i < n; i += 32) s += a[i] * b[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

constexpr int kSliceRows = 4;  // rows a warp sums at once

// out[i] = sum_j Ks[i ld + j] v[j] for the CTA's rows i < rows, from
// shared memory; ld a multiple of 4, Ks and v zero from M to ld. A warp
// sums kSliceRows rows at once over lane-strided float4 chunks, then each
// row by a butterfly: the same order in every call.
__device__ __forceinline__ void slice_matvec(const float* Ks, const float* v,
                                             float* out, int rows, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, n4 = ld / 4;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  for (int r0 = warp * kSliceRows; r0 < rows; r0 += nw * kSliceRows) {
    const float4* k4[kSliceRows];
#pragma unroll
    for (int q = 0; q < kSliceRows; ++q)
      k4[q] = reinterpret_cast<const float4*>(
          Ks + (size_t)(r0 + q < rows ? r0 + q : r0) * ld);
    float acc[kSliceRows];
#pragma unroll
    for (int q = 0; q < kSliceRows; ++q) acc[q] = 0.f;
    for (int j = lane; j < n4; j += 32) {
      const float4 x = v4[j];
#pragma unroll
      for (int q = 0; q < kSliceRows; ++q) {
        const float4 k = k4[q][j];
        acc[q] += k.x * x.x + k.y * x.y + k.z * x.z + k.w * x.w;
      }
    }
#pragma unroll
    for (int q = 0; q < kSliceRows; ++q) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
      if (lane == 0 && r0 + q < rows) out[r0 + q] = acc[q];
    }
  }
}

// Rows [row0, row0 + rows) of K (M, M) into Ks (rows x ld, ld = M
// rounded up to float4s, zero from M to ld): 16-byte asynchronous copies
// when M is a multiple of 4 and K 16-byte aligned, else element by
// element; copy_wait() ends the copies.
__device__ __forceinline__ void load_rows(float* Ks, const float* K, int row0,
                                          int rows, int M, int ld) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* Kp = K + (size_t)row0 * M;
  if (M % 4 == 0 && ((size_t)K & 15) == 0) {
    const int q4 = M / 4;
    for (int e = tid; e < rows * q4; e += nt)
      copy16(Ks + (size_t)(e / q4) * ld + (e % q4) * 4, Kp + (size_t)e * 4);
  } else {
    for (int e = tid; e < rows * ld; e += nt) {
      const int i = e / ld, j = e % ld;
      Ks[e] = j < M ? Kp[(size_t)i * M + j] : 0.f;
    }
  }
}

constexpr int kStreamMaxM = 1024;  // a lane's loads of one row: 32 floats

// out[i] = sum_j K[i M + j] v[j] for rows i < rows of K in device memory
// (read from L2 on every call), M <= kStreamMaxM: one row a warp, the
// last warp first (slice_matvec gives the first warps one row group
// more), each lane's loads of the row (8 float4s when M is a multiple of
// 4 and K 16-byte aligned, else 32 floats) issued before any is used,
// then summed in column order and by a butterfly: the same order in every
// call. v is 16-byte aligned and zero from M to up4(M).
__device__ __forceinline__ void streamed_matvec(const float* K,
                                                const float* v, float* out,
                                                int rows, int M) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const bool vec = M % 4 == 0 && ((size_t)K & 15) == 0;
  for (int i = nw - 1 - warp; i < rows; i += nw) {
    const float* kr = K + (size_t)i * M;
    float acc = 0.f;
    if (vec) {
      const float4* k4 = reinterpret_cast<const float4*>(kr);
      const float4* v4 = reinterpret_cast<const float4*>(v);
      const int n4 = M / 4;
      float4 k[kStreamMaxM / 128];
#pragma unroll
      for (int u = 0; u < kStreamMaxM / 128; ++u) {
        const int j = lane + 32 * u;
        k[u] = j < n4 ? __ldg(k4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kStreamMaxM / 128; ++u) {
        const int j = lane + 32 * u;
        if (j < n4) {
          const float4 x = v4[j];
          acc += k[u].x * x.x + k[u].y * x.y + k[u].z * x.z + k[u].w * x.w;
        }
      }
    } else {
      float k[kStreamMaxM / 32];
#pragma unroll
      for (int u = 0; u < kStreamMaxM / 32; ++u) {
        const int j = lane + 32 * u;
        k[u] = j < M ? __ldg(kr + j) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kStreamMaxM / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < M) acc += k[u] * v[j];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[i] = acc;
  }
}

// Launches `kernel` as one cluster of C CTAs (the whole grid) of
// `threads` threads with `smem` bytes of dynamic shared memory a CTA; C >
// 8 is allowed as a non-portable size. The first launch at a size asks
// the runtime whether such a cluster fits an SM group at all (`*fits`: the
// largest size one was found to fit at); none fits: an error, never
// another route. Returns the launch's error, or cudaGetLastError().
template <typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), int C, int threads, size_t smem,
                   cudaStream_t st, size_t* fits, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem > *fits) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    *fits = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace ttnx_cluster
