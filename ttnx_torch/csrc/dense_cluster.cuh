// Thread-block-cluster engine of the dense-K solvers: K's rows split over
// a cluster of C CTAs, each holding its share in shared memory for the
// whole solve, so an iteration reads K from shared memory on C SMs
// instead of from L2 on one. The vectors a matvec reads are kept
// full-length in every CTA; a CTA updates its own slice and pushes it
// into every partner's copy through distributed shared memory (DSMEM).
// An inner product is a partial a CTA, pushed into a slot array [C] in
// every CTA and summed there in rank order after the cluster barrier, so
// every CTA computes bit-identical scalars and a call is deterministic.
// Used by B10 (local_cg.cu, bicgstab_cluster_kernel); B3 and B9 (the
// other dense-K, one-SM kernels) can take it next.
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

}  // namespace ttnx_cluster
