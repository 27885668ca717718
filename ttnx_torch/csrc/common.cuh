// Shared device helpers for the ttnx_torch Hopper kernels.
//
// gemm_tile: one 64x64 output tile of C = A @ B computed by a group of 256
// threads (4x4 outputs per thread, 16-deep k-slices staged in shared
// memory). Operands are read through accessor lambdas, so a kernel states
// its strided views of the public layouts — (r_left, n, r_right) cores,
// (R, RA, R) environments — without materializing any transpose. Plain
// FP32/FP64 FMA on the CUDA cores: IEEE products, no TF32 rounding.
//
// A kernel with one group per block calls gemm_tile once per block; a
// single-block kernel runs several groups side by side, each walking its
// own tiles, synchronized by named barriers (one per group) so groups with
// different tile counts never wait on each other.
#pragma once

#include <cuda_runtime.h>

namespace ttnx {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kGroup = 256;                    // threads per gemm group
constexpr int kTileSmem = kBK * kBM + kBK * kBN;  // elements per group

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void group_sync(int group) {
  // barrier 0 is __syncthreads; groups use 1, 2, ...
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(kGroup) : "memory");
}

template <typename T, typename LA, typename LB, typename ST>
__device__ void gemm_tile(int M, int N, int K, int m0, int n0, const LA& la,
                          const LB& lb, const ST& st, T* smem, int gtid,
                          int group) {
  T* As = smem;              // [kBK][kBM]
  T* Bs = smem + kBK * kBM;  // [kBK][kBN]
  const int tm = gtid / 16, tn = gtid % 16;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = gtid; e < kBM * kBK; e += kGroup) {
      const int mm = e / kBK, kk = e % kBK;
      const int m = m0 + mm, k = k0 + kk;
      As[kk * kBM + mm] = (m < M && k < K) ? la(m, k) : T(0);
    }
    for (int e = gtid; e < kBK * kBN; e += kGroup) {
      const int kk = e / kBN, nn = e % kBN;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk * kBN + nn] = (k < K && n < N) ? lb(k, n) : T(0);
    }
    group_sync(group);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * kBM + tm * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * kBN + tn * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    group_sync(group);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tm * 4 + i, n = n0 + tn * 4 + j;
      if (m < M && n < N) st(m, n, acc[i][j]);
    }
}

// All tiles of an (M, N) product, spread over the groups of one block.
template <typename T, typename LA, typename LB, typename ST>
__device__ void gemm_block(int M, int N, int K, const LA& la, const LB& lb,
                           const ST& st, T* smem) {
  const int group = threadIdx.x / kGroup, gtid = threadIdx.x % kGroup;
  const int ngroups = blockDim.x / kGroup;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = ((M + kBM - 1) / kBM) * tiles_n;
  for (int t = group; t < tiles; t += ngroups)
    gemm_tile<T>(M, N, K, (t / tiles_n) * kBM, (t % tiles_n) * kBN, la, lb,
                 st, smem + group * kTileSmem, gtid, group);
}

// Sum over the whole block, same value returned to every thread. Every
// thread of the block must call it; blockDim.x is a multiple of 32.
template <typename T>
__device__ T block_sum(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red[] may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? red[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// p[0] = 1, p[1..count) = 0: the e0 e0^T boundary Gram / environment.
template <typename T>
__device__ void fill_e0(T* p, int count, int tid, int nthreads) {
  for (int e = tid; e < count; e += nthreads) p[e] = e == 0 ? T(1) : T(0);
}

// out[o][e] = sum_{c1, c2} coef[o1*so1 + o2*so2 + c1*sc1 + c2*sc2] *
//             in[(c1*C2 + c2)][e]          o = o1*O2 + o2, e < len
// The mixing of the small MPO indices (operator rank, physical index)
// between two GEMM phases.
template <typename T>
__device__ void mix_small(const T* coef, const T* in, T* out, int O1, int O2,
                          int C1, int C2, int so1, int so2, int sc1, int sc2,
                          int len, int tid, int nthreads) {
  const long total = (long)O1 * O2 * len;
  for (long idx = tid; idx < total; idx += nthreads) {
    const int e = (int)(idx % len);
    const int o = (int)(idx / len);
    const int o1 = o / O2, o2 = o % O2;
    const T* cf = coef + o1 * so1 + o2 * so2;
    T acc = T(0);
    for (int c1 = 0; c1 < C1; ++c1)
      for (int c2 = 0; c2 < C2; ++c2)
        acc += cf[c1 * sc1 + c2 * sc2] * in[(long)(c1 * C2 + c2) * len + e];
    out[idx] = acc;
  }
}

}  // namespace ttnx
