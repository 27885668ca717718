// The site-resident engine shared by kernel B7's site route
// (csrc/als_sweep_site.cu) and kernels B4/B5's resident route
// (csrc/local_cg_site.cu): one 512-thread block a problem, f32 IEEE FMA on
// the CUDA cores (no TF32), operands in shared memory.
//
//   * ld4/st4/axpy4/dot4: 16-byte accesses and their arithmetic.
//   * gemm (mma_chunks + reduce_scatter): a block GEMM from shared memory,
//     TM x 4 register tiles, KS lanes of a warp splitting k and summing by
//     shuffles.
//   * block_sum: a block reduction with one barrier.
//   * slab_mix: the first product of the unfolded local operator for one
//     16-wide column slab, with the MPO mix in registers.
#pragma once

#include <cuda_runtime.h>

namespace ttnx_site {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr int CS = 16;  // column slab of the apply and the env updates

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y),
                     fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// acc[i][j] += sum_k A(m0 + i, k) B(k, n0 + j) over the 4-deep chunks g,
// g + KS, ... of [0, K). AK: A is stored [k][m] and pa(m, k) = &A[k][m],
// else [m][k] and pa(m, k) = &A[m][k]; BK: B is stored [n][k] and
// pb(n, k) = &B[n][k], else [k][n] and pb(n, k) = &B[k][n]. Every pointer
// is 16-byte aligned; four consecutive values are read at once.
template <int TM, int KS, int K, bool AK, bool BK, class PA, class PB>
__device__ __forceinline__ void mma_chunks(float (&acc)[TM][4], int m0,
                                           int n0, int g, const PA& pa,
                                           const PB& pb) {
#pragma unroll 1
  for (int k = 4 * g; k < K; k += 4 * KS) {
    float b[4][4];  // b[q][j] = B(k + q, n0 + j)
    if constexpr (BK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = ld4(pb(n0 + j, k));
        b[0][j] = v.x;
        b[1][j] = v.y;
        b[2][j] = v.z;
        b[3][j] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = ld4(pb(n0, k + q));
        b[q][0] = v.x;
        b[q][1] = v.y;
        b[q][2] = v.z;
        b[q][3] = v.w;
      }
    }
    if constexpr (AK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float a[TM];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = ld4(pa(m0 + i, k + q));
          a[i] = v.x;
          a[i + 1] = v.y;
          a[i + 2] = v.z;
          a[i + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(a[i], b[q][j], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = ld4(pa(m0 + i, k));
        const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(a[q], b[q][j], acc[i][j]);
      }
    }
  }
}

// One halving step of reduce_scatter: lanes with bit MASK set keep the
// upper H/2 rows, the others the lower, each adding its partner's half.
template <int TM, int H, int MASK>
__device__ __forceinline__ void rs_step(float (&acc)[TM][4], int g,
                                        int& base) {
  if constexpr (MASK >= 1) {
    const bool up = (g & MASK) != 0;
#pragma unroll
    for (int r = 0; r < H / 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = acc[r][j], hi = acc[r + H / 2][j];
        acc[r][j] = (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi,
                                                     MASK);
      }
    if (up) base += H / 2;
    rs_step<TM, H / 2, MASK / 2>(acc, g, base);
  }
}

// Sums the partial tiles of the KS lanes g = 0..KS-1 (consecutive lanes);
// lane g keeps rows base .. base + TM/KS - 1 of the tile in acc[0..TM/KS).
template <int TM, int KS>
__device__ __forceinline__ int reduce_scatter(float (&acc)[TM][4], int g) {
  int base = 0;
  rs_step<TM, TM, KS / 2>(acc, g, base);
  return base;
}

// C (M x N) = A (M x K) B (K x N) by the whole block: TM x 4 tiles, KS
// lanes a tile splitting k; epi(m, n0, float4 of C[m][n0..n0+3]) for each
// result row. No barrier inside.
template <int M, int N, int K, int TM, int KS, bool AK, bool BK, class PA,
          class PB, class EPI>
__device__ __forceinline__ void gemm(const PA& pa, const PB& pb,
                                     const EPI& epi) {
  constexpr int NT = N / 4, POS = (M / TM) * NT;
  static_assert(M % TM == 0 && N % 4 == 0 && K % (4 * KS) == 0 &&
                    TM % KS == 0 && TM % 4 == 0,
                "tile shape");
  static_assert((POS * KS) % 32 == 0, "whole warps");
  const int g = threadIdx.x % KS;
  for (int pos = threadIdx.x / KS; pos < POS; pos += kThreads / KS) {
    const int m0 = (pos / NT) * TM, n0 = (pos % NT) * 4;
    float acc[TM][4] = {};
    mma_chunks<TM, KS, K, AK, BK>(acc, m0, n0, g, pa, pb);
    const int base = reduce_scatter<TM, KS>(acc, g);
#pragma unroll
    for (int j = 0; j < TM / KS; ++j)
      epi(m0 + base + j, n0,
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
  }
}

// Sum over the block, the same value in every thread, with one barrier;
// red holds two alternating 32-float buffers (flip picks one), so a buffer
// is rewritten only after a later barrier.
__device__ __forceinline__ float block_sum(float v, float* red, int& flip) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  float* buf = red + 32 * flip;
  flip ^= 1;
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += buf[w];
  return s;
}

// S [(W,b)][(i,c)] for the 16 columns c of slab sl:
//   sum_{J,w} A[W,i,J,w] sum_d P[(b,J)][d] RT[d][(w,c)].
// Thread (b, c quad, d half): a 2 x (RA x 4) register tile over half of
// d, the halves summed by a shuffle that leaves each lane two columns
// with every (J, w), mixed with A in registers.
template <int R, int N, int RA, int LDP, int LDR, int LDS>
__device__ __forceinline__ void slab_mix(const float* P, const float* RT,
                                         const float* Ac, float* S, int sl) {
  const int tid = threadIdx.x;
  if (tid >= 8 * R) return;
  const int kh = tid & 1, cq = (tid >> 1) & 3, bb = tid >> 3;
  const int c0 = sl * CS + cq * 4;
  float acc[2][RA][4] = {};
  const float* p0 = P + bb * N * LDP;
#pragma unroll 1
  for (int k = 4 * kh; k < R; k += 8) {
    const float4 u0 = ld4(p0 + k), u1 = ld4(p0 + LDP + k);
    const float av[2][4] = {{u0.x, u0.y, u0.z, u0.w},
                            {u1.x, u1.y, u1.z, u1.w}};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* rt = RT + (k + q) * LDR + c0;
#pragma unroll
      for (int w = 0; w < RA; ++w) {
        const float4 bv = ld4(rt + w * R);
#pragma unroll
        for (int J = 0; J < 2; ++J) {
          acc[J][w][0] = fmaf(av[J][q], bv.x, acc[J][w][0]);
          acc[J][w][1] = fmaf(av[J][q], bv.y, acc[J][w][1]);
          acc[J][w][2] = fmaf(av[J][q], bv.z, acc[J][w][2]);
          acc[J][w][3] = fmaf(av[J][q], bv.w, acc[J][w][3]);
        }
      }
    }
  }
  float t[2][RA][2];
#pragma unroll
  for (int J = 0; J < 2; ++J)
#pragma unroll
    for (int w = 0; w < RA; ++w)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float lo = acc[J][w][cc], hi = acc[J][w][cc + 2];
        t[J][w][cc] = (kh ? hi : lo) + __shfl_xor_sync(kFull, kh ? lo : hi,
                                                          1);
      }
#pragma unroll
  for (int W = 0; W < RA; ++W)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float o0 = 0.f, o1 = 0.f;
#pragma unroll
      for (int J = 0; J < N; ++J) {
        const float4 cf = ld4(Ac + ((W * N + i) * N + J) * RA);
        const float c4[4] = {cf.x, cf.y, cf.z, cf.w};
#pragma unroll
        for (int w = 0; w < RA; ++w) {
          o0 = fmaf(c4[w], t[J][w][0], o0);
          o1 = fmaf(c4[w], t[J][w][1], o1);
        }
      }
      *reinterpret_cast<float2*>(S + (W * R + bb) * LDS + i * CS + cq * 4 +
                                 kh * 2) = make_float2(o0, o1);
    }
}

}  // namespace ttnx_site
