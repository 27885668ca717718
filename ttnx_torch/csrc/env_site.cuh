// The column-slab site update of the ALS environment chains (kernels B2 and
// B6, csrc/env_chain_site.cu), on the block GEMM of site_engine.cuh: f32
// IEEE FMA on the CUDA cores (no TF32), 512 threads a block, operands in
// shared memory.
//
// Right chain at site k, with x = x_k (R, n, R), A = A_k (RA, n, n, RA),
// b = b_k (R, n, R) and the previous envs Renv = Renv_{k+1} (R, RA, R),
// Rb = Rb_{k+1} (R, R):
//   t[b,j,p,w]  = sum_q x[b,j,q] Renv[p,w,q]
//   t2[W,i,b,p] = sum_{j,w} A[W,i,j,w] t[b,j,p,w]
//   Renv_k[a,W,b] = sum_{i,p} x[a,i,p] t2[W,i,b,p]
//   Rb_k[a,u]     = sum_{i,p} x[a,i,p] sum_v b[u,i,v] Rb[p,v]
// Every output column b of Renv_k (and u of Rb_k) needs only the rows
// x[b,:,:] (b[u,:,:]), the whole x, A and the whole previous envs, so the
// update splits into column slabs of S columns that share no sum: one
// block walks all the slabs of a problem (B6), or each CTA of a cluster
// owns one (B2). The left chain is the same update of the cores with their
// bond indices swapped (x'[c,i,a] = x[a,i,c], b' likewise, A'[w,i,j,W] =
// A[W,i,j,w]) on L_k, Lb_k in the place of Renv, Rb.
//
// Shared memory (floats; padded rows keep the 16-byte loads of a warp on
// distinct banks):
//   ET[2]  previous / next env as [q][(w,p)] = env[p,w,q]   2 x R x LDR
//   X      the core as [(a,i)][p]                           n R x LDP
//   S2     t2 of the slab as [(W,b)][(i,p)]                 RA S x LDS
//   RB[2]  previous / next rhs env as [p][v]                2 x R x LDQ
//   BS     the slab's rows of b as [(u,i)][v]               n S x LDP
//   SB     sum_v b[u,i,v] Rb[p,v] of the slab as [(u,i)][p] n S x LDP
//   Ac     A as [W][i][J][w]                                RA n n RA
// At R = 64, S = 8: 228,608 B of 232,448 (no room for a second core, so
// the next site's cores are not prefetched); at R = 32, S = 16: 79,104 B.
// The next env is written into the second buffer of ET / RB (in every
// CTA of a cluster), since the current one is read by every slab.
//
// The MPO bond RA is a template parameter: 4 for B2 and B6, 5 for kernel
// B8 (the operator-only chain of the DMRG sweeps, XXX and XXZ MPOs), which
// runs the same update with no rhs (RHS false: no RB, BS, SB, no rhs
// products; 211,664 B at R = 64, S = 4).
#pragma once

#include "dense_cluster.cuh"
#include "site_engine.cuh"

namespace ttnx_envsite {
using namespace ttnx_site;

constexpr int kN = 2;  // instantiated for n = 2

// One block GEMM C (M x N) = A (M x K) B (K x N) from shared memory: the
// engine's gemm at the first (TM, KS) that tiles it in whole warps, else
// one float4 of C a thread, summed over k in order.
template <int M, int N, int K, int TM, int KS>
constexpr bool kTiles = M % TM == 0 && N % 4 == 0 && K % (4 * KS) == 0 &&
                        TM % KS == 0 &&
                        ((M / TM) * (N / 4) * KS) % 32 == 0 &&
                        (M / TM) * (N / 4) * KS <= kThreads;

template <int M, int N, int K, bool AK, bool BK, class PA, class PB,
          class EPI>
__device__ __forceinline__ void block_gemm(const PA& pa, const PB& pb,
                                           const EPI& epi) {
  if constexpr (kTiles<M, N, K, 8, 8>) {
    gemm<M, N, K, 8, 8, AK, BK>(pa, pb, epi);
  } else if constexpr (kTiles<M, N, K, 8, 4>) {
    gemm<M, N, K, 8, 4, AK, BK>(pa, pb, epi);
  } else if constexpr (kTiles<M, N, K, 4, 4>) {
    gemm<M, N, K, 4, 4, AK, BK>(pa, pb, epi);
  } else if constexpr (kTiles<M, N, K, 4, 2>) {
    gemm<M, N, K, 4, 2, AK, BK>(pa, pb, epi);
  } else {
    static_assert(!AK, "the small path reads A as [m][k]");
    for (int e = threadIdx.x; e < M * (N / 4); e += kThreads) {
      const int m = e / (N / 4), n0 = (e % (N / 4)) * 4;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < K; ++k) {
        const float a = *pa(m, k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[j] = fmaf(a, BK ? *pb(n0 + j, k) : pb(n0, k)[j], c[j]);
      }
      epi(m, n0, make_float4(c[0], c[1], c[2], c[3]));
    }
  }
}

template <int R, int S, int RA = 4, bool RHS = true>
struct EnvLayout {
  static_assert(S >= 4 && S % 4 == 0 && R % S == 0, "slab of float4s");
  static constexpr int LDP = R + 4, LDR = RA * R + 4, LDS = kN * R + 4,
                       LDQ = R + 4;
  static constexpr int NCOEF = RA * kN * kN * RA;
  static constexpr int OFF_ET = 0, OFF_X = 2 * R * LDR,
                       OFF_S2 = OFF_X + kN * R * LDP,
                       OFF_RB = OFF_S2 + RA * S * LDS,
                       OFF_BS = OFF_RB + (RHS ? 2 * R * LDQ : 0),
                       OFF_SB = OFF_BS + (RHS ? kN * S * LDP : 0),
                       OFF_A = OFF_SB + (RHS ? kN * S * LDP : 0),
                       FLOATS = OFF_A + NCOEF;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// S2[(W,bl)][(i,p)] = sum_{J,w} A[W,i,J,w] sum_q X[(b0+bl,J)][q]
// ET[q][(w,p)] for the S rows b0.. of the slab. Thread (p quad, k part g,
// row bl): a 2 x RA x 4 register tile over part g of q, the KP parts
// summed by a reduce-scatter over p (consecutive lane groups), then the
// mix with A in registers.
template <int R, int S, int RA>
__device__ __forceinline__ void rows_mix(const float* X, const float* ET,
                                         const float* Ac, float* S2,
                                         int b0) {
  using L = EnvLayout<R, S, RA>;
  constexpr int NPQ = R / 4, PL = NPQ < 8 ? NPQ : 8, PH = NPQ / PL;
  constexpr int KP0 = kThreads / (S * NPQ);
  constexpr int KP = KP0 >= 4 ? 4 : (KP0 >= 2 ? 2 : 1);
  constexpr int ACTIVE = S * NPQ * KP;
  static_assert(ACTIVE <= kThreads && ACTIVE % 32 == 0 && PL * KP <= 32,
                "whole warps, a lane group inside one warp");
  const int tid = threadIdx.x;
  if (tid >= ACTIVE) return;
  const int pql = tid % PL, g = (tid / PL) % KP, rest = tid / (PL * KP);
  const int bl = rest / PH, p0 = ((rest % PH) * PL + pql) * 4;
  const float* x0 = X + (b0 + bl) * kN * L::LDP;
  float acc[kN][RA][4] = {};
#pragma unroll 1
  for (int q = 4 * g; q < R; q += 4 * KP) {
    const float4 u0 = ld4(x0 + q), u1 = ld4(x0 + L::LDP + q);
    const float av[kN][4] = {{u0.x, u0.y, u0.z, u0.w},
                             {u1.x, u1.y, u1.z, u1.w}};
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const float* et = ET + (q + qq) * L::LDR + p0;
#pragma unroll
      for (int w = 0; w < RA; ++w) {
        const float4 e = ld4(et + w * R);
#pragma unroll
        for (int J = 0; J < kN; ++J) {
          acc[J][w][0] = fmaf(av[J][qq], e.x, acc[J][w][0]);
          acc[J][w][1] = fmaf(av[J][qq], e.y, acc[J][w][1]);
          acc[J][w][2] = fmaf(av[J][qq], e.z, acc[J][w][2]);
          acc[J][w][3] = fmaf(av[J][qq], e.w, acc[J][w][3]);
        }
      }
    }
  }
  int pb = 0;  // the lane keeps p0 + pb .. p0 + pb + 4 / KP - 1
  if constexpr (KP >= 2) {
    const bool up = (g & (KP / 2)) != 0;
#pragma unroll
    for (int J = 0; J < kN; ++J)
#pragma unroll
      for (int w = 0; w < RA; ++w)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float lo = acc[J][w][c], hi = acc[J][w][c + 2];
          acc[J][w][c] = (up ? hi : lo) +
                         __shfl_xor_sync(kFull, up ? lo : hi, PL * (KP / 2));
        }
    pb += up ? 2 : 0;
  }
  if constexpr (KP >= 4) {
    const bool up = (g & 1) != 0;
#pragma unroll
    for (int J = 0; J < kN; ++J)
#pragma unroll
      for (int w = 0; w < RA; ++w) {
        const float lo = acc[J][w][0], hi = acc[J][w][1];
        acc[J][w][0] =
            (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, PL);
      }
    pb += up ? 1 : 0;
  }
#pragma unroll
  for (int c = 0; c < 4 / KP; ++c)
#pragma unroll
    for (int W = 0; W < RA; ++W)
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        float o = 0.f;
#pragma unroll
        for (int J = 0; J < kN; ++J) {
          const float* cw = Ac + ((W * kN + i) * kN + J) * RA;
#pragma unroll
          for (int w = 0; w < RA; ++w) o = fmaf(cw[w], acc[J][w][c], o);
        }
        S2[(W * S + bl) * L::LDS + i * R + p0 + pb + c] = o;
      }
}

// index of env[a, W, b] in one (R, RA, R) env, or in its raw (RA, R, R)
__device__ __forceinline__ size_t env_index(int R, int RA, int raw, int a,
                                            int W, int b) {
  return raw ? ((size_t)W * R + a) * R + b : ((size_t)a * RA + W) * R + b;
}

// The chain of one problem: C == 1 walks every slab in one block (B6);
// C > 1 is one CTA of a cluster that owns slab `rank` and pushes its
// columns of the next envs into every partner (B2, B8). RHS false: the
// operator envs alone (B8; b and envs_b unused).
template <int R, int S, int C, int RA = 4, bool RHS = true>
struct EnvChain {
  using L = EnvLayout<R, S, RA, RHS>;
  static_assert(C == 1 || C * S == R, "a CTA a slab");
  static_assert(RHS || C > 1, "the operator envs alone run on a cluster");
  static constexpr int V = R * kN * R, E = R * RA * R;
  float* sm;  // the dynamic shared memory
  const float *x, *A, *b;
  float *envs, *envs_b;
  int d, left, raw;

  __device__ float* ET(int i) const { return sm + L::OFF_ET + i * R * L::LDR; }
  __device__ float* X() const { return sm + L::OFF_X; }
  __device__ float* S2() const { return sm + L::OFF_S2; }
  __device__ float* RB(int i) const { return sm + L::OFF_RB + i * R * L::LDQ; }
  __device__ float* BS() const { return sm + L::OFF_BS; }
  __device__ float* SB() const { return sm + L::OFF_SB; }
  __device__ float* Ac() const { return sm + L::OFF_A; }

  // Copies `rows` rows of `cols` floats (a multiple of 4) at p, row
  // stride ld, into the same place in every other CTA of the cluster:
  // consecutive threads take consecutive float4s of one row and one
  // partner, the partners in turn from the next rank on.
  __device__ static void push(const float* p, int rows, int cols, int ld,
                              int rank) {
    const int c4 = cols / 4;
    for (int e = threadIdx.x; e < (C - 1) * rows * c4; e += kThreads) {
      const int q = e % c4, rest = e / c4, row = rest % rows;
      const int to = (rank + 1 + rest / rows) % C;
      const float* src = p + row * ld + 4 * q;
      st4(ttnx_cluster::cluster_map(const_cast<float*>(src), to), ld4(src));
    }
  }

  // X and Ac of site k (no barrier): the core [(a,i)][p], or for the left
  // chain the core with its bonds swapped [(c,i)][a] and A likewise (a
  // fastest across threads, so a warp's transposed stores hit distinct
  // banks)
  __device__ void stage_site(int k) const {
    const float* xk = x + (size_t)k * V;
    for (int e = threadIdx.x; e < V / 4; e += kThreads) {
      if (!left) {
        st4(X() + (e / (R / 4)) * L::LDP + (e % (R / 4)) * 4,
            ld4(xk + 4 * e));
      } else {
        const int a = e % R, i = (e / R) % kN, c = (e / (R * kN)) * 4;
        const float4 v = ld4(xk + (a * kN + i) * R + c);
        X()[(c * kN + i) * L::LDP + a] = v.x;
        X()[((c + 1) * kN + i) * L::LDP + a] = v.y;
        X()[((c + 2) * kN + i) * L::LDP + a] = v.z;
        X()[((c + 3) * kN + i) * L::LDP + a] = v.w;
      }
    }
    const float* Ak = A + k * L::NCOEF;
    for (int e = threadIdx.x; e < L::NCOEF; e += kThreads) {
      const int w = e % RA, J = (e / RA) % kN, i = (e / (RA * kN)) % kN,
                W = e / (RA * kN * kN);
      Ac()[e] = left ? Ak[((w * kN + i) * kN + J) * RA + W] : Ak[e];
    }
  }

  // BS [(ul,i)][v] = b[u0+ul, i, v], or b[v, i, u0+ul] for the left chain
  __device__ void stage_rows(int k, int u0) const {
    const float* bk = b + (size_t)k * V;
    for (int e = threadIdx.x; e < kN * S * R; e += kThreads) {
      const int v = e % R, row = e / R, ul = row / kN, i = row % kN;
      BS()[row * L::LDP + v] =
          left ? bk[(v * kN + i) * R + u0 + ul]
               : bk[((u0 + ul) * kN + i) * R + v];
    }
  }

  // The slab of columns b0.. of site k: from ET(cur), RB(cur) into
  // ET(nxt), RB(nxt), and in a cluster into the partners' ET(nxt), RB(nxt)
  // too. Starts after a barrier behind stage_site; ends without one.
  __device__ void slab(int k, int b0, int cur, int rank) const {
    const int nxt = cur ^ 1;
    if constexpr (RHS) stage_rows(k, b0);
    rows_mix<R, S, RA>(X(), ET(cur), Ac(), S2(), b0);
    __syncthreads();
    // next env^T [b][(W,a)] = sum_{(i,p)} S2[(W,b)][(i,p)] X[(a,i)][p]
    float* et = ET(nxt) + b0 * L::LDR;
    block_gemm<RA * S, R, kN * R, false, true>(
        [&](int m, int k) { return S2() + m * L::LDS + k; },
        [&](int n, int k) { return X() + (n * kN + k / R) * L::LDP + k % R; },
        [&](int m, int n, float4 v) {
          st4(et + (m % S) * L::LDR + (m / S) * R + n, v);
        });
    if constexpr (RHS) {
      rhs_slab(b0, cur, rank, et);
    } else {
      __syncthreads();
      push(et, S, RA * R, L::LDR, rank);
    }
  }

  // The rhs half of the slab b0.. (after the env product into et): from
  // RB(cur) into RB(nxt), and the pushes of et and of the rhs columns in a
  // cluster. Ends without a barrier.
  __device__ void rhs_slab(int b0, int cur, int rank, float* et) const {
    const int nxt = cur ^ 1;
    // SB[(u,i)][p] = sum_v BS[(u,i)][v] RB[p][v]
    const float* rb = RB(cur);
    block_gemm<kN * S, R, R, false, true>(
        [&](int m, int k) { return BS() + m * L::LDP + k; },
        [&](int n, int k) { return rb + n * L::LDQ + k; },
        [&](int m, int n, float4 v) { st4(SB() + m * L::LDP + n, v); });
    __syncthreads();
    if constexpr (C > 1) push(et, S, RA * R, L::LDR, rank);
    // next rhs env [a][b0 + u] = sum_{(i,p)} X[(a,i)][p] SB[(u,i)][p]
    float* rn = RB(nxt) + b0;
    block_gemm<R, S, kN * R, false, true>(
        [&](int m, int k) { return X() + (m * kN + k / R) * L::LDP + k % R; },
        [&](int n, int k) { return SB() + (n * kN + k / R) * L::LDP + k % R; },
        [&](int m, int n, float4 v) { st4(rn + m * L::LDQ + n, v); });
    if constexpr (C > 1) {
      __syncthreads();
      push(rn, R, S, L::LDQ, rank);
    }
  }

  // Columns b0 .. b0 + cols of env number `slot` from ET(i), RB(i) to the
  // outputs, in the public or raw layout (no barrier).
  __device__ void write_out(int slot, int i, int b0, int cols) const {
    float* eo = envs + (size_t)slot * E;
    const float* et = ET(i);
    for (int e = threadIdx.x; e < R * RA * cols; e += kThreads) {
      const int bl = e % cols, aw = e / cols, a = aw / RA, W = aw % RA;
      eo[env_index(R, RA, raw, a, W, b0 + bl)] =
          et[(b0 + bl) * L::LDR + W * R + a];
    }
    if constexpr (RHS) {
      float* bo = envs_b + (size_t)slot * R * R;
      const float* rb = RB(i);
      for (int e = threadIdx.x; e < R * cols; e += kThreads) {
        const int ul = e % cols, a = e / cols;
        bo[a * R + b0 + ul] = rb[a * L::LDQ + b0 + ul];
      }
    }
  }

  // The whole chain; `rank` is the CTA's slab in a cluster (0 for C == 1).
  __device__ void run(int rank) const {
    const int b0 = C == 1 ? 0 : rank * S, cols = C == 1 ? R : S;
    for (int e = threadIdx.x; e < R * L::LDR; e += kThreads)
      ET(0)[e] = e == 0 ? 1.f : 0.f;
    if constexpr (RHS)
      for (int e = threadIdx.x; e < R * L::LDQ; e += kThreads)
        RB(0)[e] = e == 0 ? 1.f : 0.f;
    __syncthreads();
    write_out(left ? 0 : d, 0, b0, cols);
    if constexpr (C > 1) ttnx_cluster::cluster_sync();  // partners started
    int cur = 0;
    for (int t = 0; t < d; ++t) {
      const int k = left ? t : d - 1 - t;
      stage_site(k);
      __syncthreads();
      if constexpr (C == 1) {
        // a slab's last product overlaps the next slab's first: they share
        // no buffer (BS and S2 were last read before the slab's barrier)
#pragma unroll 1
        for (int sl = 0; sl < R / S; ++sl) slab(k, sl * S, cur, 0);
        __syncthreads();
      } else {
        slab(k, b0, cur, rank);
        ttnx_cluster::cluster_sync();
      }
      cur ^= 1;
      write_out(left ? k + 1 : k, cur, b0, cols);
    }
  }
};

}  // namespace ttnx_envsite
