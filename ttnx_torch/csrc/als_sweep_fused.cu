// Kernel B7: the whole forward + backward batched ALS pass in one launch.
//
// Replaces ttnx/kernels/als_sweep_fused.py, als_fwd_bwd_fused_batched
// (_sweep_pair_kernel). For each problem, with x, b (d, R, n, R) (Rb == R),
// a shared MPO stack A (d, RA, n, n, RA) and shared masks (d+1, R):
//   1. the right-env chain of the input state (column-masked), sites d-1..1;
//   2. forward sites 0..d-2: rhs from the carried left rhs env, warm start
//      T_prev @ x[k], the MPO folded into the right env (RAcat), warm
//      matrix-free CG (no per-apply mask: the envs come from masked cores;
//      the result is re-masked once), two-pass Newton-Schulz polar
//      orthogonalization of the columns (V = Q T), carried left envs;
//   3. backward sites d-1..1: the mirror, rows orthogonalized (V = T Q),
//      warm start Q_fwd[k] @ T_bwd, carried right envs;
//   4. site 0 = Q_fwd[0] @ T_last.
// Optional CG stages after the main loop: cg_refine iterations whose
// applies take bf16-rounded operands with accumulation in the working
// type (the TPU kernel's raw16 dots), then cg_polish full-precision ones.
//
// What bounds it on the H100: per problem 22 local solves of 25 applies
// (about 12.6 MFLOP an apply at R = 64 in the folded form) plus 32
// Newton-Schulz iterations of three (R, R) products per orthogonalization,
// all strictly sequential inside a problem. A problem's working set (env
// stacks, forward Qs, CG iterates, RAcat) is about 2.8 MB in f32 at d = 12,
// R = 64 — far over the 227 KB of shared memory the TPU kernel's VMEM
// residency would need.
//
// Design: one block of 1024 threads (four 256-thread GEMM groups) per
// problem, grid = B, so blocks never wait on each other. Every stack lives
// in the problem's slice of a wrapper-allocated scratch buffer (size_t
// offsets: 2.9 GB at B = 512 in f64); the forward Qs are kept in the output
// itself, where the backward pass overwrites them after reading its warm
// start. Every contraction is a block GEMM from common.cuh reading strided
// views through accessors; the two independent Newton-Schulz products of
// an iteration run on different GEMM groups.
#include <cuda_bf16.h>

#include "common.cuh"

namespace ttnx_sweep {
using namespace ttnx;

constexpr int kThreads = 1024;

template <typename T>
__device__ __forceinline__ T bf16_round(T v) {
  return (T)__bfloat162float(__float2bfloat16((float)v));
}

// Views of one problem. Env stacks are kept as (RA, R, R) slices:
// Renvs[k][W][a][b] = Renv_k[a, W, b], likewise Lenvs.
template <typename T>
struct Sweep {
  const T* A;      // (d, RA, n, n, RA), shared
  const T* masks;  // (d+1, R), shared
  const T* x;      // (d, R, n, R)
  const T* b;      // (d, R, n, R)
  T* out;          // (d, R, n, R)
  T *Renvs, *Rbs, *Lenvs, *Lbs;
  T *big, *w1, *t1, *sb, *xv, *r, *p, *ap, *rhs;
  T *G, *Ya, *Yb, *Za, *Zb, *Tm, *Gh1, *Gi, *Gh2, *Tf;
  T* smem;
  T* red;
  int d, R, RA, n;
};

// Elements of scratch one problem needs; the layout is carved in this
// order by carve().
__host__ __device__ inline size_t scratch_per_problem(int d, int R, int RA,
                                                      int n) {
  const size_t E = (size_t)RA * R * R, Q2 = (size_t)R * R;
  const size_t V = (size_t)R * n * R;
  return (2 * (size_t)d + 1) * (E + Q2) + (size_t)n * RA * V + RA * V +
         7 * V + 10 * Q2;
}

template <typename T>
__device__ void carve(Sweep<T>& s, T* base) {
  const size_t E = (size_t)s.RA * s.R * s.R, Q2 = (size_t)s.R * s.R;
  const size_t V = (size_t)s.R * s.n * s.R;
  T* q = base;
  auto take = [&](size_t len) {
    T* out = q;
    q += len;
    return out;
  };
  s.Renvs = take((s.d + 1) * E);
  s.Rbs = take((s.d + 1) * Q2);
  s.Lenvs = take(s.d * E);
  s.Lbs = take(s.d * Q2);
  s.big = take(s.n * s.RA * V);  // RAcat, or m / mm of an env update
  s.w1 = take(s.RA * V);         // s, u or t
  s.t1 = take(V);
  s.sb = take(V);
  s.xv = take(V);
  s.r = take(V);
  s.p = take(V);
  s.ap = take(V);
  s.rhs = take(V);
  T** ns[10] = {&s.G, &s.Ya, &s.Yb, &s.Za, &s.Zb,
                &s.Tm, &s.Gh1, &s.Gi, &s.Gh2, &s.Tf};
  for (int i = 0; i < 10; ++i) *ns[i] = take(Q2);
}

// Renv_out[W][a][b] = sum x[a,i,p] A[W,i,j,w] x[b,j,q] Renv_in[w][p][q]
// Rb_out[a][u]      = sum x[a,i,p] b[u,i,v] Rb_in[p][v]
// with x column-masked by masks[k+1].
template <typename T>
__device__ void right_update(const Sweep<T>& s, const T* xk, int k,
                             const T* Renv_in, const T* Rb_in, T* Renv_out,
                             T* Rb_out) {
  const int R = s.R, RA = s.RA, n = s.n, nR = n * R;
  const T* cm = s.masks + (size_t)(k + 1) * R;
  const T* Ak = s.A + (size_t)k * RA * n * n * RA;
  const T* bk = s.b + (size_t)k * R * n * R;
  T* w1 = s.w1;
  T* m = s.big;
  // s[j,w][b][p] = sum_q x[b,j,q] Renv_in[w][p][q]
  gemm_block<T>(
      nR, RA * R, R,
      [&](int bj, int q) { return xk[(size_t)bj * R + q] * cm[q]; },
      [&](int q, int wp) { return Renv_in[(size_t)wp * R + q]; },
      [&](int bj, int wp, T v) {
        const int bb = bj / n, j = bj % n, w = wp / R, pp = wp % R;
        w1[(((size_t)j * RA + w) * R + bb) * R + pp] = v;
      },
      s.smem);
  // sb[(u,i)][p] = sum_v b[u,i,v] Rb_in[p][v]
  gemm_block<T>(
      nR, R, R, [&](int ui, int v) { return bk[(size_t)ui * R + v]; },
      [&](int v, int pp) { return Rb_in[(size_t)pp * R + v]; },
      [&](int ui, int pp, T v) { s.sb[(size_t)ui * R + pp] = v; }, s.smem,
      2);
  __syncthreads();
  // m[W,i] = sum_{j,w} A[W,i,j,w] s[j,w]
  mix_small<T>(Ak, w1, m, RA, n, n, RA, n * n * RA, n * RA, RA, 1, R * R,
               threadIdx.x, blockDim.x);
  __syncthreads();
  // Renv_out[W][a][b] = sum_{i,p} x[a,i,p] m[W,i][b][p]
  gemm_block<T>(
      R, RA * R, nR,
      [&](int a, int ip) { return xk[(size_t)a * nR + ip] * cm[ip % R]; },
      [&](int ip, int Wb) {
        const int W = Wb / R, bb = Wb % R, i = ip / R, pp = ip % R;
        return m[(((size_t)W * n + i) * R + bb) * R + pp];
      },
      [&](int a, int Wb, T v) {
        Renv_out[((size_t)(Wb / R) * R + a) * R + Wb % R] = v;
      },
      s.smem);
  // Rb_out[a][u] = sum_{i,p} x[a,i,p] sb[(u,i)][p]
  gemm_block<T>(
      R, R, nR,
      [&](int a, int ip) { return xk[(size_t)a * nR + ip] * cm[ip % R]; },
      [&](int ip, int u) {
        return s.sb[((size_t)u * n + ip / R) * R + ip % R];
      },
      [&](int a, int u, T v) { Rb_out[(size_t)a * R + u] = v; }, s.smem, 2);
  __syncthreads();
}

// L_out[w][c][d] = sum Q[a,i,c] L_in[W][a][b] A[W,i,j,w] Q[b,j,d]
// Lb_out[c][v]   = sum_{a,i} Q[a,i,c] t1[(a,i)][v]   (t1 = Lb_in b, rhs_build)
template <typename T>
__device__ void left_update(const Sweep<T>& s, const T* Q, int k,
                            const T* L_in, T* L_out, T* Lb_out) {
  const int R = s.R, RA = s.RA, n = s.n, nR = n * R;
  const T* Ak = s.A + (size_t)k * RA * n * n * RA;
  T* w1 = s.w1;
  T* mm = s.big;
  // t[i,W][c][b] = sum_a Q[a,i,c] L_in[W][a][b]
  gemm_block<T>(
      nR, RA * R, R, [&](int ic, int a) { return Q[(size_t)a * nR + ic]; },
      [&](int a, int Wb) {
        return L_in[((size_t)(Wb / R) * R + a) * R + Wb % R];
      },
      [&](int ic, int Wb, T v) {
        const int i = ic / R, c = ic % R, W = Wb / R, bb = Wb % R;
        w1[(((size_t)i * RA + W) * R + c) * R + bb] = v;
      },
      s.smem);
  // Lb_out[c][v] = sum_{(a,i)} Q[(a,i)][c] t1[(a,i)][v]
  gemm_block<T>(
      R, R, nR, [&](int c, int ai) { return Q[(size_t)ai * R + c]; },
      [&](int ai, int v) { return s.t1[(size_t)ai * R + v]; },
      [&](int c, int v, T val) { Lb_out[(size_t)c * R + v] = val; }, s.smem,
      2);
  __syncthreads();
  // mm[w,j] = sum_{i,W} A[W,i,j,w] t[i,W]
  mix_small<T>(Ak, w1, mm, RA, n, n, RA, 1, RA, n * RA, n * n * RA, R * R,
               threadIdx.x, blockDim.x);
  __syncthreads();
  // L_out[w][c][d] = sum_{j,b} mm[w,j][c][b] Q[b,j,d]
  gemm_block<T>(
      RA * R, R, nR,
      [&](int wc, int jb) {
        const int w = wc / R, c = wc % R, j = jb / R, bb = jb % R;
        return mm[(((size_t)w * n + j) * R + c) * R + bb];
      },
      [&](int jb, int dd) {
        return Q[(size_t)(jb % R) * nR + (jb / R) * R + dd];
      },
      [&](int wc, int dd, T v) { L_out[(size_t)wc * R + dd] = v; }, s.smem);
  __syncthreads();
}

// t1[a][(i,v)] = sum_u Lb[a][u] b[u,i,v];
// rhs[(a,i)][c] = sum_v t1[(a,i)][v] Rb[c][v] * m_l[a] m_r[c]
template <typename T>
__device__ void rhs_build(const Sweep<T>& s, int k, const T* Lb,
                          const T* Rb) {
  const int R = s.R, n = s.n, nR = n * R;
  const T* bk = s.b + (size_t)k * R * n * R;
  const T* ml = s.masks + (size_t)k * R;
  const T* mr = ml + R;
  gemm_block<T>(
      R, nR, R, [&](int a, int u) { return Lb[(size_t)a * R + u]; },
      [&](int u, int iv) { return bk[(size_t)u * nR + iv]; },
      [&](int a, int iv, T v) { s.t1[(size_t)a * nR + iv] = v; }, s.smem);
  __syncthreads();
  gemm_block<T>(
      nR, R, R, [&](int ai, int v) { return s.t1[(size_t)ai * R + v]; },
      [&](int v, int c) { return Rb[(size_t)c * R + v]; },
      [&](int ai, int c, T v) {
        s.rhs[(size_t)ai * R + c] = v * (ml[ai / n] * mr[c]);
      },
      s.smem);
  __syncthreads();
}

// RAcat[i][J][W][c][d] = sum_w A[W,i,J,w] Renv[w][c][d]   (into s.big)
template <typename T>
__device__ void fold(const Sweep<T>& s, int k, const T* Renv) {
  const int R = s.R, RA = s.RA, n = s.n;
  const T* Ak = s.A + (size_t)k * RA * n * n * RA;
  for (int i = 0; i < n; ++i)
    mix_small<T>(Ak + i * n * RA, Renv, s.big + (size_t)i * n * RA * R * R,
                 n, RA, 1, RA, RA, n * n * RA, 0, 1, R * R, threadIdx.x,
                 blockDim.x);
  __syncthreads();
}

// out = K v with the folded operands (no mask):
//   u[i][(W,c)][b] = sum_{J,d} RAcat[i][J][(W,c)][d] v[b,J,d]
//   out[a,i,c]     = sum_{W,b} L[W][a][b] u[i][(W,c)][b]
// B16: operands rounded to bf16, u rounded to bf16 before the second GEMM.
template <typename T, bool B16>
__device__ void apply_k(const Sweep<T>& s, const T* L, const T* v, T* out) {
  const int R = s.R, RA = s.RA, n = s.n, nR = n * R, WR = RA * R;
  const T* rac = s.big;
  T* u = s.w1;
  gemm_block<T>(
      n * WR, R, nR,
      [&](int row, int Jd) {
        const int i = row / WR, Wc = row % WR, J = Jd / R, dd = Jd % R;
        const T a = rac[(((size_t)i * n + J) * WR + Wc) * R + dd];
        return B16 ? bf16_round(a) : a;
      },
      [&](int Jd, int bb) {
        const T a = v[(size_t)bb * nR + Jd];
        return B16 ? bf16_round(a) : a;
      },
      [&](int row, int bb, T val) {
        u[(size_t)row * R + bb] = B16 ? bf16_round(val) : val;
      },
      s.smem);
  __syncthreads();
  gemm_block<T>(
      R, nR, WR,
      [&](int a, int Wb) {
        const T l = L[((size_t)(Wb / R) * R + a) * R + Wb % R];
        return B16 ? bf16_round(l) : l;
      },
      [&](int Wb, int ic) {
        const int W = Wb / R, bb = Wb % R, i = ic / R, c = ic % R;
        return u[(((size_t)i * RA + W) * R + c) * R + bb];
      },
      [&](int a, int ic, T val) { out[(size_t)a * nR + ic] = val; },
      s.smem);
  __syncthreads();
}

// r = rhs - K x; p = r; returns r.r
template <typename T>
__device__ T restart(const Sweep<T>& s, const T* L) {
  const int V = s.R * s.n * s.R;
  apply_k<T, false>(s, L, s.xv, s.ap);
  T loc = T(0);
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const T ri = s.rhs[i] - s.ap[i];
    s.r[i] = ri;
    s.p[i] = ri;
    loc += ri * ri;
  }
  return block_sum<T>(loc, s.red);
}

template <typename T, bool B16>
__device__ void cg_loop(const Sweep<T>& s, const T* L, T rs, int iters) {
  const int V = s.R * s.n * s.R, tid = threadIdx.x, nt = blockDim.x;
  for (int it = 0; it < iters; ++it) {
    apply_k<T, B16>(s, L, s.p, s.ap);
    T loc = T(0);
    for (int i = tid; i < V; i += nt) loc += s.p[i] * s.ap[i];
    const T denom = block_sum<T>(loc, s.red);
    const T alpha = fabs(denom) > T(0) ? rs / denom : T(0);
    loc = T(0);
    for (int i = tid; i < V; i += nt) {
      s.xv[i] += alpha * s.p[i];
      const T ri = s.r[i] - alpha * s.ap[i];
      s.r[i] = ri;
      loc += ri * ri;
    }
    const T rs_new = block_sum<T>(loc, s.red);
    const T beta = fabs(rs) > T(0) ? rs_new / rs : T(0);
    for (int i = tid; i < V; i += nt) s.p[i] = s.r[i] + beta * s.p[i];
    rs = rs_new;
    __syncthreads();
  }
}

// CG on the site system from the masked warm start in s.xv; the result,
// masked, stays in s.xv.
template <typename T>
__device__ void cg_site(const Sweep<T>& s, int k, const T* L, int iters,
                        int refine, int polish) {
  const int R = s.R, nR = s.n * R, V = R * nR;
  cg_loop<T, false>(s, L, restart<T>(s, L), iters);
  if (refine > 0) cg_loop<T, true>(s, L, restart<T>(s, L), refine);
  if (polish > 0) cg_loop<T, false>(s, L, restart<T>(s, L), polish);
  const T* ml = s.masks + (size_t)k * R;
  for (int i = threadIdx.x; i < V; i += blockDim.x)
    s.xv[i] *= ml[i / nR] * ml[R + i % R];
  __syncthreads();
}

// Coupled Newton-Schulz on s.G (SPD, (R, R)): Gh = G^{1/2} and s.Gi =
// G^{-1/2}, with the per-problem Frobenius scaling of _ns_polar.
template <typename T>
__device__ void ns_polar(Sweep<T>& s, int iters, T* Gh) {
  const int R = s.R, RR = R * R, tid = threadIdx.x, nt = blockDim.x;
  T loc = T(0);
  for (int e = tid; e < RR; e += nt) loc += s.G[e] * s.G[e];
  const T fr = sqrt(block_sum<T>(loc, s.red));
  const T sq = sqrt(fr);
  const T inv_fr = T(1) / fr;
  T *Y = s.Ya, *Y2 = s.Yb, *Z = s.Za, *Z2 = s.Zb;
  for (int e = tid; e < RR; e += nt) {
    Y[e] = s.G[e] * inv_fr;
    Z[e] = e / R == e % R ? T(1) : T(0);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    T* Tm = s.Tm;
    // Tm = 1.5 I - 0.5 Z Y
    gemm_block<T>(
        R, R, R, [&](int a, int c) { return Z[(size_t)a * R + c]; },
        [&](int c, int bb) { return Y[(size_t)c * R + bb]; },
        [&](int a, int bb, T v) {
          Tm[(size_t)a * R + bb] = (a == bb ? T(1.5) : T(0)) - T(0.5) * v;
        },
        s.smem);
    __syncthreads();
    // Y2 = Y Tm and Z2 = Tm Z, side by side on two groups
    gemm_block<T>(
        R, R, R, [&](int a, int c) { return Y[(size_t)a * R + c]; },
        [&](int c, int bb) { return Tm[(size_t)c * R + bb]; },
        [&](int a, int bb, T v) { Y2[(size_t)a * R + bb] = v; }, s.smem);
    gemm_block<T>(
        R, R, R, [&](int a, int c) { return Tm[(size_t)a * R + c]; },
        [&](int c, int bb) { return Z[(size_t)c * R + bb]; },
        [&](int a, int bb, T v) { Z2[(size_t)a * R + bb] = v; }, s.smem, 2);
    __syncthreads();
    T* t = Y;
    Y = Y2;
    Y2 = t;
    t = Z;
    Z = Z2;
    Z2 = t;
  }
  const T inv_sq = T(1) / sq;
  for (int e = tid; e < RR; e += nt) {
    Gh[e] = Y[e] * sq;
    s.Gi[e] = Z[e] * inv_sq;
  }
  __syncthreads();
}

// Forward gauge: V (R n, R) = Q T with orthonormal masked columns Q (into
// Qout) and T = Gh2 Gh1 (into s.Tf); two Newton-Schulz passes.
template <typename T>
__device__ void orth_cols(Sweep<T>& s, int k, T* Qout, int it1, int it2) {
  const int R = s.R, nR = s.n * R;
  const T* ml = s.masks + (size_t)k * R;
  const T* mr = ml + R;
  const T* in = s.xv;
  T* Q1 = s.r;
  for (int pass = 0; pass < 2; ++pass) {
    T* Qp = pass == 0 ? Q1 : Qout;
    // G = in^T in + diag(1 - m_r)
    gemm_block<T>(
        R, R, nR, [&](int c, int ai) { return in[(size_t)ai * R + c]; },
        [&](int ai, int c2) { return in[(size_t)ai * R + c2]; },
        [&](int c, int c2, T v) {
          s.G[(size_t)c * R + c2] = v + (c == c2 ? T(1) - mr[c] : T(0));
        },
        s.smem);
    __syncthreads();
    ns_polar<T>(s, pass == 0 ? it1 : it2, pass == 0 ? s.Gh1 : s.Gh2);
    // Qp = in Gi * m2
    gemm_block<T>(
        nR, R, R, [&](int ai, int c2) { return in[(size_t)ai * R + c2]; },
        [&](int c2, int c) { return s.Gi[(size_t)c2 * R + c]; },
        [&](int ai, int c, T v) {
          Qp[(size_t)ai * R + c] = v * (ml[ai / s.n] * mr[c]);
        },
        s.smem);
    __syncthreads();
    in = Q1;
  }
  // T = Gh2 Gh1
  gemm_block<T>(
      R, R, R, [&](int a, int c) { return s.Gh2[(size_t)a * R + c]; },
      [&](int c, int bb) { return s.Gh1[(size_t)c * R + bb]; },
      [&](int a, int bb, T v) { s.Tf[(size_t)a * R + bb] = v; }, s.smem);
  __syncthreads();
}

// Backward gauge: V (R, n R) = T Q with orthonormal masked rows Q (into
// Qout) and T = Gh1 Gh2 (into s.Tf).
template <typename T>
__device__ void orth_rows(Sweep<T>& s, int k, T* Qout, int it1, int it2) {
  const int R = s.R, nR = s.n * R;
  const T* ml = s.masks + (size_t)k * R;
  const T* mr = ml + R;
  const T* in = s.xv;
  T* Q1 = s.r;
  for (int pass = 0; pass < 2; ++pass) {
    T* Qp = pass == 0 ? Q1 : Qout;
    // G = in in^T + diag(1 - m_l)
    gemm_block<T>(
        R, R, nR, [&](int a, int ic) { return in[(size_t)a * nR + ic]; },
        [&](int ic, int a2) { return in[(size_t)a2 * nR + ic]; },
        [&](int a, int a2, T v) {
          s.G[(size_t)a * R + a2] = v + (a == a2 ? T(1) - ml[a] : T(0));
        },
        s.smem);
    __syncthreads();
    ns_polar<T>(s, pass == 0 ? it1 : it2, pass == 0 ? s.Gh1 : s.Gh2);
    // Qp = Gi in * m2
    gemm_block<T>(
        R, nR, R, [&](int a, int a2) { return s.Gi[(size_t)a * R + a2]; },
        [&](int a2, int ic) { return in[(size_t)a2 * nR + ic]; },
        [&](int a, int ic, T v) {
          Qp[(size_t)a * nR + ic] = v * (ml[a] * mr[ic % R]);
        },
        s.smem);
    __syncthreads();
    in = Q1;
  }
  // T = Gh1 Gh2
  gemm_block<T>(
      R, R, R, [&](int a, int c) { return s.Gh1[(size_t)a * R + c]; },
      [&](int c, int bb) { return s.Gh2[(size_t)c * R + bb]; },
      [&](int a, int bb, T v) { s.Tf[(size_t)a * R + bb] = v; }, s.smem);
  __syncthreads();
}

// dst[a][(i,c)] = sum_b Tl[a][b] src[b][(i,c)] * m_l[a] m_r[c]
template <typename T>
__device__ void left_mul(const Sweep<T>& s, int k, const T* Tl,
                         const T* src, T* dst) {
  const int R = s.R, nR = s.n * R;
  const T* ml = s.masks + (size_t)k * R;
  const T* mr = ml + R;
  gemm_block<T>(
      R, nR, R, [&](int a, int bb) { return Tl[(size_t)a * R + bb]; },
      [&](int bb, int ic) { return src[(size_t)bb * nR + ic]; },
      [&](int a, int ic, T v) {
        dst[(size_t)a * nR + ic] = v * (ml[a] * mr[ic % R]);
      },
      s.smem);
  __syncthreads();
}

// dst[(a,i)][c] = sum_b src[(a,i)][b] Tr[b][c] * m_l[a] m_r[c]
template <typename T>
__device__ void right_mul(const Sweep<T>& s, int k, const T* src,
                          const T* Tr, T* dst) {
  const int R = s.R, nR = s.n * R;
  const T* ml = s.masks + (size_t)k * R;
  const T* mr = ml + R;
  gemm_block<T>(
      nR, R, R, [&](int ai, int bb) { return src[(size_t)ai * R + bb]; },
      [&](int bb, int c) { return Tr[(size_t)bb * R + c]; },
      [&](int ai, int c, T v) {
        dst[(size_t)ai * R + c] = v * (ml[ai / s.n] * mr[c]);
      },
      s.smem);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sweep_pair_kernel(const T* A, const T* b, const T* x, const T* masks,
                      T* out, T* scratch, size_t scratch_stride, int d, int R,
                      int RA, int n, int cg_iters, int cg_refine,
                      int cg_polish, int ns1, int ns2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[32];
  Sweep<T> s;
  const size_t bb = blockIdx.x;
  const size_t V = (size_t)R * n * R, E = (size_t)RA * R * R;
  s.A = A;
  s.masks = masks;
  s.x = x + bb * d * V;
  s.b = b + bb * d * V;
  s.out = out + bb * d * V;
  s.d = d;
  s.R = R;
  s.RA = RA;
  s.n = n;
  s.smem = reinterpret_cast<T*>(smem_raw);
  s.red = red;
  carve<T>(s, scratch + bb * scratch_stride);
  const int tid = threadIdx.x, nt = blockDim.x;

  fill_e0<T>(s.Renvs + d * E, (int)E, tid, nt);
  fill_e0<T>(s.Rbs + (size_t)d * R * R, R * R, tid, nt);
  fill_e0<T>(s.Lenvs, (int)E, tid, nt);
  fill_e0<T>(s.Lbs, R * R, tid, nt);
  __syncthreads();

  // 1. right-env chain of the input, sites d-1..1 (Renv_0 is never used)
  for (int k = d - 1; k >= 1; --k)
    right_update<T>(s, s.x + k * V, k, s.Renvs + (k + 1) * E,
                    s.Rbs + (size_t)(k + 1) * R * R, s.Renvs + k * E,
                    s.Rbs + (size_t)k * R * R);

  // 2. forward half-sweep; Q_fwd[k] is kept in out[k]
  for (int k = 0; k < d - 1; ++k) {
    rhs_build<T>(s, k, s.Lbs + (size_t)k * R * R,
                 s.Rbs + (size_t)(k + 1) * R * R);
    if (k == 0) {
      const T* ml = s.masks;
      for (int i = tid; i < (int)V; i += nt)
        s.xv[i] = s.x[i] * (ml[i / (n * R)] * ml[R + i % R]);
      __syncthreads();
    } else {
      left_mul<T>(s, k, s.Tf, s.x + k * V, s.xv);
    }
    fold<T>(s, k, s.Renvs + (k + 1) * E);
    cg_site<T>(s, k, s.Lenvs + k * E, cg_iters, cg_refine, cg_polish);
    orth_cols<T>(s, k, s.out + k * V, ns1, ns2);
    left_update<T>(s, s.out + k * V, k, s.Lenvs + k * E,
                   s.Lenvs + (k + 1) * E, s.Lbs + (size_t)(k + 1) * R * R);
  }

  // 3. backward half-sweep; the right envs of the new cores overwrite the
  // input chain's, which the forward pass no longer needs
  for (int k = d - 1; k >= 1; --k) {
    rhs_build<T>(s, k, s.Lbs + (size_t)k * R * R,
                 s.Rbs + (size_t)(k + 1) * R * R);
    if (k == d - 1)
      left_mul<T>(s, k, s.Tf, s.x + k * V, s.xv);
    else
      right_mul<T>(s, k, s.out + k * V, s.Tf, s.xv);
    fold<T>(s, k, s.Renvs + (k + 1) * E);
    cg_site<T>(s, k, s.Lenvs + k * E, cg_iters, cg_refine, cg_polish);
    orth_rows<T>(s, k, s.out + k * V, ns1, ns2);
    right_update<T>(s, s.out + k * V, k, s.Renvs + (k + 1) * E,
                    s.Rbs + (size_t)(k + 1) * R * R, s.Renvs + k * E,
                    s.Rbs + (size_t)k * R * R);
  }

  // 4. site 0 = Q_fwd[0] @ T_last, masked
  right_mul<T>(s, 0, s.out, s.Tf, s.r);
  for (int i = tid; i < (int)V; i += nt) s.out[i] = s.r[i];
}

template <typename T>
int sweep_pair(const T* A, const T* b, const T* x, const T* masks, T* out,
               T* scratch, int B, int d, int R, int RA, int n, int cg_iters,
               int cg_refine, int cg_polish, int ns1, int ns2,
               cudaStream_t s) {
  if (d < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (kThreads / kGroup) * kTileSmem * sizeof(T);
  cudaFuncSetAttribute(sweep_pair_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  sweep_pair_kernel<T><<<B, kThreads, smem, s>>>(
      A, b, x, masks, out, scratch, scratch_per_problem(d, R, RA, n), d, R,
      RA, n, cg_iters, cg_refine, cg_polish, ns1, ns2);
  return (int)cudaGetLastError();
}
}  // namespace ttnx_sweep

using namespace ttnx_sweep;

// Scratch elements per problem: the wrapper allocates B times this.
extern "C" long long ttnx_als_sweep_pair_scratch(int d, int R, int RA,
                                                 int n) {
  return (long long)scratch_per_problem(d, R, RA, n);
}

#define TTNX_SWEEP_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* A, const void* b, const void* x,            \
                      const void* masks, void* out, void* scratch, int B,     \
                      int d, int R, int RA, int n, int cg_iters,              \
                      int cg_refine, int cg_polish, int ns1, int ns2,         \
                      void* stream) {                                         \
    return sweep_pair<T>((const T*)A, (const T*)b, (const T*)x,               \
                         (const T*)masks, (T*)out, (T*)scratch, B, d, R, RA,  \
                         n, cg_iters, cg_refine, cg_polish, ns1, ns2,         \
                         (cudaStream_t)stream);                               \
  }

TTNX_SWEEP_ENTRY(ttnx_als_sweep_pair_f32, float)
TTNX_SWEEP_ENTRY(ttnx_als_sweep_pair_f64, double)
