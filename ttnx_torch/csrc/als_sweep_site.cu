// Kernel B7, site-resident route: the whole forward + backward batched ALS
// pass in one launch, f32, at compile-time shapes (R, n, RA).
//
// Replaces ttnx/kernels/als_sweep_fused.py, als_fwd_bwd_fused_batched
// (_sweep_pair_kernel, pallas_call at :545), as csrc/als_sweep_fused.cu
// does for every other shape and type: the right-env chain of the input,
// the forward half-sweep (rhs from the carried left envs, warm start from
// the transported iterate, warm matrix-free CG, two-pass Newton-Schulz
// polar gauge of the columns, carried left envs), the backward mirror
// (rows, carried right envs) and site 0. No cg_refine stage: the bf16
// refine keeps PR 2's kernel, whose rounding points follow the TPU's
// folded form.
//
// What bounds it on the H100: a problem is a chain of dependent steps
// (22 local solves of 25 applies, 32 Newton-Schulz iterations of three
// (R, R) products a site), about 6 GFLOP of f32 FMA at R = 64, so one
// problem is bound by one SM's FMA rate (507 GFLOP/s at 1.98 GHz), and the
// batch by FMA work over 132 SMs. PR 2's kernel reached 9 % of that rate:
// every operand came from L2 through accessors with runtime index
// arithmetic, with no prefetch and with spills. This kernel reaches 27-29 %
// of it (the CG applies and the Newton-Schulz products alike, measured by
// scripts/probe_torch_sweep.py): with one block of 16 warps an SM, the
// barriers (eleven a CG iteration) and the latency of the shared-memory
// loads are not hidden; a second slab buffer, which would halve the
// apply's barriers, does not fit in the 227 KB.
//
// Design: one 512-thread block a problem (grid = B), every product on the
// CUDA cores in IEEE f32 FMA (no TF32), operands in shared memory:
//   * The apply K p is unfolded: t_w = p Renv_w^T, the mix with A, then
//     sum_W L_W s_W. L (as [a][(W,b)]) and Renv (as [d][(w,c)]) are loaded
//     into shared memory once a site and stay there for the site's whole
//     CG; p lives in shared memory; x, r and K p in device memory (L2),
//     each value touched only by the thread that owns it, once an
//     iteration (kept in registers they cost spills at 128 registers).
//   * The apply streams over 16-wide column slabs c: each thread's
//     register tile of t holds every (w, J) of its (b, c) pairs, so the
//     mix with A runs in registers and only the slab of s ([(W,b)][(i,c)])
//     goes to shared memory, to be read by the L product of the same slab.
//   * Every product is a block GEMM from shared memory (site_engine.cuh):
//     8 x 4 register tiles, 16-byte loads along k or along the tile, KS
//     lanes of a warp splitting k, summed by shuffles (reduce-scatter), so
//     the small (R, R) products of the gauge still use all 16 warps.
//   * The env updates are the same streamed product with the core in place
//     of p (left envs through the mirror: the transposed core and the MPO
//     with its bond indices swapped); rhs, warm start, the gauge and the
//     Newton-Schulz iterations stage their operands into shared memory.
//   * Block sums are warp shuffles and one shared-memory exchange (one
//     barrier); p.Kp comes from the owned values right after the apply.
//
// Shared memory at R = 64, n = 2, RA = 4 (floats; padded rows keep the
// 16-byte loads of one warp on distinct banks):
//   Renv^T [d][(w,c)]  64 x 260   16,640   66,560 B
//   L      [a][(W,b)]  64 x 260   16,640   66,560 B
//   p      [(b,J)][d] 128 x  68    8,704   34,816 B
//   s slab [(W,b)][(i,c)] 256 x 36 9,216   36,864 B
//   A, block sums                    128      512 B
//   total                         51,328  205,312 B  (of 232,448)
// The gauge reuses the first two regions for its eight (R, R) matrices,
// the env updates, rhs and warm start stage their operands there too.
#include "site_engine.cuh"

namespace ttnx_site {

extern __shared__ __align__(16) float site_smem[];  // one problem's regions

// v = C[m][n..n+3]: adds x where the column is the diagonal
__device__ __forceinline__ void add_diag(float4& v, int m, int n, float x) {
  v.x += m == n ? x : 0.f;
  v.y += m == n + 1 ? x : 0.f;
  v.z += m == n + 2 ? x : 0.f;
  v.w += m == n + 3 ? x : 0.f;
}

// One problem's pass: shapes, shared-memory regions, scratch and phases.
// Every phase is called by the whole block and ends with a barrier.
template <int R, int N, int RA>
struct Site {
  static_assert(N == 2 && RA == 4 && (R == 32 || R == 64),
                "instantiated for (R, n, RA) = (64, 2, 4) and (32, 2, 4)");
  static constexpr int NR = N * R, V = R * NR, E = RA * R * R, Q2 = R * R;
  static constexpr int LGR = R == 64 ? 6 : 5;
  static constexpr int LDP = R + 4;       // core buffers [(a,i)][c]
  static constexpr int LDR = RA * R + 4;  // [q][(w,p)] and [a][(W,b)]
  static constexpr int LDS = N * CS + 4;  // slab [(W,b)][(i,c)]
  static constexpr int LDQ = R + 4;       // staged (R, R) operands
  static constexpr int SLABS = R / CS;
  static constexpr int OWNERS = 8 * R;  // threads of the apply's tiles
  static constexpr int NCOEF = RA * N * N * RA;
  static constexpr int OFF_L = R * LDR, OFF_P = 2 * R * LDR,
                       OFF_S = OFF_P + NR * LDP,
                       OFF_A = OFF_S + RA * R * LDS, OFF_RED = OFF_A + NCOEF,
                       SMEM = OFF_RED + 64;  // floats
  static_assert(8 * Q2 <= OFF_P && NR * LDP + R * LDQ <= R * LDR &&
                    NR * LDP <= RA * R * LDS,
                "staging fits the regions");

  // the shared-memory regions: constant offsets into the dynamic array
  __device__ static float* RT() { return site_smem; }
  __device__ static float* Lr() { return site_smem + OFF_L; }
  __device__ static float* P() { return site_smem + OFF_P; }
  __device__ static float* S() { return site_smem + OFF_S; }
  __device__ static float* Ac() { return site_smem + OFF_A; }
  __device__ static float* red() { return site_smem + OFF_RED; }
  int flip;
  const float *A, *masks, *x, *b;  // problem inputs
  float *out, *q;                   // the problem's output and scratch
  int d;
  // the scratch buffers: fixed offsets from q first, then the env stacks
  // (few live pointers: every buffer is q plus an offset)
  __device__ float* xv() const { return q; }
  __device__ float* rhs() const { return q + V; }
  __device__ float* t1() const { return q + 2 * V; }
  __device__ float* r() const { return q + 3 * V; }
  __device__ float* ap() const { return q + 4 * V; }
  __device__ float* Tf() const { return q + 5 * V; }
  __device__ float* Renvs() const { return q + 5 * V + Q2; }
  __device__ float* Rbs() const { return Renvs() + (size_t)(d + 1) * E; }
  __device__ float* Lenvs() const { return Rbs() + (size_t)(d + 1) * Q2; }
  __device__ float* Lbs() const { return Lenvs() + (size_t)d * E; }

  __device__ float* ns(int i) const { return RT() + i * Q2; }
  __device__ const float* ml(int k) const { return masks + k * R; }

  // ---- staging (no barrier) ----
  // dst [(a,i)][c] <- core (R, N, R), columns scaled by cm if given
  __device__ void stage_core(float* dst, const float* src,
                             const float* cm) const {
    for (int e = threadIdx.x; e < V / 4; e += kThreads) {
      const int row = e >> (LGR - 2), c = (e & (R / 4 - 1)) * 4;
      float4 v = ld4(src + 4 * e);
      if (cm) {
        v.x *= cm[c];
        v.y *= cm[c + 1];
        v.z *= cm[c + 2];
        v.w *= cm[c + 3];
      }
      st4(dst + row * LDP + c, v);
    }
  }
  // dst [(c,i)][a] = core[a][i][c]: the core with its bonds swapped
  __device__ void stage_core_t(float* dst, const float* src) const {
    for (int e = threadIdx.x; e < V / 4; e += kThreads) {
      const int row = e >> (LGR - 2), c = (e & (R / 4 - 1)) * 4;
      const int a = row / N, i = row % N;
      const float4 v = ld4(src + 4 * e);
      dst[(c * N + i) * LDP + a] = v.x;
      dst[((c + 1) * N + i) * LDP + a] = v.y;
      dst[((c + 2) * N + i) * LDP + a] = v.z;
      dst[((c + 3) * N + i) * LDP + a] = v.w;
    }
  }
  // dst [q][(w,p)] = env[w][p][q] for an env (RA, R, R)
  __device__ void stage_env_t(float* dst, const float* src) const {
    for (int e = threadIdx.x; e < E / 4; e += kThreads) {
      const int wp = e >> (LGR - 2), q = (e & (R / 4 - 1)) * 4;
      const float4 v = ld4(src + 4 * e);
      dst[q * LDR + wp] = v.x;
      dst[(q + 1) * LDR + wp] = v.y;
      dst[(q + 2) * LDR + wp] = v.z;
      dst[(q + 3) * LDR + wp] = v.w;
    }
  }
  // dst [a][(W,b)] = env[W][a][b]
  __device__ void stage_env_l(float* dst, const float* src) const {
    for (int e = threadIdx.x; e < E / 4; e += kThreads) {
      const int Wa = e >> (LGR - 2), bq = (e & (R / 4 - 1)) * 4;
      st4(dst + (Wa & (R - 1)) * LDR + (Wa >> LGR) * R + bq,
          ld4(src + 4 * e));
    }
  }
  // dst (R, R) with row stride LDQ
  __device__ void stage_sq(float* dst, const float* src) const {
    for (int e = threadIdx.x; e < Q2 / 4; e += kThreads)
      st4(dst + (e >> (LGR - 2)) * LDQ + (e & (R / 4 - 1)) * 4,
          ld4(src + 4 * e));
  }
  // Ac [W][i][J][w] = A_k, or A_k with its bond indices swapped
  __device__ void stage_coef(int k, bool swap) const {
    const float* Ak = A + k * NCOEF;
    for (int e = threadIdx.x; e < NCOEF; e += kThreads) {
      const int w = e % RA, J = (e / RA) % N, i = (e / (RA * N)) % N,
                W = e / (RA * N * N);
      Ac()[e] = swap ? Ak[((w * N + i) * N + J) * RA + W] : Ak[e];
    }
  }

  // ---- the streamed product ----
  // S [(W,b)][(i,c)] of slab sl from P, RT and Ac (site_engine.cuh)
  __device__ void step1_mix(int sl) const {
    slab_mix<R, N, RA, LDP, LDR, LDS>(P(), RT(), Ac(), S(), sl);
  }

  // K p for p in P (L in Lr, Renv^T in RT, A in Ac) into ap (device
  // memory, the core layout); each value is written by the thread that
  // owns it in the CG (row a, index i, columns c0 + 16 sl .. + 3, see
  // own_*), owners being the first OWNERS threads.
  __device__ void apply() const {
    const int tid = threadIdx.x, g = tid & 7, pos = tid >> 3;
    const int nt = pos & 7, m0 = (pos >> 3) * 8;
    const int own = own_row() * R + own_col();
#pragma unroll 1
    for (int sl = 0; sl < SLABS; ++sl) {
      step1_mix(sl);
      __syncthreads();
      if (tid < OWNERS) {
        float acc[8][4] = {};
        mma_chunks<8, 8, RA * R, false, false>(
            acc, m0, nt * 4, g,
            [&](int m, int k) { return Lr() + m * LDR + k; },
            [&](int n, int k) { return S() + k * LDS + n; });
        reduce_scatter<8, 8>(acc, g);
        st4(ap() + own + sl * CS,
            make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]));
      }
      __syncthreads();
    }
  }
  // the owned values of apply(): row (a, i) of the core, first column
  __device__ int own_row() const {
    const int tid = threadIdx.x, pos = tid >> 3;
    return ((pos >> 3) * 8 + (tid & 7)) * N + ((pos & 7) >> 2);
  }
  __device__ int own_col() const { return ((threadIdx.x >> 3) & 3) * 4; }

  // ---- CG on the site system: x in xv, r and K p in r, ap (device
  // memory; each value only ever touched by its owner), p in P ----
  __device__ float restart() {
    stage_core(P(), xv(), nullptr);
    __syncthreads();
    apply();
    const int row = own_row(), col = own_col();
    float loc = 0.f;
    if (threadIdx.x < OWNERS) {
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl) {
        const int o = row * R + sl * CS + col;
        const float4 h = ld4(rhs() + o), q = ld4(ap() + o);
        const float4 ri = make_float4(h.x - q.x, h.y - q.y, h.z - q.z,
                                      h.w - q.w);
        st4(r() + o, ri);
        st4(P() + row * LDP + sl * CS + col, ri);
        loc += dot4(ri, ri);
      }
    }
    return block_sum(loc, red(), flip);
  }

  __device__ void cg_run(int iters) {
    float rs = restart();
    const int row = own_row(), col = own_col();
    const bool own = threadIdx.x < OWNERS;
    for (int it = 0; it < iters; ++it) {
      apply();
      float loc = 0.f;
      if (own) {
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl)
          loc += dot4(ld4(P() + row * LDP + sl * CS + col),
                      ld4(ap() + row * R + sl * CS + col));
      }
      const float denom = block_sum(loc, red(), flip);
      const float alpha = fabsf(denom) > 0.f ? rs / denom : 0.f;
      loc = 0.f;
      if (own) {
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl) {
          const int o = row * R + sl * CS + col;
          st4(xv() + o, axpy4(alpha, ld4(P() + row * LDP + sl * CS + col),
                            ld4(xv() + o)));
          const float4 ri = axpy4(-alpha, ld4(ap() + o), ld4(r() + o));
          st4(r() + o, ri);
          loc += dot4(ri, ri);
        }
      }
      const float rs_new = block_sum(loc, red(), flip);
      const float beta = fabsf(rs) > 0.f ? rs_new / rs : 0.f;
      if (own) {
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl) {
          float* pp = P() + row * LDP + sl * CS + col;
          st4(pp, axpy4(beta, ld4(pp), ld4(r() + row * R + sl * CS + col)));
        }
      }
      rs = rs_new;
      __syncthreads();
    }
  }

  // warm CG from the masked start in xv, then the polish stage; the
  // result, masked, stays in xv
  __device__ void cg_site(int k, int iters, int polish) {
    stage_env_t(RT(), Renvs() + (k + 1) * E);
    stage_env_l(Lr(), Lenvs() + k * E);
    stage_coef(k, false);
    cg_run(iters);
    if (polish > 0) cg_run(polish);
    if (threadIdx.x < OWNERS) {
      const int row = own_row(), col = own_col();
      const float m = ml(k)[row / N];
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl) {
        const float* mr = ml(k + 1) + sl * CS + col;
        float* xp = xv() + row * R + sl * CS + col;
        const float4 v = ld4(xp);
        st4(xp, make_float4(v.x * m * mr[0], v.y * m * mr[1],
                            v.z * m * mr[2], v.w * m * mr[3]));
      }
    }
    __syncthreads();
  }

  // ---- the gauge: eight (R, R) matrices in the first two regions ----
  // Coupled Newton-Schulz on G (given in ns(0)): gh = G^{1/2}, ns(7) =
  // G^{-1/2}, with the Frobenius scaling of the plain version.
  __device__ void ns_polar(int iters, float* gh) {
    float *Y = ns(0), *Z = ns(1), *Y2 = ns(2), *Z2 = ns(3), *Tm = ns(4);
    float loc = 0.f;
    for (int e = threadIdx.x; e < Q2; e += kThreads) loc += Y[e] * Y[e];
    const float fr = sqrtf(block_sum(loc, red(), flip));
    const float sq = sqrtf(fr), inv_fr = 1.f / fr;
    for (int e = threadIdx.x; e < Q2; e += kThreads) {
      Y[e] *= inv_fr;
      Z[e] = (e >> LGR) == (e & (R - 1)) ? 1.f : 0.f;
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      // Tm = 1.5 I - 0.5 Z Y
      gemm<R, R, R, 8, 4, false, false>(
          [&](int m, int k) { return Z + m * R + k; },
          [&](int n, int k) { return Y + k * R + n; },
          [&](int m, int n, float4 v) {
            st4(Tm + m * R + n,
                make_float4((m == n ? 1.5f : 0.f) - 0.5f * v.x,
                            (m == n + 1 ? 1.5f : 0.f) - 0.5f * v.y,
                            (m == n + 2 ? 1.5f : 0.f) - 0.5f * v.z,
                            (m == n + 3 ? 1.5f : 0.f) - 0.5f * v.w));
          });
      __syncthreads();
      // Y2 = Y Tm, Z2 = Tm Z
      gemm<R, R, R, 8, 4, false, false>(
          [&](int m, int k) { return Y + m * R + k; },
          [&](int n, int k) { return Tm + k * R + n; },
          [&](int m, int n, float4 v) { st4(Y2 + m * R + n, v); });
      gemm<R, R, R, 8, 4, false, false>(
          [&](int m, int k) { return Tm + m * R + k; },
          [&](int n, int k) { return Z + k * R + n; },
          [&](int m, int n, float4 v) { st4(Z2 + m * R + n, v); });
      __syncthreads();
      float* t = Y;
      Y = Y2;
      Y2 = t;
      t = Z;
      Z = Z2;
      Z2 = t;
    }
    const float inv_sq = 1.f / sq;
    float* Gi = ns(7);
    for (int e = threadIdx.x; e < Q2; e += kThreads) {
      gh[e] = Y[e] * sq;
      Gi[e] = Z[e] * inv_sq;
    }
    __syncthreads();
  }

  // T (into Tf) = X Y for two (R, R) gauge matrices
  __device__ void gauge_product(const float* X, const float* Y) {
    gemm<R, R, R, 8, 4, false, false>(
        [&](int m, int k) { return X + m * R + k; },
        [&](int n, int k) { return Y + k * R + n; },
        [&](int m, int n, float4 v) { st4(Tf() + m * R + n, v); });
    __syncthreads();
  }

  // Forward gauge of xv (R n, R) = Q T: masked orthonormal columns Q into
  // Qout, T = Gh2 Gh1 into Tf; two Newton-Schulz passes.
  __device__ void orth_cols(int k, float* Qout, int it1, int it2) {
    const float *mlk = ml(k), *mr = ml(k + 1);
    const float* in = P();
    stage_core(P(), xv(), nullptr);
    __syncthreads();
    for (int pass = 0; pass < 2; ++pass) {
      // G = in^T in + diag(1 - m_r)
      gemm<R, R, NR, 8, 4, true, false>(
          [&](int m, int k) { return in + k * LDP + m; },
          [&](int n, int k) { return in + k * LDP + n; },
          [&](int m, int n, float4 v) {
            add_diag(v, m, n, 1.f - mr[m]);
            st4(ns(0) + m * R + n, v);
          });
      __syncthreads();
      ns_polar(pass == 0 ? it1 : it2, ns(5 + pass));
      // Qp = in Gi * m2
      const float* Gi = ns(7);
      float* dst = pass == 0 ? S() : Qout;
      const int ld = pass == 0 ? LDP : R;
      gemm<NR, R, R, 8, 2, false, false>(
          [&](int m, int k) { return in + m * LDP + k; },
          [&](int n, int k) { return Gi + k * R + n; },
          [&](int m, int n, float4 v) {
            const float a = mlk[m / N];
            st4(dst + m * ld + n,
                make_float4(v.x * (a * mr[n]), v.y * (a * mr[n + 1]),
                            v.z * (a * mr[n + 2]), v.w * (a * mr[n + 3])));
          });
      __syncthreads();
      in = S();
    }
    gauge_product(ns(6), ns(5));
  }

  // Backward gauge of xv (R, n R) = T Q: masked orthonormal rows Q into
  // Qout, T = Gh1 Gh2 into Tf.
  __device__ void orth_rows(int k, float* Qout, int it1, int it2) {
    const float *mlk = ml(k), *mr = ml(k + 1);
    const float* in = P();
    stage_core(P(), xv(), nullptr);
    __syncthreads();
    for (int pass = 0; pass < 2; ++pass) {
      // G = in in^T + diag(1 - m_l), in viewed as [a][(i,c)]
      auto row = [&](int a, int k) {
        return in + (a * N + (k >> LGR)) * LDP + (k & (R - 1));
      };
      gemm<R, R, NR, 8, 4, false, true>(row, row, [&](int m, int n,
                                                      float4 v) {
        add_diag(v, m, n, 1.f - mlk[m]);
        st4(ns(0) + m * R + n, v);
      });
      __syncthreads();
      ns_polar(pass == 0 ? it1 : it2, ns(5 + pass));
      // Qp = Gi in * m2
      const float* Gi = ns(7);
      float* dst = pass == 0 ? S() : Qout;
      const int ld = pass == 0 ? LDP : R;
      gemm<R, NR, R, 8, 2, false, false>(
          [&](int m, int k) { return Gi + m * R + k; },
          [&](int n, int k) {
            return in + (k * N + (n >> LGR)) * LDP + (n & (R - 1));
          },
          [&](int m, int n, float4 v) {
            const int c = n & (R - 1);
            const float a = mlk[m];
            st4(dst + (m * N + (n >> LGR)) * ld + c,
                make_float4(v.x * (a * mr[c]), v.y * (a * mr[c + 1]),
                            v.z * (a * mr[c + 2]), v.w * (a * mr[c + 3])));
          });
      __syncthreads();
      in = S();
    }
    gauge_product(ns(5), ns(6));
  }

  // ---- env updates ----
  // env_out[W][a][b] = sum x[a,i,p] A[W,i,j,w] x[b,j,q] env_in[w][p][q]
  // for x in P, env_in^T in RT, A in Ac: the apply's first product and
  // mix, slab by slab, then x (slab columns) against the slab of S.
  __device__ void env_core(float* env_out) const {
    constexpr int NT = RA * R / 4, POS = (R / 8) * NT;
    static_assert(POS <= kThreads && POS % 32 == 0, "one tile a thread");
    const int tid = threadIdx.x, m0 = (tid / NT) * 8, n0 = (tid % NT) * 4;
    float* o = env_out + ((n0 >> LGR) * R + m0) * R + (n0 & (R - 1));
#pragma unroll 1
    for (int sl = 0; sl < SLABS; ++sl) {
      step1_mix(sl);
      __syncthreads();
      if (tid < POS) {
        float acc[8][4] = {};
        mma_chunks<8, 1, N * CS, false, true>(
            acc, m0, n0, 0,
            [&](int m, int k) {
              return P() + (m * N + k / CS) * LDP + sl * CS + k % CS;
            },
            [&](int n, int k) { return S() + n * LDS + k; });
        // the slabs' partial sums meet in device memory (own tile only)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float4 v = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
          if (sl > 0) {
            const float4 u = ld4(o + j * R);
            v = make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
          }
          st4(o + j * R, v);
        }
      }
      __syncthreads();
    }
  }

  // Right env of site k from core src (columns masked by masks[k+1]):
  // Renv_out, and Rb_out[a][u] = sum_{i,p} x[a,i,p] sum_v b[u,i,v]
  // Rb_in[p][v].
  __device__ void right_update(const float* src, int k, const float* Renv_in,
                               const float* Rb_in, float* Renv_out,
                               float* Rb_out) {
    stage_core(P(), src, ml(k + 1));
    stage_env_t(RT(), Renv_in);
    stage_coef(k, false);
    __syncthreads();
    env_core(Renv_out);
    float *bs = Lr(), *rbs = Lr() + NR * LDP;
    stage_core(bs, b + k * V, nullptr);
    stage_sq(rbs, Rb_in);
    __syncthreads();
    // sb[(u,i)][p] = sum_v b[(u,i)][v] Rb_in[p][v], into S
    gemm<NR, R, R, 8, 2, false, true>(
        [&](int m, int k) { return bs + m * LDP + k; },
        [&](int n, int k) { return rbs + n * LDQ + k; },
        [&](int m, int n, float4 v) { st4(S() + m * LDP + n, v); });
    __syncthreads();
    auto row = [&](const float* base, int m, int k) {
      return base + (m * N + (k >> LGR)) * LDP + (k & (R - 1));
    };
    gemm<R, R, NR, 8, 4, false, true>(
        [&](int m, int k) { return row(P(), m, k); },
        [&](int n, int k) { return row(S(), n, k); },
        [&](int m, int n, float4 v) { st4(Rb_out + m * R + n, v); });
    __syncthreads();
  }

  // Left env of site k + 1 from the new core Q = out[k] (masked): the
  // right update of Q with its bonds swapped, L_in in the place of Renv
  // and the MPO bonds swapped; Lb_out[c][v] = sum_{(a,i)} Q[(a,i)][c]
  // t1[(a,i)][v].
  __device__ void left_update(int k) {
    const float* Q = out + k * V;
    stage_core_t(P(), Q);
    stage_env_t(RT(), Lenvs() + k * E);
    stage_coef(k, true);
    __syncthreads();
    env_core(Lenvs() + (k + 1) * E);
    float *qs = Lr(), *ts = RT();
    stage_core(qs, Q, nullptr);
    stage_core(ts, t1(), nullptr);
    __syncthreads();
    float* Lb_out = Lbs() + (k + 1) * Q2;
    gemm<R, R, NR, 8, 4, true, false>(
        [&](int m, int k) { return qs + k * LDP + m; },
        [&](int n, int k) { return ts + k * LDP + n; },
        [&](int m, int n, float4 v) { st4(Lb_out + m * R + n, v); });
    __syncthreads();
  }

  // ---- rhs and warm starts ----
  // t1[a][(i,v)] = sum_u Lb[a][u] b[u,i,v] (kept for the left update);
  // rhs[(a,i)][c] = sum_v t1[(a,i)][v] Rb[c][v] * m_l[a] m_r[c]
  __device__ void rhs_build(int k, const float* Lb, const float* Rb) {
    const float *mlk = ml(k), *mr = ml(k + 1);
    float *bs = Lr(), *lbs = Lr() + NR * LDP;
    float *ts = RT(), *rbs = RT() + NR * LDP;
    stage_core(bs, b + k * V, nullptr);
    stage_sq(lbs, Lb);
    stage_sq(rbs, Rb);
    __syncthreads();
    gemm<R, NR, R, 8, 2, false, false>(
        [&](int m, int k) { return lbs + m * LDQ + k; },
        [&](int n, int k) {
          return bs + (k * N + (n >> LGR)) * LDP + (n & (R - 1));
        },
        [&](int m, int n, float4 v) {
          st4(t1() + m * NR + n, v);
          st4(ts + (m * N + (n >> LGR)) * LDP + (n & (R - 1)), v);
        });
    __syncthreads();
    gemm<NR, R, R, 8, 2, false, true>(
        [&](int m, int k) { return ts + m * LDP + k; },
        [&](int n, int k) { return rbs + n * LDQ + k; },
        [&](int m, int n, float4 v) {
          const float a = mlk[m / N];
          st4(rhs() + m * R + n,
              make_float4(v.x * (a * mr[n]), v.y * (a * mr[n + 1]),
                          v.z * (a * mr[n + 2]), v.w * (a * mr[n + 3])));
        });
    __syncthreads();
  }

  // dst[a][(i,c)] = sum_b T[a][b] src[b][(i,c)] * m_l[a] m_r[c]
  __device__ void left_mul(int k, const float* T, const float* src,
                           float* dst) {
    const float *mlk = ml(k), *mr = ml(k + 1);
    float *tsq = Lr(), *xs = RT();
    stage_sq(tsq, T);
    stage_core(xs, src, nullptr);
    __syncthreads();
    gemm<R, NR, R, 8, 2, false, false>(
        [&](int m, int k) { return tsq + m * LDQ + k; },
        [&](int n, int k) {
          return xs + (k * N + (n >> LGR)) * LDP + (n & (R - 1));
        },
        [&](int m, int n, float4 v) {
          const int c = n & (R - 1);
          const float a = mlk[m];
          st4(dst + m * NR + n,
              make_float4(v.x * (a * mr[c]), v.y * (a * mr[c + 1]),
                          v.z * (a * mr[c + 2]), v.w * (a * mr[c + 3])));
        });
    __syncthreads();
  }

  // dst[(a,i)][c] = sum_b src[(a,i)][b] T[b][c] * m_l[a] m_r[c]; dst may
  // be src
  __device__ void right_mul(int k, const float* src, const float* T,
                            float* dst) {
    const float *mlk = ml(k), *mr = ml(k + 1);
    float *tsq = Lr(), *xs = RT();
    stage_sq(tsq, T);
    stage_core(xs, src, nullptr);
    __syncthreads();
    gemm<NR, R, R, 8, 2, false, false>(
        [&](int m, int k) { return xs + m * LDP + k; },
        [&](int n, int k) { return tsq + k * LDQ + n; },
        [&](int m, int n, float4 v) {
          const float a = mlk[m / N];
          st4(dst + m * R + n,
              make_float4(v.x * (a * mr[n]), v.y * (a * mr[n + 1]),
                          v.z * (a * mr[n + 2]), v.w * (a * mr[n + 3])));
        });
    __syncthreads();
  }
};

// Elements of scratch one problem needs: the env stacks, x, rhs, t1, T,
// and the CG's r and K p.
__host__ __device__ inline size_t scratch_per_problem(int d, int R, int RA,
                                                      int n) {
  const size_t E = (size_t)RA * R * R, Q2 = (size_t)R * R;
  const size_t V = (size_t)R * n * R;
  return (2 * (size_t)d + 1) * (E + Q2) + 5 * V + Q2;
}

template <int R, int N, int RA>
__global__ void __launch_bounds__(kThreads, 1)
    sweep_site_kernel(const float* A, const float* b, const float* x,
                      const float* masks, float* out, float* scratch,
                      size_t scratch_stride, int d, int cg_iters,
                      int cg_polish, int ns1, int ns2) {
  using St = Site<R, N, RA>;
  constexpr int V = St::V, E = St::E, Q2 = St::Q2;
  St s;
  s.flip = 0;
  const size_t bb = blockIdx.x;
  s.A = A;
  s.masks = masks;
  s.x = x + bb * d * V;
  s.b = b + bb * d * V;
  s.out = out + bb * d * V;
  s.d = d;
  s.q = scratch + bb * scratch_stride;
  const int tid = threadIdx.x;
  for (int e = tid; e < E; e += kThreads) {
    s.Renvs()[(size_t)d * E + e] = e == 0 ? 1.f : 0.f;
    s.Lenvs()[e] = e == 0 ? 1.f : 0.f;
  }
  for (int e = tid; e < Q2; e += kThreads) {
    s.Rbs()[(size_t)d * Q2 + e] = e == 0 ? 1.f : 0.f;
    s.Lbs()[e] = e == 0 ? 1.f : 0.f;
  }
  __syncthreads();

  // 1. right-env chain of the input, sites d-1..1
  for (int k = d - 1; k >= 1; --k)
    s.right_update(s.x + k * V, k, s.Renvs() + (k + 1) * E,
                   s.Rbs() + (k + 1) * Q2, s.Renvs() + k * E,
                   s.Rbs() + k * Q2);

  // 2. forward half-sweep; Q_fwd[k] is kept in out[k]
  for (int k = 0; k < d - 1; ++k) {
    s.rhs_build(k, s.Lbs() + k * Q2, s.Rbs() + (k + 1) * Q2);
    if (k == 0) {
      const float *ml = masks, *mr = masks + R;
      for (int e = tid; e < V; e += kThreads)
        s.xv()[e] = s.x[e] * (ml[e / (N * R)] * mr[e % R]);
      __syncthreads();
    } else {
      s.left_mul(k, s.Tf(), s.x + k * V, s.xv());
    }
    s.cg_site(k, cg_iters, cg_polish);
    s.orth_cols(k, s.out + k * V, ns1, ns2);
    s.left_update(k);
  }

  // 3. backward half-sweep; the right envs of the new cores overwrite the
  // input chain's
  for (int k = d - 1; k >= 1; --k) {
    s.rhs_build(k, s.Lbs() + k * Q2, s.Rbs() + (k + 1) * Q2);
    if (k == d - 1)
      s.left_mul(k, s.Tf(), s.x + k * V, s.xv());
    else
      s.right_mul(k, s.out + k * V, s.Tf(), s.xv());
    s.cg_site(k, cg_iters, cg_polish);
    s.orth_rows(k, s.out + k * V, ns1, ns2);
    s.right_update(s.out + k * V, k, s.Renvs() + (k + 1) * E,
                   s.Rbs() + (k + 1) * Q2, s.Renvs() + k * E,
                   s.Rbs() + k * Q2);
  }

  // 4. site 0 = Q_fwd[0] @ T_last, masked
  s.right_mul(0, s.out, s.Tf(), s.out);
}

template <int R, int N, int RA>
int launch(const float* A, const float* b, const float* x,
           const float* masks, float* out, float* scratch, int B, int d,
           int cg_iters, int cg_polish, int ns1, int ns2, cudaStream_t st) {
  auto kernel = sweep_site_kernel<R, N, RA>;
  const size_t smem = Site<R, N, RA>::SMEM * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, st>>>(A, b, x, masks, out, scratch,
                                    scratch_per_problem(d, R, RA, N), d,
                                    cg_iters, cg_polish, ns1, ns2);
  return (int)cudaGetLastError();
}
}  // namespace ttnx_site

// Scratch elements per problem: the wrapper allocates B times this.
extern "C" long long ttnx_als_sweep_site_scratch(int d, int R, int RA,
                                                 int n) {
  return (long long)ttnx_site::scratch_per_problem(d, R, RA, n);
}

// The arguments of ttnx_als_sweep_pair_f32; shapes other than (R, n, RA)
// = (64, 2, 4) and (32, 2, 4), d < 2 and cg_refine != 0 are refused.
extern "C" int ttnx_als_sweep_site_f32(const void* A, const void* b,
                                       const void* x, const void* masks,
                                       void* out, void* scratch, int B, int d,
                                       int R, int RA, int n, int cg_iters,
                                       int cg_refine, int cg_polish, int ns1,
                                       int ns2, void* stream) {
  if (d < 2 || cg_refine != 0 || n != 2 || RA != 4)
    return (int)cudaErrorInvalidValue;
  const auto* a = (const float*)A;
  const auto* bb = (const float*)b;
  const auto* xx = (const float*)x;
  const auto* m = (const float*)masks;
  auto* o = (float*)out;
  auto* sc = (float*)scratch;
  auto st = (cudaStream_t)stream;
  if (R == 64)
    return ttnx_site::launch<64, 2, 4>(a, bb, xx, m, o, sc, B, d, cg_iters,
                                       cg_polish, ns1, ns2, st);
  if (R == 32)
    return ttnx_site::launch<32, 2, 4>(a, bb, xx, m, o, sc, B, d, cg_iters,
                                       cg_polish, ns1, ns2, st);
  return (int)cudaErrorInvalidValue;
}
