// Kernels B4 and B5: matrix-free fixed-iteration CG for the ALS local
// solve at ranks >= 32 (and, on the card, every real shape whose dense K
// would exceed M = 1024), for one problem (B4) or a batch of B problems
// with a shared MPO core and mask (B5).
//
// Replaces ttnx/kernels/local_cg_mf.py, cg_matfree_fused (_kernel) and
// cg_matfree_fused_batched (_kernel_batched).
// Local operator, with mask = m_l (x) 1_n (x) m_r:
//   K v[a,i,c] = sum L[a,W,b] Ac[W,i,J,w] Renv[c,w,d] (v*mask)[b,J,d]
//   apply(v)   = (K v) * mask + (1 - mask) * v
// CG on rhs * mask from x0 * mask (warm) or 0, returns x * mask.
//
// What bounds it on the H100: each apply is two GEMMs of 2 R^2 * n * RA * R
// FLOP (4.2 MFLOP a GEMM at R = 64) with a small mix between, and the
// iterations are strictly sequential — latency bound. The iterates x, r,
// p, Kp are 128 KB in f32 at R = 64 and the n*RA intermediates another
// 128 KB, together more than the 227 KB of shared memory.
//
// Design: one block of 1024 threads (four 256-thread GEMM groups) runs the
// whole solve in one launch. Iterates and intermediates live in a
// wrapper-allocated scratch buffer in device memory (L2 resident); only
// the GEMM tiles are staged in shared memory. Per apply:
//   s[J,w][b][c] = sum_d v[b,J,d] Renv[c,w,d]     GEMM (R n) x (R RA), K = R
//   m[W,i][b][c] = sum_{J,w} Ac[W,i,J,w] s[J,w]   elementwise mix
//   out[a,i,c]   = sum_{W,b} L[a,W,b] m[W,i][b,c] GEMM R x (n R), K = RA R
// Scalars r.r and p.Kp are block reductions in a fixed order. Later work:
// spread each apply over many SMs (cluster or cooperative launch).
//
// B5 is the same kernel on a grid of B blocks: block bb solves problem bb
// with its own L, Renv, rhs, x0, scratch slice and CG scalars; Ac and the
// mask are shared. B4 is the grid of one. At B = 512 and R = 64 the grid
// is about four waves over the 132 SMs (one 1024-thread block per SM) and
// the scratch is 184 MB in f32, so the iterates leave L2: each block's
// working set is 360 KB.
#include "common.cuh"

namespace ttnx_cg_mf {
using namespace ttnx;

constexpr int kThreads = 1024;

template <typename T>
struct MF {
  const T* L;
  const T* Ac;
  const T* Renv;
  const T* mask;
  T* s;  // (n*RA, R, R)
  T* m;  // (RA*n, R, R)
  int R, RA, n;
};

// out = apply(v); every thread of the block calls it
template <typename T>
__device__ void apply_k(const MF<T>& f, const T* v, T* out, T* smem) {
  const int R = f.R, RA = f.RA, n = f.n;
  T* s = f.s;
  gemm_block<T>(
      R * n, R * RA, R,
      [&](int bJ, int d) {
        const size_t idx = (size_t)bJ * R + d;
        return v[idx] * f.mask[idx];
      },
      [&](int d, int cw) { return f.Renv[(size_t)cw * R + d]; },
      [&](int bJ, int cw, T val) {
        const int b = bJ / n, J = bJ % n, c = cw / RA, w = cw % RA;
        s[(((size_t)J * RA + w) * R + b) * R + c] = val;
      },
      smem);
  __syncthreads();
  mix_small<T>(f.Ac, s, f.m, RA, n, n, RA, n * n * RA, n * RA, RA, 1, R * R,
               threadIdx.x, blockDim.x);
  __syncthreads();
  const T* m = f.m;
  gemm_block<T>(
      R, n * R, RA * R,
      [&](int a, int Wb) { return f.L[(size_t)a * RA * R + Wb]; },
      [&](int Wb, int ic) {
        const int W = Wb / R, b = Wb % R, i = ic / R, c = ic % R;
        return m[(((size_t)W * n + i) * R + b) * R + c];
      },
      [&](int a, int ic, T val) {
        const size_t idx = (size_t)a * n * R + ic;
        const T mk = f.mask[idx];
        out[idx] = val * mk + (T(1) - mk) * v[idx];
      },
      smem);
  __syncthreads();
}

// scratch per problem: r, p, Kp (3 V) and the intermediates s, m (2 RA V)
__host__ __device__ inline size_t scratch_per_problem(int R, int RA, int n) {
  const size_t V = (size_t)R * n * R;
  return 3 * V + 2 * (size_t)RA * V;
}

// Block blockIdx.x solves problem blockIdx.x: L, Renv (R, RA, R), rhs, x0,
// x (R, n, R) and the scratch advance by one problem per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_mf_kernel(MF<T> f, const T* rhs, const T* x0, T* x, T* scratch,
                 int iters, int warm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ T red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int V = f.R * f.n * f.R;
  const size_t bb = blockIdx.x;
  const size_t E = (size_t)f.R * f.RA * f.R;
  f.L += bb * E;
  f.Renv += bb * E;
  rhs += bb * V;
  x0 += bb * V;
  x += bb * V;
  T* r = scratch + bb * scratch_per_problem(f.R, f.RA, f.n);
  T* p = r + V;
  T* ap = p + V;
  f.s = ap + V;
  f.m = f.s + (size_t)f.n * f.RA * f.R * f.R;

  for (int i = tid; i < V; i += nt) x[i] = warm ? x0[i] * f.mask[i] : T(0);
  __syncthreads();
  if (warm) apply_k<T>(f, x, ap, smem);
  T loc = T(0);
  for (int i = tid; i < V; i += nt) {
    const T rm = rhs[i] * f.mask[i];
    const T ri = warm ? rm - ap[i] : rm;
    r[i] = ri;
    p[i] = ri;
    loc += ri * ri;
  }
  T rs = block_sum<T>(loc, red);

  for (int it = 0; it < iters; ++it) {
    apply_k<T>(f, p, ap, smem);
    loc = T(0);
    for (int i = tid; i < V; i += nt) loc += p[i] * ap[i];
    const T denom = block_sum<T>(loc, red);
    const T alpha = fabs(denom) > T(0) ? rs / denom : T(0);
    loc = T(0);
    for (int i = tid; i < V; i += nt) {
      x[i] += alpha * p[i];
      const T ri = r[i] - alpha * ap[i];
      r[i] = ri;
      loc += ri * ri;
    }
    const T rs_new = block_sum<T>(loc, red);
    const T beta = fabs(rs) > T(0) ? rs_new / rs : T(0);
    for (int i = tid; i < V; i += nt) p[i] = r[i] + beta * p[i];
    rs = rs_new;
    __syncthreads();
  }
  for (int i = tid; i < V; i += nt) x[i] *= f.mask[i];
}

template <typename T>
int cg_matfree(const T* L, const T* Ac, const T* Renv, const T* rhs,
               const T* mask, const T* x0, T* out, T* scratch, int B, int R,
               int RA, int n, int iters, int warm, cudaStream_t s) {
  MF<T> f;
  f.L = L;
  f.Ac = Ac;
  f.Renv = Renv;
  f.mask = mask;
  f.R = R;
  f.RA = RA;
  f.n = n;
  const size_t smem = (kThreads / kGroup) * kTileSmem * sizeof(T);
  cudaFuncSetAttribute(cg_mf_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cg_mf_kernel<T><<<B, kThreads, smem, s>>>(f, rhs, x0, out, scratch, iters,
                                            warm);
  return (int)cudaGetLastError();
}
}  // namespace ttnx_cg_mf

using namespace ttnx_cg_mf;

#define TTNX_MF_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* L, const void* Ac, const void* Renv,        \
                      const void* rhs, const void* mask, const void* x0,      \
                      void* out, void* scratch, int R, int RA, int n,         \
                      int iters, int warm, void* stream) {                    \
    return cg_matfree<T>((const T*)L, (const T*)Ac, (const T*)Renv,           \
                         (const T*)rhs, (const T*)mask, (const T*)x0,         \
                         (T*)out, (T*)scratch, 1, R, RA, n, iters, warm,      \
                         (cudaStream_t)stream);                               \
  }

TTNX_MF_ENTRY(ttnx_cg_matfree_f32, float)
TTNX_MF_ENTRY(ttnx_cg_matfree_f64, double)

#define TTNX_MF_BATCHED_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* L, const void* Ac, const void* Renv,        \
                      const void* rhs, const void* mask, const void* x0,      \
                      void* out, void* scratch, int B, int R, int RA, int n,  \
                      int iters, int warm, void* stream) {                    \
    return cg_matfree<T>((const T*)L, (const T*)Ac, (const T*)Renv,           \
                         (const T*)rhs, (const T*)mask, (const T*)x0,         \
                         (T*)out, (T*)scratch, B, R, RA, n, iters, warm,      \
                         (cudaStream_t)stream);                               \
  }

TTNX_MF_BATCHED_ENTRY(ttnx_cg_matfree_batched_f32, float)
TTNX_MF_BATCHED_ENTRY(ttnx_cg_matfree_batched_f64, double)
