// Kernels B2 and B6: the ALS environment chains, right (backward) and left
// (forward), operator and rhs envs together, for one problem (B2) or a
// batch of B problems with a shared operator (B6).
// This is their route "staged" (env_chain.env_route): f64 and the shapes
// csrc/env_chain_site.cu does not take; likewise for B8 (env_A_route).
//
// Replaces ttnx/kernels/env_chain.py, right_env_chain_fused (_kernel),
// left_env_chain_fused (_kernel_left) and env_chain_fused_batched
// (_kernel_b1). With x (d, R, n, R) already masked,
// A (d, RA, n, n, RA) and b (d, Rb, n, Rb):
//   right: Renv_k[a,W,b] = sum x[a,i,p] A[W,i,j,w] x[b,j,q] Renv_{k+1}[p,w,q]
//          Rb_k[a,u]     = sum x[a,i,p] b[u,i,v] Rb_{k+1}[p,v]
//   left:  L_{k+1}[c,w,d] = sum x[a,i,c] L_k[a,W,b] A[W,i,j,w] x[b,j,d]
//          Lb_{k+1}[p,v]  = sum x[a,i,p] Lb_k[a,u] b[u,i,v]
// Outputs in the public layout: envs (d+1, R, RA, R), envs_b (d+1, R, Rb),
// boundaries e0 e0^T; with raw = 1 the envs are written (and read back)
// in the kernel-native (d+1, RA, R, R) layout of the JAX wrapper.
//
// What bounds it: d sequential sites of 2 n RA (R, R) @ (R, R) products
// plus the rhs legs (about 9 MFLOP a site at R = 64): latency bound. One
// Renv is 64 KB in f32 at R = 64 (128 KB in f64), and the TPU kernel's
// unrolled (R, R) slices of all RA * n intermediates do not fit one SM.
//
// Design: per site, a few multi-block launches in stream order — a GEMM
// over all (j, w) slices at once (grid z), the small MPO-index mix as an
// elementwise pass, and a GEMM whose k loop runs over (i, p) together
// (K = n R), so every product has K >= R. Intermediates live in a
// wrapper-allocated scratch buffer in device memory (L2 resident).
//
// B6 folds the batch into the grid: grid z runs over (problem, slice), so
// one launch per phase and site serves all B problems and the chain stays
// d sequential steps, not B d. B2 is the batch of one. Per-problem
// offsets are size_t: at B = 512, R = 64 the scratch alone is 64 MB.
//
// Kernel B8, the operator-only chain of the DMRG eigensweeps (replaces
// ttnx/kernels/env_chain.py, env_chain_A_fused, _kernel_A), is the same
// chain with no rhs (b == nullptr): the s/mix/new phases of the right
// chain and the t/mix/new phases of the left chain, three launches a
// site, and 2 n RA R^2 elements of scratch. B2 and B6 run exactly the
// launches they ran before. At the DMRG bench shape (d = 10, R = 16,
// RA = 5) a site is 4 RA (R, R) @ (R, R) products, about 0.16 MFLOP: the
// chain is bound by its 3 d dependent launches, not by FLOPs or bytes.
// Route "cluster" (env_chain_site.cu) takes f32 at RA = 5 and R = 64, 32,
// 16, the DMRG sweeps' shapes, in one launch.
#include "common.cuh"

namespace ttnx_env {
using namespace ttnx;

constexpr int kMaxGridZ = 65535;

// Per-problem views of one launch: the problem of a block is blockIdx.z /
// zper (or blockIdx.y for the elementwise passes); strides in elements.
template <typename T>
struct Batch {
  const T* x;     // (B, d, R, n, R)
  const T* A;     // (d, RA, n, n, RA), shared
  const T* b;     // (B, d, Rb, n, Rb)
  T* envs;        // (B, d+1, R, RA, R) or raw (B, d+1, RA, R, R)
  T* envs_b;      // (B, d+1, R, Rb)
  T* scratch;     // (B, scratch_per_problem)
  int d, R, RA, n, Rb, raw;
  size_t xs, bs, es, ebs, ss;
};

// index of env[a, W, b] in one (R, RA, R) env, or in its raw (RA, R, R)
__device__ __forceinline__ size_t env_at(int R, int RA, int raw, int a, int W,
                                         int b) {
  return raw ? ((size_t)W * R + a) * R + b : ((size_t)a * RA + W) * R + b;
}

template <typename T>
__global__ void set_e0(T* p, int count, size_t stride) {
  fill_e0<T>(p + blockIdx.y * stride, count,
             blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

template <typename T>
void launch_set_e0(T* p, int count, size_t stride, int nb, cudaStream_t s) {
  const int blocks = cdiv(count, 256);
  set_e0<T><<<dim3(blocks < 64 ? blocks : 64, nb), 256, 0, s>>>(p, count,
                                                                stride);
}

template <typename T>
__global__ void mix_kernel(const T* coef, const T* in, T* out, int O1, int O2,
                           int C1, int C2, int so1, int so2, int sc1, int sc2,
                           int len, size_t stride) {
  const size_t off = blockIdx.y * stride;
  mix_small<T>(coef, in + off, out + off, O1, O2, C1, C2, so1, so2, sc1, sc2,
               len, blockIdx.x * blockDim.x + threadIdx.x,
               gridDim.x * blockDim.x);
}

template <typename T>
void launch_mix(const T* coef, const T* in, T* out, int O1, int O2, int C1,
                int C2, int so1, int so2, int sc1, int sc2, int len,
                size_t stride, int nb, cudaStream_t s) {
  const int blocks = cdiv(O1 * O2 * len, 256);
  mix_kernel<T><<<dim3(blocks < 1024 ? blocks : 1024, nb), 256, 0, s>>>(
      coef, in, out, O1, O2, C1, C2, so1, so2, sc1, sc2, len, stride);
}

// ---- right chain ---------------------------------------------------------

// s[j,w][b][p] = sum_q x[b,j,q] Renv[p,w,q]       grid z = (bb, j*RA + w)
template <typename T>
__global__ void __launch_bounds__(kGroup)
    right_s(Batch<T> c, int k) {
  __shared__ T smem[kTileSmem];
  const int R = c.R, RA = c.RA, n = c.n, zper = n * RA;
  const size_t bb = blockIdx.z / zper;
  const int z = blockIdx.z % zper, j = z / RA, w = z % RA;
  const T* xk = c.x + bb * c.xs + (size_t)k * R * n * R;
  const T* Renv = c.envs + bb * c.es + (size_t)(k + 1) * R * RA * R;
  T* out = c.scratch + bb * c.ss + (size_t)z * R * R;
  gemm_tile<T>(
      R, R, R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int b, int q) { return xk[(size_t)b * n * R + j * R + q]; },
      [&](int q, int p) { return Renv[env_at(R, RA, c.raw, p, w, q)]; },
      [&](int b, int p, T v) { out[(size_t)b * R + p] = v; }, smem,
      threadIdx.x, 0);
}

// new[a,W,b] = sum_{i,p} x[a,i,p] m[W,i][b][p]      grid z = (bb, W)
template <typename T>
__global__ void __launch_bounds__(kGroup)
    right_new(Batch<T> c, int k) {
  __shared__ T smem[kTileSmem];
  const int R = c.R, RA = c.RA, n = c.n;
  const size_t bb = blockIdx.z / RA;
  const int W = blockIdx.z % RA;
  const T* xk = c.x + bb * c.xs + (size_t)k * R * n * R;
  const T* mW = c.scratch + bb * c.ss + (size_t)n * RA * R * R +
                (size_t)W * n * R * R;
  T* env = c.envs + bb * c.es + (size_t)k * R * RA * R;
  gemm_tile<T>(
      R, R, n * R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int a, int kk) { return xk[(size_t)a * n * R + kk]; },
      [&](int kk, int b) {
        return mW[((size_t)(kk / R) * R + b) * R + kk % R];
      },
      [&](int a, int b, T v) { env[env_at(R, RA, c.raw, a, W, b)] = v; },
      smem, threadIdx.x, 0);
}

// sb[i][p][u] = sum_v b[u,i,v] Rb[p,v]               grid z = (bb, i)
template <typename T>
__global__ void __launch_bounds__(kGroup)
    right_sb(Batch<T> c, int k) {
  __shared__ T smem[kTileSmem];
  const int R = c.R, n = c.n, Rb = c.Rb;
  const size_t bb = blockIdx.z / n;
  const int i = blockIdx.z % n;
  const T* bk = c.b + bb * c.bs + (size_t)k * Rb * n * Rb;
  const T* Rbenv = c.envs_b + bb * c.ebs + (size_t)(k + 1) * R * Rb;
  T* out = c.scratch + bb * c.ss + 2 * (size_t)n * c.RA * R * R +
           (size_t)i * R * Rb;
  gemm_tile<T>(
      Rb, R, Rb, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int u, int v) { return bk[(size_t)u * n * Rb + i * Rb + v]; },
      [&](int v, int p) { return Rbenv[(size_t)p * Rb + v]; },
      [&](int u, int p, T val) { out[(size_t)p * Rb + u] = val; }, smem,
      threadIdx.x, 0);
}

// new_b[a,u] = sum_{i,p} x[a,i,p] sb[i][p][u]        grid z = bb
template <typename T>
__global__ void __launch_bounds__(kGroup)
    right_newb(Batch<T> c, int k) {
  __shared__ T smem[kTileSmem];
  const int R = c.R, n = c.n, Rb = c.Rb;
  const size_t bb = blockIdx.z;
  const T* xk = c.x + bb * c.xs + (size_t)k * R * n * R;
  const T* sb = c.scratch + bb * c.ss + 2 * (size_t)n * c.RA * R * R;
  T* envb = c.envs_b + bb * c.ebs + (size_t)k * R * Rb;
  gemm_tile<T>(
      R, Rb, n * R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int a, int kk) { return xk[(size_t)a * n * R + kk]; },
      [&](int kk, int u) { return sb[(size_t)kk * Rb + u]; },
      [&](int a, int u, T v) { envb[(size_t)a * Rb + u] = v; }, smem,
      threadIdx.x, 0);
}

template <typename T>
void env_right(const Batch<T>& c, int nb, cudaStream_t s) {
  const int d = c.d, R = c.R, RA = c.RA, n = c.n, Rb = c.Rb;
  const size_t env = (size_t)R * RA * R, envb = (size_t)R * Rb;
  T* mbuf = c.scratch + (size_t)n * RA * R * R;
  const bool rhs = c.b != nullptr;
  launch_set_e0<T>(c.envs + d * env, (int)env, c.es, nb, s);
  if (rhs) launch_set_e0<T>(c.envs_b + d * envb, (int)envb, c.ebs, nb, s);
  const dim3 gs(cdiv(R, kBN), cdiv(R, kBM), nb * n * RA);
  const dim3 gn(cdiv(R, kBN), cdiv(R, kBM), nb * RA);
  const dim3 gsb(cdiv(R, kBN), cdiv(Rb, kBM), nb * n);
  const dim3 gnb(cdiv(Rb, kBN), cdiv(R, kBM), nb);
  for (int k = d - 1; k >= 0; --k) {
    const T* Ak = c.A + (size_t)k * RA * n * n * RA;
    right_s<T><<<gs, kGroup, 0, s>>>(c, k);
    // m[W,i] = sum_{j,w} A[W,i,j,w] s[j,w]
    launch_mix<T>(Ak, c.scratch, mbuf, RA, n, n, RA, n * n * RA, n * RA, RA,
                  1, R * R, c.ss, nb, s);
    right_new<T><<<gn, kGroup, 0, s>>>(c, k);
    if (!rhs) continue;
    right_sb<T><<<gsb, kGroup, 0, s>>>(c, k);
    right_newb<T><<<gnb, kGroup, 0, s>>>(c, k);
  }
}

// ---- left chain ----------------------------------------------------------

// t[i,W][c][b] = sum_a x[a,i,c] L[a,W,b]            grid z = (bb, i*RA + W)
template <typename T>
__global__ void __launch_bounds__(kGroup)
    left_t(Batch<T> c, int k) {
  __shared__ T smem[kTileSmem];
  const int R = c.R, RA = c.RA, n = c.n, zper = n * RA;
  const size_t bb = blockIdx.z / zper;
  const int z = blockIdx.z % zper, i = z / RA, W = z % RA;
  const T* xk = c.x + bb * c.xs + (size_t)k * R * n * R;
  const T* L = c.envs + bb * c.es + (size_t)k * R * RA * R;
  T* out = c.scratch + bb * c.ss + (size_t)z * R * R;
  gemm_tile<T>(
      R, R, R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int cc, int a) { return xk[(size_t)a * n * R + i * R + cc]; },
      [&](int a, int b) { return L[env_at(R, RA, c.raw, a, W, b)]; },
      [&](int cc, int b, T v) { out[(size_t)cc * R + b] = v; }, smem,
      threadIdx.x, 0);
}

// new[c,w,dd] = sum_{j,b} mm[w,j][c][b] x[b,j,dd]     grid z = (bb, w)
template <typename T>
__global__ void __launch_bounds__(kGroup)
    left_new(Batch<T> c, int k) {
  __shared__ T smem[kTileSmem];
  const int R = c.R, RA = c.RA, n = c.n;
  const size_t bb = blockIdx.z / RA;
  const int w = blockIdx.z % RA;
  const T* xk = c.x + bb * c.xs + (size_t)k * R * n * R;
  const T* mw = c.scratch + bb * c.ss + (size_t)n * RA * R * R +
                (size_t)w * n * R * R;
  T* env = c.envs + bb * c.es + (size_t)(k + 1) * R * RA * R;
  gemm_tile<T>(
      R, R, n * R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int cc, int kk) {
        return mw[((size_t)(kk / R) * R + cc) * R + kk % R];
      },
      [&](int kk, int dd) {
        return xk[(size_t)(kk % R) * n * R + (kk / R) * R + dd];
      },
      [&](int cc, int dd, T v) { env[env_at(R, RA, c.raw, cc, w, dd)] = v; },
      smem, threadIdx.x, 0);
}

// sb[i][p][u] = sum_a x[a,i,p] Lb[a,u]                 grid z = (bb, i)
template <typename T>
__global__ void __launch_bounds__(kGroup)
    left_sb(Batch<T> c, int k) {
  __shared__ T smem[kTileSmem];
  const int R = c.R, n = c.n, Rb = c.Rb;
  const size_t bb = blockIdx.z / n;
  const int i = blockIdx.z % n;
  const T* xk = c.x + bb * c.xs + (size_t)k * R * n * R;
  const T* Lb = c.envs_b + bb * c.ebs + (size_t)k * R * Rb;
  T* out = c.scratch + bb * c.ss + 2 * (size_t)n * c.RA * R * R +
           (size_t)i * R * Rb;
  gemm_tile<T>(
      R, Rb, R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int p, int a) { return xk[(size_t)a * n * R + i * R + p]; },
      [&](int a, int u) { return Lb[(size_t)a * Rb + u]; },
      [&](int p, int u, T v) { out[(size_t)p * Rb + u] = v; }, smem,
      threadIdx.x, 0);
}

// new_b[p,v] = sum_{i,u} sb[i][p][u] b[u,i,v]          grid z = bb
template <typename T>
__global__ void __launch_bounds__(kGroup)
    left_newb(Batch<T> c, int k) {
  __shared__ T smem[kTileSmem];
  const int R = c.R, n = c.n, Rb = c.Rb;
  const size_t bb = blockIdx.z;
  const T* bk = c.b + bb * c.bs + (size_t)k * Rb * n * Rb;
  const T* sb = c.scratch + bb * c.ss + 2 * (size_t)n * c.RA * R * R;
  T* envb = c.envs_b + bb * c.ebs + (size_t)(k + 1) * R * Rb;
  gemm_tile<T>(
      R, Rb, n * Rb, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int p, int kk) {
        return sb[((size_t)(kk / Rb) * R + p) * Rb + kk % Rb];
      },
      [&](int kk, int v) {
        return bk[(size_t)(kk % Rb) * n * Rb + (kk / Rb) * Rb + v];
      },
      [&](int p, int v, T val) { envb[(size_t)p * Rb + v] = val; }, smem,
      threadIdx.x, 0);
}

template <typename T>
void env_left(const Batch<T>& c, int nb, cudaStream_t s) {
  const int d = c.d, R = c.R, RA = c.RA, n = c.n, Rb = c.Rb;
  T* mbuf = c.scratch + (size_t)n * RA * R * R;
  const bool rhs = c.b != nullptr;
  launch_set_e0<T>(c.envs, R * RA * R, c.es, nb, s);
  if (rhs) launch_set_e0<T>(c.envs_b, R * Rb, c.ebs, nb, s);
  const dim3 gt(cdiv(R, kBN), cdiv(R, kBM), nb * n * RA);
  const dim3 gn(cdiv(R, kBN), cdiv(R, kBM), nb * RA);
  const dim3 gsb(cdiv(Rb, kBN), cdiv(R, kBM), nb * n);
  const dim3 gnb(cdiv(Rb, kBN), cdiv(R, kBM), nb);
  for (int k = 0; k < d; ++k) {
    const T* Ak = c.A + (size_t)k * RA * n * n * RA;
    left_t<T><<<gt, kGroup, 0, s>>>(c, k);
    // mm[w,j] = sum_{i,W} A[W,i,j,w] t[i,W]
    launch_mix<T>(Ak, c.scratch, mbuf, RA, n, n, RA, 1, RA, n * RA,
                  n * n * RA, R * R, c.ss, nb, s);
    left_new<T><<<gn, kGroup, 0, s>>>(c, k);
    if (!rhs) continue;
    left_sb<T><<<gsb, kGroup, 0, s>>>(c, k);
    left_newb<T><<<gnb, kGroup, 0, s>>>(c, k);
  }
}

// The whole chain for B problems, in chunks small enough for grid z;
// b == nullptr (and Rb == 0) builds the operator envs alone.
template <typename T>
int env_chain(const T* x, const T* A, const T* b, T* envs, T* envs_b,
              T* scratch, int B, int d, int R, int RA, int n, int Rb,
              int left, int raw, cudaStream_t s) {
  Batch<T> c;
  c.A = A;
  c.d = d;
  c.R = R;
  c.RA = RA;
  c.n = n;
  c.Rb = Rb;
  c.raw = raw;
  c.xs = (size_t)d * R * n * R;
  c.bs = (size_t)d * Rb * n * Rb;
  c.es = (size_t)(d + 1) * R * RA * R;
  c.ebs = (size_t)(d + 1) * R * Rb;
  c.ss = 2 * (size_t)n * RA * R * R + (size_t)n * R * Rb;
  const int chunk = kMaxGridZ / (n * RA);
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int nb = B - b0 < chunk ? B - b0 : chunk;
    c.x = x + b0 * c.xs;
    c.b = b ? b + b0 * c.bs : nullptr;
    c.envs = envs + b0 * c.es;
    c.envs_b = envs_b ? envs_b + b0 * c.ebs : nullptr;
    c.scratch = scratch + b0 * c.ss;
    if (left)
      env_left<T>(c, nb, s);
    else
      env_right<T>(c, nb, s);
  }
  return (int)cudaGetLastError();
}
}  // namespace ttnx_env

using namespace ttnx_env;

// B2: one problem (x, b, envs in the public layout)
#define TTNX_ENV_ENTRY(NAME, LEFT, T)                                        \
  extern "C" int NAME(const void* x, const void* A, const void* b,           \
                      void* envs, void* envs_b, void* scratch, int d, int R, \
                      int RA, int n, int Rb, void* stream) {                 \
    return env_chain<T>((const T*)x, (const T*)A, (const T*)b, (T*)envs,     \
                        (T*)envs_b, (T*)scratch, 1, d, R, RA, n, Rb, LEFT,   \
                        0, (cudaStream_t)stream);                            \
  }

TTNX_ENV_ENTRY(ttnx_env_chain_right_f32, 0, float)
TTNX_ENV_ENTRY(ttnx_env_chain_right_f64, 0, double)
TTNX_ENV_ENTRY(ttnx_env_chain_left_f32, 1, float)
TTNX_ENV_ENTRY(ttnx_env_chain_left_f64, 1, double)

// B6: B problems, shared A, left or right, public or raw env layout
#define TTNX_ENV_BATCHED_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* x, const void* A, const void* b,           \
                      void* envs, void* envs_b, void* scratch, int B, int d, \
                      int R, int RA, int n, int Rb, int left, int raw,       \
                      void* stream) {                                        \
    return env_chain<T>((const T*)x, (const T*)A, (const T*)b, (T*)envs,     \
                        (T*)envs_b, (T*)scratch, B, d, R, RA, n, Rb, left,   \
                        raw, (cudaStream_t)stream);                          \
  }

TTNX_ENV_BATCHED_ENTRY(ttnx_env_chain_batched_f32, float)
TTNX_ENV_BATCHED_ENTRY(ttnx_env_chain_batched_f64, double)

// B8: the operator-only chain of one problem, public layout
#define TTNX_ENV_A_ENTRY(NAME, LEFT, T)                                      \
  extern "C" int NAME(const void* x, const void* A, void* envs,              \
                      void* scratch, int d, int R, int RA, int n,            \
                      void* stream) {                                        \
    return env_chain<T>((const T*)x, (const T*)A, nullptr, (T*)envs,         \
                        nullptr, (T*)scratch, 1, d, R, RA, n, 0, LEFT, 0,    \
                        (cudaStream_t)stream);                               \
  }

TTNX_ENV_A_ENTRY(ttnx_env_chain_A_right_f32, 0, float)
TTNX_ENV_A_ENTRY(ttnx_env_chain_A_right_f64, 0, double)
TTNX_ENV_A_ENTRY(ttnx_env_chain_A_left_f32, 1, float)
TTNX_ENV_A_ENTRY(ttnx_env_chain_A_left_f64, 1, double)
