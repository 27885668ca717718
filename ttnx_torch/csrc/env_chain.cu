// Kernel B2: the ALS environment chains, right (backward) and left
// (forward), operator and rhs envs together.
//
// Replaces ttnx/kernels/env_chain.py, right_env_chain_fused (_kernel) and
// left_env_chain_fused (_kernel_left). With x (d, R, n, R) already masked,
// A (d, RA, n, n, RA) and b (d, Rb, n, Rb):
//   right: Renv_k[a,W,b] = sum x[a,i,p] A[W,i,j,w] x[b,j,q] Renv_{k+1}[p,w,q]
//          Rb_k[a,u]     = sum x[a,i,p] b[u,i,v] Rb_{k+1}[p,v]
//   left:  L_{k+1}[c,w,d] = sum x[a,i,c] L_k[a,W,b] A[W,i,j,w] x[b,j,d]
//          Lb_{k+1}[p,v]  = sum x[a,i,p] Lb_k[a,u] b[u,i,v]
// Outputs in the public layout: envs (d+1, R, RA, R), envs_b (d+1, R, Rb),
// boundaries e0 e0^T. No transpose of the JAX wrapper's kernel-native
// (d+1, RA, R, R) layout is needed.
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
#include "common.cuh"

namespace ttnx_env {
using namespace ttnx;

template <typename T>
__global__ void set_e0(T* p, int count) {
  fill_e0<T>(p, count, blockIdx.x * blockDim.x + threadIdx.x,
             gridDim.x * blockDim.x);
}

template <typename T>
void launch_set_e0(T* p, int count, cudaStream_t s) {
  const int blocks = cdiv(count, 256);
  set_e0<T><<<blocks < 64 ? blocks : 64, 256, 0, s>>>(p, count);
}

template <typename T>
__global__ void mix_kernel(const T* coef, const T* in, T* out, int O1, int O2,
                           int C1, int C2, int so1, int so2, int sc1, int sc2,
                           int len) {
  mix_small<T>(coef, in, out, O1, O2, C1, C2, so1, so2, sc1, sc2, len,
               blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

template <typename T>
void launch_mix(const T* coef, const T* in, T* out, int O1, int O2, int C1,
                int C2, int so1, int so2, int sc1, int sc2, int len,
                cudaStream_t s) {
  const int blocks = cdiv(O1 * O2 * len, 256);
  mix_kernel<T><<<blocks < 1024 ? blocks : 1024, 256, 0, s>>>(
      coef, in, out, O1, O2, C1, C2, so1, so2, sc1, sc2, len);
}

// ---- right chain ---------------------------------------------------------

// s[j,w][b][p] = sum_q x[b,j,q] Renv[p,w,q]            grid z = j*RA + w
template <typename T>
__global__ void __launch_bounds__(kGroup)
    right_s(const T* xk, const T* Renv,
            T* s, int R, int RA, int n) {
  __shared__ T smem[kTileSmem];
  const int j = blockIdx.z / RA, w = blockIdx.z % RA;
  T* out = s + (size_t)blockIdx.z * R * R;
  gemm_tile<T>(
      R, R, R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int b, int q) { return xk[(size_t)b * n * R + j * R + q]; },
      [&](int q, int p) { return Renv[((size_t)p * RA + w) * R + q]; },
      [&](int b, int p, T v) { out[(size_t)b * R + p] = v; }, smem,
      threadIdx.x, 0);
}

// new[a,W,b] = sum_{i,p} x[a,i,p] m[W,i][b][p]           grid z = W
template <typename T>
__global__ void __launch_bounds__(kGroup)
    right_new(const T* xk, const T* m,
              T* env, int R, int RA, int n) {
  __shared__ T smem[kTileSmem];
  const int W = blockIdx.z;
  const T* mW = m + (size_t)W * n * R * R;
  gemm_tile<T>(
      R, R, n * R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int a, int kk) { return xk[(size_t)a * n * R + kk]; },
      [&](int kk, int b) {
        return mW[((size_t)(kk / R) * R + b) * R + kk % R];
      },
      [&](int a, int b, T v) { env[((size_t)a * RA + W) * R + b] = v; },
      smem, threadIdx.x, 0);
}

// sb[i][p][u] = sum_v b[u,i,v] Rb[p,v]                    grid z = i
template <typename T>
__global__ void __launch_bounds__(kGroup)
    right_sb(const T* bk, const T* Rbenv,
             T* sb, int R, int n, int Rb) {
  __shared__ T smem[kTileSmem];
  const int i = blockIdx.z;
  T* out = sb + (size_t)i * R * Rb;
  gemm_tile<T>(
      Rb, R, Rb, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int u, int v) { return bk[(size_t)u * n * Rb + i * Rb + v]; },
      [&](int v, int p) { return Rbenv[(size_t)p * Rb + v]; },
      [&](int u, int p, T val) { out[(size_t)p * Rb + u] = val; }, smem,
      threadIdx.x, 0);
}

// new_b[a,u] = sum_{i,p} x[a,i,p] sb[i][p][u]
template <typename T>
__global__ void __launch_bounds__(kGroup)
    right_newb(const T* xk, const T* sb,
               T* envb, int R, int n, int Rb) {
  __shared__ T smem[kTileSmem];
  gemm_tile<T>(
      R, Rb, n * R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int a, int kk) { return xk[(size_t)a * n * R + kk]; },
      [&](int kk, int u) { return sb[(size_t)kk * Rb + u]; },
      [&](int a, int u, T v) { envb[(size_t)a * Rb + u] = v; }, smem,
      threadIdx.x, 0);
}

template <typename T>
int env_right(const T* x, const T* A, const T* b, T* envs, T* envs_b,
              T* scratch, int d, int R, int RA, int n, int Rb,
              cudaStream_t s) {
  const size_t env = (size_t)R * RA * R, envb = (size_t)R * Rb;
  T* sbuf = scratch;
  T* mbuf = scratch + (size_t)n * RA * R * R;
  T* sbbuf = mbuf + (size_t)RA * n * R * R;
  launch_set_e0<T>(envs + d * env, (int)env, s);
  launch_set_e0<T>(envs_b + d * envb, (int)envb, s);
  const dim3 gs(cdiv(R, kBN), cdiv(R, kBM), n * RA);
  const dim3 gn(cdiv(R, kBN), cdiv(R, kBM), RA);
  const dim3 gsb(cdiv(R, kBN), cdiv(Rb, kBM), n);
  const dim3 gnb(cdiv(Rb, kBN), cdiv(R, kBM));
  for (int k = d - 1; k >= 0; --k) {
    const T* xk = x + (size_t)k * R * n * R;
    const T* Ak = A + (size_t)k * RA * n * n * RA;
    const T* bk = b + (size_t)k * Rb * n * Rb;
    right_s<T><<<gs, kGroup, 0, s>>>(xk, envs + (k + 1) * env, sbuf, R, RA,
                                     n);
    // m[W,i] = sum_{j,w} A[W,i,j,w] s[j,w]
    launch_mix<T>(Ak, sbuf, mbuf, RA, n, n, RA, n * n * RA, n * RA, RA, 1,
                  R * R, s);
    right_new<T><<<gn, kGroup, 0, s>>>(xk, mbuf, envs + k * env, R, RA, n);
    right_sb<T><<<gsb, kGroup, 0, s>>>(bk, envs_b + (k + 1) * envb, sbbuf, R,
                                       n, Rb);
    right_newb<T><<<gnb, kGroup, 0, s>>>(xk, sbbuf, envs_b + k * envb, R, n,
                                         Rb);
  }
  return (int)cudaGetLastError();
}

// ---- left chain ----------------------------------------------------------

// t[i,W][c][b] = sum_a x[a,i,c] L[a,W,b]                 grid z = i*RA + W
template <typename T>
__global__ void __launch_bounds__(kGroup)
    left_t(const T* xk, const T* L,
           T* t, int R, int RA, int n) {
  __shared__ T smem[kTileSmem];
  const int i = blockIdx.z / RA, W = blockIdx.z % RA;
  T* out = t + (size_t)blockIdx.z * R * R;
  gemm_tile<T>(
      R, R, R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int c, int a) { return xk[(size_t)a * n * R + i * R + c]; },
      [&](int a, int b) { return L[((size_t)a * RA + W) * R + b]; },
      [&](int c, int b, T v) { out[(size_t)c * R + b] = v; }, smem,
      threadIdx.x, 0);
}

// new[c,w,dd] = sum_{j,b} mm[w,j][c][b] x[b,j,dd]         grid z = w
template <typename T>
__global__ void __launch_bounds__(kGroup)
    left_new(const T* xk, const T* mm,
             T* env, int R, int RA, int n) {
  __shared__ T smem[kTileSmem];
  const int w = blockIdx.z;
  const T* mw = mm + (size_t)w * n * R * R;
  gemm_tile<T>(
      R, R, n * R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int c, int kk) {
        return mw[((size_t)(kk / R) * R + c) * R + kk % R];
      },
      [&](int kk, int dd) {
        return xk[(size_t)(kk % R) * n * R + (kk / R) * R + dd];
      },
      [&](int c, int dd, T v) { env[((size_t)c * RA + w) * R + dd] = v; },
      smem, threadIdx.x, 0);
}

// sb[i][p][u] = sum_a x[a,i,p] Lb[a,u]                     grid z = i
template <typename T>
__global__ void __launch_bounds__(kGroup)
    left_sb(const T* xk, const T* Lb,
            T* sb, int R, int n, int Rb) {
  __shared__ T smem[kTileSmem];
  const int i = blockIdx.z;
  T* out = sb + (size_t)i * R * Rb;
  gemm_tile<T>(
      R, Rb, R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int p, int a) { return xk[(size_t)a * n * R + i * R + p]; },
      [&](int a, int u) { return Lb[(size_t)a * Rb + u]; },
      [&](int p, int u, T v) { out[(size_t)p * Rb + u] = v; }, smem,
      threadIdx.x, 0);
}

// new_b[p,v] = sum_{i,u} sb[i][p][u] b[u,i,v]
template <typename T>
__global__ void __launch_bounds__(kGroup)
    left_newb(const T* bk, const T* sb,
              T* envb, int R, int n, int Rb) {
  __shared__ T smem[kTileSmem];
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
int env_left(const T* x, const T* A, const T* b, T* envs, T* envs_b,
             T* scratch, int d, int R, int RA, int n, int Rb,
             cudaStream_t s) {
  const size_t env = (size_t)R * RA * R, envb = (size_t)R * Rb;
  T* tbuf = scratch;
  T* mbuf = scratch + (size_t)n * RA * R * R;
  T* sbbuf = mbuf + (size_t)RA * n * R * R;
  launch_set_e0<T>(envs, (int)env, s);
  launch_set_e0<T>(envs_b, (int)envb, s);
  const dim3 gt(cdiv(R, kBN), cdiv(R, kBM), n * RA);
  const dim3 gn(cdiv(R, kBN), cdiv(R, kBM), RA);
  const dim3 gsb(cdiv(Rb, kBN), cdiv(R, kBM), n);
  const dim3 gnb(cdiv(Rb, kBN), cdiv(R, kBM));
  for (int k = 0; k < d; ++k) {
    const T* xk = x + (size_t)k * R * n * R;
    const T* Ak = A + (size_t)k * RA * n * n * RA;
    const T* bk = b + (size_t)k * Rb * n * Rb;
    left_t<T><<<gt, kGroup, 0, s>>>(xk, envs + k * env, tbuf, R, RA, n);
    // mm[w,j] = sum_{i,W} A[W,i,j,w] t[i,W]
    launch_mix<T>(Ak, tbuf, mbuf, RA, n, n, RA, 1, RA, n * RA, n * n * RA,
                  R * R, s);
    left_new<T><<<gn, kGroup, 0, s>>>(xk, mbuf, envs + (k + 1) * env, R, RA,
                                      n);
    left_sb<T><<<gsb, kGroup, 0, s>>>(xk, envs_b + k * envb, sbbuf, R, n, Rb);
    left_newb<T><<<gnb, kGroup, 0, s>>>(bk, sbbuf, envs_b + (k + 1) * envb,
                                        R, n, Rb);
  }
  return (int)cudaGetLastError();
}
}  // namespace ttnx_env

using namespace ttnx_env;

#define TTNX_ENV_ENTRY(NAME, FN, T)                                          \
  extern "C" int NAME(const void* x, const void* A, const void* b,           \
                      void* envs, void* envs_b, void* scratch, int d, int R, \
                      int RA, int n, int Rb, void* stream) {                 \
    return FN<T>((const T*)x, (const T*)A, (const T*)b, (T*)envs,            \
                 (T*)envs_b, (T*)scratch, d, R, RA, n, Rb,                   \
                 (cudaStream_t)stream);                                      \
  }

TTNX_ENV_ENTRY(ttnx_env_chain_right_f32, env_right, float)
TTNX_ENV_ENTRY(ttnx_env_chain_right_f64, env_right, double)
TTNX_ENV_ENTRY(ttnx_env_chain_left_f32, env_left, float)
TTNX_ENV_ENTRY(ttnx_env_chain_left_f64, env_left, double)
