// Kernel B3: fixed-iteration conjugate gradients on a dense SPD matrix,
// optionally warm started — the rank-16 ALS local solve.
//
// Replaces ttnx/kernels/local_cg.py, cg_solve_fused (_cg_kernel).
// Solves K x = rhs, K (M, M), with `iters` CG steps (plus one matvec for
// r0 = rhs - K x0 when warm), keeping the |denom| > 0 and |rs| > 0 guards
// of the reference.
//
// What bounds it on the H100: every iteration reads all of K (1 MB in f32
// at M = 512, 4 MB at M = 1024, twice that in f64) and the iterations are
// strictly sequential, so a solve is bound by how fast one launch can
// stream K from L2. K does not fit in shared memory (227 KB), unlike the
// TPU kernel's VMEM-resident K.
//
// Design: one block of 1024 threads runs the whole solve in one launch.
// The iterates x, r, p, Kp live in shared memory (4 M values), K stays in
// device memory and is re-read from L2 each iteration, one warp per row
// with coalesced loads; r.r and p.Kp are block reductions in a fixed
// order (deterministic). Later work: split K's rows over a cluster of
// blocks so each SM keeps its share in shared memory.
#include "common.cuh"

namespace ttnx_cg {
using namespace ttnx;

constexpr int kThreads = 1024;
constexpr size_t kSmemBlock = 232448;  // shared memory one block can use

// out[i] = sum_j K[i, j] v[j], one warp per row
template <typename T>
__device__ void dense_matvec(const T* K, const T* v, T* out,
                             int M) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int row = warp; row < M; row += nw) {
    const T* Kr = K + (size_t)row * M;
    T acc = T(0);
    for (int j = lane; j < M; j += 32) acc += Kr[j] * v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) out[row] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_kernel(const T* K, const T* b,
              const T* x0, T* out, int M, int iters,
              int warm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x = reinterpret_cast<T*>(smem_raw);
  T* r = x + M;
  T* p = r + M;
  T* ap = p + M;
  __shared__ T red[32];
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < M; i += nt) x[i] = warm ? x0[i] : T(0);
  __syncthreads();
  if (warm) {
    dense_matvec<T>(K, x, ap, M);
    __syncthreads();
  }
  T loc = T(0);
  for (int i = tid; i < M; i += nt) {
    const T ri = warm ? b[i] - ap[i] : b[i];
    r[i] = ri;
    p[i] = ri;
    loc += ri * ri;
  }
  T rs = block_sum<T>(loc, red);  // also publishes p

  for (int it = 0; it < iters; ++it) {
    dense_matvec<T>(K, p, ap, M);
    __syncthreads();
    loc = T(0);
    for (int i = tid; i < M; i += nt) loc += p[i] * ap[i];
    const T denom = block_sum<T>(loc, red);
    const T alpha = fabs(denom) > T(0) ? rs / denom : T(0);
    loc = T(0);
    for (int i = tid; i < M; i += nt) {
      x[i] += alpha * p[i];
      const T ri = r[i] - alpha * ap[i];
      r[i] = ri;
      loc += ri * ri;
    }
    const T rs_new = block_sum<T>(loc, red);
    const T beta = fabs(rs) > T(0) ? rs_new / rs : T(0);
    for (int i = tid; i < M; i += nt) p[i] = r[i] + beta * p[i];
    rs = rs_new;
    __syncthreads();
  }
  for (int i = tid; i < M; i += nt) out[i] = x[i];
}

template <typename T>
int cg_solve(const T* K, const T* b, const T* x0, T* out, int M, int iters,
             int warm, cudaStream_t s) {
  const size_t smem = 4 * (size_t)M * sizeof(T);
  cudaFuncSetAttribute(cg_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cg_kernel<T><<<1, kThreads, smem, s>>>(K, b, x0, out, M, iters, warm);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel B10: fixed-iteration BiCGStab on a dense general (non-symmetric)
// matrix — the local solve of ALS solver = 'bicgstab_fused'.
//
// Replaces ttnx/kernels/local_cg.py, bicgstab_solve_fused
// (_bicgstab_kernel): `iters` unpreconditioned BiCGStab steps on K (M, M)
// from x = 0 with rhat = r = b, every division guarded as safe_div
// (|c| > 0 ? a / c : 0):
//   v = K p;  alpha = rho / (rhat.v);  s = r - alpha v;  t = K s
//   omega = (t.s) / (t.t);  x += alpha p + omega s;  r = s - omega t
//   rho' = rhat.r;  beta = (rho' / rho) (alpha / omega)
//   p = r + beta (p - omega v)
//
// What bounds it on the H100: not FLOPs (4 M^2 an iteration: 33.6 MFLOP at
// M = 512, iters 32, half a microsecond at the f32 peak) and not bytes (K
// is 1 MB in f32 at M = 512, read once from device memory and then from
// L2): the two matvecs and four block reductions of an iteration are
// strictly dependent, so a solve costs iters x (two passes of one SM over
// K from L2 + four block-wide barriers) plus one launch.
//
// Design (B3's and B9's): one block of 1024 threads runs every iteration
// in one launch, with no host sync. K stays in device memory and is
// re-read from L2 by B9's multi-row matvec (kMatvecRows rows a warp,
// unrolled column loop). The seven iterates (x, r, rhat, p, v, s, t) live
// in shared memory; every inner product is a block reduction in a fixed
// order, so a call is deterministic.
template <typename T>
__device__ __forceinline__ T safe_div(T a, T c) {
  return fabs(c) > T(0) ? a / c : T(0);
}

template <typename T>
__device__ T block_dot(const T* a, const T* b, int M, T* red) {
  T loc = T(0);
  for (int i = threadIdx.x; i < M; i += blockDim.x) loc += a[i] * b[i];
  return block_sum<T>(loc, red);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bicgstab_kernel(const T* K, const T* b, T* out, int M, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x = reinterpret_cast<T*>(smem_raw);
  T* r = x + M;
  T* rhat = r + M;
  T* p = rhat + M;
  T* v = p + M;
  T* s = v + M;
  T* t = s + M;
  __shared__ T red[32];
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < M; i += nt) {
    x[i] = T(0);
    r[i] = b[i];
    rhat[i] = b[i];
    p[i] = b[i];
  }
  T rho = block_dot<T>(rhat, r, M, red);  // also publishes the iterates

  for (int it = 0; it < iters; ++it) {
    matvec_rows<T>(K, p, v, M);
    __syncthreads();
    const T alpha = safe_div(rho, block_dot<T>(rhat, v, M, red));
    for (int i = tid; i < M; i += nt) s[i] = r[i] - alpha * v[i];
    __syncthreads();
    matvec_rows<T>(K, s, t, M);
    __syncthreads();
    const T ts = block_dot<T>(t, s, M, red);
    const T omega = safe_div(ts, block_dot<T>(t, t, M, red));
    for (int i = tid; i < M; i += nt) {
      x[i] = x[i] + alpha * p[i] + omega * s[i];
      r[i] = s[i] - omega * t[i];
    }
    const T rho_new = block_dot<T>(rhat, r, M, red);  // publishes r
    const T beta = safe_div(rho_new, rho) * safe_div(alpha, omega);
    for (int i = tid; i < M; i += nt)
      p[i] = r[i] + beta * (p[i] - omega * v[i]);
    rho = rho_new;
    __syncthreads();
  }
  for (int i = tid; i < M; i += nt) out[i] = x[i];
}

template <typename T>
int bicgstab(const T* K, const T* b, T* out, int M, int iters,
             cudaStream_t st) {
  const size_t smem = 7 * (size_t)M * sizeof(T);
  if (M < 1 || iters < 0 || smem > kSmemBlock - 32 * sizeof(T))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(bicgstab_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  bicgstab_kernel<T><<<1, kThreads, smem, st>>>(K, b, out, M, iters);
  return (int)cudaGetLastError();
}
}  // namespace ttnx_cg

using namespace ttnx_cg;

extern "C" int ttnx_cg_solve_f32(const void* K, const void* b, const void* x0,
                                 void* out, int M, int iters, int warm,
                                 void* stream) {
  return cg_solve<float>((const float*)K, (const float*)b, (const float*)x0,
                         (float*)out, M, iters, warm, (cudaStream_t)stream);
}

extern "C" int ttnx_cg_solve_f64(const void* K, const void* b, const void* x0,
                                 void* out, int M, int iters, int warm,
                                 void* stream) {
  return cg_solve<double>((const double*)K, (const double*)b,
                          (const double*)x0, (double*)out, M, iters, warm,
                          (cudaStream_t)stream);
}

#define TTNX_BICGSTAB_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* K, const void* b, void* out, int M,        \
                      int iters, void* stream) {                             \
    return bicgstab<T>((const T*)K, (const T*)b, (T*)out, M, iters,          \
                       (cudaStream_t)stream);                                \
  }

TTNX_BICGSTAB_ENTRY(ttnx_bicgstab_f32, float)
TTNX_BICGSTAB_ENTRY(ttnx_bicgstab_f64, double)
