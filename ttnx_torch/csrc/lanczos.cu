// Kernel B9: fixed-iteration Lanczos with two-pass full
// reorthogonalization on a dense symmetric matrix — the DMRG local
// eigensolve under eig_solver = 'lanczos_fused'.
//
// Replaces ttnx/kernels/lanczos.py, lanczos_fused (_lanczos_kernel). From
// a unit vector v0 (M,), `iters` steps on K (M, M) produce the Krylov
// basis Q (iters, M), alphas (iters,) and betas (iters,):
//   Q[j] = v;  w = K v;  alpha_j = v.w
//   twice: c = Q w (rows 0..j), w -= Q^T c
//   b = |w|;  breakdown when b <= 1e-12: beta_j = 0 and every later row
//   of Q and every later alpha is exactly zero; else beta_j = b,
//   v = w / b.  beta_{iters-1} is always 0.
//
// What bounds it on the H100: each step reads all of K (4 MB in f32 at
// M = 1024, 8 MB in f64), strictly after the previous step, so a call is
// bound by how fast one SM streams K from L2 — by the L2 latency of the
// loads a warp keeps in flight. K does not fit in shared memory (227 KB);
// the TPU kernel kept it in VMEM.
//
// Design (B3's): one block of 1024 threads runs every step in one launch;
// K stays in device memory and is re-read from L2. Unlike B3's matvec
// (one warp per row, one load in flight), a warp takes kMatvecRows rows
// at a time and unrolls its column loop (matvec_rows, common.cuh), so
// kMatvecRows * 4 independent loads are in flight per lane. The Krylov
// basis lives in shared memory when it fits (iters M values: 32 KB in
// f32 at iters 8, M 1024; 192 KB in f64 at iters 24), else in the output
// buffer in device memory. The
// reorthogonalization coefficients are one warp per basis row; every
// inner product and every sum runs in a fixed order, so a call is
// deterministic.
#include "common.cuh"

namespace ttnx_lanczos {
using namespace ttnx;

constexpr int kThreads = 1024;
constexpr size_t kSmemBlock = 232448;  // shared memory one block can use

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lanczos_kernel(const T* K, const T* v0, T* Qout, T* alphas, T* betas,
                   int M, int iters, int q_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v = reinterpret_cast<T*>(smem_raw);
  T* w = v + M;
  T* coef = w + M;       // (iters,) reorthogonalization coefficients
  T* a_s = coef + iters;  // (iters,)
  T* b_s = a_s + iters;   // (iters,)
  T* Q = q_in_smem ? b_s + iters : Qout;
  __shared__ T red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const T tiny = T(1e-12);
  const size_t qsize = (size_t)iters * M;

  for (size_t i = tid; i < qsize; i += nt) Q[i] = T(0);
  for (int i = tid; i < iters; i += nt) {
    a_s[i] = T(0);
    b_s[i] = T(0);
  }
  for (int i = tid; i < M; i += nt) v[i] = v0[i];
  __syncthreads();

  for (int j = 0; j < iters; ++j) {
    T* qj = Q + (size_t)j * M;
    for (int i = tid; i < M; i += nt) qj[i] = v[i];
    matvec_rows<T>(K, v, w, M);
    __syncthreads();
    T loc = T(0);
    for (int i = tid; i < M; i += nt) loc += v[i] * w[i];
    const T alpha = block_sum<T>(loc, red);
    if (tid == 0) a_s[j] = alpha;
    if (j + 1 == iters) break;  // the last beta stays 0
    for (int pass = 0; pass < 2; ++pass) {
      for (int r = warp; r <= j; r += nw) {
        const T* qr = Q + (size_t)r * M;
        T acc = T(0);
        for (int i = lane; i < M; i += 32) acc += qr[i] * w[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc += __shfl_down_sync(0xffffffffu, acc, o);
        if (lane == 0) coef[r] = acc;
      }
      __syncthreads();
      for (int i = tid; i < M; i += nt) {
        T s = T(0);
        for (int r = 0; r <= j; ++r) s += coef[r] * Q[(size_t)r * M + i];
        w[i] -= s;
      }
      __syncthreads();
    }
    loc = T(0);
    for (int i = tid; i < M; i += nt) loc += w[i] * w[i];
    const T b = sqrt(fmax(block_sum<T>(loc, red), T(0)));
    const bool ok = b > tiny;
    if (tid == 0) b_s[j] = ok ? b : T(0);
    const T scale = fmax(b, tiny);
    for (int i = tid; i < M; i += nt) v[i] = ok ? w[i] / scale : T(0);
    __syncthreads();
  }
  __syncthreads();
  if (q_in_smem)
    for (size_t i = tid; i < qsize; i += nt) Qout[i] = Q[i];
  for (int i = tid; i < iters; i += nt) {
    alphas[i] = a_s[i];
    betas[i] = b_s[i];
  }
}

template <typename T>
int lanczos(const T* K, const T* v0, T* Q, T* alphas, T* betas, int M,
            int iters, cudaStream_t s) {
  const size_t limit = kSmemBlock - 32 * sizeof(T);  // minus red[]
  const size_t base = (2 * (size_t)M + 3 * (size_t)iters) * sizeof(T);
  const size_t with_q = base + (size_t)iters * M * sizeof(T);
  if (M < 1 || iters < 1 || base > limit)
    return (int)cudaErrorInvalidValue;
  const int q_in_smem = with_q <= limit;
  const size_t smem = q_in_smem ? with_q : base;
  cudaFuncSetAttribute(lanczos_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  lanczos_kernel<T><<<1, kThreads, smem, s>>>(K, v0, Q, alphas, betas, M,
                                                iters, q_in_smem);
  return (int)cudaGetLastError();
}
}  // namespace ttnx_lanczos

using namespace ttnx_lanczos;

#define TTNX_LANCZOS_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* K, const void* v0, void* Q, void* alphas,  \
                      void* betas, int M, int iters, void* stream) {         \
    return lanczos<T>((const T*)K, (const T*)v0, (T*)Q, (T*)alphas,          \
                      (T*)betas, M, iters, (cudaStream_t)stream);            \
  }

TTNX_LANCZOS_ENTRY(ttnx_lanczos_f32, float)
TTNX_LANCZOS_ENTRY(ttnx_lanczos_f64, double)
