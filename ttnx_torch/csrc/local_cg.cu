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
