// Kernel B1: the backward right-Gram chain of Gram-chain TT rounding.
//
// Replaces ttnx/kernels/gram.py, gram_chain_fused (_gram_chain_kernel).
// Computes, for a padded chain y (d, R, n, R) in the public layout,
//     G_d = e0 e0^T,   G_k = sum_i y_k[:, i, :] G_{k+1} y_k[:, i, :]^T
// and writes Gs[k] = G_{k+1}, Gs (d, R, R).
//
// What bounds it on the H100: the d-1 sites are strictly sequential and
// each is 2n (R, R) @ (R, R) products (R = RA * rank = 64, 128, 256 on the
// CN step: 0.5 to 34 MFLOP a site), so the chain is latency bound, not
// FLOP or byte bound. The carried G is 256 KB in f32 at R = 256, more than
// an SM's 227 KB of shared memory, so the TPU design (whole chain resident
// in VMEM) does not carry over.
//
// Design: G lives in the output stack in device memory (L2 resident: the
// whole stack is 3 MB at R = 256). Each site is two launches on the stream,
// whose order is the dependency: T_i = y_i @ G for all i (grid tiles x n),
// then G_new = sum_i T_i @ y_i^T (grid tiles, the sum over i folded into
// the k loop). y is read through strided views, with no (d, n, R, R)
// transpose. Later work: one persistent cooperative launch over the chain.
#include "common.cuh"

namespace ttnx_gram {
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

// scratch[i][a][c] = sum_b y[k, a, i, b] G[b, c]
template <typename T>
__global__ void __launch_bounds__(kGroup)
    gram_left(const T* y, const T* G,
              T* scratch, int k, int R, int n) {
  __shared__ T smem[kTileSmem];
  const int i = blockIdx.z;
  const T* yk = y + (size_t)k * R * n * R;
  T* out = scratch + (size_t)i * R * R;
  gemm_tile<T>(
      R, R, R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int a, int b) { return yk[(size_t)a * n * R + i * R + b]; },
      [&](int b, int c) { return G[(size_t)b * R + c]; },
      [&](int a, int c, T v) { out[(size_t)a * R + c] = v; }, smem,
      threadIdx.x, 0);
}

// Gn[a, x] = sum_{i, c} scratch[i][a][c] y[k, x, i, c]
template <typename T>
__global__ void __launch_bounds__(kGroup)
    gram_right(const T* y, const T* scratch,
               T* Gn, int k, int R, int n) {
  __shared__ T smem[kTileSmem];
  const T* yk = y + (size_t)k * R * n * R;
  gemm_tile<T>(
      R, R, n * R, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int a, int kk) {
        return scratch[((size_t)(kk / R) * R + a) * R + kk % R];
      },
      [&](int kk, int x) { return yk[(size_t)x * n * R + kk]; },
      [&](int a, int x, T v) { Gn[(size_t)a * R + x] = v; }, smem,
      threadIdx.x, 0);
}

template <typename T>
int gram_chain(const T* y, T* out, T* scratch, int d, int R, int n,
               cudaStream_t s) {
  launch_set_e0<T>(out + (size_t)(d - 1) * R * R, R * R, s);
  const dim3 g1(cdiv(R, kBN), cdiv(R, kBM), n), g2(cdiv(R, kBN), cdiv(R, kBM));
  for (int k = d - 1; k >= 1; --k) {
    const T* G = out + (size_t)k * R * R;
    gram_left<T><<<g1, kGroup, 0, s>>>(y, G, scratch, k, R, n);
    gram_right<T><<<g2, kGroup, 0, s>>>(y, scratch,
                                        out + (size_t)(k - 1) * R * R, k, R,
                                        n);
  }
  return (int)cudaGetLastError();
}
}  // namespace ttnx_gram

using namespace ttnx_gram;

extern "C" int ttnx_gram_chain_f32(const void* y, void* out, void* scratch,
                                   int d, int R, int n, void* stream) {
  return gram_chain<float>((const float*)y, (float*)out, (float*)scratch, d,
                           R, n, (cudaStream_t)stream);
}

extern "C" int ttnx_gram_chain_f64(const void* y, void* out, void* scratch,
                                   int d, int R, int n, void* stream) {
  return gram_chain<double>((const double*)y, (double*)out, (double*)scratch,
                            d, R, n, (cudaStream_t)stream);
}
