// Kernels B11, B12, B13: batched small matrix products with every operand
// of one problem resident in shared memory — the rank-64 core contraction
// chain of the headline metric, its matmul ceiling, and the two-site
// merge.
//
// Replaces ttnx/kernels/contraction.py:
//   B13 two_site_merge (_merge_kernel): C[p] = A[p] @ B[p], f32 out for
//       any input type;
//   B12 matmul_chain (_matmul_chain_kernel): `iters` rounds of
//       x <- (x @ w in f32) cast to x's type;
//   B11 merge_resplit_chain (_chain_kernel): `iters` rounds of
//       c = (acc @ b in f32) cast to b's type, acc = (c @ w in f32) cast
//       to a's type.
// Every product accumulates in f32 over the exact products of its
// operands; the roundings sit where the TPU kernels put them.
//
// What bounds them on the H100: B11 and B12 are operation-bound (B11 at
// the bench shape, 4096 x (128 x 64) and 2048 iterations, does 3.52e13
// FLOP: 35.6 ms at the 989 TFLOP/s bf16 peak; B12, 4096 x (128 x 128) and
// 1024 iterations, 1.76e13 FLOP, 17.8 ms); they read their operands once
// and write one result. B13 is memory-bound (bf16 in, f32 out: 384 MB at
// the bench shape, 0.115 ms at 3.35 TB/s).
//
// Design (the TPU kernels' VMEM residency on one SM): one block of 256
// threads a problem loads its operands into shared memory once, keeps the
// iterate and the intermediate there for all iterations, and writes the
// result once. bf16 runs on the tensor cores (nvcuda::wmma m16n16k16,
// f32 accumulators), each warp owning 32 x 32 output tiles (2 x 2
// fragments, two operand loads an mma); a tile's accumulators go through a
// per-warp f32 staging tile in shared memory where they are rounded to the
// operand type. bf16 operands are padded to multiples of 32 with zeros
// (the padding stays zero through the chain) and their rows skewed by 16
// bytes against bank conflicts. f32 runs on the CUDA cores in IEEE f32
// (never TF32) through gemm_block (common.cuh). At the bench shapes a bf16
// B11 block holds 95 KB and a B12 block 110 KB of shared memory, two
// blocks to an SM. A problem whose operands exceed 227 KB is refused.
// Later work: wgmma from shared memory and several problems a block.
#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

namespace ttnx_mm {
using namespace ttnx;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps; one gemm group for f32
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 32;       // bf16 dims: multiples of the warp tile
constexpr int kSkew = 8;       // bf16 row skew, 16 bytes
constexpr size_t kScratch = 2048 * sizeof(float);  // staging / k-slices
constexpr size_t kSmemBlock = 232448;  // shared memory one block can use
static_assert(kWarps * 256 * sizeof(float) == kScratch, "bf16 staging");
static_assert(kTileSmem * sizeof(float) == kScratch, "f32 k-slices");

// Shared-memory layout of an operand (rows x cols): padded rows and the
// leading dimension.
template <typename T>
struct Layout {  // f32: dense
  __host__ __device__ static int rows(int r) { return r; }
  __host__ __device__ static int ld(int c) { return c; }
};
template <>
struct Layout<bf16> {
  __host__ __device__ static int rows(int r) {
    return (r + kPad - 1) / kPad * kPad;
  }
  __host__ __device__ static int ld(int c) { return rows(c) + kSkew; }
};

template <typename T>
__host__ __device__ size_t elems(int rows, int cols) {
  return (size_t)Layout<T>::rows(rows) * Layout<T>::ld(cols);
}

template <typename T>
__device__ __forceinline__ T cvt(float v);
template <>
__device__ __forceinline__ float cvt<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 cvt<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Global (rows, cols) row-major -> shared memory in Layout<T>, padding
// zeroed; 16-byte vectors where rows allow.
template <typename T>
__device__ void load(const T* g, int rows, int cols, T* s) {
  const int ld = Layout<T>::ld(cols), prow = Layout<T>::rows(rows);
  const int tid = threadIdx.x, nt = blockDim.x;
  constexpr int V = 16 / sizeof(T);
  if (cols % V != 0 || ((size_t)g & 15) != 0) {
    for (int e = tid; e < prow * ld; e += nt) {
      const int i = e / ld, j = e % ld;
      s[e] = (i < rows && j < cols) ? g[(size_t)i * cols + j] : cvt<T>(0.f);
    }
    return;
  }
  if (prow != rows || ld != cols)
    for (int e = tid; e < prow * ld; e += nt) {
      const int i = e / ld, j = e % ld;
      if (i >= rows || j >= cols) s[e] = cvt<T>(0.f);
    }
  const int vpr = cols / V;
  for (int q = tid; q < rows * vpr; q += nt) {
    const int i = q / vpr, j = (q % vpr) * V;
    *reinterpret_cast<uint4*>(s + (size_t)i * ld + j) =
        *reinterpret_cast<const uint4*>(g + (size_t)i * cols + j);
  }
}

template <typename T>
__device__ void store(const T* s, int rows, int cols, T* g) {
  const int ld = Layout<T>::ld(cols);
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x)
    g[e] = s[(size_t)(e / cols) * ld + e % cols];
}

// A (M x K) @ B (K x N), both in shared memory in Layout<bf16>, on the
// tensor cores; st(i, j, v) receives every f32 result of the padded range.
template <typename St>
__device__ void mm(const bf16* A, const bf16* B, int M, int N, int K,
                   float* scratch, const St& st) {
  using namespace nvcuda;
  const int lda = Layout<bf16>::ld(K), ldb = Layout<bf16>::ld(N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tn = Layout<bf16>::rows(N) / 32;
  const int tiles = Layout<bf16>::rows(M) / 32 * tn;
  const int k_end = (K + 15) / 16 * 16;
  float* stage = scratch + warp * 256;
  for (int t = warp; t < tiles; t += kWarps) {
    const int r0 = t / tn * 32, c0 = t % tn * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < k_end; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], A + (size_t)(r0 + 16 * i) * lda + k0,
                               lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], B + (size_t)k0 * ldb + c0 + 16 * j,
                               ldb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          st(r0 + 16 * i + e / 16, c0 + 16 * j + e % 16, stage[e]);
        __syncwarp();
      }
  }
}

// The same in IEEE f32 on the CUDA cores; st sees only i < M, j < N.
template <typename St>
__device__ void mm(const float* A, const float* B, int M, int N, int K,
                   float* scratch, const St& st) {
  gemm_block<float>(
      M, N, K, [&](int i, int k) { return A[i * K + k]; },
      [&](int k, int j) { return B[k * N + j]; }, st, scratch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const T* a, const T* b, float* out, int m, int k, int n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);
  T* As = reinterpret_cast<T*>(smem_raw + kScratch);
  T* Bs = As + elems<T>(m, k);
  const size_t p = blockIdx.x;
  load<T>(a + p * m * k, m, k, As);
  load<T>(b + p * k * n, k, n, Bs);
  __syncthreads();
  float* o = out + p * m * n;
  mm(As, Bs, m, n, k, scratch, [&](int i, int j, float v) {
    if (i < m && j < n) o[(size_t)i * n + j] = v;
  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    matmul_chain_kernel(const T* x, const T* w, T* out, int m, int k,
                        int iters) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);
  T* cur = reinterpret_cast<T*>(smem_raw + kScratch);
  T* nxt = cur + elems<T>(m, k);
  T* Ws = nxt + elems<T>(m, k);
  const size_t p = blockIdx.x;
  const int ld = Layout<T>::ld(k);
  load<T>(x + p * m * k, m, k, cur);
  load<T>(w + p * k * k, k, k, Ws);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    T* dst = nxt;
    mm(cur, Ws, m, k, k, scratch, [&](int i, int j, float v) {
      dst[(size_t)i * ld + j] = cvt<T>(v);
    });
    __syncthreads();
    nxt = cur;
    cur = dst;
  }
  store<T>(cur, m, k, out + p * m * k);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    merge_resplit_kernel(const T* a, const T* b, const T* w, T* out, int m,
                         int r, int n, int iters) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);
  T* acc = reinterpret_cast<T*>(smem_raw + kScratch);  // (m, r)
  T* Bs = acc + elems<T>(m, r);                        // (r, n)
  T* Ws = Bs + elems<T>(r, n);                         // (n, r)
  T* C = Ws + elems<T>(n, r);                          // (m, n)
  const size_t p = blockIdx.x;
  const int ldr = Layout<T>::ld(r), ldn = Layout<T>::ld(n);
  load<T>(a + p * m * r, m, r, acc);
  load<T>(b + p * r * n, r, n, Bs);
  load<T>(w + p * n * r, n, r, Ws);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    mm(acc, Bs, m, n, r, scratch, [&](int i, int j, float v) {
      C[(size_t)i * ldn + j] = cvt<T>(v);
    });
    __syncthreads();
    mm(C, Ws, m, r, n, scratch, [&](int i, int j, float v) {
      acc[(size_t)i * ldr + j] = cvt<T>(v);
    });
    __syncthreads();
  }
  store<T>(acc, m, r, out + p * m * r);
}

// Launch helper: refuse shapes whose operands do not fit one block's
// shared memory, then launch one block a problem.
template <typename K, typename... Args>
int launch(K kernel, size_t smem, int B, cudaStream_t s, Args... args) {
  if (B < 1 || smem > kSmemBlock) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<B, kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int two_site_merge(const T* a, const T* b, float* out, int B, int m, int k,
                   int n, cudaStream_t s) {
  if (m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = kScratch + (elems<T>(m, k) + elems<T>(k, n)) * sizeof(T);
  return launch(merge_kernel<T>, smem, B, s, a, b, out, m, k, n);
}

template <typename T>
int matmul_chain(const T* x, const T* w, T* out, int B, int m, int k,
                 int iters, cudaStream_t s) {
  if (m < 1 || k < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      kScratch + (2 * elems<T>(m, k) + elems<T>(k, k)) * sizeof(T);
  return launch(matmul_chain_kernel<T>, smem, B, s, x, w, out, m, k, iters);
}

template <typename T>
int merge_resplit_chain(const T* a, const T* b, const T* w, T* out, int B,
                        int m, int r, int n, int iters, cudaStream_t s) {
  if (m < 1 || r < 1 || n < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = kScratch + (elems<T>(m, r) + elems<T>(r, n) +
                                  elems<T>(n, r) + elems<T>(m, n)) *
                                     sizeof(T);
  return launch(merge_resplit_kernel<T>, smem, B, s, a, b, w, out, m, r, n,
                iters);
}
}  // namespace ttnx_mm

using namespace ttnx_mm;

#define TTNX_MERGE_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* a, const void* b, void* out, int B, int m, \
                      int k, int n, void* stream) {                          \
    return two_site_merge<T>((const T*)a, (const T*)b, (float*)out, B, m, k, \
                             n, (cudaStream_t)stream);                       \
  }

#define TTNX_MATMUL_CHAIN_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* x, const void* w, void* out, int B, int m, \
                      int k, int iters, void* stream) {                      \
    return matmul_chain<T>((const T*)x, (const T*)w, (T*)out, B, m, k,       \
                           iters, (cudaStream_t)stream);                     \
  }

#define TTNX_MERGE_RESPLIT_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const void* a, const void* b, const void* w,          \
                      void* out, int B, int m, int r, int n, int iters,      \
                      void* stream) {                                        \
    return merge_resplit_chain<T>((const T*)a, (const T*)b, (const T*)w,     \
                                  (T*)out, B, m, r, n, iters,                \
                                  (cudaStream_t)stream);                     \
  }

TTNX_MERGE_ENTRY(ttnx_two_site_merge_bf16, bf16)
TTNX_MERGE_ENTRY(ttnx_two_site_merge_f32, float)
TTNX_MATMUL_CHAIN_ENTRY(ttnx_matmul_chain_bf16, bf16)
TTNX_MATMUL_CHAIN_ENTRY(ttnx_matmul_chain_f32, float)
TTNX_MERGE_RESPLIT_ENTRY(ttnx_merge_resplit_chain_bf16, bf16)
TTNX_MERGE_RESPLIT_ENTRY(ttnx_merge_resplit_chain_f32, float)
