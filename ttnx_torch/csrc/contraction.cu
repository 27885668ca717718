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
// and write one result. B13 is memory-bound (bf16 in, f32 out: 402.7 MB
// at the bench shape, 0.120 ms at 3.35 TB/s).
//
// Design of B11 in bf16 (chain_wgmma_kernel, r <= 64, n r <= 512). Rows
// of the iterate are independent: row i evolves as acc_i <- bf16(bf16(
// acc_i b) w) and reads only b and w. One warpgroup (a block of 128
// threads) owns a strip of 64 rows and runs every iteration with no block
// barrier after the first load. b and w sit read-only in shared memory,
// transposed once into wgmma's K-major layout with the 128-byte swizzle;
// the iterate never leaves registers. The merge runs in chunks of 64
// columns of c: wgmma m64n64k16 with A (the iterate) from registers gives
// a 64 x 64 f32 chunk of c, whose bf16 rounding is, register for register,
// the A operand of the re-split product (wgmma m64nRk16 accumulating into
// the next iterate). Rounding c elementwise before the re-split sums
// chunk by chunk changes nothing but the order of f32 sums. 33 KB of
// shared memory and 106 registers a thread at the bench shape: four
// warpgroups an SM, whose products interleave on the tensor cores while
// one of them converts. Rows are padded to 64 and r to a multiple of 16
// with zeros (the padding stays zero through the chain). Larger r or n r
// take the wmma kernel below (merge_resplit_kernel); the wrapper chooses
// by shape.
//
// Design of B12 in bf16 (matmul_chain_wgmma_kernel, k <= 128): B11's.
// Rows of the iterate are independent (row i evolves as x_i <- bf16(x_i
// w)), so one warpgroup (a block of 128 threads) owns a 64-row strip and
// runs every iteration with no block barrier after the first load. w sits
// read-only in shared memory, transposed once into wgmma's K-major layout
// with the 128-byte swizzle: at k = 128 two 64-wide atoms along K, 32 KB.
// The iterate never leaves registers: an iteration is k/16 wgmma
// m64n128k16 with A from registers into 64 f32 accumulators, one commit
// and wait, and round_to_a, which turns accumulator columns 16q..16q+15
// into, register for register, k-step q of the next product. 33 KB of
// shared memory and at most 128 registers a thread: four warpgroups an SM,
// whose products interleave on the tensor cores while one of them rounds.
// Each strip loads w for itself (B11's choice): the 32 KB a strip are 268
// MB from L2 at the bench shape, under 1 % of the chain's time, and the
// four warpgroups of an SM never wait on one another, as two strips
// sharing one block's w would at its load. Rows are padded to 64 and k to
// 64 or 128 (wgmma's N of the two instantiations) with zeros, and the
// padding stays zero through the chain. Larger k, whose 64 + 32 registers
// of accumulators and operand no longer fit, take the wmma kernel below
// (matmul_chain_kernel); the wrapper chooses by shape.
//
// Design of B13 in bf16 (merge_mma_kernel): one block of 256 threads a
// problem, two blocks an SM, so one block's loads overlap another's
// stores and the hardware scheduler balances the last wave. A and B load
// by cp.async, marked evict-first in L2 (read once), into rows skewed by
// 16 bytes; mma.sync m16n8k16 with ldmatrix. Each warp's 16 x 64 f32 tile
// goes through 16 staging rows in shared memory and leaves as whole rows
// (16 lanes a row, 16-byte evict-first stores), so every store fills whole
// 128-byte lines. A persistent grid with two or three prefetch stages was
// built and measured slower (PERF.md). A problem whose operands and
// staging rows (72,704 bytes at the bench shape) do not fit one block
// takes merge_kernel below.
//
// The other routes (the TPU kernels' VMEM residency on one SM):
// one block of 256 threads a problem loads its operands into shared
// memory once, keeps the iterate and the intermediate there for all
// iterations, and writes the result once. bf16 runs on the tensor cores
// (nvcuda::wmma m16n16k16, f32 accumulators), each warp owning 32 x 32
// output tiles (2 x 2 fragments, two operand loads an mma); a tile's
// accumulators go through a per-warp f32 staging tile in shared memory
// where they are rounded to the operand type. bf16 operands are padded to
// multiples of 32 with zeros (the padding stays zero through the chain)
// and their rows skewed by 16 bytes against bank conflicts. f32 runs on
// the CUDA cores in IEEE f32 (never TF32) through gemm_block (common.cuh).
// A bf16 B12 block of this route holds 110 KB of shared memory at (128,
// 128), two blocks to an SM. A problem whose operands exceed 227 KB is
// refused.
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// Tensor-core primitives in PTX: mma.sync, ldmatrix, cp.async, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Two floats rounded to a bf16 pair, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pair_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bf16 lo_bf16(uint32_t v) {
  return reinterpret_cast<__nv_bfloat162*>(&v)->x;
}

__device__ __forceinline__ bf16 hi_bf16(uint32_t v) {
  return reinterpret_cast<__nv_bfloat162*>(&v)->y;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronous, bypassing L1 and marked for
// early eviction from L2: the data is read once.
__device__ __forceinline__ void cp_async16_evict_first(uint32_t s,
                                                       const void* g) {
  asm volatile(
      "{\n"
      ".reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, pol;\n"
      "}\n" ::"r"(s),
      "l"(g)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor of a K-major bf16 operand in the 128-byte
// swizzle: rows of 64 values (128 bytes), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Element offset of (row, col < 64) in that layout, rows counted from a
// 1024-byte aligned base: 16-byte chunk c of row i sits at c ^ (i % 8).
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an asynchronous product reads or writes are pinned here: the
// compiler may neither read them earlier nor reuse them before this point.
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x 64, f32) = a (64 x 16, bf16, registers) @ B (16 x 64, bf16,
// shared memory, K-major) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// The same with 16 output columns.
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t* a,
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// The same with 128 output columns: d (64 x 128, f32), 64 registers a
// thread.
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// ---------------------------------------------------------------------------
// B11 in bf16: one warpgroup a 64-row strip, the iterate in registers
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;
constexpr int kChainRows = 64;   // rows of a strip: wgmma's M
constexpr int kChunk = 64;       // columns of c a merge chunk
constexpr int kChainMaxN = 512;  // n r of the wgmma route

__host__ __device__ inline int chain_np(int n) {
  return (n + kChunk - 1) / kChunk * kChunk;
}

// 1 KB to align the swizzle atoms, b^T (np x 64) and w^T (np / 64 x rp x
// 64), in bytes
__host__ __device__ inline size_t chain_wgmma_smem(int n, int rp) {
  return 1024 + (size_t)chain_np(n) * (128 + 2 * rp);
}

// Accumulator fragment of 16 columns (two n8 tiles) rounded to the A
// fragment of the next product: rows g, g + 8; columns 2t, 2t + 8.
__device__ __forceinline__ void round_to_a(const float* d, uint32_t* a) {
  a[0] = pack_bf16(d[0], d[1]);
  a[1] = pack_bf16(d[2], d[3]);
  a[2] = pack_bf16(d[4], d[5]);
  a[3] = pack_bf16(d[6], d[7]);
}

template <int RP>
__global__ void __launch_bounds__(kWgThreads, 4)
    chain_wgmma_kernel(const bf16* a, const bf16* b, const bf16* w, bf16* out,
                       int m, int r, int n, int iters) {
  constexpr int KS = RP / 16;  // k-steps of the merge, n16 tiles of c @ w
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int np = chain_np(n), chunks = np / kChunk;
  bf16* bT = reinterpret_cast<bf16*>(base);                     // (np, 64)
  bf16* wT = reinterpret_cast<bf16*>(base + (size_t)np * 128);  // (., 64)
  const int tid = threadIdx.x;
  const int strips = (m + kChainRows - 1) / kChainRows;
  const size_t p = blockIdx.x / strips;
  const int row0 = (blockIdx.x % strips) * kChainRows;
  const bf16* bp = b + p * r * n;
  const bf16* wp = w + p * n * r;

  // b^T and w^T, zero-padded, once
  const int words = (np * 128 + chunks * RP * 128) / 16;
  for (int e = tid; e < words; e += kWgThreads)
    reinterpret_cast<uint4*>(base)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int e = tid; e < r * n; e += kWgThreads) {  // b (r, n): (k, j)
    const int k = e / n, j = e % n;
    bT[sw128(j, k)] = bp[e];
  }
  for (int e = tid; e < n * r; e += kWgThreads) {  // w (n, r): (j, c)
    const int j = e / r, c = e % r;
    wT[sw128((j / kChunk) * RP + c, j % kChunk)] = wp[e];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // this thread's rows of the strip and its A fragments of the iterate
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ra = row0 + warp * 16 + g, rb = ra + 8;
  const bf16* ap = a + p * m * r;
  const bf16 zero = __float2bfloat16_rn(0.f);
  auto at = [&](int i, int j) {
    return (i < m && j < r) ? ap[(size_t)i * r + j] : zero;
  };
  uint32_t af[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c0 = 16 * kk + 2 * t, c1 = c0 + 8;
    af[kk][0] = pair_bf16(at(ra, c0), at(ra, c0 + 1));
    af[kk][1] = pair_bf16(at(rb, c0), at(rb, c0 + 1));
    af[kk][2] = pair_bf16(at(ra, c1), at(ra, c1 + 1));
    af[kk][3] = pair_bf16(at(rb, c1), at(rb, c1 + 1));
  }

  const uint32_t bT_s = smem_u32(bT), wT_s = smem_u32(wT);
  for (int it = 0; it < iters; ++it) {
    float nx[RP / 2];  // the next iterate, f32
    for (int j = 0; j < chunks; ++j) {
      float c[32];  // c[:, 64 j : 64 j + 64] = acc @ b[:, chunk]
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_n64(c, af[kk], desc_sw128(bT_s + j * kChunk * 128 + kk * 32),
                  kk > 0);
      wg_commit();
      wg_wait_all();
      pin<32>(c);
      pin<4 * KS>(&af[0][0]);
      uint32_t cf[4][4];  // bf16(c): the A operand of the re-split
#pragma unroll
      for (int q = 0; q < 4; ++q) round_to_a(c + 8 * q, cf[q]);
      wg_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t wq = wT_s + j * RP * 128 + q * 32;
        if constexpr (RP == 64) {
          wgmma_n64(nx, cf[q], desc_sw128(wq), j > 0 || q > 0);
        } else {
#pragma unroll
          for (int h = 0; h < KS; ++h)
            wgmma_n16(nx + 8 * h, cf[q], desc_sw128(wq + h * 16 * 128),
                      j > 0 || q > 0);
        }
      }
      wg_commit();
      wg_wait_all();
      pin<RP / 2>(nx);
      pin<16>(&cf[0][0]);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) round_to_a(nx + 8 * kk, af[kk]);
  }

  bf16* op = out + p * m * r;
  auto put = [&](int i, int j, bf16 v) {
    if (i < m && j < r) op[(size_t)i * r + j] = v;
  };
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c0 = 16 * kk + 2 * t, c1 = c0 + 8;
    put(ra, c0, lo_bf16(af[kk][0]));
    put(ra, c0 + 1, hi_bf16(af[kk][0]));
    put(rb, c0, lo_bf16(af[kk][1]));
    put(rb, c0 + 1, hi_bf16(af[kk][1]));
    put(ra, c1, lo_bf16(af[kk][2]));
    put(ra, c1 + 1, hi_bf16(af[kk][2]));
    put(rb, c1, lo_bf16(af[kk][3]));
    put(rb, c1 + 1, hi_bf16(af[kk][3]));
  }
}

// ---------------------------------------------------------------------------
// B12 in bf16: one warpgroup a 64-row strip, the iterate in registers
// ---------------------------------------------------------------------------

constexpr int kMatmulWgmmaMaxK = 128;  // k of the wgmma route

// 1 KB to align the swizzle atoms, then w^T: kp / 64 atoms of kp rows x 64
// columns, in bytes
__host__ __device__ inline size_t matmul_wgmma_smem(int kp) {
  return 1024 + (size_t)kp * kp * sizeof(bf16);
}

template <int KP>
__global__ void __launch_bounds__(kWgThreads, 4)
    matmul_chain_wgmma_kernel(const bf16* x, const bf16* w, bf16* out, int m,
                              int k, int iters) {
  constexpr int KS = KP / 16;      // k-steps a product, n16 tiles of x @ w
  constexpr int ATOM = KP * 128;   // bytes of one 64-wide K atom of w^T
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* wT = reinterpret_cast<bf16*>(base);  // (KP / 64, KP, 64)
  const int tid = threadIdx.x;
  const int strips = (m + kChainRows - 1) / kChainRows;
  const size_t p = blockIdx.x / strips;
  const int row0 = (blockIdx.x % strips) * kChainRows;

  // w^T, zero-padded, once: w (k, k) element (c, j) at row j, column c % 64
  // of atom c / 64
  for (int e = tid; e < KP * KP / 8; e += kWgThreads)
    reinterpret_cast<uint4*>(base)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const bf16* wp = w + p * k * k;
  for (int e = tid; e < k * k; e += kWgThreads) {
    const int c = e / k, j = e % k;
    wT[(c / 64) * (ATOM / 2) + sw128(j, c % 64)] = wp[e];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // this thread's rows of the strip and its A fragments of the iterate
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ra = row0 + warp * 16 + g, rb = ra + 8;
  const bf16* xp = x + p * m * k;
  const bf16 zero = __float2bfloat16_rn(0.f);
  auto at = [&](int i, int j) {
    return (i < m && j < k) ? xp[(size_t)i * k + j] : zero;
  };
  uint32_t af[KS][4];
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    const int c0 = 16 * q + 2 * t, c1 = c0 + 8;
    af[q][0] = pair_bf16(at(ra, c0), at(ra, c0 + 1));
    af[q][1] = pair_bf16(at(rb, c0), at(rb, c0 + 1));
    af[q][2] = pair_bf16(at(ra, c1), at(ra, c1 + 1));
    af[q][3] = pair_bf16(at(rb, c1), at(rb, c1 + 1));
  }

  // k-step q reads K columns 16 q .. 16 q + 15: atom q / 4, 32 bytes a step
  // inside it (the start address field holds the byte address / 16)
  const uint64_t desc0 = desc_sw128(smem_u32(wT));
  for (int it = 0; it < iters; ++it) {
    float acc[KP / 2];  // x @ w, f32
    wg_fence();
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      const uint64_t desc = desc0 + (((q / 4) * ATOM + (q % 4) * 32) >> 4);
      if constexpr (KP == 128) {
        wgmma_n128(acc, af[q], desc, q > 0);
      } else {
        wgmma_n64(acc, af[q], desc, q > 0);
      }
    }
    wg_commit();
    wg_wait_all();
    pin<KP / 2>(acc);
    pin<4 * KS>(&af[0][0]);
    // accumulator columns 16 q .. 16 q + 15 are k-step q of the next product
#pragma unroll
    for (int q = 0; q < KS; ++q) round_to_a(acc + 8 * q, af[q]);
  }

  bf16* op = out + p * m * k;
  auto put = [&](int i, int j, bf16 v) {
    if (i < m && j < k) op[(size_t)i * k + j] = v;
  };
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    const int c0 = 16 * q + 2 * t, c1 = c0 + 8;
    put(ra, c0, lo_bf16(af[q][0]));
    put(ra, c0 + 1, hi_bf16(af[q][0]));
    put(rb, c0, lo_bf16(af[q][1]));
    put(rb, c0 + 1, hi_bf16(af[q][1]));
    put(ra, c1, lo_bf16(af[q][2]));
    put(ra, c1 + 1, hi_bf16(af[q][2]));
    put(rb, c1, lo_bf16(af[q][3]));
    put(rb, c1 + 1, hi_bf16(af[q][3]));
  }
}

// ---------------------------------------------------------------------------
// B13 in bf16: cp.async loads, mma.sync, whole-row streaming stores
// ---------------------------------------------------------------------------

constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kStageLd = 72;  // a staging row: 64 floats + 8 against conflicts

__host__ __device__ inline int up16(int x) { return (x + 15) / 16 * 16; }

// Shared memory of a block: A (mp x kp + 8) and B (kp x np + 8) in bf16,
// padded to 16 and skewed by 16 bytes, then each warp's 16 staging rows.
__host__ __device__ inline size_t merge_mma_smem(int m, int k, int n) {
  return ((size_t)up16(m) * (up16(k) + 8) +
          (size_t)up16(k) * (up16(n) + 8)) * sizeof(bf16) +
         (size_t)kMergeWarps * 16 * kStageLd * sizeof(float);
}

__global__ void __launch_bounds__(kMergeThreads)
    merge_mma_kernel(const bf16* a, const bf16* b, float* out, int m, int k,
                     int n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int mp = up16(m), kp = up16(k), np = up16(n);
  const int lda = kp + 8, ldb = np + 8;
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + (size_t)mp * lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* stg = reinterpret_cast<float*>(Bs + (size_t)kp * ldb) +
               warp * 16 * kStageLd;
  const size_t p = blockIdx.x;
  const bf16* ag = a + p * m * k;
  const bf16* bg = b + p * k * n;
  float* o = out + p * m * n;

  // A and B, read once: evict-first cp.async where rows are 16-byte
  // multiples, else element by element; the padding (A's rows m..mp and
  // columns k..kp, B's rows k..kp and columns n..np) set to zero
  if (k % 8 == 0 && n % 8 == 0 && ((size_t)a & 15) == 0 &&
      ((size_t)b & 15) == 0) {
    const int va = k / 8, vb = n / 8;
    for (int q = tid; q < m * va; q += kMergeThreads)
      cp_async16_evict_first(smem_u32(As + (q / va) * lda + (q % va) * 8),
                             ag + (size_t)q * 8);
    for (int q = tid; q < k * vb; q += kMergeThreads)
      cp_async16_evict_first(smem_u32(Bs + (q / vb) * ldb + (q % vb) * 8),
                             bg + (size_t)q * 8);
    cp_async_commit();
  } else {
    for (int e = tid; e < m * k; e += kMergeThreads)
      As[(e / k) * lda + e % k] = ag[e];
    for (int e = tid; e < k * n; e += kMergeThreads)
      Bs[(e / n) * ldb + e % n] = bg[e];
  }
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = tid; e < (mp - m) * kp; e += kMergeThreads)
    As[(m + e / kp) * lda + e % kp] = zero;
  for (int e = tid; e < m * (kp - k); e += kMergeThreads)
    As[(e / (kp - k)) * lda + k + e % (kp - k)] = zero;
  for (int e = tid; e < (kp - k) * np; e += kMergeThreads)
    Bs[(k + e / np) * ldb + e % np] = zero;
  for (int e = tid; e < k * (np - n); e += kMergeThreads)
    Bs[(e / (np - n)) * ldb + n + e % (np - n)] = zero;
  cp_async_wait<0>();
  __syncthreads();

  const bool vec_out = n % 4 == 0 && ((size_t)out & 15) == 0;
  const int tiles_n = (np + 63) / 64, tiles = mp / 16 * tiles_n;
  for (int tile = warp; tile < tiles; tile += kMergeWarps) {
    const int r0 = tile / tiles_n * 16, c0 = tile % tiles_n * 64;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int k0 = 0; k0 < kp; k0 += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, smem_u32(As + (r0 + (lane & 15)) * lda + k0 +
                               (lane >> 4) * 8));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n0 = c0 + 16 * jj;
        if (n0 < np) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, smem_u32(Bs + (k0 + (lane & 15)) * ldb +
                                          n0 + (lane >> 4) * 8));
          mma_16816(acc[2 * jj], af, bfr[0], bfr[1]);
          mma_16816(acc[2 * jj + 1], af, bfr[2], bfr[3]);
        }
      }
    }
    // the 16 x 64 tile through the warp's staging rows, then out as whole
    // rows: 16 lanes a row, 16 bytes a lane, evict-first
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(stg + g * kStageLd + 8 * j + 2 * t) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(stg + (g + 8) * kStageLd + 8 * j + 2 * t) =
          make_float2(acc[j][2], acc[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rr = 2 * i + (lane >> 4), cc = 4 * (lane & 15);
      const float4 v =
          *reinterpret_cast<const float4*>(stg + rr * kStageLd + cc);
      const int row = r0 + rr, col = c0 + cc;
      if (row >= m || col >= n) continue;
      float* dst = o + (size_t)row * n + col;
      if (vec_out) {
        __stcs(reinterpret_cast<float4*>(dst), v);
      } else {
        const float vs[4] = {v.x, v.y, v.z, v.w};
        for (int e = 0; e < 4 && col + e < n; ++e) dst[e] = vs[e];
      }
    }
    __syncwarp();
  }
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

template <int RP>
int chain_wgmma(const bf16* a, const bf16* b, const bf16* w, bf16* out,
                int B, int m, int r, int n, int iters, cudaStream_t s) {
  const size_t smem = chain_wgmma_smem(n, RP);
  const long long blocks = (long long)B * ((m + kChainRows - 1) / kChainRows);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(chain_wgmma_kernel<RP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  chain_wgmma_kernel<RP><<<(int)blocks, kWgThreads, smem, s>>>(
      a, b, w, out, m, r, n, iters);
  return (int)cudaGetLastError();
}

int merge_resplit_chain_wgmma(const bf16* a, const bf16* b, const bf16* w,
                              bf16* out, int B, int m, int r, int n,
                              int iters, cudaStream_t s) {
  if (B < 1 || m < 1 || r < 1 || r > 64 || n < 1 || n > kChainMaxN ||
      iters < 0)
    return (int)cudaErrorInvalidValue;
  switch ((r + 15) / 16) {
    case 1:
      return chain_wgmma<16>(a, b, w, out, B, m, r, n, iters, s);
    case 2:
      return chain_wgmma<32>(a, b, w, out, B, m, r, n, iters, s);
    case 3:
      return chain_wgmma<48>(a, b, w, out, B, m, r, n, iters, s);
    default:
      return chain_wgmma<64>(a, b, w, out, B, m, r, n, iters, s);
  }
}

template <int KP>
int matmul_wgmma(const bf16* x, const bf16* w, bf16* out, int B, int m,
                 int k, int iters, cudaStream_t s) {
  const size_t smem = matmul_wgmma_smem(KP);
  const long long blocks = (long long)B * ((m + kChainRows - 1) / kChainRows);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(matmul_chain_wgmma_kernel<KP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  matmul_chain_wgmma_kernel<KP><<<(int)blocks, kWgThreads, smem, s>>>(
      x, w, out, m, k, iters);
  return (int)cudaGetLastError();
}

int matmul_chain_wgmma(const bf16* x, const bf16* w, bf16* out, int B, int m,
                       int k, int iters, cudaStream_t s) {
  if (B < 1 || m < 1 || k < 1 || k > kMatmulWgmmaMaxK || iters < 0)
    return (int)cudaErrorInvalidValue;
  return k <= 64 ? matmul_wgmma<64>(x, w, out, B, m, k, iters, s)
                 : matmul_wgmma<128>(x, w, out, B, m, k, iters, s);
}

int two_site_merge_mma(const bf16* a, const bf16* b, float* out, int B,
                       int m, int k, int n, cudaStream_t s) {
  if (m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return launch(merge_mma_kernel, merge_mma_smem(m, k, n), B, s, a, b, out,
                m, k, n);
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

extern "C" int ttnx_merge_resplit_chain_wgmma_bf16(
    const void* a, const void* b, const void* w, void* out, int B, int m,
    int r, int n, int iters, void* stream) {
  return merge_resplit_chain_wgmma((const bf16*)a, (const bf16*)b,
                                   (const bf16*)w, (bf16*)out, B, m, r, n,
                                   iters, (cudaStream_t)stream);
}

extern "C" int ttnx_matmul_chain_wgmma_bf16(const void* x, const void* w,
                                            void* out, int B, int m, int k,
                                            int iters, void* stream) {
  return matmul_chain_wgmma((const bf16*)x, (const bf16*)w, (bf16*)out, B, m,
                            k, iters, (cudaStream_t)stream);
}

extern "C" int ttnx_two_site_merge_mma_bf16(const void* a, const void* b,
                                            void* out, int B, int m, int k,
                                            int n, void* stream) {
  return two_site_merge_mma((const bf16*)a, (const bf16*)b, (float*)out, B,
                            m, k, n, (cudaStream_t)stream);
}
