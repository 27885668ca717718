// Kernel B1, route "grid": the backward right-Gram chain of Gram-chain TT
// rounding as one persistent cooperative launch across the card.
//
// Replaces ttnx/kernels/gram.py, gram_chain_fused (_gram_chain_kernel),
// for f32 at n = 2 and RB = 64, 128, 256 (the heat CN step's stacks: RA = 4
// times r16, r32, r64); csrc/gram_chain.cu (route "staged") takes f64 and
// every other shape. For a padded chain y (d, R, n, R) in the public
// layout it computes
//     G_d = e0 e0^T,   G_k = sum_i y_k[:, i, :] G_{k+1} y_k[:, i, :]^T
// and writes Gs[k] = G_{k+1}, Gs (d, R, R).
//
// What bounds it on the H100: the d - 1 sites are strictly sequential and
// each is 2n (R, R) @ (R, R) products: 134 MFLOP at R = 256, 2.1 at R = 64.
// Route "staged" runs a site as two multi-block launches of 64 x 64 tiles,
// 16-32 of the 132 SMs busy: the chain is bound by occupancy and by the
// latency of 2(d - 1) dependent launches, not by FLOPs (its bound is
// 0.022 ms at R = 256).
//
// Design: one cooperative launch of as many 256-thread CTAs as there are
// tiles (at most the co-resident count) walks the whole chain, with a grid
// barrier after each of a site's two phases:
//   phase 1  T_i = y_k[:, i, :] @ G        32 x 32 tiles of T (n, R, R)
//   phase 2  G_new = sum_i T_i @ y_k[:, i, :]^T
//                                          32 x 16 tiles of G_new, the k
//                                          loop over (i, c) together
// (128 tiles each at R = 256, 32 at R = 128, 8 at R = 64). G is Gs[k] in
// the output stack and T a wrapper-allocated scratch (512 KB at R = 256),
// both L2 resident; y is read in place. Tiles are dealt out by a stride
// over gridDim.x, so any grid size gives the same result. A tile's operands
// stream through shared memory in 32-deep chunks by cp.async, four chunks
// in flight; each thread sums a 4 x 4 block of the tile over its share of
// every chunk's k (KS lanes split k), and the KS partial blocks are summed
// by a butterfly of shuffles. Every output element is summed by one CTA in
// a fixed order, with no atomics: two launches give the same bits.
//
// The grid barrier and the copies go through cooperative groups and small
// wrappers, so that the CPU emulation of tests/cuda_emu can run the index
// arithmetic unchanged.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace ttnx_gramgrid {
namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kTM = 32;                 // rows of an output tile
constexpr int kTN1 = 32, kTN2 = 16;     // its columns in phase 1, phase 2
constexpr int kKC = 32;                 // k depth of a staged chunk
constexpr int kLD = 36;                 // padded row of a staged chunk
constexpr int kStages = 4;              // chunks in flight
constexpr int kStage = 2 * kTM * kLD;   // floats of one stage (A and B)
constexpr size_t kSmemBytes = kStages * kStage * sizeof(float);
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes global -> shared, asynchronous, cached in L2 only (the operands
// are rewritten by other CTAs between barriers; L1 is not coherent).
__device__ __forceinline__ void copy16(float* s, const float* g) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
#else
  memcpy(s, g, 16);
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most `kStages - 2` committed groups are pending.
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
#endif
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One 32 x TN output tile C[m][n] = sum_k A[m][k] B(k, n) over K (a
// multiple of kKC). load(chunk, buffer) issues the cp.async copies of a
// chunk: A as [m][k] and B as [k][n] (BK false) or [n][k] (BK true), each
// row kLD floats apart. store(m, n, v) writes one element. Thread (warp w,
// lane): rows 4w..4w+3, columns n0..n0+3, and the quads g, g + KS, ... of
// each chunk's eight; the lanes of one 8-lane phase read distinct or equal
// float4s (no bank conflict). Starts and ends with every buffer free.
template <int TN, bool BK, class LOAD, class STORE>
__device__ __forceinline__ void tile(float* sm, int K, const LOAD& load,
                                     const STORE& store) {
  constexpr int NB = TN / 4, KS = 32 / NB;
  static_assert(KS == 4 || KS == 8, "a warp covers 4 rows of the tile");
  const int lane = threadIdx.x & 31;
  const int g = KS == 4 ? lane / NB : lane % KS;
  const int n0 = 4 * (KS == 4 ? lane % NB : lane / KS);
  const int m0 = 4 * (threadIdx.x >> 5);
  const int chunks = K / kKC;
  float acc[4][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    copy_commit();
  }
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    copy_wait();
    __syncthreads();  // chunk c is in; chunk c - 1's buffer is free
    if (c + kStages - 1 < chunks)
      load(c + kStages - 1, (c + kStages - 1) % kStages);
    copy_commit();
    const float* A = sm + (c % kStages) * kStage;
    const float* B = A + kTM * kLD;
#pragma unroll
    for (int q = g; q < kKC / 4; q += KS) {
      float a[4][4], b[4][4];  // a[i][kq] = A[m0+i][4q+kq], b[kq][j]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = ld4(A + (m0 + i) * kLD + 4 * q);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 v = BK ? ld4(B + (n0 + r) * kLD + 4 * q)
                            : ld4(B + (4 * q + r) * kLD + n0);
        if (BK) {
          b[0][r] = v.x;
          b[1][r] = v.y;
          b[2][r] = v.z;
          b[3][r] = v.w;
        } else {
          b[r][0] = v.x;
          b[r][1] = v.y;
          b[r][2] = v.z;
          b[r][3] = v.w;
        }
      }
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(a[i][kq], b[kq][j], acc[i][j]);
    }
  }
  __syncthreads();  // every buffer free for the next tile
  // the KS partial blocks: a butterfly leaves the same sums in every lane
#pragma unroll
  for (int m = (KS == 4 ? NB : 1); m < (KS == 4 ? 32 : KS); m *= 2)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += __shfl_xor_sync(kFull, acc[i][j], m);
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e % KS == g) store(m0 + e / 4, n0 + e % 4, acc[e / 4][e % 4]);
}

__global__ void __launch_bounds__(kThreads)
    gram_grid_kernel(const float* y, float* Gs, float* T, int d, int R,
                     int n) {
  extern __shared__ __align__(16) float gram_smem[];
  float* sm = gram_smem;
  cg::grid_group grid = cg::this_grid();
  const size_t RR = (size_t)R * R;
  const int nR = n * R, t = threadIdx.x;
  float* Gd = Gs + (size_t)(d - 1) * RR;
  for (size_t e = (size_t)blockIdx.x * kThreads + t; e < RR;
       e += (size_t)gridDim.x * kThreads)
    Gd[e] = e == 0 ? 1.f : 0.f;
  const int mt = R / kTM, nt1 = R / kTN1, nt2 = R / kTN2;
  const int r = t / (kKC / 4), q4 = 4 * (t % (kKC / 4));  // a copy's row, col
  for (int k = d - 1; k >= 1; --k) {
    grid.sync();
    const float* yk = y + (size_t)k * R * nR;
    const float* G = Gs + (size_t)k * RR;
    // phase 1: T[i][a][c] = sum_b y[k, a, i, b] G[b, c]
    for (int tt = blockIdx.x; tt < n * mt * nt1; tt += gridDim.x) {
      const int i = tt / (mt * nt1), a0 = (tt / nt1) % mt * kTM,
                c0 = tt % nt1 * kTN1;
      const float* ya = yk + (size_t)(a0 + r) * nR + i * R + q4;
      const float* gb = G + (size_t)r * R + c0 + q4;
      float* Ti = T + (size_t)i * RR;
      tile<kTN1, false>(
          sm, R,
          [&](int c, int s) {
            float* A = sm + s * kStage;
            copy16(A + r * kLD + q4, ya + c * kKC);
            copy16(A + kTM * kLD + r * kLD + q4, gb + (size_t)c * kKC * R);
          },
          [&](int m, int c, float v) {
            Ti[(size_t)(a0 + m) * R + c0 + c] = v;
          });
    }
    grid.sync();
    // phase 2: Gn[a, x] = sum_{i, c} T[i][a][c] y[k, x, i, c]
    float* Gn = Gs + (size_t)(k - 1) * RR;
    for (int tt = blockIdx.x; tt < mt * nt2; tt += gridDim.x) {
      const int a0 = tt / nt2 * kTM, x0 = tt % nt2 * kTN2;
      const float* yx = yk + (size_t)(x0 + r) * nR + q4;
      tile<kTN2, true>(
          sm, nR,
          [&](int c, int s) {
            float* A = sm + s * kStage;
            const int kk = c * kKC, i = kk / R;
            copy16(A + r * kLD + q4,
                   T + ((size_t)i * R + a0 + r) * R + kk % R + q4);
            if (r < kTN2) copy16(A + kTM * kLD + r * kLD + q4, yx + kk);
          },
          [&](int m, int x, float v) {
            Gn[(size_t)(a0 + m) * R + x0 + x] = v;
          });
    }
  }
}

// The co-resident CTAs of the kernel on the current device (cached a
// device).
int resident_ctas() {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gram_grid_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

// As many CTAs as the larger phase has tiles, at most the co-resident
// count; none co-resident is an error (never another route).
int gram_grid(const float* y, float* Gs, float* T, int d, int R, int n,
              cudaStream_t st) {
  if (n != 2 || (R != 64 && R != 128 && R != 256) || d < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles1 = n * (R / kTM) * (R / kTN1),
            tiles2 = (R / kTM) * (R / kTN2);
  const int most = resident_ctas();
  if (most < 0) return -most;
  int grid = tiles1 > tiles2 ? tiles1 : tiles2;
  if (grid > most) grid = most;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, gram_grid_kernel, y, Gs, T, d, R, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
}  // namespace ttnx_gramgrid

// B1, route grid: y (d, R, 2, R), out (d, R, R), scratch (2, R, R), f32,
// 16-byte aligned; R = 64, 128 or 256, n = 2, other shapes refused.
extern "C" int ttnx_gram_chain_grid_f32(const void* y, void* out,
                                        void* scratch, int d, int R, int n,
                                        void* stream) {
  return ttnx_gramgrid::gram_grid((const float*)y, (float*)out,
                                  (float*)scratch, d, R, n,
                                  (cudaStream_t)stream);
}
