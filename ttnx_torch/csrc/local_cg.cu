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
// strictly sequential, so a solve is bound by the dependent chain of its
// iterations: one matvec and two reductions each. K does not fit in one
// SM's shared memory (227 KB), unlike the TPU kernel's VMEM-resident K.
//
// Design of route "cluster" (cg_cluster_kernel, f32, M <= 672), on the
// engine of dense_cluster.cuh as B10's: one cluster of C = 8 CTAs, 256
// threads each; CTA c holds rows [c R, c R + R) of K in its shared memory
// for the whole solve, R = ceil(M / C) (64 rows, 128 KB at M = 512), its
// slices of x and K p, and full-length p and r. An iteration runs two
// cluster barriers: (1) the partials of p.Kp; (2) the partials of r.r,
// with every CTA's new slice of r pushed into every partner's full r in
// the same exchange. After (2) each CTA updates the whole of p = r + beta
// p itself (elementwise from the same bits: the same p in every CTA), so
// p needs no exchange. The warm start is one more matvec whose r slices
// ride on the first barrier. Every CTA sums the partials in rank order,
// so all hold the same alpha and beta and a call is deterministic.
//
// Design of route "l2" (cg_kernel: f64, larger M): one block of 1024
// threads runs the whole solve in one launch. The iterates x, r, p, Kp
// live in shared memory (4 M values), K stays in device memory and is
// re-read from L2 each iteration, one warp per row with coalesced loads;
// r.r and p.Kp are block reductions in a fixed order (deterministic).
#include "common.cuh"
#include "dense_cluster.cuh"

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
// L2): the two matvecs and four reductions of an iteration are strictly
// dependent, so a solve costs iters x (two passes over K + the
// reductions' barriers) plus one launch. On route "l2" that is two passes
// of one SM over K from L2 and four block barriers, 22.1 us an iteration
// at M = 512 on an H100 (700 W); on route "cluster" two passes of 8 SMs
// over their shares in shared memory and five cluster barriers of about
// 0.47 us each, 5.95 us an iteration.
//
// Design of route "cluster" (bicgstab_cluster_kernel, f32, M <= 668):
// one cluster of C = 8 CTAs (portable), 256 threads each, on the engine
// of dense_cluster.cuh. CTA c owns rows [c R, c R + R) of K, R = ceil(M /
// C) (64 rows, 128 KB at M = 512), loaded into its shared memory once by
// evict-first cp.async and read from there by both matvecs of every
// iteration; it owns the same slice of x, r, rhat, v and t, and keeps
// full-length p and s, the vectors a matvec reads. An iteration runs five
// cluster barriers, each carrying what its consumer needs: (1) the
// partials of rhat.v, (2) every CTA's slice of s pushed into every copy,
// (3) the partials of t.s and t.t in one exchange, (4) those of rhat.r,
// (5) every slice of p pushed. Each slot array and full vector is
// written at least one barrier after its last reader has passed, so none
// needs a second buffer; no CTA reads a partner's memory, and the last
// barrier follows the last push, so no CTA exits while a partner still
// writes into it. Every CTA sums the partials in rank order, so all hold
// the same alpha, omega and beta and a call is deterministic. A CTA's 64
// rows at 4 B are 2048 clocks of its SM's shared-memory bandwidth an
// iteration, against two passes of one SM over 1 MB of L2.
//
// Design of route "l2" (bicgstab_kernel: f64, M > 668; B3's and B9's):
// one block of 1024 threads runs every iteration in one launch, with no
// host sync. K stays in device memory and is re-read from L2 by B9's
// multi-row matvec (kMatvecRows rows a warp, unrolled column loop). The
// seven iterates (x, r, rhat, p, v, s, t) live in shared memory; every
// inner product is a block reduction in a fixed order, so a call is
// deterministic.
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

// ---------------------------------------------------------------------------
// Route "cluster": B10 in f32 on a cluster of C CTAs, K resident in their
// shared memory
// ---------------------------------------------------------------------------

constexpr int kClusterThreads = 256;
constexpr int kCluster = 8;  // CTAs a cluster: the portable maximum

extern __shared__ __align__(16) float bcl_smem[];  // one CTA's regions

__host__ __device__ inline int up4(int x) { return (x + 3) / 4 * 4; }

// Shared memory of one CTA in bytes: its rows of K (ceil(M / C) x ld),
// full p and s (ld each), its slices of x, r, rhat, v, t and four slot
// arrays of C partials; ld = M rounded up to float4s.
__host__ __device__ inline size_t bicgstab_cluster_smem(int M, int C) {
  const int rpc = (M + C - 1) / C;
  return ((size_t)rpc * up4(M) + 2 * up4(M) + 5 * up4(rpc) + 4 * C) *
         sizeof(float);
}

template <int C>
__global__ void __launch_bounds__(kClusterThreads)
    bicgstab_cluster_kernel(const float* K, const float* b, float* out,
                            int M, int iters) {
  using namespace ttnx_cluster;
  const int rank = cluster_rank();
  const int ld = up4(M), rpc = (M + C - 1) / C, rp4 = up4(rpc);
  const int row0 = rank * rpc;
  const int rows = M - row0 < rpc ? (M - row0 > 0 ? M - row0 : 0) : rpc;
  float* Ks = bcl_smem;                // (rows, ld): K[row0 + i, :]
  float* p = Ks + (size_t)rpc * ld;    // full length
  float* s = p + ld;                   // full length
  float* x = s + ld;                   // this CTA's slices, rp4 each
  float* r = x + rp4;
  float* rh = r + rp4;
  float* v = rh + rp4;
  float* t = v + rp4;
  float* slot_a = t + rp4;  // partials: rhat.v
  float* slot_ts = slot_a + C;  // t.s
  float* slot_tt = slot_ts + C;  // t.t
  float* slot_r = slot_tt + C;  // rhat.r
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const bool w0 = tid < 32;  // warp 0 updates the slices and reduces

  const float* Kp = K + (size_t)row0 * M;
  if (M % 4 == 0 && ((size_t)K & 15) == 0) {
    const int q4 = M / 4;
    for (int e = tid; e < rows * q4; e += nt)
      copy16(Ks + (size_t)(e / q4) * ld + (e % q4) * 4, Kp + (size_t)e * 4);
  } else {
    for (int e = tid; e < rows * ld; e += nt) {
      const int i = e / ld, j = e % ld;
      Ks[e] = j < M ? Kp[(size_t)i * M + j] : 0.f;
    }
  }
  for (int j = tid; j < ld; j += nt) {
    p[j] = j < M ? b[j] : 0.f;
    s[j] = 0.f;
  }
  for (int i = tid; i < rows; i += nt) {
    x[i] = 0.f;
    r[i] = b[row0 + i];
    rh[i] = b[row0 + i];
  }
  copy_wait();
  cluster_sync();  // every CTA runs and holds its rows: DSMEM from here on
  if (w0) push_partial<C>(slot_r, warp_dot(rh, r, rows), rank);
  cluster_sync();
  float rho = cluster_sum<C>(slot_r);

  for (int it = 0; it < iters; ++it) {
    slice_matvec(Ks, p, v, rows, ld);  // v = K p
    __syncthreads();
    if (w0) push_partial<C>(slot_a, warp_dot(rh, v, rows), rank);
    cluster_sync();  // (1)
    const float alpha = safe_div(rho, cluster_sum<C>(slot_a));
    if (w0)
      for (int i = lane; i < rows; i += 32)
        push_all<C>(s, row0 + i, r[i] - alpha * v[i]);
    cluster_sync();  // (2) s complete in every CTA
    slice_matvec(Ks, s, t, rows, ld);  // t = K s
    __syncthreads();
    if (w0) {
      push_partial<C>(slot_ts, warp_dot(t, s + row0, rows), rank);
      push_partial<C>(slot_tt, warp_dot(t, t, rows), rank);
    }
    cluster_sync();  // (3)
    const float omega =
        safe_div(cluster_sum<C>(slot_ts), cluster_sum<C>(slot_tt));
    if (w0) {
      for (int i = lane; i < rows; i += 32) {
        const float si = s[row0 + i];
        x[i] = x[i] + alpha * p[row0 + i] + omega * si;
        r[i] = si - omega * t[i];
      }
      push_partial<C>(slot_r, warp_dot(rh, r, rows), rank);  // same lanes
    }
    cluster_sync();  // (4)
    const float rho_new = cluster_sum<C>(slot_r);
    const float beta = safe_div(rho_new, rho) * safe_div(alpha, omega);
    if (w0)
      for (int i = lane; i < rows; i += 32) {
        const int j = row0 + i;
        push_all<C>(p, j, r[i] + beta * (p[j] - omega * v[i]));
      }
    rho = rho_new;
    cluster_sync();  // (5) p complete in every CTA; no push after the last
  }
  for (int i = tid; i < rows; i += nt) out[row0 + i] = x[i];
}

// One cluster of C CTAs (ttnx_cluster::launch_cluster).
template <int C>
int bicgstab_cluster(const float* K, const float* b, float* out, int M,
                     int iters, cudaStream_t st) {
  const size_t smem = bicgstab_cluster_smem(M, C);
  if (M < 1 || iters < 0 || smem > kSmemBlock)
    return (int)cudaErrorInvalidValue;
  static size_t fits = 0;
  return ttnx_cluster::launch_cluster(bicgstab_cluster_kernel<C>, C,
                                      kClusterThreads, smem, st, &fits, K, b,
                                      out, M, iters);
}

// ---------------------------------------------------------------------------
// Route "cluster" of B3: CG in f32 on a cluster of C CTAs, K resident in
// their shared memory
// ---------------------------------------------------------------------------

// Shared memory of one CTA in bytes: its rows of K (ceil(M / C) x ld),
// full p and r (ld each), its slices of x and K p and two slot arrays of
// C partials.
__host__ __device__ inline size_t cg_cluster_smem(int M, int C) {
  const int rpc = (M + C - 1) / C;
  return ((size_t)rpc * up4(M) + 2 * up4(M) + 2 * up4(rpc) + 2 * C) *
         sizeof(float);
}

template <int C>
__global__ void __launch_bounds__(kClusterThreads)
    cg_cluster_kernel(const float* K, const float* b, const float* x0,
                      float* out, int M, int iters, int warm) {
  using namespace ttnx_cluster;
  const int rank = cluster_rank();
  const int ld = up4(M), rpc = (M + C - 1) / C, rp4 = up4(rpc);
  const int row0 = rank * rpc;
  const int rows = M - row0 < rpc ? (M - row0 > 0 ? M - row0 : 0) : rpc;
  float* Ks = bcl_smem;              // (rows, ld): K[row0 + i, :]
  float* p = Ks + (size_t)rpc * ld;  // full length
  float* r = p + ld;                 // full length
  float* x = r + ld;                 // this CTA's slices, rp4 each
  float* ap = x + rp4;
  float* slot_d = ap + rp4;  // partials: p.Kp
  float* slot_r = slot_d + C;  // r.r
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const bool w0 = tid < 32;  // warp 0 updates the slices and reduces

  load_rows(Ks, K, row0, rows, M, ld);
  for (int j = tid; j < ld; j += nt) {
    p[j] = j < M ? (warm ? x0[j] : b[j]) : 0.f;  // x0 first when warm
    r[j] = j < M ? b[j] : 0.f;
  }
  for (int i = tid; i < rows; i += nt) x[i] = warm ? x0[row0 + i] : 0.f;
  copy_wait();
  cluster_sync();  // every CTA runs and holds its rows: DSMEM from here on
  if (warm) {
    slice_matvec(Ks, p, ap, rows, ld);  // K x0
    __syncthreads();
    if (w0) {
      float s = 0.f;
      for (int i = lane; i < rows; i += 32) {
        const float ri = b[row0 + i] - ap[i];
        push_all<C>(r, row0 + i, ri);
        s += ri * ri;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      push_partial<C>(slot_r, s, rank);
    }
  } else if (w0) {
    push_partial<C>(slot_r, warp_dot(r + row0, r + row0, rows), rank);
  }
  cluster_sync();  // r complete in every CTA
  float rs = cluster_sum<C>(slot_r);
  if (warm)
    for (int j = tid; j < ld; j += nt) p[j] = r[j];
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    slice_matvec(Ks, p, ap, rows, ld);  // Kp
    __syncthreads();
    if (w0) push_partial<C>(slot_d, warp_dot(p + row0, ap, rows), rank);
    cluster_sync();  // (1)
    const float alpha = safe_div(rs, cluster_sum<C>(slot_d));
    if (w0) {
      float s = 0.f;
      for (int i = lane; i < rows; i += 32) {
        const int j = row0 + i;
        x[i] += alpha * p[j];
        const float ri = r[j] - alpha * ap[i];
        push_all<C>(r, j, ri);
        s += ri * ri;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      push_partial<C>(slot_r, s, rank);
    }
    cluster_sync();  // (2) r complete in every CTA; no push after the last
    const float rs_new = cluster_sum<C>(slot_r);
    const float beta = safe_div(rs_new, rs);
    for (int j = tid; j < ld; j += nt) p[j] = r[j] + beta * p[j];
    rs = rs_new;
    __syncthreads();
  }
  for (int i = tid; i < rows; i += nt) out[row0 + i] = x[i];
}

// One cluster of C CTAs, launched as B10's.
template <int C>
int cg_cluster(const float* K, const float* b, const float* x0, float* out,
               int M, int iters, int warm, cudaStream_t st) {
  const size_t smem = cg_cluster_smem(M, C);
  if (M < 1 || iters < 0 || smem > kSmemBlock)
    return (int)cudaErrorInvalidValue;
  static size_t fits = 0;
  return ttnx_cluster::launch_cluster(cg_cluster_kernel<C>, C,
                                      kClusterThreads, smem, st, &fits, K, b,
                                      x0, out, M, iters, warm);
}
}  // namespace ttnx_cg

using namespace ttnx_cg;

extern "C" int ttnx_cg_solve_cluster_f32(const void* K, const void* b,
                                         const void* x0, void* out, int M,
                                         int iters, int warm, void* stream) {
  return cg_cluster<kCluster>((const float*)K, (const float*)b,
                              (const float*)x0, (float*)out, M, iters, warm,
                              (cudaStream_t)stream);
}

extern "C" int ttnx_bicgstab_cluster_f32(const void* K, const void* b,
                                         void* out, int M, int iters,
                                         void* stream) {
  return bicgstab_cluster<kCluster>((const float*)K, (const float*)b,
                                    (float*)out, M, iters,
                                    (cudaStream_t)stream);
}

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
