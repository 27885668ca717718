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
// bound by the dependent chain of its steps: a matvec, two
// reorthogonalization passes and a norm each. On one SM that is how fast
// the SM streams K from L2 (the route "l2" kernel); K does not fit in one
// SM's shared memory (227 KB); the TPU kernel kept it in VMEM.
//
// Design of route "cluster" (lanczos_cluster_kernel, f32, M <= 1024), on
// the engine of dense_cluster.cuh: one cluster of C CTAs (kCluster = 16,
// a non-portable size), 256 threads each. CTA c owns rows [c R, c R + R)
// of K, R = ceil(M / C): 64 rows, 256 KB at M = 1024, more than its
// shared memory, so it keeps the first rows that fit there for the whole
// call (54 at iters 8) and streams the others from L2 on every matvec
// (streamed_matvec). It keeps full v (the vector its matvec reads), its
// slices of w and of the basis Q (iters x R, in shared memory when it
// fits, else in the output) and slot arrays of partials. A step runs
// three cluster barriers: (1) the partials of Q[r].w for every stored
// row r <= j; the one of row j (Q[j] = v) is alpha; (2) those of the
// second pass; (3) those of |w|^2, with every CTA's w slice pushed into
// every partner's full v in the same exchange. Each CTA then scales its
// full v by 1 / max(b, 1e-12), or zeroes it on breakdown. Every CTA sums
// the partials in rank order, so all hold the same coefficients, alpha
// and b, take the same branch and run the same barriers; a call is
// deterministic. CTA c writes its columns of Q, rank 0 alphas and betas.
//
// Design of route "l2" (lanczos_kernel: f64, M > 1024; B3's first design):
// one block of 1024 threads runs every step in one launch;
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
#include "dense_cluster.cuh"

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
// ---------------------------------------------------------------------------
// Route "cluster": B9 in f32 on a cluster of C CTAs
// ---------------------------------------------------------------------------

constexpr int kClusterThreads = 256;
constexpr int kCluster = 16;  // CTAs a cluster: non-portable (> 8)

extern __shared__ __align__(16) float lcl_smem[];  // one CTA's regions

__host__ __device__ inline int up4(int x) { return (x + 3) / 4 * 4; }

// One CTA's shared memory, in floats, for K (M, M), `iters` steps, a
// cluster of C and `budget` bytes: full v (ld = M rounded up to float4s),
// its w slice (rp4 = ceil(M / C) rounded up), the coefficients, two slot
// arrays of iters x C partials and one of C; then the basis slice (iters
// x rp4) when it fits; then as many of its rows of K as fit (`resident`,
// at most ceil(M / C)). `fixed` above `budget`: the call is refused.
struct ClusterLayout {
  int ld, rpc, rp4, resident, q_in_smem;
  size_t fixed, floats;
};

__host__ __device__ inline ClusterLayout lanczos_cluster_layout(
    int M, int iters, int C, size_t budget) {
  ClusterLayout L;
  L.ld = up4(M);
  L.rpc = (M + C - 1) / C;
  L.rp4 = up4(L.rpc);
  L.fixed = (size_t)L.ld + L.rp4 + up4(iters) + 2 * (size_t)up4(iters * C) +
            up4(C);
  const size_t cap = budget / sizeof(float), q = (size_t)iters * L.rp4;
  L.q_in_smem = L.fixed + q <= cap;
  const size_t used = L.fixed + (L.q_in_smem ? q : 0);
  const size_t fit = cap > used ? (cap - used) / L.ld : 0;
  L.resident = fit < (size_t)L.rpc ? (int)fit : L.rpc;
  L.floats = used + (size_t)L.resident * L.ld;
  return L;
}

template <int C>
__global__ void __launch_bounds__(kClusterThreads)
    lanczos_cluster_kernel(const float* K, const float* v0, float* Qout,
                           float* alphas, float* betas, int M, int iters,
                           int resident, int q_in_smem) {
  using namespace ttnx_cluster;
  const int rank = cluster_rank();
  const int ld = up4(M), rpc = (M + C - 1) / C, rp4 = up4(rpc);
  const int row0 = rank * rpc;
  const int rows = M - row0 < rpc ? (M - row0 > 0 ? M - row0 : 0) : rpc;
  const int res = rows < resident ? rows : resident;
  float* v = lcl_smem;               // full length
  float* w = v + ld;                 // this CTA's slice
  float* coef = w + rp4;             // (iters,) summed coefficients
  float* slot1 = coef + up4(iters);  // (iters, C) partials of pass 1
  float* slot2 = slot1 + up4(iters * C);  // (iters, C) pass 2
  float* slot3 = slot2 + up4(iters * C);  // (C,) |w|^2
  float* Qs = slot3 + up4(C);
  float* Ks = Qs + (q_in_smem ? (size_t)iters * rp4 : 0);  // (res, ld)
  float* Q = q_in_smem ? Qs : Qout + row0;  // Q[r][i] at Q + r qld + i
  const size_t qld = q_in_smem ? rp4 : M;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, nw = nt >> 5;
  const float tiny = 1e-12f;

  load_rows(Ks, K, row0, res, M, ld);
  for (int k = tid; k < ld; k += nt) v[k] = k < M ? v0[k] : 0.f;
  copy_wait();
  cluster_sync();  // every CTA runs and holds its rows: DSMEM from here on

  for (int j = 0; j < iters; ++j) {
    float* qj = Q + j * qld;
    for (int i = tid; i < rows; i += nt) qj[i] = v[row0 + i];
    streamed_matvec(K + (size_t)(row0 + res) * M, v, w + res, rows - res,
                    M);
    slice_matvec(Ks, v, w, res, ld);  // w = K v
    __syncthreads();
    for (int r = warp; r <= j; r += nw)
      push_partial<C>(slot1 + r * C, warp_dot(Q + r * qld, w, rows), rank);
    cluster_sync();  // (1)
    const float alpha = cluster_sum<C>(slot1 + j * C);
    if (rank == 0 && tid == 0) alphas[j] = alpha;
    if (j + 1 == iters) break;  // the last beta stays 0
    for (int pass = 0; pass < 2; ++pass) {
      const float* slot = pass ? slot2 : slot1;
      if (pass) {
        for (int r = warp; r <= j; r += nw)
          push_partial<C>(slot2 + r * C, warp_dot(Q + r * qld, w, rows),
                          rank);
        cluster_sync();  // (2)
      }
      for (int r = tid; r <= j; r += nt) coef[r] = cluster_sum<C>(slot + r * C);
      __syncthreads();
      for (int i = tid; i < rows; i += nt) {
        float s = 0.f;
        for (int r = 0; r <= j; ++r) s += coef[r] * Q[r * qld + i];
        w[i] -= s;
      }
      __syncthreads();
    }
    if (warp == 0) push_partial<C>(slot3, warp_dot(w, w, rows), rank);
    for (int e = tid; e < C * rows; e += nt) {
      const int c = e / rows, i = e - c * rows;
      cluster_map(v, c)[row0 + i] = w[i];
    }
    cluster_sync();  // (3) v holds w in every CTA
    const float b = sqrtf(fmaxf(cluster_sum<C>(slot3), 0.f));
    const bool ok = b > tiny;
    if (rank == 0 && tid == 0) betas[j] = ok ? b : 0.f;
    const float scale = fmaxf(b, tiny);
    for (int k = tid; k < M; k += nt) v[k] = ok ? v[k] / scale : 0.f;
    __syncthreads();
  }
  if (rank == 0 && tid == 0) betas[iters - 1] = 0.f;
  if (q_in_smem)
    for (int e = tid; e < iters * rows; e += nt) {
      const int r = e / rows, i = e - r * rows;
      Qout[(size_t)r * M + row0 + i] = Qs[(size_t)r * rp4 + i];
    }
}

// One cluster of C CTAs (ttnx_cluster::launch_cluster; C > 8 as a
// non-portable size) holding as much of K as `budget` bytes of shared
// memory a CTA allow.
template <int C>
int lanczos_cluster(const float* K, const float* v0, float* Q, float* alphas,
                    float* betas, int M, int iters, size_t budget,
                    cudaStream_t st) {
  if (M < 1 || M > ttnx_cluster::kStreamMaxM || iters < 1 ||
      budget > kSmemBlock)
    return (int)cudaErrorInvalidValue;
  const ClusterLayout L = lanczos_cluster_layout(M, iters, C, budget);
  if (L.fixed > budget / sizeof(float)) return (int)cudaErrorInvalidValue;
  static size_t fits = 0;
  return ttnx_cluster::launch_cluster(
      lanczos_cluster_kernel<C>, C, kClusterThreads,
      L.floats * sizeof(float), st, &fits, K, v0, Q, alphas, betas, M, iters,
      L.resident, L.q_in_smem);
}
}  // namespace ttnx_lanczos

using namespace ttnx_lanczos;

extern "C" int ttnx_lanczos_cluster_f32(const void* K, const void* v0,
                                        void* Q, void* alphas, void* betas,
                                        int M, int iters, void* stream) {
  return lanczos_cluster<kCluster>((const float*)K, (const float*)v0,
                                   (float*)Q, (float*)alphas, (float*)betas,
                                   M, iters, kSmemBlock,
                                   (cudaStream_t)stream);
}

#define TTNX_LANCZOS_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* K, const void* v0, void* Q, void* alphas,  \
                      void* betas, int M, int iters, void* stream) {         \
    return lanczos<T>((const T*)K, (const T*)v0, (T*)Q, (T*)alphas,          \
                      (T*)betas, M, iters, (cudaStream_t)stream);            \
  }

TTNX_LANCZOS_ENTRY(ttnx_lanczos_f32, float)
TTNX_LANCZOS_ENTRY(ttnx_lanczos_f64, double)
