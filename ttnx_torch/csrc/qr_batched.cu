// The batched gauge QR of the batched ALS: the thin Householder QR of a
// batch of small matrices, the whole batch in one launch.
//
// Replaces no TPU kernel: ttnx (ttnx/solvers/als_scan_batched.py) leaves
// the gauge QR to XLA's batched jnp.linalg.qr. It was added because on the
// card torch.linalg.qr factors a batch with cuBLAS's geqrfBatched but forms
// Q with cuSOLVER's orgqr one matrix at a time (larft, four GEMM kernels,
// splitKreduce, lacpy and batch_eye a matrix), so the host launched about
// 110,000 tiny kernels a call of the batched ALS at B = 512.
//
// Matrices: m rows and k columns, 1 <= k <= m <= 128 (the batched ALS sends
// m = R n, k = R). rows = 0 factors a contiguous (B, m, k) stack and writes
// Q (B, m, k) and R (B, k, k); rows = 1 takes the contiguous (B, k, m)
// stack, factors the transpose of each matrix (an LQ of the matrix as
// stored, with no transpose copy) and writes Q^T (B, k, m) and R^T
// (B, k, k). R has zeros below the diagonal (R^T above).
//
// Convention, LAPACK's xgeqr2 / xorg2r with xlarfg's rules: the reflector
// of column j has beta = -sign(alpha) ||(alpha, x)|| (sign(+-0) = +, as
// MKL's), tau = (beta - alpha) / beta and v = x / (alpha - beta); tau = 0
// and the column is left as it is when x, the part below the diagonal, is
// exactly zero. Q is formed backwards in xorg2r's order. So the factors
// equal LAPACK's to rounding, column by column, also on the zero rows and
// columns that the ALS rank masks leave.
//
// What bounds it on the H100, at the batched ALS's shape (B = 512, m = 128,
// k = 64, f32): bytes, read 16.8 MB and written 25.2 MB, 12.5 us at 3.35
// TB/s; operations, about 1.75 MFLOP a matrix (geqrf and orgqr, 2 m k^2 -
// 2 k^3 / 3 each), 0.90 GFLOP in all, 13.4 us at 67 TFLOP/s. Neither binds:
// a matrix is 2 k strictly sequential column steps, each a warp reduction
// and a block barrier, so the kernel is latency bound and relies on many
// resident CTAs.
//
// Design: one CTA of 256 threads a matrix, the matrix resident in shared
// memory column-major (column c at c * ld; ld = m | 1 for rows = 0, so the
// transposing load and store hit distinct banks, ld = m for rows = 1,
// where they are straight copies), tau beside it: 33 KB at 128 x 64 f32,
// six CTAs an SM. Lane l of a warp holds rows l, l + 32, l + 64, l + 96 of
// one column in registers. Factor: at step j every warp takes trailing
// columns j + 1 + warp + 8 t, forms v^T a by a butterfly sum (the same
// bits in every lane) and updates a -= tau (v^T a) v with FMAs; the warp
// that owns column j + 1 then builds that column's reflector from its
// registers, so one barrier a step suffices. A step with tau_j = 0 (the
// masks' dead columns) only builds the next reflector. R is written, then
// Q is formed in place over the reflectors (the owner of column j + 1
// turns it into Q's column before applying H_j), and written. The input is
// read once and Q and R written once, in coalesced 16-byte accesses where
// the inner size and the pointers allow (the ALS shapes do), else in
// coalesced 4- or 8-byte ones. IEEE FMAs throughout, no TF32; the launch
// never synchronizes and reads nothing back.
#include <cstdint>

#include <cuda_runtime.h>

namespace ttnx_qr {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;
constexpr int kLaneRows = kMaxRows / 32;  // rows of a column a lane holds
constexpr unsigned kFull = 0xffffffffu;

extern __shared__ __align__(16) unsigned char qr_smem[];

// The squared norm is taken unscaled when it lies in [tiny, huge]: no
// square that underflowed can matter there (tiny = smallest normal / eps^2)
// and none overflowed. Otherwise (exact zeros too) it is taken again with
// the largest entry scaled to one.
template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static constexpr float tiny = 1.17549435e-38f / (1.1920929e-07f *
                                                   1.1920929e-07f);
  static constexpr float huge = 3.40282347e+38f;
};
template <>
struct Limits<double> {
  static constexpr double tiny =
      2.2250738585072014e-308 / (2.220446049250313e-16 *
                                 2.220446049250313e-16);
  static constexpr double huge = 1.7976931348623157e+308;
};

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Rows [lo, m) of column c into a (zeros elsewhere), and back.
template <typename T>
__device__ __forceinline__ void load_col(T (&a)[kLaneRows], const T* col,
                                         int lo, int m, int lane) {
#pragma unroll
  for (int t = 0; t < kLaneRows; ++t) {
    const int i = lane + 32 * t;
    a[t] = (i >= lo && i < m) ? col[i] : T(0);
  }
}
template <typename T>
__device__ __forceinline__ void store_col(const T (&a)[kLaneRows], T* col,
                                          int lo, int m, int lane) {
#pragma unroll
  for (int t = 0; t < kLaneRows; ++t) {
    const int i = lane + 32 * t;
    if (i >= lo && i < m) col[i] = a[t];
  }
}

// The reflector of v_p = (1 at row p, the stored v below it, 0 above).
template <typename T>
__device__ __forceinline__ void load_v(T (&v)[kLaneRows], const T* col,
                                       int p, int m, int lane) {
#pragma unroll
  for (int t = 0; t < kLaneRows; ++t) {
    const int i = lane + 32 * t;
    v[t] = (i > p && i < m) ? col[i] : (i == p ? T(1) : T(0));
  }
}

// a := (I - tau v v^T) a, one column held by the warp; rows where v is 0
// are left as they are.
template <typename T>
__device__ __forceinline__ void apply(T (&a)[kLaneRows],
                                      const T (&v)[kLaneRows], T tau) {
  T s = T(0);
#pragma unroll
  for (int t = 0; t < kLaneRows; ++t) s = fma(v[t], a[t], s);
  const T f = -tau * warp_sum(s);
#pragma unroll
  for (int t = 0; t < kLaneRows; ++t) a[t] = fma(f, v[t], a[t]);
}

// xlarfg on (alpha = a[row p], x = a[rows p+1 .. m-1]) of a column held by
// the warp: overwrites a with beta at row p and v below it, returns tau
// (the same value in every lane).
template <typename T>
__device__ T reflector(T (&a)[kLaneRows], int p, int m, int lane) {
  T ssq = T(0), alpha = T(0);
#pragma unroll
  for (int t = 0; t < kLaneRows; ++t) {
    const int i = lane + 32 * t;
    if (i > p && i < m) ssq = fma(a[t], a[t], ssq);
    if (i == p) alpha = a[t];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {  // one exact nonzero term in alpha
    ssq += __shfl_xor_sync(kFull, ssq, o);
    alpha += __shfl_xor_sync(kFull, alpha, o);
  }
  T xnorm;
  if (ssq >= Limits<T>::tiny && ssq <= Limits<T>::huge) {
    xnorm = sqrt(ssq);
  } else {
    T amax = T(0);
#pragma unroll
    for (int t = 0; t < kLaneRows; ++t) {
      const int i = lane + 32 * t;
      if (i > p && i < m) amax = fmax(amax, fabs(a[t]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmax(amax, __shfl_xor_sync(kFull, amax, o));
    if (amax == T(0)) return T(0);  // x == 0: H = I, the column stays
    const T inv = T(1) / amax;
    T s = T(0);
#pragma unroll
    for (int t = 0; t < kLaneRows; ++t) {
      const int i = lane + 32 * t;
      const T y = (i > p && i < m) ? a[t] * inv : T(0);
      s = fma(y, y, s);
    }
    xnorm = amax * sqrt(warp_sum(s));
  }
  const T norm = hypot(alpha, xnorm);
  const T beta = alpha < T(0) ? norm : -norm;
  const T tau = (beta - alpha) / beta;
  const T scal = T(1) / (alpha - beta);
#pragma unroll
  for (int t = 0; t < kLaneRows; ++t) {
    const int i = lane + 32 * t;
    if (i > p && i < m) a[t] *= scal;
    if (i == p) a[t] = beta;
  }
  return tau;
}

// Element (i, c) of the matrix factored lies at flat index i * k + c of its
// (m, k) block for rows = 0 and at c * m + i of its (k, m) block for rows =
// 1; Q (or Q^T) takes the input's layout. Copies chunks of V elements along
// the block's inner size, between the block and the column-major tile.
template <int V, typename T>
__device__ void copy_tile(const T* src, T* dst, T* A, int m, int k, int ld,
                          int rows, bool in) {
  const int inner = rows ? m : k;
  const int step = rows ? 1 : ld;  // tile stride along the inner size
  for (int e = threadIdx.x * V; e < m * k; e += kThreads * V) {
    const int o = e / inner, r = e % inner;
    T* a = A + (rows ? (size_t)o * ld + r : (size_t)r * ld + o);
    T v[V];
    if (in) {
      if constexpr (V * sizeof(T) == 16) {
        load16(src + e, v);
      } else {
#pragma unroll
        for (int s = 0; s < V; ++s) v[s] = src[e + s];
      }
#pragma unroll
      for (int s = 0; s < V; ++s) a[s * step] = v[s];
    } else {
#pragma unroll
      for (int s = 0; s < V; ++s) v[s] = a[s * step];
      if constexpr (V * sizeof(T) == 16) {
        store16(dst + e, v);
      } else {
#pragma unroll
        for (int s = 0; s < V; ++s) dst[e + s] = v[s];
      }
    }
  }
}

// R (rows = 0) or R^T (rows = 1) as a dense (k, k) block.
template <int V, typename T>
__device__ void store_r(T* dst, const T* A, int k, int ld, int rows) {
  for (int e = threadIdx.x * V; e < k * k; e += kThreads * V) {
    const int a = e / k, b0 = e % k;
    T v[V];
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const int b = b0 + s;
      v[s] = rows ? (b <= a ? A[(size_t)a * ld + b] : T(0))
                  : (a <= b ? A[(size_t)b * ld + a] : T(0));
    }
    if constexpr (V * sizeof(T) == 16) {
      store16(dst + e, v);
    } else {
#pragma unroll
      for (int s = 0; s < V; ++s) dst[e + s] = v[s];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    qr_kernel(const T* __restrict__ in, T* __restrict__ qout,
              T* __restrict__ rout, int m, int k, int ld, int rows,
              int vec) {
  constexpr int V = 16 / sizeof(T);
  T* A = reinterpret_cast<T*>(qr_smem);  // column c at A + c * ld
  T* tau = A + (size_t)ld * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t mat = (size_t)blockIdx.x * m * k;

  if (vec)
    copy_tile<V, T>(in + mat, nullptr, A, m, k, ld, rows, true);
  else
    copy_tile<1, T>(in + mat, nullptr, A, m, k, ld, rows, true);
  __syncthreads();

  // factor: H_{k-1} ... H_0 A = R
  if (warp == 0) {
    T a[kLaneRows];
    load_col(a, A, 0, m, lane);
    const T t0 = reflector(a, 0, m, lane);
    store_col(a, A, 0, m, lane);
    if (lane == 0) tau[0] = t0;
  }
  __syncthreads();
  for (int j = 0; j + 1 < k; ++j) {
    const T tj = tau[j];
    T v[kLaneRows];
    load_v(v, A + (size_t)j * ld, j, m, lane);
    for (int c = j + 1 + warp; c < k; c += kWarps) {
      const bool next = c == j + 1;
      if (tj == T(0) && !next) continue;
      T a[kLaneRows];
      T* col = A + (size_t)c * ld;
      load_col(a, col, j, m, lane);
      if (tj != T(0)) apply(a, v, tj);
      if (next) {
        const T tn = reflector(a, j + 1, m, lane);
        if (lane == 0) tau[j + 1] = tn;
      }
      store_col(a, col, j, m, lane);
    }
    __syncthreads();
  }

  T* rdst = rout + (size_t)blockIdx.x * k * k;
  if (vec)
    store_r<V, T>(rdst, A, k, ld, rows);
  else
    store_r<1, T>(rdst, A, k, ld, rows);
  __syncthreads();

  // form Q = H_0 ... H_{k-1} I[:, :k] in place, backwards (xorg2r)
  for (int j = k - 2; j >= 0; --j) {
    const T tj = tau[j], tn = tau[j + 1];
    T v[kLaneRows];
    load_v(v, A + (size_t)j * ld, j, m, lane);
    for (int c = j + 1 + warp; c < k; c += kWarps) {
      const bool next = c == j + 1;
      if (tj == T(0) && !next) continue;
      T a[kLaneRows];
      T* col = A + (size_t)c * ld;
      if (next) {  // reflector j + 1 into Q's column: H_{j+1} e_{j+1}
#pragma unroll
        for (int t = 0; t < kLaneRows; ++t) {
          const int i = lane + 32 * t;
          a[t] = (i > c && i < m) ? col[i] * -tn
                                  : (i == c ? T(1) - tn : T(0));
        }
      } else {
        load_col(a, col, j, m, lane);
      }
      if (tj != T(0)) apply(a, v, tj);
      store_col(a, col, next ? 0 : j, m, lane);
    }
    __syncthreads();
  }
  if (warp == 0) {
    const T t0 = tau[0];
#pragma unroll
    for (int t = 0; t < kLaneRows; ++t) {
      const int i = lane + 32 * t;
      if (i < m) A[i] = i == 0 ? T(1) - t0 : A[i] * -t0;
    }
  }
  __syncthreads();

  if (vec)
    copy_tile<V, T>(nullptr, qout + mat, A, m, k, ld, rows, false);
  else
    copy_tile<1, T>(nullptr, qout + mat, A, m, k, ld, rows, false);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int qr_batched(const T* in, T* q, T* r, int B, int m, int k, int rows,
               cudaStream_t s) {
  if (B < 1 || k < 1 || k > m || m > kMaxRows) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  const int ld = rows ? m : (m | 1);
  const size_t smem = ((size_t)ld * k + k) * sizeof(T);
  const int vec = (rows ? m : k) % V == 0 && k % V == 0 && aligned16(in) &&
                  aligned16(q) && aligned16(r);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  qr_kernel<T><<<B, kThreads, smem, s>>>(in, q, r, m, k, ld, rows, vec);
  return cudaGetLastError();
}

}  // namespace ttnx_qr

extern "C" int ttnx_qr_batched_f32(const void* in, void* q, void* r, int B,
                                   int m, int k, int rows, void* stream) {
  return ttnx_qr::qr_batched<float>((const float*)in, (float*)q, (float*)r,
                                    B, m, k, rows, (cudaStream_t)stream);
}

extern "C" int ttnx_qr_batched_f64(const void* in, void* q, void* r, int B,
                                   int m, int k, int rows, void* stream) {
  return ttnx_qr::qr_batched<double>((const double*)in, (double*)q,
                                     (double*)r, B, m, k, rows,
                                     (cudaStream_t)stream);
}
