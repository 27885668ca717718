// Kernels B4 and B5, resident route: matrix-free fixed-iteration CG for the
// ALS local solve, f32, at compile-time shapes (R, n, RA), for a batch of
// B problems with a shared MPO core and mask (B5; B4 is the grid of one).
//
// Replaces ttnx/kernels/local_cg_mf.py, cg_matfree_fused_batched
// (_kernel_batched, pallas_call at :225) and cg_matfree_fused (_kernel,
// pallas_call at :260), as csrc/local_cg_mf.cu does for f64 and every
// other shape. Local operator, for any mask (R, n, R):
//   K v[a,i,c] = sum L[a,W,b] Ac[W,i,J,w] Renv[c,w,d] (v*mask)[b,J,d]
//   apply(v)   = (K v) * mask + (1 - mask) * v
// CG on rhs * mask from x0 * mask (warm) or 0, returns x * mask.
//
// What bounds it on the H100: an apply is 8.9 MFLOP at R = 64 (p Renv^T
// and the L product, 4.2 MFLOP each, and the mix), and the 17 applies of a
// warm 16-iteration solve are strictly sequential, so one problem is bound
// by one SM's f32 FMA rate (507 GFLOP/s at 1.98 GHz: 0.30 ms a solve) and
// a batch by FMA work over 132 SMs. PR 1's kernel (csrc/local_cg_mf.cu)
// read every operand of every apply from L2 through accessors with runtime
// index arithmetic and wrote its intermediates to device memory: 0.145 ms
// a CG iteration at R = 64. This kernel takes 0.064 ms (27.6 % of the
// SM's rate, as B7's apply on the same engine; 0.256 a slot at B = 512,
// four waves), measured by scripts/probe_torch_matfree.py.
//
// Design: B7's site engine (site_engine.cuh), one 512-thread block a
// problem (grid = B), every product on the CUDA cores in IEEE f32 FMA:
//   * L (as [a][(W,b)], its own layout) and Renv (transposed as staged, to
//     [d][(w,c)]) are loaded into shared memory once a launch and stay
//     there for the whole solve, beside the MPO core and the block sums.
//   * The apply streams over 16-wide column slabs c: slab_mix forms the
//     slab of s = mix(A, (p mask) Renv^T) with the MPO mix in registers,
//     then the L product of the same slab runs from shared memory and its
//     epilogue applies out * mask + (1 - mask) p for the owned values.
//   * The apply's input p * mask lives in shared memory (P); x (in the
//     output), r, p and K p live in device memory (L2), each value touched
//     only by the thread that owns it in the L product's epilogue. The
//     mask (shared by every problem) is read from L2, where it stays, at
//     the two points the plain version applies it: as p * mask is staged,
//     and in the epilogue, whose loads are issued before the L product.
//   * p . K p is summed in the apply's epilogue; block sums are warp
//     shuffles and one shared-memory exchange (one barrier).
//
// Shared memory at R = 64, n = 2, RA = 4 (floats; padded rows keep the
// 16-byte loads of one warp on distinct banks), as B7's site kernel:
//   Renv^T [d][(w,c)]  64 x 260   16,640   66,560 B
//   L      [a][(W,b)]  64 x 260   16,640   66,560 B
//   p*mask [(b,J)][d] 128 x  68    8,704   34,816 B
//   s slab [(W,b)][(i,c)] 256 x 36 9,216   36,864 B
//   A, block sums                    128      512 B
//   total                         51,328  205,312 B  (of 232,448)
// At R = 32 the same regions take 61,952 B.
#include "site_engine.cuh"

namespace ttnx_cg_site {
using namespace ttnx_site;

extern __shared__ __align__(16) float cg_smem[];  // one problem's regions

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// One problem's solve: shapes, shared-memory regions and phases, each
// called by the whole block.
template <int R, int N, int RA>
struct Solve {
  static_assert(N == 2 && RA == 4 && (R == 32 || R == 64),
                "instantiated for (R, n, RA) = (64, 2, 4) and (32, 2, 4)");
  static constexpr int NR = N * R, V = R * NR, E = R * RA * R;
  static constexpr int LGR = R == 64 ? 6 : 5;
  static constexpr int LDP = R + 4;       // P [(b,J)][d]
  static constexpr int LDR = RA * R + 4;  // [d][(w,c)] and [a][(W,b)]
  static constexpr int LDS = N * CS + 4;  // slab [(W,b)][(i,c)]
  static constexpr int SLABS = R / CS;
  static constexpr int OWNERS = 8 * R;  // threads of the apply's tiles
  static constexpr int NCOEF = RA * N * N * RA;
  static constexpr int OFF_L = R * LDR, OFF_P = 2 * R * LDR,
                       OFF_S = OFF_P + NR * LDP,
                       OFF_A = OFF_S + RA * R * LDS, OFF_RED = OFF_A + NCOEF,
                       SMEM = OFF_RED + 64;  // floats

  // the shared-memory regions: constant offsets into the dynamic array
  __device__ static float* RT() { return cg_smem; }
  __device__ static float* Lr() { return cg_smem + OFF_L; }
  __device__ static float* P() { return cg_smem + OFF_P; }
  __device__ static float* S() { return cg_smem + OFF_S; }
  __device__ static float* Ac() { return cg_smem + OFF_A; }
  __device__ static float* red() { return cg_smem + OFF_RED; }
  int flip;
  const float* mask;
  float *x, *q;  // the iterate (in the output) and the scratch: r, p, K p
  __device__ float* r() const { return q; }
  __device__ float* p() const { return q + V; }
  __device__ float* ap() const { return q + 2 * V; }

  // ---- staging, once a launch (no barrier) ----
  // RT [d][(w,c)] = Renv[c][w][d]
  __device__ static void stage_renv(const float* src) {
    for (int e = threadIdx.x; e < E / 4; e += kThreads) {
      const int cw = e >> (LGR - 2), d = (e & (R / 4 - 1)) * 4;
      float* dst = RT() + d * LDR + (cw % RA) * R + cw / RA;
      const float4 v = ld4(src + 4 * e);
      dst[0] = v.x;
      dst[LDR] = v.y;
      dst[2 * LDR] = v.z;
      dst[3 * LDR] = v.w;
    }
  }
  // Lr [a][(W,b)] = L[a][W][b]
  __device__ static void stage_l(const float* src) {
    constexpr int ROW4 = RA * R / 4;
    for (int e = threadIdx.x; e < E / 4; e += kThreads)
      st4(Lr() + (e / ROW4) * LDR + (e % ROW4) * 4, ld4(src + 4 * e));
  }
  __device__ static void stage_coef(const float* A) {
    for (int e = threadIdx.x; e < NCOEF; e += kThreads) Ac()[e] = A[e];
  }

  // the owned values of apply(): row (a, i) of the vector, first column
  // (then + 16 sl for slab sl)
  __device__ static int own_row() {
    const int tid = threadIdx.x, pos = tid >> 3;
    return ((pos >> 3) * 8 + (tid & 7)) * N + ((pos & 7) >> 2);
  }
  __device__ static int own_col() { return ((threadIdx.x >> 3) & 3) * 4; }

  // ap = K (v * mask) * mask + (1 - mask) v for v * mask in P and v in
  // device memory; returns the owned part of v . ap (0 in non-owners)
  __device__ float apply(const float* v) const {
    const int tid = threadIdx.x, g = tid & 7, pos = tid >> 3;
    const int nt = pos & 7, m0 = (pos >> 3) * 8;
    const int own = own_row() * R + own_col();
    float vap = 0.f;
#pragma unroll 1
    for (int sl = 0; sl < SLABS; ++sl) {
      slab_mix<R, N, RA, LDP, LDR, LDS>(P(), RT(), Ac(), S(), sl);
      __syncthreads();
      if (tid < OWNERS) {
        // issued before the product, whose time hides their L2 latency
        const int o = own + sl * CS;
        const float4 mk = ld4(mask + o), vv = ld4(v + o);
        float acc[8][4] = {};
        mma_chunks<8, 8, RA * R, false, false>(
            acc, m0, nt * 4, g,
            [&](int m, int k) { return Lr() + m * LDR + k; },
            [&](int n, int k) { return S() + k * LDS + n; });
        reduce_scatter<8, 8>(acc, g);
        const float4 out = make_float4(acc[0][0] * mk.x + (1.f - mk.x) * vv.x,
                                       acc[0][1] * mk.y + (1.f - mk.y) * vv.y,
                                       acc[0][2] * mk.z + (1.f - mk.z) * vv.z,
                                       acc[0][3] * mk.w + (1.f - mk.w) * vv.w);
        st4(ap() + o, out);
        vap += dot4(vv, out);
      }
      __syncthreads();
    }
    return vap;
  }

  // P (owned values) = v * mask
  __device__ void stage_p(int row, int col, int sl, float4 v) const {
    st4(P() + row * LDP + sl * CS + col,
        mul4(v, ld4(mask + row * R + sl * CS + col)));
  }

  // fixed-iteration CG; the result, masked, in x
  __device__ void solve(const float* rhs, const float* x0, int iters,
                        bool warm) {
    const int row = own_row(), col = own_col();
    const bool own = threadIdx.x < OWNERS;
    if (warm) {
      if (own) {
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl) {
          const int o = row * R + sl * CS + col;
          const float4 xv = mul4(ld4(x0 + o), ld4(mask + o));
          st4(x + o, xv);
          stage_p(row, col, sl, xv);
        }
      }
      __syncthreads();
      apply(x);
    }
    float loc = 0.f;
    if (own) {
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl) {
        const int o = row * R + sl * CS + col;
        float4 ri = mul4(ld4(rhs + o), ld4(mask + o));
        if (warm) {
          const float4 h = ld4(ap() + o);
          ri = make_float4(ri.x - h.x, ri.y - h.y, ri.z - h.z, ri.w - h.w);
        } else {
          st4(x + o, make_float4(0.f, 0.f, 0.f, 0.f));
        }
        st4(r() + o, ri);
        st4(p() + o, ri);
        stage_p(row, col, sl, ri);
        loc += dot4(ri, ri);
      }
    }
    // its barrier also publishes P and the staged operators
    float rs = block_sum(loc, red(), flip);
    for (int it = 0; it < iters; ++it) {
      const float denom = block_sum(apply(p()), red(), flip);
      const float alpha = fabsf(denom) > 0.f ? rs / denom : 0.f;
      loc = 0.f;
      if (own) {
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl) {
          const int o = row * R + sl * CS + col;
          st4(x + o, axpy4(alpha, ld4(p() + o), ld4(x + o)));
          const float4 ri = axpy4(-alpha, ld4(ap() + o), ld4(r() + o));
          st4(r() + o, ri);
          loc += dot4(ri, ri);
        }
      }
      const float rs_new = block_sum(loc, red(), flip);
      const float beta = fabsf(rs) > 0.f ? rs_new / rs : 0.f;
      if (own) {
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl) {
          const int o = row * R + sl * CS + col;
          const float4 pv = axpy4(beta, ld4(p() + o), ld4(r() + o));
          st4(p() + o, pv);
          stage_p(row, col, sl, pv);
        }
      }
      rs = rs_new;
      __syncthreads();
    }
    if (own) {
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl) {
        const int o = row * R + sl * CS + col;
        st4(x + o, mul4(ld4(x + o), ld4(mask + o)));
      }
    }
  }
};

// Block blockIdx.x solves problem blockIdx.x: L, Renv (R, RA, R), rhs, x0,
// out (R, n, R) and 3 V of scratch advance by one problem per block; Ac
// and mask are shared.
template <int R, int N, int RA>
__global__ void __launch_bounds__(kThreads, 1)
    cg_site_kernel(const float* L, const float* Ac, const float* Renv,
                   const float* rhs, const float* mask, const float* x0,
                   float* out, float* scratch, int iters, int warm) {
  using Sv = Solve<R, N, RA>;
  constexpr int V = Sv::V, E = Sv::E;
  const size_t bb = blockIdx.x;
  Sv s;
  s.flip = 0;
  s.mask = mask;
  s.x = out + bb * V;
  s.q = scratch + bb * 3 * V;
  Sv::stage_renv(Renv + bb * E);
  Sv::stage_l(L + bb * E);
  Sv::stage_coef(Ac);
  s.solve(rhs + bb * V, x0 + bb * V, iters, warm != 0);
}

template <int R, int N, int RA>
int launch(const float* L, const float* Ac, const float* Renv,
           const float* rhs, const float* mask, const float* x0, float* out,
           float* scratch, int B, int iters, int warm, cudaStream_t st) {
  auto kernel = cg_site_kernel<R, N, RA>;
  const size_t smem = Solve<R, N, RA>::SMEM * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, st>>>(L, Ac, Renv, rhs, mask, x0, out, scratch,
                                    iters, warm);
  return (int)cudaGetLastError();
}
}  // namespace ttnx_cg_site

// The arguments of ttnx_cg_matfree_batched_f32, with a scratch of 3 R n R
// elements a problem; shapes other than (R, n, RA) = (64, 2, 4) and
// (32, 2, 4) are refused.
extern "C" int ttnx_cg_matfree_site_f32(const void* L, const void* Ac,
                                        const void* Renv, const void* rhs,
                                        const void* mask, const void* x0,
                                        void* out, void* scratch, int B, int R,
                                        int RA, int n, int iters, int warm,
                                        void* stream) {
  if (n != 2 || RA != 4) return (int)cudaErrorInvalidValue;
  const auto* l = (const float*)L;
  const auto* a = (const float*)Ac;
  const auto* re = (const float*)Renv;
  const auto* h = (const float*)rhs;
  const auto* m = (const float*)mask;
  const auto* x = (const float*)x0;
  auto* o = (float*)out;
  auto* sc = (float*)scratch;
  auto st = (cudaStream_t)stream;
  if (R == 64)
    return ttnx_cg_site::launch<64, 2, 4>(l, a, re, h, m, x, o, sc, B, iters,
                                          warm, st);
  if (R == 32)
    return ttnx_cg_site::launch<32, 2, 4>(l, a, re, h, m, x, o, sc, B, iters,
                                          warm, st);
  return (int)cudaErrorInvalidValue;
}
