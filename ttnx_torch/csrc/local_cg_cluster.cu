// Kernel B4, route cluster: the matrix-free fixed-iteration CG of ONE ALS
// local solve, f32, at (R, n, RA) = (64, 2, 4) and (32, 2, 4), on one
// thread-block cluster of C = R / 4 CTAs (16 at R = 64, a non-portable
// size; 8 at R = 32).
//
// Replaces ttnx/kernels/local_cg_mf.py, cg_matfree_fused (_kernel,
// pallas_call at :260) for one problem; a batch (B5) keeps route resident
// (csrc/local_cg_site.cu), one block a problem, which fills the card. The
// same operator, for any mask (R, n, R):
//   K v[a,i,c] = sum L[a,W,b] Ac[W,i,J,w] Renv[c,w,d] (v*mask)[b,J,d]
//   apply(v)   = (K v) * mask + (1 - mask) * v
// CG on rhs * mask from x0 * mask (warm) or 0, returns x * mask, with the
// resident route's arithmetic: IEEE f32 FMA (no TF32), the same updates
// and the same number of iterations.
//
// What bounds it on the H100: an apply is 8.9 MFLOP at R = 64 and the 17
// applies of a warm 16-iteration solve are strictly sequential. On one SM
// (route resident) a solve takes 1.09 ms, 27.6 % of that SM's FMA rate.
// Output column c of K v needs only Renv[c, :, :], the whole L and the
// whole of v * mask, so the apply splits by columns with no shared sum:
// CTA `rank` owns c in [4 rank, 4 rank + 4) and computes
//   T[(b,J)][(cl,w)] = sum_d P[(b,J)][d] RT[(cl,w)][d]       (product 1)
//   S[(i,cl)][(W,b)] = sum_{J,w} A[W,i,J,w] T[(b,J)][(cl,w)] (the mix)
//   Kv[a][(i,cl)]    = sum_{(W,b)} L[a][(W,b)] S[(i,cl)][(W,b)]
// for its columns alone: a 16th of the FMA work a CTA at R = 64. This
// kernel takes 0.132-0.138 ms a solve at R = 64 (7.3 us a CG iteration,
// 8.3x route resident on the same inputs) and 0.075-0.078 ms at R = 32
// (resident 0.20), measured by scripts/probe_torch_matfree.py and
// chip_smoke.py phase 3; below about 0.35 ms the CN step's ALS sweep is
// paced by the host's issue of a site, not by this kernel.
//
// Design, on the site engine (site_engine.cuh) and the cluster engine
// (dense_cluster.cuh):
//   * L (as [a][(W,b)]), the CTA's four columns of Renv (as [(cl,w)][d])
//     and the MPO core are staged into shared memory once a launch.
//   * P = v * mask (as [(b,J)][d]) is whole in every CTA. A CTA updates its
//     own columns of P and pushes them into every partner's P through
//     distributed shared memory (16-byte stores), as B2's cluster does.
//   * Every owned value of x, r, p, K p and the mask lives in a register
//     of the thread that computes it in product 3's epilogue (one value a
//     thread at R = 64): no device-memory traffic inside the iterations.
//   * Product 1 is the engine's 8 x 4 register tile with 8 lanes over d,
//     whose reduce-scatter leaves lanes g and g ^ 1 the two J rows of one
//     (b, cl); one shuffle gives each both, and the mix runs in registers
//     (lane parity = i). Product 3 is one 8 x 4 tile a warp with its 32
//     lanes over (W,b), summed to one value a lane.
//   * The two inner products of an iteration are a block sum a CTA, pushed
//     into a slot array of every CTA and summed there in rank order after
//     the cluster barrier: every CTA holds the same alpha and beta bits and
//     two launches give the same result. Three cluster barriers an
//     iteration (p . K p, r . r, the push of P), two in the last.
//
// Shared memory at R = 64 (floats; padded rows keep a warp's 16-byte loads
// on distinct banks):
//   L        [a][(W,b)]      64 x 260   16,640   66,560 B
//   P        [(b,J)][d]     128 x  68    8,704   34,816 B
//   RT       [(cl,w)][d]     16 x  68    1,088    4,352 B
//   S        [(i,cl)][(W,b)]  8 x 260    2,080    8,320 B
//   A, block sums, slots                   192      768 B
//   total                               28,704  114,816 B  (of 232,448)
// At R = 32 the same regions take 33,408 B.
#include "dense_cluster.cuh"
#include "site_engine.cuh"

namespace ttnx_cg_cluster {
using namespace ttnx_site;
using ttnx_cluster::cluster_map;

extern __shared__ __align__(16) float cgc_smem[];  // one CTA's regions

template <int R>
struct Solve {
  static_assert(R == 32 || R == 64, "instantiated for R = 64 and 32");
  static constexpr int N = 2, RA = 4, CW = 4, C = R / CW;
  static constexpr int E = R * RA * R, NCOEF = RA * N * N * RA;
  static constexpr int OWNERS = N * CW * R;  // threads of the tiles
  static constexpr int LDR = RA * R + 4;     // L and S
  static constexpr int LDP = R + 4;          // P and RT
  static constexpr int OFF_P = R * LDR, OFF_T = OFF_P + N * R * LDP,
                       OFF_S = OFF_T + CW * RA * LDP,
                       OFF_A = OFF_S + N * CW * LDR, OFF_RED = OFF_A + NCOEF,
                       OFF_SLOT = OFF_RED + 64, SMEM = OFF_SLOT + 64;  // floats
  static_assert(OWNERS <= kThreads && 2 * C <= 64, "one block, two slot rows");

  __device__ static float* Lr() { return cgc_smem; }
  __device__ static float* P() { return cgc_smem + OFF_P; }
  __device__ static float* RT() { return cgc_smem + OFF_T; }
  __device__ static float* S() { return cgc_smem + OFF_S; }
  __device__ static float* Ac() { return cgc_smem + OFF_A; }
  __device__ static float* red() { return cgc_smem + OFF_RED; }
  __device__ static float* slots() { return cgc_smem + OFF_SLOT; }

  int rank, c0, flip, sflip;

  // ---- staging, once a launch (no barrier) ----
  __device__ void stage(const float* L, const float* Ac_, const float* Renv)
      const {
    constexpr int ROW4 = RA * R / 4, D4 = R / 4;
    for (int e = threadIdx.x; e < E / 4; e += kThreads)
      st4(Lr() + (e / ROW4) * LDR + (e % ROW4) * 4, ld4(L + 4 * e));
    // RT [(cl,w)][d] = Renv[c0 + cl][w][d]: consecutive rows of Renv
    const float* src = Renv + (size_t)c0 * RA * R;
    for (int e = threadIdx.x; e < CW * RA * D4; e += kThreads)
      st4(RT() + (e / D4) * LDP + (e % D4) * 4, ld4(src + 4 * e));
    for (int e = threadIdx.x; e < NCOEF; e += kThreads) Ac()[e] = Ac_[e];
  }

  // the owned value of thread tid < OWNERS: warp w, lane l of product 3
  // keeps row a = 8 (w / 2) + l / 4, column (i, cl) = (w % 2, l % 4)
  __device__ static int own_a() { return (threadIdx.x >> 6) * 8 +
                                         ((threadIdx.x & 31) >> 2); }
  __device__ static int own_i() { return (threadIdx.x >> 5) & 1; }
  __device__ int own_c() const { return c0 + (threadIdx.x & 3); }

  // Sums the 8 x 4 tiles of a warp's 32 lanes, each a partial over its own
  // k: lane l keeps element (l / 4, l % 4) of the sum.
  __device__ static float warp_tile_sum(float (&acc)[8][4], int lane) {
    int row = 0;
    rs_step<8, 8, 16>(acc, lane, row);  // rows 8 -> 1 over lane bits 4..2
    const bool up2 = (lane & 2) != 0, up1 = (lane & 1) != 0;
    float h[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float lo = acc[0][c], hi = acc[0][c + 2];
      h[c] = (up2 ? hi : lo) + __shfl_xor_sync(kFull, up2 ? lo : hi, 2);
    }
    return (up1 ? h[1] : h[0]) + __shfl_xor_sync(kFull, up1 ? h[0] : h[1], 1);
  }

  // (K (v * mask)) at the owned value (0 in other threads), for v * mask
  // whole in P. Starts after a barrier that published P; one barrier.
  __device__ float apply() const {
    const int tid = threadIdx.x;
    if (tid < OWNERS) {
      // product 1 and the mix: tile (rows m0.., columns (cl, w = 0..3))
      const int g = tid & 7, pos = tid >> 3;
      const int m0 = (pos >> 2) * 8, cl = pos & 3;
      float acc[8][4] = {};
      mma_chunks<8, 8, R, false, true>(
          acc, m0, cl * 4, g, [&](int m, int k) { return P() + m * LDP + k; },
          [&](int n, int k) { return RT() + n * LDP + k; });
      reduce_scatter<8, 8>(acc, g);  // lane g: row m0 + g = (b, J = g & 1)
      const bool odd = (g & 1) != 0;
      float t[2][RA];  // t[J][w] of (b, cl), in both lanes of the pair
#pragma unroll
      for (int w = 0; w < RA; ++w) {
        const float mine = acc[0][w];
        const float other = __shfl_xor_sync(kFull, mine, 1);
        t[0][w] = odd ? other : mine;
        t[1][w] = odd ? mine : other;
      }
      const int b = (m0 + g) >> 1, i = odd ? 1 : 0;
#pragma unroll
      for (int W = 0; W < RA; ++W) {
        float o = 0.f;
#pragma unroll
        for (int JJ = 0; JJ < N; ++JJ) {
          const float4 cf = ld4(Ac() + ((W * N + i) * N + JJ) * RA);
          const float c4[4] = {cf.x, cf.y, cf.z, cf.w};
#pragma unroll
          for (int w = 0; w < RA; ++w) o = fmaf(c4[w], t[JJ][w], o);
        }
        S()[(i * CW + cl) * LDR + W * R + b] = o;
      }
    }
    __syncthreads();
    if (tid >= OWNERS) return 0.f;
    // product 3: warp w's tile (rows 8 (w / 2).., columns (i = w % 2, cl))
    const int lane = tid & 31, w = tid >> 5;
    float acc[8][4] = {};
    mma_chunks<8, 32, RA * R, false, true>(
        acc, (w >> 1) * 8, (w & 1) * CW, lane,
        [&](int m, int k) { return Lr() + m * LDR + k; },
        [&](int n, int k) { return S() + n * LDR + k; });
    return warp_tile_sum(acc, lane);
  }

  // The sum over the cluster of every thread's v, the same bits in every
  // thread of every CTA: a block sum, pushed into slot row sflip of every
  // CTA, summed in rank order after the cluster barrier.
  __device__ float cluster_dot(float v) {
    const float s = block_sum(v, red(), flip);
    float* slot = slots() + 32 * sflip;
    sflip ^= 1;
    if (threadIdx.x < 32) ttnx_cluster::push_partial<C>(slot, s, rank);
    ttnx_cluster::cluster_sync();
    return ttnx_cluster::cluster_sum<C>(slot);
  }

  // P's owned columns = pv (the owners' values) in every CTA; ends with
  // the cluster barrier that publishes them.
  __device__ void publish(float pv) const {
    if (threadIdx.x < OWNERS)
      P()[(own_a() * N + own_i()) * LDP + own_c()] = pv;
    __syncthreads();
    constexpr int ROWS = N * R;
    for (int e = threadIdx.x; e < (C - 1) * ROWS; e += kThreads) {
      const int row = e % ROWS, to = (rank + 1 + e / ROWS) % C;
      float* src = P() + row * LDP + c0;
      st4(cluster_map(src, to), ld4(src));
    }
    ttnx_cluster::cluster_sync();
  }

  __device__ void solve(const float* rhs, const float* mask, const float* x0,
                        float* out, int iters, bool warm) {
    const bool own = threadIdx.x < OWNERS;
    const int o = (own_a() * N + own_i()) * R + own_c();
    const float mk = own ? mask[o] : 0.f;
    float x = 0.f, r = own ? rhs[o] * mk : 0.f;
    ttnx_cluster::cluster_sync();  // staged, and every partner started
    if (warm) {
      x = own ? x0[o] * mk : 0.f;
      publish(x * mk);
      const float h = apply() * mk + (1.f - mk) * x;
      r = r - h;
    }
    float p = r;
    // its barrier also keeps every partner's warm apply ahead of the push
    float rs = cluster_dot(r * r);
    publish(p * mk);
    for (int it = 0; it < iters; ++it) {
      const float ap = apply() * mk + (1.f - mk) * p;
      const float denom = cluster_dot(p * ap);
      const float alpha = fabsf(denom) > 0.f ? rs / denom : 0.f;
      x = fmaf(alpha, p, x);
      r = fmaf(-alpha, ap, r);
      const float rs_new = cluster_dot(r * r);
      const float beta = fabsf(rs) > 0.f ? rs_new / rs : 0.f;
      rs = rs_new;
      if (it + 1 == iters) break;  // the last p is never applied
      p = fmaf(beta, p, r);
      publish(p * mk);
    }
    if (own) out[o] = x * mk;
  }
};

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    matfree_cluster_kernel(const float* L, const float* Ac, const float* Renv,
                           const float* rhs, const float* mask,
                           const float* x0, float* out, int iters, int warm) {
  Solve<R> s;
  s.rank = ttnx_cluster::cluster_rank();
  s.c0 = s.rank * Solve<R>::CW;
  s.flip = 0;
  s.sflip = 0;
  s.stage(L, Ac, Renv);
  s.solve(rhs, mask, x0, out, iters, warm != 0);
}

template <int R>
int launch(const float* L, const float* Ac, const float* Renv,
           const float* rhs, const float* mask, const float* x0, float* out,
           int iters, int warm, cudaStream_t st) {
  static size_t fits = 0;
  return ttnx_cluster::launch_cluster(
      matfree_cluster_kernel<R>, Solve<R>::C, kThreads,
      Solve<R>::SMEM * sizeof(float), st, &fits, L, Ac, Renv, rhs, mask, x0,
      out, iters, warm);
}
}  // namespace ttnx_cg_cluster

// Shared-memory bytes of one CTA at rank R (the instantiated ranks; else
// -1).
extern "C" long long ttnx_cg_matfree_cluster_smem(int R) {
  using ttnx_cg_cluster::Solve;
  if (R == 64) return Solve<64>::SMEM * sizeof(float);
  if (R == 32) return Solve<32>::SMEM * sizeof(float);
  return -1;
}

// B4, route cluster: L, Ac, Renv, rhs, mask, x0 and out of ONE problem in
// the layouts of ttnx_cg_matfree_batched_f32 at B = 1 (no scratch); (R, n, RA) = (64, 2, 4)
// or (32, 2, 4), other shapes are refused.
extern "C" int ttnx_cg_matfree_cluster_f32(const void* L, const void* Ac,
                                           const void* Renv, const void* rhs,
                                           const void* mask, const void* x0,
                                           void* out, int R, int RA, int n,
                                           int iters, int warm,
                                           void* stream) {
  if (n != 2 || RA != 4) return (int)cudaErrorInvalidValue;
  const auto* l = (const float*)L;
  const auto* a = (const float*)Ac;
  const auto* re = (const float*)Renv;
  const auto* h = (const float*)rhs;
  const auto* m = (const float*)mask;
  const auto* x = (const float*)x0;
  auto* o = (float*)out;
  auto st = (cudaStream_t)stream;
  if (R == 64)
    return ttnx_cg_cluster::launch<64>(l, a, re, h, m, x, o, iters, warm, st);
  if (R == 32)
    return ttnx_cg_cluster::launch<32>(l, a, re, h, m, x, o, iters, warm, st);
  return (int)cudaErrorInvalidValue;
}
