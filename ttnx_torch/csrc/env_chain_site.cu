// Kernels B6 and B2 on the column-slab site update (env_site.cuh): the ALS
// environment chains, operator and rhs envs together, f32, at (R, n, RA)
// with n = 2, RA = 4 and Rb = R; and kernel B8, the operator envs alone of
// the DMRG sweeps, f32 at n = 2, RA = 5.
//
// Replaces ttnx/kernels/env_chain.py, env_chain_fused_batched
// (_kernel_b1, pallas_call at :346) with route "resident",
// right_env_chain_fused / left_env_chain_fused (pallas_call at :420 and
// :382) with route "cluster", and env_chain_A_fused (_kernel_A,
// pallas_call at :238) with route "cluster", as csrc/env_chain.cu (route
// "staged") does for f64 and every other shape.
//
// What bounds it on the H100: a site of the chain is about 10.9 MFLOP of
// f32 FMA at R = 64 (2.7 at R = 32, 0.7 at R = 16), and the d sites of a
// problem depend on each other. Route "staged" runs each site as five
// multi-block launches in stream order with the intermediates in device
// scratch (64 MB at B = 512): 8.5 ms a batched call at B = 512, slower
// than its plain version, and 0.8-0.9 ms a single chain at R = 64, where
// 62 dependent launches of 3-26 us each set the time.
//
// Route "resident" (env_resident_kernel): one 512-thread block a problem
// (grid = B) walks its d sites in one launch; the env and rhs env stay in
// shared memory from one site to the next (a ping-pong pair, since every
// slab reads the whole previous env), and every env is written to the
// output. At R = 64 the block takes 228,608 B of shared memory, one block
// an SM. A shape of two blocks an SM (at most 113 KB each) cannot hold the
// previous env (66,560 B padded) with the core (34,816 B) and a slab at
// R = 64, so it would read the env from L2 on every slab: the one-block
// shape is kept. The next site's cores are not prefetched: a second core
// buffer does not fit, and one core is 32 KB from L2 against tens of us
// of FMA work a site.
//
// Route "cluster" (env_cluster_kernel): one chain (B = 1) on one cluster
// of C = R / 4 CTAs (16 at R = 64, a non-portable size), each owning S = 4
// output columns of the env and of the rhs env. Every CTA holds the whole previous envs (the same ping-pong
// pair), computes its slab, and pushes it into every partner's next
// buffer through distributed shared memory; one cluster barrier a site.
// No slab depends on another's sums, so two launches give the same bits.
// The launch asks cudaOccupancyMaxActiveClusters first (launch_cluster):
// no fit is an error, never another route.
//
// B8's route "cluster" (env_A_cluster_kernel) is B2's with RA = 5 and no
// rhs: one push of the env slab and one cluster barrier a site, 211,664 B
// of shared memory a CTA at R = 64 (a site is about 11.3 MFLOP there,
// about B2's 10.9 with its rhs). Route "staged" ran it as three launches a
// site, the MPO mix an elementwise pass through device scratch.
#include "env_site.cuh"

namespace ttnx_envsite {

extern __shared__ __align__(16) float env_smem[];

template <int R, int S>
__global__ void __launch_bounds__(kThreads, 1)
    env_resident_kernel(const float* x, const float* A, const float* b,
                        float* envs, float* envs_b, size_t b_stride, int d,
                        int left, int raw) {
  const size_t bb = blockIdx.x;
  EnvChain<R, S, 1> c;
  c.sm = env_smem;
  c.x = x + bb * d * EnvChain<R, S, 1>::V;
  c.A = A;
  c.b = b + bb * b_stride;
  c.envs = envs + bb * (d + 1) * EnvChain<R, S, 1>::E;
  c.envs_b = envs_b + bb * (d + 1) * R * R;
  c.d = d;
  c.left = left;
  c.raw = raw;
  c.run(0);
}

template <int R, int C>
__global__ void __launch_bounds__(kThreads, 1)
    env_cluster_kernel(const float* x, const float* A, const float* b,
                       float* envs, float* envs_b, int d, int left,
                       int raw) {
  EnvChain<R, R / C, C> c;
  c.sm = env_smem;
  c.x = x;
  c.A = A;
  c.b = b;
  c.envs = envs;
  c.envs_b = envs_b;
  c.d = d;
  c.left = left;
  c.raw = raw;
  c.run(ttnx_cluster::cluster_rank());
}

template <int R, int C>
__global__ void __launch_bounds__(kThreads, 1)
    env_A_cluster_kernel(const float* x, const float* A, float* envs, int d,
                         int left) {
  EnvChain<R, R / C, C, 5, false> c;
  c.sm = env_smem;
  c.x = x;
  c.A = A;
  c.b = nullptr;
  c.envs = envs;
  c.envs_b = nullptr;
  c.d = d;
  c.left = left;
  c.raw = 0;
  c.run(ttnx_cluster::cluster_rank());
}

// The slab width of route resident at rank R: every thread of the first
// product busy.
template <int R>
constexpr int resident_slab() {
  return R == 64 ? 8 : 16;
}

template <int R>
int resident(const float* x, const float* A, const float* b, float* envs,
             float* envs_b, size_t b_stride, int B, int d, int left,
             int raw, cudaStream_t st) {
  constexpr int S = resident_slab<R>();
  auto kernel = env_resident_kernel<R, S>;
  const size_t smem = EnvLayout<R, S>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, st>>>(x, A, b, envs, envs_b, b_stride, d, left,
                                    raw);
  return (int)cudaGetLastError();
}

template <int R, int C>
int cluster(const float* x, const float* A, const float* b, float* envs,
            float* envs_b, int d, int left, int raw, cudaStream_t st) {
  static size_t fits = 0;
  return ttnx_cluster::launch_cluster(
      env_cluster_kernel<R, C>, C, kThreads, EnvLayout<R, R / C>::BYTES, st,
      &fits, x, A, b, envs, envs_b, d, left, raw);
}

template <int R, int C>
int cluster_A(const float* x, const float* A, float* envs, int d, int left,
              cudaStream_t st) {
  static size_t fits = 0;
  return ttnx_cluster::launch_cluster(
      env_A_cluster_kernel<R, C>, C, kThreads,
      EnvLayout<R, R / C, 5, false>::BYTES, st, &fits, x, A, envs, d, left);
}
}  // namespace ttnx_envsite

// Shared-memory bytes of one block (CTA) at rank R, slab width S, MPO bond
// RA, with the rhs envs (rhs 1, B2 and B6) or without (0, B8), for the
// instantiated shapes (else -1).
extern "C" long long ttnx_env_site_smem(int R, int S, int RA, int rhs) {
  using ttnx_envsite::EnvLayout;
  if (RA == 4 && rhs) {
    if (R == 64 && S == 8) return EnvLayout<64, 8>::BYTES;
    if (R == 64 && S == 4) return EnvLayout<64, 4>::BYTES;
    if (R == 32 && S == 16) return EnvLayout<32, 16>::BYTES;
    if (R == 32 && S == 4) return EnvLayout<32, 4>::BYTES;
    if (R == 16 && S == 4) return EnvLayout<16, 4>::BYTES;
  }
  if (RA == 5 && !rhs && S == 4) {
    if (R == 64) return EnvLayout<64, 4, 5, false>::BYTES;
    if (R == 32) return EnvLayout<32, 4, 5, false>::BYTES;
    if (R == 16) return EnvLayout<16, 4, 5, false>::BYTES;
  }
  return -1;
}

// B6, route resident: B problems, shared A, b's problems b_stride floats
// apart (0: one rhs for all), envs in the public or raw layout. R = 64 or
// 32, n = 2, RA = 4, Rb = R; other shapes are refused.
extern "C" int ttnx_env_chain_resident_f32(const void* x, const void* A,
                                           const void* b, void* envs,
                                           void* envs_b, long long b_stride,
                                           int B, int d, int R, int RA, int n,
                                           int Rb, int left, int raw,
                                           void* stream) {
  if (n != 2 || RA != 4 || Rb != R || d < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const auto *xx = (const float*)x, *a = (const float*)A,
             *bb = (const float*)b;
  auto *e = (float*)envs, *eb = (float*)envs_b;
  auto st = (cudaStream_t)stream;
  if (R == 64)
    return ttnx_envsite::resident<64>(xx, a, bb, e, eb, (size_t)b_stride, B,
                                      d, left, raw, st);
  if (R == 32)
    return ttnx_envsite::resident<32>(xx, a, bb, e, eb, (size_t)b_stride, B,
                                      d, left, raw, st);
  return (int)cudaErrorInvalidValue;
}

// B2, route cluster: one chain on a cluster of R / 4 CTAs (slabs of four
// columns), envs in the public or raw layout. R = 64, 32 or 16, n = 2,
// RA = 4, Rb = R; other shapes are refused. Slabs of eight (8 CTAs at
// R = 64, 4 at R = 32) ran slower on the H100 (scripts/probe_torch_env.py).
extern "C" int ttnx_env_chain_cluster_f32(const void* x, const void* A,
                                          const void* b, void* envs,
                                          void* envs_b, int d, int R, int RA,
                                          int n, int Rb, int left, int raw,
                                          void* stream) {
  if (n != 2 || RA != 4 || Rb != R || d < 1) return (int)cudaErrorInvalidValue;
  const auto *xx = (const float*)x, *a = (const float*)A,
             *bb = (const float*)b;
  auto *e = (float*)envs, *eb = (float*)envs_b;
  auto st = (cudaStream_t)stream;
  using namespace ttnx_envsite;
  if (R == 64) return cluster<64, 16>(xx, a, bb, e, eb, d, left, raw, st);
  if (R == 32) return cluster<32, 8>(xx, a, bb, e, eb, d, left, raw, st);
  if (R == 16) return cluster<16, 4>(xx, a, bb, e, eb, d, left, raw, st);
  return (int)cudaErrorInvalidValue;
}

// B8, route cluster: the operator envs of one chain on a cluster of R / 4
// CTAs, public layout. R = 64, 32 or 16, n = 2, RA = 5; other shapes are
// refused.
extern "C" int ttnx_env_chain_A_cluster_f32(const void* x, const void* A,
                                            void* envs, int d, int R, int RA,
                                            int n, int left, void* stream) {
  if (n != 2 || RA != 5 || d < 1) return (int)cudaErrorInvalidValue;
  const auto *xx = (const float*)x, *a = (const float*)A;
  auto* e = (float*)envs;
  auto st = (cudaStream_t)stream;
  using namespace ttnx_envsite;
  if (R == 64) return cluster_A<64, 16>(xx, a, e, d, left, st);
  if (R == 32) return cluster_A<32, 8>(xx, a, e, d, left, st);
  if (R == 16) return cluster_A<16, 4>(xx, a, e, d, left, st);
  return (int)cudaErrorInvalidValue;
}
