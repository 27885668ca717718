// Runs every route of kernels B6, B2 and B8 (ttnx_torch/csrc/
// env_chain_site.cu, on env_site.cuh) on the CPU: route resident as one
// emulated block of 512 threads a problem, the problems one after another;
// the cluster routes (B2's, and B8's with no rhs) through their host
// functions, which launch one cluster of C emulated blocks of 512 threads,
// all running at once.
//
//   g++ -std=c++20 -O1 -I tests/cuda_emu -I ttnx_torch/csrc \
//       -DENV_SOURCE=<env.cpp> tests/cuda_emu/emulate_env.cpp \
//       -o emulate_env -lpthread
//   emulate_env DIR resident B d R left raw     (R = 32 or 64)
//   emulate_env DIR cluster d R left raw        (R = 16, 32 or 64: R / 4
//                                                blocks)
//   emulate_env DIR clusterA d R left           (B8: RA = 5, no rhs)
//
// ENV_SOURCE is env_chain_site.cu with its launch expression removed and
// its dynamic shared-memory array mapped to the emulated block's (the
// test does both). DIR holds x.bin (B, d, R, 2, R), A.bin (d, 4, 2, 2, 4)
// and b.bin (B, d, R, 2, R), float32 (B = 1 for the cluster); envs and
// envs_b are written to DIR/envs.bin and DIR/envs_b.bin. B8 reads x.bin
// (d, R, 2, R) and A.bin (d, 5, 2, 2, 5) and writes envs.bin (d+1, R, 5,
// R). The shared-memory bytes of every instantiated layout are printed on
// standard output.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "emu_block.h"

#include ENV_SOURCE

static std::vector<float> read(const std::string& path, size_t count) {
  std::vector<float> v(count);
  FILE* f = fopen(path.c_str(), "rb");
  if (!f || fread(v.data(), sizeof(float), count, f) != count) {
    fprintf(stderr, "cannot read %s\n", path.c_str());
    exit(1);
  }
  fclose(f);
  return v;
}

static void write(const std::string& path, const std::vector<float>& v) {
  FILE* f = fopen(path.c_str(), "wb");
  fwrite(v.data(), sizeof(float), v.size(), f);
  fclose(f);
}

template <int R>
void resident(const float* x, const float* A, const float* b, float* envs,
              float* envs_b, int B, int d, int left, int raw) {
  using namespace ttnx_envsite;
  constexpr int S = resident_slab<R>();
  for (int p = 0; p < B; ++p)
    emu_run_block_smem(p, kThreads, EnvLayout<R, S>::BYTES, [&] {
      env_resident_kernel<R, S>(x, A, b, envs, envs_b,
                                (size_t)d * R * 2 * R, d, left, raw);
    });
}

static int operator_only(const std::string& dir, int d, int R, int left) {
  const size_t V = (size_t)R * 2 * R, E = (size_t)R * 5 * R;
  const auto x = read(dir + "/x.bin", d * V);
  const auto A = read(dir + "/A.bin", (size_t)d * 100);
  std::vector<float> envs((d + 1) * E, NAN);
  const int err = ttnx_env_chain_A_cluster_f32(x.data(), A.data(),
                                               envs.data(), d, R, 5, 2, left,
                                               nullptr);
  if (err) {
    fprintf(stderr, "env chain clusterA: error %d\n", err);
    return 3;
  }
  write(dir + "/envs.bin", envs);
  return 0;
}

int main(int argc, char** argv) {
  for (int RA : {4, 5})
    for (int rhs : {1, 0})
      for (int R : {64, 32, 16})
        for (int S : {16, 8, 4})
          if (ttnx_env_site_smem(R, S, RA, rhs) > 0)
            printf("smem R %d S %d RA %d rhs %d %lld\n", R, S, RA, rhs,
                   ttnx_env_site_smem(R, S, RA, rhs));
  const std::string route = argc > 2 ? argv[2] : "";
  if (route == "clusterA")
    return argc == 6 ? operator_only(argv[1], atoi(argv[3]), atoi(argv[4]),
                                     atoi(argv[5]))
                     : 2;
  const bool res = route == "resident";
  if (argc != (res ? 8 : 7)) return 2;
  const std::string dir = argv[1];
  const int B = res ? atoi(argv[3]) : 1, d = atoi(argv[res ? 4 : 3]);
  const int R = atoi(argv[res ? 5 : 4]);
  const int left = atoi(argv[res ? 6 : 5]), raw = atoi(argv[res ? 7 : 6]);
  const size_t V = (size_t)R * 2 * R, E = (size_t)R * 4 * R;
  const auto x = read(dir + "/x.bin", B * d * V);
  const auto A = read(dir + "/A.bin", (size_t)d * 64);
  const auto b = read(dir + "/b.bin", B * d * V);
  std::vector<float> envs(B * (d + 1) * E, NAN);
  std::vector<float> envs_b(B * (d + 1) * (size_t)R * R, NAN);
  int err = 0;
  if (res && R == 64)
    resident<64>(x.data(), A.data(), b.data(), envs.data(), envs_b.data(), B,
                 d, left, raw);
  else if (res && R == 32)
    resident<32>(x.data(), A.data(), b.data(), envs.data(), envs_b.data(), B,
                 d, left, raw);
  else if (res)
    return 2;
  else
    err = ttnx_env_chain_cluster_f32(x.data(), A.data(), b.data(),
                                     envs.data(), envs_b.data(), d, R, 4, 2,
                                     R, left, raw, nullptr);
  if (err) {
    fprintf(stderr, "env chain %s: error %d\n", route.c_str(), err);
    return 3;
  }
  write(dir + "/envs.bin", envs);
  write(dir + "/envs_b.bin", envs_b);
  return 0;
}
