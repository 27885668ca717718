// Runs route cluster of kernel B4 (ttnx_torch/csrc/local_cg_cluster.cu) on
// the CPU: its host function launches one cluster of R / 4 emulated blocks
// of 512 threads, all running at once, each with its own shared memory.
//
//   g++ -std=c++20 -O1 -I tests/cuda_emu -I ttnx_torch/csrc \
//       -DCLUSTER_SOURCE=<cluster.cpp> \
//       tests/cuda_emu/emulate_matfree_cluster.cpp \
//       -o emulate_matfree_cluster -lpthread
//   emulate_matfree_cluster DIR R iters warm
//
// CLUSTER_SOURCE is local_cg_cluster.cu with its dynamic shared-memory
// array mapped to the emulated block's (the test does that). DIR holds
// L.bin, Ac.bin, Renv.bin, rhs.bin, mask.bin and x0.bin of one problem
// (float32, the wrapper's layouts, n = 2, RA = 4); the result is written to
// DIR/out.bin. Standard output gets the shared-memory bytes of a CTA at
// each instantiated rank and the blocks of the launch.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "emu_block.h"

#include CLUSTER_SOURCE

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

int main(int argc, char** argv) {
  for (int R : {64, 32})
    printf("smem R %d %lld\n", R, ttnx_cg_matfree_cluster_smem(R));
  if (argc != 5) return 2;
  const std::string dir = argv[1];
  const int R = atoi(argv[2]), iters = atoi(argv[3]), warm = atoi(argv[4]);
  const int n = 2, RA = 4;
  const size_t V = (size_t)R * n * R, E = (size_t)R * RA * R;
  const auto L = read(dir + "/L.bin", E);
  const auto Ac = read(dir + "/Ac.bin", (size_t)RA * n * n * RA);
  const auto Renv = read(dir + "/Renv.bin", E);
  const auto rhs = read(dir + "/rhs.bin", V);
  const auto mask = read(dir + "/mask.bin", V);
  const auto x0 = read(dir + "/x0.bin", V);
  std::vector<float> out(V, NAN);
  const int err = ttnx_cg_matfree_cluster_f32(
      L.data(), Ac.data(), Renv.data(), rhs.data(), mask.data(), x0.data(),
      out.data(), R, RA, n, iters, warm, nullptr);
  if (err) {
    fprintf(stderr, "cg_matfree_cluster R %d: error %d\n", R, err);
    return 3;
  }
  printf("grid %u\n", emu_last_grid);
  FILE* f = fopen((dir + "/out.bin").c_str(), "wb");
  fwrite(out.data(), sizeof(float), out.size(), f);
  fclose(f);
  return 0;
}
