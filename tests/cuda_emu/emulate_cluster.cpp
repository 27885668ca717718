// Runs the cluster route of B10 (bicgstab_cluster_kernel in
// ttnx_torch/csrc/local_cg.cu, on dense_cluster.cuh) on the CPU: its host
// function launches one cluster of C emulated blocks of 256 threads, all
// running at once.
//
//   g++ -std=c++20 -O1 -I tests/cuda_emu -I ttnx_torch/csrc \
//       -DCLUSTER_SOURCE=<local_cg.cpp> tests/cuda_emu/emulate_cluster.cpp \
//       -o emulate_cluster -lpthread
//   emulate_cluster DIR M iters C
//
// CLUSTER_SOURCE is local_cg.cu with its launch expressions removed and
// its dynamic shared-memory array mapped to the emulated block's (the
// test does both). DIR holds K.bin (M x M) and b.bin (M), float32; the
// result is written to DIR/out.bin. C is 2 or 4.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "emu_block.h"

#include CLUSTER_SOURCE

namespace ttnx_cg {
unsigned char smem_raw[16];  // the one-block kernels' (compiled, never run)
}

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
  if (argc != 5) return 2;
  const std::string dir = argv[1];
  const int M = atoi(argv[2]), iters = atoi(argv[3]), C = atoi(argv[4]);
  const auto K = read(dir + "/K.bin", (size_t)M * M);
  const auto b = read(dir + "/b.bin", M);
  std::vector<float> out(M, NAN);
  int err = 2;
  if (C == 2)
    err = ttnx_cg::bicgstab_cluster<2>(K.data(), b.data(), out.data(), M,
                                       iters, nullptr);
  else if (C == 4)
    err = ttnx_cg::bicgstab_cluster<4>(K.data(), b.data(), out.data(), M,
                                       iters, nullptr);
  if (err) {
    fprintf(stderr, "bicgstab_cluster<%d>: error %d\n", C, err);
    return 3;
  }
  FILE* f = fopen((dir + "/out.bin").c_str(), "wb");
  fwrite(out.data(), sizeof(float), out.size(), f);
  fclose(f);
  return 0;
}
