// Runs the cluster routes of B10 and B3 (bicgstab_cluster_kernel and
// cg_cluster_kernel in ttnx_torch/csrc/local_cg.cu, on dense_cluster.cuh)
// on the CPU: their host functions launch one cluster of C emulated
// blocks of 256 threads, all running at once.
//
//   g++ -std=c++20 -O1 -I tests/cuda_emu -I ttnx_torch/csrc \
//       -DCLUSTER_SOURCE=<local_cg.cpp> tests/cuda_emu/emulate_cluster.cpp \
//       -o emulate_cluster -lpthread
//   emulate_cluster DIR M iters C            (B10)
//   emulate_cluster DIR M iters C cg WARM    (B3, WARM 0 or 1)
//
// CLUSTER_SOURCE is local_cg.cu with its launch expressions removed and
// its dynamic shared-memory array mapped to the emulated block's (the
// test does both). DIR holds K.bin (M x M), b.bin (M) and, for a warm B3,
// x0.bin (M), float32; the result is written to DIR/out.bin. C is 2 or
// 4.
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

template <int C>
int run(bool cg, const float* K, const float* b, const float* x0, float* out,
        int M, int iters, int warm) {
  if (cg)
    return ttnx_cg::cg_cluster<C>(K, b, x0, out, M, iters, warm, nullptr);
  return ttnx_cg::bicgstab_cluster<C>(K, b, out, M, iters, nullptr);
}

int main(int argc, char** argv) {
  if (argc != 5 && argc != 7) return 2;
  const std::string dir = argv[1];
  const int M = atoi(argv[2]), iters = atoi(argv[3]), C = atoi(argv[4]);
  const bool cg = argc == 7 && std::string(argv[5]) == "cg";
  const int warm = argc == 7 ? atoi(argv[6]) : 0;
  const auto K = read(dir + "/K.bin", (size_t)M * M);
  const auto b = read(dir + "/b.bin", M);
  const auto x0 = warm ? read(dir + "/x0.bin", M) : b;
  std::vector<float> out(M, NAN);
  int err = 2;
  if (C == 2)
    err = run<2>(cg, K.data(), b.data(), x0.data(), out.data(), M, iters,
                 warm);
  else if (C == 4)
    err = run<4>(cg, K.data(), b.data(), x0.data(), out.data(), M, iters,
                 warm);
  if (err) {
    fprintf(stderr, "%s_cluster<%d>: error %d\n", cg ? "cg" : "bicgstab", C,
            err);
    return 3;
  }
  FILE* f = fopen((dir + "/out.bin").c_str(), "wb");
  fwrite(out.data(), sizeof(float), out.size(), f);
  fclose(f);
  return 0;
}
