// Runs the cluster route of B9 (lanczos_cluster_kernel in
// ttnx_torch/csrc/lanczos.cu, on dense_cluster.cuh) on the CPU: its host
// function launches one cluster of C emulated blocks of 256 threads, all
// running at once.
//
//   g++ -std=c++20 -O1 -I tests/cuda_emu -I ttnx_torch/csrc \
//       -DLANCZOS_SOURCE=<lanczos.cpp> tests/cuda_emu/emulate_lanczos.cpp \
//       -o emulate_lanczos -lpthread
//   emulate_lanczos DIR M iters C BUDGET
//
// LANCZOS_SOURCE is lanczos.cu with its launch expression removed and its
// cluster kernel's dynamic shared-memory array mapped to the emulated
// block's (the test does both). DIR holds K.bin (M x M) and v0.bin (M),
// float32; Q (iters x M), alphas and betas (iters) are written to
// DIR/Q.bin, DIR/alphas.bin and DIR/betas.bin. C is 2 or 4; BUDGET is the
// shared memory a CTA may use, in bytes (the card's 232448, or less so
// that rows of K are streamed). The layout the host function uses
// (resident rows, basis in shared memory) is printed on standard output.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "emu_block.h"

#include LANCZOS_SOURCE

namespace ttnx_lanczos {
unsigned char smem_raw[16];  // the one-block kernel's (compiled, never run)
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

static void write(const std::string& path, const std::vector<float>& v) {
  FILE* f = fopen(path.c_str(), "wb");
  fwrite(v.data(), sizeof(float), v.size(), f);
  fclose(f);
}

int main(int argc, char** argv) {
  if (argc != 6) return 2;
  const std::string dir = argv[1];
  const int M = atoi(argv[2]), iters = atoi(argv[3]), C = atoi(argv[4]);
  const size_t budget = (size_t)atol(argv[5]);
  const auto K = read(dir + "/K.bin", (size_t)M * M);
  const auto v0 = read(dir + "/v0.bin", M);
  std::vector<float> Q((size_t)iters * M, NAN), a(iters, NAN), b(iters, NAN);
  int err = 2;
  if (C == 2)
    err = ttnx_lanczos::lanczos_cluster<2>(K.data(), v0.data(), Q.data(),
                                           a.data(), b.data(), M, iters,
                                           budget, nullptr);
  else if (C == 4)
    err = ttnx_lanczos::lanczos_cluster<4>(K.data(), v0.data(), Q.data(),
                                           a.data(), b.data(), M, iters,
                                           budget, nullptr);
  if (err) {
    fprintf(stderr, "lanczos_cluster<%d>: error %d\n", C, err);
    return 3;
  }
  const auto L = ttnx_lanczos::lanczos_cluster_layout(M, iters, C, budget);
  printf("resident %d q_in_smem %d bytes %zu\n", L.resident, L.q_in_smem,
         L.floats * sizeof(float));
  write(dir + "/Q.bin", Q);
  write(dir + "/alphas.bin", a);
  write(dir + "/betas.bin", b);
  return 0;
}
