// Runs the resident B4/B5 kernel (ttnx_torch/csrc/local_cg_site.cu) on the
// CPU: 512 threads a block, the blocks one after another.
//
//   g++ -std=c++20 -O1 -I tests/cuda_emu -I ttnx_torch/csrc \
//       -DMATFREE_SOURCE=<matfree.cpp> tests/cuda_emu/emulate_matfree.cpp \
//       -o emulate_matfree -lpthread
//   emulate_matfree DIR B R iters warm
//
// MATFREE_SOURCE is the kernel source with its one launch expression
// removed (the test does that). DIR holds L.bin, Ac.bin, Renv.bin,
// rhs.bin, mask.bin and x0.bin (float32, the wrapper's layouts, n = 2,
// RA = 4); the result is written to DIR/out.bin.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "emu_block.h"

#include MATFREE_SOURCE

namespace ttnx_cg_site {
alignas(16) float cg_smem[Solve<64, 2, 4>::SMEM];
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
  if (argc != 6) return 2;
  const std::string dir = argv[1];
  const int B = atoi(argv[2]), R = atoi(argv[3]);
  const int iters = atoi(argv[4]), warm = atoi(argv[5]);
  if (R != 32 && R != 64) return 2;
  const int n = 2, RA = 4;
  const size_t V = (size_t)R * n * R, E = (size_t)R * RA * R;
  const auto L = read(dir + "/L.bin", B * E);
  const auto Ac = read(dir + "/Ac.bin", (size_t)RA * n * n * RA);
  const auto Renv = read(dir + "/Renv.bin", B * E);
  const auto rhs = read(dir + "/rhs.bin", B * V);
  const auto mask = read(dir + "/mask.bin", V);
  const auto x0 = read(dir + "/x0.bin", B * V);
  std::vector<float> out(B * V, NAN), scratch(B * 3 * V, NAN);
  for (int p = 0; p < B; ++p) {
    for (float& v : ttnx_cg_site::cg_smem) v = NAN;
    run_block(p, ttnx_site::kThreads, [&] {
      if (R == 32)
        ttnx_cg_site::cg_site_kernel<32, 2, 4>(
            L.data(), Ac.data(), Renv.data(), rhs.data(), mask.data(),
            x0.data(), out.data(), scratch.data(), iters, warm);
      else
        ttnx_cg_site::cg_site_kernel<64, 2, 4>(
            L.data(), Ac.data(), Renv.data(), rhs.data(), mask.data(),
            x0.data(), out.data(), scratch.data(), iters, warm);
    });
  }
  FILE* f = fopen((dir + "/out.bin").c_str(), "wb");
  fwrite(out.data(), sizeof(float), out.size(), f);
  fclose(f);
  return 0;
}
