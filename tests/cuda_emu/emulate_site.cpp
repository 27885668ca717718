// Runs the site-resident B7 kernel (ttnx_torch/csrc/als_sweep_site.cu) on
// the CPU: 512 threads a block, the blocks one after another.
//
//   g++ -std=c++20 -O1 -I tests/cuda_emu -I ttnx_torch/csrc \
//       -DSITE_SOURCE=<site.cpp> tests/cuda_emu/emulate_site.cpp \
//       -o emulate_site -lpthread
//   emulate_site DIR B d R cg_iters cg_polish ns1 ns2
//
// SITE_SOURCE is the kernel source with its one launch expression
// removed (the test does that). DIR holds A.bin, b.bin, x.bin, m.bin
// (float32: the MPO stack, right-hand sides, guesses and masks, n = 2,
// RA = 4); the result is written to DIR/out.bin.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "emu_block.h"

#include SITE_SOURCE

namespace ttnx_site {
alignas(16) float site_smem[Site<64, 2, 4>::SMEM];
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
  if (argc != 9) return 2;
  const std::string dir = argv[1];
  const int B = atoi(argv[2]), d = atoi(argv[3]), R = atoi(argv[4]);
  const int cg = atoi(argv[5]), polish = atoi(argv[6]);
  const int ns1 = atoi(argv[7]), ns2 = atoi(argv[8]);
  if (R != 32 && R != 64) return 2;
  const int n = 2, RA = 4;
  const size_t V = (size_t)R * n * R;
  const auto A = read(dir + "/A.bin", (size_t)d * RA * n * n * RA);
  const auto b = read(dir + "/b.bin", B * d * V);
  const auto x = read(dir + "/x.bin", B * d * V);
  const auto m = read(dir + "/m.bin", (size_t)(d + 1) * R);
  std::vector<float> out(B * d * V, NAN);
  const size_t per = ttnx_site::scratch_per_problem(d, R, RA, n);
  std::vector<float> scratch(B * per, NAN);
  for (int p = 0; p < B; ++p) {
    for (float& v : ttnx_site::site_smem) v = NAN;
    run_block(p, ttnx_site::kThreads, [&] {
      if (R == 32)
        ttnx_site::sweep_site_kernel<32, 2, 4>(
            A.data(), b.data(), x.data(), m.data(), out.data(),
            scratch.data(), per, d, cg, polish, ns1, ns2);
      else
        ttnx_site::sweep_site_kernel<64, 2, 4>(
            A.data(), b.data(), x.data(), m.data(), out.data(),
            scratch.data(), per, d, cg, polish, ns1, ns2);
    });
  }
  FILE* f = fopen((dir + "/out.bin").c_str(), "wb");
  fwrite(out.data(), sizeof(float), out.size(), f);
  fclose(f);
  return 0;
}
