// Runs kernel B1's route grid (ttnx_torch/csrc/gram_chain_grid.cu) on the
// CPU: its host function launches one cooperative grid of emulated blocks
// of 256 threads, all running at once, the grid barrier a barrier of all
// their threads.
//
//   g++ -std=c++20 -O1 -I tests/cuda_emu -I ttnx_torch/csrc \
//       -DGRAM_SOURCE=<gram.cpp> tests/cuda_emu/emulate_gram.cpp \
//       -o emulate_gram -lpthread
//   emulate_gram DIR d R SMS           (the kernel sizes its grid itself,
//                                       on an emulated device of SMS SMs)
//
// GRAM_SOURCE is gram_chain_grid.cu with its dynamic shared-memory array
// mapped to the emulated block's (the test does that). DIR holds y.bin
// (d, R, 2, R) float32; the stack Gs (d, R, R) is written to DIR/Gs.bin
// and the grid size the kernel chose to standard output ("grid N").
// A refused shape exits 3 with the error on standard error.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "emu_block.h"

#include GRAM_SOURCE

int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const std::string dir = argv[1];
  const int d = atoi(argv[2]), R = atoi(argv[3]);
  emu_sm_count = atoi(argv[4]);
  const size_t ny = (size_t)d * R * 2 * R;
  std::vector<float> y(ny), Gs((size_t)d * R * R, NAN),
      T((size_t)2 * R * R, NAN);
  FILE* f = fopen((dir + "/y.bin").c_str(), "rb");
  if (!f || fread(y.data(), sizeof(float), ny, f) != ny) return 1;
  fclose(f);
  const int err = ttnx_gram_chain_grid_f32(y.data(), Gs.data(), T.data(), d,
                                           R, 2, nullptr);
  if (err) {
    fprintf(stderr, "gram chain grid: error %d\n", err);
    return 3;
  }
  f = fopen((dir + "/Gs.bin").c_str(), "wb");
  fwrite(Gs.data(), sizeof(float), Gs.size(), f);
  fclose(f);
  printf("grid %u\n", emu_last_grid);
  return 0;
}
