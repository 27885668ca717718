// Runs the batched gauge QR (ttnx_torch/csrc/qr_batched.cu) on the CPU:
// 256 threads a block, one block a matrix, the blocks one after another,
// each with its own dynamic shared memory (starting as NaN bytes).
//
//   g++ -std=c++20 -O1 -I tests/cuda_emu -I ttnx_torch/csrc \
//       -DQR_SOURCE=<qr.cpp> tests/cuda_emu/emulate_qr.cpp \
//       -o emulate_qr -lpthread
//   emulate_qr DIR dtype B m k rows vec     (dtype f32 or f64)
//
// QR_SOURCE is qr_batched.cu with its launch expression removed and its
// dynamic shared-memory array mapped to the emulated block's (the test
// does that). DIR holds V.bin, the (B, m, k) stack for rows = 0 or the
// (B, k, m) stack for rows = 1; Q.bin (the input's layout) and R.bin (B,
// k, k) are written there. vec = 1 takes the 16-byte copies (the inner
// size must allow them), vec = 0 the element-wise ones.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "emu_block.h"

#include QR_SOURCE

template <typename T>
static int run(const std::string& dir, int B, int m, int k, int rows,
               int vec) {
  const size_t nv = (size_t)B * m * k, nr = (size_t)B * k * k;
  std::vector<T> V(nv), Q(nv, (T)NAN), R(nr, (T)NAN);
  FILE* f = fopen((dir + "/V.bin").c_str(), "rb");
  if (!f || fread(V.data(), sizeof(T), nv, f) != nv) return 1;
  fclose(f);
  const int ld = rows ? m : (m | 1);
  const size_t smem = ((size_t)ld * k + k) * sizeof(T);
  for (int b = 0; b < B; ++b)
    emu_run_block_smem(b, ttnx_qr::kThreads, smem, [&] {
      ttnx_qr::qr_kernel<T>(V.data(), Q.data(), R.data(), m, k, ld, rows,
                            vec);
    });
  f = fopen((dir + "/Q.bin").c_str(), "wb");
  fwrite(Q.data(), sizeof(T), nv, f);
  fclose(f);
  f = fopen((dir + "/R.bin").c_str(), "wb");
  fwrite(R.data(), sizeof(T), nr, f);
  fclose(f);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const std::string dir = argv[1], dtype = argv[2];
  const int B = atoi(argv[3]), m = atoi(argv[4]), k = atoi(argv[5]);
  const int rows = atoi(argv[6]), vec = atoi(argv[7]);
  if (k < 1 || k > m || m > ttnx_qr::kMaxRows) return 2;
  return dtype == "f64" ? run<double>(dir, B, m, k, rows, vec)
                        : run<float>(dir, B, m, k, rows, vec);
}
