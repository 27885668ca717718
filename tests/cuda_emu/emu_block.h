// The runtime half of the thread emulation of a CUDA block (the types and
// declarations are in cuda_runtime.h): one std::thread per CUDA thread,
// __syncthreads a block-wide std::barrier, __shfl_xor_sync an exchange
// through a per-warp slot array between two warp barriers. Included by one
// driver of each emulator executable.
#pragma once
#include <barrier>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

constexpr int kEmuWarps = 16;  // 512 threads a block at most

thread_local emu_dim3 threadIdx;
emu_dim3 blockIdx;
static std::barrier<>* block_barrier;
static std::barrier<>* warp_barrier[kEmuWarps];
static float warp_slot[kEmuWarps][32];

float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  warp_slot[w][l] = v;
  warp_barrier[w]->arrive_and_wait();
  const float out = warp_slot[w][l ^ lane_mask];
  warp_barrier[w]->arrive_and_wait();
  return out;
}
void __syncthreads() { block_barrier->arrive_and_wait(); }

// Runs body() in each of the `threads` threads (a multiple of 32, at most
// 32 kEmuWarps) of block `block`.
template <class F>
void run_block(int block, int threads, const F& body) {
  blockIdx.x = block;
  std::barrier<> bar(threads);
  block_barrier = &bar;
  std::vector<std::barrier<>*> warps;
  for (int w = 0; w < threads / 32; ++w)
    warps.push_back(warp_barrier[w] = new std::barrier<>(32));
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx.x = t;
      body();
    });
  for (auto& t : pool) t.join();
  for (auto* w : warps) delete w;
}
