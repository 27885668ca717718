// The runtime half of the thread emulation of CUDA blocks (the types and
// declarations are in cuda_runtime.h and cooperative_groups.h): one
// std::thread per CUDA thread, __syncthreads a block-wide std::barrier,
// __shfl_xor_sync / __shfl_down_sync an exchange through a per-warp slot
// array between two warp barriers. run_block runs one block,
// emu_run_block_smem one block with dynamic shared memory; a cluster
// launch (cudaLaunchKernelEx) runs its blocks at once, each with its own
// dynamic shared memory, one cluster-wide barrier for all their threads,
// and partner addresses mapped block to block; a cooperative launch
// (cudaLaunchKernelEx too) is such a cluster, its grid barrier the
// cluster's. Included by the main program of each emulator executable.
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#include "cooperative_groups.h"
#include "cuda_runtime.h"

constexpr int kEmuWarps = 16;  // 512 threads a block at most

struct EmuBlock {
  explicit EmuBlock(int threads) : bar(threads) {
    for (int w = 0; w < threads / 32; ++w)
      warps.push_back(std::make_unique<std::barrier<>>(32));
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  double slot[kEmuWarps][32];
  unsigned char* smem = nullptr;  // dynamic shared memory (clusters)
};

struct EmuCluster {
  std::barrier<>* bar;
  std::vector<EmuBlock*> blocks;  // by rank
};

thread_local emu_dim3 threadIdx;
thread_local emu_dim3 blockIdx;
thread_local emu_dim3 blockDim;
thread_local emu_dim3 gridDim;
static thread_local EmuBlock* emu_self;
static thread_local EmuCluster* emu_cluster;

static double emu_exchange(double v, int from) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  emu_self->slot[w][l] = v;
  emu_self->warps[w]->arrive_and_wait();
  const double out = emu_self->slot[w][from & 31];
  emu_self->warps[w]->arrive_and_wait();
  return out;
}
float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  return (float)emu_exchange(v, (threadIdx.x & 31) ^ lane_mask);
}
double __shfl_xor_sync(unsigned, double v, int lane_mask) {
  return emu_exchange(v, (threadIdx.x & 31) ^ lane_mask);
}
double emu_shfl_down(double v, int delta) {
  const int l = threadIdx.x & 31;
  const double got = emu_exchange(v, l + delta);
  return l + delta < 32 ? got : v;
}
void __syncthreads() { emu_self->bar.arrive_and_wait(); }

unsigned emu_cluster_rank() { return blockIdx.x; }
unsigned emu_cluster_size() { return (unsigned)emu_cluster->blocks.size(); }
void emu_cluster_sync() { emu_cluster->bar->arrive_and_wait(); }
void* emu_map_shared(void* p, int rank) {
  const std::ptrdiff_t off =
      static_cast<unsigned char*>(p) - emu_self->smem;
  return emu_cluster->blocks.at(rank)->smem + off;
}
unsigned char* emu_dynamic_smem() { return emu_self->smem; }

static void emu_thread(EmuBlock* self, EmuCluster* cluster, int block,
                       int t, int threads, const std::function<void()>& f) {
  threadIdx = {(unsigned)t, 0, 0};
  blockIdx = {(unsigned)block, 0, 0};
  blockDim = {(unsigned)threads, 1, 1};
  gridDim = {cluster ? (unsigned)cluster->blocks.size() : 1u, 1, 1};
  emu_self = self;
  emu_cluster = cluster;
  f();
}

// Runs body() in each of the `threads` threads (a multiple of 32, at most
// 32 kEmuWarps) of block `block`.
template <class F>
void run_block(int block, int threads, const F& body) {
  EmuBlock self(threads);
  const std::function<void()> f = body;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back(emu_thread, &self, nullptr, block, t, threads,
                      std::cref(f));
  for (auto& t : pool) t.join();
}

// Runs body() in each of the `threads` threads of block `block`, with
// `smem_bytes` of dynamic shared memory starting as NaN bytes (0xff).
void emu_run_block_smem(int block, int threads, size_t smem_bytes,
                        const std::function<void()>& body) {
  EmuBlock self(threads);
  std::vector<unsigned char> memory(smem_bytes + 1024, (unsigned char)0xff);
  const auto at = reinterpret_cast<std::uintptr_t>(memory.data());
  self.smem = memory.data() + ((1024 - at % 1024) % 1024);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back(emu_thread, &self, nullptr, block, t, threads,
                      std::cref(body));
  for (auto& t : pool) t.join();
}

// Runs body() in every thread of `blocks` blocks at once, as one cluster;
// each block's dynamic shared memory starts as NaN bytes (0xff).
void emu_run_cluster(int blocks, int threads, size_t smem_bytes,
                     const std::function<void()>& body) {
  std::barrier<> bar(blocks * threads);
  EmuCluster cluster{&bar, {}};
  std::vector<std::unique_ptr<EmuBlock>> owned;
  std::vector<std::vector<unsigned char>> memory;
  for (int b = 0; b < blocks; ++b) {
    owned.push_back(std::make_unique<EmuBlock>(threads));
    memory.emplace_back(smem_bytes + 1024, (unsigned char)0xff);
    const auto at = reinterpret_cast<std::uintptr_t>(memory.back().data());
    owned.back()->smem = memory.back().data() + ((1024 - at % 1024) % 1024);
    cluster.blocks.push_back(owned.back().get());
  }
  std::vector<std::thread> pool;
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t)
      pool.emplace_back(emu_thread, owned[b].get(), &cluster, b, t, threads,
                        std::cref(body));
  for (auto& t : pool) t.join();
}
