// A CPU stand-in for the cluster and grid parts of cooperative_groups.h,
// on the emulated clusters of emu_block.h: a block's rank, the address of
// a shared-memory location in a partner block, the cluster barrier, and
// the grid barrier of a cooperative launch (whose blocks run as one
// emulated cluster).
#pragma once
#include "cuda_runtime.h"

unsigned emu_cluster_rank();
unsigned emu_cluster_size();
void emu_cluster_sync();
void* emu_map_shared(void* p, int rank);

namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu_cluster_rank(); }
  unsigned num_blocks() const { return emu_cluster_size(); }
  void sync() const { emu_cluster_sync(); }
  template <class T>
  T* map_shared_rank(T* p, int rank) const {
    return static_cast<T*>(emu_map_shared((void*)p, rank));
  }
};
inline cluster_group this_cluster() { return {}; }
struct grid_group {
  void sync() const { emu_cluster_sync(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
