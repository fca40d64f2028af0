// A stand-in for cooperative_groups.h (see cuda_runtime.h): the thread
// block cluster of the calling thread, as emu.cpp runs it (a cluster's
// blocks at once, each with its own shared memory).
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu_block_rank(); }
  void sync() const { emu_cluster_sync(); }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    return static_cast<T*>(emu_map_shared(p, rank));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
