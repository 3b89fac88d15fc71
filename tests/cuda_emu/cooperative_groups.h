// The cluster of cooperative_groups the port's kernels use, emulated on
// the CPU with cuda_runtime.h's threads: this_cluster() of the running
// thread's block, its rank in the cluster, sync() a barrier across every
// thread of the cluster's blocks (barrier.cluster on the card), and
// map_shared_rank() the address at the same offset in another block's
// dynamic shared memory (distributed shared memory on the card).
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  void sync() const { emu_cluster_bar->arrive_and_wait(); }
  unsigned block_rank() const { return blockIdx.x % emu_cluster_size; }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    if (rank >= emu_cluster_size) std::abort();
    const auto at = reinterpret_cast<const unsigned char*>(p) - emu_dyn_smem;
    return reinterpret_cast<T*>(emu_cluster_smem[rank] + at);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
