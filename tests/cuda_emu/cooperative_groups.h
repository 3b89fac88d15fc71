// The cluster of cooperative_groups the port's kernels use, emulated on
// the CPU with cuda_runtime.h's threads: this_cluster() of the running
// thread's block, its rank in the cluster, and sync() a barrier across
// every thread of the cluster's blocks (barrier.cluster on the card).
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  void sync() const { emu_cluster_bar->arrive_and_wait(); }
  unsigned block_rank() const { return blockIdx.x % emu_cluster_size; }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
