// The CUDA the port's kernels use, emulated on the CPU so that g++ can
// build a kernel source and run it: one std::thread per CUDA thread, a
// barrier for __syncthreads and one per warp for __syncwarp (and one per
// group of lanes for a shuffle of width < 32), the shuffles and the
// ballots, atomicAdd, atomicOr and atomicCAS through std::atomic_ref, and
// the round-to-nearest float intrinsics as plain IEEE operations (g++
// contracts no FMA for x86-64 without -mfma); log1p and log1pf are the host
// libm's.  Blocks run one cluster at a time: the blocks of a cluster
// together (their threads all at once, each block with its own warps,
// barrier and dynamic shared memory, cooperative_groups.h's
// this_cluster().sync() a barrier across them and map_shared_rank() a
// pointer into another block's dynamic shared memory), clusters one after
// another.  bulk_copy.cuh stands in for the package's bulk copies and
// mbarriers.  cudaLaunchKernelEx runs a kernel as emu_launch does, row y
// of its grid after row y - 1 (blockIdx.y set in each block's threads);
// its attributes are read by nothing, and cudaGridDependencySynchronize
// (programmatic dependent launch's wait) returns at once: the launches run
// one after another.
// A kernel's cluster size is its __cluster_dims__ (a no-op attribute here):
// tests/test_torch_cuda_emulated.py rewrites each `kernel<<<grid, block,
// smem, stream>>>(args)` into emu_launch(grid, block, smem, [&] {
// kernel(args); }, cluster), cluster 1 unless the kernel declares one.
// Block-level __shared__ variables become statics, so only a kernel of
// clusters of one block may have them (one block runs at a time).
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
  dim3(unsigned a = 0, unsigned b = 0, unsigned c = 0) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline dim3 blockDim;
inline dim3 gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
enum cudaLaunchAttributeID {
  cudaLaunchAttributeProgrammaticStreamSerialization = 5
};
union cudaLaunchAttributeValue {
  int programmaticStreamSerializationAllowed;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};
// one cluster at a time, as the emulator runs them
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, const void*,
                                                  const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __cluster_dims__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct uint4 {
  uint32_t x, y, z, w;
};
// 16-byte aligned as CUDA's: a load of one at another address aborts, as
// the card faults on it
struct alignas(16) double2 {
  double x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
template <class T>
T __ldg(const T* p) {
  if (reinterpret_cast<uintptr_t>(p) % alignof(T)) std::abort();
  return *p;
}
template <class T>
T __ldcg(const T* p) {
  if (reinterpret_cast<uintptr_t>(p) % alignof(T)) std::abort();
  return *p;
}
inline double2 make_double2(double x, double y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline void cudaGridDependencySynchronize() {}
inline int __popc(uint32_t v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
// the block's threads run concurrently: atomics are real ones
template <class T>
T atomicAdd(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_add(v);
}
template <class T>
T atomicOr(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_or(v);
}
template <class T>
T atomicCAS(T* p, T cmp, T v) {
  std::atomic_ref<T>(*p).compare_exchange_strong(cmp, v);
  return cmp;  // the old value, on success as on failure
}
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)(((((uint64_t)hi) << 32) | lo) << (s & 31) >> 32);
}
inline int min(int a, int b) { return a < b ? a : b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }

struct EmuWarp {
  std::unique_ptr<std::barrier<>> bar;
  // sub[k][i]: the barrier of lanes [i << k, (i + 1) << k), k = 1..4
  std::unique_ptr<std::barrier<>> sub[5][16];
  unsigned char slot[32][8];
};
// the running thread's block: its warps, its barrier, its dynamic shared
// memory; and its cluster's size and barrier
inline thread_local std::vector<EmuWarp>* emu_warps;
inline thread_local std::barrier<>* emu_block_bar;
inline thread_local unsigned char* emu_dyn_smem;
inline thread_local unsigned emu_cluster_size = 1;
inline thread_local std::barrier<>* emu_cluster_bar;
// the dynamic shared memory of each block of the running thread's cluster,
// by rank
inline thread_local unsigned char* const* emu_cluster_smem;

inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  (*emu_warps)[threadIdx.x >> 5].bar->arrive_and_wait();
}
template <class T>
T emu_shfl(T v, int src, int width = 32) {
  EmuWarp& w = (*emu_warps)[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  std::barrier<>* bar = w.bar.get();
  if (width < 32) {  // only the lanes of this group take part
    const int k = __builtin_ctz(width);
    bar = w.sub[k][lane >> k].get();
    src = (lane & ~(width - 1)) | (src & (width - 1));
  }
  std::memcpy(w.slot[lane], &v, sizeof(T));
  bar->arrive_and_wait();
  T out;
  std::memcpy(&out, w.slot[src & 31], sizeof(T));
  bar->arrive_and_wait();
  return out;
}
template <class T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  return emu_shfl(v, src, width);
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int o) {
  return emu_shfl(v, (int)(threadIdx.x & 31) ^ o);
}
template <class T>
T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  const T got = emu_shfl(v, lane < d ? lane : lane - d);
  return lane < d ? v : got;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  EmuWarp& w = (*emu_warps)[threadIdx.x >> 5];
  w.slot[threadIdx.x & 31][0] = pred != 0;
  w.bar->arrive_and_wait();
  unsigned out = 0;
  for (int l = 0; l < 32; ++l) out |= (unsigned)w.slot[l][0] << l;
  w.bar->arrive_and_wait();
  return out;
}
inline bool __all_sync(unsigned m, int pred) {
  return __ballot_sync(m, pred) == 0xffffffffu;
}

// The state of one emulated block.
struct EmuBlock {
  std::vector<EmuWarp> warps;
  std::unique_ptr<std::barrier<>> bar;
  std::vector<unsigned char> dyn;
  EmuBlock(int block, size_t smem)
      : warps((block + 31) / 32), bar(new std::barrier<>(block)),
        dyn(smem + 16) {
    for (auto& w : warps) {
      w.bar = std::make_unique<std::barrier<>>(32);
      for (int k = 1; k < 5; ++k)
        for (int i = 0; i < (32 >> k); ++i)
          w.sub[k][i] = std::make_unique<std::barrier<>>(1 << k);
    }
  }
  unsigned char* smem() {
    return dyn.data() + (16 - ((uintptr_t)dyn.data() & 15)) % 16;
  }
};

inline void emu_launch(long long grid, int block, size_t smem,
                       std::function<void()> body, int cluster = 1) {
  blockDim.x = block;
  gridDim.x = (unsigned)grid;
  if (cluster < 1 || grid % cluster) std::abort();  // as the card refuses
  for (long long c0 = 0; c0 < grid; c0 += cluster) {
    std::vector<std::unique_ptr<EmuBlock>> blocks;
    for (int b = 0; b < cluster; ++b)
      blocks.push_back(std::make_unique<EmuBlock>(block, smem));
    std::barrier<> cluster_bar(cluster * block);
    std::vector<unsigned char*> cluster_smem;
    for (auto& eb : blocks) cluster_smem.push_back(eb->smem());
    std::vector<std::thread> threads;
    for (int b = 0; b < cluster; ++b)
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&, t, b] {
          EmuBlock& eb = *blocks[b];
          threadIdx.x = t;
          blockIdx.x = (unsigned)(c0 + b);
          emu_warps = &eb.warps;
          emu_block_bar = eb.bar.get();
          emu_dyn_smem = eb.smem();
          emu_cluster_size = (unsigned)cluster;
          emu_cluster_bar = &cluster_bar;
          emu_cluster_smem = cluster_smem.data();
          body();
        });
    for (auto& th : threads) th.join();
  }
}

template <class... Params, class... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(Params...), Args&&... args) {
  gridDim.y = cfg->gridDim.y;
  for (unsigned y = 0; y < cfg->gridDim.y; ++y)
    emu_launch(cfg->gridDim.x, (int)cfg->blockDim.x, cfg->dynamicSmemBytes,
               [&, y] {
                 blockIdx.y = y;
                 kernel(args...);
               });
  return cudaSuccess;
}
