// The CUDA the port's kernels use, emulated on the CPU so that g++ can
// build a kernel source and run it: one std::thread per CUDA thread,
// blocks one after another, a barrier for __syncthreads and one per warp
// for __syncwarp and the shuffles.  Block-level __shared__ variables
// become statics (one block runs at a time).  tests/test_torch_cuda_
// emulated.py rewrites each `kernel<<<grid, block, smem, stream>>>(args)`
// into emu_launch(grid, block, smem, [&] { kernel(args); }).
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline dim3 blockDim;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct uint4 {
  uint32_t x, y, z, w;
};
struct double2 {
  double x, y;
};
struct float4 {
  float x, y, z, w;
};
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline int __popc(uint32_t v) { return __builtin_popcount(v); }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)(((((uint64_t)hi) << 32) | lo) << (s & 31) >> 32);
}
inline int min(int a, int b) { return a < b ? a : b; }

struct EmuWarp {
  std::unique_ptr<std::barrier<>> bar;
  unsigned char slot[32][8];
};
inline std::vector<EmuWarp>* emu_warps;
inline std::barrier<>* emu_block_bar;
inline unsigned char* emu_dyn_smem;

inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  (*emu_warps)[threadIdx.x >> 5].bar->arrive_and_wait();
}
template <class T>
T emu_shfl(T v, int src) {
  EmuWarp& w = (*emu_warps)[threadIdx.x >> 5];
  std::memcpy(w.slot[threadIdx.x & 31], &v, sizeof(T));
  w.bar->arrive_and_wait();
  T out;
  std::memcpy(&out, w.slot[src & 31], sizeof(T));
  w.bar->arrive_and_wait();
  return out;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return emu_shfl(v, src);
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

inline void emu_launch(long long grid, int block, size_t smem,
                       std::function<void()> body) {
  blockDim.x = block;
  std::vector<unsigned char> dyn(smem + 16);
  emu_dyn_smem = dyn.data() + (16 - ((uintptr_t)dyn.data() & 15)) % 16;
  for (long long b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    emu_block_bar = &bar;
    std::vector<EmuWarp> warps((block + 31) / 32);
    for (auto& w : warps) w.bar = std::make_unique<std::barrier<>>(32);
    emu_warps = &warps;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = (unsigned)b;
        body();
      });
    for (auto& th : threads) th.join();
  }
}
