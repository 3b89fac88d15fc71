// The bulk copies and mbarriers of emsar_tpu_torch/csrc/bulk_copy.cuh,
// emulated on the CPU with cuda_runtime.h's threads: the copy is a memcpy
// by the thread that issues it, and the barrier's 8 bytes count the
// arrivals (bits 0-19) and bytes (bits 20-51) its phase still waits for,
// bit 63 set when phase 0 has completed.  One phase only, as the kernels
// use it: a second, a copy before its bytes are expected, or a copy whose
// addresses or size are not multiples of 16 bytes (the card refuses them)
// aborts.
#pragma once
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>

inline void mbar_init(uint64_t* bar, unsigned arrivals) {
  std::atomic_ref<uint64_t>(*bar).store(arrivals);
}

inline void emu_mbar_add(uint64_t* bar, long long arrivals,
                         long long bytes) {
  std::atomic_ref<uint64_t> a(*bar);
  const uint64_t v = a.load();
  const long long arr = static_cast<long long>(v & 0xfffff) - arrivals;
  const long long tx = static_cast<long long>((v >> 20) & 0xffffffffu) + bytes;
  if ((v >> 63) || arr < 0 || tx < 0) std::abort();
  a.store(arr == 0 && tx == 0
              ? uint64_t(1) << 63
              : static_cast<uint64_t>(arr) | static_cast<uint64_t>(tx) << 20);
}

inline void mbar_expect_bytes(uint64_t* bar, unsigned bytes) {
  emu_mbar_add(bar, 1, bytes);
}

inline void bulk_load(void* dst, const void* src, unsigned bytes,
                      uint64_t* bar) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
       bytes) & 15)
    std::abort();
  std::memcpy(dst, src, bytes);
  emu_mbar_add(bar, 0, -static_cast<long long>(bytes));
}

inline void mbar_wait(uint64_t* bar, unsigned parity) {
  if (parity != 0) std::abort();
  while (!(std::atomic_ref<uint64_t>(*bar).load() >> 63))
    std::this_thread::yield();
}
