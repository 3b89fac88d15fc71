// Bulk copies from device memory into a block's shared memory by the
// Tensor Memory Accelerator (cp.async.bulk), and the shared-memory
// barrier (mbarrier) that reports their completion, for sm_90.
//
//   if (threadIdx.x == 0) mbar_init(bar, 1);
//   __syncthreads();
//   if (threadIdx.x == 0) {
//     mbar_expect_bytes(bar, bytes);        // the one arrival, and the bytes
//     bulk_load(dst, src, bytes, bar);      // to come (one copy or several)
//   }
//   ...                                     // other work meanwhile
//   mbar_wait(bar, 0);                      // phase 0 complete: dst is there
//
// A copy's addresses and size are multiples of 16 bytes; a phase counts
// fewer than 2^20 bytes.  The barrier is 8 bytes of shared memory, 8-byte
// aligned.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Make the barrier expect ``arrivals`` arrivals a phase; visible to the
// cluster's async proxy (the copies) once the fence is passed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, and ``bytes`` more to come by copies before the phase ends.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar,
                                                  unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Copy ``bytes`` from device memory at ``src`` to this block's shared
// memory at ``dst``; the barrier counts them when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
