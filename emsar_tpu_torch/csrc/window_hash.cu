// The SE hash pass of the index build: for every forward window start i in
// [0, n), n = borderpos - rl + 1, the 96-bit identity (three 32-bit hash
// lanes) of the window's canonical 2-bit words and its transcript id.
//
// Replaces emsar_tpu/index/device_build.py::_se_hash_slab together with
// what it calls: _slab_words_packed (window words; rc words and the
// lexicographic fw/rc minimum when unstranded), _p16_range (16-base
// big-endian 2-bit words), _bad_win (non-ACGT test) and _hash3_cols (the
// lanes).  Those are XLA ops, not a Pallas kernel; torch has no fitting op
// (no uint32 add or shift on the CPU, and the int64 form is ~20 passes
// over every row per word, each with its temporaries).
//
//   valid:  no code >= 4 in codes[i, i + rl)  ('@' and '$' are non-ACGT,
//           so no valid window crosses a transcript)
//   words:  fw word w = the bases [i + 16w, i + 16w + nb) with
//           nb = min(16, rl - 16w), 2 bits each, big-endian (a partial
//           last word is the shifted-down 16-base word of the JAX code);
//           rc word w the same at j + 16w, j = seqlength - i - rl;
//           unstranded: the lexicographically smaller of fw and rc
//   lanes:  acc = 0; for each word: acc += word * mult[lane][w];
//           acc ^= (acc >> 16) * 0x85EBCA6B   (uint32 wrap-around)
//   output: h1, h2, h3 as int32 bit patterns and tid = tidf[i]; an invalid
//           window gets all-ones lanes and tid = -1.
//
// What bounds it on the H100: bytes.  One thread per window reads its rl
// codes (twice rl when unstranded) as single bytes; neighbouring threads
// read overlapping windows, so L1 serves almost all of them and device
// memory sees each code byte about once per strand, plus 16 B of output
// per window: ~21 B per window at l76 unstranded, ~7 GB at 338 M windows,
// about 2 ms of HBM time.  The lanes are a few integer multiply-adds per
// word.  Both strands are hashed in the same pass (six accumulators) so
// each code byte is read once per strand.
//
// Layout: codes [L] uint8 (0-3 ACGT, 4 otherwise); tidf [>= n] int32;
// mult [3, 64] uint32; outputs [n] int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWords = 64;  // read lengths up to 1024

__device__ __forceinline__ uint32_t mix(uint32_t acc, uint32_t word,
                                        uint32_t m) {
  acc = acc + word * m;
  return acc ^ ((acc >> 16) * 0x85EBCA6Bu);
}

__global__ void window_hash_kernel(const uint8_t* __restrict__ codes,
                                   const int32_t* __restrict__ tidf,
                                   const uint32_t* __restrict__ mult,
                                   long long n, long long seqlength, int rl,
                                   int unstranded, int32_t* __restrict__ h1,
                                   int32_t* __restrict__ h2,
                                   int32_t* __restrict__ h3,
                                   int32_t* __restrict__ tid) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* fw = codes + i;
  bool valid = true;
  for (int k = 0; k < rl; ++k) {
    if (__ldg(fw + k) >= 4) {
      valid = false;
      break;
    }
  }
  if (!valid) {
    h1[i] = -1;
    h2[i] = -1;
    h3[i] = -1;
    tid[i] = -1;
    return;
  }
  const uint8_t* rc = codes + (seqlength - i - rl);
  uint32_t a0 = 0, a1 = 0, a2 = 0, b0 = 0, b1 = 0, b2 = 0;
  int cmp = 0;
  const int W = (rl + 15) / 16;
  for (int w = 0; w < W; ++w) {
    const int nb = min(16, rl - 16 * w);
    uint32_t f = 0, r = 0;
    for (int k = 0; k < nb; ++k)
      f = (f << 2) | (__ldg(fw + 16 * w + k) & 3u);
    const uint32_t m0 = __ldg(mult + w);
    const uint32_t m1 = __ldg(mult + kMaxWords + w);
    const uint32_t m2 = __ldg(mult + 2 * kMaxWords + w);
    a0 = mix(a0, f, m0);
    a1 = mix(a1, f, m1);
    a2 = mix(a2, f, m2);
    if (unstranded) {
      for (int k = 0; k < nb; ++k)
        r = (r << 2) | (__ldg(rc + 16 * w + k) & 3u);
      if (cmp == 0) cmp = (f > r) - (f < r);
      b0 = mix(b0, r, m0);
      b1 = mix(b1, r, m1);
      b2 = mix(b2, r, m2);
    }
  }
  const bool use_rc = unstranded && cmp > 0;
  h1[i] = static_cast<int32_t>(use_rc ? b0 : a0);
  h2[i] = static_cast<int32_t>(use_rc ? b1 : a1);
  h3[i] = static_cast<int32_t>(use_rc ? b2 : a2);
  tid[i] = tidf[i];
}

}  // namespace

extern "C" int emsar_window_hash(const void* codes, const void* tidf,
                                 const void* mult, long long n,
                                 long long seqlength, int rl, int unstranded,
                                 void* h1, void* h2, void* h3, void* tid,
                                 void* stream) {
  if (n <= 0) return 0;
  if (rl <= 0 || rl > 16 * kMaxWords)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  window_hash_kernel<<<(unsigned int)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(tidf),
      static_cast<const uint32_t*>(mult), n, seqlength, rl, unstranded,
      static_cast<int32_t*>(h1), static_cast<int32_t*>(h2),
      static_cast<int32_t*>(h3), static_cast<int32_t*>(tid));
  return static_cast<int>(cudaGetLastError());
}
