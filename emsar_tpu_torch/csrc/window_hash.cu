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
// Design: a thread block owns a tile of kTile consecutive window starts
// [i0, i0 + kTile).  It stages the bytes its windows read, forward
// [i0, i0 + kTile + rl - 1) and, when unstranded, the rc stretch
// [seqlength - i0 - kTile - rl + 1, seqlength - i0) (window i + 1's rc
// bases start one before window i's, so the stretch is contiguous), with
// aligned 16-byte loads, and packs each 16 bytes into one big-endian
// 2-bit word and a 16-bit mask of its non-ACGT codes, in shared memory.
// Any 16-base word at offset p is then one funnel shift of the packed
// words p / 16 and p / 16 + 1, so a window costs ceil(rl / 16) shifts per
// strand instead of rl byte loads.  Validity is O(1): an exclusive prefix
// count of non-ACGT codes per packed word (one block scan) and a popcount
// of the word's mask below p give pre(p), and the window is valid iff
// pre(i + rl) = pre(i).  Unstranded, the fw/rc order is decided on the
// words alone (almost always by word 0) and only the chosen strand is
// hashed.  Threads take windows i0 + t, i0 + t + 256, ... so the lanes of
// a warp read neighbouring words (shared-memory broadcasts) and write
// neighbouring outputs.
//
// What bounds it on the H100: bytes.  Each code byte is read from device
// memory about once per strand (plus a halo of rl - 1 bytes per 2048
// windows), tidf once, and 16 B are written per window: ~22 B a window
// at l76 unstranded, ~7.4 GB at 337 M windows, ~2.2 ms at 3.35 TB/s; a
// stranded run stages no rc code, ~21 B a window, ~2.1 ms.  The
// lanes are ~60 integer operations a window at l76 (5 words x 3 lanes x a
// multiply-add, a shift, a multiply and an xor), about 1 ms of issue at
// 337 M windows on 132 SMs.
//
// Layout: codes [L] uint8 (0-3 ACGT, 4 otherwise); tidf [>= n] int32;
// mult [3, 64] uint32; outputs [n] int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWords = 64;  // read lengths up to 1024
constexpr int kThreads = 256;
constexpr int kTile = 2048;  // window starts per block
// packed words of a staged stretch: bytes [g - mis, g + kTile + rl - 1)
// rounded up, and the word after the last for the funnel shift
constexpr int kStageWords = (15 + kTile + 16 * kMaxWords - 2) / 16 + 2;
static_assert(kStageWords <= kThreads, "one packed word per thread");
static_assert(kTile % kThreads == 0, "whole windows per thread");

__device__ __forceinline__ uint32_t mix(uint32_t acc, uint32_t word,
                                        uint32_t m) {
  acc = acc + word * m;
  return acc ^ ((acc >> 16) * 0x85EBCA6Bu);
}

// 16 codes (byte k of `u` is base k) as a big-endian 2-bit word and a mask
// with bit k set where base k is not ACGT.
__device__ __forceinline__ void pack16(uint4 u, uint32_t& word,
                                       uint32_t& bad) {
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
  word = 0;
  bad = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t c = (v[q] >> (8 * k)) & 0xFFu;
      word = (word << 2) | (c & 3u);
      bad |= static_cast<uint32_t>(c >= 4) << (4 * q + k);
    }
  }
}

// Stage codes[g - mis, g - mis + 16 * nw) as nw packed words into P (and
// the non-ACGT masks into bad, when given), where mis aligns the start to
// 16 bytes; bytes outside [0, L) count as non-ACGT.  Returns mis: base
// g + x sits at position mis + x of the packed stretch.
__device__ int stage(const uint8_t* __restrict__ codes, long long L,
                     long long g, int nw, uint32_t* P, uint32_t* bad) {
  const int mis =
      static_cast<int>((reinterpret_cast<uintptr_t>(codes) +
                        static_cast<uintptr_t>(g)) & 15u);
  const long long a0 = g - mis;
  for (int q = threadIdx.x; q < nw; q += blockDim.x) {
    const long long s = a0 + 16LL * q;
    uint4 u;
    if (s >= 0 && s + 16 <= L) {
      u = __ldg(reinterpret_cast<const uint4*>(codes + s));
    } else {
      uint32_t v[4] = {0, 0, 0, 0};
      for (int k = 0; k < 16; ++k) {
        const uint32_t c = (s + k >= 0 && s + k < L) ? codes[s + k] : 4u;
        v[k >> 2] |= c << (8 * (k & 3));
      }
      u = make_uint4(v[0], v[1], v[2], v[3]);
    }
    uint32_t w, b;
    pack16(u, w, b);
    P[q] = w;
    if (bad) bad[q] = b;
  }
  return mis;
}

// The nb-base word at position pos of a packed stretch.
__device__ __forceinline__ uint32_t word_at(const uint32_t* P, int pos,
                                            int nb) {
  const uint32_t w =
      __funnelshift_l(P[(pos >> 4) + 1], P[pos >> 4], 2 * (pos & 15));
  return nb == 16 ? w : w >> (2 * (16 - nb));
}

__global__ void __launch_bounds__(kThreads)
window_hash_kernel(const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ tidf,
                   const uint32_t* __restrict__ mult, long long n,
                   long long seqlength, int rl, int unstranded,
                   int32_t* __restrict__ h1, int32_t* __restrict__ h2,
                   int32_t* __restrict__ h3, int32_t* __restrict__ tid) {
  __shared__ uint32_t pf[kStageWords], pr[kStageWords];
  __shared__ uint32_t bad[kStageWords], pre[kStageWords];
  __shared__ uint32_t mul[3][kMaxWords];
  __shared__ uint32_t warp_total[kThreads / 32];

  const long long i0 = static_cast<long long>(blockIdx.x) * kTile;
  const int W = (rl + 15) / 16;
  const int nw = (15 + kTile + rl - 2) / 16 + 2;
  for (int k = threadIdx.x; k < 3 * W; k += blockDim.x)
    mul[k / W][k % W] = __ldg(mult + (k / W) * kMaxWords + k % W);
  const int mf = stage(codes, seqlength + 1, i0, nw, pf, bad);
  const int mr = unstranded ? stage(codes, seqlength + 1,
                                    seqlength - i0 - kTile - rl + 1, nw, pr,
                                    nullptr)
                            : 0;
  __syncthreads();

  // pre[q]: the non-ACGT codes of the forward stretch before word q
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t v = threadIdx.x < nw ? __popc(bad[threadIdx.x]) : 0u;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  uint32_t off = 0;
  for (int w = 0; w < warp; ++w) off += warp_total[w];
  if (threadIdx.x < nw) pre[threadIdx.x] = off + incl - v;
  __syncthreads();

  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const long long i = i0 + k;
    if (i >= n) break;
    const int p = mf + k;
    const int e = p + rl;
    const uint32_t before = pre[p >> 4] +
                            __popc(bad[p >> 4] & ((1u << (p & 15)) - 1u));
    const uint32_t upto = pre[e >> 4] +
                          __popc(bad[e >> 4] & ((1u << (e & 15)) - 1u));
    if (upto != before) {
      h1[i] = -1;
      h2[i] = -1;
      h3[i] = -1;
      tid[i] = -1;
      continue;
    }
    const uint32_t* P = pf;
    int pos = p;
    if (unstranded) {
      const int q = mr + kTile - 1 - k;
      for (int w = 0; w < W; ++w) {
        const int nb = min(16, rl - 16 * w);
        const uint32_t f = word_at(pf, p + 16 * w, nb);
        const uint32_t r = word_at(pr, q + 16 * w, nb);
        if (f != r) {
          if (f > r) {
            P = pr;
            pos = q;
          }
          break;
        }
      }
    }
    uint32_t a0 = 0, a1 = 0, a2 = 0;
    for (int w = 0; w < W; ++w) {
      const uint32_t word = word_at(P, pos + 16 * w, min(16, rl - 16 * w));
      a0 = mix(a0, word, mul[0][w]);
      a1 = mix(a1, word, mul[1][w]);
      a2 = mix(a2, word, mul[2][w]);
    }
    h1[i] = static_cast<int32_t>(a0);
    h2[i] = static_cast<int32_t>(a1);
    h3[i] = static_cast<int32_t>(a2);
    tid[i] = __ldg(tidf + i);
  }
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
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  window_hash_kernel<<<(unsigned int)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(tidf),
      static_cast<const uint32_t*>(mult), n, seqlength, rl, unstranded,
      static_cast<int32_t*>(h1), static_cast<int32_t*>(h2),
      static_cast<int32_t*>(h3), static_cast<int32_t*>(tid));
  return static_cast<int>(cudaGetLastError());
}
