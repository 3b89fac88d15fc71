// The mate2 candidate expansion of the PE index build: for a chunk of M
// mate1 members (window start mpos[m], cluster rank mrank[m]) and every
// fragment-length slot dd in [0, nfl), the candidate pairs mate1 at
// p = mpos[m] with the mate2 window at q = p + d0 + dd.
//
// Replaces emsar_tpu/index/device_build.py::_pe_cvalid (validity and the
// unstranded pair orientation on ranks) and the key/payload packing of
// _pe_expand_sort (which _pe_stream_gen computes too).  Those are XLA ops,
// not a Pallas kernel; as torch ops they are ~15-20 launches per dd row,
// each writing a chunk-sized temporary.
//
//   valid:  q <= seqlength - rl, q inside R, R[q] a valid rank
//           (< kBigRank), d0 + dd <= nsep[p] - rl - p (mate2 ends before
//           the separator that ends mate1's transcript), and, unstranded,
//           the canonical pair orientation on ranks:
//           cmp = sign(mrank[m] - RF[q]), or sign(R[q] - RF[p]) on a tie;
//           keep cmp <= 0 when p < borderpos, else cmp < 0
//           (reference src/emsar_functions.c:2854-2872)
//   keys:   (int64)mrank[m] << 30 | R[q] when valid, else INT64_MAX (sorts
//           last); ranks are < 2^30
//   pay:    t32[p] << 9 | dd as an int32 bit pattern (t32 < 2^23,
//           nfl <= 512)
// Every table read is masked against the table's length (no clamping):
// a member outside [0, n_t32) or [0, n_nsep) gives tid 0 or no valid
// candidate.
//
// Design: one thread per candidate, c = m * nfl + dd, in a grid-stride
// loop.  Neighbouring threads take neighbouring dd of one member, so their
// R[q] and RF[q] reads are one contiguous run of nfl entries per member,
// and the outputs are written fully coalesced.  A launch takes at most
// 2^30 candidates, so all index arithmetic is 32-bit.
//
// What bounds it on the H100: bytes.  12 B are written per candidate
// (key and payload); per member it reads mpos, mrank, t32[p] and nsep[p]
// (16 B) and its window of R (and RF when unstranded), which overlaps the
// windows of members at nearby positions.  A chunk of the scale build
// (positions sorted by rank, so scattered) reads each member's R window
// as one or two 32-byte sectors.  The integer work, ~20 operations a
// candidate, is far below the card's issue rate.
//
// Layout: mpos, mrank [M] int32; R, RF [n_rank] int32; t32 [n_t32] int32;
// nsep [n_nsep] int32; keys [M * nfl] int64; pay [M * nfl] int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 64;
// candidates per launch: c + the grid's stride stays below 2^31
constexpr long long kMaxCandidates = 1LL << 30;
constexpr int32_t kBigRank = 0x3FFFFFFF;
constexpr long long kInvalidKey = 0x7FFFFFFFFFFFFFFFLL;

__global__ void __launch_bounds__(kThreads)
pe_candidates_kernel(const int32_t* __restrict__ mpos,
                     const int32_t* __restrict__ mrank, int total,
                     const int32_t* __restrict__ R,
                     const int32_t* __restrict__ RF, int n_rank,
                     const int32_t* __restrict__ t32, int n_t32,
                     const int32_t* __restrict__ nsep, int n_nsep, int d0,
                     int nfl, int rl, int borderpos, int seqlength,
                     int unstranded, int64_t* __restrict__ keys,
                     int32_t* __restrict__ pay) {
  const int stride = gridDim.x * blockDim.x;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < total;
       c += stride) {
    const int m = c / nfl;
    const int dd = c - m * nfl;
    const int p = __ldg(mpos + m);
    const int32_t r1 = __ldg(mrank + m);
    const int32_t tid = (p >= 0 && p < n_t32) ? __ldg(t32 + p) : 0;
    pay[c] = static_cast<int32_t>((static_cast<uint32_t>(tid) << 9) |
                                  static_cast<uint32_t>(dd));
    long long key = kInvalidKey;
    const int d = d0 + dd;  // the launcher keeps d0 + nfl below 2^31
    const long long q = static_cast<long long>(p) + d;
    if (p >= 0 && p < n_nsep && q <= seqlength - rl && q < n_rank) {
      const int32_t r2 = __ldg(R + q);
      if (r2 >= 0 && r2 < kBigRank &&
          static_cast<long long>(d) <=
              static_cast<long long>(__ldg(nsep + p)) - rl - p) {
        bool keep = true;
        if (unstranded) {
          const int32_t rfq = __ldg(RF + q);
          int cmp = (r1 > rfq) - (r1 < rfq);
          if (cmp == 0) {
            const int32_t rfp = p < n_rank ? __ldg(RF + p) : kBigRank;
            cmp = (r2 > rfp) - (r2 < rfp);
          }
          keep = p < borderpos ? cmp <= 0 : cmp < 0;
        }
        if (keep)
          key = (static_cast<long long>(r1) << 30) |
                static_cast<long long>(r2);
      }
    }
    keys[c] = key;
  }
}

}  // namespace

extern "C" int emsar_pe_candidates(
    const void* mpos, const void* mrank, long long M, const void* R,
    const void* RF, long long n_rank, const void* t32, long long n_t32,
    const void* nsep, long long n_nsep, int d0, int nfl, int rl,
    long long borderpos, long long seqlength, int unstranded, void* keys,
    void* pay, void* stream) {
  if (M <= 0) return 0;
  if (nfl <= 0 || nfl > 512 || rl <= 0 || rl > 1024 || d0 < 0 ||
      d0 > 0x7fffffff - 512 || M * nfl > kMaxCandidates ||
      n_nsep > 0x7fffffffLL || n_rank > n_nsep || n_t32 > n_nsep ||
      seqlength >= n_nsep || (unstranded && RF == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = static_cast<int>(M * nfl);
  const int want = (total + kThreads - 1) / kThreads;
  const int blocks = want < kMaxBlocks ? want : kMaxBlocks;
  pe_candidates_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mpos), static_cast<const int32_t*>(mrank),
      total, static_cast<const int32_t*>(R),
      static_cast<const int32_t*>(RF), static_cast<int>(n_rank),
      static_cast<const int32_t*>(t32), static_cast<int>(n_t32),
      static_cast<const int32_t*>(nsep), static_cast<int>(n_nsep), d0, nfl,
      rl, static_cast<int>(borderpos), static_cast<int>(seqlength),
      unstranded, static_cast<int64_t*>(keys), static_cast<int32_t*>(pay));
  return static_cast<int>(cudaGetLastError());
}
