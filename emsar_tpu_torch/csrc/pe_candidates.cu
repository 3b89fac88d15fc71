// The mate2 candidate expansion of the PE index build: for the chunk of
// mate1 members [lo, lo + M) of the rank-sorted members (window start
// spos[j], cluster rank srank[j]) and every fragment-length slot dd in
// [0, nfl), the candidate pairs mate1 at p = spos[j] with the mate2 window
// at q = p + d0 + dd.
//
// Replaces emsar_tpu/index/device_build.py::_pe_cvalid (validity and the
// unstranded pair orientation on ranks), the key/payload packing of
// _pe_expand_sort and the singleton pass _pe_single_chunk.  Those are XLA
// ops, not a Pallas kernel.
//
// A member's tid and next separator come packed in one 8-byte entry,
// tn[p] = nsep[p] << 32 | t32[p] (kernels/pe_candidates.py pack_tables).
//
//   valid:  q <= seqlength - rl, q inside R, R[q] a valid rank
//           (< kBigRank), d0 + dd <= nsep[p] - rl - p (mate2 ends before
//           the separator that ends mate1's transcript), and, unstranded,
//           the canonical pair orientation on ranks:
//           cmp = sign(srank[j] - RF[q]), or sign(R[q] - RF[p]) on a tie;
//           keep cmp <= 0 when p < borderpos, else cmp < 0
//           (reference src/emsar_functions.c:2854-2872)
//   singleton member (srank[j] differs from srank[j - 1] and srank[j + 1],
//           read across the chunk's ends): a valid slot whose mate2 rank
//           appears in no other valid slot of the row adds 1 to
//           single[t32[p] * nfl + dd] (the reference's multi-d drop,
//           src/emsar_functions.c:1926, drops the others); nothing of the
//           row is written
//   other members: each valid candidate is written, in member-major order
//           (the plain version's), key (int64)srank[j] << 30 | R[q] and
//           payload t32[p] << 9 | dd as an int32 bit pattern (t32 < 2^23,
//           nfl <= 512); scratch[1] receives their count
// Every table read is masked against the table's length (no clamping):
// a member outside [0, n_tn) gives tid 0 and no valid candidate; an
// index of single past n_single is dropped; candidates past `capacity`
// are counted, not written.
//
// Design: a thread block takes a tile of members (tile ids from a
// counter, so in launch order), split among its warps: each warp owns up
// to warp_members(nfl) consecutive members (32 at nfl 11, fewer as nfl
// grows) and their member x slot cells, staged in shared memory; a warp
// works on its own segment with no block barrier.  (1) One lane a member
// reads its position and rank (coalesced), then its tn entry, and turns
// nsep into the row's last valid slot.  (2) The warp walks its cells in
// member-major order, neighbouring lanes on neighbouring slots of one
// member, reading R[q] and RF[q] (each member's window one contiguous
// run): kBatch rounds of 32 loads are issued before any is used, and each
// cell's mate2 rank, or -1 where invalid, is staged; the (member, slot) of
// a cell is carried from cell to cell, with no division; RF[p] is read
// only on an orientation tie (srank[j] == RF[q]), which is rare.  The
// tile's count of cells to write is published at once.  (3) Singleton
// rows, a warp-uniform branch per member, put the row's valid ranks
// into the warp's hash table in shared memory (2^lg >= 2 nfl entries,
// linear probing with atomicCAS; a rank met again is marked), then look
// each slot's rank up: an unmarked one counts, with an integer atomicAdd,
// exact in any order.  O(1) expected a slot, exact up to nfl 512.  (4)
// A decoupled look-back over the tiles' published counts gives the tile
// its output offset.  (5) Each warp walks its cells again; ballots and
// popcounts place the written ones.  Three block barriers a tile.
//
// What bounds it on the H100: bytes.  12 B are written per candidate of
// a multi-cluster member; per member it reads spos, srank and tn[p]
// (16 B) and its window of R (and the RF window, and RF[p] on a tie, when
// unstranded).  Members come in rank order, so tn and the windows are
// scattered: the card moves a 32-byte sector (or more) for each 8-byte tn
// entry and one or two for each window, several times the bytes the bound
// counts.  Packing t32 and nsep saves one such sector a member.  A
// look-back costs the tile the wait for its predecessors' counts; a
// block that reserved its output with an atomic instead would not wait,
// but the output order would change from run to run.
//
// Layout: spos, srank [n_members] int32; R, RF [n_rank] int32; tn [n_tn]
// int64; single [n_single] int64; keys [capacity] int64; pay [capacity]
// int32; scratch [2 + tiles] int64, zeroed: the tile counter, the count,
// the tiles' states.  Dynamic shared memory: the tile's cells (int32),
// then a hash table of 2^lg uint32 entries per warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpMembers = 32;
constexpr int kWarpCells = 352;  // 32 members x 11 slots
constexpr int kBatch = 4;        // rounds of a warp's loads in flight
constexpr int kTileMembers = kWarps * kWarpMembers;
constexpr long long kMaxCandidates = 1LL << 30;
constexpr int32_t kBigRank = 0x3FFFFFFF;
// a tile's state: flag in the top two bits (0: not yet, 1: the tile's
// own count, 2: the count of the tile and all before it), count below
constexpr unsigned long long kAggregate = 1ULL << 62;
constexpr unsigned long long kPrefix = 2ULL << 62;
constexpr unsigned long long kCountMask = (1ULL << 62) - 1;
// a hash-table entry: empty, or a rank (< 2^30) with kTwice once it is
// met a second time
constexpr uint32_t kEmpty = 0xffffffffu;
constexpr uint32_t kTwice = 1u << 31;

// members of a warp's segment: at most kWarpCells cells, at least one
// member, at most one per lane
__host__ __device__ inline int warp_members(int nfl) {
  const int w = kWarpCells / nfl;
  return w > kWarpMembers ? kWarpMembers : (w < 1 ? 1 : w);
}

// log2 of a warp's hash-table entries: at least 2 nfl and 32, so that a
// row fills at most half of it
__host__ __device__ inline int table_log2(int nfl) {
  int lg = 5;
  while ((1 << lg) < 2 * nfl) ++lg;
  return lg;
}

// a rank's first probe in a table of 2^lg entries (Fibonacci hashing)
__device__ inline uint32_t slot_hash(uint32_t v, int lg) {
  return (v * 0x9E3779B1u) >> (32 - lg);
}

__device__ inline long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

template <bool kUnstranded>
__global__ void __launch_bounds__(kThreads)
pe_candidates_kernel(const int32_t* __restrict__ spos,
                     const int32_t* __restrict__ srank, long long n_members,
                     long long lo, int M, const int32_t* __restrict__ R,
                     const int32_t* __restrict__ RF, int n_rank,
                     const int64_t* __restrict__ tn, int n_tn, int d0,
                     int nfl, int rl, int borderpos, int seqlength,
                     unsigned long long* __restrict__ single,
                     long long n_single, int64_t* __restrict__ keys,
                     int32_t* __restrict__ pay, long long capacity,
                     unsigned long long* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int32_t s_p[kTileMembers], s_r1[kTileMembers];
  __shared__ int32_t s_tid[kTileMembers], s_rb[kTileMembers];
  __shared__ int32_t s_sng[kTileMembers];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile;
  __shared__ long long s_base;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (t == 0) s_tile = static_cast<int>(atomicAdd(scratch, 1ULL));
  __syncthreads();
  const int tile = s_tile;
  const int wm = warp_members(nfl);
  // the warp's members: tile members [w0, w0 + wn)
  const int w0 = warp * wm;
  const long long first = static_cast<long long>(tile) * kWarps * wm + w0;
  const int wn = static_cast<int>(lmin(wm, first < M ? M - first : 0));
  const int n_cells = wn * nfl;
  int32_t* val = reinterpret_cast<int32_t*>(smem_raw) + w0 * nfl;

  // (1) the warp's members
  if (lane < wn) {
    const long long j = lo + first + lane;
    const int p = __ldg(spos + j);
    const int32_t r1 = __ldg(srank + j);
    const bool sng = (j == 0 || __ldg(srank + j - 1) != r1) &&
                     (j + 1 >= n_members || __ldg(srank + j + 1) != r1);
    int32_t tid = 0, rb = -1;
    if (p >= 0 && p < n_tn) {
      const long long e = __ldg(tn + p);
      tid = static_cast<int32_t>(e & 0xffffffffLL);
      // the last slot inside the sequence, R and mate1's transcript
      long long b = nfl - 1;
      b = lmin(b, static_cast<long long>(seqlength) - rl - p - d0);
      b = lmin(b, static_cast<long long>(n_rank) - 1 - p - d0);
      b = lmin(b, (e >> 32) - rl - p - d0);
      rb = b < -1 ? -1 : static_cast<int32_t>(b);
    }
    s_p[w0 + lane] = p;
    s_r1[w0 + lane] = r1;
    s_tid[w0 + lane] = tid;
    s_rb[w0 + lane] = rb;
    s_sng[w0 + lane] = sng;
  }
  __syncwarp();

  // a lane's cells: lane, lane + 32, ...; (m, dd) carried along
  const int step_m = 32 / nfl, step_dd = 32 - step_m * nfl;
  const int m_first = lane / nfl, dd_first = lane - m_first * nfl;

  // (2) every cell's mate2 rank when valid, else -1; the written ones
  // counted.  kBatch rounds of loads are issued before any is used.
  int written = 0;
  {
    int m = m_first, dd = dd_first;
    for (int c0 = 0; c0 < n_cells; c0 += 32 * kBatch) {
      int k[kBatch];
      int32_t r2[kBatch], rf[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        k[b] = -1;  // no cell
        r2[b] = -1;
        rf[b] = 0;
        if (c0 + 32 * b + lane < n_cells) {
          k[b] = w0 + m;
          if (dd <= s_rb[k[b]]) {
            const int q = s_p[k[b]] + d0 + dd;
            r2[b] = __ldg(R + q);
            if (kUnstranded) rf[b] = __ldg(RF + q);
          }
        }
        m += step_m;
        dd += step_dd;
        if (dd >= nfl) {
          dd -= nfl;
          ++m;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k[b] < 0) continue;
        int32_t v = r2[b] >= 0 && r2[b] < kBigRank ? r2[b] : -1;
        if (kUnstranded && v >= 0) {
          const int32_t r1 = s_r1[k[b]];
          const int p = s_p[k[b]];
          int cmp = (r1 > rf[b]) - (r1 < rf[b]);
          if (cmp == 0) {
            // p < q < n_rank for a valid cell
            const int32_t rfp = __ldg(RF + p);
            cmp = (v > rfp) - (v < rfp);
          }
          if (!(p < borderpos ? cmp <= 0 : cmp < 0)) v = -1;
        }
        val[c0 + 32 * b + lane] = v;
        written += v >= 0 && !s_sng[k[b]];
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    written += __shfl_xor_sync(0xffffffffu, written, o);
  if (lane == 0) s_warp[warp] = written;
  __syncthreads();

  // the tile's count, published at once for the tiles after it
  volatile unsigned long long* state = scratch + 2;
  long long agg = 0;
  for (int w = 0; w < kWarps; ++w) agg += s_warp[w];
  if (t == 0)
    state[tile] = (tile == 0 ? kPrefix : kAggregate) |
                  static_cast<unsigned long long>(agg);

  // (3) singleton rows into single: the row's valid ranks go into the
  // warp's hash table, a rank met twice marked kTwice; a slot counts when
  // its rank is unmarked
  const int lg = table_log2(nfl);
  const uint32_t hmask = (1u << lg) - 1u;
  uint32_t* tab = reinterpret_cast<uint32_t*>(
                      smem_raw + static_cast<size_t>(kWarps) * wm * nfl *
                                     sizeof(int32_t)) +
                  (warp << lg);
  for (int i = 0; i < wn; ++i) {
    const int rb = s_rb[w0 + i];
    if (!s_sng[w0 + i] || rb < 0) continue;
    const int32_t* row = val + i * nfl;
    for (int h = lane; h <= static_cast<int>(hmask); h += 32) tab[h] = kEmpty;
    __syncwarp();
    for (int dd = lane; dd <= rb; dd += 32) {
      const uint32_t v = static_cast<uint32_t>(row[dd]);
      if (row[dd] < 0) continue;
      for (uint32_t h = slot_hash(v, lg);; h = (h + 1) & hmask) {
        const uint32_t old = atomicCAS(tab + h, kEmpty, v);
        if (old == kEmpty) break;
        if ((old & ~kTwice) == v) {
          atomicOr(tab + h, kTwice);
          break;
        }
      }
    }
    __syncwarp();
    const long long at0 = static_cast<long long>(s_tid[w0 + i]) * nfl;
    for (int dd = lane; dd <= rb; dd += 32) {
      const uint32_t v = static_cast<uint32_t>(row[dd]);
      if (row[dd] < 0) continue;
      uint32_t h = slot_hash(v, lg);
      while ((tab[h] & ~kTwice) != v) h = (h + 1) & hmask;
      if (!(tab[h] & kTwice) && at0 + dd < n_single)
        atomicAdd(single + at0 + dd, 1ULL);
    }
    __syncwarp();  // the table is cleared for the next row
  }

  // (4) the tile's output offset: decoupled look-back, one warp
  if (warp == 0) {
    long long excl = 0;
    if (tile > 0) {
      for (int pred = tile - 1;; pred -= 32) {
        const int idx = pred - lane;  // lane 0: the nearest predecessor
        unsigned long long st;
        bool ready;
        do {
          st = kPrefix;  // before tile 0: a prefix of 0
          if (idx >= 0) st = state[idx];
          ready = (st >> 62) != 0;
        } while (!__all_sync(0xffffffffu, ready));
        const unsigned prefixed = __ballot_sync(0xffffffffu, (st >> 62) == 2);
        const int stop = prefixed ? __ffs(prefixed) - 1 : 32;
        long long v =
            lane <= stop ? static_cast<long long>(st & kCountMask) : 0;
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (prefixed) break;
      }
      if (lane == 0)
        state[tile] = kPrefix | static_cast<unsigned long long>(excl + agg);
    }
    if (lane == 0) {
      s_base = excl;
      if (tile == static_cast<int>(gridDim.x) - 1)
        scratch[1] = static_cast<unsigned long long>(excl + agg);
    }
  }
  __syncthreads();

  // (5) the written cells, member-major
  long long out = s_base;
  for (int w = 0; w < warp; ++w) out += s_warp[w];
  int m = m_first, dd = dd_first;
  for (int c = lane; c - lane < n_cells; c += 32) {
    int32_t v = -1;
    if (c < n_cells && !s_sng[w0 + m]) v = val[c];
    const unsigned ball = __ballot_sync(0xffffffffu, v >= 0);
    if (v >= 0) {
      const long long at = out + __popc(ball & ((1u << lane) - 1u));
      if (at < capacity) {
        keys[at] = (static_cast<long long>(s_r1[w0 + m]) << 30) |
                   static_cast<long long>(v);
        pay[at] = static_cast<int32_t>(
            (static_cast<uint32_t>(s_tid[w0 + m]) << 9) |
            static_cast<uint32_t>(dd));
      }
    }
    out += __popc(ball);
    m += step_m;
    dd += step_dd;
    if (dd >= nfl) {
      dd -= nfl;
      ++m;
    }
  }
}

}  // namespace

// int64 entries of the zeroed scratch a launch of M members takes
extern "C" long long emsar_pe_candidates_scratch(long long M, int nfl) {
  if (M <= 0 || nfl <= 0 || nfl > 512) return 2;
  const int tm = kWarps * warp_members(nfl);
  return 2 + (M + tm - 1) / tm;
}

extern "C" int emsar_pe_candidates(
    const void* spos, const void* srank, long long n_members, long long lo,
    long long M, const void* R, const void* RF, long long n_rank,
    const void* tn, long long n_tn, int d0, int nfl, int rl,
    long long borderpos, long long seqlength, int unstranded, void* single,
    long long n_single, void* keys, void* pay, long long capacity,
    void* scratch, void* stream) {
  if (M <= 0) return 0;
  if (nfl <= 0 || nfl > 512 || rl <= 0 || rl > 1024 || d0 < 0 ||
      d0 > 0x7fffffff - 512 || lo < 0 || M > kMaxCandidates ||
      lo + M > n_members || n_members > 0x7fffffffLL || capacity < 0 ||
      capacity > kMaxCandidates || n_tn > 0x7fffffffLL ||
      n_rank > n_tn || seqlength >= n_tn ||
      borderpos > 0x7fffffffLL || (unstranded && RF == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tm = kWarps * warp_members(nfl);
  const long long tiles = (M + tm - 1) / tm;
  const size_t smem =
      (static_cast<size_t>(tm) * nfl + (static_cast<size_t>(kWarps)
                                        << table_log2(nfl))) *
      sizeof(int32_t);
  auto kernel = unstranded ? pe_candidates_kernel<true>
                           : pe_candidates_kernel<false>;
  // past nfl ~256 the tables and the static arrays pass the 48 KB a block
  // may take without opting in
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(spos), static_cast<const int32_t*>(srank),
      n_members, lo, static_cast<int>(M), static_cast<const int32_t*>(R),
      static_cast<const int32_t*>(RF), static_cast<int>(n_rank),
      static_cast<const int64_t*>(tn), static_cast<int>(n_tn), d0, nfl, rl,
      static_cast<int>(borderpos), static_cast<int>(seqlength),
      static_cast<unsigned long long*>(single), n_single,
      static_cast<int64_t*>(keys), static_cast<int32_t*>(pay), capacity,
      static_cast<unsigned long long*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
