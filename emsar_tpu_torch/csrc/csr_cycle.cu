// The vector work of one stabilized SQUAREM cycle of the CSR EM solver
// (model/solver.py::_squarem_cycle_launches) and of the end of a block
// (model/solver.py::_squarem_block: em_solve, parallel/mesh.py::
// solve_sharded), rows r < R of theta [R, T] and of the intensities
// [R, C]:
//
//   pair_gain: the intensities of t2 and of cand (segment sums of mult *
//     theta[:, tid] by cid, both in one pass over the edges) and the
//     likelihood gain term of each segment (model/solver.py::gain_of
//     before its sum):
//       term = both > 0 ? reads * log1p((s_new - s_old) / s_old)
//                       : (born - died) * 1e30
//       out  = term - eumaps * (s_new - s_old)
//     and, in a block's last cycle, both intensities written out;
//   block_end: from the last cycle's gain [R] (the row sum of its terms),
//     cand, t2 and their intensities: theta = gain[r] >= 0 ? cand : t2 (the
//     accept), its intensities picked the same way, and their gain terms
//     over the previous block's intensities s_prev (the block's gain
//     before its sum); no pass over the edges;
//   cycle_extrap and cycle_select:
//       alpha  = sqrt(vv) > 0 ? -sqrt(rr) / sqrt(vv) : -1, at most -1
//       extrap = (theta - (2 alpha) r) + (alpha alpha) v
//       x      = extrap > 0 ? extrap : t2      (the third EM step's input)
//       theta  = gain[r] >= 0 ? cand : t2      (the accept, the next
//                                               cycle's theta)
//
// They replace the elementwise XLA ops of
// emsar_tpu/model/solver.py::_em_solve's squarem_cycle (:150), gain_of
// (:134) and the block's gain under the lax.while_loop (:181): on the card,
// some 60 small torch kernels a cycle.  With the EM steps
// (csrc/segment_sum.cu, mode 3 writing r * r and v * v) and the three row
// sums, which stay torch.sum over the tensors the torch body reduces, a
// cycle is twelve launches; a block ends with one block_end.  On
// thread-block clusters (csrc/csr_cluster.cu) a cycle is five launches and
// the block ends with the same block_end, the intensities from
// cluster_extrap_gain's pass 3.
//
// Bits.  Every product, quotient, difference and root is rounded on its
// own (the _rn intrinsics: nvcc contracts no FMA here), in torch's order
// of evaluation, so each output equals the torch body's on the same
// inputs.  Comparisons are IEEE's: false for NaN, so a NaN intensity
// makes both, died and born false, and a NaN gain takes t2;
// clamp(alpha, max=-1) keeps a NaN alpha as torch.clamp does; a read-less
// segment whose ratio rounds to -1 gives reads * log1p(-1) = 0 * -inf =
// NaN, as torch does (the NaN block gain that stops a solve).  log1p is
// CUDA's, the function torch's own CUDA kernel calls.  The intensities
// fold the products of a segment in edge order from 0, as
// csrc/segment_sum.cu does: the bits of sum_groups.  So block_end's
// intensities are those the block's old pass over the edges summed from
// the accepted theta: the accept takes one whole row, cand's or t2's, and
// each was folded in that order.
//
// pair_gain's design.  A block takes a tile of consecutive segments (the
// grouping's tiles, kernels/segment_sum.py::tile_bounds: at most kTile
// segments, and fewer than kTile edges before the last; its group and
// edge bounds read at once) and one row.  Its segments' edges are
// contiguous: a thread an edge loads its tid and weight (coalesced) and
// computes both products, every gather of t2[tid] and cand[tid] in
// flight at once, into shared memory, while the threads also load the
// tile's reads and eumaps; then a thread a segment folds them from there
// in edge order and writes the gain term once.  A tile's edges beyond
// kStaged (a segment of very many edges) are read from device memory by
// the folding thread, in the same order.  Every launch of this path is
// one grid, so no block waits on another.  Built with EMSAR_PAIR_TMA=1,
// the tile's tids, weights and group ends come into shared memory first
// by TMA bulk copies onto an mbarrier (csrc/bulk_copy.cuh; the ends of
// their 16-byte lines by the threads) while the threads load reads and
// eumaps: the staging of csrc/csr_cluster.cu.  On the H100 it was 6-44%
// slower than the direct loads at every shape measured, from a cold L2
// (bench/pair_parts.py, which also times tiles of 256 and 128 segments:
// 256 ~8% faster at R 1, 14-35% slower at every other shape), so the
// default build loads directly, in tiles of 512.
//
// What bounds it on the H100: bytes, and in practice latency.  At the
// smoke workload's CSR shape (R 1, f64; 27,619 segments, 89,744 edges,
// 12,090 transcripts) pair_gain moves ~2.1 MB (the by-cid edges, two
// thetas, reads, eumaps, the terms), block_end ~1.5 MB (three vectors of
// C, two of T read, two of C and one of T written) and no edge:
// ~1.1 us together at 3.35 TB/s against a few us of launch each.
//
// Layout: theta, t1, t2, cand, x and out [R, T] contiguous; rsum, vsum and
// gain [R]; w [E]; idx [E] int32; offsets [G + 1] int64; tiles [2, n_tiles
// + 1] int64 (the tiles' group bounds, then their edge bounds); reads and
// eumaps [G] (a_stride 0) or [R, G] (a_stride G); s_t2, s_cand, s_prev,
// s_out and the terms [R, G].  float or double.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef EMSAR_PAIR_TILE
#define EMSAR_PAIR_TILE 512
#endif
#ifndef EMSAR_PAIR_THREADS
#define EMSAR_PAIR_THREADS 256
#endif
// 1: pair_gain stages its tile's group ends, weights and tids by TMA bulk
// copies (bench/pair_parts.py builds it to time against the default 0)
#ifndef EMSAR_PAIR_TMA
#define EMSAR_PAIR_TMA 0
#endif
#if EMSAR_PAIR_TMA
#include "bulk_copy.cuh"
#endif

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float log1p_of(float a) { return log1pf(a); }
__device__ __forceinline__ double log1p_of(double a) { return log1p(a); }

constexpr int kThreads = 256;
// pair_gain: a tile's segments at most (the tiles' tile size at most), the
// edges of a tile staged, and the threads of its block
constexpr int kTile = EMSAR_PAIR_TILE;
constexpr int kStaged = 2 * kTile;
constexpr int kTileThreads = EMSAR_PAIR_THREADS;

// the gain term of one segment (gain_of's, before the sum over segments)
template <typename F>
__device__ __forceinline__ F gain_term(F reads, F eumaps, F s_old, F s_new) {
  const bool both = s_old > F(0) && s_new > F(0);
  const F d = sub_rn(s_new, s_old);
  const F ratio = log1p_of(both ? div_rn(d, s_old) : F(0));
  const bool died = s_old > F(0) && s_new <= F(0) && reads > F(0);
  const bool born = s_old <= F(0) && s_new > F(0) && reads > F(0);
  const F term = both ? mul_rn(reads, ratio)
                      : mul_rn(sub_rn(F(born), F(died)), F(1e30));
  return sub_rn(term, mul_rn(eumaps, d));
}

// pair_gain's shared memory, bytes from its start: reads and eumaps (kTile
// each), the two products (kStaged each); with EMSAR_PAIR_TMA the staged
// tids, weights and group ends (each with a 16-byte line's slack) and the
// copies' barrier
template <typename F>
struct TileSmem {
  static constexpr int rd = 0;
  static constexpr int eu = rd + int(sizeof(F)) * kTile;
  static constexpr int prod = eu + int(sizeof(F)) * kTile;
#if EMSAR_PAIR_TMA
  static constexpr int ids = prod + 2 * int(sizeof(F)) * kStaged;
  static constexpr int ws = ids + 4 * (kStaged + 4);
  static constexpr int ends = ws + int(sizeof(F)) * (kStaged + 4);
  static constexpr int bar = ends + 8 * (kTile + 4);
  static constexpr int bytes = bar + 16;
#else
  static constexpr int bytes = prod + 2 * int(sizeof(F)) * kStaged;
#endif
};

// a tile's tid, weight or group end: from shared memory where staged
// there (EMSAR_PAIR_TMA), else from device memory
template <typename T>
__device__ __forceinline__ T staged_at(const T* p) {
#if EMSAR_PAIR_TMA
  return *p;
#else
  return __ldg(p);
#endif
}

#if EMSAR_PAIR_TMA
// Elements [lo, hi) of a device array a as staged in shared memory s:
// s[head + k] = a[lo + k], s 16-byte aligned, head the elements of a
// before lo in lo's 16-byte line; [b0, b1) the 16-byte aligned interior
// (elements of a) that comes by one bulk copy, the rest by the threads.
template <typename T>
struct Lines {
  int head;
  long long b0, b1;
  __device__ Lines(const T* a, long long lo, long long hi) {
    constexpr int per = 16 / int(sizeof(T));
    head = static_cast<int>((reinterpret_cast<uintptr_t>(a + lo) & 15) /
                            sizeof(T));
    b0 = head ? lo - head + per : lo;
    b1 = lo - head + (hi - lo + head) / per * per;
    if (b1 < b0) b1 = b0;
  }
  __device__ unsigned bytes() const {
    return static_cast<unsigned>(b1 - b0) * unsigned(sizeof(T));
  }
  // thread 0, after the barrier expects the bytes
  __device__ void copy(T* s, const T* a, long long lo, uint64_t* bar) const {
    if (b1 > b0) bulk_load(s + head + (b0 - lo), a + b0, bytes(), bar);
  }
  // every thread: the elements outside the interior
  __device__ void load_rest(T* s, const T* a, long long lo,
                            long long hi) const {
    const long long h = b0 < hi ? b0 : hi;
    for (long long k = lo + threadIdx.x; k < h; k += kTileThreads)
      s[head + (k - lo)] = __ldg(a + k);
    for (long long k = (b1 > h ? b1 : h) + threadIdx.x; k < hi;
         k += kTileThreads)
      s[head + (k - lo)] = __ldg(a + k);
  }
};
#endif

// A block per (row, tile): both intensities of the tile's segments and
// their gain terms; with s_t2_out, both intensities written too.
template <typename F>
__global__ void __launch_bounds__(kTileThreads)
    pair_gain_kernel(const F* __restrict__ x_old, const F* __restrict__ x_new,
                     const F* __restrict__ w, const int32_t* __restrict__ idx,
                     const int64_t* __restrict__ offsets,
                     const int64_t* __restrict__ tiles,
                     const F* __restrict__ reads,
                     const F* __restrict__ eumaps, F* __restrict__ s_old_out,
                     F* __restrict__ s_new_out, F* __restrict__ out,
                     long long G, long long N, long long a_stride,
                     long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using L = TileSmem<F>;
  const long long r = blockIdx.x / n_tiles;
  const long long tile = blockIdx.x - r * n_tiles;
  const long long s0 = __ldg(tiles + tile);
  const int ns = static_cast<int>(__ldg(tiles + tile + 1) - s0);
  const long long e0 = __ldg(tiles + n_tiles + 1 + tile);
  const long long m = __ldg(tiles + n_tiles + 2 + tile) - e0;
  if (ns <= 0) return;  // a tile inside one long segment's edges
  const int staged = m < kStaged ? static_cast<int>(m) : kStaged;
  F* rd = reinterpret_cast<F*>(smem_raw + L::rd);
  F* eu = reinterpret_cast<F*>(smem_raw + L::eu);
#if EMSAR_PAIR_TMA
  int32_t* s_ids = reinterpret_cast<int32_t*>(smem_raw + L::ids);
  F* s_ws = reinterpret_cast<F*>(smem_raw + L::ws);
  int64_t* s_ends = reinterpret_cast<int64_t*>(smem_raw + L::ends);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + L::bar);
  const Lines<int32_t> li(idx, e0, e0 + staged);
  const Lines<F> lw(w, e0, e0 + staged);
  const Lines<int64_t> le(offsets, s0, s0 + ns + 1);
  if (threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_bytes(bar, li.bytes() + lw.bytes() + le.bytes());
    li.copy(s_ids, idx, e0, bar);
    lw.copy(s_ws, w, e0, bar);
    le.copy(s_ends, offsets, s0, bar);
  }
  li.load_rest(s_ids, idx, e0, e0 + staged);
  lw.load_rest(s_ws, w, e0, e0 + staged);
  le.load_rest(s_ends, offsets, s0, s0 + ns + 1);
#endif
  const long long a0 = r * a_stride + s0;
  for (int i = threadIdx.x; i < ns; i += kTileThreads) {
    rd[i] = __ldg(reads + a0 + i);
    eu[i] = __ldg(eumaps + a0 + i);
  }
  const F* xo = x_old + r * N;
  const F* xn = x_new + r * N;
  F* prod = reinterpret_cast<F*>(smem_raw + L::prod);
#if EMSAR_PAIR_TMA
  mbar_wait(bar, 0);
  __syncthreads();  // the threads' ends of the lines
  const int32_t* ids = s_ids + li.head;
  const F* ws = s_ws + lw.head;
  const int64_t* ends = s_ends + le.head;
#else
  const int32_t* ids = idx + e0;
  const F* ws = w + e0;
  const int64_t* ends = offsets + s0;
#endif
  for (int e = threadIdx.x; e < staged; e += kTileThreads) {
    const int32_t j = staged_at(ids + e);
    const F we = staged_at(ws + e);
    prod[e] = mul_rn(we, __ldg(xo + j));
    prod[kStaged + e] = mul_rn(we, __ldg(xn + j));
  }
  __syncthreads();  // the products, reads and eumaps
  for (int i = threadIdx.x; i < ns; i += kTileThreads) {
    F acc_old = F(0), acc_new = F(0);
    const long long b1 = staged_at(ends + i + 1) - e0;
    for (long long e = staged_at(ends + i) - e0; e < b1; ++e) {
      F po, pn;
      if (e < staged) {
        po = prod[e];
        pn = prod[kStaged + e];
      } else {  // past the staged edges: from device memory
        const F we = __ldg(w + e0 + e);
        const int32_t j = __ldg(idx + e0 + e);
        po = mul_rn(we, __ldg(xo + j));
        pn = mul_rn(we, __ldg(xn + j));
      }
      acc_old = add_rn(acc_old, po);
      acc_new = add_rn(acc_new, pn);
    }
    const long long o = r * G + s0 + i;
    if (s_old_out != nullptr) {
      s_old_out[o] = acc_old;
      s_new_out[o] = acc_new;
    }
    out[o] = gain_term(rd[i], eu[i], acc_old, acc_new);
  }
}

// A thread per (row, k < max(C, T)): theta[r, k] for k < T, and for k < C
// the picked intensity and, with s_prev, its gain term.
template <typename F>
__global__ void __launch_bounds__(kThreads)
    block_end_kernel(const F* __restrict__ gain, const F* __restrict__ cand,
                     const F* __restrict__ t2, const F* __restrict__ s_t2,
                     const F* __restrict__ s_cand,
                     const F* __restrict__ s_prev,
                     const F* __restrict__ reads,
                     const F* __restrict__ eumaps, F* __restrict__ theta,
                     F* __restrict__ s_out, F* __restrict__ terms,
                     long long R, long long C, long long T,
                     long long a_stride) {
  const long long W = C > T ? C : T;
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= R * W) return;
  const long long r = i / W;
  const long long k = i - r * W;
  const bool take = __ldg(gain + r) >= F(0);
  if (k < T) {
    const long long o = r * T + k;
    theta[o] = take ? __ldg(cand + o) : __ldg(t2 + o);
  }
  if (k < C) {
    const long long o = r * C + k;
    const F s = take ? __ldg(s_cand + o) : __ldg(s_t2 + o);
    s_out[o] = s;
    if (s_prev != nullptr) {
      const long long a = r * a_stride + k;
      terms[o] = gain_term(__ldg(reads + a), __ldg(eumaps + a),
                           __ldg(s_prev + o), s);
    }
  }
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    cycle_extrap_kernel(const F* __restrict__ theta,
                        const F* __restrict__ t1, const F* __restrict__ t2,
                        const F* __restrict__ rsum,
                        const F* __restrict__ vsum, F* __restrict__ out,
                        long long R, long long T) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= R * T) return;
  const long long row = i / T;
  const F rn = sqrt_rn(__ldg(rsum + row));
  const F vn = sqrt_rn(__ldg(vsum + row));
  F alpha = vn > F(0) ? div_rn(-rn, vn) : F(-1);
  if (!(alpha != alpha) && !(alpha < F(-1))) alpha = F(-1);  // NaN stays
  const F th = __ldg(theta + i), a = __ldg(t1 + i), b = __ldg(t2 + i);
  const F r = sub_rn(a, th);
  const F v = sub_rn(sub_rn(b, a), r);
  const F ex = add_rn(sub_rn(th, mul_rn(mul_rn(F(2), alpha), r)),
                      mul_rn(mul_rn(alpha, alpha), v));
  out[i] = ex > F(0) ? ex : b;
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    cycle_select_kernel(const F* __restrict__ gain,
                        const F* __restrict__ cand, const F* __restrict__ t2,
                        F* __restrict__ out, long long R, long long T) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= R * T) return;
  out[i] = __ldg(gain + i / T) >= F(0) ? __ldg(cand + i) : __ldg(t2 + i);
}

long long blocks_for(long long threads) {
  return (threads + kThreads - 1) / kThreads;
}

template <typename F>
int launch_pair(const void* x_old, const void* x_new, const void* w,
                const void* idx, const void* offsets, const void* tiles,
                const void* reads, const void* eumaps, void* s_old_out,
                void* s_new_out, void* out, long long R, long long G,
                long long N, long long a_stride, long long n_tiles, int tile,
                void* stream) {
  if (R * G <= 0) return 0;
  const long long blocks = R * n_tiles;
  if (n_tiles <= 0 || tile < 1 || tile > kTile || blocks > 0x7fffffffLL ||
      (s_old_out == nullptr) != (s_new_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  pair_gain_kernel<F><<<static_cast<unsigned>(blocks), kTileThreads,
                        TileSmem<F>::bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const F*>(x_old), static_cast<const F*>(x_new),
      static_cast<const F*>(w), static_cast<const int32_t*>(idx),
      static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(tiles), static_cast<const F*>(reads),
      static_cast<const F*>(eumaps), static_cast<F*>(s_old_out),
      static_cast<F*>(s_new_out), static_cast<F*>(out), G, N, a_stride,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_block_end(const void* gain, const void* cand, const void* t2,
                     const void* s_t2, const void* s_cand,
                     const void* s_prev, const void* reads,
                     const void* eumaps, void* theta, void* s_out,
                     void* terms, long long R, long long C, long long T,
                     long long a_stride, void* stream) {
  const long long blocks = blocks_for(R * (C > T ? C : T));
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL || (s_prev != nullptr) != (terms != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  block_end_kernel<F><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const F*>(gain), static_cast<const F*>(cand),
      static_cast<const F*>(t2), static_cast<const F*>(s_t2),
      static_cast<const F*>(s_cand), static_cast<const F*>(s_prev),
      static_cast<const F*>(reads), static_cast<const F*>(eumaps),
      static_cast<F*>(theta), static_cast<F*>(s_out), static_cast<F*>(terms),
      R, C, T, a_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_extrap(const void* theta, const void* t1, const void* t2,
                  const void* rsum, const void* vsum, void* out, long long R,
                  long long T, void* stream_ptr) {
  if (R * T <= 0) return 0;
  const long long blocks = blocks_for(R * T);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cycle_extrap_kernel<F><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const F*>(theta), static_cast<const F*>(t1),
      static_cast<const F*>(t2), static_cast<const F*>(rsum),
      static_cast<const F*>(vsum), static_cast<F*>(out), R, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_select(const void* gain, const void* cand, const void* t2,
                  void* out, long long R, long long T, void* stream_ptr) {
  if (R * T <= 0) return 0;
  const long long blocks = blocks_for(R * T);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cycle_select_kernel<F><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const F*>(gain), static_cast<const F*>(cand),
      static_cast<const F*>(t2), static_cast<F*>(out), R, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pair_gain: tiles (kernels/segment_sum.py::tile_bounds of the grouping at
// ``tile`` <= EMSAR_PAIR_TILE); s_old_out and s_new_out both null or both
// given (a block's last cycle: the two intensities)
extern "C" int emsar_pair_gain_f32(const void* x_old, const void* x_new,
                                   const void* w, const void* idx,
                                   const void* offsets, const void* tiles,
                                   const void* reads, const void* eumaps,
                                   void* s_old_out, void* s_new_out,
                                   void* out, long long R, long long G,
                                   long long N, long long a_stride,
                                   long long n_tiles, int tile,
                                   void* stream) {
  return launch_pair<float>(x_old, x_new, w, idx, offsets, tiles, reads,
                            eumaps, s_old_out, s_new_out, out, R, G, N,
                            a_stride, n_tiles, tile, stream);
}

extern "C" int emsar_pair_gain_f64(const void* x_old, const void* x_new,
                                   const void* w, const void* idx,
                                   const void* offsets, const void* tiles,
                                   const void* reads, const void* eumaps,
                                   void* s_old_out, void* s_new_out,
                                   void* out, long long R, long long G,
                                   long long N, long long a_stride,
                                   long long n_tiles, int tile,
                                   void* stream) {
  return launch_pair<double>(x_old, x_new, w, idx, offsets, tiles, reads,
                             eumaps, s_old_out, s_new_out, out, R, G, N,
                             a_stride, n_tiles, tile, stream);
}

// block_end: s_prev and terms both null (no gain terms) or both given
extern "C" int emsar_block_end_f32(const void* gain, const void* cand,
                                   const void* t2, const void* s_t2,
                                   const void* s_cand, const void* s_prev,
                                   const void* reads, const void* eumaps,
                                   void* theta, void* s_out, void* terms,
                                   long long R, long long C, long long T,
                                   long long a_stride, void* stream) {
  return launch_block_end<float>(gain, cand, t2, s_t2, s_cand, s_prev, reads,
                                 eumaps, theta, s_out, terms, R, C, T,
                                 a_stride, stream);
}

extern "C" int emsar_block_end_f64(const void* gain, const void* cand,
                                   const void* t2, const void* s_t2,
                                   const void* s_cand, const void* s_prev,
                                   const void* reads, const void* eumaps,
                                   void* theta, void* s_out, void* terms,
                                   long long R, long long C, long long T,
                                   long long a_stride, void* stream) {
  return launch_block_end<double>(gain, cand, t2, s_t2, s_cand, s_prev,
                                  reads, eumaps, theta, s_out, terms, R, C,
                                  T, a_stride, stream);
}

extern "C" int emsar_cycle_extrap_f32(const void* theta, const void* t1,
                                      const void* t2, const void* rsum,
                                      const void* vsum, void* out,
                                      long long R, long long T,
                                      void* stream) {
  return launch_extrap<float>(theta, t1, t2, rsum, vsum, out, R, T, stream);
}

extern "C" int emsar_cycle_extrap_f64(const void* theta, const void* t1,
                                      const void* t2, const void* rsum,
                                      const void* vsum, void* out,
                                      long long R, long long T,
                                      void* stream) {
  return launch_extrap<double>(theta, t1, t2, rsum, vsum, out, R, T, stream);
}

extern "C" int emsar_cycle_select_f32(const void* gain, const void* cand,
                                      const void* t2, void* out, long long R,
                                      long long T, void* stream) {
  return launch_select<float>(gain, cand, t2, out, R, T, stream);
}

extern "C" int emsar_cycle_select_f64(const void* gain, const void* cand,
                                      const void* t2, void* out, long long R,
                                      long long T, void* stream) {
  return launch_select<double>(gain, cand, t2, out, R, T, stream);
}
