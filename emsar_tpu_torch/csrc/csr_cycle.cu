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
// cycle_extrap's and cycle_select's design.  Two short elementwise passes
// that follow a torch.sum row sum (cycle_extrap the sum of v * v,
// cycle_select the previous cycle's sum of the gain terms): most of their
// time is the launch, the wait on that sum and a first load.  A block
// takes a run of one row (blockIdx.y the row, blockIdx.x a run of kVecs *
// kThreads 16-byte vectors, neighbouring threads on neighbouring
// addresses), so no thread divides; the row's elements before its first
// 16-byte line and after its last (a row of R > 1 starts inside a line
// when T * sizeof(F) % 16 != 0) are loaded one by one by the first run's
// threads, and a call whose arrays lie at different offsets within
// their lines is made of one-element vectors.  cycle_extrap's step
// length is a row's: one thread of a block computes it, broadcast through
// shared memory.  Both are launched by cudaLaunchKernelEx with
// programmatic stream serialization (Hopper's programmatic dependent
// launch): a block may start while the kernel before it on the stream
// still runs, does its index work and loads every input but the one that
// kernel writes (theta, t1, t2 and the sum of r * r; cand and t2), waits
// in cudaGridDependencySynchronize() for that kernel to finish, and only
// then reads the last input (the sum of v * v; the gain) and writes.
// Everything before the kernel directly before it on the stream had
// finished when that one started, so the early loads are of finished
// data; without the attribute (-DEMSAR_CYCLE_PDL=0, the build
// bench/cycle_parts.py times against this one) the wait returns at once.
// Where a row's cand and t2 are many bytes (above kSelectEarlyBytes a
// call), cycle_select reads only the picked one, after the wait.
//
// What bounds it on the H100: bytes, and in practice latency.  At the
// smoke workload's CSR shape (R 1, f64; 27,619 segments, 89,744 edges,
// 12,090 transcripts) pair_gain moves ~2.1 MB (the by-cid edges, two
// thetas, reads, eumaps, the terms), block_end ~1.5 MB (three vectors of
// C, two of T read, two of C and one of T written) and no edge:
// ~1.1 us together at 3.35 TB/s against a few us of launch each;
// cycle_extrap ~0.4 MB (three vectors of T read, one written),
// cycle_select ~0.2 MB (the picked vector read, one written).
//
// Layout: theta, t1, t2, cand, x and out [R, T] contiguous; rsum, vsum and
// gain [R]; w [E]; idx [E] int32; offsets [G + 1] int64; tiles [2, n_tiles
// + 1] int64 (the tiles' group bounds, then their edge bounds); reads and
// eumaps [G] (a_stride 0) or [R, G] (a_stride G); s_t2, s_cand, s_prev,
// s_out and the terms [R, G].  float or double.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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
// 0: cycle_extrap and cycle_select launched without programmatic stream
// serialization (bench/cycle_parts.py builds it to time against the
// default 1)
#ifndef EMSAR_CYCLE_PDL
#define EMSAR_CYCLE_PDL 1
#endif
// the bytes of cand a call above which cycle_select reads only the picked
// row, after the wait: below it the other row costs at most ~0.16 us of
// HBM, and the gain's load overlaps the rows' (bench/cycle_parts.py times
// both paths at every shape)
#ifndef EMSAR_SELECT_EARLY_BYTES
#define EMSAR_SELECT_EARLY_BYTES (512LL << 10)
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
// cycle_extrap and cycle_select: 16-byte vectors a thread (1 and 4 a
// thread were no faster on the H100)
constexpr int kVecs = 2;
constexpr long long kSelectEarlyBytes = EMSAR_SELECT_EARLY_BYTES;

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

// A row's 16-byte lines: its elements [head, head + n W) lie on whole
// lines of W = 16 / sizeof(F) elements, its first ``head`` and last
// ``tail`` elements outside them (W = 1: no such element); a block's
// threads take the vectors of its run, kVecs each, and the first run's
// threads the loose elements, one each.
template <typename F, int W>
struct RowRun {
  int head, tail;
  long long n;  // the row's vectors
  __device__ RowRun(const F* row, long long T) {
    head = W == 1 ? 0
                  : static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row)
                                             & 15)) & 15) / sizeof(F));
    if (head > T) head = static_cast<int>(T);
    n = (T - head) / W;
    tail = static_cast<int>(T - head - n * W);
  }
  // the row's first element of this thread's k-th vector, -1 past the row
  __device__ long long vec(int k) const {
    const long long q = static_cast<long long>(blockIdx.x) * (kVecs *
                                                              kThreads) +
                        k * kThreads + threadIdx.x;
    return q < n ? head + q * W : -1;
  }
  // this thread's loose element of the row, -1 for none
  __device__ long long loose(long long T) const {
    const int t = threadIdx.x;
    if (blockIdx.x != 0) return -1;
    if (t < head) return t;
    if (t >= W && t < W + tail) return T - tail + (t - W);
    return -1;
  }
};

__device__ __forceinline__ void load_line(const double* p, double* e) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  e[0] = v.x;
  e[1] = v.y;
}
__device__ __forceinline__ void load_line(const float* p, float* e) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}
__device__ __forceinline__ void store_line(double* p, const double* e) {
  *reinterpret_cast<double2*>(p) = make_double2(e[0], e[1]);
}
__device__ __forceinline__ void store_line(float* p, const float* e) {
  *reinterpret_cast<float4*>(p) = make_float4(e[0], e[1], e[2], e[3]);
}
template <int W, typename F>
__device__ __forceinline__ void load_vec(const F* p, F* e) {
  if constexpr (W == 1) {
    e[0] = __ldg(p);
  } else {
    load_line(p, e);
  }
}
template <int W, typename F>
__device__ __forceinline__ void store_vec(F* p, const F* e) {
  if constexpr (W == 1) {
    p[0] = e[0];
  } else {
    store_line(p, e);
  }
}

// squarem_cycle's extrapolation of one element, t2's value where it is not
// positive, from 2 alpha and alpha alpha
template <typename F>
__device__ __forceinline__ F extrap_of(F th, F a, F b, F two_alpha,
                                       F alpha_sq) {
  const F r = sub_rn(a, th);
  const F v = sub_rn(sub_rn(b, a), r);
  const F ex = add_rn(sub_rn(th, mul_rn(two_alpha, r)), mul_rn(alpha_sq, v));
  return ex > F(0) ? ex : b;
}

// A block per (run, row): the third EM step's input of the run's elements.
// vsum is written by the kernel before (not read-only while this one runs:
// read through L2 after the wait, never through the read-only cache).
template <typename F, int W>
__global__ void __launch_bounds__(kThreads)
    cycle_extrap_kernel(const F* __restrict__ theta,
                        const F* __restrict__ t1, const F* __restrict__ t2,
                        const F* __restrict__ rsum, const F* vsum,
                        F* __restrict__ out, long long T) {
  __shared__ F coef[2];  // 2 alpha, alpha alpha
  const long long row = blockIdx.y;
  const long long o = row * T;
  const RowRun<F, W> run(theta + o, T);
  F th[kVecs][W], a[kVecs][W], b[kVecs][W];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long e = run.vec(k);
    if (e >= 0) {
      load_vec<W>(theta + o + e, th[k]);
      load_vec<W>(t1 + o + e, a[k]);
      load_vec<W>(t2 + o + e, b[k]);
    }
  }
  const long long l = run.loose(T);
  F lth = F(0), la = F(0), lb = F(0);
  if (l >= 0) {
    lth = __ldg(theta + o + l);
    la = __ldg(t1 + o + l);
    lb = __ldg(t2 + o + l);
  }
  const F rs = __ldg(rsum + row);
  cudaGridDependencySynchronize();  // vsum: the kernel before has finished
  if (threadIdx.x == 0) {
    const F rn = sqrt_rn(rs);
    const F vn = sqrt_rn(__ldcg(vsum + row));
    F alpha = vn > F(0) ? div_rn(-rn, vn) : F(-1);
    if (!(alpha != alpha) && !(alpha < F(-1))) alpha = F(-1);  // NaN stays
    coef[0] = mul_rn(F(2), alpha);
    coef[1] = mul_rn(alpha, alpha);
  }
  __syncthreads();
  const F two_alpha = coef[0], alpha_sq = coef[1];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long e = run.vec(k);
    if (e >= 0) {
      F x[W];
#pragma unroll
      for (int j = 0; j < W; ++j)
        x[j] = extrap_of(th[k][j], a[k][j], b[k][j], two_alpha, alpha_sq);
      store_vec<W>(out + o + e, x);
    }
  }
  if (l >= 0) out[o + l] = extrap_of(lth, la, lb, two_alpha, alpha_sq);
}

// A block per (run, row): the run's elements of cand where the row's gain
// is >= 0, else of t2.  kEarly: both loaded before the wait, else only the
// picked one after it.  gain is written by the kernel before (read
// through L2 after the wait).
template <typename F, int W, bool kEarly>
__global__ void __launch_bounds__(kThreads)
    cycle_select_kernel(const F* gain, const F* __restrict__ cand,
                        const F* __restrict__ t2, F* __restrict__ out,
                        long long T) {
  const long long row = blockIdx.y;
  const long long o = row * T;
  const RowRun<F, W> run(cand + o, T);
  const long long l = run.loose(T);
  F c[kVecs][W], u[kVecs][W];  // cand's (or the picked row's), t2's
  F lc = F(0), lu = F(0);
  if constexpr (kEarly) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long e = run.vec(k);
      if (e >= 0) {
        load_vec<W>(cand + o + e, c[k]);
        load_vec<W>(t2 + o + e, u[k]);
      }
    }
    if (l >= 0) {
      lc = __ldg(cand + o + l);
      lu = __ldg(t2 + o + l);
    }
  }
  cudaGridDependencySynchronize();  // gain: the kernel before has finished
  const bool take = __ldcg(gain + row) >= F(0);
  if constexpr (!kEarly) {
    const F* src = (take ? cand : t2) + o;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long e = run.vec(k);
      if (e >= 0) load_vec<W>(src + e, c[k]);
    }
    if (l >= 0) lc = __ldg(src + l);
  }
  const bool keep_c = !kEarly || take;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long e = run.vec(k);
    if (e >= 0) {
      F x[W];  // picked element by element: the arrays stay in registers
#pragma unroll
      for (int j = 0; j < W; ++j) x[j] = keep_c ? c[k][j] : u[k][j];
      store_vec<W>(out + o + e, x);
    }
  }
  if (l >= 0) out[o + l] = keep_c ? lc : lu;
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

// 16 / sizeof(F) where the arrays lie at one offset within their 16-byte
// lines (torch's allocations: every one), else 1 (one element a vector)
template <typename F>
int width_of(std::initializer_list<const void*> arrays) {
  uintptr_t apart = 0;
  for (const void* p : arrays)
    apart |= (reinterpret_cast<uintptr_t>(p) ^
              reinterpret_cast<uintptr_t>(*arrays.begin())) & 15;
  return apart ? 1 : 16 / int(sizeof(F));
}

// kernel on (runs of a row of T elements in vectors of W, R rows) blocks,
// launched by cudaLaunchKernelEx with programmatic stream serialization
// (EMSAR_CYCLE_PDL): it may start before the kernel before it ends
template <typename... Params, typename... Args>
int launch_runs(void (*kernel)(Params...), long long R, long long T, int W,
                void* stream, Args... args) {
  const long long per_run = static_cast<long long>(kVecs) * kThreads;
  const long long runs = (T / W + per_run - 1) / per_run;
  if (R > 65535 || runs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = EMSAR_CYCLE_PDL;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(runs > 0 ? runs : 1),
                     static_cast<unsigned>(R), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename F>
int launch_extrap(const void* theta, const void* t1, const void* t2,
                  const void* rsum, const void* vsum, void* out, long long R,
                  long long T, void* stream) {
  if (R * T <= 0) return 0;
  const F *th = static_cast<const F*>(theta), *a = static_cast<const F*>(t1),
          *b = static_cast<const F*>(t2), *rs = static_cast<const F*>(rsum),
          *vs = static_cast<const F*>(vsum);
  F* x = static_cast<F*>(out);
  constexpr int kLine = 16 / sizeof(F);
  const int W = width_of<F>({theta, t1, t2, out});
  if (W == 1)
    return launch_runs(cycle_extrap_kernel<F, 1>, R, T, W, stream, th, a, b,
                       rs, vs, x, T);
  return launch_runs(cycle_extrap_kernel<F, kLine>, R, T, W, stream, th, a,
                     b, rs, vs, x, T);
}

template <typename F>
int launch_select(const void* gain, const void* cand, const void* t2,
                  void* out, long long R, long long T, void* stream) {
  if (R * T <= 0) return 0;
  const F *g = static_cast<const F*>(gain), *c = static_cast<const F*>(cand),
          *u = static_cast<const F*>(t2);
  F* x = static_cast<F*>(out);
  constexpr int kLine = 16 / sizeof(F);
  const int W = width_of<F>({cand, t2, out});
  const bool early = R * T * static_cast<long long>(sizeof(F)) <=
                     kSelectEarlyBytes;
  if (W == 1)
    return early ? launch_runs(cycle_select_kernel<F, 1, true>, R, T, W,
                               stream, g, c, u, x, T)
                 : launch_runs(cycle_select_kernel<F, 1, false>, R, T, W,
                               stream, g, c, u, x, T);
  return early ? launch_runs(cycle_select_kernel<F, kLine, true>, R, T, W,
                             stream, g, c, u, x, T)
               : launch_runs(cycle_select_kernel<F, kLine, false>, R, T, W,
                             stream, g, c, u, x, T);
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
