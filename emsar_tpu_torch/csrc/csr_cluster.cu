// The stabilized SQUAREM cycle of the CSR EM solver
// (model/solver.py::_squarem_cycles) in two launches a cycle, on
// thread-block clusters that stop at hardware cluster barriers between the
// passes that need each other's values:
//
//   cluster_em_pair: theta = the row's source (theta itself, or the
//     previous cycle's accept, gain[r] >= 0 ? cand : t2, written out), then
//     the cycle's two EM steps:
//       pass 1, by cid: ratio1 = s > 0 ? reads / s : 0, s the intensity of
//         theta                                    | cluster barrier
//       pass 2, by tid: t1 = (theta * num) * inv_denom  | barrier
//       pass 3, by cid: ratio2 from t1's intensities    | barrier
//       pass 4, by tid: t2 = (t1 * num) * inv_denom, and r * r, v * v for
//         r = t1 - theta, v = (t2 - t1) - r
//   (then torch.sum of r * r and of v * v by row, as before)
//   cluster_extrap_gain: from theta, t1, t2 and the two row sums:
//       x = extrap > 0 ? extrap : t2, once a transcript as it is staged
//       pass 1, by cid: the intensities of x; ratio = reads / s   | barrier
//       pass 2, by tid: cand = (x * num) * inv_denom              | barrier
//       pass 3, by cid: the intensities of t2 and of cand side by side,
//         and the gain term of each segment; in a block's last cycle both
//         intensities are written out too (after the pass's barrier)
//   (then torch.sum of the terms by row: the gain that the next cycle's
//   cluster_em_pair, or the block's block_end (csrc/csr_cycle.cu), accepts
//   on; block_end picks the accepted row's intensities from pass 3's, so a
//   block makes no other pass over the edges)
//
// They replace em_iter (emsar_tpu/model/solver.py:113), gain_of (:134),
// squarem_cycle's vector work (:150) and the cycle loop of the block under
// the lax.while_loop (:181): five launches a cycle, where the kernels of
// csrc/segment_sum.cu and csrc/csr_cycle.cu take ten.
//
// Tiles.  Every pass needs only values of the same module (a connected
// component of the edges): the row-wide values, the step length and the
// gain, come in from the torch.sum launches.  So the wrapper packs each
// row's modules into tiles (kernels/csr_cluster.py::TilePlan), and a launch
// is ceil(R / rows) x n_tiles clusters of CL blocks (1, 2, 4 or 8), a
// cluster a tile and ``rows`` rows one after another: the work spreads over
// the card, and a module too large for one block's shared memory takes a
// cluster of several.  A cluster's blocks are scheduled together
// (__cluster_dims__: the plain launch and graph capture need nothing more)
// and its barrier (cluster.sync(): barrier.cluster arrive.release /
// wait.acquire) is in hardware; no cluster waits on another, so clusters
// beyond the card's concurrent ones run in waves, and a grid shared with
// other work or captured in a graph cannot deadlock.
//
// What bounds it on the H100: the latency of each pass's dependent loads
// (the bound, each input read once, is ~1 us at the smoke's shape).  So
// every value a pass reads is in shared memory when the pass starts:
//   * the static part of a block's share, both groupings' group ends, edge
//     weights and tile-local endpoints, lies in device memory as the
//     block's image (the plan's, contiguous, laid out as in shared memory)
//     and comes in by one bulk copy of the Tensor Memory Accelerator
//     (bulk_copy.cuh), its completion counted by an mbarrier; meanwhile the
//     other threads gather the launch's per-group inputs through each
//     group's id in the problem (orig) into the block's vectors: theta (or
//     the accept), reads, eumaps, 1 / denom, t1 and t2, and x;
//   * a tile-local endpoint is the rank of the cluster's block that holds
//     the other end in its share, and that end's slot there (rank << 28 |
//     slot): a gather reads its own block's shared memory, or another
//     block's of the cluster through distributed shared memory
//     (cluster.map_shared_rank);
//   * the values a launch makes (ratio1, t1, ratio2; ratio, cand) live in
//     the block's vectors and nowhere else; the outputs are written once,
//     at each group's id in the problem, after the launch's last barrier.
// A pass is then two steps behind a block barrier: every edge's products,
// a thread an edge, all gathers in flight together, into shared memory;
// then each group's fold from there, a thread a group.  Passes are split by
// barriers of the whole cluster: a block barrier where a cluster is one
// block (the smoke's plan), else a cluster barrier, whose release waits
// for the threads' earlier stores to device memory (~0.7 us a barrier on
// the H100, against ~0.1 for a block's: PERF.md §6).  So nothing goes to
// device memory before the last pass's gathers, after which a barrier of
// the cluster lets every block write its outputs and exit: none exits
// while another reads its vectors.
//
// Bits.  Every value is computed as those kernels compute it: a group's
// products rounded on their own (mul_rn) and added one after another in
// edge order from 0 (add_rn), the epilogues with the _rn intrinsics in
// torch's order; the accept test, the step length, the extrapolation and
// the gain term are csr_cycle.cu's, NaN as torch lets it through.  So both
// launches give the twelve launches' bits, and the row sums stay torch.sum
// over the tensors they reduced.  Inputs are read-only and read through
// __ldg.
//
// Shared memory of a block (offsets: the plan's Layout and BlockDesc): the
// mbarrier (16 B); the image at 16 (cid: ends [n] int32, endpoints [m],
// weights [m]; tid: the same; each part 16-byte aligned); then, at the
// same offsets in every block of a launch, the cid vectors (orig [n]
// int32, three of [n] F) and the tid vectors (orig, four of [n] F); then
// the products (F, two per edge of the cid share or one of the tid share).
//
// Layout: theta, cand, t2 and every [R, T] output contiguous; gain, rsum,
// vsum [R]; reads and eumaps [C] (a_stride 0) or [R, C] (a_stride C);
// inv_denom [T] or [R, T]; terms, s_t2 and s_cand [R, C].  float or
// double.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace cg = cooperative_groups;

#ifndef EMSAR_CLUSTER_THREADS
#define EMSAR_CLUSTER_THREADS 1024
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

constexpr int kThreads = EMSAR_CLUSTER_THREADS;
// the image's place in shared memory, after the mbarrier
constexpr int kImage = 16;
// a tile-local endpoint: the block's rank in the cluster, its slot there
constexpr int kRankShift = 28;
constexpr uint32_t kSlotMask = (1u << kRankShift) - 1;

// A block's descriptor (kernels/csr_cluster.py::TilePlan.blocks, int32
// [n_tiles x CL, 16], block b = tile * CL + rank): its share of each
// grouping in tile order (first group, group count, first edge, edge
// count), its image in device memory (at 16 x img16 bytes, img_bytes
// long) and the image's parts (offsets from its start; the cid ends at 0).
struct __align__(16) BlockDesc {
  int c_s0, c_n, c_e0, c_m;
  int t_s0, t_n, t_e0, t_m;
  int img16, img_bytes, c_local, c_w;
  int t_ends, t_local, t_w, unused;
};

// Where the vectors and the products lie in every block of a launch
// (TilePlan.layout): cid orig, its three vectors (c_stride apart), tid
// orig, its four vectors, the products; bytes from the start of shared
// memory.
struct Layout {
  int c_orig, c_vec, c_stride, t_orig, t_vec, t_stride, prod;
};

// The plan's arrays: the block descriptors, the images, and each
// grouping's group ids in tile order.
struct Tiles {
  const BlockDesc* desc;
  const unsigned char* image;
  const int32_t* c_orig;
  const int32_t* t_orig;
};

template <typename F, int NS>
struct Sums {
  F s[NS];
};

// the gain term of one segment: csr_cycle.cu's gain_term
template <typename F>
__device__ __forceinline__ F gain_term(F reads, F eumaps, F s_old, F s_new,
                                       bool skip_unread) {
  const bool both = s_old > F(0) && s_new > F(0);
  const F d = sub_rn(s_new, s_old);
  const F ratio = log1p_of(both ? div_rn(d, s_old) : F(0));
  const bool died = s_old > F(0) && s_new <= F(0) && reads > F(0);
  const bool born = s_old <= F(0) && s_new > F(0) && reads > F(0);
  const bool read_term = both && (!skip_unread || reads > F(0));
  const F term = read_term ? mul_rn(reads, ratio)
                           : mul_rn(sub_rn(F(born), F(died)), F(1e30));
  return sub_rn(term, mul_rn(eumaps, d));
}

// A block's share of a grouping in shared memory: its n groups' ends
// (group i's edges are ends[i - 1]:ends[i], from 0), ids in the problem
// (orig: each slot written and read by the thread that takes it), and its
// m edges' tile-local other endpoints and weights.
template <typename F>
struct Share {
  const int* ends;
  const uint32_t* local;
  const F* w;
  int* orig;
  int n, m;
};

// The block's shares: its image's bulk copy issued (thread 0; complete at
// mbar_wait(bar, 0)) while every thread loads its slots' ids.
template <typename F>
__device__ void stage(const Tiles& tl, const Layout& lay, const BlockDesc& d,
                      unsigned char* smem, Share<F>& cid, Share<F>& tid) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* img = smem + kImage;
  if (threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_bytes(bar, static_cast<unsigned>(d.img_bytes));
    if (d.img_bytes > 0)
      bulk_load(img, tl.image + 16LL * d.img16,
                static_cast<unsigned>(d.img_bytes), bar);
  }
  cid = Share<F>{reinterpret_cast<const int*>(img),
                 reinterpret_cast<const uint32_t*>(img + d.c_local),
                 reinterpret_cast<const F*>(img + d.c_w),
                 reinterpret_cast<int*>(smem + lay.c_orig), d.c_n, d.c_m};
  tid = Share<F>{reinterpret_cast<const int*>(img + d.t_ends),
                 reinterpret_cast<const uint32_t*>(img + d.t_local),
                 reinterpret_cast<const F*>(img + d.t_w),
                 reinterpret_cast<int*>(smem + lay.t_orig), d.t_n, d.t_m};
  for (int i = threadIdx.x; i < d.c_n; i += kThreads)
    cid.orig[i] = __ldg(tl.c_orig + d.c_s0 + i);
  for (int i = threadIdx.x; i < d.t_n; i += kThreads)
    tid.orig[i] = __ldg(tl.t_orig + d.t_s0 + i);
}

template <typename F>
__device__ __forceinline__ F* cvec(unsigned char* smem, const Layout& lay,
                                   int k) {
  return reinterpret_cast<F*>(smem + lay.c_vec + k * lay.c_stride);
}
template <typename F>
__device__ __forceinline__ F* tvec(unsigned char* smem, const Layout& lay,
                                   int k) {
  return reinterpret_cast<F*>(smem + lay.t_vec + k * lay.t_stride);
}

// The value of vector ``v`` (at the same offset in every block) at the
// tile-local endpoint ``loc``: this block's shared memory, or another
// block's of the cluster.
template <int CL, typename F>
__device__ __forceinline__ F peer(const cg::cluster_group& cluster,
                                  const F* v, uint32_t loc) {
  if constexpr (CL == 1) {
    return v[loc];
  } else {
    return *cluster.map_shared_rank(v + (loc & kSlotMask),
                                    loc >> kRankShift);
  }
}

// A barrier of every thread of the cluster: a block barrier where the
// cluster is one block, else the cluster's barrier (barrier.cluster
// arrive.release / wait.acquire, which also waits for the threads' earlier
// stores to device memory: ~0.7 us on the H100, where a block barrier
// takes ~0.1, PERF.md §6; so no output is written before one).
template <int CL>
__device__ __forceinline__ void sync_all(const cg::cluster_group& cluster) {
  if constexpr (CL == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
}

// One pass of a block over its share of a grouping: every group i (slot)
// gets the sums of w[e] * gather(local[e]) over its edges (NS of them side
// by side), folded in edge order from 0, and then post(i, sums) runs.
// First every edge's products, a thread an edge, all gathers in flight
// together, into ``prod`` (NS x m, shared memory); then barrier() (the
// block's, or the cluster's after a launch's last gathers); then each
// group's fold from there, a thread a group.
template <int NS, typename F, class Gather, class Barrier, class Post>
__device__ __forceinline__ void fold_pass(const Share<F>& sh, F* prod,
                                          Gather gather, Barrier barrier,
                                          Post post) {
  for (int e = threadIdx.x; e < sh.m; e += kThreads) {
    const Sums<F, NS> x = gather(sh.local[e]);
    const F we = sh.w[e];
#pragma unroll
    for (int s = 0; s < NS; ++s) prod[s * sh.m + e] = mul_rn(we, x.s[s]);
  }
  barrier();
  for (int i = threadIdx.x; i < sh.n; i += kThreads) {
    Sums<F, NS> acc;
#pragma unroll
    for (int s = 0; s < NS; ++s) acc.s[s] = F(0);
    for (int e = i > 0 ? sh.ends[i - 1] : 0; e < sh.ends[i]; ++e) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        acc.s[s] = add_rn(acc.s[s], prod[s * sh.m + e]);
    }
    post(i, acc);
  }
}

// The launch's rows of this cluster: [r0, r1).
struct Rows {
  long long tile, r0, r1;
};

template <int CL>
__device__ __forceinline__ Rows rows_of(long long n_tiles, long long rows,
                                        long long R) {
  const long long k = blockIdx.x / CL;
  const long long r0 = k / n_tiles * rows;
  return Rows{k % n_tiles, r0, r0 + rows < R ? r0 + rows : R};
}

template <typename F>
struct EmPairArgs {
  const F* theta;  // [R, T], or null: the source is the accept below
  const F* gain;   // [R], the previous cycle's gain
  const F* cand;   // [R, T]
  const F* t2p;    // [R, T], the previous cycle's t2
  Tiles tiles;
  Layout lay;
  long long R, T, n_tiles, rows;
  const F* reads;
  const F* inv_denom;
  long long reads_stride, inv_stride;
  F* theta_out;  // [R, T], written when the source is the accept
  F* t1;         // [R, T]
  F* t2;         // [R, T]
  F* rr;         // [R, T]
  F* vv;         // [R, T]
};

template <typename F, int CL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(kThreads, 1)
    cluster_em_pair_kernel(EmPairArgs<F> a) {
  cg::cluster_group cluster = cg::this_cluster();
  const Rows rw = rows_of<CL>(a.n_tiles, a.rows, a.R);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BlockDesc d = a.tiles.desc[rw.tile * CL + cluster.block_rank()];
  Share<F> by_cid, by_tid;
  stage<F>(a.tiles, a.lay, d, smem_raw, by_cid, by_tid);
  F* rd = cvec<F>(smem_raw, a.lay, 0);
  F* ratio = cvec<F>(smem_raw, a.lay, 2);  // ratio1, then ratio2
  F* th = tvec<F>(smem_raw, a.lay, 0);
  F* inv = tvec<F>(smem_raw, a.lay, 1);
  F* t1v = tvec<F>(smem_raw, a.lay, 2);
  F* prod = reinterpret_cast<F*>(smem_raw + a.lay.prod);
  const long long T = a.T;

  for (long long r = rw.r0; r < rw.r1; ++r) {
    const F* src = a.theta != nullptr
                       ? a.theta + r * T
                       : (__ldg(a.gain + r) >= F(0) ? a.cand : a.t2p) + r * T;
    const F* inv_r = a.inv_denom + r * a.inv_stride;
    const F* reads_r = a.reads + r * a.reads_stride;
    F* theta_out = a.theta == nullptr ? a.theta_out + r * T : nullptr;
    F* t1 = a.t1 + r * T;
    F* t2 = a.t2 + r * T;
    F* rr = a.rr + r * T;
    F* vv = a.vv + r * T;
    // the row's inputs into the vectors
    for (int i = threadIdx.x; i < by_tid.n; i += kThreads) {
      const int t = by_tid.orig[i];
      th[i] = __ldg(src + t);
      inv[i] = __ldg(inv_r + t);
    }
    for (int i = threadIdx.x; i < by_cid.n; i += kThreads)
      rd[i] = __ldg(reads_r + by_cid.orig[i]);
    if (r == rw.r0) mbar_wait(reinterpret_cast<uint64_t*>(smem_raw), 0);
    sync_all<CL>(cluster);  // every block's image and vectors in place
    // pass 1: the read ratio of theta's intensities
    fold_pass<1>(
        by_cid, prod,
        [&](uint32_t loc) { return Sums<F, 1>{{peer<CL>(cluster, th, loc)}}; },
        [] { __syncthreads(); },
        [&](int i, const Sums<F, 1>& s) {
          ratio[i] = s.s[0] > F(0) ? div_rn(rd[i], s.s[0]) : F(0);
        });
    sync_all<CL>(cluster);
    // pass 2: t1
    fold_pass<1>(
        by_tid, prod,
        [&](uint32_t loc) {
          return Sums<F, 1>{{peer<CL>(cluster, ratio, loc)}};
        },
        [] { __syncthreads(); },
        [&](int i, const Sums<F, 1>& s) {
          t1v[i] = mul_rn(mul_rn(th[i], s.s[0]), inv[i]);
        });
    sync_all<CL>(cluster);
    // pass 3: the read ratio of t1's intensities
    fold_pass<1>(
        by_cid, prod,
        [&](uint32_t loc) {
          return Sums<F, 1>{{peer<CL>(cluster, t1v, loc)}};
        },
        [] { __syncthreads(); },
        [&](int i, const Sums<F, 1>& s) {
          ratio[i] = s.s[0] > F(0) ? div_rn(rd[i], s.s[0]) : F(0);
        });
    sync_all<CL>(cluster);
    // pass 4: t2 and the squares of the cycle's r and v; after its gathers
    // no block's vectors are read any more: the row's outputs are written
    fold_pass<1>(
        by_tid, prod,
        [&](uint32_t loc) {
          return Sums<F, 1>{{peer<CL>(cluster, ratio, loc)}};
        },
        [&] { sync_all<CL>(cluster); },
        [&](int i, const Sums<F, 1>& s) {
          const F p = t1v[i];
          const F b = mul_rn(mul_rn(p, s.s[0]), inv[i]);
          const F res = sub_rn(p, th[i]);
          const F curv = sub_rn(sub_rn(b, p), res);
          const int t = by_tid.orig[i];
          if (theta_out != nullptr) theta_out[t] = th[i];
          t1[t] = p;
          t2[t] = b;
          rr[t] = mul_rn(res, res);
          vv[t] = mul_rn(curv, curv);
        });
  }
}

template <typename F>
struct ExtrapGainArgs {
  const F* theta;  // [R, T]
  const F* t1;
  const F* t2;
  const F* rsum;  // [R]
  const F* vsum;  // [R]
  Tiles tiles;
  Layout lay;
  long long R, C, T, n_tiles, rows;
  const F* reads;
  const F* eumaps;
  const F* inv_denom;
  long long reads_stride, inv_stride;
  F* cand;    // [R, T]
  F* terms;   // [R, C]
  F* s_t2;    // [R, C], or null: the intensities of t2 and of cand
  F* s_cand;  // [R, C]
  int skip_unread;  // gain_term's: the read term left out where reads == 0
};

template <typename F, int CL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(kThreads, 1)
    cluster_extrap_gain_kernel(ExtrapGainArgs<F> a) {
  cg::cluster_group cluster = cg::this_cluster();
  const Rows rw = rows_of<CL>(a.n_tiles, a.rows, a.R);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BlockDesc d = a.tiles.desc[rw.tile * CL + cluster.block_rank()];
  Share<F> by_cid, by_tid;
  stage<F>(a.tiles, a.lay, d, smem_raw, by_cid, by_tid);
  F* rd = cvec<F>(smem_raw, a.lay, 0);
  F* eu = cvec<F>(smem_raw, a.lay, 1);
  F* ratio = cvec<F>(smem_raw, a.lay, 2);
  F* xv = tvec<F>(smem_raw, a.lay, 0);
  F* inv = tvec<F>(smem_raw, a.lay, 1);
  F* cv = tvec<F>(smem_raw, a.lay, 2);
  F* t2v = tvec<F>(smem_raw, a.lay, 3);
  F* prod = reinterpret_cast<F*>(smem_raw + a.lay.prod);
  const long long T = a.T;

  for (long long r = rw.r0; r < rw.r1; ++r) {
    const F* theta = a.theta + r * T;
    const F* t1 = a.t1 + r * T;
    const F* t2 = a.t2 + r * T;
    const F* reads_r = a.reads + r * a.reads_stride;
    const F* eumaps_r = a.eumaps + r * a.reads_stride;
    const F* inv_r = a.inv_denom + r * a.inv_stride;
    F* cand = a.cand + r * T;
    // the row's step length, as cycle_extrap computes it
    const F rn = sqrt_rn(__ldg(a.rsum + r));
    const F vn = sqrt_rn(__ldg(a.vsum + r));
    F alpha = vn > F(0) ? div_rn(-rn, vn) : F(-1);
    if (!(alpha != alpha) && !(alpha < F(-1))) alpha = F(-1);  // NaN stays
    const F two_alpha = mul_rn(F(2), alpha);
    const F alpha_sq = mul_rn(alpha, alpha);
    // the stabilizing step's input x, once a transcript, and t2
    for (int i = threadIdx.x; i < by_tid.n; i += kThreads) {
      const int t = by_tid.orig[i];
      const F th = __ldg(theta + t), p = __ldg(t1 + t), q = __ldg(t2 + t);
      const F res = sub_rn(p, th);
      const F curv = sub_rn(sub_rn(q, p), res);
      const F ex =
          add_rn(sub_rn(th, mul_rn(two_alpha, res)), mul_rn(alpha_sq, curv));
      xv[i] = ex > F(0) ? ex : q;
      t2v[i] = q;
      inv[i] = __ldg(inv_r + t);
    }
    for (int i = threadIdx.x; i < by_cid.n; i += kThreads) {
      const int c = by_cid.orig[i];
      rd[i] = __ldg(reads_r + c);
      eu[i] = __ldg(eumaps_r + c);
    }
    if (r == rw.r0) mbar_wait(reinterpret_cast<uint64_t*>(smem_raw), 0);
    sync_all<CL>(cluster);  // every block's image and vectors in place
    // pass 1: the read ratio of x's intensities
    fold_pass<1>(
        by_cid, prod,
        [&](uint32_t loc) { return Sums<F, 1>{{peer<CL>(cluster, xv, loc)}}; },
        [] { __syncthreads(); },
        [&](int i, const Sums<F, 1>& s) {
          ratio[i] = s.s[0] > F(0) ? div_rn(rd[i], s.s[0]) : F(0);
        });
    sync_all<CL>(cluster);
    // pass 2: cand, one EM step from x
    fold_pass<1>(
        by_tid, prod,
        [&](uint32_t loc) {
          return Sums<F, 1>{{peer<CL>(cluster, ratio, loc)}};
        },
        [] { __syncthreads(); },
        [&](int i, const Sums<F, 1>& s) {
          cv[i] = mul_rn(mul_rn(xv[i], s.s[0]), inv[i]);
        });
    sync_all<CL>(cluster);
    // pass 3: the intensities of t2 and cand, and the gain term of cand
    // over t2 (pair_gain's); after its gathers no block's vectors are read
    // any more: the row's outputs are written
    fold_pass<2>(
        by_cid, prod,
        [&](uint32_t loc) {
          return Sums<F, 2>{
              {peer<CL>(cluster, t2v, loc), peer<CL>(cluster, cv, loc)}};
        },
        [&] { sync_all<CL>(cluster); },
        [&](int i, const Sums<F, 2>& s) {
          const long long o = r * a.C + by_cid.orig[i];
          a.terms[o] = gain_term(rd[i], eu[i], s.s[0], s.s[1],
                                 a.skip_unread != 0);
          if (a.s_t2 != nullptr) {
            a.s_t2[o] = s.s[0];
            a.s_cand[o] = s.s[1];
          }
        });
    for (int i = threadIdx.x; i < by_tid.n; i += kThreads)
      cand[by_tid.orig[i]] = cv[i];
  }
}

Tiles tiles_of(const void* const* p) {
  return Tiles{static_cast<const BlockDesc*>(p[0]),
               static_cast<const unsigned char*>(p[1]),
               static_cast<const int32_t*>(p[2]),
               static_cast<const int32_t*>(p[3])};
}

Layout layout_of(const int* l) {
  return Layout{l[0], l[1], l[2], l[3], l[4], l[5], l[6]};
}

// The most dynamic shared memory a block may take (the H100's 227 KB),
// allowed each kernel once: a kernel's type does not tell its cluster
// sizes apart, hence CL.
constexpr int kMaxSmem = 232448;

template <int CL, class Kernel>
bool allowed(Kernel kernel) {
  static const bool ok =
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem) == cudaSuccess;
  return ok;
}

template <typename F, int CL>
int launch_em_pair(const EmPairArgs<F>& a, long long clusters, int smem,
                   void* stream) {
  if (!allowed<CL>(cluster_em_pair_kernel<F, CL>))
    return static_cast<int>(cudaErrorInvalidValue);
  cluster_em_pair_kernel<F, CL><<<static_cast<unsigned>(clusters * CL),
                                  kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename F, int CL>
int launch_extrap_gain(const ExtrapGainArgs<F>& a, long long clusters,
                       int smem, void* stream) {
  if (!allowed<CL>(cluster_extrap_gain_kernel<F, CL>))
    return static_cast<int>(cudaErrorInvalidValue);
  cluster_extrap_gain_kernel<F, CL><<<static_cast<unsigned>(clusters * CL),
                                      kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// the launch of ``Args`` at the cluster size ``cluster`` (1, 2, 4 or 8)
template <typename F, template <typename, int> class Launch, class Args>
int launch_at(const Args& a, long long clusters, int cluster, int smem,
              void* stream) {
  switch (cluster) {
    case 1:
      return Launch<F, 1>::run(a, clusters, smem, stream);
    case 2:
      return Launch<F, 2>::run(a, clusters, smem, stream);
    case 4:
      return Launch<F, 4>::run(a, clusters, smem, stream);
    case 8:
      return Launch<F, 8>::run(a, clusters, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F, int CL>
struct EmPairLaunch {
  static int run(const EmPairArgs<F>& a, long long n, int smem,
                 void* stream) {
    return launch_em_pair<F, CL>(a, n, smem, stream);
  }
};

template <typename F, int CL>
struct ExtrapGainLaunch {
  static int run(const ExtrapGainArgs<F>& a, long long n, int smem,
                 void* stream) {
    return launch_extrap_gain<F, CL>(a, n, smem, stream);
  }
};

// the clusters of a launch (ceil(R / rows) x n_tiles), or -1 when the
// shape cannot launch
long long clusters_of(long long R, long long n_tiles, long long rows,
                      int cluster, long long smem) {
  if (n_tiles <= 0 || rows <= 0 || smem < kImage || smem > kMaxSmem)
    return -1;
  const long long n = (R + rows - 1) / rows * n_tiles;
  return n * cluster <= 0x7fffffffLL ? n : -1;
}

template <typename F>
int em_pair(const void* theta, const void* gain, const void* cand,
            const void* t2p, const void* const* tiles, const int* layout,
            const void* reads, const void* inv_denom, void* theta_out,
            void* t1, void* t2, void* rr, void* vv, long long R,
            long long T, long long n_tiles, long long rows, long long smem,
            long long reads_stride, long long inv_stride, int cluster,
            void* stream) {
  if (R <= 0) return 0;
  const long long n = clusters_of(R, n_tiles, rows, cluster, smem);
  if (n < 0 || ((theta == nullptr) == (gain == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const EmPairArgs<F> a{static_cast<const F*>(theta),
                        static_cast<const F*>(gain),
                        static_cast<const F*>(cand),
                        static_cast<const F*>(t2p),
                        tiles_of(tiles),
                        layout_of(layout),
                        R,
                        T,
                        n_tiles,
                        rows,
                        static_cast<const F*>(reads),
                        static_cast<const F*>(inv_denom),
                        reads_stride,
                        inv_stride,
                        static_cast<F*>(theta_out),
                        static_cast<F*>(t1),
                        static_cast<F*>(t2),
                        static_cast<F*>(rr),
                        static_cast<F*>(vv)};
  return launch_at<F, EmPairLaunch>(a, n, cluster, static_cast<int>(smem),
                                    stream);
}

template <typename F>
int extrap_gain(const void* theta, const void* t1, const void* t2,
                const void* rsum, const void* vsum, const void* const* tiles,
                const int* layout, const void* reads, const void* eumaps,
                const void* inv_denom, void* cand, void* terms, void* s_t2,
                void* s_cand, long long R, long long C, long long T,
                long long n_tiles, long long rows, long long smem,
                long long reads_stride, long long inv_stride, int cluster,
                int skip_unread, void* stream) {
  if (R <= 0) return 0;
  const long long n = clusters_of(R, n_tiles, rows, cluster, smem);
  if (n < 0 || (s_t2 == nullptr) != (s_cand == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ExtrapGainArgs<F> a{static_cast<const F*>(theta),
                            static_cast<const F*>(t1),
                            static_cast<const F*>(t2),
                            static_cast<const F*>(rsum),
                            static_cast<const F*>(vsum),
                            tiles_of(tiles),
                            layout_of(layout),
                            R,
                            C,
                            T,
                            n_tiles,
                            rows,
                            static_cast<const F*>(reads),
                            static_cast<const F*>(eumaps),
                            static_cast<const F*>(inv_denom),
                            reads_stride,
                            inv_stride,
                            static_cast<F*>(cand),
                            static_cast<F*>(terms),
                            static_cast<F*>(s_t2),
                            static_cast<F*>(s_cand),
                            skip_unread};
  return launch_at<F, ExtrapGainLaunch>(a, n, cluster,
                                        static_cast<int>(smem), stream);
}

// clusters of CL blocks of kernel `which` (0 em_pair, 1 extrap_gain),
// each block with ``smem`` bytes of dynamic shared memory, that can be
// resident at once (< 0: minus the CUDA error of the query)
template <typename F, int CL>
int max_active(int which, int smem) {
  if (!allowed<CL>(cluster_em_pair_kernel<F, CL>) ||
      !allowed<CL>(cluster_extrap_gain_kernel<F, CL>))
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  const void* fn =
      which == 0 ? reinterpret_cast<const void*>(cluster_em_pair_kernel<F, CL>)
                 : reinterpret_cast<const void*>(
                       cluster_extrap_gain_kernel<F, CL>);
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename F>
int max_active_at(int which, int cluster, int smem) {
  switch (cluster) {
    case 1:
      return max_active<F, 1>(which, smem);
    case 2:
      return max_active<F, 2>(which, smem);
    case 4:
      return max_active<F, 4>(which, smem);
    case 8:
      return max_active<F, 8>(which, smem);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// tiles: the plan's (block descriptors, images, cid orig, tid orig)
// (kernels/csr_cluster.py::TilePlan.pointers), layout its seven offsets
// (TilePlan.layout).  theta [R, T], or null and (gain, cand, t2p): the
// row's source is then gain >= 0 ? cand : t2p, written to theta_out.  The
// grid: ceil(R / rows) x n_tiles clusters of `cluster` blocks.
extern "C" int emsar_cluster_em_pair_f32(
    const void* theta, const void* gain, const void* cand, const void* t2p,
    const void* const* tiles, const int* layout, const void* reads,
    const void* inv_denom, void* theta_out, void* t1, void* t2, void* rr,
    void* vv, long long R, long long T, long long n_tiles, long long rows,
    long long smem, long long reads_stride, long long inv_stride,
    int cluster, void* stream) {
  return em_pair<float>(theta, gain, cand, t2p, tiles, layout, reads,
                        inv_denom, theta_out, t1, t2, rr, vv, R, T, n_tiles,
                        rows, smem, reads_stride, inv_stride, cluster,
                        stream);
}

extern "C" int emsar_cluster_em_pair_f64(
    const void* theta, const void* gain, const void* cand, const void* t2p,
    const void* const* tiles, const int* layout, const void* reads,
    const void* inv_denom, void* theta_out, void* t1, void* t2, void* rr,
    void* vv, long long R, long long T, long long n_tiles, long long rows,
    long long smem, long long reads_stride, long long inv_stride,
    int cluster, void* stream) {
  return em_pair<double>(theta, gain, cand, t2p, tiles, layout, reads,
                         inv_denom, theta_out, t1, t2, rr, vv, R, T, n_tiles,
                         rows, smem, reads_stride, inv_stride, cluster,
                         stream);
}

extern "C" int emsar_cluster_extrap_gain_f32(
    const void* theta, const void* t1, const void* t2, const void* rsum,
    const void* vsum, const void* const* tiles, const int* layout,
    const void* reads, const void* eumaps, const void* inv_denom, void* cand,
    void* terms, void* s_t2, void* s_cand, long long R, long long C,
    long long T, long long n_tiles, long long rows, long long smem,
    long long reads_stride, long long inv_stride, int cluster,
    int skip_unread, void* stream) {
  return extrap_gain<float>(theta, t1, t2, rsum, vsum, tiles, layout, reads,
                            eumaps, inv_denom, cand, terms, s_t2, s_cand, R,
                            C, T, n_tiles, rows, smem, reads_stride,
                            inv_stride, cluster, skip_unread, stream);
}

extern "C" int emsar_cluster_extrap_gain_f64(
    const void* theta, const void* t1, const void* t2, const void* rsum,
    const void* vsum, const void* const* tiles, const int* layout,
    const void* reads, const void* eumaps, const void* inv_denom, void* cand,
    void* terms, void* s_t2, void* s_cand, long long R, long long C,
    long long T, long long n_tiles, long long rows, long long smem,
    long long reads_stride, long long inv_stride, int cluster,
    int skip_unread, void* stream) {
  return extrap_gain<double>(theta, t1, t2, rsum, vsum, tiles, layout,
                             reads, eumaps, inv_denom, cand, terms, s_t2,
                             s_cand, R, C, T, n_tiles, rows, smem,
                             reads_stride, inv_stride, cluster, skip_unread,
                             stream);
}

// the clusters of `cluster` blocks of kernel `which` (0 em_pair, 1
// extrap_gain), ``smem`` bytes of shared memory a block, that fit on the
// card at once; < 0: minus the CUDA error of the query
extern "C" int emsar_cluster_max_active(int f64, int which, int cluster,
                                        int smem) {
  return f64 ? max_active_at<double>(which, cluster, smem)
             : max_active_at<float>(which, cluster, smem);
}
