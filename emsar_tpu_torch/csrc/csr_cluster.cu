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
//       pass 1, by cid: the intensities of x = extrap > 0 ? extrap : t2,
//         x computed where it is gathered; ratio = reads / s   | barrier
//       pass 2, by tid: cand = (x * num) * inv_denom            | barrier
//       pass 3, by cid: the intensities of t2 and of cand side by side,
//         and the gain term of each segment
//   (then torch.sum of the terms by row: the gain that the next cycle's
//   cluster_em_pair, or the block's cycle_select, accepts on)
//
// They replace em_iter (emsar_tpu/model/solver.py:113), gain_of (:134),
// squarem_cycle's vector work (:150) and the cycle loop of the block under
// the lax.while_loop (:181): five launches a cycle, where the kernels of
// csrc/segment_sum.cu and csrc/csr_cycle.cu take twelve.
//
// Tiles.  Every pass needs only values of the same module (a connected
// component of the edges): the row-wide values, the step length and the
// gain, come in from the torch.sum launches.  So the wrapper packs each
// row's modules into tiles (kernels/csr_cluster.py::TilePlan), and the
// grid is R x n_tiles clusters of CL blocks (1, 2, 4 or 8), a cluster a
// tile: the row's work spreads over the card, and a module too large for
// one block's shared memory takes a cluster of several.  A cluster's
// blocks are scheduled together (__cluster_dims__: the plain launch and
// graph capture need nothing more) and its barrier (cluster.sync():
// barrier.cluster arrive.release / wait.acquire) is in hardware; no
// cluster waits on another, so clusters beyond the card's concurrent ones
// run in waves, and a grid shared with other work or captured in a graph
// cannot deadlock.
//
// What bounds it on the H100: the latency of each pass's dependent loads,
// where the twelve launches pay a launch's too.  So a block stages its
// share of the tile (equal counts of groups) of both edge lists in shared
// memory once a launch, and a pass is two steps behind a block barrier:
// every edge's products, a thread an edge, all gathers in flight together,
// into shared memory; then each group's fold from there, a thread a group.
// The loads left in a pass are the gathers and the epilogues' operands.
//
// Bits.  Every value is computed as those kernels compute it: a group's
// products rounded on their own (mul_rn) and added one after another in
// edge order from 0 (add_rn), the epilogues with the _rn intrinsics in
// torch's order; the accept test, the step length, the extrapolation and
// the gain term are csr_cycle.cu's, NaN as torch lets it through.  So both
// launches give the twelve launches' bits, and the row sums stay torch.sum
// over the tensors they reduced.  Vectors written earlier in the same
// launch (ratio1, t1, ratio2, cand) live in scratch the wrapper allocates,
// each its own buffer, and are read with plain loads after a barrier
// (never __ldg or const __restrict__: the non-coherent path may return
// stale lines); the edge lists, reads, eumaps, 1 / denom and the launch's
// inputs are read-only and read through __ldg.
//
// Layout: theta, cand, t2 and every [R, T] output contiguous; gain, rsum,
// vsum [R]; each grouping in tile order (Groups: w [E], idx [E] int32 the
// problem's ids, offsets [G + 1] int64 (E < 2^31), orig [G] int32,
// tile_off [n_tiles + 1] int32); reads and eumaps [C] (a_stride 0) or [R,
// C] (a_stride C); inv_denom [T] or [R, T]; ratio and terms [R, C].  A
// block takes the dynamic shared memory the plan sized (TilePlan.smem).
// float or double.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Edges grouped by one endpoint, the groups in tile order
// (kernels/csr_cluster.py::TiledGroups): group i of the order is group
// orig[i] of the problem, its edges off[i]:off[i + 1] (in the problem's
// order), each edge's other endpoint idx[e] the problem's; tile t holds
// the groups tile_off[t]:tile_off[t + 1].
template <typename F>
struct Groups {
  const F* w;
  const int32_t* idx;
  const int64_t* off;
  const int32_t* orig;
  const int32_t* tile_off;
};

template <typename F, int NS>
struct Sums {
  F s[NS];
};

// the gain term of one segment: csr_cycle.cu's gain_term
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

// A block's share of a grouping, staged in shared memory: its n groups
// (the tile's groups s0 + i, i < n), their edge ranges off[i]:off[i + 1]
// relative to the share's first edge, their ids in the problem, and the
// share's m edges (the other endpoint's id in the problem, the weight).
template <typename F>
struct Staged {
  const int* off;
  const int* orig;
  const int32_t* idx;
  const F* w;
  int n, m;
};

// Shares of a tile among a cluster's CL blocks: equal counts of groups.
__device__ __forceinline__ long long share_start(long long t0, long long n,
                                                 unsigned rank, int cl) {
  return t0 + n * rank / cl;
}

__device__ __forceinline__ unsigned char* align_up(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 15) & ~uintptr_t(15));
}

// Copy this block's share of grouping ``gr`` in tile ``tile`` into shared
// memory at ``cursor`` (advanced past it); every thread copies its part.
template <int CL, typename F>
__device__ Staged<F> stage(const Groups<F>& gr, long long tile,
                           unsigned rank, unsigned char*& cursor) {
  const long long t0 = __ldg(gr.tile_off + tile);
  const long long nt = __ldg(gr.tile_off + tile + 1) - t0;
  const long long s0 = share_start(t0, nt, rank, CL);
  const int n = static_cast<int>(share_start(t0, nt, rank + 1, CL) - s0);
  const long long e0 = __ldg(gr.off + s0);
  const int m = static_cast<int>(__ldg(gr.off + s0 + n) - e0);
  int* off = reinterpret_cast<int*>(cursor);
  int* orig = off + n + 1;
  int32_t* idx = reinterpret_cast<int32_t*>(align_up(
      reinterpret_cast<unsigned char*>(orig + n)));
  F* w = reinterpret_cast<F*>(align_up(
      reinterpret_cast<unsigned char*>(idx + m)));
  cursor = align_up(reinterpret_cast<unsigned char*>(w + m));
  for (int i = threadIdx.x; i <= n; i += kThreads)
    off[i] = static_cast<int>(__ldg(gr.off + s0 + i) - e0);
  for (int i = threadIdx.x; i < n; i += kThreads)
    orig[i] = __ldg(gr.orig + s0 + i);
  for (int e = threadIdx.x; e < m; e += kThreads) {
    idx[e] = __ldg(gr.idx + e0 + e);
    w[e] = __ldg(gr.w + e0 + e);
  }
  return Staged<F>{off, orig, idx, w, n, m};
}

// One pass of a block over its staged share of a grouping: every group g
// (the problem's id) gets the sums of w[e] * gather(idx[e]) over its edges
// (NS of them side by side), folded in edge order from 0, and then post(g,
// pre(g), sums) runs.  First every edge's products, a thread an edge, all
// gathers in flight together, into ``prod`` (NS x m, shared memory); then
// each group's fold from there, a thread a group.  A thread's first group's
// pre() loads are issued before the products, to arrive meanwhile.
template <int NS, typename F, class Gather, class Pre, class Post>
__device__ __forceinline__ void fold_pass(const Staged<F>& st, F* prod,
                                          Gather gather, Pre pre,
                                          Post post) {
  const int first = threadIdx.x;
  const int g_first = first < st.n ? st.orig[first] : 0;
  const auto op_first = pre(g_first);
  for (int e = threadIdx.x; e < st.m; e += kThreads) {
    const Sums<F, NS> x = gather(st.idx[e]);
    const F we = st.w[e];
#pragma unroll
    for (int s = 0; s < NS; ++s) prod[s * st.m + e] = mul_rn(we, x.s[s]);
  }
  __syncthreads();
  for (int i = first; i < st.n; i += kThreads) {
    const int g = i == first ? g_first : st.orig[i];
    const auto op = i == first ? op_first : pre(g);
    Sums<F, NS> acc;
#pragma unroll
    for (int s = 0; s < NS; ++s) acc.s[s] = F(0);
    for (int e = st.off[i]; e < st.off[i + 1]; ++e) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        acc.s[s] = add_rn(acc.s[s], prod[s * st.m + e]);
    }
    post(g, op, acc);
  }
}

template <typename F>
struct EmPairArgs {
  const F* theta;  // [R, T], or null: the source is the accept below
  const F* gain;   // [R], the previous cycle's gain
  const F* cand;   // [R, T]
  const F* t2p;    // [R, T], the previous cycle's t2
  Groups<F> by_cid, by_tid;
  long long C, T, n_tiles;
  const F* reads;
  const F* inv_denom;
  long long reads_stride, inv_stride;
  F* theta_out;  // [R, T], written when the source is the accept
  F* ratio1;     // [R, C] scratch
  F* t1;         // [R, T]
  F* ratio2;     // [R, C] scratch
  F* t2;         // [R, T]
  F* rr;         // [R, T]
  F* vv;         // [R, T]
};

template <typename F, int CL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(kThreads, 1)
    cluster_em_pair_kernel(EmPairArgs<F> a) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long long r = blockIdx.x / CL / a.n_tiles;
  const long long tile = blockIdx.x / CL - r * a.n_tiles;
  const long long C = a.C, T = a.T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* cursor = smem_raw;
  const Staged<F> by_cid = stage<CL>(a.by_cid, tile, rank, cursor);
  const Staged<F> by_tid = stage<CL>(a.by_tid, tile, rank, cursor);
  F* prod = reinterpret_cast<F*>(cursor);  // [m] a pass
  const F* th = a.theta != nullptr ? a.theta + r * T
                : (__ldg(a.gain + r) >= F(0) ? a.cand : a.t2p) + r * T;
  const F* reads = a.reads + r * a.reads_stride;
  const F* inv = a.inv_denom + r * a.inv_stride;
  F* theta_out = a.theta == nullptr ? a.theta_out + r * T : nullptr;
  F* ratio1 = a.ratio1 + r * C;
  F* t1 = a.t1 + r * T;
  F* ratio2 = a.ratio2 + r * C;
  F* t2 = a.t2 + r * T;
  F* rr = a.rr + r * T;
  F* vv = a.vv + r * T;
  struct Own {
    F x, inv;
  };
  struct Own3 {
    F x, th, inv;
  };

  __syncthreads();  // the shares are staged
  // pass 1: the read ratio of theta's intensities
  fold_pass<1>(
      by_cid, prod,
      [&](int32_t j) { return Sums<F, 1>{{__ldg(th + j)}}; },
      [&](long long g) { return __ldg(reads + g); },
      [&](long long g, F rd, const Sums<F, 1>& s) {
        ratio1[g] = s.s[0] > F(0) ? div_rn(rd, s.s[0]) : F(0);
      });
  cluster.sync();
  // pass 2: t1, and the source written out as this cycle's theta
  fold_pass<1>(
      by_tid, prod, [&](int32_t c) { return Sums<F, 1>{{ratio1[c]}}; },
      [&](long long t) { return Own{__ldg(th + t), __ldg(inv + t)}; },
      [&](long long t, const Own& o, const Sums<F, 1>& s) {
        t1[t] = mul_rn(mul_rn(o.x, s.s[0]), o.inv);
        if (theta_out != nullptr) theta_out[t] = o.x;
      });
  cluster.sync();
  // pass 3: the read ratio of t1's intensities
  fold_pass<1>(
      by_cid, prod, [&](int32_t j) { return Sums<F, 1>{{t1[j]}}; },
      [&](long long g) { return __ldg(reads + g); },
      [&](long long g, F rd, const Sums<F, 1>& s) {
        ratio2[g] = s.s[0] > F(0) ? div_rn(rd, s.s[0]) : F(0);
      });
  cluster.sync();
  // pass 4: t2 and the squares of the cycle's r and v
  fold_pass<1>(
      by_tid, prod, [&](int32_t c) { return Sums<F, 1>{{ratio2[c]}}; },
      [&](long long t) { return Own3{t1[t], __ldg(th + t), __ldg(inv + t)}; },
      [&](long long t, const Own3& o, const Sums<F, 1>& s) {
        const F b = mul_rn(mul_rn(o.x, s.s[0]), o.inv);
        const F res = sub_rn(o.x, o.th);
        const F curv = sub_rn(sub_rn(b, o.x), res);
        t2[t] = b;
        rr[t] = mul_rn(res, res);
        vv[t] = mul_rn(curv, curv);
      });
}

template <typename F>
struct ExtrapGainArgs {
  const F* theta;  // [R, T]
  const F* t1;
  const F* t2;
  const F* rsum;  // [R]
  const F* vsum;  // [R]
  Groups<F> by_cid, by_tid;
  long long C, T, n_tiles;
  const F* reads;
  const F* eumaps;
  const F* inv_denom;
  long long reads_stride, inv_stride;
  F* ratio;  // [R, C] scratch
  F* cand;   // [R, T]
  F* terms;  // [R, C]
};

template <typename F, int CL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(kThreads, 1)
    cluster_extrap_gain_kernel(ExtrapGainArgs<F> a) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long long r = blockIdx.x / CL / a.n_tiles;
  const long long tile = blockIdx.x / CL - r * a.n_tiles;
  const long long C = a.C, T = a.T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* cursor = smem_raw;
  const Staged<F> by_cid = stage<CL>(a.by_cid, tile, rank, cursor);
  const Staged<F> by_tid = stage<CL>(a.by_tid, tile, rank, cursor);
  F* prod = reinterpret_cast<F*>(cursor);  // [NS x m] a pass
  const F* theta = a.theta + r * T;
  const F* t1 = a.t1 + r * T;
  const F* t2 = a.t2 + r * T;
  const F* reads = a.reads + r * a.reads_stride;
  const F* eumaps = a.eumaps + r * a.reads_stride;
  const F* inv = a.inv_denom + r * a.inv_stride;
  F* ratio = a.ratio + r * C;
  F* cand = a.cand + r * T;
  F* terms = a.terms + r * C;
  // the row's step length, as cycle_extrap computes it
  const F rn = sqrt_rn(__ldg(a.rsum + r));
  const F vn = sqrt_rn(__ldg(a.vsum + r));
  F alpha = vn > F(0) ? div_rn(-rn, vn) : F(-1);
  if (!(alpha != alpha) && !(alpha < F(-1))) alpha = F(-1);  // NaN stays
  const F two_alpha = mul_rn(F(2), alpha);
  const F alpha_sq = mul_rn(alpha, alpha);
  // the stabilizing step's input at transcript j
  auto x_at = [&](long long j) {
    const F th = __ldg(theta + j), p = __ldg(t1 + j), q = __ldg(t2 + j);
    const F res = sub_rn(p, th);
    const F curv = sub_rn(sub_rn(q, p), res);
    const F ex =
        add_rn(sub_rn(th, mul_rn(two_alpha, res)), mul_rn(alpha_sq, curv));
    return ex > F(0) ? ex : q;
  };
  struct Own {
    F x, inv;
  };
  struct Pair {
    F reads, eumaps;
  };

  __syncthreads();  // the shares are staged
  // pass 1: the read ratio of x's intensities
  fold_pass<1>(
      by_cid, prod, [&](int32_t j) { return Sums<F, 1>{{x_at(j)}}; },
      [&](long long g) { return __ldg(reads + g); },
      [&](long long g, F rd, const Sums<F, 1>& s) {
        ratio[g] = s.s[0] > F(0) ? div_rn(rd, s.s[0]) : F(0);
      });
  cluster.sync();
  // pass 2: cand, one EM step from x
  fold_pass<1>(
      by_tid, prod, [&](int32_t c) { return Sums<F, 1>{{ratio[c]}}; },
      [&](long long t) { return Own{x_at(t), __ldg(inv + t)}; },
      [&](long long t, const Own& o, const Sums<F, 1>& s) {
        cand[t] = mul_rn(mul_rn(o.x, s.s[0]), o.inv);
      });
  cluster.sync();
  // pass 3: the intensities of t2 and cand, and the gain term of cand over
  // t2 (pair_gain's)
  fold_pass<2>(
      by_cid, prod,
      [&](int32_t j) { return Sums<F, 2>{{__ldg(t2 + j), cand[j]}}; },
      [&](long long g) { return Pair{__ldg(reads + g), __ldg(eumaps + g)}; },
      [&](long long g, const Pair& o, const Sums<F, 2>& s) {
        terms[g] = gain_term(o.reads, o.eumaps, s.s[0], s.s[1]);
      });
}

template <typename F>
Groups<F> groups(const void* const* g) {
  return Groups<F>{static_cast<const F*>(g[0]),
                   static_cast<const int32_t*>(g[1]),
                   static_cast<const int64_t*>(g[2]),
                   static_cast<const int32_t*>(g[3]),
                   static_cast<const int32_t*>(g[4])};
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

bool shape_ok(long long R, long long n_tiles, int cluster, long long smem) {
  return n_tiles > 0 && R * n_tiles * cluster <= 0x7fffffffLL &&
         smem >= 0 && smem <= kMaxSmem;
}

template <typename F>
int em_pair(const void* theta, const void* gain, const void* cand,
            const void* t2p, const void* const* cid, const void* const* tid,
            const void* reads, const void* inv_denom, void* theta_out,
            void* ratio1, void* t1, void* ratio2, void* t2, void* rr,
            void* vv, long long R, long long C, long long T,
            long long n_tiles, long long smem, long long reads_stride,
            long long inv_stride, int cluster,
            void* stream) {
  if (R <= 0) return 0;
  if (!shape_ok(R, n_tiles, cluster, smem) ||
      ((theta == nullptr) == (gain == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const EmPairArgs<F> a{static_cast<const F*>(theta),
                        static_cast<const F*>(gain),
                        static_cast<const F*>(cand),
                        static_cast<const F*>(t2p),
                        groups<F>(cid),
                        groups<F>(tid),
                        C,
                        T,
                        n_tiles,
                        static_cast<const F*>(reads),
                        static_cast<const F*>(inv_denom),
                        reads_stride,
                        inv_stride,
                        static_cast<F*>(theta_out),
                        static_cast<F*>(ratio1),
                        static_cast<F*>(t1),
                        static_cast<F*>(ratio2),
                        static_cast<F*>(t2),
                        static_cast<F*>(rr),
                        static_cast<F*>(vv)};
  return launch_at<F, EmPairLaunch>(a, R * n_tiles, cluster,
                                    static_cast<int>(smem), stream);
}

template <typename F>
int extrap_gain(const void* theta, const void* t1, const void* t2,
                const void* rsum, const void* vsum, const void* const* cid,
                const void* const* tid, const void* reads,
                const void* eumaps, const void* inv_denom, void* ratio,
                void* cand, void* terms, long long R, long long C,
                long long T, long long n_tiles, long long smem,
                long long reads_stride, long long inv_stride, int cluster,
                void* stream) {
  if (R <= 0) return 0;
  if (!shape_ok(R, n_tiles, cluster, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const ExtrapGainArgs<F> a{static_cast<const F*>(theta),
                            static_cast<const F*>(t1),
                            static_cast<const F*>(t2),
                            static_cast<const F*>(rsum),
                            static_cast<const F*>(vsum),
                            groups<F>(cid),
                            groups<F>(tid),
                            C,
                            T,
                            n_tiles,
                            static_cast<const F*>(reads),
                            static_cast<const F*>(eumaps),
                            static_cast<const F*>(inv_denom),
                            reads_stride,
                            inv_stride,
                            static_cast<F*>(ratio),
                            static_cast<F*>(cand),
                            static_cast<F*>(terms)};
  return launch_at<F, ExtrapGainLaunch>(a, R * n_tiles, cluster,
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

// cid and tid: a grouping's (w, idx, offsets, orig, tile_off) in tile
// order (kernels/csr_cluster.py::TiledGroups).  theta [R, T], or null and
// (gain, cand, t2p): the row's source is then gain >= 0 ? cand : t2p,
// written to theta_out.  The grid: R x n_tiles clusters of `cluster`
// blocks.
extern "C" int emsar_cluster_em_pair_f32(
    const void* theta, const void* gain, const void* cand, const void* t2p,
    const void* const* cid, const void* const* tid, const void* reads,
    const void* inv_denom, void* theta_out, void* ratio1, void* t1,
    void* ratio2, void* t2, void* rr, void* vv, long long R, long long C,
    long long T, long long n_tiles, long long smem, long long reads_stride,
    long long inv_stride, int cluster,
    void* stream) {
  return em_pair<float>(theta, gain, cand, t2p, cid, tid, reads, inv_denom,
                        theta_out, ratio1, t1, ratio2, t2, rr, vv, R, C, T,
                        n_tiles, smem, reads_stride, inv_stride, cluster,
                        stream);
}

extern "C" int emsar_cluster_em_pair_f64(
    const void* theta, const void* gain, const void* cand, const void* t2p,
    const void* const* cid, const void* const* tid, const void* reads,
    const void* inv_denom, void* theta_out, void* ratio1, void* t1,
    void* ratio2, void* t2, void* rr, void* vv, long long R, long long C,
    long long T, long long n_tiles, long long smem, long long reads_stride,
    long long inv_stride, int cluster,
    void* stream) {
  return em_pair<double>(theta, gain, cand, t2p, cid, tid, reads, inv_denom,
                         theta_out, ratio1, t1, ratio2, t2, rr, vv, R, C, T,
                         n_tiles, smem, reads_stride, inv_stride, cluster,
                         stream);
}

extern "C" int emsar_cluster_extrap_gain_f32(
    const void* theta, const void* t1, const void* t2, const void* rsum,
    const void* vsum, const void* const* cid, const void* const* tid,
    const void* reads, const void* eumaps, const void* inv_denom,
    void* ratio, void* cand, void* terms, long long R, long long C,
    long long T, long long n_tiles, long long smem, long long reads_stride,
    long long inv_stride, int cluster,
    void* stream) {
  return extrap_gain<float>(theta, t1, t2, rsum, vsum, cid, tid, reads,
                            eumaps, inv_denom, ratio, cand, terms, R, C, T,
                            n_tiles, smem, reads_stride, inv_stride,
                            cluster, stream);
}

extern "C" int emsar_cluster_extrap_gain_f64(
    const void* theta, const void* t1, const void* t2, const void* rsum,
    const void* vsum, const void* const* cid, const void* const* tid,
    const void* reads, const void* eumaps, const void* inv_denom,
    void* ratio, void* cand, void* terms, long long R, long long C,
    long long T, long long n_tiles, long long smem, long long reads_stride,
    long long inv_stride, int cluster,
    void* stream) {
  return extrap_gain<double>(theta, t1, t2, rsum, vsum, cid, tid, reads,
                             eumaps, inv_denom, ratio, cand, terms, R, C, T,
                             n_tiles, smem, reads_stride, inv_stride,
                             cluster, stream);
}

// the clusters of `cluster` blocks of kernel `which` (0 em_pair, 1
// extrap_gain), ``smem`` bytes of shared memory a block, that fit on the
// card at once; < 0: minus the CUDA error of the query
extern "C" int emsar_cluster_max_active(int f64, int which, int cluster,
                                        int smem) {
  return f64 ? max_active_at<double>(which, cluster, smem)
             : max_active_at<float>(which, cluster, smem);
}
