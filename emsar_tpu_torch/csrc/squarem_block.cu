// SQUAREM EM block over padded dense modules.
//
// Replaces the Pallas TPU kernel emsar_tpu/model/dense.py::_pallas_block
// (kernel body `kernel5`).  Arithmetic is kernel5's, term for term:
//   em(th):  s_c = sum_t M[c,t] th[t];  ratio_c = s_c > 0 ? R_c / s_c : 0;
//            th'[t] = th[t] * (sum_c M[c,t] ratio_c) * inv_denom[t]
//   cycle:   t1 = em(th); t2 = em(t1); r = t1 - th; v = t2 - t1 - r;
//            alpha = min(|v| > 0 ? -|r|/|v| : -1, -1);
//            extrap = th - 2 alpha r + alpha^2 v;
//            cand = em(extrap > 0 ? extrap : t2);
//            gain = sum_c term_c - E_c (lamc_c - lam2_c)  with the log1p
//            term and the +-1e30 born/died sentinels;
//            th = gain >= 0 ? cand : t2.
// `n_iters` cycles run inside the kernel: the loop takes the place of the
// TPU's sequential grid, and theta never leaves the SM in between.
//
// Layout: m [B, C, T], eumaps/reads [B, C], inv_denom/theta [B, T], all
// contiguous, float or double.
//
// Order of the sums: row sums over t and column sums over c run
// sequentially from index 0, the norms and the gain as the xor
// butterflies below, whose result equals a shuffle-down tree over the
// lanes in order.  In float32 SQUAREM's alpha^2 step turns a changed last
// bit of t1 or t2 into ~1e-3 of theta (kernels/check.py), so the design
// keeps that order wherever it changes the layout of the work.
//
// What bounds it on the H100: latency.  A module's work is 8 C T
// multiply-adds (16 C T flops) a cycle (eight passes over M: two
// contractions in each of three EM steps, and the two intensity passes of
// the accept test), and
// the cycles are serial; the main path holds 1-2 thousand modules, a few
// warps per SM.  So a cycle costs the length of its chain of dependent
// steps (memory reads, shuffles or barriers, the divisions, the f64 log1p
// and sqrt), and the design shortens that chain per size class.  What is
// left is mostly arithmetic latency: on an H100 a (32, 8) cycle takes
// ~3.7 us in f64 and ~2.2 us in f32, and cutting the shuffles and
// shared-memory reads of a cycle by two thirds (column of M in registers,
// vectors through shared slots with 16-byte broadcast loads) gained 15%
// at (32, 8) and lost 5% at (64, 16) in f64, so it was not kept.
//
// The classes:
//
// * (32, 8) and (64, 16), the classes of the main path: one warp per
//   module, four modules per block, no __syncthreads.  The warp stages
//   its module's M once with coalesced 16-byte loads into its slice of
//   shared memory (2 KB at (32, 8) and 8 KB at (64, 16) in f64) and from
//   there into registers by rows: lane c holds row c (and row c + 32 at
//   (64, 16)), E_c and R_c.  Each lane owns transcript t = lane mod T of
//   every T-vector, one value in one register (the 32 / T lanes that share
//   a t hold the same bits).  A row sum gathers the vector by T broadcast
//   shuffles and runs in-lane; a column sum reads the ratios from the
//   warp's slice (written after the row sums, __syncwarp) and column t of
//   M from the staged copy, both conflict-free, in a chain of C
//   multiply-adds; the norms are xor butterflies within a group of T
//   lanes, the gain one over the warp per row of the lane.  An xor
//   butterfly gives every lane the same bits (a + b = b + a), so the warp
//   takes one accept decision.  The ragged last block leaves out whole
//   warps.
// * (128, 32): one block of 128 threads per module with M staged once in
//   shared memory (row stride T + 1, so that both the row-wise reads of
//   the row sums and the column-wise reads of the column sums are free of
//   bank conflicts; 33 KB of M in f64, 38 KB in all, under the 48 KB
//   static limit); one thread per row, then one per column.
// * (512, 128): M (256 KB in f32, 512 KB in f64) does not fit in shared
//   memory and is read from L1/L2 on every pass.  The block reductions are
//   warp-first: warp butterflies, one barrier, then every warp adds the
//   warp partials itself, with no second barrier.
//
// Shared memory of the block classes: 6 T-vectors (th, t1, t2,
// extrapolated start, cand, inv_denom), 3 C-vectors (E, R, ratio) and 64
// reduction slots, plus the staged M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kStaticSmem = 48 * 1024;

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }

// One cycle's accept-test term of a segment row.
template <typename F>
__device__ __forceinline__ F gain_term(F lam2, F lamc, F r, F e) {
  const bool both = lam2 > F(0) && lamc > F(0);
  const bool died = lam2 > F(0) && lamc <= F(0) && r > F(0);
  const bool born = lam2 <= F(0) && lamc > F(0) && r > F(0);
  const F ratio_c = log1p_(both ? (lamc - lam2) / lam2 : F(0));
  const F term = both ? r * ratio_c
                      : (died ? F(-1e30) : (born ? F(1e30) : F(0)));
  return term - e * (lamc - lam2);
}

// min(alpha, -1) that propagates NaN, as jnp.minimum does
template <typename F>
__device__ __forceinline__ F step_length(F rn, F vn) {
  const F alpha = vn > F(0) ? -rn / vn : F(-1);
  return (alpha < F(-1) || alpha != alpha) ? alpha : F(-1);
}

// Sum of v over the N lanes of a group (the lanes that share every lane
// bit above log2 N), in each of them: lane 0's sum is that of a
// shuffle-down tree over lanes 0..N-1.
template <int N, typename F>
__device__ __forceinline__ F group_sum(F v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
  return group_sum<32>(v);
}

// ---- one warp per module: (32, 8) and (64, 16) ----

// The lane's entry of em(in): `in` and `inv` are its transcript's values,
// Mw the module's staged M [C, T], ratio_s the warp's C ratio slots.
template <typename F, int RPL, int T>
__device__ __forceinline__ F warp_em(const F (&M)[RPL][T], const F* Mw,
                                     F* ratio_s, const F (&rr)[RPL], F in,
                                     F inv, int lane) {
  constexpr int C = 32 * RPL;
  F s[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) s[r] = F(0);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const F x = __shfl_sync(kFull, in, t);
#pragma unroll
    for (int r = 0; r < RPL; ++r) s[r] += M[r][t] * x;
  }
#pragma unroll
  for (int r = 0; r < RPL; ++r)
    ratio_s[lane + 32 * r] = s[r] > F(0) ? rr[r] / s[r] : F(0);
  __syncwarp();
  const int own = lane & (T - 1);
  F num = F(0);
#pragma unroll
  for (int c = 0; c < C; ++c) num += Mw[c * T + own] * ratio_s[c];
  __syncwarp();  // the slots are written again by the next step
  return in * num * inv;
}

template <typename F, int RPL, int T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
squarem_warp_kernel(const F* __restrict__ m, const F* __restrict__ eumaps,
                    const F* __restrict__ reads,
                    const F* __restrict__ inv_denom,
                    const F* __restrict__ theta_in, F* __restrict__ theta_out,
                    long long B, int n_iters, int vec) {
  constexpr int C = 32 * RPL;
  static_assert(C * T * sizeof(F) % 16 == 0 && 32 % T == 0, "warp class");
  __shared__ __align__(16) F Ms[kWarpsPerBlock][C * T];
  __shared__ F rs[kWarpsPerBlock][C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (b >= B) return;  // the ragged last block: whole warps leave
  F* Mw = Ms[warp];
  const F* Mg = m + b * C * T;
  if (vec) {
    for (int u = lane; u < C * T * (int)sizeof(F) / 16; u += 32)
      reinterpret_cast<uint4*>(Mw)[u] =
          __ldg(reinterpret_cast<const uint4*>(Mg) + u);
  } else {
    for (int i = lane; i < C * T; i += 32) Mw[i] = __ldg(Mg + i);
  }
  __syncwarp();
  F M[RPL][T], ee[RPL], rr[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int c = lane + 32 * r;
#pragma unroll
    for (int t = 0; t < T; ++t) M[r][t] = Mw[c * T + t];
    ee[r] = __ldg(eumaps + b * C + c);
    rr[r] = __ldg(reads + b * C + c);
  }
  const int own = lane & (T - 1);
  F th = __ldg(theta_in + b * T + own);
  const F inv = __ldg(inv_denom + b * T + own);

  for (int it = 0; it < n_iters; ++it) {
    const F t1 = warp_em<F, RPL, T>(M, Mw, rs[warp], rr, th, inv, lane);
    const F t2 = warp_em<F, RPL, T>(M, Mw, rs[warp], rr, t1, inv, lane);
    const F r = t1 - th;
    const F v = t2 - t1 - r;
    const F alpha = step_length(sqrt_(group_sum<T>(r * r)),
                                sqrt_(group_sum<T>(v * v)));
    const F extrap = th - F(2) * alpha * r + alpha * alpha * v;
    const F cand = warp_em<F, RPL, T>(M, Mw, rs[warp], rr,
                                      extrap > F(0) ? extrap : t2, inv, lane);

    F lam2[RPL], lamc[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) lam2[k] = lamc[k] = F(0);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const F a = __shfl_sync(kFull, t2, t);
      const F c = __shfl_sync(kFull, cand, t);
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        lam2[k] += M[k][t] * a;
        lamc[k] += M[k][t] * c;
      }
    }
    F gain = F(0);
#pragma unroll
    for (int k = 0; k < RPL; ++k)
      gain += warp_sum(gain_term(lam2[k], lamc[k], rr[k], ee[k]));
    th = gain >= F(0) ? cand : t2;
  }
  if (lane < T) theta_out[b * T + lane] = th;
}

// ---- one block per module: (128, 32) and (512, 128) ----

// Sums of v[0..N) over the block, in every thread: warp butterflies, one
// barrier, then each warp adds the warp partials by another butterfly.
// `red` holds N x 32 slots; a barrier must separate two uses of them.
template <int N, typename F>
__device__ __forceinline__ void block_sums(F (&v)[N], F* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) red[32 * k + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k)
    v[k] = warp_sum(lane < nwarps ? red[32 * k + lane] : F(0));
}

// out = em(in) for one module; M [C, T] with row stride ld.
template <typename F>
__device__ void em_block(const F* M, int ld, const F* in, F* out,
                         const F* rr, const F* inv, F* ratio, int C, int T) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const F* row = M + (int64_t)c * ld;
    F s = F(0);
    for (int t = 0; t < T; ++t) s += row[t] * in[t];
    ratio[c] = s > F(0) ? rr[c] / s : F(0);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    F num = F(0);
    for (int c = 0; c < C; ++c) num += M[(int64_t)c * ld + t] * ratio[c];
    out[t] = in[t] * num * inv[t];
  }
  __syncthreads();
}

template <typename F, bool kStageM>
__global__ void __launch_bounds__(kMaxThreads)
squarem_block_kernel(const F* __restrict__ m, const F* __restrict__ eumaps,
                     const F* __restrict__ reads,
                     const F* __restrict__ inv_denom,
                     const F* __restrict__ theta_in, F* __restrict__ theta_out,
                     int C, int T, int n_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F* th = reinterpret_cast<F*>(smem_raw);
  F* t1 = th + T;
  F* t2 = t1 + T;
  F* x = t2 + T;
  F* cand = x + T;
  F* inv = cand + T;
  F* ee = inv + T;
  F* rr = ee + C;
  F* ratio = rr + C;
  F* red = ratio + C;
  F* Ms = red + 64;

  const int64_t b = blockIdx.x;
  const F* Mg = m + b * (int64_t)C * T;
  const int ld = kStageM ? T + 1 : T;
  if (kStageM) {
    for (int i = threadIdx.x; i < C * T; i += blockDim.x)
      Ms[(i / T) * ld + i % T] = Mg[i];
  }
  const F* M = kStageM ? Ms : Mg;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    th[t] = theta_in[b * T + t];
    inv[t] = inv_denom[b * T + t];
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    ee[c] = eumaps[b * C + c];
    rr[c] = reads[b * C + c];
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    em_block(M, ld, th, t1, rr, inv, ratio, C, T);
    em_block(M, ld, t1, t2, rr, inv, ratio, C, T);

    F sq[2] = {F(0), F(0)};
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const F r = t1[t] - th[t];
      const F v = t2[t] - t1[t] - r;
      sq[0] += r * r;
      sq[1] += v * v;
    }
    block_sums(sq, red);
    const F alpha = step_length(sqrt_(sq[0]), sqrt_(sq[1]));
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const F r = t1[t] - th[t];
      const F v = t2[t] - t1[t] - r;
      const F extrap = th[t] - F(2) * alpha * r + alpha * alpha * v;
      x[t] = extrap > F(0) ? extrap : t2[t];
    }
    __syncthreads();
    em_block(M, ld, x, cand, rr, inv, ratio, C, T);

    F g[1] = {F(0)};
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const F* row = M + (int64_t)c * ld;
      F lam2 = F(0), lamc = F(0);
      for (int t = 0; t < T; ++t) {
        lam2 += row[t] * t2[t];
        lamc += row[t] * cand[t];
      }
      g[0] += gain_term(lam2, lamc, rr[c], ee[c]);
    }
    block_sums(g, red);
    const bool accept = g[0] >= F(0);
    for (int t = threadIdx.x; t < T; t += blockDim.x)
      th[t] = accept ? cand[t] : t2[t];
    __syncthreads();
  }

  for (int t = threadIdx.x; t < T; t += blockDim.x)
    theta_out[b * T + t] = th[t];
}

template <typename F>
int launch(const void* m_, const void* eumaps_, const void* reads_,
           const void* inv_denom_, const void* theta_in_, void* theta_out_,
           long long B, int C, int T, int n_iters, void* stream_) {
  if (B <= 0) return 0;
  const F* m = static_cast<const F*>(m_);
  const F* eumaps = static_cast<const F*>(eumaps_);
  const F* reads = static_cast<const F*>(reads_);
  const F* inv_denom = static_cast<const F*>(inv_denom_);
  const F* theta_in = static_cast<const F*>(theta_in_);
  F* theta_out = static_cast<F*>(theta_out_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const unsigned int warp_blocks =
      (unsigned int)((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int vec = (reinterpret_cast<uintptr_t>(m) & 15u) == 0;
  if (C == 32 && T == 8) {
    squarem_warp_kernel<F, 1, 8><<<warp_blocks, kWarpsPerBlock * 32, 0,
                                   stream>>>(m, eumaps, reads, inv_denom,
                                             theta_in, theta_out, B, n_iters,
                                             vec);
  } else if (C == 64 && T == 16) {
    squarem_warp_kernel<F, 2, 16><<<warp_blocks, kWarpsPerBlock * 32, 0,
                                    stream>>>(m, eumaps, reads, inv_denom,
                                              theta_in, theta_out, B,
                                              n_iters, vec);
  } else {
    // one thread per row or column, at most 256; M staged when it fits
    int threads = ((C > T ? C : T) + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const size_t base = (size_t)(6 * T + 3 * C + 64) * sizeof(F);
    const size_t staged = base + (size_t)C * (T + 1) * sizeof(F);
    if (staged <= kStaticSmem) {
      squarem_block_kernel<F, true><<<(unsigned int)B, threads, staged,
                                      stream>>>(m, eumaps, reads, inv_denom,
                                                theta_in, theta_out, C, T,
                                                n_iters);
    } else {
      squarem_block_kernel<F, false><<<(unsigned int)B, threads, base,
                                       stream>>>(m, eumaps, reads, inv_denom,
                                                 theta_in, theta_out, C, T,
                                                 n_iters);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int emsar_squarem_block_f32(const void* m, const void* eumaps,
                                       const void* reads,
                                       const void* inv_denom,
                                       const void* theta_in, void* theta_out,
                                       long long B, int C, int T,
                                       int n_iters, void* stream) {
  return launch<float>(m, eumaps, reads, inv_denom, theta_in, theta_out, B,
                       C, T, n_iters, stream);
}

extern "C" int emsar_squarem_block_f64(const void* m, const void* eumaps,
                                       const void* reads,
                                       const void* inv_denom,
                                       const void* theta_in, void* theta_out,
                                       long long B, int C, int T,
                                       int n_iters, void* stream) {
  return launch<double>(m, eumaps, reads, inv_denom, theta_in, theta_out, B,
                        C, T, n_iters, stream);
}
