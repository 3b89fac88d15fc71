// SQUAREM EM block over padded dense modules, one thread block per module.
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
// `n_iters` cycles run inside the block: the loop takes the place of the
// TPU's sequential grid, and theta never leaves shared memory in between.
//
// Layout: m [B, C, T], eumaps/reads [B, C], inv_denom/theta [B, T], all
// contiguous, float or double.  Shared memory per block: 6 T-vectors
// (th, t1, t2, extrapolated start, cand, inv_denom) and 3 C-vectors
// (E, R, ratio) plus 33 reduction slots: 18.7 KB at (C, T) = (512, 128) in
// double, under the 48 KB static limit, so no opt-in attribute is needed.
//
// What bounds it on the H100: each cycle makes eight passes over the
// module's M (two contractions in each of three EM steps, plus the two
// intensity passes of the accept test), 8 C T multiply-adds, with M read
// from L1/L2 (one module's M is 2 KB at (32, 8) f32 and 512 KB at
// (512, 128) f64).
// The work per module is small and serial over cycles, so the kernel is
// latency-bound; its parallelism is one block per module.  Row-wise sums
// over t give one thread per segment row, column-wise sums over c one
// thread per transcript column; the norms and the gain are block
// reductions (warp shuffles, then one warp over the warp partials).
// Staging M in shared memory, wgmma, TMA and packing several small modules
// into one block are left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }

template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block; every thread gets the total.  `red` holds 33
// slots: 32 warp partials and the result.
template <typename F>
__device__ F block_sum(F v, F* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    F w = lane < nwarps ? red[lane] : F(0);
    w = warp_sum(w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  return red[32];
}

// out = em(in) for one module; M row-major [C, T].
template <typename F>
__device__ void em_step(const F* __restrict__ M, const F* in, F* out,
                        const F* rr, const F* inv, F* ratio, int C, int T) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const F* row = M + (int64_t)c * T;
    F s = F(0);
    for (int t = 0; t < T; ++t) s += row[t] * in[t];
    ratio[c] = s > F(0) ? rr[c] / s : F(0);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    F num = F(0);
    for (int c = 0; c < C; ++c) num += M[(int64_t)c * T + t] * ratio[c];
    out[t] = in[t] * num * inv[t];
  }
  __syncthreads();
}

template <typename F>
__global__ void __launch_bounds__(kMaxThreads)
squarem_block_kernel(const F* __restrict__ m, const F* __restrict__ eumaps,
                     const F* __restrict__ reads,
                     const F* __restrict__ inv_denom,
                     const F* __restrict__ theta_in, F* __restrict__ theta_out,
                     int C, int T, int n_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F* sh = reinterpret_cast<F*>(smem_raw);
  F* th = sh;
  F* t1 = th + T;
  F* t2 = t1 + T;
  F* x = t2 + T;
  F* cand = x + T;
  F* inv = cand + T;
  F* ee = inv + T;
  F* rr = ee + C;
  F* ratio = rr + C;
  F* red = ratio + C;

  const int64_t b = blockIdx.x;
  const F* M = m + b * (int64_t)C * T;
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
    em_step(M, th, t1, rr, inv, ratio, C, T);
    em_step(M, t1, t2, rr, inv, ratio, C, T);

    F rsq = F(0), vsq = F(0);
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const F r = t1[t] - th[t];
      const F v = t2[t] - t1[t] - r;
      rsq += r * r;
      vsq += v * v;
    }
    const F rn = sqrt_(block_sum(rsq, red));
    const F vn = sqrt_(block_sum(vsq, red));
    F alpha = vn > F(0) ? -rn / vn : F(-1);
    // min(alpha, -1) that propagates NaN, as jnp.minimum does
    alpha = (alpha < F(-1) || alpha != alpha) ? alpha : F(-1);
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const F r = t1[t] - th[t];
      const F v = t2[t] - t1[t] - r;
      const F extrap = th[t] - F(2) * alpha * r + alpha * alpha * v;
      x[t] = extrap > F(0) ? extrap : t2[t];
    }
    __syncthreads();
    em_step(M, x, cand, rr, inv, ratio, C, T);

    F g = F(0);
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const F* row = M + (int64_t)c * T;
      F lam2 = F(0), lamc = F(0);
      for (int t = 0; t < T; ++t) {
        lam2 += row[t] * t2[t];
        lamc += row[t] * cand[t];
      }
      const F r = rr[c];
      const bool both = lam2 > F(0) && lamc > F(0);
      const bool died = lam2 > F(0) && lamc <= F(0) && r > F(0);
      const bool born = lam2 <= F(0) && lamc > F(0) && r > F(0);
      const F ratio_c = log1p_(both ? (lamc - lam2) / lam2 : F(0));
      const F term = both ? r * ratio_c
                          : (died ? F(-1e30) : (born ? F(1e30) : F(0)));
      g += term - ee[c] * (lamc - lam2);
    }
    const F gain = block_sum(g, red);
    const bool accept = gain >= F(0);
    for (int t = threadIdx.x; t < T; t += blockDim.x)
      th[t] = accept ? cand[t] : t2[t];
    __syncthreads();
  }

  for (int t = threadIdx.x; t < T; t += blockDim.x)
    theta_out[b * T + t] = th[t];
}

template <typename F>
int launch(const void* m, const void* eumaps, const void* reads,
           const void* inv_denom, const void* theta_in, void* theta_out,
           long long B, int C, int T, int n_iters, void* stream) {
  if (B <= 0) return 0;
  int threads = ((C > T ? C : T) + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (size_t)(6 * T + 3 * C + 33) * sizeof(F);
  squarem_block_kernel<F><<<(unsigned int)B, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const F*>(m), static_cast<const F*>(eumaps),
      static_cast<const F*>(reads), static_cast<const F*>(inv_denom),
      static_cast<const F*>(theta_in), static_cast<F*>(theta_out), C, T,
      n_iters);
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
