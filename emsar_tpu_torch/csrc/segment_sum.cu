// Deterministic gather-multiply-segmented sum over CSR-grouped edges:
//
//   out[r, g] = sum_{e in [offsets[g], offsets[g+1])} w[e] * x[r, idx[e]]
//
// with an optional epilogue that turns the sum s into one half of the CSR
// EM step of model/solver.py::_em_iter:
//
//   mode 0 (plain):  out[r, g] = s
//   mode 1 (ratio):  out[r, g] = s > 0 ? a[r, g] / s : 0     (a = reads)
//   mode 2 (update): out[r, g] = (b[r, g] * s) * a[r, g]     (b = theta,
//                                                             a = inv_denom)
//   mode 3 (cycle):  mode 2, and with c = the SQUAREM cycle's theta
//                    (b = t1 = one EM step from it, out = t2):
//                    rr[r, g] = r * r, vv[r, g] = v * v for
//                    r = t1 - c and v = (t2 - t1) - r
//
// so one EM step is two launches: by cid in mode 1 (the segment
// intensities s, turned into the read ratio R / s), then by tid in mode 2
// (the numerator sum of mult * ratio, times theta and 1 / denom).  It
// replaces the two `jax.ops.segment_sum` calls of
// emsar_tpu/model/solver.py::_em_solve (XLA ops, not a Pallas kernel) and
// the elementwise work between and after them.  Mode 3 is the second EM
// step of a cycle (model/solver.py::_squarem_cycle): its epilogue writes
// the squares whose row sums are the step-length norms, which saves the
// four elementwise launches of r, v, r * r and v * v
// (kernels/csr_cycle.py has the rest of the cycle's vector work).
//
// a[r, g] is a[r * a_stride + g]: a_stride 0 shares one row of a among
// the R rows (one sample's reads and 1 / denom under its restart rounds),
// a_stride G gives each row its own (the batched multisample solve of
// parallel/mesh.py: per-sample reads [S, C] and inv_denom [S, T]).
//
// Order and bits.  Each product is rounded (mul_rn), then the products of
// a segment are added to a running sum one after another in edge order
// (add_rn), starting from 0; no FMA contraction, no atomics.  That is the
// order of the sequential CPU `index_add_` over the same edges, so the
// kernel gives the plain version's bits on the CPU, and the same bits on
// every launch.  The epilogues use IEEE division and separately rounded
// products and differences in torch's order, so they give torch's bits
// too.
//
// What bounds it on the H100: bytes.  One f64 launch by cid on the smoke
// workload's CSR problem (27,619 segments, 89,744 edges, x of 12,090)
// moves w and idx once (12 B an edge with int32 indices), x once, offsets
// and out once: ~1.6 MB, ~0.5 us at 3.35 TB/s.  In practice the floor is
// the launch latency (a few us), so the design cuts the latency of each
// launch and the launches themselves:
//
// * A group of K lanes (K = 4, 8, 16 or 32, a template parameter the
//   wrapper picks from the mean edges per segment) owns one output.  The
//   lanes load K consecutive idx / w coalesced and have all K gathers of x
//   in flight at once, where one thread per output waited on one
//   dependent gather per edge.
// * The group then folds its K products in edge order: K dependent add_rn
//   on values broadcast with __shfl_sync (all lanes keep the same running
//   sum, which carries over to the next chunk of K edges).  Register adds
//   cost cycles where serial gathers cost memory latency, and the order is
//   that of the sequential loop.  A group's shuffles name only its own
//   lanes, so groups of one warp may run different numbers of chunks.
// * The grid covers R x G groups: K times the threads of one thread per
//   output, several blocks on every SM.
// * idx is int32 (the wrapper checks the range once per problem).
// * The EM epilogues save the six elementwise launches of each EM step.
//
// Layout: x [R, N] contiguous; w [E]; idx [E] int32; offsets [G + 1]
// int64; a [G] (a_stride 0) or [R, G] (a_stride G); b, c, out, rr and vv
// [R, G].  float or double.

#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

constexpr int kThreads = 256;

template <typename F, int K, int MODE>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const F* __restrict__ x, const F* __restrict__ w,
                       const int32_t* __restrict__ idx,
                       const int64_t* __restrict__ offsets,
                       const F* __restrict__ a, const F* __restrict__ b,
                       const F* __restrict__ c, F* __restrict__ out,
                       F* __restrict__ rr, F* __restrict__ vv, long long R,
                       long long G, long long N, long long a_stride) {
  static_assert(K == 4 || K == 8 || K == 16 || K == 32, "lanes per group");
  const long long grp =
      (blockIdx.x * (long long)kThreads + threadIdx.x) / K;
  // K divides the warp, so a group's lanes leave together
  if (grp >= R * G) return;
  const int lane = threadIdx.x & (K - 1);
  const unsigned mask =
      K == 32 ? 0xffffffffu
              : ((1u << K) - 1u) << ((threadIdx.x & 31) & ~(K - 1));
  const long long r = grp / G;
  const long long g = grp - r * G;
  const F* xr = x + r * N;
  const long long e1 = __ldg(offsets + g + 1);
  F acc = F(0);
  for (long long base = __ldg(offsets + g); base < e1; base += K) {
    const long long e = base + lane;
    F p = F(0);
    if (e < e1) p = mul_rn(__ldg(w + e), __ldg(xr + __ldg(idx + e)));
    const long long left = e1 - base;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const F v = __shfl_sync(mask, p, j, K);
      if (j < left) acc = add_rn(acc, v);
    }
  }
  if (lane != 0) return;
  if (MODE == 0) {
    out[grp] = acc;
    return;
  }
  const F ag = __ldg(a + r * a_stride + g);
  if (MODE == 1) {
    out[grp] = acc > F(0) ? div_rn(ag, acc) : F(0);
    return;
  }
  const F t1 = __ldg(b + grp);
  const F t2 = mul_rn(mul_rn(t1, acc), ag);
  out[grp] = t2;
  if (MODE == 3) {
    const F res = sub_rn(t1, __ldg(c + grp));  // r
    const F curv = sub_rn(sub_rn(t2, t1), res);  // v
    rr[grp] = mul_rn(res, res);
    vv[grp] = mul_rn(curv, curv);
  }
}

template <typename F, int K, int MODE>
int launch_mode(const void* x, const void* w, const void* idx,
                const void* offsets, const void* a, const void* b,
                const void* c, void* out, void* rr, void* vv, long long R,
                long long G, long long N, long long a_stride,
                cudaStream_t stream) {
  const long long threads = R * G * K;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<F, K, MODE><<<static_cast<unsigned int>(blocks),
                                   kThreads, 0, stream>>>(
      static_cast<const F*>(x), static_cast<const F*>(w),
      static_cast<const int32_t*>(idx), static_cast<const int64_t*>(offsets),
      static_cast<const F*>(a), static_cast<const F*>(b),
      static_cast<const F*>(c), static_cast<F*>(out), static_cast<F*>(rr),
      static_cast<F*>(vv), R, G, N, a_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename F, int K>
int launch_k(const void* x, const void* w, const void* idx,
             const void* offsets, const void* a, const void* b,
             const void* c, void* out, void* rr, void* vv, long long R,
             long long G, long long N, long long a_stride, int mode,
             cudaStream_t stream) {
  switch (mode) {
    case 0:
      return launch_mode<F, K, 0>(x, w, idx, offsets, a, b, c, out, rr, vv,
                                  R, G, N, a_stride, stream);
    case 1:
      return launch_mode<F, K, 1>(x, w, idx, offsets, a, b, c, out, rr, vv,
                                  R, G, N, a_stride, stream);
    case 2:
      return launch_mode<F, K, 2>(x, w, idx, offsets, a, b, c, out, rr, vv,
                                  R, G, N, a_stride, stream);
    case 3:
      return launch_mode<F, K, 3>(x, w, idx, offsets, a, b, c, out, rr, vv,
                                  R, G, N, a_stride, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int launch(const void* x, const void* w, const void* idx, const void* offsets,
           const void* a, const void* b, const void* c, void* out, void* rr,
           void* vv, long long R, long long G, long long N,
           long long a_stride, int lanes, int mode, void* stream_ptr) {
  if (R * G <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (lanes) {
    case 4:
      return launch_k<F, 4>(x, w, idx, offsets, a, b, c, out, rr, vv, R,
                            G, N, a_stride, mode, stream);
    case 8:
      return launch_k<F, 8>(x, w, idx, offsets, a, b, c, out, rr, vv, R,
                            G, N, a_stride, mode, stream);
    case 16:
      return launch_k<F, 16>(x, w, idx, offsets, a, b, c, out, rr, vv, R,
                             G, N, a_stride, mode, stream);
    case 32:
      return launch_k<F, 32>(x, w, idx, offsets, a, b, c, out, rr, vv, R,
                             G, N, a_stride, mode, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// mode 0-2; the C interface of the wrapper's plain sums and EM steps
extern "C" int emsar_segment_sum_f32(const void* x, const void* w,
                                     const void* idx, const void* offsets,
                                     const void* a, const void* b, void* out,
                                     long long R, long long G, long long N,
                                     long long a_stride, int lanes, int mode,
                                     void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(x, w, idx, offsets, a, b, nullptr, out, nullptr,
                       nullptr, R, G, N, a_stride, lanes, mode, stream);
}

extern "C" int emsar_segment_sum_f64(const void* x, const void* w,
                                     const void* idx, const void* offsets,
                                     const void* a, const void* b, void* out,
                                     long long R, long long G, long long N,
                                     long long a_stride, int lanes, int mode,
                                     void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(x, w, idx, offsets, a, b, nullptr, out, nullptr,
                        nullptr, R, G, N, a_stride, lanes, mode, stream);
}

// mode 3: x = the read ratio, a = inv_denom, b = t1, c = theta; writes
// t2 to out, r * r to rr and v * v to vv
extern "C" int emsar_em_cycle_update_f32(const void* x, const void* w,
                                         const void* idx,
                                         const void* offsets, const void* a,
                                         const void* b, const void* c,
                                         void* out, void* rr, void* vv,
                                         long long R, long long G,
                                         long long N, long long a_stride,
                                         int lanes, void* stream) {
  return launch<float>(x, w, idx, offsets, a, b, c, out, rr, vv, R, G, N,
                       a_stride, lanes, 3, stream);
}

extern "C" int emsar_em_cycle_update_f64(const void* x, const void* w,
                                         const void* idx,
                                         const void* offsets, const void* a,
                                         const void* b, const void* c,
                                         void* out, void* rr, void* vv,
                                         long long R, long long G,
                                         long long N, long long a_stride,
                                         int lanes, void* stream) {
  return launch<double>(x, w, idx, offsets, a, b, c, out, rr, vv, R, G, N,
                        a_stride, lanes, 3, stream);
}
