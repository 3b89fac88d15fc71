// The vector work of one stabilized SQUAREM cycle of the CSR EM solver
// (model/solver.py::_squarem_cycle) and of the gain at the end of a block
// (model/solver.py::em_solve, parallel/mesh.py::solve_sharded), rows
// r < R of theta [R, T] and of the intensities [R, C]:
//
//   cycle_extrap: from theta, t1, t2 (two EM steps from theta) and the row
//     sums of r * r and v * v (r = t1 - theta, v = (t2 - t1) - r):
//       alpha  = sqrt(vv) > 0 ? -sqrt(rr) / sqrt(vv) : -1, at most -1
//       extrap = (theta - (2 alpha) r) + (alpha alpha) v
//       out    = extrap > 0 ? extrap : t2      (the third EM step's input)
//   pair_gain: the intensities of two thetas (segment sums of mult *
//     theta[:, tid] by cid, both in one pass over the edges) or of one
//     theta against intensities read, and the likelihood gain term of
//     each segment (model/solver.py::gain_of before its sum):
//       term = both > 0 ? reads * log1p((s_new - s_old) / s_old)
//                       : (born - died) * 1e30
//       out  = term - eumaps * (s_new - s_old)
//   cycle_select: out = gain[r] >= 0 ? cand : t2     (the accept test)
//
// They replace the elementwise XLA ops of
// emsar_tpu/model/solver.py::_em_solve's squarem_cycle (:150) and gain_of
// (:134): on the card, some 60 small torch kernels a cycle.  With the EM
// steps (csrc/segment_sum.cu, whose mode 3 writes r * r and v * v) and
// the three row sums, which stay torch.sum over the tensors the torch
// body reduces, a cycle is twelve launches.
//
// Bits.  Every product, quotient, difference and root is rounded on its
// own (the _rn intrinsics: nvcc contracts no FMA here), in torch's order
// of evaluation, so each output equals the torch body's on the same
// inputs.  Comparisons are IEEE's: false for NaN, so a NaN intensity
// makes both, died and born false; clamp(alpha, max=-1) keeps a NaN
// alpha as torch.clamp does; a read-less segment whose ratio rounds to
// -1 gives reads * log1p(-1) = 0 * -inf = NaN, as torch does (the NaN
// block gain that stops a solve).  log1p is CUDA's, the function torch's
// own CUDA kernel calls.  The intensities fold the products of a segment
// in edge order from 0, as csrc/segment_sum.cu does: the bits of
// sum_groups.
//
// What bounds it on the H100: bytes, and in practice launch latency.  At
// the smoke workload's CSR shape (R 1, f64; 27,619 segments, 89,744
// edges, 12,090 transcripts) pair_gain moves ~2.1 MB (the by-cid edges,
// two thetas, reads, eumaps, the terms), cycle_extrap ~0.4 MB and
// cycle_select ~0.3 MB: ~0.85 us at 3.35 TB/s against a few us of launch
// each.  So the design cuts launches: one pass computes both intensities
// and their gain terms, one computes the step length and the
// extrapolation (each thread recomputes its row's alpha from two loaded
// sums rather than taking another launch), and r and v are recomputed
// from theta, t1 and t2 instead of being stored.  pair_gain uses a group
// of K lanes a segment as segment_sum.cu does (K from the mean edges per
// segment): K gathers in flight, then K dependent add_rn on shuffled
// values, both sums side by side.
//
// Layout: theta, t1, t2, cand, x_old, x_new and out [R, T] or [R, N]
// contiguous; rsum, vsum and gain [R]; w [E]; idx [E] int32; offsets
// [G + 1] int64; reads and eumaps [G] (a_stride 0) or [R, G] (a_stride
// G); s_old, s_out and the terms [R, G].  float or double.

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

// A group of K lanes a (row, segment): the intensities of x_new and, with
// TWO, of x_old (else s_old is read), then the gain term; with s_out the
// intensity of x_new is written too.
template <typename F, int K, bool TWO>
__global__ void __launch_bounds__(kThreads)
    pair_gain_kernel(const F* __restrict__ x_new, const F* __restrict__ x_old,
                     const F* __restrict__ s_old, const F* __restrict__ w,
                     const int32_t* __restrict__ idx,
                     const int64_t* __restrict__ offsets,
                     const F* __restrict__ reads,
                     const F* __restrict__ eumaps, F* __restrict__ s_out,
                     F* __restrict__ out, long long R, long long G,
                     long long N, long long a_stride) {
  static_assert(K == 4 || K == 8 || K == 16 || K == 32, "lanes per group");
  const long long grp =
      (blockIdx.x * (long long)kThreads + threadIdx.x) / K;
  // K divides the warp, so a group's lanes leave together
  if (grp >= R * G) return;
  const int lane = threadIdx.x & (K - 1);
  const unsigned mask =
      K == 32 ? 0xffffffffu
              : ((1u << K) - 1u) << ((threadIdx.x & 31) & ~(K - 1));
  const long long row = grp / G;
  const long long g = grp - row * G;
  const F* xn = x_new + row * N;
  const F* xo = TWO ? x_old + row * N : nullptr;
  const long long e1 = __ldg(offsets + g + 1);
  F acc_new = F(0), acc_old = F(0);
  for (long long base = __ldg(offsets + g); base < e1; base += K) {
    const long long e = base + lane;
    F p_new = F(0), p_old = F(0);
    if (e < e1) {
      const F we = __ldg(w + e);
      const int32_t j = __ldg(idx + e);
      p_new = mul_rn(we, __ldg(xn + j));
      if (TWO) p_old = mul_rn(we, __ldg(xo + j));
    }
    const long long left = e1 - base;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const F vn = __shfl_sync(mask, p_new, k, K);
      F vo = F(0);
      if (TWO) vo = __shfl_sync(mask, p_old, k, K);
      if (k < left) {
        acc_new = add_rn(acc_new, vn);
        if (TWO) acc_old = add_rn(acc_old, vo);
      }
    }
  }
  if (lane != 0) return;
  const F so = TWO ? acc_old : __ldg(s_old + grp);
  if (s_out != nullptr) s_out[grp] = acc_new;
  const long long a = row * a_stride + g;
  out[grp] = gain_term(__ldg(reads + a), __ldg(eumaps + a), so, acc_new);
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

template <typename F, int K>
int launch_pair_k(const void* x_new, const void* x_old, const void* s_old,
                  const void* w, const void* idx, const void* offsets,
                  const void* reads, const void* eumaps, void* s_out,
                  void* out, long long R, long long G, long long N,
                  long long a_stride, cudaStream_t stream) {
  const long long blocks = blocks_for(R * G * K);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  const F* xo = static_cast<const F*>(x_old);
  if (xo != nullptr) {
    pair_gain_kernel<F, K, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const F*>(x_new), xo, nullptr, static_cast<const F*>(w),
        static_cast<const int32_t*>(idx),
        static_cast<const int64_t*>(offsets), static_cast<const F*>(reads),
        static_cast<const F*>(eumaps), static_cast<F*>(s_out),
        static_cast<F*>(out), R, G, N, a_stride);
  } else {
    pair_gain_kernel<F, K, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const F*>(x_new), nullptr, static_cast<const F*>(s_old),
        static_cast<const F*>(w), static_cast<const int32_t*>(idx),
        static_cast<const int64_t*>(offsets), static_cast<const F*>(reads),
        static_cast<const F*>(eumaps), static_cast<F*>(s_out),
        static_cast<F*>(out), R, G, N, a_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_pair(const void* x_new, const void* x_old, const void* s_old,
                const void* w, const void* idx, const void* offsets,
                const void* reads, const void* eumaps, void* s_out,
                void* out, long long R, long long G, long long N,
                long long a_stride, int lanes, void* stream_ptr) {
  if (R * G <= 0) return 0;
  if ((x_old == nullptr) == (s_old == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (lanes) {
    case 4:
      return launch_pair_k<F, 4>(x_new, x_old, s_old, w, idx, offsets, reads,
                                 eumaps, s_out, out, R, G, N, a_stride,
                                 stream);
    case 8:
      return launch_pair_k<F, 8>(x_new, x_old, s_old, w, idx, offsets, reads,
                                 eumaps, s_out, out, R, G, N, a_stride,
                                 stream);
    case 16:
      return launch_pair_k<F, 16>(x_new, x_old, s_old, w, idx, offsets,
                                  reads, eumaps, s_out, out, R, G, N,
                                  a_stride, stream);
    case 32:
      return launch_pair_k<F, 32>(x_new, x_old, s_old, w, idx, offsets,
                                  reads, eumaps, s_out, out, R, G, N,
                                  a_stride, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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

// pair_gain: exactly one of x_old (two intensities) and s_old (one read)
// is given; s_out may be null
extern "C" int emsar_pair_gain_f32(const void* x_new, const void* x_old,
                                   const void* s_old, const void* w,
                                   const void* idx, const void* offsets,
                                   const void* reads, const void* eumaps,
                                   void* s_out, void* out, long long R,
                                   long long G, long long N,
                                   long long a_stride, int lanes,
                                   void* stream) {
  return launch_pair<float>(x_new, x_old, s_old, w, idx, offsets, reads,
                            eumaps, s_out, out, R, G, N, a_stride, lanes,
                            stream);
}

extern "C" int emsar_pair_gain_f64(const void* x_new, const void* x_old,
                                   const void* s_old, const void* w,
                                   const void* idx, const void* offsets,
                                   const void* reads, const void* eumaps,
                                   void* s_out, void* out, long long R,
                                   long long G, long long N,
                                   long long a_stride, int lanes,
                                   void* stream) {
  return launch_pair<double>(x_new, x_old, s_old, w, idx, offsets, reads,
                             eumaps, s_out, out, R, G, N, a_stride, lanes,
                             stream);
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
