// Deterministic gather-multiply-segmented sum over CSR-grouped edges:
//
//   out[r, g] = sum_{e in [offsets[g], offsets[g+1])} w[e] * x[r, idx[e]]
//
// The two segment sums of every CSR EM step: s = sum over a segment's
// edges of mult * theta[tid] (edges grouped by cid), and num = sum over a
// transcript's edges of mult * (R / s)[cid] (edges grouped by tid).  It
// replaces the two `jax.ops.segment_sum` calls of
// emsar_tpu/model/solver.py::_em_solve (XLA ops, not a Pallas kernel),
// whose torch counterpart `index_add_` sums with float atomics on CUDA in
// an order that changes from launch to launch.
//
// Why no atomics: one thread owns one (row, segment) output and adds its
// edges one after another in edge order, so the summation order is fixed
// by the CSR layout alone.  Two launches on the same input give the same
// bits, and the order equals that of the sequential CPU `index_add_` over
// the same edge order (products and sums are rounded separately, no FMA
// contraction), so the plain version on the CPU gives the same bits too.
//
// What bounds it on the H100: bytes, not arithmetic.  Each edge costs one
// multiply-add against a random 4- or 8-byte gather of x (theta or the
// read ratio) plus a streaming read of idx (8 B) and w; the gathers hit L2
// (the x rows of a real problem are a few MB, under the 50 MB L2).  Load
// balance follows the segment sizes: a segment with many edges keeps its
// thread longer; EMSAR's segments hold a handful of transcripts and a
// transcript a few hundred segments at most, so one thread per output is
// kept over a warp-per-segment tree, whose fixed reduction shape would
// change the order relative to the CPU.
//
// Layout: x [R, N] contiguous; w [E]; idx [E] and offsets [G + 1] int64;
// out [R, G].  float or double.

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

template <typename F>
__global__ void segment_sum_kernel(const F* __restrict__ x,
                                   const F* __restrict__ w,
                                   const int64_t* __restrict__ idx,
                                   const int64_t* __restrict__ offsets,
                                   F* __restrict__ out, long long R,
                                   long long G, long long N) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= R * G) return;
  const long long r = t / G;
  const long long g = t - r * G;
  const F* xr = x + r * N;
  const long long e1 = offsets[g + 1];
  F acc = F(0);
  for (long long e = offsets[g]; e < e1; ++e)
    acc = add_rn(acc, mul_rn(w[e], __ldg(xr + idx[e])));
  out[t] = acc;
}

template <typename F>
int launch(const void* x, const void* w, const void* idx, const void* offsets,
           void* out, long long R, long long G, long long N, void* stream) {
  const long long n = R * G;
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<F><<<(unsigned int)blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const F*>(x), static_cast<const F*>(w),
      static_cast<const int64_t*>(idx), static_cast<const int64_t*>(offsets),
      static_cast<F*>(out), R, G, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int emsar_segment_sum_f32(const void* x, const void* w,
                                     const void* idx, const void* offsets,
                                     void* out, long long R, long long G,
                                     long long N, void* stream) {
  return launch<float>(x, w, idx, offsets, out, R, G, N, stream);
}

extern "C" int emsar_segment_sum_f64(const void* x, const void* w,
                                     const void* idx, const void* offsets,
                                     void* out, long long R, long long G,
                                     long long N, void* stream) {
  return launch<double>(x, w, idx, offsets, out, R, G, N, stream);
}
