// K17: a fixed quadrature rule reduced over segments, in FP64.
//
// Replaces the reduction of autobzcore_tpu/ops/adaptive.py:644
// fixed_rule_eval (:666-677; QuadratureFunction, alone and as a fixed level
// of NestedQuad, autobzcore_tpu/algorithms/nested.py:481-490): for lane l
// and channel c of node values fx (L, S, npt, C), weights w (npt) and the
// segments' half widths half (L, S),
//
//   out[l, c] = sum_s (sum_j w_j fx[l, s, j, c]) half[l, s],
//
// the reference's two-level order: over the nodes first, times the half
// width, then over the segments. Complex values arrive as (re, im) pairs, so
// C counts doubles (the weights and half widths are real).
//
// What bounds it on an H100: it reads every node value once and does two
// flops with it, so bytes bound it; at a nest level's widths (tens of lanes,
// a few hundred nodes) launch latency does.
//
// What the design does about it: one thread per (lane, channel), adjacent
// threads on adjacent channels, each summing its nodes and segments in a
// fixed order, so repeats are bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fixed_rule_reduce_kernel(const double* __restrict__ fx, const double* __restrict__ w,
                         const double* __restrict__ half, double* __restrict__ out, int64_t L,
                         int S, int P, int C) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= L * C) return;
  const int64_t l = t / C;
  const int c = static_cast<int>(t - l * C);
  double acc = 0.0;
  for (int s = 0; s < S; ++s) {
    const double* f = fx + ((l * S + s) * P) * C + c;
    double seg = 0.0;
    for (int j = 0; j < P; ++j) seg += w[j] * f[static_cast<int64_t>(j) * C];
    acc += seg * half[l * S + s];
  }
  out[t] = acc;
}

}  // namespace

// fx: (L, S, P, C) doubles; w: (P,); half: (L, S); out: (L, C). Returns
// cudaGetLastError() after the launch.
extern "C" int fixed_rule_reduce_launch(const void* fx, const void* w, const void* half, void* out,
                                        long long L, int S, int P, int C, void* stream) {
  if (S < 1 || P < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  const long long threads = L * C;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  fixed_rule_reduce_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(fx), static_cast<const double*>(w),
      static_cast<const double*>(half), static_cast<double*>(out), L, S, P, C);
  return static_cast<int>(cudaGetLastError());
}
