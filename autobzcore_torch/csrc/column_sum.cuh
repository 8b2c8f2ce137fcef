// The second pass of the two-pass kernels (K2, K8, K10, K13, K19, K25, K27,
// K28): out[i] = scale * sum_r partials[r, i] over nrows rows of n columns,
// summed in row order. The first pass writes one partial row per block or
// k-chunk and no atomics, so repeats are bit-identical and the sums do not
// depend on the first pass's launch shape. T is double, or double2 summed
// componentwise; with accumulate, out[i] += scale * sum instead.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace autobz {

namespace {

__device__ __forceinline__ double colsum_add(double s, double x) { return s + x; }
__device__ __forceinline__ double2 colsum_add(double2 s, double2 x) { return make_double2(s.x + x.x, s.y + x.y); }
__device__ __forceinline__ double colsum_scale(double s, double f) { return f * s; }
__device__ __forceinline__ double2 colsum_scale(double2 s, double f) { return make_double2(f * s.x, f * s.y); }

template <class T>
__global__ void column_sum_kernel(const T* __restrict__ partials, T* __restrict__ out, int64_t nrows, int64_t n,
                                  double scale, int accumulate) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T s = T();
  for (int64_t r = 0; r < nrows; ++r) s = colsum_add(s, partials[r * n + i]);
  out[i] = accumulate ? colsum_add(out[i], colsum_scale(s, scale)) : colsum_scale(s, scale);
}

// One launch on st; returns cudaGetLastError().
template <class T>
int column_sum_launch(const T* partials, T* out, int64_t nrows, int64_t n, double scale, cudaStream_t st,
                      int accumulate = 0) {
  if (n > 0) {
    column_sum_kernel<T><<<static_cast<unsigned>((n + 127) / 128), 128, 0, st>>>(partials, out, nrows, n, scale,
                                                                                 accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace autobz
