// The second pass of the two-pass kernels (K8, K10, K13, K19, K27, K28):
// out[i] = scale * sum_r partials[r, i] over nrows rows of n columns,
// summed in row order. The first pass writes one partial row per block or
// k-chunk and no atomics, so repeats are bit-identical and the sums do not
// depend on the first pass's launch shape. T is double, or double2 summed
// componentwise; with accumulate, out[i] += scale * sum instead.
//
// K2 and K25 lay their partials out lane by lane, (n, nrows), and take
// lane_sum_launch: a block of kLaneSumThreads threads a lane, so a lane of
// many rows (30,518 at 1.25e8 k-points) is read by 256 threads and not by
// one thread in a dependent chain of loads.
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

__device__ __forceinline__ double colsum_shfl_xor(double s, int off) { return __shfl_xor_sync(0xffffffffu, s, off); }
__device__ __forceinline__ double2 colsum_shfl_xor(double2 s, int off) {
  return make_double2(__shfl_xor_sync(0xffffffffu, s.x, off), __shfl_xor_sync(0xffffffffu, s.y, off));
}

constexpr int kLaneSumThreads = 256;

// out[i] = scale * sum_r partials[i, r], a block per lane i: thread t adds
// entries t, t + 256, ... in order, a warp's 32 sums meet in a butterfly
// (both partners of each step add the same two values, so every thread ends
// with the same bits), and thread 0 adds the 8 warp sums in warp order. The
// order depends on nrows alone.
template <class T>
__global__ void __launch_bounds__(kLaneSumThreads)
lane_sum_kernel(const T* __restrict__ partials, T* __restrict__ out, int64_t nrows, double scale) {
  __shared__ T warp_sums[kLaneSumThreads / 32];
  const T* row = partials + static_cast<int64_t>(blockIdx.x) * nrows;
  T s = T();
  for (int64_t r = threadIdx.x; r < nrows; r += kLaneSumThreads) s = colsum_add(s, row[r]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = colsum_add(s, colsum_shfl_xor(s, off));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = warp_sums[0];
#pragma unroll
    for (int q = 1; q < kLaneSumThreads / 32; ++q) t = colsum_add(t, warp_sums[q]);
    out[blockIdx.x] = colsum_scale(t, scale);
  }
}

// One launch on st for n lanes of nrows partials each, laid out (n, nrows);
// returns cudaGetLastError().
template <class T>
int lane_sum_launch(const T* partials, T* out, int64_t nrows, int64_t n, double scale, cudaStream_t st) {
  if (n > 0) {
    lane_sum_kernel<T><<<static_cast<unsigned>(n), kLaneSumThreads, 0, st>>>(partials, out, nrows, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace autobz
