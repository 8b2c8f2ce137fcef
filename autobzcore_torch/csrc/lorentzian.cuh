// The Lorentzian omega x k sum in FP64, shared by K7 (fullgrid_tail.cu) and
// K8 (lorentzian_sum.cu):
//
//   S(w) = scale * eta * sum_p w_p sum_b 1 / ((omega_w - e_b(p))^2 + eta^2)
//
// over points p with NB eigenvalues each, which a loader computes or reads.
//
// What bounds it on an H100: every (omega, point, band) triple costs a
// subtraction, an FMA, a reciprocal and an FMA into the sum. The reciprocal
// (__drcp_rn) is a sequence of about four DFMAs after a MUFU estimate, so a
// term is ~13 FP64 operations. At the full-grid rung (6.4e7 points x 3 bands
// x 1024 omegas at npt = 400) that is 2.6e12 operations (75 ms at 34
// TFLOP/s) against 6 GB of entry planes (1.8 ms at 3.35 TB/s): FP64
// arithmetic is the limit, about 40 times over, so the design keeps every
// term in registers and never forms the (omega, point) matrix.
//
// The design:
//  * a block of kThreads threads loads a tile of kTile points, one per
//    thread, and puts their eigenvalues and weights in shared memory; then
//    each thread owns kLanes omega lanes (blockIdx.y picks the block's
//    kThreads * kLanes lanes) and walks the tile in a fixed order, all threads
//    reading the same point, which shared memory broadcasts;
//  * a block loops over tiles blockIdx.x, blockIdx.x + gridDim.x, ..., so
//    the partials (one row of W per block) stay bounded whatever the number
//    of points;
//  * points of zero weight (the pad rows of a slab) are skipped, uniformly
//    across the block;
//  * blocks run in no order, so the cross-block sum is a second pass that
//    adds each lane's partials in block order. No atomics: repeated runs are
//    bit-identical.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"

namespace autobz {

constexpr int kLorThreads = 256;       // threads per block = points per tile
constexpr int kLorLanes = 4;           // omega lanes per thread
constexpr int kLorMaxBlocks = 8 * 132;  // tiles in flight: eight blocks per SM

__host__ __device__ inline int64_t lor_ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Blocks along x for npoints points and W lanes: one per tile, at most
// kLorMaxBlocks over all the lane groups. The partials hold this many rows.
inline int64_t lor_num_blocks(int64_t npoints, int W) {
  const int64_t groups = lor_ceil_div(W, kLorThreads * kLorLanes);
  int64_t g = kLorMaxBlocks / (groups > 0 ? groups : 1);
  const int64_t tiles = lor_ceil_div(npoints, kLorThreads);
  if (g > tiles) g = tiles;
  return g > 0 ? g : 1;
}

namespace {

// partials[blockIdx.x, w] = sum over the block's tiles of sum_p w_p sum_b
// 1 / ((omega_w - e_b(p))^2 + eta^2). Loader: ld(p, e, w) fills the NB
// eigenvalues and the weight of point p.
template <int NB, class Loader>
__global__ void __launch_bounds__(kLorThreads)
lorentz_partials_kernel(Loader ld, int64_t npoints, const double* __restrict__ omega, int W,
                        double eta2, double* __restrict__ partials) {
  __shared__ double es[NB][kLorThreads];
  __shared__ double ws[kLorThreads];
  const int lane0 = blockIdx.y * (kLorThreads * kLorLanes) + threadIdx.x;
  double om[kLorLanes], acc[kLorLanes];
#pragma unroll
  for (int l = 0; l < kLorLanes; ++l) {
    const int wi = lane0 + l * kLorThreads;
    om[l] = wi < W ? omega[wi] : 0.0;
    acc[l] = 0.0;
  }
  const int64_t ntiles = lor_ceil_div(npoints, kLorThreads);
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t p = t * kLorThreads + threadIdx.x;
    double e[NB];
    double w = 0.0;
#pragma unroll
    for (int b = 0; b < NB; ++b) e[b] = 0.0;
    if (p < npoints) ld(p, e, w);
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int b = 0; b < NB; ++b) es[b][threadIdx.x] = e[b];
    ws[threadIdx.x] = w;
    __syncthreads();
    const int64_t left = npoints - t * kLorThreads;
    const int nt = static_cast<int>(left < kLorThreads ? left : kLorThreads);
    for (int j = 0; j < nt; ++j) {
      const double wj = ws[j];
      if (wj == 0.0) continue;  // pad rows: the same j for every thread
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const double ej = es[b][j];
#pragma unroll
        for (int l = 0; l < kLorLanes; ++l) {
          const double d = om[l] - ej;
          acc[l] = fma(wj, __drcp_rn(fma(d, d, eta2)), acc[l]);
        }
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kLorLanes; ++l) {
    const int wi = lane0 + l * kLorThreads;
    if (wi < W) partials[static_cast<int64_t>(blockIdx.x) * W + wi] = acc[l];
  }
}

// Both passes on one stream; returns cudaGetLastError() after each.
template <int NB, class Loader>
int lorentz_launch(const Loader& ld, int64_t npoints, const double* omega, int W, double eta,
                   double scale, double* partials, double* out, int accumulate,
                   cudaStream_t st) {
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t groups = lor_ceil_div(W, kLorThreads * kLorLanes);
  const int64_t g = lor_num_blocks(npoints, W);
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (npoints > 0) {
    const dim3 grid(static_cast<unsigned>(g), static_cast<unsigned>(groups));
    lorentz_partials_kernel<NB><<<grid, kLorThreads, 0, st>>>(ld, npoints, omega, W, eta * eta,
                                                              partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return column_sum_launch(partials, out, npoints > 0 ? g : 0, W, scale * eta, st, accumulate);
}

}  // namespace

}  // namespace autobz
