// K2: weighted k-sum of the Lorentzian-broadened DOS trace, in FP64.
//
// Replaces autobzcore_tpu/models/observables.py:149 dos_trace (through
// :108 greens_function_trace and :73 _trace_inv_small) as summed by the PTR
// rule, autobzcore_tpu/algorithms/ptr.py:77-83 (utils/tree.py:39
// tree_weighted_sum). For every frequency lane w it computes
//
//   D(w) = scale * sum_k w_k * (-Im Tr (z_w I - H_k)^{-1}) / pi,
//   z_w = omega_w + i eta_w,
//
// with the reference's closed forms for m <= 3: 1/M for m = 1, tr/det for
// m = 2 and the adjugate identity (tr^2 - tr M^2) / (2 det) for m = 3.
//
// The closed forms live in small_trace.cuh, shared with K4.
//
// What bounds it on an H100: every (w, k) pair costs one 3x3 complex
// determinant, a trace of M^2 and a complex division, about 200 FP64 flops.
// At the flagship shape (W = 264, K = 1e6) that is ~5e10 flops against a
// 144 MB read of H, so FP64 arithmetic is the limit; H must not be read
// once per frequency, and the (W, K) matrix of traces must never exist.
//
// What the design does about it:
//  * a block covers 32 frequency lanes (one per thread of a warp) and a
//    chunk of kChunkK k-points; it stages H_k and w_k through shared memory
//    in tiles of kTileK, and its four warps take every fourth k of a tile.
//    All threads of a warp read the same H_k, which shared memory broadcasts;
//  * blocks of one k-chunk are adjacent in launch order (frequency tiles on
//    blockIdx.x), so H is fetched from device memory about once and re-read
//    from L2 by the other frequency tiles;
//  * the grid's y extent is capped (at 65535, the hardware's limit, unless
//    the caller lowers it), and a block row loops over k-chunks blockIdx.y,
//    blockIdx.y + gridDim.y, ..., so any number of k-points takes one
//    launch;
//  * blocks run in no order, so the cross-block sum is a second pass: each
//    k-chunk writes one partial per lane (one row per 4096 k-points, 0.4 %
//    of H's bytes at 264 lanes), and column_sum.cuh's pass adds the
//    partials of each lane in chunk order. Each chunk's partial is computed the same way
//    whatever the grid, so the result does not depend on the cap, and with
//    no atomics repeated runs are bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"
#include "small_trace.cuh"

namespace {

using autobz::trace_inv_imag;

constexpr int kLanes = 32;     // frequency lanes per block
constexpr int kKWarps = 4;     // warps per block, each over every fourth k
constexpr int kTileK = 128;    // k-points per shared tile
constexpr int kChunkK = 4096;  // k-points per block (one partial per lane)
constexpr int kThreads = kLanes * kKWarps;

template <int M>
__global__ void __launch_bounds__(kThreads)
dos_partials_kernel(const double2* __restrict__ H, const double* __restrict__ w,
                    const double* __restrict__ omega, const double* __restrict__ eta,
                    double* __restrict__ partials, int64_t K, int W) {
  constexpr int MM = M * M;
  __shared__ double2 hs[kTileK * MM];
  __shared__ double ws[kTileK];
  __shared__ double red[kKWarps][kLanes];

  const int lane = threadIdx.x % kLanes;
  const int kw = threadIdx.x / kLanes;
  const int wi = blockIdx.x * kLanes + lane;
  const bool live = wi < W;
  const double2 z = live ? make_double2(omega[wi], eta[wi]) : make_double2(0.0, 1.0);

  const int64_t nchunks = (K + kChunkK - 1) / kChunkK;
  for (int64_t c = blockIdx.y; c < nchunks; c += gridDim.y) {
    const int64_t kbeg = c * kChunkK;
    const int64_t kend = K < kbeg + kChunkK ? K : kbeg + kChunkK;
    double acc = 0.0;
    for (int64_t t0 = kbeg; t0 < kend; t0 += kTileK) {
      const int nk = static_cast<int>(kend - t0 < kTileK ? kend - t0 : kTileK);
      __syncthreads();  // the previous tile (and chunk's reduction) is consumed
      for (int i = threadIdx.x; i < nk * MM; i += kThreads) hs[i] = H[t0 * MM + i];
      for (int i = threadIdx.x; i < nk; i += kThreads) ws[i] = w[t0 + i];
      __syncthreads();
      for (int j = kw; j < nk; j += kKWarps) acc += ws[j] * trace_inv_imag<M>(hs + j * MM, z);
    }
    red[kw][lane] = acc;
    __syncthreads();
    if (kw == 0 && live) {
      double s = red[0][lane];
#pragma unroll
      for (int q = 1; q < kKWarps; ++q) s += red[q][lane];
      partials[c * W + wi] = s;
    }
  }
}

}  // namespace

// Number of k-chunks, i.e. rows of the partials scratch the caller allocates.
extern "C" long long dos_trace_num_chunks(long long K) { return (K + kChunkK - 1) / kChunkK; }

// H: (K, m, m) complex128 as double2; w: (K,); omega, eta: (W,); partials:
// (num_chunks(K), W); out: (W,), all float64. out = -scale/pi * sum_k w_k Im Tr(...).
// max_grid_y caps the grid's y extent (<= 0 or above 65535: 65535); a lower
// cap makes every block row loop over more k-chunks and gives the same bits.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for m outside 1..3.
extern "C" int dos_trace_weighted_sum_launch(const void* H, const void* w, const void* omega,
                                             const void* eta, void* partials, void* out,
                                             long long K, int W, int m, double factor,
                                             int max_grid_y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nchunks = dos_trace_num_chunks(K);
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  if (m < 1 || m > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = max_grid_y <= 0 || max_grid_y > 65535 ? 65535 : max_grid_y;
  if (nchunks > 0) {
    const dim3 grid((W + kLanes - 1) / kLanes,
                    static_cast<unsigned>(nchunks < cap ? nchunks : cap));
    const auto* Hp = static_cast<const double2*>(H);
    const auto* wp = static_cast<const double*>(w);
    const auto* op = static_cast<const double*>(omega);
    const auto* ep = static_cast<const double*>(eta);
    auto* pp = static_cast<double*>(partials);
    if (m == 1) {
      dos_partials_kernel<1><<<grid, kThreads, 0, st>>>(Hp, wp, op, ep, pp, K, W);
    } else if (m == 2) {
      dos_partials_kernel<2><<<grid, kThreads, 0, st>>>(Hp, wp, op, ep, pp, K, W);
    } else {
      dos_partials_kernel<3><<<grid, kThreads, 0, st>>>(Hp, wp, op, ep, pp, K, W);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return autobz::column_sum_launch(static_cast<const double*>(partials), static_cast<double*>(out), nchunks, W,
                                   factor, st);
}
