// The tile loop of a per-energy sum in FP64, of K13 (ggr_dos.cu):
//
//   out[j] = scale * sum over terms t of f_t(E_j)
//
// for energies E (W,) and terms that a Tile functor stages and sums.
//
// The design:
//  * a block of kTileThreads threads stages a tile of kTileThreads terms,
//    one per thread, into shared memory (Tile::stage: K13 puts a term's
//    closed-form constants there);
//  * each thread owns kTileLanes energy lanes, kTileThreads apart
//    (blockIdx.y picks the block's kTileThreads * kTileLanes lanes), and
//    walks the tile's terms in a fixed order, every thread reading the same
//    term (a shared-memory broadcast; Tile::consume). Interleaved lanes keep
//    a warp's threads on neighbouring energies, so they branch alike, and
//    give each thread the range [emin, emax] of its energies, against which
//    a term's support is tested once for all its lanes;
//  * a block loops over tiles blockIdx.x, blockIdx.x + gridDim.x, ..., so
//    the partials (one row of W per block) stay bounded;
//  * blocks run in no order, so the cross-block sum is a second pass that
//    adds each lane's partials in block order and scales them. No atomics:
//    repeated runs are bit-identical.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"

namespace autobz {

constexpr int kTileThreads = 128;        // threads per block = terms per tile
constexpr int kTileLanes = 8;            // energy lanes per thread
constexpr int kTileMaxBlocks = 8 * 132;  // tiles in flight: eight blocks per SM

__host__ __device__ inline int64_t tile_ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Blocks along x for nterms terms and W energies: one per tile, at most
// kTileMaxBlocks over all the lane groups. The partials hold this many rows.
inline int64_t tile_num_blocks(int64_t nterms, int W) {
  const int64_t groups = tile_ceil_div(W, kTileThreads * kTileLanes);
  int64_t g = kTileMaxBlocks / (groups > 0 ? groups : 1);
  const int64_t tiles = tile_ceil_div(nterms, kTileThreads);
  if (g > tiles) g = tiles;
  return g > 0 ? g : 1;
}

// A thread's energies: lane l holds E[lane0 + l * kTileThreads]; nlive of
// them are real, spanning [emin, emax]; acc[l] is lane l's sum.
struct EnergyLanes {
  double en[kTileLanes], acc[kTileLanes];
  double emin, emax;
  int nlive;
};

namespace {

// partials[blockIdx.x, j] = sum over the block's tiles of sum over their
// terms of f_t(E_j). Tile: a type Shared (the tile's shared memory),
// stage(sh, p) (this thread's term p into slot threadIdx.x of sh) and
// consume(sh, q, lanes) (add term q of the tile into the thread's lanes).
template <class Tile>
__global__ void __launch_bounds__(kTileThreads)
energy_partials_kernel(Tile tile, int64_t nterms, const double* __restrict__ E, int W,
                       double* __restrict__ partials) {
  __shared__ typename Tile::Shared sh;
  EnergyLanes ln;
  const int lane0 = blockIdx.y * (kTileThreads * kTileLanes) + threadIdx.x;
  ln.nlive = lane0 < W ? (W - lane0 + kTileThreads - 1) / kTileThreads : 0;
  ln.emin = __longlong_as_double(0x7ff0000000000000LL);
  ln.emax = -ln.emin;
#pragma unroll
  for (int l = 0; l < kTileLanes; ++l) {
    ln.en[l] = l < ln.nlive ? E[lane0 + l * kTileThreads] : 0.0;
    ln.acc[l] = 0.0;
    if (l < ln.nlive) {
      ln.emin = fmin(ln.emin, ln.en[l]);
      ln.emax = fmax(ln.emax, ln.en[l]);
    }
  }
  const int64_t ntiles = tile_ceil_div(nterms, kTileThreads);
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t p = t * kTileThreads + threadIdx.x;
    __syncthreads();  // the previous tile is consumed
    if (p < nterms) tile.stage(sh, p);
    __syncthreads();
    const int64_t left = nterms - t * kTileThreads;
    const int nt = static_cast<int>(left < kTileThreads ? left : kTileThreads);
    for (int q = 0; ln.nlive > 0 && q < nt; ++q) tile.consume(sh, q, ln);
  }
#pragma unroll
  for (int l = 0; l < kTileLanes; ++l) {
    if (l < ln.nlive) partials[static_cast<int64_t>(blockIdx.x) * W + lane0 + l * kTileThreads] = ln.acc[l];
  }
}

// Both passes on one stream; partials: (tile_num_blocks(nterms, W), W)
// scratch. Returns cudaGetLastError() after each.
template <class Tile>
int energy_tiles_launch(const Tile& tile, int64_t nterms, const double* E, int W, double scale,
                        double* partials, double* out, cudaStream_t st) {
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t groups = tile_ceil_div(W, kTileThreads * kTileLanes);
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t g = tile_num_blocks(nterms, W);
  if (nterms > 0) {
    const dim3 grid(static_cast<unsigned>(g), static_cast<unsigned>(groups));
    energy_partials_kernel<Tile><<<grid, kTileThreads, 0, st>>>(tile, nterms, E, W, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return column_sum_launch(partials, out, nterms > 0 ? g : 0, W, scale, st);
}

}  // namespace

}  // namespace autobz
