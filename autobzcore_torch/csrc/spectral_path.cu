// K29: the momentum-resolved spectral map along a k-path, in FP64.
//
// Replaces autobzcore_tpu/models/kpath.py:123-131 (spectral_path's
// broadcast Lorentzian and its band sum). For band energies e (K, m) at K
// path points, frequencies w (W,) and one broadening eta it writes
//
//   A[k, j] = (1/pi) sum_n eta / ((w_j - e[k, n])^2 + eta^2),
//
// the (K, W) map itself: K8's Lorentzian sum (lorentzian_sum.cu) kept per
// point instead of reduced over k.
//
// What bounds it on an H100: at the flagship path (K = 3,787 points, m = 3,
// W = 4,001) the map is 121 MB of output against 13 FP64 operations a term
// (4.5e7 terms): the writes bound it (0.036 ms at 3.35 TB/s). At m = 30 the
// terms take over (about 0.17 ms at 34 TFLOP/s).
//
// The design: a block covers kThreads consecutive frequencies of kRows
// consecutive path points (a grid-stride loop over row tiles past the
// grid's y limit), their energies staged in shared memory; a thread keeps
// its frequency and writes its column of the tile, so consecutive threads
// write consecutive addresses and the stores coalesce, and a block has
// kRows stores in flight per thread. Each thread sums its bands in
// ascending order and scales once by 1/pi; there are no atomics, so
// repeats are bit-identical and a value does not depend on the launch
// shape.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;          // path points a block covers
constexpr int kMaxTiles = 65535;  // the grid's y limit
constexpr int kMaxBands = 768;    // a tile's energies staged in 48 KB of shared memory

__global__ void __launch_bounds__(kThreads)
spectral_path_kernel(const double* __restrict__ e, const double* __restrict__ w, double* __restrict__ out,
                     int64_t K, int m, int W, double eta, double inv_pi) {
  extern __shared__ double es[];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const double wj = j < W ? __ldg(w + j) : 0.0;
  const double eta2 = eta * eta;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * kRows;
  for (int64_t k0 = static_cast<int64_t>(blockIdx.y) * kRows; k0 < K; k0 += stride) {
    const int nr = static_cast<int>(K - k0 < kRows ? K - k0 : kRows);
    __syncthreads();  // the previous tile's energies are consumed
    for (int n = threadIdx.x; n < nr * m; n += kThreads) es[n] = e[k0 * m + n];
    __syncthreads();
    if (j < W) {
      for (int r = 0; r < nr; ++r) {
        const double* er = es + r * m;
        double acc = 0.0;
        for (int n = 0; n < m; ++n) {
          const double x = wj - er[n];
          acc += eta / (x * x + eta2);
        }
        out[(k0 + r) * W + j] = acc * inv_pi;
      }
    }
  }
}

}  // namespace

// The largest band count K29 takes (its energies staged in shared memory).
extern "C" int spectral_path_max_bands() { return kMaxBands; }

// e: (K, m) float64; w: (W,) float64; out: (K, W) float64, written.
// Returns cudaErrorInvalidValue for m outside 1..spectral_path_max_bands(),
// else cudaGetLastError() after the launch.
extern "C" int spectral_path_launch(const void* e, const void* w, void* out, long long K, int m, int W, double eta,
                                    double inv_pi, void* stream) {
  if (m < 1 || m > kMaxBands) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const long long tiles = (K + kRows - 1) / kRows;
  const dim3 grid((W + kThreads - 1) / kThreads, static_cast<unsigned>(tiles < kMaxTiles ? tiles : kMaxTiles));
  spectral_path_kernel<<<grid, kThreads, static_cast<size_t>(kRows) * m * sizeof(double),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(e), static_cast<const double*>(w), static_cast<double*>(out),
      static_cast<int64_t>(K), m, W, eta, inv_pi);
  return static_cast<int>(cudaGetLastError());
}
