// K7: the fused tail of a full-grid rung slab, in FP64: closed-form
// eigenvalues of every grid point's Hermitian H(k) (m <= 3) and the weighted
// Lorentzian sum over all omegas, added to the rung's accumulator.
//
// Replaces the tail of the reference's slab body,
// autobzcore_tpu/ops/grid_sweep.py:259-321 (FullGridSpectralSweep._make_run:
// eigvalsh3_rows of autobzcore_tpu/ops/eigh3.py:106 for m = 3, the
// diagonal for m = 1, and the omega-batched two-float Lorentzian reduction),
// and eigvalsh2 (eigh3.py:17) for m = 2, which the reference reaches through
// its general-m route. Here every step is native FP64.
//
// Input: the slab's entry planes as stage B leaves them, complex128 (ne, N)
// entry-major over the slab's N points: the m diagonals first (their
// imaginary parts are ignored, as the reference drops them), then the
// m(m-1)/2 upper off-diagonals row-major. Point p lies in slab row
// (p / inner) % R and takes that row's weight (0 on pad rows).
//
// What bounds it, and the design: see lorentzian.cuh. The eigenvalues cost
// ~200 FP64 operations per point against 13 per (point, band, omega) term,
// 1/200 of the work at W = 1024; they are computed in registers by the
// thread that loads the point and go to shared memory with the tile.

#include <cuda_runtime.h>

#include <cstdint>

#include "lorentzian.cuh"
#include "small_eigen.cuh"

namespace {

template <int M>
struct SlabLoader {
  const double2* planes;
  const double* wrow;
  int64_t N;
  int64_t inner;
  int R;

  __device__ __forceinline__ void operator()(int64_t p, double (&e)[M], double& w) const {
    w = wrow[(p / inner) % R];
    if constexpr (M == 1) {
      e[0] = __ldg(&planes[p].x);
    } else if constexpr (M == 2) {
      const double2 b = __ldg(&planes[2 * N + p]);
      autobz::eig2(__ldg(&planes[p].x), __ldg(&planes[N + p].x), b.x, b.y, e[0], e[1]);
    } else {
      const double2 h12 = __ldg(&planes[3 * N + p]);
      const double2 h13 = __ldg(&planes[4 * N + p]);
      const double2 h23 = __ldg(&planes[5 * N + p]);
      double e1, e2, e3;
      autobz::cardano3(__ldg(&planes[p].x), __ldg(&planes[N + p].x), __ldg(&planes[2 * N + p].x),
                       h12.x, h12.y, h13.x, h13.y, h23.x, h23.y, e1, e2, e3);
      // the reference's exchange network: lo, mid, hi
      const double lo = fmin(fmin(e1, e2), e3);
      const double hi = fmax(fmax(e1, e2), e3);
      e[0] = lo;
      e[1] = (e1 + e2 + e3) - lo - hi;
      e[2] = hi;
    }
  }
};

template <int M>
int launch(const void* planes, const void* wrow, long long N, long long inner, int R,
           const void* omega, int W, double eta, double scale, void* partials, void* acc,
           cudaStream_t st) {
  const SlabLoader<M> ld{static_cast<const double2*>(planes), static_cast<const double*>(wrow),
                         N, inner, R};
  return autobz::lorentz_launch<M>(ld, N, static_cast<const double*>(omega), W, eta, scale,
                                   static_cast<double*>(partials), static_cast<double*>(acc),
                                   /*accumulate=*/1, st);
}

}  // namespace

// planes: (m(m+1)/2, N) complex128; wrow: (R,) float64; omega: (W,);
// partials: (lorentz_num_blocks(N, W), W) scratch; acc: (W,) float64, to
// which scale * eta * sum_p w_p sum_b 1/((omega - e_b(p))^2 + eta^2) is added.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for m outside 1..3 or a bad row map.
extern "C" int fullgrid_tail_launch(const void* planes, const void* wrow, long long N,
                                    long long inner, int R, int m, const void* omega, int W,
                                    double eta, double scale, void* partials, void* acc,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inner <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (m) {
    case 1:
      return launch<1>(planes, wrow, N, inner, R, omega, W, eta, scale, partials, acc, st);
    case 2:
      return launch<2>(planes, wrow, N, inner, R, omega, W, eta, scale, partials, acc, st);
    case 3:
      return launch<3>(planes, wrow, N, inner, R, omega, W, eta, scale, partials, acc, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
