// K8: the Lorentzian omega x k sum of given eigenvalues, in FP64:
//
//   out[w] = scale * eta * sum_k w_k sum_b 1 / ((omega_w - e[k, b])^2 + eta^2)
//
// Replaces the reduction of bench.py:96-99 (dos_sweep) and the Lorentzian
// of autobzcore_tpu/ops/grid_sweep.py:289-321 where the eigenvalues come
// from elsewhere: the full-grid engine's tail for m > 3 bands, whose
// eigenvalues come from torch.linalg.eigvalsh, and the bench lane's sweep
// of K9's eigenvalues.
//
// Each (k, band) pair is one point of the shared Lorentzian tile loop
// (lorentzian.cuh, which also says what bounds it), so any band count takes
// the same kernel; the weight of pair p is w[p / nb], or 1 without weights.

#include <cuda_runtime.h>

#include <cstdint>

#include "lorentzian.cuh"

namespace {

struct BandLoader {
  const double* e;
  const double* w;  // null: unit weights
  int nb;

  __device__ __forceinline__ void operator()(int64_t p, double (&ev)[1], double& wp) const {
    ev[0] = __ldg(&e[p]);
    wp = w ? __ldg(&w[p / nb]) : 1.0;
  }
};

}  // namespace

// Rows of the partials scratch that K7 and K8 need for npoints points (for
// K8, K * nb) and W lanes.
extern "C" long long lorentz_num_blocks(long long npoints, int W) {
  return autobz::lor_num_blocks(npoints, W);
}

// e: (K, nb) float64; w: (K,) float64 or null; omega: (W,); partials:
// (lorentz_num_blocks(K * nb, W), W) scratch; out: (W,) float64, written.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for nb < 1.
extern "C" int lorentzian_sum_launch(const void* e, const void* w, long long K, int nb,
                                     const void* omega, int W, double eta, double scale,
                                     void* partials, void* out, void* stream) {
  if (nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const BandLoader ld{static_cast<const double*>(e), static_cast<const double*>(w), nb};
  return autobz::lorentz_launch<1>(ld, K * nb, static_cast<const double*>(omega), W, eta, scale,
                                   static_cast<double*>(partials), static_cast<double*>(out),
                                   /*accumulate=*/0, static_cast<cudaStream_t>(stream));
}
