// Closed-form eigenvalues of Hermitian 1x1, 2x2 and 3x3 matrices in FP64,
// shared by K7 (fullgrid_tail.cu) and K9 (eigh_small.cu).
//
// The forms are the reference's (autobzcore_tpu/ops/eigh3.py): mean +- the
// half-gap radius for m = 2 (:17 eigvalsh2), and for m = 3 the
// trigonometric Cardano solution on the matrix invariants (:61 eigvalsh3,
// :106 eigvalsh3_rows) with its scale-relative degeneracy guard, which
// returns the diagonal for (near-)scalar matrices, and the clip of the
// arccos argument to [-1, 1].
#pragma once

#include <cuda_runtime.h>

namespace autobz {

// Eigenvalues of the Hermitian 3x3 with diagonals a11, a22, a33 and upper
// off-diagonals (r12 + i i12), (r13 + i i13), (r23 + i i23): e1 the largest
// and e3 the smallest of the trigonometric solution, the diagonal entries
// where the guard fires (in that order, as the reference).
__device__ __forceinline__ void cardano3(double a11, double a22, double a33, double r12, double i12,
                                         double r13, double i13, double r23, double i23,
                                         double& e1, double& e2, double& e3) {
  const double b12 = r12 * r12 + i12 * i12;
  const double b13 = r13 * r13 + i13 * i13;
  const double b23 = r23 * r23 + i23 * i23;
  const double p1 = b12 + b13 + b23;
  const double q = (a11 + a22 + a33) / 3.0;
  const double d1 = a11 - q, d2 = a22 - q, d3 = a33 - q;
  const double p2 = d1 * d1 + d2 * d2 + d3 * d3 + 2.0 * p1;
  const double thr = 1e-24 * (q * q + p2 + 1e-30);
  const double p = sqrt(fmax(p2, thr) / 6.0);
  const double inv_p = 1.0 / p;
  // Re(a12 a23 conj(a13))
  const double re_triple = (r12 * r23 - i12 * i23) * r13 + (r12 * i23 + i12 * r23) * i13;
  const double detB = (d1 * d2 * d3 + 2.0 * re_triple - d1 * b23 - d2 * b13 - d3 * b12) *
                      (inv_p * inv_p * inv_p);
  const double phi = acos(fmin(fmax(detB / 2.0, -1.0), 1.0)) / 3.0;
  constexpr double four_pi_3 = 4.0 * 3.141592653589793 / 3.0;  // as the reference rounds it
  e1 = q + 2.0 * p * cos(phi);
  e3 = q + 2.0 * p * cos(phi + four_pi_3);
  e2 = 3.0 * q - e1 - e3;
  if (p2 <= thr) {
    e1 = a33;
    e2 = a22;
    e3 = a11;
  }
}

// Ascending eigenvalues of the Hermitian 2x2 [[a, b], [conj(b), c]].
__device__ __forceinline__ void eig2(double a, double c, double br, double bi, double& lo,
                                     double& hi) {
  const double mean = (a + c) / 2.0;
  const double h = (a - c) / 2.0;
  const double rad = sqrt(h * h + (br * br + bi * bi));
  lo = mean - rad;
  hi = mean + rad;
}

__device__ __forceinline__ void swap_if_greater(double& x, double& y) {
  if (x > y) {
    const double t = x;
    x = y;
    y = t;
  }
}

}  // namespace autobz
