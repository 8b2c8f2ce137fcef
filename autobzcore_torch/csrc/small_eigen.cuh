// Closed-form eigenvalues of Hermitian 1x1, 2x2 and 3x3 matrices in FP64,
// shared by K7 (fullgrid_tail.cu) and K9 (eigh_small.cu), and the 2x2
// eigendecomposition shared by K21 (berry_pairs.cu) and K30 (band_expect.cu).
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

// The reference's eigh2 (ops/eigh3.py:27-58) of one Hermitian 2x2 h (row
// major): ascending e, U[i * 2 + n] with column n the eigenvector of band n.
// Branch-stable: the upper band's vector is [d + r, conj(b)] for d >= 0 and
// [b, r - d] otherwise, the identity at exact degeneracy.
__device__ inline void eigh2(const double2* __restrict__ h, double* e, double2* U) {
  const double a = h[0].x, c = h[3].x;
  const double2 b = h[1];
  const double dd = (a - c) / 2;
  const double r = sqrt(dd * dd + (b.x * b.x + b.y * b.y));
  const double mean = (a + c) / 2;
  e[0] = mean - r;
  e[1] = mean + r;
  double2 v0, v1;
  if (dd >= 0) {
    v0 = make_double2(dd + r, 0.0);
    v1 = make_double2(b.x, -b.y);
  } else {
    v0 = b;
    v1 = make_double2(r - dd, 0.0);
  }
  const double nrm = sqrt((v0.x * v0.x + v0.y * v0.y) + (v1.x * v1.x + v1.y * v1.y));
  double2 up0 = make_double2(0.0, 0.0), up1 = make_double2(1.0, 0.0);  // r = 0: the identity
  if (nrm > 0) {
    up0 = make_double2(v0.x / nrm, v0.y / nrm);
    up1 = make_double2(v1.x / nrm, v1.y / nrm);
  }
  U[0] = make_double2(-up1.x, up1.y);  // lower band: (-conj(up1), conj(up0))
  U[1] = up0;
  U[2] = make_double2(up0.x, -up0.y);
  U[3] = up1;
}

}  // namespace autobz
