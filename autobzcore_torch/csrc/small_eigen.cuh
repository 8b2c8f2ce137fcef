// Closed-form eigenvalues of Hermitian 1x1, 2x2 and 3x3 matrices in FP64,
// shared by K7 (fullgrid_tail.cu) and K9 (eigh_small.cu), and the register
// eigensolver of K12's and K31's fused entries (band_velocity.cu,
// transport_points.cu), whose 2x2 form is also K21's (berry_pairs.cu) and
// K30's (band_expect.cu) eigh2.
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

// The register eigensolver for m <= 3 (eigh_rn): ascending eigenvalues e and
// eigenvectors U (column n that of band n, ur + i ui) of the Hermitian
// matrix with diagonal d and upper off-diagonals o = (or + i oi) at (0, 1),
// (0, 2), (1, 2) in that order. m = 1 is trivial; m = 2 is the reference's
// branch-stable eigh2 (ops/eigh3.py:27); m = 3 a cyclic complex Jacobi:
// rotations (0, 1), (0, 2), (1, 2) with the stable tangent, each skipped
// where |h_pq| <= eps ||H||_F, kJacobiSweeps sweeps, then an ascending sort
// with the vectors. Trigonometric Cardano loses ~sqrt(eps) on
// near-degenerate eigenvalues and its cross-product vectors fail there;
// Jacobi's rotations are backward stable at any gap.
//
// Every operation is one of the correctly rounded ones below, which the
// compiler does not contract into FMAs, in a fixed order: the PyTorch mirror
// (ops/eigh3.py eigh3_jacobi) runs the same operations and the two agree bit
// for bit, at degenerate and near-degenerate eigenvalues too.

// Four sweeps left every off-diagonal at or below eps ||H||_F on all the
// matrices the mirror was run on (1e6 random ones, the flagship's and
// synthetic_wannier(3)'s grids, exact pairs and triples, gaps of 1e-15 to
// 1e-6, graded scales 1e-8 to 1e8); the fifth is a margin, three skip
// tests where nothing is left.
constexpr int kJacobiSweeps = 5;
constexpr double kEps2 = 4.930380657631324e-32;  // 2^-104, DBL_EPSILON squared

__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double rn_sqrt(double a) { return __dsqrt_rn(a); }

// The Hermitian part of the m x m complex matrix at x (row major): the real
// diagonal, and (h_il + conj(h_li)) / 2 above it.
template <int M>
__device__ __forceinline__ void load_hermitian(const double2* x, double (&d)[3], double (&orr)[3],
                                               double (&oi)[3]) {
#pragma unroll
  for (int i = 0; i < M; ++i) d[i] = x[i * M + i].x;
  int k = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int l = i + 1; l < M; ++l, ++k) {
      const double2 a = x[i * M + l], b = x[l * M + i];
      orr[k] = rn_mul(rn_add(a.x, b.x), 0.5);
      oi[k] = rn_mul(rn_sub(a.y, b.y), 0.5);
    }
  }
}

// (x, y) <- (c x - s conj(phase) y, s phase x + c y), s phase = sr + i si.
__device__ __forceinline__ void rotate_pair(double c, double sr, double si, double& xr, double& xi, double& yr,
                                            double& yi) {
  const double nxr = rn_sub(rn_mul(c, xr), rn_add(rn_mul(sr, yr), rn_mul(si, yi)));
  const double nxi = rn_sub(rn_mul(c, xi), rn_sub(rn_mul(sr, yi), rn_mul(si, yr)));
  const double nyr = rn_add(rn_sub(rn_mul(sr, xr), rn_mul(si, xi)), rn_mul(c, yr));
  const double nyi = rn_add(rn_add(rn_mul(sr, xi), rn_mul(si, xr)), rn_mul(c, yi));
  xr = nxr;
  xi = nxi;
  yr = nyr;
  yi = nyi;
}

// One rotation of the pair (P, Q): h_pq = g = |g| phase, (x, y) = (A_rp, A_rq)
// of the third index r. Skipped where |g|^2 <= tol2. The tangent t is the
// smaller root of t^2 + 2 theta t - 1 = 0, theta = (d_q - d_p) / (2 |g|); the
// unitary G = [[c, s phase], [-s conj(phase), c]] zeroes h_pq, A <- G^H A G,
// U <- U G.
template <int P, int Q>
__device__ __forceinline__ void jacobi_rotate(double& dp, double& dq, double& gr, double& gi, double& xr, double& xi,
                                              double& yr, double& yi, double (&ur)[3][3], double (&ui)[3][3],
                                              double tol2) {
  const double g2 = rn_add(rn_mul(gr, gr), rn_mul(gi, gi));
  if (!(g2 > tol2)) return;
  const double a = rn_sqrt(g2);
  const double ia = rn_div(1.0, a);
  const double er = rn_mul(gr, ia), ei = rn_mul(gi, ia);
  const double th = rn_div(rn_sub(dq, dp), rn_add(a, a));
  double t = rn_div(1.0, rn_add(fabs(th), rn_sqrt(rn_add(rn_mul(th, th), 1.0))));
  if (th < 0.0) t = -t;
  const double c = rn_div(1.0, rn_sqrt(rn_add(rn_mul(t, t), 1.0)));
  const double s = rn_mul(t, c);
  const double ta = rn_mul(t, a);
  dp = rn_sub(dp, ta);
  dq = rn_add(dq, ta);
  gr = 0.0;
  gi = 0.0;
  const double sr = rn_mul(s, er), si = rn_mul(s, ei);
  rotate_pair(c, sr, si, xr, xi, yr, yi);
#pragma unroll
  for (int i = 0; i < 3; ++i) rotate_pair(c, sr, si, ur[i][P], ui[i][P], ur[i][Q], ui[i][Q]);
}

// Swap bands a and b (eigenvalue and column) where e_a > e_b.
template <int A, int B>
__device__ __forceinline__ void sort_pair(double (&e)[3], double (&ur)[3][3], double (&ui)[3][3]) {
  if (e[A] > e[B]) {
    const double t = e[A];
    e[A] = e[B];
    e[B] = t;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const double r = ur[i][A], m = ui[i][A];
      ur[i][A] = ur[i][B];
      ui[i][A] = ui[i][B];
      ur[i][B] = r;
      ui[i][B] = m;
    }
  }
}

template <int M>
__device__ __forceinline__ void eigh_rn(double (&d)[3], double (&orr)[3], double (&oi)[3], double (&e)[3],
                                        double (&ur)[3][3], double (&ui)[3][3]) {
  if constexpr (M == 1) {
    e[0] = d[0];
    ur[0][0] = 1.0;
    ui[0][0] = 0.0;
  } else if constexpr (M == 2) {
    // branch-stable: the upper band's vector is [d + r, conj(b)] for d >= 0
    // and [b, r - d] otherwise, the identity at exact degeneracy
    const double dd = rn_mul(rn_sub(d[0], d[1]), 0.5);
    const double r = rn_sqrt(rn_add(rn_mul(dd, dd), rn_add(rn_mul(orr[0], orr[0]), rn_mul(oi[0], oi[0]))));
    const double mean = rn_mul(rn_add(d[0], d[1]), 0.5);
    e[0] = rn_sub(mean, r);
    e[1] = rn_add(mean, r);
    double v0r, v0i, v1r, v1i;
    if (dd >= 0.0) {
      v0r = rn_add(dd, r);
      v0i = 0.0;
      v1r = orr[0];
      v1i = -oi[0];
    } else {
      v0r = orr[0];
      v0i = oi[0];
      v1r = rn_sub(r, dd);
      v1i = 0.0;
    }
    const double nrm = rn_sqrt(rn_add(rn_add(rn_mul(v0r, v0r), rn_mul(v0i, v0i)),
                                      rn_add(rn_mul(v1r, v1r), rn_mul(v1i, v1i))));
    double u0r = 0.0, u0i = 0.0, u1r = 1.0, u1i = 0.0;  // r = 0: the identity
    if (nrm > 0.0) {
      u0r = rn_div(v0r, nrm);
      u0i = rn_div(v0i, nrm);
      u1r = rn_div(v1r, nrm);
      u1i = rn_div(v1i, nrm);
    }
    ur[0][0] = -u1r;  // lower band: (-conj(up1), conj(up0))
    ui[0][0] = u1i;
    ur[1][0] = u0r;
    ui[1][0] = -u0i;
    ur[0][1] = u0r;  // upper band: (up0, up1)
    ui[0][1] = u0i;
    ur[1][1] = u1r;
    ui[1][1] = u1i;
  } else {
    double f2 = rn_add(rn_add(rn_mul(d[0], d[0]), rn_mul(d[1], d[1])), rn_mul(d[2], d[2]));
    const double o2 = rn_add(rn_add(rn_add(rn_mul(orr[0], orr[0]), rn_mul(oi[0], oi[0])),
                                    rn_add(rn_mul(orr[1], orr[1]), rn_mul(oi[1], oi[1]))),
                             rn_add(rn_mul(orr[2], orr[2]), rn_mul(oi[2], oi[2])));
    f2 = rn_add(f2, rn_add(o2, o2));
    const double tol2 = rn_mul(kEps2, f2);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        ur[i][j] = i == j ? 1.0 : 0.0;
        ui[i][j] = 0.0;
      }
    }
#pragma unroll 1
    for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
      {  // (0, 1), r = 2: x = A_20 = conj(o_02), y = A_21 = conj(o_12)
        double xr = orr[1], xi = -oi[1], yr = orr[2], yi = -oi[2];
        jacobi_rotate<0, 1>(d[0], d[1], orr[0], oi[0], xr, xi, yr, yi, ur, ui, tol2);
        orr[1] = xr;
        oi[1] = -xi;
        orr[2] = yr;
        oi[2] = -yi;
      }
      {  // (0, 2), r = 1: x = A_10 = conj(o_01), y = A_12 = o_12
        double xr = orr[0], xi = -oi[0];
        jacobi_rotate<0, 2>(d[0], d[2], orr[1], oi[1], xr, xi, orr[2], oi[2], ur, ui, tol2);
        orr[0] = xr;
        oi[0] = -xi;
      }
      // (1, 2), r = 0: x = A_01 = o_01, y = A_02 = o_02
      jacobi_rotate<1, 2>(d[1], d[2], orr[2], oi[2], orr[0], oi[0], orr[1], oi[1], ur, ui, tol2);
    }
    e[0] = d[0];
    e[1] = d[1];
    e[2] = d[2];
    sort_pair<0, 1>(e, ur, ui);
    sort_pair<1, 2>(e, ur, ui);
    sort_pair<0, 1>(e, ur, ui);
  }
}

// The reference's eigh2 (ops/eigh3.py:27-58) of one Hermitian 2x2 h (row
// major), as eigh_rn<2> on h's diagonal and h_01 (the reference reads no
// more): ascending e, U[i * 2 + n] with column n the eigenvector of band n.
__device__ inline void eigh2(const double2* __restrict__ h, double* e, double2* U) {
  double d[3] = {h[0].x, h[3].x, 0.0}, orr[3] = {h[1].x, 0.0, 0.0}, oi[3] = {h[1].y, 0.0, 0.0};
  double ev[3], ur[3][3], ui[3][3];
  eigh_rn<2>(d, orr, oi, ev, ur, ui);
  e[0] = ev[0];
  e[1] = ev[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int n = 0; n < 2; ++n) U[i * 2 + n] = make_double2(ur[i][n], ui[i][n]);
  }
}

}  // namespace autobz
