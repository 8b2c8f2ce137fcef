// Inverses of a GENERAL complex m x m matrix M, m <= kMaxInverse, shared by
// K27 (sigma_trace.cu) and K28 (sigma_pairs.cu): the self-energy family
// inverts M = Z - H with a matrix Z = (w + mu) I - Sigma(w) that is neither
// a multiple of the identity nor Hermitian, so small_trace.cuh's
// trace_inv_imag(h, z), which takes a scalar z and a Hermitian h, does not
// apply.
//
// For m <= 3 the forms are the reference's closed ones
// (autobzcore_tpu/models/observables.py:73 _trace_inv_small and :89
// _inv_small): 1/M for m = 1; tr/det and the adjugate [[d, -b], [-c, a]] /
// det for m = 2; for m = 3 the trace identity (tr^2 - tr M^2) / (2 det) and
// the adjugate whose rows are the cross products of column pairs, over det.
// The determinant is the cofactor expansion along the first row (the
// reference's jnp.linalg.det is an LU factorization, so the two agree to
// rounding, not in the last bit). For 4 <= m <= kMaxInverse the reference
// solves against the identity (LU with partial pivoting); here Gauss-Jordan
// elimination with partial pivoting on [M | I] takes its place, with the
// same rounding-level agreement. Its loops are not unrolled: the matrices
// live in local memory (L1), which keeps registers and build time bounded.
//
// Matrices are row-major arrays of M * M double2; the arithmetic is
// FusedOps (the compiler may contract products and sums into FMAs).
#pragma once

#include "small_trace.cuh"

namespace autobz {

// conj(b) / |b|^2: the reciprocal of a complex number
__device__ __forceinline__ double2 crecip(double2 b) {
  const double s = 1.0 / (b.x * b.x + b.y * b.y);
  return make_double2(b.x * s, -b.y * s);
}

constexpr int kMaxInverse = 8;  // the largest m the kernels take

__device__ __forceinline__ double cabs2(double2 b) { return b.x * b.x + b.y * b.y; }

// 4 <= M <= kMaxInverse: Gauss-Jordan with partial pivoting (the first row of
// largest |M_rp| below the diagonal). Columns left of the pivot are already
// unit vectors, so the updates of M start at the pivot's column.
template <int M>
struct GeneralInverse {
  static_assert(M >= 4 && M <= kMaxInverse, "the closed forms take M <= 3");
  static __device__ void inverse(const double2* m, double2* g) {
    double2 a[M * M];
#pragma unroll 1
    for (int i = 0; i < M * M; ++i) {
      a[i] = m[i];
      g[i] = make_double2(i % (M + 1) == 0 ? 1.0 : 0.0, 0.0);
    }
#pragma unroll 1
    for (int p = 0; p < M; ++p) {
      int piv = p;
      double best = cabs2(a[p * M + p]);
#pragma unroll 1
      for (int r = p + 1; r < M; ++r) {
        const double v = cabs2(a[r * M + p]);
        if (v > best) {
          best = v;
          piv = r;
        }
      }
      if (piv != p) {
#pragma unroll 1
        for (int j = 0; j < M; ++j) {
          const double2 t = a[p * M + j], u = g[p * M + j];
          a[p * M + j] = a[piv * M + j];
          g[p * M + j] = g[piv * M + j];
          a[piv * M + j] = t;
          g[piv * M + j] = u;
        }
      }
      const double2 r = crecip(a[p * M + p]);
#pragma unroll 1
      for (int j = p; j < M; ++j) a[p * M + j] = cmul(a[p * M + j], r);
#pragma unroll 1
      for (int j = 0; j < M; ++j) g[p * M + j] = cmul(g[p * M + j], r);
#pragma unroll 1
      for (int i = 0; i < M; ++i) {
        if (i == p) continue;
        const double2 f = a[i * M + p];
#pragma unroll 1
        for (int j = p; j < M; ++j) a[i * M + j] = csub(a[i * M + j], cmul(f, a[p * M + j]));
#pragma unroll 1
        for (int j = 0; j < M; ++j) g[i * M + j] = csub(g[i * M + j], cmul(f, g[p * M + j]));
      }
    }
  }
  static __device__ double2 trace_inv(const double2* m) {
    double2 g[M * M];
    inverse(m, g);
    double2 t = g[0];
#pragma unroll 1
    for (int i = 1; i < M; ++i) t = cadd(t, g[i * (M + 1)]);
    return t;
  }
};

template <>
struct GeneralInverse<1> {
  static __device__ __forceinline__ double2 det(const double2* a) { return a[0]; }
  static __device__ __forceinline__ double2 trace_inv(const double2* a) { return crecip(a[0]); }
  static __device__ __forceinline__ void inverse(const double2* a, double2* g) { g[0] = crecip(a[0]); }
};

template <>
struct GeneralInverse<2> {
  static __device__ __forceinline__ double2 det(const double2* a) {
    return csub(cmul(a[0], a[3]), cmul(a[1], a[2]));
  }
  static __device__ __forceinline__ double2 trace_inv(const double2* a) {
    return cmul(cadd(a[0], a[3]), crecip(det(a)));
  }
  static __device__ __forceinline__ void inverse(const double2* a, double2* g) {
    const double2 r = crecip(det(a));
    g[0] = cmul(a[3], r);
    g[1] = cmul(make_double2(-a[1].x, -a[1].y), r);
    g[2] = cmul(make_double2(-a[2].x, -a[2].y), r);
    g[3] = cmul(a[0], r);
  }
};

template <>
struct GeneralInverse<3> {
  static __device__ __forceinline__ double2 det(const double2* a) {
    const double2 c0 = csub(cmul(a[4], a[8]), cmul(a[5], a[7]));
    const double2 c1 = csub(cmul(a[3], a[8]), cmul(a[5], a[6]));
    const double2 c2 = csub(cmul(a[3], a[7]), cmul(a[4], a[6]));
    return cadd(csub(cmul(a[0], c0), cmul(a[1], c1)), cmul(a[2], c2));
  }
  static __device__ __forceinline__ double2 trace_inv(const double2* a) {
    const double2 tr = cadd(cadd(a[0], a[4]), a[8]);
    // tr(M^2) = sum_ij M_ij M_ji
    double2 tr2 = cadd(cadd(cmul(a[0], a[0]), cmul(a[4], a[4])), cmul(a[8], a[8]));
    const double2 off = cadd(cadd(cmul(a[1], a[3]), cmul(a[2], a[6])), cmul(a[5], a[7]));
    tr2 = cadd(tr2, cadd(off, off));
    const double2 num = csub(cmul(tr, tr), tr2);
    const double2 q = cmul(num, crecip(det(a)));
    return make_double2(0.5 * q.x, 0.5 * q.y);
  }
  // adjugate rows: cross(c1, c2), cross(c2, c0), cross(c0, c1) of the
  // columns c_j[i] = a[3 i + j]
  static __device__ __forceinline__ void inverse(const double2* a, double2* g) {
    const double2 r = crecip(det(a));
#pragma unroll
    for (int row = 0; row < 3; ++row) {
      const int p = (row + 1) % 3, q = (row + 2) % 3;  // the column pair of this row
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
        const double2 x = csub(cmul(a[3 * i1 + p], a[3 * i2 + q]), cmul(a[3 * i2 + p], a[3 * i1 + q]));
        g[3 * row + i] = cmul(x, r);
      }
    }
  }
};

// Im [M^{-1}]_ii for i < M: the inverse's diagonal
template <int M>
__device__ __forceinline__ void inverse_diag_imag(const double2* a, double* out) {
  double2 g[M * M];
  GeneralInverse<M>::inverse(a, g);
#pragma unroll
  for (int i = 0; i < M; ++i) out[i] = g[i * M + i].y;
}

}  // namespace autobz
