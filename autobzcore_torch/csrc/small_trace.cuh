// Complex helpers and the closed-form Im Tr (z I - H)^{-1} for m <= 3 bands,
// shared by K2 (dos_trace.cu) and K4 (gk_leaf_dos.cu).
//
// The forms are the reference's (autobzcore_tpu/models/observables.py:73
// _trace_inv_small): 1/M for m = 1, tr/det for m = 2 and the adjugate
// identity (tr^2 - tr M^2) / (2 det) for m = 3, with M = z I - H.
#pragma once

#include <cuda_runtime.h>

namespace autobz {

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
// Im(a / b)
__device__ __forceinline__ double cdiv_imag(double2 a, double2 b) {
  return (a.y * b.x - a.x * b.y) / (b.x * b.x + b.y * b.y);
}

// Im Tr (z I - H)^{-1} for one row-major m x m matrix h.
template <int M>
__device__ __forceinline__ double trace_inv_imag(const double2* h, double2 z);

template <>
__device__ __forceinline__ double trace_inv_imag<1>(const double2* h, double2 z) {
  return cdiv_imag(make_double2(1.0, 0.0), csub(z, h[0]));
}

template <>
__device__ __forceinline__ double trace_inv_imag<2>(const double2* h, double2 z) {
  const double2 m00 = csub(z, h[0]), m11 = csub(z, h[3]);
  const double2 m01 = h[1], m10 = h[2];  // off-diagonal of M is -h; the signs cancel in det
  const double2 det = csub(cmul(m00, m11), cmul(m01, m10));
  return cdiv_imag(cadd(m00, m11), det);
}

template <>
__device__ __forceinline__ double trace_inv_imag<3>(const double2* h, double2 z) {
  double2 m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = make_double2(-h[i].x, -h[i].y);
  m[0] = csub(z, h[0]);
  m[4] = csub(z, h[4]);
  m[8] = csub(z, h[8]);
  const double2 tr = cadd(cadd(m[0], m[4]), m[8]);
  // tr(M^2) = sum_ij M_ij M_ji
  double2 tr2 = cadd(cadd(cmul(m[0], m[0]), cmul(m[4], m[4])), cmul(m[8], m[8]));
  const double2 off = cadd(cadd(cmul(m[1], m[3]), cmul(m[2], m[6])), cmul(m[5], m[7]));
  tr2 = cadd(tr2, cadd(off, off));
  // cofactor expansion along the first row
  const double2 c0 = csub(cmul(m[4], m[8]), cmul(m[5], m[7]));
  const double2 c1 = csub(cmul(m[3], m[8]), cmul(m[5], m[6]));
  const double2 c2 = csub(cmul(m[3], m[7]), cmul(m[4], m[6]));
  const double2 det = cadd(csub(cmul(m[0], c0), cmul(m[1], c1)), cmul(m[2], c2));
  const double2 num = csub(cmul(tr, tr), tr2);
  return 0.5 * cdiv_imag(num, det);
}

}  // namespace autobz
