// Complex helpers and the closed-form Im Tr (z I - H)^{-1} for m <= 3 bands,
// shared by K2 (dos_trace.cu), K4 (gk_leaf_dos.cu) and K15 (gm_rule.cu).
//
// The forms are the reference's (autobzcore_tpu/models/observables.py:73
// _trace_inv_small): 1/M for m = 1, tr/det for m = 2 and the adjugate
// identity (tr^2 - tr M^2) / (2 det) for m = 3, with M = z I - H.
//
// The arithmetic is a policy: FusedOps lets the compiler contract products
// and sums into fused multiply-adds (K2, K4); RoundedOps rounds after every
// operation, as separate tensor operations do, so that K15 gives the bits of
// its plain version (models/observables.py gm_dos_values_plain).
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

struct FusedOps {
  static __device__ __forceinline__ double2 mul(double2 a, double2 b) { return cmul(a, b); }
  static __device__ __forceinline__ double2 add(double2 a, double2 b) { return cadd(a, b); }
  static __device__ __forceinline__ double2 sub(double2 a, double2 b) { return csub(a, b); }
  static __device__ __forceinline__ double div_imag(double2 a, double2 b) { return cdiv_imag(a, b); }
  static __device__ __forceinline__ double half(double x) { return 0.5 * x; }
};

struct RoundedOps {
  static __device__ __forceinline__ double2 mul(double2 a, double2 b) {
    return make_double2(__dsub_rn(__dmul_rn(a.x, b.x), __dmul_rn(a.y, b.y)),
                        __dadd_rn(__dmul_rn(a.x, b.y), __dmul_rn(a.y, b.x)));
  }
  static __device__ __forceinline__ double2 add(double2 a, double2 b) {
    return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
  }
  static __device__ __forceinline__ double2 sub(double2 a, double2 b) {
    return make_double2(__dsub_rn(a.x, b.x), __dsub_rn(a.y, b.y));
  }
  static __device__ __forceinline__ double div_imag(double2 a, double2 b) {
    return __ddiv_rn(__dsub_rn(__dmul_rn(a.y, b.x), __dmul_rn(a.x, b.y)),
                     __dadd_rn(__dmul_rn(b.x, b.x), __dmul_rn(b.y, b.y)));
  }
  static __device__ __forceinline__ double half(double x) { return __dmul_rn(0.5, x); }
};

// Im Tr (z I - H)^{-1} for one row-major m x m matrix h.
template <int M, class Ops = FusedOps>
struct TraceInvImag;

template <class Ops>
struct TraceInvImag<1, Ops> {
  static __device__ __forceinline__ double eval(const double2* h, double2 z) {
    return Ops::div_imag(make_double2(1.0, 0.0), Ops::sub(z, h[0]));
  }
};

template <class Ops>
struct TraceInvImag<2, Ops> {
  static __device__ __forceinline__ double eval(const double2* h, double2 z) {
    const double2 m00 = Ops::sub(z, h[0]), m11 = Ops::sub(z, h[3]);
    const double2 m01 = h[1], m10 = h[2];  // off-diagonal of M is -h; the signs cancel in det
    const double2 det = Ops::sub(Ops::mul(m00, m11), Ops::mul(m01, m10));
    return Ops::div_imag(Ops::add(m00, m11), det);
  }
};

template <class Ops>
struct TraceInvImag<3, Ops> {
  static __device__ __forceinline__ double eval(const double2* h, double2 z) {
    double2 m[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) m[i] = make_double2(-h[i].x, -h[i].y);
    m[0] = Ops::sub(z, h[0]);
    m[4] = Ops::sub(z, h[4]);
    m[8] = Ops::sub(z, h[8]);
    const double2 tr = Ops::add(Ops::add(m[0], m[4]), m[8]);
    // tr(M^2) = sum_ij M_ij M_ji
    double2 tr2 = Ops::add(Ops::add(Ops::mul(m[0], m[0]), Ops::mul(m[4], m[4])), Ops::mul(m[8], m[8]));
    const double2 off = Ops::add(Ops::add(Ops::mul(m[1], m[3]), Ops::mul(m[2], m[6])),
                                 Ops::mul(m[5], m[7]));
    tr2 = Ops::add(tr2, Ops::add(off, off));
    // cofactor expansion along the first row
    const double2 c0 = Ops::sub(Ops::mul(m[4], m[8]), Ops::mul(m[5], m[7]));
    const double2 c1 = Ops::sub(Ops::mul(m[3], m[8]), Ops::mul(m[5], m[6]));
    const double2 c2 = Ops::sub(Ops::mul(m[3], m[7]), Ops::mul(m[4], m[6]));
    const double2 det = Ops::add(Ops::sub(Ops::mul(m[0], c0), Ops::mul(m[1], c1)), Ops::mul(m[2], c2));
    const double2 num = Ops::sub(Ops::mul(tr, tr), tr2);
    return Ops::half(Ops::div_imag(num, det));
  }
};

template <int M, class Ops = FusedOps>
__device__ __forceinline__ double trace_inv_imag(const double2* h, double2 z) {
  return TraceInvImag<M, Ops>::eval(h, z);
}

}  // namespace autobz
