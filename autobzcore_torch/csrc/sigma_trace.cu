// K27: the self-energy DOS trace in FP64, weighted k-sum and pointwise, and
// its matrix mode, the matrix spectral function's weighted k-sum and points.
//
// Replaces autobzcore_tpu/models/selfenergy.py:214-225 (SigmaDOSSolver's
// `one`: the weighted k-sum of -Im Tr G / pi, or of -Im G_ii / pi per
// orbital with project=True), :122-135 (greens_trace_sigma, the pointwise
// integrand) and the closed forms of models/observables.py:73-105. For
// frequency lanes w with matrices Z_w = (w + mu) I - Sigma(w) it computes
//
//   trace mode:    D[w]    = -scale/pi * sum_k w_k Im Tr (Z_w - H_k)^{-1},
//   diagonal mode: D[w, i] = -scale/pi * sum_k w_k Im [(Z_w - H_k)^{-1}]_ii,
//   pointwise:     T[n]    = Tr (Z_n - H_n)^{-1}  (complex, no sum),
//   matrix mode:   S[w]    = scale * sum_k w_k A(Z_w - H_k)       (W, m, m),
//   matrix points: A[n]    = A(Z_n - H_n)                         (N, m, m),
//
// with A(M) = -(G - G^H) / (2 pi i), G = M^{-1}, the matrix spectral
// function (models/observables.py:160-165 spectral_function, summed by the
// PTR rule at Z_w = (w + i eta) I: the reference's algorithms/ptr.py:77-83).
// Z is a GENERAL complex matrix (Sigma is neither Hermitian nor a multiple
// of I), or in the matrix modes a scalar z per lane or point (Z = z I, as
// both of their callers pass it). Every caller's H is Hermitian (a
// Hermitian series on the grid): the sums at m <= 3 read its Hermitian part
// (H + H^H) / 2, as K28 does; the pointwise entries read it as given, as
// their plain versions do (on a pole at eta = 1e-3 the Hermitian part of a
// Fourier-evaluated H moves a value by ~5e-13 of its scale, as much as the
// 1e-12 check allows). For 4 <= m <= 8 every entry takes any complex H and
// inverts with small_inverse.cuh's Gauss-Jordan with partial pivoting (in
// place of the reference's `solve`), one pair at a time in local memory.
//
// What bounds it on an H100, m = 3. The trace and diagonal sums at the DOS
// leg's shape (K = 1e6 points of the npt = 100 grid, W = 1000 frequencies)
// are 1e9 (w, k) pairs against a 144 MB read of H; the matrix mode's 2.64e8
// pairs likewise: arithmetic, and the operands each pair must see. A
// pointwise call reads 144 B of H and writes 16 B (trace) or 144 B (matrix)
// a point: bytes, and on the path mostly its launch and host call.
//
// What the design does about it:
//  * trace and diagonal sums, m = 3: with M = Z - H,
//      det M = det Z - tr(adj Z H) + tr(Z adj H) - det H,
//      e2 M  = e2 Z + e2 H - tr Z tr H + tr(Z H),   Tr M^{-1} = e2 M / det M,
//      minor_ii M = adj Z_ii + adj H_ii - (Z_kk h_jj + Z_jj h_kk - a S_jk - b D_jk)
//    (e2 the sum of the principal 2 x 2 minors, {i, j, k} = {0, 1, 2}, h_jk =
//    a + i b). A trace against a Hermitian X is sum_i C_ii x_ii + sum_i<j
//    (a_ij S_ij + b_ij D_ij), S_ij = C_ij + C_ji, D_ij = i (C_ji - C_ij). So
//    det M, e2 M and the minors are products of a lane's coefficients (of Z,
//    adj Z, det Z, e2 Z, tr Z: formed once, in registers) with a k's record
//    of reals (H's, adj H's, 1, det H, e2 H: formed once a tile, in shared
//    memory): (lanes x rows) by (rows x k) products over 20 rows for det,
//    12 for e2 and 4 for each minor (adj H_ii is added after), which run on
//    the FP64 tensor cores (mma.sync m16n8k8 and m16n8k4, dmma.cuh). On the
//    CUDA cores the same expansion was bound by the 22 doubles each pair
//    read from shared memory (PERF.md, the K27 rows);
//  * then per pair on the CUDA cores: the cancellation guard, Im(num conj
//    det) and one reciprocal of |det|^2 (rcp.approx and two Newton steps,
//    as K2). The expansion loses about eps B / |det M| of det's relative
//    accuracy, B = |det Z| + |det H| + |adj Z| |H| + |Z| |adj H| (Frobenius
//    norms: a lane's and a k's). Where B > kGuard |det M| (a pole at small
//    eta: ~0.1-1 % of the pairs at eta = 1e-3) or |det|^2 leaves the
//    reciprocal's range, the thread redoes its pair from M formed directly
//    (direct3: cofactors, one reciprocal, scaled out of its range). The test
//    is the pair's own, so a lane's bits do not depend on its neighbours;
//  * m = 1 and 2 form M directly (a few operations) with the same
//    reciprocal and the same exact route out of its range;
//  * matrix mode with scalar z, m <= 3: adj(z I - H) = z^2 I + z (H - tr H I)
//    + adj H (Cayley-Hamilton; z I + (H - tr H I) at m = 2, 1 at m = 1), and
//    the sum is linear, so a lane accumulates S0 = sum_k c_k, S1 = sum_k c_k
//    (H_k - tr H_k I) and S2 = sum_k c_k adj H_k with c_k = w_k / det (one
//    reciprocal), their Hermitian factors' products kept as four real sums
//    an off-diagonal entry; A' = i (G - G^H) with G = z^2 S0 I + z S1 + S2
//    is formed once a lane and k-chunk. det stays in diagonal shifts d_i =
//    z - h_ii (K2's form: d0 d1 - p01, d2 A - d0 p12 - d1 p02 - c): about 62
//    FP64 instructions a pair where the general inverse and the 18 spectral
//    sums took ~250. A general Z (W, m, m) keeps the general route below;
//  * pointwise entries, m <= 3: at m = 3 a block of 128 points stages their
//    H, and their Z or z, through shared memory by coalesced 16-byte loads
//    (a thread's own point lies 144 B from its neighbour's, which reads
//    conflict-free from shared memory) and writes a matrix result back the
//    same way; at m <= 2 a point's values lie next to its neighbour's and a
//    thread reads them in place. A point inverts M = Z - H by
//    small_inverse.cuh's closed forms with one division, its plain
//    version's arithmetic. Plain loads: a block has no work to overlap with
//    cp.async;
//  * a sum's block covers 32 frequency lanes and a chunk of kChunkK
//    k-points, staged in tiles of kTileK (at m = 3 a warp takes 8 lanes and
//    every k; at m <= 2 and in the matrix mode a thread takes a lane and its
//    warp every fourth k, all threads of a warp reading the same k, which
//    shared memory broadcasts). The grid's y extent is capped at 65535 and
//    a block row loops over k-chunks, so any K takes one launch; the
//    cross-block sum is a second pass in chunk order (column_sum.cuh): one
//    partial row per k-chunk (per (k-chunk, warp) in the matrix modes), no
//    atomics, so repeats are bit-identical and the sums do not depend on
//    the launch shape.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"
#include "dmma.cuh"
#include "small_inverse.cuh"

namespace {

using autobz::cadd;
using autobz::cmul;
using autobz::csub;
using autobz::GeneralInverse;

constexpr int kLanes = 32;     // frequency lanes per block
constexpr int kKWarps = 4;     // warps per block, each over every fourth k
constexpr int kTileK = 128;    // k-points per shared tile for m <= 3
constexpr int kChunkK = 4096;  // k-points per partial row
constexpr int kThreads = kLanes * kKWarps;
constexpr int kPoints = 128;   // points per block of the pointwise entries
// redo a pair whose expansion bound B exceeds kGuard |det| (B^2 > kGuard^2 |det|^2)
constexpr double kGuard2 = 4194304.0;  // 2048^2

// k-points per shared tile of the general route: near 16 KB of H
template <int M>
__host__ __device__ constexpr int tile_k() {
  return M <= 3 ? kTileK : 16384 / (16 * M * M);
}

// ---- one reciprocal a pair ---------------------------------------------------------------

// |den| outside [2^-1021, 2^1022), where rcp.approx's fast form does not
// hold (den >= 0 or NaN, so the high word's exponent bits decide)
__device__ __forceinline__ bool out_of_range(double den) {
  return static_cast<unsigned>(__double2hiint(den)) - 0x00200000u >= 0x7fb00000u;
}

// 1 / den by rcp.approx and two Newton steps, den in range
__device__ __forceinline__ double rcp(double den) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(den));
  r = fma(r, fma(-den, r, 1.0), r);
  return fma(r, fma(-den, r, 1.0), r);
}

// b scaled by 2^-e to about 1 (exact) and 1 / |b 2^-e|^2 by a correctly rounded division
struct Scaled {
  double x, y, r;
  int e;
  __device__ __forceinline__ explicit Scaled(double2 b) {
    frexp(fmax(fabs(b.x), fabs(b.y)), &e);
    x = ldexp(b.x, -e);
    y = ldexp(b.y, -e);
    r = __ddiv_rn(1.0, fma(x, x, y * y));
  }
  // Im(a / b)
  __device__ __forceinline__ double im(double2 a) const { return ldexp(fma(a.y, x, -a.x * y) * r, -e); }
  // a / b
  __device__ __forceinline__ double2 quot(double2 a) const {
    return make_double2(ldexp(fma(a.x, x, a.y * y) * r, -e), ldexp(fma(a.y, x, -a.x * y) * r, -e));
  }
};

// ---- M = Z - H --------------------------------------------------------------------------

// h_ij of the Hermitian part of row-major x: (x_ij + conj(x_ji)) / 2
template <int M>
__device__ __forceinline__ double2 herm(const double2* x, int i, int j) {
  if (i == j) return make_double2(x[i * M + i].x, 0.0);
  const double2 u = x[i * M + j], l = x[j * M + i];
  return make_double2(0.5 * (u.x + l.x), 0.5 * (u.y - l.y));
}

// a = Z - H for a row-major Z, or z I - H where scalar (H as given)
template <int M, bool Scalar>
__device__ __forceinline__ void form_m(const double2* h, const double2* z, double2* a) {
#pragma unroll
  for (int i = 0; i < M * M; ++i) {
    double2 zi;
    if constexpr (Scalar) {
      zi = i % (M + 1) == 0 ? z[0] : make_double2(0.0, 0.0);
    } else {
      zi = z[i];
    }
    a[i] = csub(zi, h[i]);
  }
}

// the adjugate of a 3 x 3 matrix (the cross products of column pairs,
// GeneralInverse<3>'s rows) and its determinant (the first row of a times
// the first column of adj)
__device__ __forceinline__ double2 adjugate3(const double2* a, double2* adj) {
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    const int p = (row + 1) % 3, q = (row + 2) % 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
      adj[3 * row + i] = csub(cmul(a[3 * i1 + p], a[3 * i2 + q]), cmul(a[3 * i2 + p], a[3 * i1 + q]));
    }
  }
  return cadd(cadd(cmul(a[0], adj[0]), cmul(a[1], adj[3])), cmul(a[2], adj[6]));
}

// ---- trace and diagonal sums, m = 3: a k's record and a lane's coefficients -----------------

// A Hermitian 3 x 3 matrix's nine reals, in this order: x00, x11, x22,
// Re x01, Im x01, Re x02, Im x02, Re x12, Im x12. tr(C X) for a general C is
// sum_r c[r] x[r] with c = C00, C11, C22, S01, D01, S02, D02, S12, D12,
// S_ij = C_ij + C_ji, D_ij = i (C_ji - C_ij).
__device__ __forceinline__ void coefficients(const double2* c, double2* out) {
  out[0] = c[0];
  out[1] = c[4];
  out[2] = c[8];
  const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const double2 u = c[pairs[p][0] * 3 + pairs[p][1]], l = c[pairs[p][1] * 3 + pairs[p][0]];
    out[3 + 2 * p] = cadd(u, l);
    out[4 + 2 * p] = make_double2(u.y - l.y, l.x - u.x);  // i (l - u)
  }
}

// the Hermitian part of H's nine reals
__device__ __forceinline__ void herm_reals(const double2* __restrict__ x, double* h) {
  h[0] = x[0].x;
  h[1] = x[4].x;
  h[2] = x[8].x;
  const double2 h01 = herm<3>(x, 0, 1), h02 = herm<3>(x, 0, 2), h12 = herm<3>(x, 1, 2);
  h[3] = h01.x;
  h[4] = h01.y;
  h[5] = h02.x;
  h[6] = h02.y;
  h[7] = h12.x;
  h[8] = h12.y;
}

// adj h's nine reals from h's (adj h is Hermitian)
__device__ __forceinline__ void herm_adjugate(const double* h, double* a) {
  const double h00 = h[0], h11 = h[1], h22 = h[2], a01 = h[3], b01 = h[4], a02 = h[5], b02 = h[6], a12 = h[7],
               b12 = h[8];
  a[0] = h11 * h22 - (a12 * a12 + b12 * b12);
  a[1] = h00 * h22 - (a02 * a02 + b02 * b02);
  a[2] = h00 * h11 - (a01 * a01 + b01 * b01);
  a[3] = a02 * a12 + b02 * b12 - a01 * h22;  // h02 conj(h12) - h01 h22
  a[4] = b02 * a12 - a02 * b12 - b01 * h22;
  a[5] = a01 * a12 - b01 * b12 - a02 * h11;  // h01 h12 - h02 h11
  a[6] = a01 * b12 + b01 * a12 - b02 * h11;
  a[7] = a02 * a01 + b02 * b01 - h00 * a12;  // h02 conj(h01) - h00 h12
  a[8] = b02 * a01 - a02 * b01 - h00 * b12;
}

__device__ __forceinline__ double herm_norm(const double* x) {
  double o = 0.0;
#pragma unroll
  for (int r = 3; r < 9; ++r) o = fma(x[r], x[r], o);
  return sqrt(fma(2.0, o, x[0] * x[0] + x[1] * x[1] + x[2] * x[2]));
}

// A k's record, a column of the shared tile: kBRows rows, the B operand of
// the tensor-core products, then w_k. What each row holds is a code: 0-8
// H's reals, 9-17 adj H's reals (the same order), then 1, det H, e2 H, or
// nothing. det M reads rows 0-19 in steps of 8, 8 and 4 rows. The trace
// mode's rows are adj H's reals, det H, 1, H's reals, e2 H, so that e2 M
// reads rows 10-21 (8 and 4). The diagonal mode's put each minor's four
// reals of H in 4 rows (minor_00 rows 0-3, minor_11 3-6, minor_22 20-23, four
// of H's reals stored twice; its adj H_ii is added after the product):
//   a12 b12 h11 h22 h00 a02 b02 a01 b01 A00 A11 A22 | adj H's off-diagonal | 1 det_H | h00 h11 a01 b01
// (a_ij, b_ij: Re and Im of h_ij; A: adj H).
constexpr int kBRows = 24, kRows = kBRows + 1, kWeight = kBRows;
constexpr int kQOne = 18, kQDetH = 19, kQE2H = 20, kQNone = 21;
constexpr int kTileStride = kTileK + 4;  // a row's stride: fragment loads free of bank conflicts
__device__ constexpr int kTraceRows[kBRows] = {9, 10, 11, 12, 13, 14, 15, 16, 17, kQDetH, kQOne, 0, 1, 2, 3, 4, 5, 6,
                                               7, 8, kQE2H, kQNone, kQNone, kQNone};
__device__ constexpr int kDiagRows[kBRows] = {7, 8, 1, 2, 0, 5, 6, 3, 4, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                                              kQOne, kQDetH, 0, 1, 3, 4};
__device__ constexpr int kMinorBase[3] = {0, 3, 20};  // the first row of minor_ii's 4
constexpr int kAdjHDiag = 9;                          // the diagonal layout's adj H_00 row (then 11, 22)

// the record of H (row-major, its Hermitian part) into column col; returns
// the guard's |H|, |adj H| and |det H| (Frobenius norms)
template <bool Diag>
__device__ __forceinline__ void build_column(const double2* __restrict__ x, double wk, double* col, double* norms) {
  double q[21];
  herm_reals(x, q);
  herm_adjugate(q, q + 9);
  const double* h = q;
  const double* a = q + 9;
  // det = h00 adj00 + h01 adj10 + h02 adj20, real for Hermitian h
  q[kQDetH] = h[0] * a[0] + (h[3] * a[3] + h[4] * a[4]) + (h[5] * a[5] + h[6] * a[6]);
  q[kQOne] = 1.0;
  q[kQE2H] = a[0] + a[1] + a[2];
#pragma unroll
  for (int r = 0; r < kBRows; ++r) {
    const int c = Diag ? kDiagRows[r] : kTraceRows[r];
    col[r * kTileStride] = c == kQNone ? 0.0 : q[c];
  }
  col[kWeight * kTileStride] = wk;
  norms[0] = herm_norm(h);
  norms[1] = herm_norm(a);
  norms[2] = fabs(q[kQDetH]);
}

__device__ __forceinline__ double cnorm2(const double2* c, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) s = fma(c[i].x, c[i].x, fma(c[i].y, c[i].y, s));
  return s;
}

// A lane's coefficients of the record's quantities (codes) in det M, e2 M
// and minor_ii M (the A operand's rows), the constants adj Z_ii of the
// minors, and the guard's |det Z|, |adj Z|, |Z|.
struct Lane3 {
  double2 cz[9], na[9], det, e2, tr;
  double adet, nadj, nz;
  __device__ __forceinline__ void init(const double2* z) {
    double2 adj[9];
    det = adjugate3(z, adj);
    coefficients(z, cz);
    coefficients(adj, na);
#pragma unroll
    for (int r = 0; r < 9; ++r) na[r] = make_double2(-na[r].x, -na[r].y);
    tr = cadd(cadd(z[0], z[4]), z[8]);
    e2 = cadd(cadd(adj[0], adj[4]), adj[8]);
    adet = hypot(det.x, det.y);
    nadj = sqrt(cnorm2(adj, 9));
    nz = sqrt(cnorm2(z, 9));
  }
  // det M = (det Z) 1 - det H + sum -adj Z coefficients x H + sum Z coefficients x adj H
  __device__ __forceinline__ double2 det_of(int c) const {
    if (c < 9) return na[c];
    if (c < 18) return cz[c - 9];
    if (c == kQOne) return det;
    if (c == kQDetH) return make_double2(-1.0, 0.0);
    return make_double2(0.0, 0.0);
  }
  // e2 M = (e2 Z) 1 + e2 H + sum (Z coefficients, the diagonal less tr Z) x H
  __device__ __forceinline__ double2 e2_of(int c) const {
    if (c < 3) return csub(cz[c], tr);
    if (c < 9) return cz[c];
    if (c == kQOne) return e2;
    if (c == kQE2H) return make_double2(1.0, 0.0);
    return make_double2(0.0, 0.0);
  }
  // minor_ii M - adj Z_ii - adj H_ii = - Z_kk h_jj - Z_jj h_kk + S_jk a_jk + D_jk b_jk
  __device__ __forceinline__ double2 minor_of(int i, int c) const {
    const int j = i == 0 ? 1 : 0, k = i == 2 ? 1 : 2, p = 2 - i;
    if (c == j) return make_double2(-cz[k].x, -cz[k].y);
    if (c == k) return make_double2(-cz[j].x, -cz[j].y);
    if (c == 3 + 2 * p || c == 4 + 2 * p) return cz[c];
    return make_double2(0.0, 0.0);
  }
};

// The direct route of a pair: M = Z - H from the lane's row of Z (i I on a
// dead lane) and the k's reals h; det and the principal minors by cofactors,
// then one reciprocal of |det|^2 (scaled out of its range).
template <bool Diag>
__device__ void direct3(const double2* __restrict__ z, bool live, const double* h, double wk, double* acc) {
  double2 a[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) a[i] = live ? z[i] : make_double2(0.0, i % 4 == 0 ? 1.0 : 0.0);
  a[0].x -= h[0];
  a[4].x -= h[1];
  a[8].x -= h[2];
  const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int u = pairs[p][0] * 3 + pairs[p][1], l = pairs[p][1] * 3 + pairs[p][0];
    a[u] = make_double2(a[u].x - h[3 + 2 * p], a[u].y - h[4 + 2 * p]);
    a[l] = make_double2(a[l].x - h[3 + 2 * p], a[l].y + h[4 + 2 * p]);
  }
  double2 adj[9];
  const double2 det = adjugate3(a, adj);
  const double2 num[3] = {Diag ? adj[0] : cadd(cadd(adj[0], adj[4]), adj[8]), adj[4], adj[8]};
  const double den = fma(det.x, det.x, det.y * det.y);
  if (out_of_range(den)) {
    const Scaled s(det);
#pragma unroll
    for (int q = 0; q < (Diag ? 3 : 1); ++q) acc[q] = fma(wk, s.im(num[q]), acc[q]);
  } else {
    const double wr = wk * rcp(den);
#pragma unroll
    for (int q = 0; q < (Diag ? 3 : 1); ++q) acc[q] = fma(wr, fma(num[q].y, det.x, -num[q].x * det.y), acc[q]);
  }
}

// The A fragment of one of a lane's rows for a product step of 8 record
// rows from row b (a_i at row g + 8 (i % 2), column t + 4 (i / 2): the real
// part in row g, the imaginary part in row g + 8), or of 4 rows
template <bool Diag, class F>
__device__ __forceinline__ void fragment8(F of, int b, int t, double (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = b + t + 4 * (i / 2);
    const double2 c = of(Diag ? kDiagRows[r] : kTraceRows[r]);
    a[i] = i % 2 ? c.y : c.x;
  }
}

template <bool Diag, class F>
__device__ __forceinline__ void fragment4(F of, int b, int t, double (&a)[2]) {
  const double2 c = of(Diag ? kDiagRows[b + t] : kTraceRows[b + t]);
  a[0] = c.x;
  a[1] = c.y;
}

// partials[c, w, j]: j < 1 (trace) or j < 3 (diagonal). A warp takes 8
// lanes (the rows of its products: lane g's real part in row g, its
// imaginary part in row g + 8) and every k of the chunk, 8 k-points (the
// columns) a step: det M from m16n8k8, m16n8k8 and m16n8k4 products over
// the record's rows 0-19, e2 M (trace) from an m16n8k8 and an m16n8k4,
// each minor_ii M (diagonal) from one m16n8k4. Thread (g, t) then holds
// lane g's values at the step's k-points 2t and 2t + 1 and finishes them
// there: the guard, one reciprocal, the weighted sum (issuing the next
// step's products first held more registers and ran slower:
// tools/kernel_variants.py sigma_trace pipelined). The four threads of a lane meet in a fixed order at the
// chunk's end. The guard's bound takes the tile's largest |H|, |adj H| and
// |det H| (at least each pair's own B).
template <bool Diag>
__global__ void __launch_bounds__(kThreads)
sigma_trace_dmma(const double2* __restrict__ H, const double* __restrict__ w, const double2* __restrict__ Z,
                 double* __restrict__ partials, int64_t K, int W) {
  constexpr int J = Diag ? 3 : 1;
  constexpr int kNum = Diag ? 3 : 1;  // the minors, or e2 M
  __shared__ double rec[kRows * kTileStride];
  __shared__ double tmax[kKWarps][3];

  const int lid = threadIdx.x % 32, g = lid / 4, t = lid % 4, warp = threadIdx.x / 32;
  const int wi = blockIdx.x * kLanes + warp * 8 + g;
  const bool live = wi < W;
  const double2* Zl = Z + static_cast<int64_t>(live ? wi : 0) * 9;
  double ad[2][4], ad4[2], an[4], an4[kNum][2];  // the A fragments: det's, the numerators'
  double2 zd[kNum];                              // the numerators' constants: adj Z_ii (diagonal)
  double adet, nadj, nz;
  {
    double2 z[9];
#pragma unroll
    for (int i = 0; i < 9; ++i)  // a dead lane takes i I - H, which is never singular
      z[i] = live ? Zl[i] : make_double2(0.0, i % 4 == 0 ? 1.0 : 0.0);
    Lane3 L;
    L.init(z);
    const auto det_of = [&](int c) { return L.det_of(c); };
    fragment8<Diag>(det_of, 0, t, ad[0]);
    fragment8<Diag>(det_of, 8, t, ad[1]);
    fragment4<Diag>(det_of, 16, t, ad4);
    if constexpr (Diag) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        fragment4<Diag>([&](int c) { return L.minor_of(q, c); }, kMinorBase[q], t, an4[q]);
        zd[q] = make_double2(-L.na[q].x, -L.na[q].y);
      }
    } else {
      const auto e2_of = [&](int c) { return L.e2_of(c); };
      fragment8<Diag>(e2_of, 10, t, an);
      fragment4<Diag>(e2_of, 18, t, an4[0]);
      zd[0] = make_double2(0.0, 0.0);
    }
    adet = L.adet;
    nadj = L.nadj;
    nz = L.nz;
  }

  // one step's products: columns n0..n0 + 7 (b_i: row t + 4 i, column g)
  const auto products = [&](int n0, double (&dd)[4], double (&dn)[kNum][4]) {
    const double* col = rec + n0 + g;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dd[e] = 0.0;
#pragma unroll
      for (int q = 0; q < kNum; ++q) dn[q][e] = 0.0;
    }
    autobz::dmma(dd, ad[0], col[t * kTileStride], col[(t + 4) * kTileStride]);
    autobz::dmma(dd, ad[1], col[(8 + t) * kTileStride], col[(12 + t) * kTileStride]);
    autobz::dmma_k4(dd, ad4, col[(16 + t) * kTileStride]);
    if constexpr (Diag) {
#pragma unroll
      for (int q = 0; q < 3; ++q) autobz::dmma_k4(dn[q], an4[q], col[(kMinorBase[q] + t) * kTileStride]);
    } else {
      autobz::dmma(dn[0], an, col[(10 + t) * kTileStride], col[(14 + t) * kTileStride]);
      autobz::dmma_k4(dn[0], an4[0], col[(18 + t) * kTileStride]);
    }
  };

  const int64_t nchunks = (K + kChunkK - 1) / kChunkK;
  for (int64_t c = blockIdx.y; c < nchunks; c += gridDim.y) {
    const int64_t kbeg = c * kChunkK;
    const int64_t kend = K < kbeg + kChunkK ? K : kbeg + kChunkK;
    double acc[J];
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = 0.0;
    for (int64_t t0 = kbeg; t0 < kend; t0 += kTileK) {
      const int nk = static_cast<int>(kend - t0 < kTileK ? kend - t0 : kTileK);
      __syncthreads();  // the previous tile is consumed
      double nm[3] = {0.0, 0.0, 0.0};
      const int i = threadIdx.x;
      if (i < nk) build_column<Diag>(H + (t0 + i) * 9, w[t0 + i], rec + i, nm);
#pragma unroll
      for (int v = 0; v < 3; ++v) {
#pragma unroll
        for (int off = 16; off > 0; off /= 2) nm[v] = fmax(nm[v], __shfl_xor_sync(0xffffffffu, nm[v], off));
        if (lid == 0) tmax[warp][v] = nm[v];
      }
      __syncthreads();
      double m3[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) m3[v] = fmax(fmax(tmax[0][v], tmax[1][v]), fmax(tmax[2][v], tmax[3][v]));
      const double Bt = fma(nz, m3[1], fma(nadj, m3[0], adet + m3[2]));
      // a pair takes the expansion where kGuard |det| >= Bt and |det|^2 is in rcp's range
      const double lo = fmax(Bt * Bt * (1.0 / kGuard2), 0x1p-1021);

      // the guard, one reciprocal and the weighted sum at the step's k-points n0 + 2t + e
      // (d_i: row g + 8 (i / 2), column 2 t + i % 2)
      const auto finish = [&](int n0, const double (&dd)[4], const double (&dn)[kNum][4]) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = n0 + 2 * t + e;
          if (kk >= nk) continue;
          const double2 det = make_double2(dd[e], dd[2 + e]);
          const double den = fma(det.x, det.x, det.y * det.y);
          const double wk = rec[kWeight * kTileStride + kk];
          if (!(den >= lo && den < 0x1p1022)) {
            double h[9];
#pragma unroll
            for (int r = 0; r < kBRows; ++r) {
              const int cq = Diag ? kDiagRows[r] : kTraceRows[r];
              if (cq < 9) h[cq] = rec[r * kTileStride + kk];
            }
            direct3<Diag>(Zl, live, h, wk, acc);
            continue;
          }
          const double wr = wk * rcp(den);
#pragma unroll
          for (int q = 0; q < kNum; ++q) {
            double nx = dn[q][e] + zd[q].x;
            if constexpr (Diag) nx += rec[(kAdjHDiag + q) * kTileStride + kk];
            const double ny = dn[q][2 + e] + zd[q].y;
            acc[q] = fma(wr, fma(ny, det.x, -nx * det.y), acc[q]);
          }
        }
      };

      double d0[4], n0s[kNum][4];
      for (int n0 = 0; n0 < nk; n0 += 8) {
        products(n0, d0, n0s);
        finish(n0, d0, n0s);
      }
    }
    // lane g's four threads, in the order t = 0, 1, 2, 3
#pragma unroll
    for (int q = 0; q < J; ++q) {
      double sum = __shfl_sync(0xffffffffu, acc[q], 4 * g);
#pragma unroll
      for (int v = 1; v < 4; ++v) sum += __shfl_sync(0xffffffffu, acc[q], 4 * g + v);
      if (t == 0 && live) partials[(c * W + wi) * J + q] = sum;
    }
  }
}

// ---- trace and diagonal sums, m = 1 and 2: M formed directly -------------------------------

// a k's record: m = 1 h00; m = 2 h00, h11, Re h01, Im h01 (H's Hermitian part)
template <int M>
constexpr int kRecSmall = M == 1 ? 1 : 4;

template <int M>
__device__ __forceinline__ void build_record_small(const double2* __restrict__ x, double* rec) {
  rec[0] = x[0].x;
  if constexpr (M == 2) {
    const double2 h01 = herm<2>(x, 0, 1);
    rec[1] = x[3].x;
    rec[2] = h01.x;
    rec[3] = h01.y;
  }
}

template <int M, bool Diag>
__device__ __forceinline__ void pair_small(const double2* z, const double* r, double wk, double* acc) {
  if constexpr (M == 1) {
    const double2 d = make_double2(z[0].x - r[0], z[0].y);
    const double den = fma(d.x, d.x, d.y * d.y);
    const double q = out_of_range(den) ? Scaled(d).im(make_double2(1.0, 0.0)) : -d.y * rcp(den);
    acc[0] = fma(wk, q, acc[0]);
  } else {
    const double2 a0 = make_double2(z[0].x - r[0], z[0].y), a3 = make_double2(z[3].x - r[1], z[3].y);
    const double2 a1 = make_double2(z[1].x - r[2], z[1].y - r[3]), a2 = make_double2(z[2].x - r[2], z[2].y + r[3]);
    const double2 det = csub(cmul(a0, a3), cmul(a1, a2));
    const double den = fma(det.x, det.x, det.y * det.y);
    const double2 num[2] = {Diag ? a3 : cadd(a0, a3), a0};
    if (out_of_range(den)) {
      const Scaled s(det);
#pragma unroll
      for (int q = 0; q < (Diag ? 2 : 1); ++q) acc[q] = fma(wk, s.im(num[q]), acc[q]);
    } else {
      const double wr = wk * rcp(den);
#pragma unroll
      for (int q = 0; q < (Diag ? 2 : 1); ++q) acc[q] = fma(wr, fma(num[q].y, det.x, -num[q].x * det.y), acc[q]);
    }
  }
}

// partials[c, w, j]: j < 1 (trace) or j < M (diagonal); the general
// route's layout (a lane a thread, four warps over every fourth k)
template <int M, bool Diag>
__global__ void __launch_bounds__(kThreads)
sigma_trace_small(const double2* __restrict__ H, const double* __restrict__ w, const double2* __restrict__ Z,
                  double* __restrict__ partials, int64_t K, int W) {
  constexpr int MM = M * M;
  constexpr int J = Diag ? M : 1;
  constexpr int kRec = kRecSmall<M>;
  __shared__ double recs[kTileK * kRec];
  __shared__ double ws[kTileK];
  __shared__ double red[kKWarps][kLanes][J];

  const int lane = threadIdx.x % kLanes;
  const int kw = threadIdx.x / kLanes;
  const int wi = blockIdx.x * kLanes + lane;
  const bool live = wi < W;
  double2 z[MM];
#pragma unroll
  for (int i = 0; i < MM; ++i)  // a dead lane takes i I - H, which is never singular
    z[i] = live ? Z[static_cast<int64_t>(wi) * MM + i] : make_double2(0.0, i % (M + 1) == 0 ? 1.0 : 0.0);

  const int64_t nchunks = (K + kChunkK - 1) / kChunkK;
  for (int64_t c = blockIdx.y; c < nchunks; c += gridDim.y) {
    const int64_t kbeg = c * kChunkK;
    const int64_t kend = K < kbeg + kChunkK ? K : kbeg + kChunkK;
    double acc[J];
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = 0.0;
    for (int64_t t0 = kbeg; t0 < kend; t0 += kTileK) {
      const int nk = static_cast<int>(kend - t0 < kTileK ? kend - t0 : kTileK);
      __syncthreads();  // the previous tile (and chunk's reduction) is consumed
      for (int i = threadIdx.x; i < nk; i += kThreads) {
        build_record_small<M>(H + (t0 + i) * MM, recs + i * kRec);
        ws[i] = w[t0 + i];
      }
      __syncthreads();
      for (int j = kw; j < nk; j += kKWarps) pair_small<M, Diag>(z, recs + j * kRec, ws[j], acc);
    }
#pragma unroll
    for (int q = 0; q < J; ++q) red[kw][lane][q] = acc[q];
    __syncthreads();
    if (kw == 0 && live) {
#pragma unroll
      for (int q = 0; q < J; ++q) {
        double s = red[0][lane][q];
#pragma unroll
        for (int v = 1; v < kKWarps; ++v) s += red[v][lane][q];
        partials[(c * W + wi) * J + q] = s;
      }
    }
  }
}

// ---- trace and diagonal sums, 4 <= m <= 8 (the general inverse) ---------------------------

template <int M, bool Diag>
__global__ void __launch_bounds__(kThreads)
sigma_trace_partials(const double2* __restrict__ H, const double* __restrict__ w, const double2* __restrict__ Z,
                     double* __restrict__ partials, int64_t K, int W) {
  constexpr int MM = M * M;
  constexpr int J = Diag ? M : 1;
  constexpr int kTile = tile_k<M>();
  __shared__ double2 hs[kTile * MM];
  __shared__ double ws[kTile];
  __shared__ double red[kKWarps][kLanes][J];

  const int lane = threadIdx.x % kLanes;
  const int kw = threadIdx.x / kLanes;
  const int wi = blockIdx.x * kLanes + lane;
  const bool live = wi < W;
  double2 z[MM];
#pragma unroll
  for (int i = 0; i < MM; ++i)  // a dead lane inverts i I - H, which is never singular
    z[i] = live ? Z[static_cast<int64_t>(wi) * MM + i] : make_double2(0.0, i % (M + 1) == 0 ? 1.0 : 0.0);

  const int64_t nchunks = (K + kChunkK - 1) / kChunkK;
  for (int64_t c = blockIdx.y; c < nchunks; c += gridDim.y) {
    const int64_t kbeg = c * kChunkK;
    const int64_t kend = K < kbeg + kChunkK ? K : kbeg + kChunkK;
    double acc[J];
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = 0.0;
    for (int64_t t0 = kbeg; t0 < kend; t0 += kTile) {
      const int nk = static_cast<int>(kend - t0 < kTile ? kend - t0 : kTile);
      __syncthreads();  // the previous tile (and chunk's reduction) is consumed
      for (int i = threadIdx.x; i < nk * MM; i += kThreads) hs[i] = H[t0 * MM + i];
      for (int i = threadIdx.x; i < nk; i += kThreads) ws[i] = w[t0 + i];
      __syncthreads();
      for (int j = kw; j < nk; j += kKWarps) {
        double2 a[MM];
#pragma unroll
        for (int i = 0; i < MM; ++i) a[i] = csub(z[i], hs[j * MM + i]);
        if (Diag) {
          double g[M];
          autobz::inverse_diag_imag<M>(a, g);
#pragma unroll
          for (int q = 0; q < J; ++q) acc[q] += ws[j] * g[q];
        } else {
          acc[0] += ws[j] * GeneralInverse<M>::trace_inv(a).y;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < J; ++q) red[kw][lane][q] = acc[q];
    __syncthreads();
    if (kw == 0 && live) {
#pragma unroll
      for (int q = 0; q < J; ++q) {
        double s = red[0][lane][q];
#pragma unroll
        for (int v = 1; v < kKWarps; ++v) s += red[v][lane][q];
        partials[(c * W + wi) * J + q] = s;
      }
    }
  }
}

template <int M>
void launch_partials(bool diag, dim3 grid, cudaStream_t st, const double2* H, const double* w,
                     const double2* Z, double* partials, int64_t K, int W) {
  if constexpr (M == 3) {
    if (diag) {
      sigma_trace_dmma<true><<<grid, kThreads, 0, st>>>(H, w, Z, partials, K, W);
    } else {
      sigma_trace_dmma<false><<<grid, kThreads, 0, st>>>(H, w, Z, partials, K, W);
    }
  } else if constexpr (M <= 2) {
    if (diag) {
      sigma_trace_small<M, true><<<grid, kThreads, 0, st>>>(H, w, Z, partials, K, W);
    } else {
      sigma_trace_small<M, false><<<grid, kThreads, 0, st>>>(H, w, Z, partials, K, W);
    }
  } else if (diag) {
    sigma_trace_partials<M, true><<<grid, kThreads, 0, st>>>(H, w, Z, partials, K, W);
  } else {
    sigma_trace_partials<M, false><<<grid, kThreads, 0, st>>>(H, w, Z, partials, K, W);
  }
}

// ---- the pointwise entries, m <= 3 ----------------------------------------------------------

// n 16-byte values from src to dst, coalesced over the block
__device__ __forceinline__ void stage(double2* dst, const double2* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += kPoints) dst[i] = __ldg(src + i);
}

// The block's points' H and Z (z_stride = Zn values a point: m * m for a
// matrix, 1 for a scalar) or one Z for all (z_stride 0), a thread a point:
// at m = 3 staged through shared memory (a point's 144 B lie apart from its
// neighbour's), below read in place (a point's values are next to its
// neighbour's already). M = Z - H, or z I - H.
template <int M, int Zn, bool Scalar>
struct PointTile {
  static constexpr int MM = M * M;
  static constexpr bool kStaged = M == 3;
  double2 hs[kStaged ? kPoints * MM : 1], zs[kStaged ? kPoints * Zn : 1];
  __device__ __forceinline__ void load(const double2* __restrict__ H, const double2* __restrict__ Z,
                                       int64_t z_stride, int64_t n0, int np) {
    if constexpr (kStaged) {
      stage(hs, H + n0 * MM, np * MM);
      if (z_stride) stage(zs, Z + n0 * Zn, np * Zn);
    }
  }
  __device__ __forceinline__ void form(const double2* __restrict__ H, const double2* __restrict__ Z,
                                       int64_t z_stride, int64_t n0, int t, double2* a) const {
    double2 h[MM], z[Zn];
#pragma unroll
    for (int i = 0; i < MM; ++i) h[i] = kStaged ? hs[t * MM + i] : __ldg(H + (n0 + t) * MM + i);
#pragma unroll
    for (int i = 0; i < Zn; ++i)
      z[i] = !z_stride ? __ldg(Z + i) : kStaged ? zs[t * Zn + i] : __ldg(Z + (n0 + t) * Zn + i);
    form_m<M, Scalar>(h, z, a);
  }
};

template <int M, int Zn>
__global__ void __launch_bounds__(kPoints)
sigma_trace_points_small(const double2* __restrict__ H, const double2* __restrict__ Z, int64_t z_stride,
                         double2* __restrict__ out, int64_t N) {
  using Tile = PointTile<M, Zn, false>;
  __shared__ Tile tile;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kPoints;
  const int np = static_cast<int>(N - n0 < kPoints ? N - n0 : kPoints);
  tile.load(H, Z, z_stride, n0, np);
  if constexpr (Tile::kStaged) __syncthreads();
  const int t = threadIdx.x;
  if (t >= np) return;
  double2 a[M * M];
  tile.form(H, Z, z_stride, n0, t, a);
  out[n0 + t] = GeneralInverse<M>::trace_inv(a);
}

// A(Z - H) / (2 pi); at m = 3 written back through the staged tile
template <int M, int Zn>
__global__ void __launch_bounds__(kPoints)
sigma_spectral_points_small(const double2* __restrict__ H, const double2* __restrict__ Z, int64_t z_stride,
                            double2* __restrict__ out, int64_t N, double inv_2pi) {
  constexpr int MM = M * M;
  using Tile = PointTile<M, Zn, Zn == 1 && M != 1>;
  __shared__ Tile tile;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kPoints;
  const int np = static_cast<int>(N - n0 < kPoints ? N - n0 : kPoints);
  tile.load(H, Z, z_stride, n0, np);
  if constexpr (Tile::kStaged) __syncthreads();
  const int t = threadIdx.x;
  double2 g[MM], A[MM];
  if (t < np) {
    double2 a[MM];
    tile.form(H, Z, z_stride, n0, t, a);
    GeneralInverse<M>::inverse(a, g);
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int q = 0; q < M; ++q) {
        const double2 gab = g[r * M + q], gba = g[q * M + r];
        A[r * M + q] = make_double2(-(gab.y + gba.y) * inv_2pi, (gab.x - gba.x) * inv_2pi);
      }
  }
  if constexpr (Tile::kStaged) {
    __syncthreads();  // every point's H is read: the tile takes the results
    if (t < np) {
#pragma unroll
      for (int i = 0; i < MM; ++i) tile.hs[t * MM + i] = A[i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < np * MM; i += kPoints) out[n0 * MM + i] = tile.hs[i];
  } else if (t < np) {
#pragma unroll
    for (int i = 0; i < MM; ++i) out[(n0 + t) * MM + i] = A[i];
  }
}

// ---- pointwise entries, 4 <= m <= 8 (the general inverse) ----------------------------------

template <int M>
__global__ void sigma_trace_points_kernel(const double2* __restrict__ H, const double2* __restrict__ Z,
                                          int64_t z_stride, double2* __restrict__ out, int64_t N) {
  constexpr int MM = M * M;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  double2 a[MM];
#pragma unroll
  for (int i = 0; i < MM; ++i) a[i] = csub(Z[n * z_stride + i], H[n * MM + i]);
  out[n] = GeneralInverse<M>::trace_inv(a);
}

// A(M) entry (a, b) without the 1/(2 pi): (-(Im G_ab + Im G_ba), Re G_ab - Re G_ba)
__device__ __forceinline__ double2 spectral_entry(double2 gab, double2 gba) {
  return make_double2(-(gab.y + gba.y), gab.x - gba.x);
}

template <int M>
__global__ void sigma_spectral_points_kernel(const double2* __restrict__ H, const double2* __restrict__ Z,
                                             int64_t z_stride, double2* __restrict__ out, int64_t N,
                                             double inv_2pi) {
  constexpr int MM = M * M;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  double2 a[MM], g[MM];
#pragma unroll
  for (int i = 0; i < MM; ++i) a[i] = csub(Z[n * z_stride + i], H[n * MM + i]);
  GeneralInverse<M>::inverse(a, g);
#pragma unroll
  for (int r = 0; r < M; ++r) {
#pragma unroll
    for (int q = 0; q < M; ++q) {
      const double2 s = spectral_entry(g[r * M + q], g[q * M + r]);
      out[n * MM + r * M + q] = make_double2(s.x * inv_2pi, s.y * inv_2pi);
    }
  }
}

// ---- matrix mode, a general Z per lane (any m) ---------------------------------------------

// partials[(c * kKWarps + kw), w, i]: the warp kw's part of chunk c
template <int M>
__global__ void __launch_bounds__(kThreads)
sigma_spectral_partials(const double2* __restrict__ H, const double* __restrict__ w,
                        const double2* __restrict__ Z, double2* __restrict__ partials, int64_t K, int W) {
  constexpr int MM = M * M;
  constexpr int kTile = tile_k<M>();
  // above three bands the inverse works in local memory (small_inverse.cuh),
  // and so do Z and the sums: rolled loops bound the build and the spills
  constexpr int kUnroll = M <= 3 ? 64 : 1;
  __shared__ double2 hs[kTile * MM];
  __shared__ double ws[kTile];

  const int lane = threadIdx.x % kLanes;
  const int kw = threadIdx.x / kLanes;
  const int wi = blockIdx.x * kLanes + lane;
  const bool live = wi < W;
  double2 z[MM];
#pragma unroll kUnroll
  for (int i = 0; i < MM; ++i)  // a dead lane inverts i I - H, which is never singular
    z[i] = live ? Z[static_cast<int64_t>(wi) * MM + i] : make_double2(0.0, i % (M + 1) == 0 ? 1.0 : 0.0);

  const int64_t nchunks = (K + kChunkK - 1) / kChunkK;
  for (int64_t c = blockIdx.y; c < nchunks; c += gridDim.y) {
    const int64_t kbeg = c * kChunkK;
    const int64_t kend = K < kbeg + kChunkK ? K : kbeg + kChunkK;
    double2 acc[MM];
#pragma unroll kUnroll
    for (int i = 0; i < MM; ++i) acc[i] = make_double2(0.0, 0.0);
    for (int64_t t0 = kbeg; t0 < kend; t0 += kTile) {
      const int nk = static_cast<int>(kend - t0 < kTile ? kend - t0 : kTile);
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < nk * MM; i += kThreads) hs[i] = H[t0 * MM + i];
      for (int i = threadIdx.x; i < nk; i += kThreads) ws[i] = w[t0 + i];
      __syncthreads();
      for (int j = kw; j < nk; j += kKWarps) {
        double2 a[MM], g[MM];
#pragma unroll kUnroll
        for (int i = 0; i < MM; ++i) a[i] = csub(z[i], hs[j * MM + i]);
        GeneralInverse<M>::inverse(a, g);
        const double wk = ws[j];
#pragma unroll kUnroll
        for (int r = 0; r < M; ++r) {
#pragma unroll kUnroll
          for (int q = 0; q < M; ++q) {
            const double2 s = spectral_entry(g[r * M + q], g[q * M + r]);
            acc[r * M + q].x += wk * s.x;
            acc[r * M + q].y += wk * s.y;
          }
        }
      }
    }
    if (live) {
      double2* row = partials + ((c * kKWarps + kw) * W + wi) * MM;
#pragma unroll kUnroll
      for (int i = 0; i < MM; ++i) row[i] = acc[i];
    }
  }
}

// ---- matrix mode, a scalar z per lane, m <= 3 ----------------------------------------------

// The per-k record (kZRec<M> doubles) and a lane's sums. det(z I - H) in
// diagonal shifts d_i = z - h_ii, which share z's imaginary part y:
//   m = 1: d0;  m = 2: d0 d1 - p01;
//   m = 3: A = d0 d1 - p01, det = d2 A - d0 p12 - d1 p02 - c,
// p_ij = |h_ij|^2, c = 2 Re(h01 h12 h20); then c_k = w_k / det and
//   G_k = c_k adj(z I - H_k) = c_k (z^2 I + z H'_k + adj H_k)   (m = 3),
//                              c_k (z I + H'_k)                 (m = 2),
//                              c_k                              (m = 1),
// H' = H - tr H I. A Hermitian factor X's off-diagonal x = a + i b enters
// c x and c conj(x) (its lower entry) through four real sums: cr a, ci b,
// cr b, ci a.
template <int M>
constexpr int kZRec = M == 3 ? 26 : M == 2 ? 5 : 1;

// m = 3 record: h00 h11 h22 | H' diagonal | H's off-diagonal reals (6) |
// adj H's nine reals | p01 p02 p12 | p02 + p12 | -c
template <int M>
__device__ __forceinline__ void build_zrecord(const double2* __restrict__ x, double* rec) {
  if constexpr (M == 1) {
    rec[0] = x[0].x;
  } else if constexpr (M == 2) {
    const double2 h01 = herm<2>(x, 0, 1);
    rec[0] = x[0].x;
    rec[1] = x[3].x;
    rec[2] = h01.x;
    rec[3] = h01.y;
    rec[4] = h01.x * h01.x + h01.y * h01.y;
  } else {
    double h[9];
    herm_reals(x, h);
    const double tr = h[0] + h[1] + h[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      rec[i] = h[i];
      rec[3 + i] = h[i] - tr;
    }
#pragma unroll
    for (int q = 3; q < 9; ++q) rec[3 + q] = h[q];
    herm_adjugate(h, rec + 12);
    const double p01 = h[3] * h[3] + h[4] * h[4], p02 = h[5] * h[5] + h[6] * h[6], p12 = h[7] * h[7] + h[8] * h[8];
    rec[21] = p01;
    rec[22] = p02;
    rec[23] = p12;
    rec[24] = p02 + p12;
    // h01 h12 conj(h02)
    const double ux = h[3] * h[7] - h[4] * h[8], uy = h[3] * h[8] + h[4] * h[7];
    rec[25] = -2.0 * (ux * h[5] + uy * h[6]);
  }
}

// four real sums of c x, c conj(x) for x = a + i b: (cr a, ci b, cr b, ci a)
struct OffSums {
  double rr = 0.0, ii = 0.0, ri = 0.0, ir = 0.0;
  __device__ __forceinline__ void add(double cr, double ci, double a, double b) {
    rr = fma(cr, a, rr);
    ii = fma(ci, b, ii);
    ri = fma(cr, b, ri);
    ir = fma(ci, a, ir);
  }
  __device__ __forceinline__ double2 upper() const { return make_double2(rr - ii, ri + ir); }  // sum c x
  __device__ __forceinline__ double2 lower() const { return make_double2(rr + ii, ir - ri); }  // sum c conj(x)
};

template <int M>
struct ZSums {
  double2 s0;
  double2 s1d[M > 1 ? M : 1], s2d[M > 2 ? M : 1];
  OffSums s1o[M > 1 ? M * (M - 1) / 2 : 1], s2o[M > 2 ? 3 : 1];

  __device__ __forceinline__ void zero() {
    s0 = make_double2(0.0, 0.0);
#pragma unroll
    for (int i = 0; i < (M > 1 ? M : 1); ++i) s1d[i] = make_double2(0.0, 0.0);
#pragma unroll
    for (int i = 0; i < (M > 2 ? M : 1); ++i) s2d[i] = make_double2(0.0, 0.0);
#pragma unroll
    for (int i = 0; i < (M > 1 ? M * (M - 1) / 2 : 1); ++i) s1o[i] = OffSums();
#pragma unroll
    for (int i = 0; i < (M > 2 ? 3 : 1); ++i) s2o[i] = OffSums();
  }

  // one pair: z = (x, y), y2 = y^2, the record r and the weight wk
  __device__ __forceinline__ void add(double x, double y, double y2, const double* r, double wk) {
    double2 det;
    if constexpr (M == 1) {
      det = make_double2(x - r[0], y);
    } else if constexpr (M == 2) {
      const double d0 = x - r[0], d1 = x - r[1];
      det = make_double2(fma(d0, d1, -r[4]) - y2, y * (d0 + d1));
    } else {
      const double d0 = x - r[0], d1 = x - r[1], d2 = x - r[2];
      const double ax = fma(d0, d1, -r[21]) - y2, ay = y * (d0 + d1);
      det = make_double2(fma(d2, ax, fma(-y, ay, fma(-d0, r[23], fma(-d1, r[22], r[25])))),
                         fma(d2, ay, y * (ax - r[24])));
    }
    const double den = fma(det.x, det.x, det.y * det.y);
    double cr, ci;
    if (out_of_range(den)) {
      const double2 c = Scaled(det).quot(make_double2(wk, 0.0));
      cr = c.x;
      ci = c.y;
    } else {
      const double s = wk * rcp(den);
      cr = det.x * s;
      ci = -det.y * s;
    }
    s0.x += cr;
    s0.y += ci;
    if constexpr (M == 2) {
      // H' = H - tr H I: diagonal -h11, -h00
      s1d[0] = make_double2(fma(-cr, r[1], s1d[0].x), fma(-ci, r[1], s1d[0].y));
      s1d[1] = make_double2(fma(-cr, r[0], s1d[1].x), fma(-ci, r[0], s1d[1].y));
      s1o[0].add(cr, ci, r[2], r[3]);
    } else if constexpr (M == 3) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s1d[i] = make_double2(fma(cr, r[3 + i], s1d[i].x), fma(ci, r[3 + i], s1d[i].y));
        s2d[i] = make_double2(fma(cr, r[12 + i], s2d[i].x), fma(ci, r[12 + i], s2d[i].y));
        s1o[i].add(cr, ci, r[6 + 2 * i], r[7 + 2 * i]);
        s2o[i].add(cr, ci, r[15 + 2 * i], r[16 + 2 * i]);
      }
    }
  }

  // the row of A' = i (G - G^H) entries, G = sum_k c_k adj(z I - H_k)
  __device__ __forceinline__ void write(double2 z, double2* row) const {
    double2 g[M * M];
    if constexpr (M == 1) {
      g[0] = s0;
    } else {
      const double2 zc = M == 3 ? cmul(z, z) : z;  // the identity's factor: z^2 or z
      const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
#pragma unroll
      for (int i = 0; i < M; ++i) {
        double2 gi = cadd(cmul(zc, s0), M == 3 ? cmul(z, s1d[i]) : s1d[i]);
        if constexpr (M == 3) gi = cadd(gi, s2d[i]);
        g[i * M + i] = gi;
      }
#pragma unroll
      for (int p = 0; p < M * (M - 1) / 2; ++p) {
        const int i = pairs[p][0], j = pairs[p][1];
        double2 u = s1o[p].upper(), l = s1o[p].lower();
        if constexpr (M == 3) {
          u = cadd(cmul(z, u), s2o[p].upper());
          l = cadd(cmul(z, l), s2o[p].lower());
        }
        g[i * M + j] = u;
        g[j * M + i] = l;
      }
    }
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int b = 0; b < M; ++b) row[a * M + b] = spectral_entry(g[a * M + b], g[b * M + a]);
  }
};

// partials[(c * kKWarps + kw), w, i], as the general route's
template <int M>
__global__ void __launch_bounds__(kThreads)
sigma_spectral_z_partials(const double2* __restrict__ H, const double* __restrict__ w,
                          const double2* __restrict__ z, double2* __restrict__ partials, int64_t K, int W) {
  constexpr int MM = M * M;
  constexpr int kRec = kZRec<M>;
  constexpr int kRec2 = (kRec + 1) / 2;
  __shared__ double2 recs[kTileK * kRec2];
  __shared__ double ws[kTileK];

  const int lane = threadIdx.x % kLanes;
  const int kw = threadIdx.x / kLanes;
  const int wi = blockIdx.x * kLanes + lane;
  const bool live = wi < W;
  const double2 zl = live ? z[wi] : make_double2(0.0, 1.0);  // a dead lane takes z = i
  const double y2 = zl.y * zl.y;

  const int64_t nchunks = (K + kChunkK - 1) / kChunkK;
  for (int64_t c = blockIdx.y; c < nchunks; c += gridDim.y) {
    const int64_t kbeg = c * kChunkK;
    const int64_t kend = K < kbeg + kChunkK ? K : kbeg + kChunkK;
    ZSums<M> acc;
    acc.zero();
    for (int64_t t0 = kbeg; t0 < kend; t0 += kTileK) {
      const int nk = static_cast<int>(kend - t0 < kTileK ? kend - t0 : kTileK);
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < nk; i += kThreads) {
        double rec[kRec];
        build_zrecord<M>(H + (t0 + i) * MM, rec);
        double* dst = reinterpret_cast<double*>(recs + i * kRec2);
#pragma unroll
        for (int q = 0; q < kRec; ++q) dst[q] = rec[q];
        ws[i] = w[t0 + i];
      }
      __syncthreads();
      for (int j = kw; j < nk; j += kKWarps) {
        double r[2 * kRec2];
#pragma unroll
        for (int q = 0; q < kRec2; ++q) {
          const double2 v = recs[j * kRec2 + q];
          r[2 * q] = v.x;
          r[2 * q + 1] = v.y;
        }
        acc.add(zl.x, zl.y, y2, r, ws[j]);
      }
    }
    if (live) {
      double2 row[MM];
      acc.write(zl, row);
      double2* dst = partials + ((c * kKWarps + kw) * W + wi) * MM;
#pragma unroll
      for (int i = 0; i < MM; ++i) dst[i] = row[i];
    }
  }
}

}  // namespace

// The largest m K27 and K28 take.
extern "C" int sigma_max_bands() { return autobz::kMaxInverse; }

// Rows of the partials scratch: one per k-chunk.
extern "C" long long sigma_trace_num_chunks(long long K) { return (K + kChunkK - 1) / kChunkK; }

// H: (K, m, m) complex128 (Hermitian for m <= 3: its Hermitian part is
// read); w: (K,) float64; Z: (W, m, m) complex128; partials:
// (num_chunks(K), W, J) float64 with J = m in the diagonal mode, else 1;
// out: (W, J) float64, factor * sum_k w_k Im(...). Returns
// cudaErrorInvalidValue for m outside 1..sigma_max_bands(), else
// cudaGetLastError() after the launches.
extern "C" int sigma_trace_sum_launch(const void* H, const void* w, const void* Z, void* partials, void* out,
                                      long long K, int W, int m, int diagonal, double factor, void* stream) {
  if (m < 1 || m > autobz::kMaxInverse) return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nchunks = sigma_trace_num_chunks(K);
  const int J = diagonal ? m : 1;
  if (nchunks > 0) {
    const dim3 grid((W + kLanes - 1) / kLanes, static_cast<unsigned>(nchunks < 65535 ? nchunks : 65535));
    const auto* Hp = static_cast<const double2*>(H);
    const auto* wp = static_cast<const double*>(w);
    const auto* Zp = static_cast<const double2*>(Z);
    auto* pp = static_cast<double*>(partials);
    const bool dg = diagonal != 0;
    switch (m) {
      case 1: launch_partials<1>(dg, grid, st, Hp, wp, Zp, pp, K, W); break;
      case 2: launch_partials<2>(dg, grid, st, Hp, wp, Zp, pp, K, W); break;
      case 3: launch_partials<3>(dg, grid, st, Hp, wp, Zp, pp, K, W); break;
      case 4: launch_partials<4>(dg, grid, st, Hp, wp, Zp, pp, K, W); break;
      case 5: launch_partials<5>(dg, grid, st, Hp, wp, Zp, pp, K, W); break;
      case 6: launch_partials<6>(dg, grid, st, Hp, wp, Zp, pp, K, W); break;
      case 7: launch_partials<7>(dg, grid, st, Hp, wp, Zp, pp, K, W); break;
      default: launch_partials<8>(dg, grid, st, Hp, wp, Zp, pp, K, W); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return autobz::column_sum_launch(static_cast<const double*>(partials), static_cast<double*>(out), nchunks,
                                   static_cast<int64_t>(W) * J, factor, st);
}

// H: (N, m, m) complex128 (Hermitian for m <= 3); Z: complex128 with
// z_stride = m * m (one matrix a point) or 0 (one for all); out: (N,)
// complex128, Tr (Z_n - H_n)^{-1}.
extern "C" int sigma_trace_points_launch(const void* H, const void* Z, long long z_stride, void* out, long long N,
                                         int m, void* stream) {
  if (m < 1 || m > autobz::kMaxInverse || (z_stride != 0 && z_stride != static_cast<long long>(m) * m))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((N + 127) / 128);
  const auto* Hp = static_cast<const double2*>(H);
  const auto* Zp = static_cast<const double2*>(Z);
  auto* op = static_cast<double2*>(out);
  switch (m) {
    case 1: sigma_trace_points_small<1, 1><<<blocks, kPoints, 0, st>>>(Hp, Zp, z_stride, op, N); break;
    case 2: sigma_trace_points_small<2, 4><<<blocks, kPoints, 0, st>>>(Hp, Zp, z_stride, op, N); break;
    case 3: sigma_trace_points_small<3, 9><<<blocks, kPoints, 0, st>>>(Hp, Zp, z_stride, op, N); break;
    case 4: sigma_trace_points_kernel<4><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N); break;
    case 5: sigma_trace_points_kernel<5><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N); break;
    case 6: sigma_trace_points_kernel<6><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N); break;
    case 7: sigma_trace_points_kernel<7><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N); break;
    default: sigma_trace_points_kernel<8><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows of the matrix mode's partials scratch: one per (k-chunk, warp).
extern "C" long long sigma_spectral_num_rows(long long K) { return sigma_trace_num_chunks(K) * kKWarps; }

// H: (K, m, m) complex128 (Hermitian for m <= 3 with scalar z); w: (K,)
// float64; Z: (W, m, m) complex128, or with scalar != 0 and m <= 3 the
// lanes' z (W,) complex128 (Z = z I); partials: (num_rows(K), W, m, m)
// complex128; out: (W, m, m) complex128, factor * sum_k w_k (G - G^H) i, the
// matrix spectral function's weighted sum for factor = scale / (2 pi).
// Returns cudaErrorInvalidValue for m outside 1..sigma_max_bands() (1..3
// with scalar z), else cudaGetLastError() after the launches.
extern "C" int sigma_spectral_sum_launch(const void* H, const void* w, const void* Z, int scalar, void* partials,
                                         void* out, long long K, int W, int m, double factor, void* stream) {
  if (m < 1 || m > (scalar ? 3 : autobz::kMaxInverse)) return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nchunks = sigma_trace_num_chunks(K);
  if (nchunks > 0) {
    const dim3 grid((W + kLanes - 1) / kLanes, static_cast<unsigned>(nchunks < 65535 ? nchunks : 65535));
    const auto* Hp = static_cast<const double2*>(H);
    const auto* wp = static_cast<const double*>(w);
    const auto* Zp = static_cast<const double2*>(Z);
    auto* pp = static_cast<double2*>(partials);
    if (scalar) {
      switch (m) {
        case 1: sigma_spectral_z_partials<1><<<grid, kThreads, 0, st>>>(Hp, wp, Zp, pp, K, W); break;
        case 2: sigma_spectral_z_partials<2><<<grid, kThreads, 0, st>>>(Hp, wp, Zp, pp, K, W); break;
        default: sigma_spectral_z_partials<3><<<grid, kThreads, 0, st>>>(Hp, wp, Zp, pp, K, W); break;
      }
    } else {
      switch (m) {
        case 1: sigma_spectral_partials<1><<<grid, kThreads, 0, st>>>(Hp, wp, Zp, pp, K, W); break;
        case 2: sigma_spectral_partials<2><<<grid, kThreads, 0, st>>>(Hp, wp, Zp, pp, K, W); break;
        case 3: sigma_spectral_partials<3><<<grid, kThreads, 0, st>>>(Hp, wp, Zp, pp, K, W); break;
        case 4: sigma_spectral_partials<4><<<grid, kThreads, 0, st>>>(Hp, wp, Zp, pp, K, W); break;
        case 5: sigma_spectral_partials<5><<<grid, kThreads, 0, st>>>(Hp, wp, Zp, pp, K, W); break;
        case 6: sigma_spectral_partials<6><<<grid, kThreads, 0, st>>>(Hp, wp, Zp, pp, K, W); break;
        case 7: sigma_spectral_partials<7><<<grid, kThreads, 0, st>>>(Hp, wp, Zp, pp, K, W); break;
        default: sigma_spectral_partials<8><<<grid, kThreads, 0, st>>>(Hp, wp, Zp, pp, K, W); break;
      }
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return autobz::column_sum_launch(static_cast<const double2*>(partials), static_cast<double2*>(out),
                                   nchunks * kKWarps, static_cast<int64_t>(W) * m * m, factor, st);
}

// H: (N, m, m) complex128 (Hermitian for m <= 3); Z: complex128, one value
// set for all points (z_stride 0) or one a point: with scalar = 0 an (m, m)
// matrix (z_stride = m * m), with scalar != 0 (m <= 3) the point's z of Z
// = z I (z_stride 1); out: (N, m, m) complex128, A(Z_n - H_n).
extern "C" int sigma_spectral_points_launch(const void* H, const void* Z, long long z_stride, int scalar, void* out,
                                            long long N, int m, double inv_2pi, void* stream) {
  const long long zn = scalar ? 1 : static_cast<long long>(m) * m;
  if (m < 1 || m > (scalar ? 3 : autobz::kMaxInverse) || (z_stride != 0 && z_stride != zn))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((N + 127) / 128);
  const auto* Hp = static_cast<const double2*>(H);
  const auto* Zp = static_cast<const double2*>(Z);
  auto* op = static_cast<double2*>(out);
  if (scalar || m <= 3) {
    const int key = 2 * m + (scalar ? 1 : 0);
    switch (key) {
      case 2: case 3: sigma_spectral_points_small<1, 1><<<blocks, kPoints, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
      case 4: sigma_spectral_points_small<2, 4><<<blocks, kPoints, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
      case 5: sigma_spectral_points_small<2, 1><<<blocks, kPoints, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
      case 6: sigma_spectral_points_small<3, 9><<<blocks, kPoints, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
      default: sigma_spectral_points_small<3, 1><<<blocks, kPoints, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
  switch (m) {
    case 4: sigma_spectral_points_kernel<4><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    case 5: sigma_spectral_points_kernel<5><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    case 6: sigma_spectral_points_kernel<6><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    case 7: sigma_spectral_points_kernel<7><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    default: sigma_spectral_points_kernel<8><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
  }
  return static_cast<int>(cudaGetLastError());
}
