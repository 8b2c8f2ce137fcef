// K28: the matrix self-energy transport distribution in FP64, weighted
// k-sum and pointwise.
//
// Replaces autobzcore_tpu/models/selfenergy.py:138-153
// (transport_distribution_sigma), its k-sum in SigmaTransportSolver
// (:279-286) and the two-frequency integrand of
// SigmaKineticCoefficientSolver (:380-393). For frequency pairs b with
// matrices Z1_b = w1 I - Sigma(w1) and Z2_b = w2 I - Sigma(w2) (mu folded
// in by the caller) it computes
//
//   sum:       G[b, a, c] = scale * sum_k w_k Re Tr[v_a A1 v_c A2],
//   pointwise: T[n, a, c] = Re Tr[v_a A v_c A]   (one Z per point, no sum),
//
// with A_i = (G_i - G_i^H) / (-2 pi i), G_i = (Z_i - H_k)^{-1} (the
// adjugate over the determinant for m <= 3, small_inverse.cuh's
// Gauss-Jordan for 4 <= m <= 8), v_a = dH/dz_a (d <= 3). When Z2 is Z1
// (equal frequencies) the inverse is taken once. The kernel works with
// A' = 2 pi A = i (G - G^H) and folds 1 / (4 pi^2) into the final scale.
// H and v_a are Hermitian, so the kernel reads their Hermitian parts
// ((X + X^H) / 2: the inputs themselves where they are exactly Hermitian).
//
// What bounds it on an H100: FP64 arithmetic. Per (pair, k) at m = d = 3
// the function needs one spectral function (about 230 operations with M and
// the Hermitian A), the products v_c A (405) and, the trace being symmetric
// in (a, c) at equal frequencies, 6 of the 9 traces of m^2 real parts (228
// with the sums): about 860 operations at equal frequencies, 1,610 at
// unequal ones (two spectral functions, v_a A1 and v_c A2, all 9 traces).
// At the main path's 256 equal frequencies over K = 1e6 points that is
// 2.2e11 (6.5 ms at 34 TFLOP/s) against a 576 MB read of H and V (0.17 ms);
// a kinetic trip's 960 unequal pairs need 1.5e12 (45 ms).
//
// The design: a block covers 32 pair lanes (one per thread of a warp) and a
// chunk of kChunkK points; it stages the points in tiles of kTile through
// shared memory as packed Hermitian matrices (m real diagonal values and
// m (m - 1) / 2 complex ones: 9 doubles for H and for each v_a at m = 3)
// with their weights, the four warps taking every fourth point of a tile and
// all threads of a warp reading the same point, which shared memory
// broadcasts. Per (pair, point) a thread keeps only what one product needs:
//  * A' as a packed Hermitian from the adjugate, with one reciprocal of the
//    determinant, into which the weight w_k is folded at unequal
//    frequencies;
//  * at equal frequencies the d products B_c = v_c A (the Hermitian
//    structure of both factors: a real diagonal on each side), then
//    Re Tr[B_a B_c] for a <= c only (the trace is symmetric in (a, c)),
//    mirrored when the sums are written;
//  * at unequal frequencies, for one c at a time, B_c = v_c A2 and the
//    Hermitian part of Y_c = A1 B_c (m real and m (m - 1) / 2 complex
//    values), whose real inner product with v_a is Re Tr[v_a A1 v_c A2]:
//    9 multiply-adds per (a, c) at m = 3 instead of a product of two
//    general matrices, and no product v_a A1 kept across the c's.
// For m <= 3 the lanes' Z matrices sit in shared memory; above, the tiles
// shrink to keep shared memory near 16 KB and each thread reads its lane's Z
// through L1. Up to m = 4 every loop unrolls, so the packed matrices stay in
// registers (the Gauss-Jordan inverse works in local memory); above, the
// same code runs as loops over local memory. At m <= 3 a block asks for
// three blocks an SM (168 registers a thread): at four (128 registers) the
// unequal m = 3 instance spilled more and ran 12 % slower on an H100, at one
// a kinetic trip's 960 pairs ran 2 % slower; at m = 4 it asks for one, and
// the unrolled instances take 180-255 registers and run 4-5x faster than
// as loops (tools/kernel_variants.py sigma_pairs). The cross-block sum is a
// second pass in chunk order (column_sum.cuh), one partial row per k-chunk:
// no atomics, repeats are bit-identical, and a pair's sums depend neither
// on its row nor on the number of pairs. The pointwise entry runs
// one thread per point through the same functions.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"
#include "small_inverse.cuh"

namespace {

using autobz::GeneralInverse;

constexpr int kLanes = 32;     // pair lanes per block
constexpr int kKWarps = 4;     // warps per block, each over every fourth k
constexpr int kTileK = 32;     // points per shared tile for m <= 3
constexpr int kChunkK = 2048;  // points per partial row
constexpr int kThreads = kLanes * kKWarps;
constexpr double kInvFourPi2 = 0.025330295910584444;  // 1 / (4 pi^2)

// the loops unroll (and index registers) up to four bands: the helpers'
// loops run over 0..M (triangles by a test inside), which an unroll count of
// 8 unrolls fully; above, they run as loops over local memory
template <int M>
constexpr int kUnroll = M <= 4 ? 8 : 1;

// blocks an SM the sum kernel asks for: three (168 registers a thread) for
// the closed forms; one at four bands and above, whose unrolled m = 4
// instances need up to 255 registers
template <int M>
constexpr int kMinBlocks = M <= 3 ? 3 : 1;

// A Hermitian m x m matrix, packed: o the entries above the diagonal (row by
// row), d the real diagonal.
template <int M>
struct Herm {
  static constexpr int P = M * (M - 1) / 2;
  double2 o[P > 0 ? P : 1];
  double d[M];
};

// the slot of entry (i, j), i < j, in Herm::o
template <int M>
__host__ __device__ constexpr int upper(int i, int j) {
  return i * (2 * M - i - 1) / 2 + (j - i - 1);
}

// entry (i, j), i != j
template <int M>
__device__ __forceinline__ double2 herm_at(const Herm<M>& h, int i, int j) {
  if (i < j) return h.o[upper<M>(i, j)];
  const double2 x = h.o[upper<M>(j, i)];
  return make_double2(x.x, -x.y);
}

// s += a b for complex a, b; s += r b for real r
__device__ __forceinline__ void cmac(double2& s, double2 a, double2 b) {
  s.x = fma(a.x, b.x, s.x);
  s.x = fma(-a.y, b.y, s.x);
  s.y = fma(a.x, b.y, s.y);
  s.y = fma(a.y, b.x, s.y);
}
__device__ __forceinline__ void rmac(double2& s, double r, double2 b) {
  s.x = fma(r, b.x, s.x);
  s.y = fma(r, b.y, s.y);
}
// s + Re(a b), s + Im(a b), s - Im(a b)
__device__ __forceinline__ double re_mac(double s, double2 a, double2 b) { return fma(-a.y, b.y, fma(a.x, b.x, s)); }
__device__ __forceinline__ double im_mac(double s, double2 a, double2 b) { return fma(a.y, b.x, fma(a.x, b.y, s)); }
__device__ __forceinline__ double im_msub(double s, double2 a, double2 b) { return fma(-a.y, b.x, fma(-a.x, b.y, s)); }

// s + Re(A_il b), s + Im(A_il b), s - Im(A_il b) for entry (i, l) of a
// packed Hermitian A
template <int M>
__device__ __forceinline__ double re_mac_at(double s, const Herm<M>& A, int i, int l, double2 b) {
  return i == l ? fma(A.d[i], b.x, s) : re_mac(s, herm_at(A, i, l), b);
}
template <int M>
__device__ __forceinline__ double im_mac_at(double s, const Herm<M>& A, int i, int l, double2 b) {
  return i == l ? fma(A.d[i], b.y, s) : im_mac(s, herm_at(A, i, l), b);
}
template <int M>
__device__ __forceinline__ double im_msub_at(double s, const Herm<M>& A, int i, int l, double2 b) {
  return i == l ? fma(-A.d[i], b.y, s) : im_msub(s, herm_at(A, i, l), b);
}

// The Hermitian part of one row-major complex matrix x (its upper and lower
// triangles averaged) into packed form.
template <int M, int U = kUnroll<M>>
__device__ __forceinline__ void pack_hermitian(const double2* __restrict__ x, Herm<M>& h) {
#pragma unroll (U)
  for (int i = 0; i < M; ++i) {
    h.d[i] = x[i * M + i].x;
#pragma unroll (U)
    for (int j = 0; j < M; ++j) {
      if (j > i) {
        const double2 u = x[i * M + j], l = x[j * M + i];
        h.o[upper<M>(i, j)] = make_double2(0.5 * (u.x + l.x), 0.5 * (u.y - l.y));
      }
    }
  }
}

// The adjugate of a (3 x 3 as cross products of column pairs, the rows of
// GeneralInverse<3>), returning the determinant (the first row of a times
// the first column of adj).
template <int M>
__device__ __forceinline__ double2 adjugate(const double2* a, double2* adj) {
  static_assert(M <= 3, "the closed forms take M <= 3");
  if constexpr (M == 1) {
    adj[0] = make_double2(1.0, 0.0);
    return a[0];
  } else if constexpr (M == 2) {
    adj[0] = a[3];
    adj[1] = make_double2(-a[1].x, -a[1].y);
    adj[2] = make_double2(-a[2].x, -a[2].y);
    adj[3] = a[0];
  } else {
#pragma unroll
    for (int row = 0; row < 3; ++row) {
      const int p = (row + 1) % 3, q = (row + 2) % 3;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
        // a[i1, p] a[i2, q] - a[i2, p] a[i1, q]
        const double2 u = a[3 * i1 + p], v = a[3 * i2 + q], x = a[3 * i2 + p], y = a[3 * i1 + q];
        double re = u.x * v.x;
        re = fma(-u.y, v.y, re);
        re = fma(-x.x, y.x, re);
        re = fma(x.y, y.y, re);
        double im = u.x * v.y;
        im = fma(u.y, v.x, im);
        im = fma(-x.x, y.y, im);
        im = fma(-x.y, y.x, im);
        adj[3 * row + i] = make_double2(re, im);
      }
    }
  }
  double2 det = make_double2(0.0, 0.0);
#pragma unroll
  for (int j = 0; j < M; ++j) cmac(det, a[j], adj[j * M]);
  return det;
}

// f A' = f i (G - G^H), packed, of M = z - h for z (row-major, general) and
// a packed Hermitian h.
template <int M, int U = kUnroll<M>>
__device__ __forceinline__ void spectral(const double2* z, const Herm<M>& h, double f, Herm<M>& A) {
  constexpr int MM = M * M;
  double2 a[MM];
#pragma unroll (U)
  for (int j = 0; j < M; ++j) {
#pragma unroll (U)
    for (int k = 0; k < M; ++k) {
      const double2 zz = z[j * M + k];
      if (j == k) {
        a[j * M + k] = make_double2(zz.x - h.d[j], zz.y);
      } else {
        const double2 hh = herm_at(h, j, k);
        a[j * M + k] = make_double2(zz.x - hh.x, zz.y - hh.y);
      }
    }
  }
  if constexpr (M <= 3) {
    // G = adj / det; with r = -f / det: f A'_jj = 2 Im(adj_jj r), and for
    // j < k f A'_jk = Im((adj_jk + adj_kj) r) + i Re((adj_kj - adj_jk) r)
    double2 adj[MM];
    const double2 det = adjugate<M>(a, adj);
    const double s = -f / fma(det.x, det.x, det.y * det.y);
    const double2 r = make_double2(det.x * s, -det.y * s);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      A.d[j] = 2.0 * im_mac(0.0, adj[j * M + j], r);
#pragma unroll
      for (int k = 0; k < M; ++k) {
        if (k > j) {
          const double2 x = adj[j * M + k], y = adj[k * M + j];
          A.o[upper<M>(j, k)] = make_double2(im_mac(0.0, make_double2(x.x + y.x, x.y + y.y), r),
                                             re_mac(0.0, make_double2(y.x - x.x, y.y - x.y), r));
        }
      }
    }
  } else {
    double2 g[MM];
    GeneralInverse<M>::inverse(a, g);
#pragma unroll (U)
    for (int j = 0; j < M; ++j) {
      A.d[j] = -2.0 * f * g[j * M + j].y;
#pragma unroll (U)
      for (int k = j + 1; k < M; ++k) {
        const double2 x = g[j * M + k], y = g[k * M + j];
        A.o[upper<M>(j, k)] = make_double2(-f * (x.y + y.y), f * (x.x - y.x));
      }
    }
  }
}

// B = v A for packed Hermitian v and A (row-major, general)
template <int M, int U = kUnroll<M>>
__device__ __forceinline__ void herm_product(const Herm<M>& v, const Herm<M>& A, double2* B) {
#pragma unroll (U)
  for (int k = 0; k < M; ++k) {
#pragma unroll (U)
    for (int i = 0; i < M; ++i) {
      double2 s = make_double2(0.0, 0.0);
#pragma unroll (U)
      for (int l = 0; l < M; ++l) {
        if (k == l && l == i) {
          s.x = fma(v.d[k], A.d[k], s.x);
        } else if (k == l) {
          rmac(s, v.d[k], herm_at(A, l, i));
        } else if (l == i) {
          rmac(s, A.d[i], herm_at(v, k, l));
        } else {
          cmac(s, herm_at(v, k, l), herm_at(A, l, i));
        }
      }
      B[k * M + i] = s;
    }
  }
}

// Y = A B for a packed Hermitian A and a general B, kept as the parts that a
// real inner product with a Hermitian matrix reads: Y.d[i] = Re Y_ii and,
// for i < j, Y.o = Y_ij + conj(Y_ji)
template <int M, int U = kUnroll<M>>
__device__ __forceinline__ void herm_part_product(const Herm<M>& A, const double2* B, Herm<M>& Y) {
#pragma unroll (U)
  for (int i = 0; i < M; ++i) {
    double re = 0.0;
#pragma unroll (U)
    for (int l = 0; l < M; ++l) re = re_mac_at(re, A, i, l, B[l * M + i]);
    Y.d[i] = re;
#pragma unroll (U)
    for (int j = 0; j < M; ++j) {
      if (j > i) {
        double p = 0.0, q = 0.0;
#pragma unroll (U)
        for (int l = 0; l < M; ++l) {
          p = re_mac_at(p, A, i, l, B[l * M + j]);
          q = im_mac_at(q, A, i, l, B[l * M + j]);
        }
#pragma unroll (U)
        for (int l = 0; l < M; ++l) {
          p = re_mac_at(p, A, j, l, B[l * M + i]);
          q = im_msub_at(q, A, j, l, B[l * M + i]);
        }
        Y.o[upper<M>(i, j)] = make_double2(p, q);
      }
    }
  }
}

// s + Re Tr[Y v] for the parts of Y that herm_part_product keeps and a packed
// Hermitian v
template <int M, int U = kUnroll<M>>
__device__ __forceinline__ double herm_dot(const Herm<M>& Y, const Herm<M>& v, double s) {
#pragma unroll (U)
  for (int i = 0; i < M; ++i) s = fma(Y.d[i], v.d[i], s);
#pragma unroll (U)
  for (int p = 0; p < Herm<M>::P; ++p) s = fma(Y.o[p].y, v.o[p].y, fma(Y.o[p].x, v.o[p].x, s));
  return s;
}

// Re Tr[X Y] for general X, Y
template <int M, int U = kUnroll<M>>
__device__ __forceinline__ double re_trace(const double2* X, const double2* Y) {
  double t = 0.0;
#pragma unroll (U)
  for (int i = 0; i < M; ++i) {
#pragma unroll (U)
    for (int k = 0; k < M; ++k) t = re_mac(t, X[i * M + k], Y[k * M + i]);
  }
  return t;
}

// the sums a thread keeps: the pairs a <= c at equal frequencies, all d^2 else
template <int D, bool Same>
__host__ __device__ constexpr int num_sums() {
  return Same ? D * (D + 1) / 2 : D * D;
}

// the sum index of output (a, c)
template <int D, bool Same>
__device__ __forceinline__ int sum_index(int a, int c) {
  if constexpr (Same) {
    const int lo = a < c ? a : c, hi = a < c ? c : a;
    return lo * D - lo * (lo - 1) / 2 + (hi - lo);
  } else {
    return a * D + c;
  }
}

// acc[q] += w Re Tr[v_a A v_c A] over the pairs q = (a <= c), row by row
template <int M, int D>
__device__ __forceinline__ void terms_equal(const Herm<M>* v, const Herm<M>& A, double w, double* acc) {
  double2 B[D][M * M];
#pragma unroll
  for (int c = 0; c < D; ++c) herm_product<M>(v[c], A, B[c]);
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      if (c >= a) acc[sum_index<D, true>(a, c)] = fma(w, re_trace<M>(B[a], B[c]), acc[sum_index<D, true>(a, c)]);
    }
  }
}

// acc[a D + c] += Re Tr[v_a A1 v_c A2] (the weight folded into A1)
template <int M, int D>
__device__ __forceinline__ void terms_unequal(const Herm<M>* v, const Herm<M>& A1, const Herm<M>& A2, double* acc) {
#pragma unroll
  for (int c = 0; c < D; ++c) {
    double2 B[M * M];
    herm_product<M>(v[c], A2, B);
    Herm<M> Y;
    herm_part_product<M>(A1, B, Y);
#pragma unroll
    for (int a = 0; a < D; ++a) acc[a * D + c] = herm_dot<M>(Y, v[a], acc[a * D + c]);
  }
}

// points per shared tile: kTileK for m <= 3, else near 16 KB of H, V and w
template <int M, int D>
__host__ __device__ constexpr int tile_k() {
  return M <= 3 ? kTileK : 16384 / (static_cast<int>(sizeof(Herm<M>)) * (1 + D) + 8);
}

template <int M, int D, bool Same>
__global__ void __launch_bounds__(kThreads, kMinBlocks<M>)
sigma_pairs_partials(const double2* __restrict__ H, const double2* __restrict__ V, const double* __restrict__ w,
                     const double2* __restrict__ Z1, const double2* __restrict__ Z2,
                     double* __restrict__ partials, int64_t K, int B) {
  constexpr int MM = M * M;
  constexpr int DD = D * D;
  constexpr int NQ = num_sums<D, Same>();
  constexpr int kTile = tile_k<M, D>();
  constexpr bool kZShared = M <= 3;
  __shared__ Herm<M> hs[kTile];
  __shared__ Herm<M> vs[kTile][D];
  __shared__ double ws[kTile];
  __shared__ double2 zs[kZShared ? kLanes * (Same ? 1 : 2) * MM : 1];
  __shared__ double red[kKWarps - 1][kLanes][NQ];

  const int lane = threadIdx.x % kLanes;
  const int kw = threadIdx.x / kLanes;
  const int bi = blockIdx.x * kLanes + lane;
  const bool live = bi < B;
  const double2* z1;
  const double2* z2;
  if constexpr (kZShared) {
    // the lanes' matrices; a dead lane inverts i I - H, which is never singular
    for (int i = threadIdx.x; i < kLanes * MM; i += kThreads) {
      const int l = i / MM, e = i - l * MM;
      const int b = blockIdx.x * kLanes + l;
      const double2 dead = make_double2(0.0, e % (M + 1) == 0 ? 1.0 : 0.0);
      zs[i] = b < B ? Z1[static_cast<int64_t>(b) * MM + e] : dead;
      if (!Same) zs[kLanes * MM + i] = b < B ? Z2[static_cast<int64_t>(b) * MM + e] : dead;
    }
    z1 = zs + lane * MM;
    z2 = zs + (Same ? 0 : kLanes * MM) + lane * MM;
  } else {  // read through L1; a dead lane repeats the last live one and writes nothing
    const int64_t b = live ? bi : B - 1;
    z1 = Z1 + b * MM;
    z2 = (Same ? Z1 : Z2) + b * MM;
  }

  const int64_t nchunks = (K + kChunkK - 1) / kChunkK;
  for (int64_t c = blockIdx.y; c < nchunks; c += gridDim.y) {
    const int64_t kbeg = c * kChunkK;
    const int64_t kend = K < kbeg + kChunkK ? K : kbeg + kChunkK;
    double acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = 0.0;
    for (int64_t t0 = kbeg; t0 < kend; t0 += kTile) {
      const int nk = static_cast<int>(kend - t0 < kTile ? kend - t0 : kTile);
      __syncthreads();  // the previous tile (and chunk's reduction) is consumed; zs is written
      for (int i = threadIdx.x; i < nk * (1 + D); i += kThreads) {
        const int j = i / (1 + D), u = i - j * (1 + D);
        if (u == 0) {
          pack_hermitian<M>(H + (t0 + j) * MM, hs[j]);
          ws[j] = w[t0 + j];
        } else {
          pack_hermitian<M>(V + ((t0 + j) * D + u - 1) * MM, vs[j][u - 1]);
        }
      }
      __syncthreads();
      for (int j = kw; j < nk; j += kKWarps) {
        if constexpr (Same) {
          Herm<M> A;
          spectral<M>(z1, hs[j], 1.0, A);
          terms_equal<M, D>(vs[j], A, ws[j], acc);
        } else {
          Herm<M> A1, A2;
          spectral<M>(z1, hs[j], ws[j], A1);
          spectral<M>(z2, hs[j], 1.0, A2);
          terms_unequal<M, D>(vs[j], A1, A2, acc);
        }
      }
    }
    if (kw > 0) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) red[kw - 1][lane][q] = acc[q];
    }
    __syncthreads();
    if (kw == 0 && live) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int u = 0; u < kKWarps - 1; ++u) acc[q] += red[u][lane][q];
      }
#pragma unroll
      for (int a = 0; a < D; ++a) {
#pragma unroll
        for (int cc = 0; cc < D; ++cc) partials[(c * B + bi) * DD + a * D + cc] = acc[sum_index<D, Same>(a, cc)];
      }
    }
  }
}

template <int M, int D>
__global__ void sigma_pairs_points_kernel(const double2* __restrict__ H, const double2* __restrict__ V,
                                          const double2* __restrict__ Z, int64_t z_stride,
                                          double* __restrict__ out, int64_t N) {
  constexpr int MM = M * M;
  constexpr int NQ = num_sums<D, true>();
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  double2 z[MM];
#pragma unroll
  for (int i = 0; i < MM; ++i) z[i] = Z[n * z_stride + i];
  Herm<M> h, v[D], A;
  pack_hermitian<M>(H + n * MM, h);
#pragma unroll
  for (int c = 0; c < D; ++c) pack_hermitian<M>(V + (n * D + c) * MM, v[c]);
  spectral<M>(z, h, 1.0, A);
  double acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = 0.0;
  terms_equal<M, D>(v, A, 1.0, acc);
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int c = 0; c < D; ++c) out[n * D * D + a * D + c] = kInvFourPi2 * acc[sum_index<D, true>(a, c)];
  }
}

template <int M, int D>
void launch_sum(bool same, dim3 grid, cudaStream_t st, const double2* H, const double2* V, const double* w,
                const double2* Z1, const double2* Z2, double* partials, int64_t K, int B) {
  if (same) {
    sigma_pairs_partials<M, D, true><<<grid, kThreads, 0, st>>>(H, V, w, Z1, Z2, partials, K, B);
  } else {
    sigma_pairs_partials<M, D, false><<<grid, kThreads, 0, st>>>(H, V, w, Z1, Z2, partials, K, B);
  }
}

template <int M>
void launch_sum_d(int d, bool same, dim3 grid, cudaStream_t st, const double2* H, const double2* V,
                  const double* w, const double2* Z1, const double2* Z2, double* partials, int64_t K, int B) {
  if (d == 1) {
    launch_sum<M, 1>(same, grid, st, H, V, w, Z1, Z2, partials, K, B);
  } else if (d == 2) {
    launch_sum<M, 2>(same, grid, st, H, V, w, Z1, Z2, partials, K, B);
  } else {
    launch_sum<M, 3>(same, grid, st, H, V, w, Z1, Z2, partials, K, B);
  }
}

template <int M>
void launch_points_d(int d, unsigned blocks, cudaStream_t st, const double2* H, const double2* V,
                     const double2* Z, int64_t z_stride, double* out, int64_t N) {
  if (d == 1) {
    sigma_pairs_points_kernel<M, 1><<<blocks, 128, 0, st>>>(H, V, Z, z_stride, out, N);
  } else if (d == 2) {
    sigma_pairs_points_kernel<M, 2><<<blocks, 128, 0, st>>>(H, V, Z, z_stride, out, N);
  } else {
    sigma_pairs_points_kernel<M, 3><<<blocks, 128, 0, st>>>(H, V, Z, z_stride, out, N);
  }
}

}  // namespace

// Rows of the partials scratch: one per k-chunk.
extern "C" long long sigma_pairs_num_chunks(long long K) { return (K + kChunkK - 1) / kChunkK; }

// H: (K, m, m), V: (K, d, m, m) complex128; w: (K,) float64; Z1, Z2: (B,
// m, m) complex128 (same != 0: Z2 is Z1 and is not read); partials:
// (num_chunks(K), B, d, d) float64; out: (B, d, d) float64, scale * sum_k
// w_k Re Tr[v_a A1 v_c A2]. Returns cudaErrorInvalidValue for m outside
// 1..8 or d outside 1..3, else cudaGetLastError() after the launches.
extern "C" int sigma_pairs_sum_launch(const void* H, const void* V, const void* w, const void* Z1, const void* Z2,
                                      int same, void* partials, void* out, long long K, int B, int m, int d,
                                      double scale, void* stream) {
  if (m < 1 || m > autobz::kMaxInverse || d < 1 || d > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nchunks = sigma_pairs_num_chunks(K);
  if (nchunks > 0) {
    const dim3 grid((B + kLanes - 1) / kLanes, static_cast<unsigned>(nchunks < 65535 ? nchunks : 65535));
    const auto* Hp = static_cast<const double2*>(H);
    const auto* Vp = static_cast<const double2*>(V);
    const auto* wp = static_cast<const double*>(w);
    const auto* Z1p = static_cast<const double2*>(Z1);
    const auto* Z2p = static_cast<const double2*>(same ? Z1 : Z2);
    auto* pp = static_cast<double*>(partials);
    const bool sm = same != 0;
    switch (m) {
      case 1: launch_sum_d<1>(d, sm, grid, st, Hp, Vp, wp, Z1p, Z2p, pp, K, B); break;
      case 2: launch_sum_d<2>(d, sm, grid, st, Hp, Vp, wp, Z1p, Z2p, pp, K, B); break;
      case 3: launch_sum_d<3>(d, sm, grid, st, Hp, Vp, wp, Z1p, Z2p, pp, K, B); break;
      case 4: launch_sum_d<4>(d, sm, grid, st, Hp, Vp, wp, Z1p, Z2p, pp, K, B); break;
      case 5: launch_sum_d<5>(d, sm, grid, st, Hp, Vp, wp, Z1p, Z2p, pp, K, B); break;
      case 6: launch_sum_d<6>(d, sm, grid, st, Hp, Vp, wp, Z1p, Z2p, pp, K, B); break;
      case 7: launch_sum_d<7>(d, sm, grid, st, Hp, Vp, wp, Z1p, Z2p, pp, K, B); break;
      default: launch_sum_d<8>(d, sm, grid, st, Hp, Vp, wp, Z1p, Z2p, pp, K, B); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return autobz::column_sum_launch(static_cast<const double*>(partials), static_cast<double*>(out), nchunks,
                                   static_cast<int64_t>(B) * d * d, scale * kInvFourPi2, st);
}

// H: (N, m, m), V: (N, d, m, m) complex128; Z: complex128 with z_stride = m
// * m (one matrix a point) or 0 (one for all); out: (N, d, d) float64.
extern "C" int sigma_pairs_points_launch(const void* H, const void* V, const void* Z, long long z_stride, void* out,
                                         long long N, int m, int d, void* stream) {
  if (m < 1 || m > autobz::kMaxInverse || d < 1 || d > 3 || (z_stride != 0 && z_stride != static_cast<long long>(m) * m))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((N + 127) / 128);
  const auto* Hp = static_cast<const double2*>(H);
  const auto* Vp = static_cast<const double2*>(V);
  const auto* Zp = static_cast<const double2*>(Z);
  auto* op = static_cast<double*>(out);
  switch (m) {
    case 1: launch_points_d<1>(d, blocks, st, Hp, Vp, Zp, z_stride, op, N); break;
    case 2: launch_points_d<2>(d, blocks, st, Hp, Vp, Zp, z_stride, op, N); break;
    case 3: launch_points_d<3>(d, blocks, st, Hp, Vp, Zp, z_stride, op, N); break;
    case 4: launch_points_d<4>(d, blocks, st, Hp, Vp, Zp, z_stride, op, N); break;
    case 5: launch_points_d<5>(d, blocks, st, Hp, Vp, Zp, z_stride, op, N); break;
    case 6: launch_points_d<6>(d, blocks, st, Hp, Vp, Zp, z_stride, op, N); break;
    case 7: launch_points_d<7>(d, blocks, st, Hp, Vp, Zp, z_stride, op, N); break;
    default: launch_points_d<8>(d, blocks, st, Hp, Vp, Zp, z_stride, op, N); break;
  }
  return static_cast<int>(cudaGetLastError());
}
