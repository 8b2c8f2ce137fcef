// K13: the spectral-grid DOS sums of GGR (box mode) and of adaptive
// Gaussian broadening (Gaussian mode), in FP64.
//
// Replaces autobzcore_tpu/dos/ggr.py:30-75 (_ggr_1d, _ggr_2d, _ggr_3d) with
// the per-energy sum of :303-307, and autobzcore_tpu/dos/tetrahedron.py:325-327
// (the dense Gaussian sum of AdaptiveGaussianBroadening). Over the terms
// t = (k, band) of the spectral grid (energies e (K, m), weights w (K,)) it
// computes, for each energy E_j,
//
//   box:      out[j] = sum_t w_k f_d(b, |E_j - e_t|, sorted |v_t|)
//   Gaussian: out[j] = scale * sum_t w_k norm_t exp(-0.5 ((E_j - e_t) / sigma_t)^2)
//
// with f_d the reference's closed forms of a box-broadened delta in d = 1,
// 2, 3 (velocities v (K, d, m)), in its branch order (dw <= w1, then
// v1 >= v2 + v3; dw <= w2, w3, w4), its _EPS = 1e-300 guards and its gate
// v1 > vtol on the largest |v|. |v| of each term is sorted in registers by a
// min/max network (exact, as K10 sorts its corners).
//
// What bounds it on an H100: in box mode a term is zero outside
// |E - e| <= b (v1 + v2 + v3), so the work the function needs is one support
// test per (energy, term) pair and ~30 FP64 operations per pair inside the
// support; in Gaussian mode every pair costs an exp (~25 operations) and a
// division. At the flagship (1e6 points x 3 bands, 1001 energies) that is
// ~3e9 pairs, so FP64 throughput is the limit; the inputs are 100 MB.
//
// The design is energy_tiles.cuh's tile loop:
// a thread stages one term of a tile, putting its constants in shared
// memory (in box mode the sorted |v|, the branch thresholds w1..w4 and the
// per-term parts of the closed forms, in Gaussian mode e, sigma and norm);
// every term is computed with the plain version's operations, unfused (see
// mul below). Every thread then walks the tile's terms for its kTileLanes
// energy lanes. A term whose support lies outside the thread's energy range
// costs two compares for all its lanes. Rounding is monotone, so
// |E - e| >= fl(e - max E) for every lane: the skip drops only terms that
// each lane would add as exactly 0 (in Gaussian mode, terms whose exp
// underflows: -0.5 t^2 <= -750).

#include <cuda_runtime.h>

#include <cstdint>

#include "energy_tiles.cuh"

namespace {

using autobz::EnergyLanes;
using autobz::kTileLanes;
using autobz::kTileThreads;

constexpr double kEps = 1e-300;      // the reference's _EPS
constexpr double kUnderflow = 1500;  // t^2 above which exp(-0.5 t^2) is 0.0

// Sums of products are written with the rounding intrinsics, which nvcc
// does not fuse into FMAs: each term then rounds as the plain version's
// separate multiplies and adds do. Where a closed form cancels (one |v| at
// rounding level, e.g. at a symmetric k-point), the term's value is made of
// its rounding errors, and only the same operations give the same value.
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

__device__ __forceinline__ void cswap_desc(double& a, double& b) {
  const double hi = fmax(a, b), lo = fmin(a, b);
  a = hi;
  b = lo;
}

// Per-term constants, field-major in shared memory. Box fields by d:
//  d = 1: r = 1 / max(v1, EPS)
//  d = 2: w1, r1 = 2b / max(v1, EPS), d12 = max(v1 v2, EPS)
//  d = 3: w1, w2, w3, caseA, PB = 2 b^2 (v1 v2 + v2 v3 + v3 v1), vvb2 = (vv b)^2,
//         d123, PC = b^2 (v1 v2 + 3 v2 v3 + v3 v1), PC2 = -v1 + v2 + v3,
//         PD = b (v1 + v2), d12, ab = (v1 >= v2 + v3)
// plus e, w and the support half-width wmax (b v1, b (v1 + v2), w4), or
// wmax = -1 for a term the gate v1 > vtol drops. Gaussian fields: sigma, norm.
constexpr int kFields = 16;
enum { F_E, F_W, F_WMAX, F_0 };

template <int D>
__device__ __forceinline__ void box_term(double (&f)[kFields], double e, double w, const double* vk,
                                         int m, double b, double vtol) {
  double v1 = fabs(vk[0]), v2 = D > 1 ? fabs(vk[m]) : 0.0, v3 = D > 2 ? fabs(vk[2 * m]) : 0.0;
  if constexpr (D == 2) cswap_desc(v1, v2);
  if constexpr (D == 3) {
    cswap_desc(v1, v2);
    cswap_desc(v2, v3);
    cswap_desc(v1, v2);
  }
  f[F_E] = e;
  f[F_W] = w;
  if (!(v1 > vtol)) {
    f[F_WMAX] = -1.0;
    return;
  }
  if constexpr (D == 1) {
    f[F_WMAX] = b * v1;
    f[F_0] = 1.0 / fmax(v1, kEps);
  } else if constexpr (D == 2) {
    f[F_WMAX] = b * (v1 + v2);
    f[F_0] = b * fabs(v1 - v2);
    f[F_0 + 1] = 2 * b / fmax(v1, kEps);
    f[F_0 + 2] = fmax(v1 * v2, kEps);
  } else {
    const double vv = sqrt(add(add(mul(v1, v1), mul(v2, v2)), mul(v3, v3)));
    f[F_WMAX] = b * (v1 + v2 + v3);
    f[F_0] = b * fabs(v1 - v2 - v3);
    f[F_0 + 1] = b * (v1 - v2 + v3);
    f[F_0 + 2] = b * (v1 + v2 - v3);
    f[F_0 + 3] = 4 * (b * b) / fmax(v1, kEps);
    f[F_0 + 4] = 2 * (b * b) * add(add(mul(v1, v2), mul(v2, v3)), mul(v3, v1));
    f[F_0 + 5] = (vv * b) * (vv * b);
    f[F_0 + 6] = fmax(v1 * v2 * v3, kEps);
    f[F_0 + 7] = (b * b) * add(add(mul(v1, v2), mul(3 * v2, v3)), mul(v3, v1));
    f[F_0 + 8] = -v1 + v2 + v3;
    f[F_0 + 9] = b * (v1 + v2);
    f[F_0 + 10] = fmax(v1 * v2, kEps);
    f[F_0 + 11] = v1 >= v2 + v3 ? 1.0 : 0.0;
  }
}

// The closed form at dw <= wmax, from the term's fields (s: field stride).
template <int D>
__device__ __forceinline__ double box_value(const double* f, int s, double dw, double b) {
  if constexpr (D == 1) {
    return f[F_0 * s];
  } else if constexpr (D == 2) {
    if (dw <= f[F_0 * s]) return f[(F_0 + 1) * s];
    return (f[F_WMAX * s] - dw) / f[(F_0 + 2) * s];
  } else {
    if (dw <= f[F_0 * s]) {
      if (f[(F_0 + 11) * s] != 0.0) return f[(F_0 + 3) * s];
      return sub(f[(F_0 + 4) * s], add(mul(dw, dw), f[(F_0 + 5) * s])) / f[(F_0 + 6) * s];
    }
    if (dw <= f[(F_0 + 1) * s]) {
      const double lin = mul(mul(b, dw), f[(F_0 + 8) * s]);
      return sub(sub(f[(F_0 + 7) * s], lin), add(mul(dw, dw), f[(F_0 + 5) * s]) / 2) /
             f[(F_0 + 6) * s];
    }
    if (dw <= f[(F_0 + 2) * s]) return 2 * b * (f[(F_0 + 9) * s] - dw) / f[(F_0 + 10) * s];
    const double x = f[F_WMAX * s] - dw;
    return mul(x, x) / (2 * f[(F_0 + 6) * s]);
  }
}

// The tile of K13: terms are the (k, band) pairs of e (K, m). D = 1..3 is
// box mode (a the velocities (K, D, m)), D = 0 Gaussian mode (a the widths
// (K, m), nrm the norms).
template <int D>
struct GgrTile {
  static constexpr int NF = D < 2 ? F_0 + 1 : (D == 2 ? F_0 + 3 : F_0 + 12);
  struct Shared {
    double sf[NF * kTileThreads];
  };
  const double* __restrict__ e;
  const double* __restrict__ a;
  const double* __restrict__ nrm;
  const double* __restrict__ w;
  int m;
  double b, vtol;

  __device__ __forceinline__ void stage(Shared& sh, int64_t p) const {
    const int64_t k = p / m;
    const int band = static_cast<int>(p - k * m);
    double* sf = sh.sf;
    if constexpr (D == 0) {
      sf[F_E * kTileThreads + threadIdx.x] = e[p];
      sf[F_W * kTileThreads + threadIdx.x] = w[k];
      sf[F_WMAX * kTileThreads + threadIdx.x] = a[p];  // sigma
      sf[F_0 * kTileThreads + threadIdx.x] = nrm[p];
    } else {
      double f[kFields] = {};
      box_term<D>(f, e[p], w[k], a + k * D * m + band, m, b, vtol);
#pragma unroll
      for (int i = 0; i < NF; ++i) sf[i * kTileThreads + threadIdx.x] = f[i];
    }
  }

  __device__ __forceinline__ void consume(const Shared& sh, int q, EnergyLanes& ln) const {
    const double* f = sh.sf + q;
    const double et = f[F_E * kTileThreads];
    const double wt = f[F_W * kTileThreads];
    if constexpr (D == 0) {
      const double sig = f[F_WMAX * kTileThreads], nm = f[F_0 * kTileThreads];
      const double dist = et > ln.emax ? et - ln.emax : (ln.emin > et ? ln.emin - et : 0.0);
      const double tq = dist / sig;
      if (tq * tq > kUnderflow) return;
#pragma unroll
      for (int l = 0; l < kTileLanes; ++l) {
        if (l >= ln.nlive) break;
        const double x = (ln.en[l] - et) / sig;
        const double x2 = x * x;
        if (x2 <= kUnderflow) ln.acc[l] = add(ln.acc[l], mul(wt, nm * exp(-0.5 * x2)));
      }
    } else {
      const double wmax = f[F_WMAX * kTileThreads];
      if (!(wmax >= 0.0)) return;  // gated off by v1 <= vtol
      if (et - ln.emax > wmax || ln.emin - et > wmax) return;
#pragma unroll
      for (int l = 0; l < kTileLanes; ++l) {
        if (l >= ln.nlive) break;
        const double dw = fabs(ln.en[l] - et);
        if (dw <= wmax) ln.acc[l] = add(ln.acc[l], mul(wt, box_value<D>(f, kTileThreads, dw, b)));
      }
    }
  }
};

template <int D>
int launch(const double* e, const double* a, const double* nrm, const double* w, int64_t nterms, int m,
           const double* E, int W, double b, double vtol, double scale, double* partials, double* out,
           cudaStream_t st) {
  const GgrTile<D> tile{e, a, nrm, w, m, b, vtol};
  return autobz::energy_tiles_launch(tile, nterms, E, W, scale, partials, out, st);
}

}  // namespace

// Rows of the partials scratch of K13 for nterms terms and W energies
// (energy_tiles.cuh): one per tile, at most kTileMaxBlocks over all the lane
// groups.
extern "C" long long energy_tiles_num_blocks(long long nterms, int W) {
  return autobz::tile_num_blocks(nterms, W);
}

// e: (K, m) float64; w: (K,); E: (W,); partials:
// (energy_tiles_num_blocks(K m, W), W) scratch; out: (W,), written. d = 1..3 is box mode, with a the
// velocities (K, d, m), b the half box width and vtol the gate, nrm unused;
// d = 0 is Gaussian mode, with a the widths sigma (K, m) and nrm the norms
// (K, m). Every output is multiplied by scale. Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for d outside 0..3 or m < 1.
extern "C" int ggr_dos_launch(int d, const void* e, const void* a, const void* nrm, const void* w,
                              long long K, int m, const void* E, int W, double b, double vtol,
                              double scale, void* partials, void* out, void* stream) {
  if (d < 0 || d > 3 || m < 1 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nterms = K * m;
  const auto* ep = static_cast<const double*>(e);
  const auto* ap = static_cast<const double*>(a);
  const auto* np = static_cast<const double*>(nrm);
  const auto* wp = static_cast<const double*>(w);
  const auto* Ep = static_cast<const double*>(E);
  auto* pp = static_cast<double*>(partials);
  auto* op = static_cast<double*>(out);
  switch (d) {
    case 0: return launch<0>(ep, ap, np, wp, nterms, m, Ep, W, b, vtol, scale, pp, op, st);
    case 1: return launch<1>(ep, ap, np, wp, nterms, m, Ep, W, b, vtol, scale, pp, op, st);
    case 2: return launch<2>(ep, ap, np, wp, nterms, m, Ep, W, b, vtol, scale, pp, op, st);
    default: return launch<3>(ep, ap, np, wp, nterms, m, Ep, W, b, vtol, scale, pp, op, st);
  }
}
