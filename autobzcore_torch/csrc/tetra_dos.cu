// K10: the linear tetrahedron method's DOS and integrated DOS N(E), in FP64.
//
// Replaces autobzcore_tpu/dos/tetrahedron.py:47-128 (the closed forms
// _dos_segment, _dos_triangle, _dos_tetrahedron and _nos_*) with the corner
// build of :167-214 that feeds them. For energies E (W,) and the band-major
// eigenvalue grid eg (m, npt^d) of a periodic npt^d grid (C order, axis 0
// slowest) it computes
//
//   out[j] = vol * sum over (cell, simplex, band) f(E_j, sorted corners)
//
// with f the DOS or the N(E) closed form in d = 1, 2, 3. Corner v of cell i
// reads the grid at i + bit_j(v) along each axis j, periodically (the
// reference's jnp.roll(..., -1)); each of the d! simplices of the cell (the
// reference's _SIMPLICES, all sharing the main diagonal 0 -> 2^d - 1) is
// sorted by the reference's min/max exchange network. min and max are exact,
// so the sorted corners equal the reference's bit for bit. The branches
// mirror the reference's masks: _safe, ok/flat, and the half-open tests
// E >= e_i && E < e_{i+1}, so values at corner energies follow the
// one-sided closed form and an energy outside every band gives exactly 0.
//
// What bounds it on an H100: outside its support a (simplex, band) term is a
// constant, so the work the function needs is one support test per term
// and about 30 FP64 operations (a division and a dozen multiply-adds) per
// (energy, term) pair inside the support. At the flagship (npt = 100, m = 3,
// d = 3) that is 1.8e7 terms and, at 1001 energies over the bands, ~1.7e8
// pairs in the support, against a 24 MB read of eg: FP64 throughput is the
// limit, so the (d+1, S, m npt^d) corner tensor of the reference (576 MB at
// npt = 100) is never formed. This kernel tests every term against each
// thread's energy range, so it does 1.8e7 tests per thread row of 8 lanes;
// walking each term's support over the sorted energies would do one.
//
// The design is energy_tiles.cuh's tile loop: a thread stages one (cell,
// band) pair of a tile, reading its 2^d corner values, sorting each of the
// d! simplices and putting them in shared memory; every thread then walks
// the tile's simplices for its kTileLanes energy lanes. A simplex whose
// corners lie outside the thread's energy range costs two compares for all
// its lanes: with one energy (a Fermi-level step) that settles ~99 % of the
// terms; over a sweep each thread's lanes span the window (on an H100,
// lanes of adjacent energies per thread ran 2x slower than interleaved).

#include <cuda_runtime.h>

#include <cstdint>

#include "energy_tiles.cuh"

namespace {

using autobz::EnergyLanes;
using autobz::kTileLanes;
using autobz::kTileThreads;

__host__ __device__ constexpr int num_simplices(int d) { return d == 1 ? 1 : (d == 2 ? 2 : 6); }

// The reference's _SIMPLICES (corner labels, bit j = offset along grid axis
// j): d = 1 (0, 1); d = 2 (0, 1, 3), (0, 2, 3); d = 3 (0, a, b, 7) with
// (a, b) = (1, 3), (1, 5), (2, 3), (2, 6), (4, 5), (4, 6). The loops over s
// and k unroll, so every label folds to a constant and the corners stay in
// registers.
template <int D>
__device__ __forceinline__ constexpr int simplex_vertex(int s, int k) {
  if constexpr (D == 1) {
    return k;
  } else if constexpr (D == 2) {
    return k == 0 ? 0 : (k == 2 ? 3 : (s == 0 ? 1 : 2));
  } else {
    if (k == 0) return 0;
    if (k == 3) return 7;
    if (k == 1) return s < 2 ? 1 : (s < 4 ? 2 : 4);
    return (s == 0 || s == 2) ? 3 : ((s == 1 || s == 4) ? 5 : 6);
  }
}

__device__ __forceinline__ double safe(double x) { return x > 0.0 ? x : 1.0; }

__device__ __forceinline__ void cswap(double& a, double& b) {
  const double lo = fmin(a, b), hi = fmax(a, b);
  a = lo;
  b = hi;
}

// The reference's exchange networks (tetrahedron.py:210-213).
template <int D>
__device__ __forceinline__ void sort_corners(double (&v)[D + 1]) {
  if constexpr (D == 1) {
    cswap(v[0], v[1]);
  } else if constexpr (D == 2) {
    cswap(v[0], v[1]);
    cswap(v[1], v[2]);
    cswap(v[0], v[1]);
  } else {
    cswap(v[0], v[1]);
    cswap(v[2], v[3]);
    cswap(v[0], v[2]);
    cswap(v[1], v[3]);
    cswap(v[1], v[2]);
  }
}

// DOS closed forms: tetrahedron.py:47-82.
__device__ __forceinline__ double dos_term(double E, const double (&e)[2], double tol) {
  const double e1 = e[0], e2 = e[1];
  return (E >= e1 && E < e2 && e2 - e1 > tol) ? 1.0 / safe(e2 - e1) : 0.0;
}

__device__ __forceinline__ double dos_term(double E, const double (&e)[3], double tol) {
  const double e1 = e[0], e2 = e[1], e3 = e[2];
  if (!(E >= e1 && E < e3 && e3 - e1 > tol)) return 0.0;
  const double d31 = safe(e3 - e1);
  if (E < e2) return 2.0 * (E - e1) / (safe(e2 - e1) * d31);
  return 2.0 * (e3 - E) / (safe(e3 - e2) * d31);
}

__device__ __forceinline__ double dos_term(double E, const double (&e)[4], double tol) {
  const double e1 = e[0], e2 = e[1], e3 = e[2], e4 = e[3];
  if (!(E >= e1 && E < e4 && e4 - e1 > tol)) return 0.0;
  const double d31 = safe(e3 - e1), d41 = safe(e4 - e1);
  if (E < e2) {
    const double x = E - e1;
    return 3.0 * (x * x) / (safe(e2 - e1) * d31 * d41);
  }
  const double d42 = safe(e4 - e2);
  if (E < e3) {
    const double x = E - e2;
    return (3.0 * (e2 - e1) + 6.0 * x - 3.0 * ((e3 - e1) + (e4 - e2)) * (x * x) / (safe(e3 - e2) * d42)) /
           (d31 * d41);
  }
  const double x = e4 - E;
  return 3.0 * (x * x) / (d41 * d42 * safe(e4 - e3));
}

// N(E) closed forms: tetrahedron.py:88-124.
__device__ __forceinline__ double nos_term(double E, const double (&e)[2], double tol) {
  const double e1 = e[0], e2 = e[1];
  if (e2 - e1 <= tol) return E >= e1 ? 1.0 : 0.0;
  return fmin(fmax((E - e1) / safe(e2 - e1), 0.0), 1.0);
}

__device__ __forceinline__ double nos_term(double E, const double (&e)[3], double tol) {
  const double e1 = e[0], e2 = e[1], e3 = e[2];
  if (e3 - e1 <= tol) return E >= e1 ? 1.0 : 0.0;
  if (E < e1) return 0.0;
  if (E >= e3) return 1.0;
  const double e31 = safe(e3 - e1);
  if (E < e2) {
    const double x = E - e1;
    return (x * x) / (safe(e2 - e1) * e31);
  }
  const double x = e3 - E;
  return 1.0 - (x * x) / (safe(e3 - e2) * e31);
}

__device__ __forceinline__ double nos_term(double E, const double (&e)[4], double tol) {
  const double e1 = e[0], e2 = e[1], e3 = e[2], e4 = e[3];
  if (e4 - e1 <= tol) return E >= e1 ? 1.0 : 0.0;
  if (E < e1) return 0.0;
  if (E >= e4) return 1.0;
  // the reference's _safe on every difference, e21 included in the middle
  // piece (tetrahedron.py:111, :119)
  const double e21 = safe(e2 - e1), e31 = safe(e3 - e1), e41 = safe(e4 - e1);
  if (E < e2) {
    const double x = E - e1;
    return (x * x * x) / (e21 * e31 * e41);
  }
  const double e42 = safe(e4 - e2);
  if (E < e3) {
    const double x = E - e2;
    return (e21 * e21 + 3.0 * e21 * x + 3.0 * (x * x) -
            ((e3 - e1) + (e4 - e2)) / (safe(e3 - e2) * e42) * (x * x * x)) /
           (e31 * e41);
  }
  const double x = e4 - E;
  return 1.0 - (x * x * x) / (e41 * e42 * safe(e4 - e3));
}

// The tile of K10: terms are (cell, band) pairs of the band-major grid eg
// (m, ncell); each adds f(E, sorted corners) over the cell's simplices.
template <int D, bool kNos>
struct TetraTile {
  static constexpr int S = num_simplices(D);
  static constexpr int NV = D + 1;
  struct Shared {
    double sc[S][NV][kTileThreads];
  };
  const double* __restrict__ eg;
  int64_t ncell;
  int npt;
  double tol;

  __device__ __forceinline__ void stage(Shared& sh, int64_t p) const {
    const int64_t band = p / ncell;
    const int64_t cell = p - band * ncell;
    const double* g = eg + band * ncell;
    // grid coordinates of the cell, axis 0 slowest
    int idx[D];
    int64_t rem = cell;
#pragma unroll
    for (int j = D - 1; j >= 0; --j) {
      idx[j] = static_cast<int>(rem % npt);
      rem /= npt;
    }
    double corner[1 << D];
#pragma unroll
    for (int v = 0; v < (1 << D); ++v) {
      int64_t lin = 0;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        int c = idx[j] + ((v >> j) & 1);
        if (c == npt) c = 0;
        lin = lin * npt + c;
      }
      corner[v] = __ldg(&g[lin]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      double sv[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) sv[k] = corner[simplex_vertex<D>(s, k)];
      sort_corners<D>(sv);
#pragma unroll
      for (int k = 0; k < NV; ++k) sh.sc[s][k][threadIdx.x] = sv[k];
    }
  }

  __device__ __forceinline__ void consume(const Shared& sh, int q, EnergyLanes& ln) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      double e[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) e[k] = sh.sc[s][k][q];
      // a simplex whose corners lie all below or all above the thread's
      // energies gives every lane the closed form's constant there: 0, or
      // N = 1 above (flat simplices included), so two compares settle
      // the lanes; the per-lane sums are the same, term by term
      if (e[0] > ln.emax) continue;
      if (e[NV - 1] <= ln.emin) {
        if constexpr (kNos) {
#pragma unroll
          for (int l = 0; l < kTileLanes; ++l) {
            if (l < ln.nlive) ln.acc[l] += 1.0;
          }
        }
        continue;
      }
#pragma unroll
      for (int l = 0; l < kTileLanes; ++l) {
        if (l >= ln.nlive) break;
        if constexpr (kNos) {
          ln.acc[l] += nos_term(ln.en[l], e, tol);
        } else {
          ln.acc[l] += dos_term(ln.en[l], e, tol);
        }
      }
    }
  }
};

template <int D, bool kNos>
int launch(const double* eg, int64_t ncell, int64_t npairs, int npt, const double* E, int W,
           double tol, double vol, double* partials, double* out, cudaStream_t st) {
  const TetraTile<D, kNos> tile{eg, ncell, npt, tol};
  return autobz::energy_tiles_launch(tile, npairs, E, W, vol, partials, out, st);
}

}  // namespace

// Rows of the partials scratch of K10 and K13 for nterms terms and W
// energies (energy_tiles.cuh): one per tile, at most kTileMaxBlocks over all
// the lane groups.
extern "C" long long energy_tiles_num_blocks(long long nterms, int W) {
  return autobz::tile_num_blocks(nterms, W);
}

// eg: (m, npt^d) float64, band-major; E: (W,); partials:
// (energy_tiles_num_blocks(m npt^d, W), W) scratch; out: (W,), written.
// nos = 0 gives the DOS, 1 the integrated DOS. Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for d outside 1..3 or
// npt < 1.
extern "C" int tetra_dos_launch(const void* eg, long long m, int npt, int d, const void* E, int W,
                                double tol, double vol, int nos, void* partials, void* out,
                                void* stream) {
  if (d < 1 || d > 3 || npt < 1 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long ncell = npt;
  for (int j = 1; j < d; ++j) ncell *= npt;
  const long long npairs = m * ncell;
  const auto* egp = static_cast<const double*>(eg);
  const auto* Ep = static_cast<const double*>(E);
  auto* pp = static_cast<double*>(partials);
  auto* op = static_cast<double*>(out);
  if (d == 1) {
    return nos ? launch<1, true>(egp, ncell, npairs, npt, Ep, W, tol, vol, pp, op, st)
               : launch<1, false>(egp, ncell, npairs, npt, Ep, W, tol, vol, pp, op, st);
  }
  if (d == 2) {
    return nos ? launch<2, true>(egp, ncell, npairs, npt, Ep, W, tol, vol, pp, op, st)
               : launch<2, false>(egp, ncell, npairs, npt, Ep, W, tol, vol, pp, op, st);
  }
  return nos ? launch<3, true>(egp, ncell, npairs, npt, Ep, W, tol, vol, pp, op, st)
             : launch<3, false>(egp, ncell, npairs, npt, Ep, W, tol, vol, pp, op, st);
}
