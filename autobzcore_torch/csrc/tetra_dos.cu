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
// The design (the shape of lorentzian.cuh's tile loop):
//  * a block of kThreads threads loads a tile of kThreads (cell, band) pairs,
//    one per thread; the thread reads its 2^d corner values, sorts each of
//    the d! simplices and puts them in shared memory;
//  * each thread owns kLanes energy lanes, kThreads apart (blockIdx.y
//    picks the block's kThreads * kLanes lanes), and walks the tile's
//    simplices in a fixed order, every thread reading the same simplex (a
//    shared-memory broadcast). A simplex whose corners lie outside the
//    thread's energy range costs two compares for all its lanes: with one
//    energy (a Fermi-level step) that settles ~99 % of the terms; over a
//    sweep each thread's lanes span the window, and interleaving keeps a
//    warp's threads on neighbouring energies, so they branch alike (on an
//    H100, lanes of adjacent energies per thread ran 2x slower);
//  * a block loops over tiles blockIdx.x, blockIdx.x + gridDim.x, ..., so
//    the partials (one row of W per block) stay bounded;
//  * blocks run in no order, so the cross-block sum is a second pass that
//    adds each lane's partials in block order and scales by vol. No atomics:
//    repeated runs are bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;          // threads per block = pairs per tile
constexpr int kLanes = 8;              // energy lanes per thread
constexpr int kMaxBlocks = 8 * 132;    // tiles in flight: eight blocks per SM

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

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

// partials[blockIdx.x, j] = sum over the block's tiles of sum over their
// (pair, simplex) of f(E_j, sorted corners).
template <int D, bool kNos>
__global__ void __launch_bounds__(kThreads)
tetra_partials_kernel(const double* __restrict__ eg, int64_t npairs, int npt,
                      const double* __restrict__ E, int W, double tol,
                      double* __restrict__ partials) {
  constexpr int S = num_simplices(D);
  constexpr int NV = D + 1;
  __shared__ double sc[S][NV][kThreads];
  int64_t ncell = npt;
#pragma unroll
  for (int j = 1; j < D; ++j) ncell *= npt;
  // this thread's energies: lane l holds energy lane0 + l * kThreads (the
  // block's lanes interleave, so a warp's threads see similar energies and
  // branch alike); nlive of them are real, spanning [emin, emax]
  const int lane0 = blockIdx.y * (kThreads * kLanes) + threadIdx.x;
  const int nlive = lane0 < W ? (W - lane0 + kThreads - 1) / kThreads : 0;
  double en[kLanes], acc[kLanes];
  double emin = __longlong_as_double(0x7ff0000000000000LL), emax = -emin;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    en[l] = l < nlive ? E[lane0 + l * kThreads] : 0.0;
    acc[l] = 0.0;
    if (l < nlive) {
      emin = fmin(emin, en[l]);
      emax = fmax(emax, en[l]);
    }
  }
  const int64_t ntiles = (npairs + kThreads - 1) / kThreads;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t p = t * kThreads + threadIdx.x;
    __syncthreads();  // the previous tile is consumed
    if (p < npairs) {
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
        for (int k = 0; k < NV; ++k) sc[s][k][threadIdx.x] = sv[k];
      }
    }
    __syncthreads();
    const int64_t left = npairs - t * kThreads;
    const int nt = static_cast<int>(left < kThreads ? left : kThreads);
    for (int q = 0; nlive > 0 && q < nt; ++q) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        double e[NV];
#pragma unroll
        for (int k = 0; k < NV; ++k) e[k] = sc[s][k][q];
        // a simplex whose corners lie all below or all above the thread's
        // energies gives every lane the closed form's constant there: 0, or
        // N = 1 above (flat simplices included), so two compares settle
        // the lanes; the per-lane sums are the same, term by term
        if (e[0] > emax) continue;
        if (e[NV - 1] <= emin) {
          if constexpr (kNos) {
#pragma unroll
            for (int l = 0; l < kLanes; ++l) {
              if (l < nlive) acc[l] += 1.0;
            }
          }
          continue;
        }
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          if (l >= nlive) break;
          if constexpr (kNos) {
            acc[l] += nos_term(en[l], e, tol);
          } else {
            acc[l] += dos_term(en[l], e, tol);
          }
        }
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    if (l < nlive) partials[static_cast<int64_t>(blockIdx.x) * W + lane0 + l * kThreads] = acc[l];
  }
}

// out[j] = vol * sum_g partials[g, j], in block order.
__global__ void tetra_reduce_kernel(const double* __restrict__ partials, double* __restrict__ out,
                                    int nblocks, int W, double vol) {
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= W) return;
  double s = 0.0;
  for (int g = 0; g < nblocks; ++g) s += partials[static_cast<int64_t>(g) * W + wi];
  out[wi] = vol * s;
}

template <int D, bool kNos>
void launch_partials(dim3 grid, cudaStream_t st, const double* eg, int64_t npairs, int npt,
                     const double* E, int W, double tol, double* partials) {
  tetra_partials_kernel<D, kNos><<<grid, kThreads, 0, st>>>(eg, npairs, npt, E, W, tol, partials);
}

}  // namespace

// Rows of the partials scratch for npairs (cell, band) pairs and W energies:
// one per tile, at most kMaxBlocks over all the lane groups.
extern "C" long long tetra_num_blocks(long long npairs, int W) {
  const long long groups = ceil_div(W, kThreads * kLanes);
  long long g = kMaxBlocks / (groups > 0 ? groups : 1);
  const long long tiles = ceil_div(npairs, kThreads);
  if (g > tiles) g = tiles;
  return g > 0 ? g : 1;
}

// eg: (m, npt^d) float64, band-major; E: (W,); partials:
// (tetra_num_blocks(m npt^d, W), W) scratch; out: (W,), written. nos = 0
// gives the DOS, 1 the integrated DOS. Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for d outside 1..3 or npt < 1.
extern "C" int tetra_dos_launch(const void* eg, long long m, int npt, int d, const void* E, int W,
                                double tol, double vol, int nos, void* partials, void* out,
                                void* stream) {
  if (d < 1 || d > 3 || npt < 1 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  long long ncell = npt;
  for (int j = 1; j < d; ++j) ncell *= npt;
  const long long npairs = m * ncell;
  const long long groups = ceil_div(W, kThreads * kLanes);
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long g = tetra_num_blocks(npairs, W);
  const auto* egp = static_cast<const double*>(eg);
  const auto* Ep = static_cast<const double*>(E);
  auto* pp = static_cast<double*>(partials);
  if (npairs > 0) {
    const dim3 grid(static_cast<unsigned>(g), static_cast<unsigned>(groups));
    if (d == 1) {
      nos ? launch_partials<1, true>(grid, st, egp, npairs, npt, Ep, W, tol, pp)
          : launch_partials<1, false>(grid, st, egp, npairs, npt, Ep, W, tol, pp);
    } else if (d == 2) {
      nos ? launch_partials<2, true>(grid, st, egp, npairs, npt, Ep, W, tol, pp)
          : launch_partials<2, false>(grid, st, egp, npairs, npt, Ep, W, tol, pp);
    } else {
      nos ? launch_partials<3, true>(grid, st, egp, npairs, npt, Ep, W, tol, pp)
          : launch_partials<3, false>(grid, st, egp, npairs, npt, Ep, W, tol, pp);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tetra_reduce_kernel<<<static_cast<unsigned>(ceil_div(W, 128)), 128, 0, st>>>(
      pp, static_cast<double*>(out), npairs > 0 ? static_cast<int>(g) : 0, W, vol);
  return static_cast<int>(cudaGetLastError());
}
