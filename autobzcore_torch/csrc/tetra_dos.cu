// K10: the linear tetrahedron method's DOS and integrated DOS N(E), in FP64.
//
// Replaces autobzcore_tpu/dos/tetrahedron.py:47-128 (the closed forms
// _dos_segment, _dos_triangle, _dos_tetrahedron and _nos_*) with the corner
// build of :167-214 that feeds them. For energies E (W,), sorted ascending,
// and the band-major eigenvalue grid eg (m, npt^d) of a periodic npt^d grid
// (C order, axis 0 slowest) it computes
//
//   out[j] = vol * sum over (cell, simplex, band) f(E_j, sorted corners)
//
// with f the DOS or the N(E) closed form in d = 1, 2, 3. Corner v of cell i
// reads the grid at i + bit_j(v) along each axis j, periodically (the
// reference's jnp.roll(..., -1)); each of the d! simplices of the cell (the
// reference's _SIMPLICES, all sharing the main diagonal 0 -> 2^d - 1) is
// sorted by the reference's min/max exchange network. min and max are exact,
// so the sorted corners equal the reference's bit for bit. The closed forms
// mirror the reference's masks: _safe, ok/flat, and the half-open tests
// E >= e_1 && E < e_top, so values at corner energies follow the one-sided
// closed form and an energy outside every band gives exactly 0. (The caller
// sorts E; tetrahedron.py's tetra_dos sorts a copy and puts the values
// back.)
//
// What bounds it on an H100: outside its support [e_1, e_top) a (simplex,
// band) term is a constant (0 for the DOS; for N(E) 0 below and 1 at and
// above its step, which is e_top, or e_1 for a flat simplex), so the work
// the function needs is one support test per term and about 30 FP64
// operations (a division and a dozen multiply-adds) per (energy, term) pair
// inside the support. At the flagship (npt = 100, m = 3, d = 3) that is
// 1.8e7 terms and, at 1001 energies over the bands, ~1.7e8 pairs in the
// support, against a 24 MB read of eg: FP64 throughput is the limit, so the
// (d+1, S, m npt^d) corner tensor of the reference (576 MB at npt = 100) is
// never formed.
//
// The design: a term reaches only the energies of its support. A block of
// 128 threads owns a chunk of up to kChunkE sorted energies (blockIdx.y) and
// walks tiles of 128 cells of one band (blockIdx.x, + gridDim.x, ...); a
// tile is a brick of cells (4 x 4 x 8, 8 x 16, 128), so its energies are
// close and its range of energies narrow. Per tile:
//  * the brick's grid points (5 x 5 x 9 at d = 3) are read once into shared
//    memory with their rank in the chunk's energies (a binary search: the
//    first energy >= the value);
//  * a thread takes one cell: its 2^d corners from shared memory, each
//    simplex sorted, and the simplex's support in energy indices from its
//    corners' ranks (the rank is monotone, so the support [lo, hi) is the
//    least and the largest rank of its corners). A flat simplex has no
//    support. For N(E) the step of each simplex goes to an integer
//    histogram over the chunk's energies (counts are exact in any order);
//  * the (simplex, energy) pairs of the supports are numbered in simplex
//    order (a block scan of the threads' counts) and their closed forms
//    computed in rounds of kPairs: each thread writes the simplex of each of
//    its own pairs, then a thread takes a pair, so the lanes of a warp all
//    evaluate;
//  * over the tile's range of energies, in blocks of 32, a warp's lanes own
//    the block's energies and each warp adds, simplex by simplex, a quarter
//    of the round's simplices: the values of the supports that hold its
//    lanes' energies. The quarters go in warp order into the block's sum
//    for each energy in shared memory.
// At the end, a block's N(E) adds the prefix sums of its histogram, and it
// writes one partial row over its chunk; the cross-block sum is a second
// pass in block order (column_sum.cuh). With at most kFewE energies (a
// Fermi-level step has one) a thread takes a (cell, band) term instead,
// tests each simplex against the energies in its registers, and a block's
// sums are a fixed tree. No atomics on floating-point values: repeats are
// bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"

namespace {

constexpr int kThreads = 128;           // threads per block = cells per tile
constexpr int kWarps = kThreads / 32;
constexpr int kChunkE = 512;            // sorted energies per block row
constexpr int kPairs = 1024;            // (simplex, energy) pairs a round
constexpr int kFewE = 4;                // at most this many energies go term by term
constexpr int kMaxBlocks = 8 * 132;     // blocks over all the energy chunks
constexpr unsigned kFull = 0xffffffffu;

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

// Cell extents of a tile's brick along each axis (axis 0 slowest), 128
// cells, and its grid points (the brick and its far faces).
template <int D>
struct Brick {
  __host__ __device__ static constexpr int ext(int j) { return D == 1 ? 128 : (D == 2 ? (j == 0 ? 8 : 16) : (j < 2 ? 4 : 8)); }
  __host__ __device__ static constexpr int pts(int j) { return j < D ? ext(j) + 1 : 1; }
  static constexpr int NP = pts(0) * pts(1) * pts(2);
};

// the first of n sorted energies e[0..n) that is >= x, or n
__device__ __forceinline__ int rank_of(const double* e, int n, double x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (e[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

template <int D, bool kNos>
struct Shared {
  static constexpr int S = num_simplices(D);
  static constexpr int NV = D + 1;
  static constexpr int NQ = S * kThreads;
  double acc[kChunkE];                // the block's sums over the chunk's energies
  unsigned long long steps[kNos ? kChunkE : 1];  // N(E): steps per energy
  double pv[Brick<D>::NP];            // the brick's grid values
  int pr[Brick<D>::NP];               // and their ranks
  double sc[NV][NQ];                  // the tile's sorted simplices, q = cell thread * S + s
  int2 sup[NQ];                       // their supports [lo, hi); (0, 0) when empty
  int off[NQ + 1];                    // their first pairs (in q order), the pair count last
  double val[kPairs];                 // a round's closed forms, pair by pair
  unsigned short qidx[kPairs];        // and their simplices
  double red[kWarps][32];
  unsigned long long wsum[kWarps];
  int lo, hi;                         // the tile's range
};

template <int D, bool kNos>
__global__ void __launch_bounds__(kThreads)
tetra_partials_kernel(const double* __restrict__ eg, int npt, int64_t m, const double* __restrict__ E, int W,
                      double tol, double* __restrict__ partials) {
  using B = Brick<D>;
  using Sh = Shared<D, kNos>;
  constexpr int S = Sh::S;
  constexpr int NV = Sh::NV;
  constexpr int NQ = Sh::NQ;
  extern __shared__ __align__(16) unsigned char smem[];
  Sh& sh = *reinterpret_cast<Sh*>(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int J0 = blockIdx.y * kChunkE;
  const int nE = W - J0 < kChunkE ? W - J0 : kChunkE;
  const double* en = E + J0;  // the chunk's energies, read through L1
  for (int j = tid; j < kChunkE; j += kThreads) {
    sh.acc[j] = 0.0;
    if (kNos) sh.steps[j] = 0;
  }
  int nb[3];  // bricks per axis
#pragma unroll
  for (int j = 0; j < 3; ++j) nb[j] = j < D ? (npt + B::ext(j) - 1) / B::ext(j) : 1;
  int64_t ncell = 1;
#pragma unroll
  for (int j = 0; j < D; ++j) ncell *= npt;
  const int64_t nbricks = static_cast<int64_t>(nb[0]) * nb[1] * nb[2];
  const int64_t ntiles = m * nbricks;
  // this thread's cell in a brick, axis D - 1 fastest
  int loc[3] = {0, 0, 0};
  {
    int r = tid;
#pragma unroll
    for (int j = D - 1; j >= 0; --j) {
      loc[j] = r % B::ext(j);
      r /= B::ext(j);
    }
  }

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t band = t / nbricks;
    int64_t rem = t - band * nbricks;
    int org[3];  // the brick's first cell
#pragma unroll
    for (int j = 2; j >= 0; --j) {
      org[j] = static_cast<int>(rem % nb[j]) * B::ext(j);
      rem /= nb[j];
    }
    const double* g = eg + band * ncell;
    __syncthreads();  // the previous tile is consumed
    if (tid == 0) {
      sh.lo = kChunkE;
      sh.hi = 0;
    }
    for (int p = tid; p < B::NP; p += kThreads) {
      int r = p;
      int64_t lin = 0;
      int c[3];
#pragma unroll
      for (int j = 2; j >= 0; --j) {
        c[j] = r % B::pts(j);
        r /= B::pts(j);
      }
#pragma unroll
      for (int j = 0; j < D; ++j) lin = lin * npt + (org[j] + c[j]) % npt;
      const double x = __ldg(&g[lin]);
      sh.pv[p] = x;
      sh.pr[p] = rank_of(en, nE, x);
    }
    __syncthreads();

    // this thread's cell: its simplices, their supports, pair counts and steps
    bool inside = true;
#pragma unroll
    for (int j = 0; j < D; ++j) inside = inside && org[j] + loc[j] < npt;
    unsigned tlo = kChunkE, thi = 0;
    double corner[1 << D];
    int crank[1 << D];
#pragma unroll
    for (int v = 0; v < (1 << D); ++v) {
      int p = 0;
#pragma unroll
      for (int j = 0; j < D; ++j) p = p * B::pts(j) + loc[j] + ((v >> j) & 1);
      corner[v] = sh.pv[p];
      crank[v] = sh.pr[p];
    }
    int first[S], npair[S], count = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int q = tid * S + s;
      double sv[NV];
      int lo = kChunkE, hi = 0;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = simplex_vertex<D>(s, k);
        sv[k] = corner[v];
        lo = min(lo, crank[v]);
        hi = max(hi, crank[v]);
      }
      sort_corners<D>(sv);
#pragma unroll
      for (int k = 0; k < NV; ++k) sh.sc[k][q] = sv[k];
      const bool flat = !(sv[NV - 1] - sv[0] > tol);
      const bool live = inside && !flat && lo < hi;
      sh.sup[q] = live ? make_int2(lo, hi) : make_int2(0, 0);
      first[s] = count;
      npair[s] = live ? hi - lo : 0;
      if (live) {
        count += hi - lo;
        tlo = min(tlo, static_cast<unsigned>(lo));
        thi = max(thi, static_cast<unsigned>(hi));
      }
      if constexpr (kNos) {
        // N(E) steps to 1 at e_top (at e_1 when flat): count it at that rank
        const unsigned key = inside ? static_cast<unsigned>(flat ? lo : hi) : static_cast<unsigned>(kChunkE);
        const unsigned peers = __match_any_sync(kFull, key);
        if (key < static_cast<unsigned>(nE) && lane == __ffs(peers) - 1)
          atomicAdd(&sh.steps[key], static_cast<unsigned long long>(__popc(peers)));
      }
    }
    tlo = __reduce_min_sync(kFull, tlo);
    thi = __reduce_max_sync(kFull, thi);
    if (lane == 0 && tlo < thi) {
      atomicMin(&sh.lo, static_cast<int>(tlo));
      atomicMax(&sh.hi, static_cast<int>(thi));
    }
    // the pairs' offsets in q order: an exclusive scan of the threads' counts
    unsigned long long incl = static_cast<unsigned long long>(count);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) sh.wsum[warp] = incl;
    __syncthreads();
    int base = static_cast<int>(incl) - count;
    for (int w = 0; w < warp; ++w) base += static_cast<int>(sh.wsum[w]);
#pragma unroll
    for (int s = 0; s < S; ++s) sh.off[tid * S + s] = base + first[s];
    if (tid == kThreads - 1) sh.off[NQ] = base + count;
    __syncthreads();

    // the closed forms in rounds of kPairs pairs: each thread writes the
    // simplex of its own pairs, then a pair a thread; then, over the tile's
    // range in blocks of 32 energies, each warp adds a quarter of the round's
    // simplices for its lanes' energies, and the quarters go in warp order
    const int npairs = sh.off[NQ], rlo = sh.lo, rhi = sh.hi;
    for (int r0 = 0; r0 < npairs; r0 += kPairs) {
      const int np = npairs - r0 < kPairs ? npairs - r0 : kPairs;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int o = base + first[s];
        const int p0 = o > r0 ? o : r0, p1 = o + npair[s] < r0 + np ? o + npair[s] : r0 + np;
        for (int p = p0; p < p1; ++p) sh.qidx[p - r0] = static_cast<unsigned short>(tid * S + s);
      }
      __syncthreads();
      for (int i = tid; i < np; i += kThreads) {
        const int q = sh.qidx[i];
        const int j = sh.sup[q].x + (r0 + i - sh.off[q]);
        double e[NV];
#pragma unroll
        for (int k = 0; k < NV; ++k) e[k] = sh.sc[k][q];
        const double En = __ldg(&en[j]);
        sh.val[i] = kNos ? nos_term(En, e, tol) : dos_term(En, e, tol);
      }
      __syncthreads();
      const int qa = sh.qidx[0], qb = sh.qidx[np - 1] + 1;
      const int qs = qa + (qb - qa) * warp / kWarps, qe = qa + (qb - qa) * (warp + 1) / kWarps;
      for (int b = rlo; b < rhi; b += 32) {
        const int j = b + lane;
        double a = 0.0;
        for (int q = qs; q < qe; ++q) {
          const int2 sp = sh.sup[q];
          if (sp.y <= b || sp.x >= b + 32) continue;  // the warp's energies miss this support
          const int p = sh.off[q] + (j - sp.x) - r0;
          if (j >= sp.x && j < sp.y && p >= 0 && p < np) a += sh.val[p];
        }
        sh.red[warp][lane] = a;
        __syncthreads();
        if (warp == 0 && j < rhi) {
          double r = sh.red[0][lane];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) r += sh.red[w][lane];
          sh.acc[j] += r;
        }
        __syncthreads();
      }
    }
  }

  __syncthreads();
  if constexpr (kNos) {
    // the steps at or below each energy: a prefix sum over the chunk, in
    // runs of kChunkE / kThreads energies a thread
    constexpr int R = kChunkE / kThreads;
    unsigned long long run = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) run += sh.steps[tid * R + i];
    unsigned long long incl = run;  // inclusive scan of the runs over the block
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) sh.wsum[warp] = incl;
    __syncthreads();
    unsigned long long before = incl - run;
    for (int w = 0; w < warp; ++w) before += sh.wsum[w];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      before += sh.steps[tid * R + i];
      const int j = tid * R + i;
      if (j < nE) partials[static_cast<int64_t>(blockIdx.x) * W + J0 + j] = sh.acc[j] + static_cast<double>(before);
    }
  } else {
    for (int j = tid; j < nE; j += kThreads) partials[static_cast<int64_t>(blockIdx.x) * W + J0 + j] = sh.acc[j];
  }
}

// A few energies (W <= kFewE, a Fermi-level step's one): a thread per
// (cell, band) term, grid-stride, reads its corners, sorts its simplices
// and tests each against the energies held in registers; a block's sums are
// a fixed tree over its threads.
template <int D, bool kNos>
__global__ void __launch_bounds__(kThreads)
tetra_few_kernel(const double* __restrict__ eg, int npt, int64_t m, const double* __restrict__ E, int W, double tol,
                 double* __restrict__ partials) {
  constexpr int S = num_simplices(D);
  constexpr int NV = D + 1;
  __shared__ double red[kFewE][kThreads];
  const int tid = threadIdx.x;
  double en[kFewE], acc[kFewE];
#pragma unroll
  for (int w = 0; w < kFewE; ++w) {
    en[w] = w < W ? E[w] : 0.0;
    acc[w] = 0.0;
  }
  int64_t ncell = 1;
#pragma unroll
  for (int j = 0; j < D; ++j) ncell *= npt;
  const int64_t nterms = m * ncell;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + tid; p < nterms;
       p += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t band = p / ncell;
    int64_t rem = p - band * ncell;
    int idx[D];  // grid coordinates of the cell, axis 0 slowest
#pragma unroll
    for (int j = D - 1; j >= 0; --j) {
      idx[j] = static_cast<int>(rem % npt);
      rem /= npt;
    }
    const double* g = eg + band * ncell;
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
      for (int w = 0; w < kFewE; ++w) {
        if (w < W) acc[w] += kNos ? nos_term(en[w], sv, tol) : dos_term(en[w], sv, tol);
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kFewE; ++w) red[w][tid] = acc[w];
  for (int st = kThreads / 2; st > 0; st >>= 1) {
    __syncthreads();
    if (tid < st) {
#pragma unroll
      for (int w = 0; w < kFewE; ++w) red[w][tid] += red[w][tid + st];
    }
  }
  __syncthreads();
  if (tid < W) partials[static_cast<int64_t>(blockIdx.x) * W + tid] = red[tid][0];
}

int64_t num_tiles(int64_t m, int npt, int d) {
  int64_t tiles = m;
  for (int j = 0; j < d; ++j) {
    const int e = d == 1 ? Brick<1>::ext(j) : (d == 2 ? Brick<2>::ext(j) : Brick<3>::ext(j));
    tiles *= (npt + e - 1) / e;
  }
  return tiles;
}

// Blocks along x for W energies, one partial row each: for W <= kFewE at
// most kMaxBlocks over the terms, else at most kMaxBlocks over the energy
// chunks and one a tile.
int64_t num_blocks(int64_t m, int npt, int d, int W) {
  int64_t g;
  if (W <= kFewE) {
    int64_t nterms = m;
    for (int j = 0; j < d; ++j) nterms *= npt;
    g = (nterms + kThreads - 1) / kThreads;
    if (g > kMaxBlocks) g = kMaxBlocks;
  } else {
    g = kMaxBlocks / ((static_cast<int64_t>(W) + kChunkE - 1) / kChunkE);
    const int64_t tiles = num_tiles(m, npt, d);
    if (g > tiles) g = tiles;
  }
  return g > 0 ? g : 1;
}

template <int D, bool kNos>
int launch(const double* eg, int npt, int64_t m, const double* E, int W, double tol, double vol,
           double* partials, double* out, cudaStream_t st) {
  const int64_t g = num_blocks(m, npt, D, W);
  if (m > 0 && W <= kFewE) {
    tetra_few_kernel<D, kNos><<<static_cast<unsigned>(g), kThreads, 0, st>>>(eg, npt, m, E, W, tol, partials);
  } else if (m > 0) {
    const int64_t chunks = (static_cast<int64_t>(W) + kChunkE - 1) / kChunkE;
    if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
    constexpr int smem = static_cast<int>(sizeof(Shared<D, kNos>));
    cudaFuncSetAttribute(tetra_partials_kernel<D, kNos>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    tetra_partials_kernel<D, kNos><<<dim3(static_cast<unsigned>(g), static_cast<unsigned>(chunks)), kThreads, smem,
                                     st>>>(eg, npt, m, E, W, tol, partials);
  }
  if (m > 0) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return autobz::column_sum_launch(partials, out, m > 0 ? g : 0, W, vol, st);
}

}  // namespace

// Rows of the partials scratch of K10 for m bands on an npt^d grid and W
// energies: one per block, at most kMaxBlocks over the energy chunks.
extern "C" long long tetra_dos_num_blocks(long long m, int npt, int d, int W) { return num_blocks(m, npt, d, W); }

// eg: (m, npt^d) float64, band-major; E: (W,), sorted ascending; partials:
// (tetra_dos_num_blocks(m, npt, d, W), W) scratch; out: (W,), written.
// nos = 0 gives the DOS, 1 the integrated DOS. Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for d outside 1..3, npt < 1
// or m < 0.
extern "C" int tetra_dos_launch(const void* eg, long long m, int npt, int d, const void* E, int W,
                                double tol, double vol, int nos, void* partials, void* out,
                                void* stream) {
  if (d < 1 || d > 3 || npt < 1 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* egp = static_cast<const double*>(eg);
  const auto* Ep = static_cast<const double*>(E);
  auto* pp = static_cast<double*>(partials);
  auto* op = static_cast<double*>(out);
  if (d == 1) {
    return nos ? launch<1, true>(egp, npt, m, Ep, W, tol, vol, pp, op, st)
               : launch<1, false>(egp, npt, m, Ep, W, tol, vol, pp, op, st);
  }
  if (d == 2) {
    return nos ? launch<2, true>(egp, npt, m, Ep, W, tol, vol, pp, op, st)
               : launch<2, false>(egp, npt, m, Ep, W, tol, vol, pp, op, st);
  }
  return nos ? launch<3, true>(egp, npt, m, Ep, W, tol, vol, pp, op, st)
             : launch<3, false>(egp, npt, m, Ep, W, tol, vol, pp, op, st);
}
