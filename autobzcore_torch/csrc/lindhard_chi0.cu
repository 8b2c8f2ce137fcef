// K25 and K26: the Lindhard bubble and the Cooper bubble on a full zone
// grid, in FP64.
//
// K25 replaces autobzcore_tpu/models/lindhard.py:78-101
// (LindhardSolver._build_query.query). On the C-order npt^d grid (d <= 3)
// with band energies e (K, m), occupations f = fermi(beta (e - mu)) (K, m)
// and eigenvectors U (K, m, m) (columns), for a grid shift s (q = s / npt)
// it writes, for each frequency w,
//
//   chi0(w) = scale * sum_{k, n, m} |<u_n(k)|u_m(k+q)>|^2 (f_n(k) - f_m(k+q))
//                                 / (w + i eta + e_n(k) - e_m(k+q)),
//
// with k+q found by index arithmetic, (i_j + s_j) mod npt on each axis:
// the reference's roll of (e, U) is never materialized.
//
// K26 replaces autobzcore_tpu/models/lindhard.py:134-150 (cooper_bubble's
// query): the mean over (k, n) of (1 - f1 - f2) / (xi1 + xi2), xi = e - mu,
// with the partner index of the reference's code, (-(i_j + s_j)) mod npt
// on each axis, i.e. -(k+q) (its docstring says -k+q; the two agree only
// where e(k) = e(-k)), and the |den| < 1e-10 limit beta f1 (1 - f1).
//
// What bounds them on an H100: K25's FP64 arithmetic. At the main path's
// shape (K = 64^3 = 262,144 points, m = 3, W = 100) there are 2.36e8 (k,
// n, m, w) terms of ~13 operations (an add, an FMA, a reciprocal counted
// as 8, two FMAs into the sums): 3.1e9 operations, 0.09 ms at 34 TFLOP/s,
// against 50 MB of e, f and U (0.015 ms). The overlaps cost m^3 complex
// multiply-adds a point (216 operations at m = 3) and serve every
// frequency. K26 reads e and f twice and does ~20 operations an element:
// bytes bound it.
//
// The design of K25: the tile loop of K8 and K13 (lorentzian.cuh,
// energy_tiles.cuh). A block takes a tile of points, and its threads build
// the tile's m^2 terms (a = |O|^2 df, de) a point each into shared memory;
// then every thread owns one frequency lane and walks the tile's terms in
// a fixed order, all threads reading the same term, which shared memory
// broadcasts. Blocks loop over tiles blockIdx.x, blockIdx.x + gridDim.x,
// ...; gridDim.x depends on K alone (frequencies go on blockIdx.y), so a
// frequency's sum does not depend on how many others are asked for. The
// cross-block sum is a second pass over the partial rows in block order: no
// atomics, bit-identical repeats. K26 is a fixed-order two-pass mean: a
// partial per chunk of kCooperItems (k, n) elements, reduced in a fixed
// tree, then the partials in the same way.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"

namespace {

constexpr int kThreads = 128;     // frequency lanes per block (K25)
constexpr int kTileTerms = 2304;  // (point, n, m) terms per tile: 256 points at m = 3
constexpr int kMaxBands = 8;
constexpr int kMaxBlocks = 8 * 132;  // tiles in flight: eight blocks per SM
constexpr int kCooperThreads = 256;
constexpr int kCooperItems = 4096;  // (k, n) elements per K26 partial

struct Grid {
  int d, npt, s[3];
};

// C-order index of the point whose grid index on each axis is (sign * i_j
// + s_j) mod npt: sign = 1 gives k + q, sign = -1 with s_j -> -s_j the
// partner -(k+q) (see cooper_partner)
__device__ __forceinline__ int64_t shifted(int64_t k, const Grid& g) {
  int64_t out = 0, stride = 1, rest = k;
  for (int j = g.d - 1; j >= 0; --j) {
    const int i = static_cast<int>(rest % g.npt);
    rest /= g.npt;
    out += static_cast<int64_t>((i + g.s[j]) % g.npt) * stride;
    stride *= g.npt;
  }
  return out;
}

__device__ __forceinline__ int64_t cooper_partner(int64_t k, const Grid& g) {
  int64_t out = 0, stride = 1, rest = k;
  for (int j = g.d - 1; j >= 0; --j) {
    const int i = static_cast<int>(rest % g.npt);
    rest /= g.npt;
    out += static_cast<int64_t>((g.npt - (i + g.s[j]) % g.npt) % g.npt) * stride;
    stride *= g.npt;
  }
  return out;
}

// partials[blockIdx.x, w] = sum over the block's tiles of a / (w + i eta + de)
__global__ void __launch_bounds__(kThreads)
chi0_partials(const double* __restrict__ e, const double* __restrict__ f, const double2* __restrict__ U, Grid g,
              int64_t K, int m, const double* __restrict__ omega, int W, double eta,
              double2* __restrict__ partials) {
  __shared__ double2 ts[kTileTerms];  // (a, de)
  const int mm = m * m;
  const int P = kTileTerms / mm;  // points per tile
  const int wi = blockIdx.y * kThreads + threadIdx.x;
  const double om = wi < W ? omega[wi] : 0.0;
  const double eta2 = eta * eta;
  double re = 0.0, im = 0.0;  // sum a x / |den|^2 and sum a / |den|^2 (times -eta at the end)
  const int64_t ntiles = (K + P - 1) / P;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t k0 = t * P;
    const int np = static_cast<int>(K - k0 < P ? K - k0 : P);
    __syncthreads();  // the previous tile is consumed
    for (int p = threadIdx.x; p < np; p += kThreads) {
      const int64_t k = k0 + p, kq = shifted(k, g);
      const double2* u = U + k * mm;
      const double2* uq = U + kq * mm;
      for (int n = 0; n < m; ++n) {
        const double en = e[k * m + n], fn = f[k * m + n];
        for (int b = 0; b < m; ++b) {
          double ox = 0.0, oy = 0.0;  // <u_n(k)|u_b(k+q)> = sum_i conj(U[i, n]) Uq[i, b]
          for (int i = 0; i < m; ++i) {
            const double2 x = u[i * m + n], y = uq[i * m + b];
            ox += x.x * y.x + x.y * y.y;
            oy += x.x * y.y - x.y * y.x;
          }
          ts[p * mm + n * m + b] = make_double2((ox * ox + oy * oy) * (fn - f[kq * m + b]), en - e[kq * m + b]);
        }
      }
    }
    __syncthreads();
    const int nt = wi < W ? np * mm : 0;  // a dead lane only helps build the tiles
    for (int j = 0; j < nt; ++j) {
      const double2 term = ts[j];
      const double x = om + term.y;
      const double r = term.x / (x * x + eta2);
      re += r * x;
      im += r;
    }
  }
  if (wi < W) partials[static_cast<int64_t>(blockIdx.x) * W + wi] = make_double2(re, -eta * im);
}

__device__ __forceinline__ void tree_sum(double* sh) {
  for (int t = kCooperThreads / 2; t > 0; t >>= 1) {
    if (threadIdx.x < t) sh[threadIdx.x] += sh[threadIdx.x + t];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kCooperThreads)
cooper_partials(const double* __restrict__ e, const double* __restrict__ f, Grid g, int64_t K, int m, double mu,
                double beta, double* __restrict__ partials) {
  __shared__ double sh[kCooperThreads];
  const int64_t n_items = K * m;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kCooperItems;
  const int64_t j1 = n_items - j0 < kCooperItems ? n_items : j0 + kCooperItems;
  double acc = 0.0;
  for (int64_t j = j0 + threadIdx.x; j < j1; j += kCooperThreads) {
    const int64_t k = j / m;
    const int n = static_cast<int>(j - k * m);
    const int64_t p = cooper_partner(k, g) * m + n;
    const double xi1 = e[j] - mu, xi2 = e[p] - mu;
    const double f1 = f[j], f2 = f[p];
    const double den = xi1 + xi2;
    acc += fabs(den) < 1e-10 ? beta * f1 * (1.0 - f1) : (1.0 - f1 - f2) / den;
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  tree_sum(sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = sh[0];
}

__global__ void __launch_bounds__(kCooperThreads)
cooper_reduce(const double* __restrict__ partials, int64_t nparts, double count, double* __restrict__ out) {
  __shared__ double sh[kCooperThreads];
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < nparts; i += kCooperThreads) s += partials[i];
  sh[threadIdx.x] = s;
  __syncthreads();
  tree_sum(sh);
  if (threadIdx.x == 0) out[0] = sh[0] / count;  // the mean, as jnp.mean divides
}

bool make_grid(int d, int npt, const int* shift, Grid* g) {
  if (d < 1 || d > 3 || npt < 1) return false;
  g->d = d;
  g->npt = npt;
  for (int j = 0; j < 3; ++j) {
    g->s[j] = j < d ? shift[j] : 0;
    if (g->s[j] < 0 || g->s[j] >= npt) return false;
  }
  return true;
}

}  // namespace

// Rows of K25's partials scratch for K points of m bands (independent of W).
extern "C" long long chi0_num_blocks(long long K, int m) {
  if (m < 1 || m > kMaxBands) return 0;
  const long long P = kTileTerms / (m * m);
  const long long tiles = (K + P - 1) / P;
  return tiles < kMaxBlocks ? tiles : kMaxBlocks;
}

extern "C" int chi0_max_bands() { return kMaxBands; }

// e, f: (npt^d, m) float64; U: (npt^d, m, m) complex128, all in C order of
// the grid; shift: d ints in [0, npt); omega: (W,) float64; partials:
// (chi0_num_blocks(K, m), W) complex128 scratch; out: (W,) complex128.
// Returns cudaErrorInvalidValue for what it does not take, else
// cudaGetLastError() after each launch.
extern "C" int chi0_launch(const void* e, const void* f, const void* U, int d, int npt, const int* shift, int m,
                           const void* omega, int W, double eta, double scale, void* partials, void* out,
                           void* stream) {
  Grid g;
  if (!make_grid(d, npt, shift, &g) || m < 1 || m > kMaxBands) return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  long long K = 1;
  for (int j = 0; j < d; ++j) K *= npt;
  const long long nb = chi0_num_blocks(K, m);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>((W + kThreads - 1) / kThreads));
  chi0_partials<<<grid, kThreads, 0, st>>>(static_cast<const double*>(e), static_cast<const double*>(f),
                                           static_cast<const double2*>(U), g, K, m,
                                           static_cast<const double*>(omega), W, eta,
                                           static_cast<double2*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return autobz::column_sum_launch(static_cast<const double2*>(partials), static_cast<double2*>(out), nb, W, scale,
                                   st);
}

// Rows of K26's partials scratch for K points of m bands.
extern "C" long long cooper_num_chunks(long long K, int m) { return (K * m + kCooperItems - 1) / kCooperItems; }

// e, f: (npt^d, m) float64 in C order of the grid; shift: d ints in [0,
// npt); partials: (cooper_num_chunks(K, m),) float64; out: one float64, the
// mean over (k, n). Returns cudaErrorInvalidValue for what it does not
// take, else cudaGetLastError() after each launch.
extern "C" int cooper_launch(const void* e, const void* f, int d, int npt, const int* shift, int m, double mu,
                             double beta, void* partials, void* out, void* stream) {
  Grid g;
  if (!make_grid(d, npt, shift, &g) || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long K = 1;
  for (int j = 0; j < d; ++j) K *= npt;
  const long long nparts = cooper_num_chunks(K, m);
  if (nparts > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cooper_partials<<<static_cast<unsigned>(nparts), kCooperThreads, 0, st>>>(
      static_cast<const double*>(e), static_cast<const double*>(f), g, K, m, mu, beta,
      static_cast<double*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cooper_reduce<<<1, kCooperThreads, 0, st>>>(static_cast<const double*>(partials), nparts,
                                              static_cast<double>(K * m), static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
