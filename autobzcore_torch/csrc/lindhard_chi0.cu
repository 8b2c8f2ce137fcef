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
// n, m, w) terms of ~14 operations (an add, an FMA, a reciprocal counted
// as 8, a product and two sums): 3.3e9 operations, 0.097 ms at 34
// TFLOP/s, against 50 MB of e, f and U (0.015 ms). The overlaps cost m^3
// complex multiply-adds a point (216 operations at m = 3) and serve every
// frequency. K26 reads e and f twice and does ~20 operations an element:
// bytes bound it.
//
// The design of K25. A block takes a tile of P points (P from K and m
// alone: up to 2304 / m^2, fewer where K is small, so that a small grid
// still gives the card some 2,048 tiles), and all its threads build the
// tile's m^2 terms (a = |O|^2 df, de) into shared memory, a (point, n) a
// thread, k+q found in 32-bit index arithmetic where the grid allows. Then
// a thread owns kLanesT = 4 frequencies and one of kSubT = 8 substreams of
// the tile's terms (term j goes to substream j mod 8), so a block is sized
// to W (W = 100 takes 25 groups of 8 threads, W = 9 one warp), not to a
// fixed 128 lanes. Per (term, frequency) there is one reciprocal of x^2 +
// eta^2, x = w + de, by rcp.approx and two Newton steps, shared by both
// sums; the four frequencies give four independent chains. The wrapper
// takes |eta| in [1e-150, 1e150] (below it the sum of a / (x^2 + eta^2)
// overflows before the factor -eta), so x^2 + eta^2 leaves the
// reciprocal's range [2^-1021, 2^1022) only where |x| > 2^511: the tile's
// sums are then redone with a correctly rounded division for those terms
// (the same bits for the others). Blocks loop over tiles blockIdx.x, blockIdx.x + gridDim.x, ...;
// gridDim.x depends on K and m alone (frequencies go on blockIdx.y and
// threadIdx), every operation rounds explicitly, and a frequency's partial
// is its 8 substreams met in a fixed butterfly, so a frequency's sum does
// not depend on how many others are asked for. The cross-block sum is
// column_sum.cuh's lane_sum over the partials laid out frequency by
// frequency (2,048 of them at the main path's shape): no atomics,
// bit-identical repeats. K26 is a fixed-order two-pass mean: a partial per
// chunk of kCooperItems (k, n) elements, reduced in a fixed tree, then the
// partials in the same way.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"

namespace {

constexpr int kSubT = 8;          // term substreams of a tile (K25)
constexpr int kLanesT = 4;        // frequencies a thread (K25)
constexpr int kMaxGroups = 32;    // frequency groups a block: 256 threads
constexpr int kTileTerms = 2304;  // (point, n, m) terms per tile at most: 256 points at m = 3
constexpr int kMaxBands = 8;
constexpr int kTiles = 2048;      // tiles K25 aims at, and its most blocks along x
constexpr int kCooperThreads = 256;
constexpr int kCooperItems = 4096;  // (k, n) elements per K26 partial

struct Grid {
  int d, npt, s[3];
};

// C-order index of the point whose grid index on each axis is (i_j + s_j)
// mod npt (k + q), in the index type I (32-bit where npt^d < 2^32)
template <typename I>
__device__ __forceinline__ I shifted(I k, const Grid& g) {
  const I n = static_cast<I>(g.npt);
  I out = 0, stride = 1, rest = k;
  for (int j = g.d - 1; j >= 0; --j) {
    const I q = rest / n;
    I i = rest - q * n + static_cast<I>(g.s[j]);
    if (i >= n) i -= n;
    rest = q;
    out += i * stride;
    stride *= n;
  }
  return out;
}

// the partner -(k+q) of K26: the grid index (-(i_j + s_j)) mod npt on
// each axis
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

// x^2 + eta^2 outside [2^-1021, 2^1022), where the reciprocal's fast form
// does not hold (den >= 0 or NaN, so the high word's exponent bits decide)
__device__ __forceinline__ bool out_of_range(double den) {
  return static_cast<unsigned>(__double2hiint(den)) - 0x00200000u >= 0x7fb00000u;
}

// a / den: by rcp.approx and two Newton steps, or (exact) by a correctly
// rounded division where den is out of range
template <bool kExact>
__device__ __forceinline__ double quotient(double a, double den) {
  if (kExact && out_of_range(den)) return __ddiv_rn(a, den);
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(den));
  r = __fma_rn(r, __fma_rn(-den, r, 1.0), r);
  r = __fma_rn(r, __fma_rn(-den, r, 1.0), r);
  return __dmul_rn(a, r);
}

// re[r] += sum over the thread's terms of a x / (x^2 + eta^2), im[r] += sum
// of a / (x^2 + eta^2), x = om[r] + de; returns whether a den was out of
// range (only the fast form counts them)
template <bool kExact>
__device__ __forceinline__ bool term_sums(const double2* ts, int nt, const double* om, double eta2, double* re,
                                          double* im) {
  unsigned bad = 0;
#pragma unroll 2
  for (int j = threadIdx.x % kSubT; j < nt; j += kSubT) {
    const double2 term = ts[j];
#pragma unroll
    for (int r = 0; r < kLanesT; ++r) {
      const double x = __dadd_rn(om[r], term.y);
      const double den = __fma_rn(x, x, eta2);
      if (!kExact) bad |= out_of_range(den);
      const double t = quotient<kExact>(term.x, den);
      re[r] = __fma_rn(t, x, re[r]);
      im[r] = __dadd_rn(im[r], t);
    }
  }
  return bad != 0;
}

// partials[w, blockIdx.x] = sum over the block's tiles of a / (w + i eta +
// de), for the kLanesT frequencies of each of the block's `groups` groups
// of kSubT threads (frequency group blockIdx.y * groups + threadIdx.x /
// kSubT); P points a tile; nrows = gridDim.x
template <typename I>
__global__ void __launch_bounds__(kMaxGroups * kSubT)
chi0_partials(const double* __restrict__ e, const double* __restrict__ f, const double2* __restrict__ U, Grid g,
              int64_t K, int m, int P, const double* __restrict__ omega, int W, double eta, int groups,
              double2* __restrict__ partials) {
  __shared__ double2 ts[kTileTerms];  // (a, de)
  const int mm = m * m;
  const int gi = threadIdx.x / kSubT;
  const bool worker = gi < groups;
  const int lane0 = (blockIdx.y * groups + gi) * kLanesT;
  const double eta2 = __dmul_rn(eta, eta);
  double om[kLanesT], re[kLanesT], im[kLanesT];
#pragma unroll
  for (int r = 0; r < kLanesT; ++r) {
    om[r] = worker && lane0 + r < W ? omega[lane0 + r] : 0.0;
    re[r] = im[r] = 0.0;
  }
  const int64_t ntiles = (K + P - 1) / P;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t k0 = t * P;
    const int np = static_cast<int>(K - k0 < P ? K - k0 : P);
    __syncthreads();  // the previous tile is consumed
    for (int it = threadIdx.x; it < np * m; it += blockDim.x) {
      const int p = it / m, n = it - p * m;
      const int64_t k = k0 + p;
      const int64_t kq = static_cast<int64_t>(shifted<I>(static_cast<I>(k), g));
      const double2* u = U + k * mm;
      const double2* uq = U + kq * mm;
      double2 un[kMaxBands];  // column n of U(k)
#pragma unroll
      for (int i = 0; i < kMaxBands; ++i) un[i] = i < m ? __ldg(u + i * m + n) : make_double2(0.0, 0.0);
      const double en = __ldg(e + k * m + n), fn = __ldg(f + k * m + n);
      for (int b = 0; b < m; ++b) {
        double ox = 0.0, oy = 0.0;  // <u_n(k)|u_b(k+q)> = sum_i conj(U[i, n]) Uq[i, b]
#pragma unroll
        for (int i = 0; i < kMaxBands; ++i) {
          if (i < m) {
            const double2 y = __ldg(uq + i * m + b);
            ox = __fma_rn(un[i].x, y.x, __fma_rn(un[i].y, y.y, ox));
            oy = __fma_rn(un[i].x, y.y, __fma_rn(-un[i].y, y.x, oy));
          }
        }
        ts[p * mm + n * m + b] = make_double2(__dmul_rn(__fma_rn(ox, ox, __dmul_rn(oy, oy)),
                                                        __dsub_rn(fn, __ldg(f + kq * m + b))),
                                              __dsub_rn(en, __ldg(e + kq * m + b)));
      }
    }
    __syncthreads();
    if (worker) {
      double re0[kLanesT], im0[kLanesT];
#pragma unroll
      for (int r = 0; r < kLanesT; ++r) re0[r] = re[r], im0[r] = im[r];
      if (term_sums<false>(ts, np * mm, om, eta2, re, im)) {
#pragma unroll
        for (int r = 0; r < kLanesT; ++r) re[r] = re0[r], im[r] = im0[r];
        term_sums<true>(ts, np * mm, om, eta2, re, im);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kLanesT; ++r) {
#pragma unroll
    for (int off = kSubT / 2; off > 0; off >>= 1) {
      re[r] = __dadd_rn(re[r], __shfl_xor_sync(0xffffffffu, re[r], off));
      im[r] = __dadd_rn(im[r], __shfl_xor_sync(0xffffffffu, im[r], off));
    }
  }
  if (worker && threadIdx.x % kSubT == 0) {
#pragma unroll
    for (int r = 0; r < kLanesT; ++r) {
      if (lane0 + r < W) {
        partials[static_cast<int64_t>(lane0 + r) * gridDim.x + blockIdx.x] = make_double2(re[r], -eta * im[r]);
      }
    }
  }
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

// Points per K25 tile for K points of m bands: as many as ~kTiles tiles
// need, in multiples of 32, at least 32 and at most kTileTerms / m^2.
long long chi0_tile_points(long long K, int m) {
  const long long most = kTileTerms / (m * m);
  long long p = (K + kTiles - 1) / kTiles;
  p = p < 32 ? 32 : (p + 31) / 32 * 32;
  return p < most ? p : most;
}

// Partials per frequency of K25's scratch for K points of m bands
// (independent of W): its blocks along x.
extern "C" long long chi0_num_blocks(long long K, int m) {
  if (m < 1 || m > kMaxBands) return 0;
  const long long P = chi0_tile_points(K, m);
  const long long tiles = (K + P - 1) / P;
  return tiles < kTiles ? tiles : kTiles;
}

extern "C" int chi0_max_bands() { return kMaxBands; }

// e, f: (npt^d, m) float64; U: (npt^d, m, m) complex128, all in C order of
// the grid; shift: d ints in [0, npt); omega: (W,) float64; partials:
// (W, chi0_num_blocks(K, m)) complex128 scratch; out: (W,) complex128. Returns
// cudaErrorInvalidValue for what it does not take, else cudaGetLastError()
// after each launch.
extern "C" int chi0_launch(const void* e, const void* f, const void* U, int d, int npt, const int* shift, int m,
                           const void* omega, int W, double eta, double scale, void* partials, void* out,
                           void* stream) {
  Grid g;
  if (!make_grid(d, npt, shift, &g) || m < 1 || m > kMaxBands) return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  long long K = 1;
  for (int j = 0; j < d; ++j) K *= npt;
  const long long nb = chi0_num_blocks(K, m);
  const int P = static_cast<int>(chi0_tile_points(K, m));
  // frequency groups of kLanesT, spread evenly over the fewest block rows of
  // at most kMaxGroups groups; a block of groups * kSubT threads in whole warps
  const long long G = (W + kLanesT - 1) / kLanesT;
  const long long rows = (G + kMaxGroups - 1) / kMaxGroups;
  const int groups = static_cast<int>((G + rows - 1) / rows);
  const int threads = (groups * kSubT + 31) / 32 * 32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ep = static_cast<const double*>(e);
  const auto* fp = static_cast<const double*>(f);
  const auto* Up = static_cast<const double2*>(U);
  const auto* op = static_cast<const double*>(omega);
  auto* pp = static_cast<double2*>(partials);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(rows));
  if (nb > 0) {
    if (K <= 0xffffffffLL) {
      chi0_partials<uint32_t><<<grid, threads, 0, st>>>(ep, fp, Up, g, K, m, P, op, W, eta, groups, pp);
    } else {
      chi0_partials<int64_t><<<grid, threads, 0, st>>>(ep, fp, Up, g, K, m, P, op, W, eta, groups, pp);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return autobz::lane_sum_launch(static_cast<const double2*>(partials), static_cast<double2*>(out), nb, W, scale,
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
