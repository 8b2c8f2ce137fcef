// K24: the occupation-weighted zone average of the Berry family, in FP64.
//
// Replaces autobzcore_tpu/models/berry.py:462-470 (_cart_average's
// jnp.mean of einsum("km,kmab->kab", w, F)) with the band weights of
// :487-490 (ahc), :505-507 (anomalous_nernst), :521-525
// (berry_curvature_dipole, a (d, d, d) result), :606-610 (operator_hall)
// and :627-634 (orbital_magnetization), and chern()'s per-band mean at
// :478. For energies e (K, m) and a field F (K, m, C) it writes the zone
// mean
//
//   X[j] = (1 / K) sum_k sum_n w(e[k, n]) F[k, n, j]            (C columns),
//   X[a, j] = (1 / K) sum_k sum_n w(e[k, n]) vd[k, n, a] F[k, n, j]
//                                                 (dipole, d C columns),
//   X[n, j] = (1 / K) sum_k F[k, n, j]                     (per band, m C),
//
// with x = beta (e - mu) and the weight w a mode: 0 the step (e < mu); 1
// the Fermi function 1 / (1 + e^x); 2 the entropy softplus(x) - x
// sigmoid(x), softplus(x) = max(x, 0) + log1p(e^-|x|) (the reference's
// logaddexp(x, 0), exact at every x); 3 -df/de = beta f (1 - f), times
// vd_a; 4 the grand potential softplus(-x) / beta, or max(mu - e, 0) at
// beta = inf; 5 one, per band. The B^-T X B^-1 and |det B| / (2 pi)^d tail
// stays on the host in float64, as in the reference.
//
// What bounds it on an H100: the bytes. The Weyl 3-D AHC reads e and Om at
// 7,077,888 points (16 + 144 B a point, 1.13 GB: 0.34 ms at 3.35 TB/s)
// against a weight (~40 FP64 operations at most) and 2 per term.
//
// The design: a fixed-order two-pass sum. A block of 256 threads takes a
// chunk of kPoints points and a tile of up to 256 output columns: thread
// (lane l, column j) sums points l, l + L, ... of the chunk in order, over
// all bands, then the block adds its L lanes of each column in lane order
// into one partial row. A second pass, one block per column, adds the
// partial rows in a fixed tree. No atomics, so repeats are bit-identical.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 1024;  // points per partial row

enum Mode { kStep = 0, kFermi = 1, kEntropy = 2, kDipole = 3, kGrand = 4, kBand = 5 };

__device__ __forceinline__ double softplus(double x) { return fmax(x, 0.0) + log1p(exp(-fabs(x))); }

__device__ __forceinline__ double weight(int mode, double e, double mu, double beta) {
  switch (mode) {
    case kStep:
      return e < mu ? 1.0 : 0.0;
    case kFermi:
      return 1.0 / (1.0 + exp(beta * (e - mu)));
    case kEntropy: {
      const double x = beta * (e - mu);
      return softplus(x) - x * (1.0 / (1.0 + exp(-x)));
    }
    case kDipole: {
      const double f = 1.0 / (1.0 + exp(beta * (e - mu)));
      return beta * f * (1.0 - f);
    }
    case kGrand:
      return isinf(beta) ? fmax(mu - e, 0.0) : softplus(-(beta * (e - mu))) / beta;
    default:
      return 1.0;
  }
}

// Columns J of the result; a tile of jt of them per block (blockIdx.y).
__global__ void __launch_bounds__(kThreads)
zone_average_partial(const double* __restrict__ e, const double* __restrict__ F, const double* __restrict__ vd,
                     int64_t K, int m, int C, int d, int J, int jt, int mode, double mu, double beta,
                     double* __restrict__ partials) {
  __shared__ double sh[kThreads];
  const int L = kThreads / jt;  // point lanes
  const int lane = threadIdx.x / jt, jc = threadIdx.x - (threadIdx.x / jt) * jt;
  const int j = blockIdx.y * jt + jc;
  const bool live = lane < L && j < J;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kPoints;
  const int64_t k1 = K - k0 < kPoints ? K : k0 + kPoints;
  double acc = 0.0;
  if (live) {
    if (mode == kBand) {
      const int n = j / C, c = j - (j / C) * C;
      for (int64_t k = k0 + lane; k < k1; k += L) acc += __ldg(F + (k * m + n) * C + c);
    } else {
      const int a = mode == kDipole ? j / C : 0;
      const int c = mode == kDipole ? j - a * C : j;
      for (int64_t k = k0 + lane; k < k1; k += L) {
        for (int n = 0; n < m; ++n) {
          double w = weight(mode, __ldg(e + k * m + n), mu, beta);
          if (mode == kDipole) w *= __ldg(vd + (k * m + n) * d + a);
          acc += w * __ldg(F + (k * m + n) * C + c);
        }
      }
    }
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < jt && j < J) {
    double s = 0.0;
    for (int l = 0; l < L; ++l) s += sh[l * jt + jc];
    partials[static_cast<int64_t>(blockIdx.x) * J + j] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
zone_average_reduce(const double* __restrict__ partials, int64_t nparts, int J, double nk, double* __restrict__ out) {
  __shared__ double sh[kThreads];
  const int j = blockIdx.x;
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < nparts; i += kThreads) s += partials[i * J + j];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int t = kThreads / 2; t > 0; t >>= 1) {
    if (threadIdx.x < t) sh[threadIdx.x] += sh[threadIdx.x + t];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = sh[0] / nk;  // the mean, as jnp.mean divides
}

int columns(int mode, int m, int C, int d) { return mode == kBand ? m * C : (mode == kDipole ? d * C : C); }

}  // namespace

// Rows of the partials scratch for K points (each row holds every column).
extern "C" long long zone_average_num_chunks(long long K) { return (K + kPoints - 1) / kPoints; }

// e: (K, m) float64; F: (K, m, C) float64; vd: (K, m, d) float64 in the
// dipole mode (else unread; d is then unread too); partials:
// (zone_average_num_chunks(K), J) float64 scratch, J the result's columns;
// out: (J,) float64, written: (C,), (d, C) in the dipole mode, (m, C) per
// band. beta = inf takes the grand potential's zero-temperature form.
// Returns cudaErrorInvalidValue for a mode or shape it does not take, else
// cudaGetLastError() after each launch.
extern "C" int zone_average_launch(const void* e, const void* F, const void* vd, long long K, int m, int C, int d,
                                   int mode, double mu, double beta, void* partials, void* out, void* stream) {
  if (mode < kStep || mode > kBand || K < 1 || m < 1 || C < 1 || (mode == kDipole && (d < 1 || vd == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int J = columns(mode, m, C, d);
  const int jt = J < kThreads ? J : kThreads;
  const long long nparts = zone_average_num_chunks(K);
  if (nparts > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nparts), static_cast<unsigned>((J + jt - 1) / jt));
  zone_average_partial<<<grid, kThreads, 0, st>>>(static_cast<const double*>(e), static_cast<const double*>(F),
                                                  static_cast<const double*>(vd), static_cast<int64_t>(K), m, C, d, J,
                                                  jt, mode, mu, beta, static_cast<double*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  zone_average_reduce<<<static_cast<unsigned>(J), kThreads, 0, st>>>(static_cast<const double*>(partials), nparts, J,
                                                                     static_cast<double>(K),
                                                                     static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
