// K19: the Lorentzian-pair transport contraction, in FP64.
//
// Replaces autobzcore_tpu/models/observables.py:379-383 (TransportSolver's
// chunk: the spectral functions at each frequency, their pair products and
// the (C, K m^2) x (K m^2, d^2) product by Wmat) and
// autobzcore_tpu/models/transport.py:160-181 (KineticCoefficientSolver's
// integrand, the same at the node pair (w, w + Omega)). For B node pairs b
// it computes
//
//   G[b, c] = scale * sum_k sum_{n, q} A(y1_b - e[k, n]; g1_b)
//                                      A(y2_b - e[k, q]; g2_b) Wmat[(k, n, q), c],
//   A(x; g) = g / (x * x + g * g) / pi,
//
// with y = w - Re Sigma(w) and g = -Im Sigma(w) at each node (0 and eta
// without a self-energy), which is the reference's expression in both cases.
//
// What bounds it on an H100: FP64 arithmetic. Per (node pair, k) the
// function needs 2m Lorentzians (m at equal frequencies), each one
// reciprocal and a few multiplies and adds (1/pi folds into the width), the
// m^2 pair products, and the 2 m^2 d^2 operations of the contraction by
// Wmat, a real FP64 matrix product that the tensor cores run at 67 TFLOP/s.
// At m = 3, d = 3 and the flagship's 216,000 points that is about 1.0 ms for
// a 960-pair GK trip, against 140 MB of Wmat read per pass (0.04 ms). The
// (B, K m^2) matrix of pair products, 15.5 MB a node there, must never
// exist.
//
// The design:
//  * a block takes a tile of kTile = 32 kNodes node pairs and a chunk of
//    kChunk points; each of its four warps walks a quarter of the chunk, and
//    each lane owns kNodes pairs of the tile (strided by 32), keeping their
//    d^2 sums in registers, so every value of Wmat a thread reads serves
//    kNodes pairs and all lanes of a warp read the same point at a time (a
//    broadcast through the L1 cache);
//  * the four warps' sums are added in shared memory in warp order, and the
//    block writes one partial row per pair for its chunk; blockIdx.y walks
//    the chunks (grid-stride past the grid's limit), and a second pass adds
//    each pair's partials in chunk order and multiplies by scale. The chunks
//    do not depend on the number of pairs, so a pair's value does not depend
//    on the other pairs of its launch, and with no atomics repeated runs are
//    bit-identical;
//  * at equal frequencies (the caller's `same`: the wrapper passes it when
//    the two node vectors are the same tensors, as in TransportSolver) each
//    Lorentzian is computed once;
//  * each Lorentzian is the reference's sequence of IEEE operations (x * x,
//    + g * g, two correctly rounded divisions), never contracted into an FMA,
//    so the kernel's spectral functions are bit-equal to the plain version's
//    and only the order of the final sum differs; the second division costs
//    time that a bound counting one reciprocal does not.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kNodes = 4;               // node pairs per lane
constexpr int kTile = 32 * kNodes;      // node pairs per block
constexpr int kChunk = 512;             // points per partial row
constexpr int kSub = kChunk / kWarps;   // points per warp
constexpr int kMaxBands = 64;      // the runtime-m path's local arrays
constexpr int kMaxGridY = 65535;
constexpr double kPi = 3.141592653589793;

__device__ __forceinline__ double lorentz(double y, double e, double g, double gg) {
  const double x = __dsub_rn(y, e);
  return __ddiv_rn(__ddiv_rn(g, __dadd_rn(__dmul_rn(x, x), gg)), kPi);
}

// The terms of point k for a thread's node pairs: acc[j][c] += A1 A2 W over
// the m^2 band pairs. MB > 0: m is MB, every loop unrolled and the spectral
// functions in registers; MB = 0: m is runtime (<= kMaxBands), loops rolled.
template <int MB, int DD>
__device__ __forceinline__ void point_terms(const double* __restrict__ e, const double* __restrict__ W,
                                            int64_t k, int m, const double (&py1)[kNodes],
                                            const double (&pg1)[kNodes], const double (&pgg1)[kNodes],
                                            const double (&py2)[kNodes], const double (&pg2)[kNodes],
                                            const double (&pgg2)[kNodes], bool same,
                                            double (&acc)[kNodes][DD]) {
  const double* ek = e + k * m;
  if constexpr (MB > 0) {
    double a2[kNodes][MB];
#pragma unroll
    for (int q = 0; q < MB; ++q) {
      const double eq = __ldg(ek + q);
#pragma unroll
      for (int j = 0; j < kNodes; ++j) a2[j][q] = lorentz(py2[j], eq, pg2[j], pgg2[j]);
    }
#pragma unroll
    for (int n = 0; n < MB; ++n) {
      double a1[kNodes];
      if (same) {
#pragma unroll
        for (int j = 0; j < kNodes; ++j) a1[j] = a2[j][n];
      } else {
        const double en = __ldg(ek + n);
#pragma unroll
        for (int j = 0; j < kNodes; ++j) a1[j] = lorentz(py1[j], en, pg1[j], pgg1[j]);
      }
      const double* Wn = W + (k * MB + n) * MB * DD;
#pragma unroll
      for (int q = 0; q < MB; ++q) {
        double p[kNodes];
#pragma unroll
        for (int j = 0; j < kNodes; ++j) p[j] = __dmul_rn(a1[j], a2[j][q]);
#pragma unroll
        for (int c = 0; c < DD; ++c) {
          const double wv = __ldg(Wn + q * DD + c);
#pragma unroll
          for (int j = 0; j < kNodes; ++j) acc[j][c] = fma(p[j], wv, acc[j][c]);
        }
      }
    }
  } else {
    double a2[kNodes][kMaxBands];
#pragma unroll 1
    for (int q = 0; q < m; ++q) {
      const double eq = __ldg(ek + q);
#pragma unroll
      for (int j = 0; j < kNodes; ++j) a2[j][q] = lorentz(py2[j], eq, pg2[j], pgg2[j]);
    }
#pragma unroll 1
    for (int n = 0; n < m; ++n) {
      double a1[kNodes];
      if (same) {
#pragma unroll
        for (int j = 0; j < kNodes; ++j) a1[j] = a2[j][n];
      } else {
        const double en = __ldg(ek + n);
#pragma unroll
        for (int j = 0; j < kNodes; ++j) a1[j] = lorentz(py1[j], en, pg1[j], pgg1[j]);
      }
      const double* Wn = W + (k * m + n) * static_cast<int64_t>(m) * DD;
#pragma unroll 1
      for (int q = 0; q < m; ++q) {
        double p[kNodes];
#pragma unroll
        for (int j = 0; j < kNodes; ++j) p[j] = __dmul_rn(a1[j], a2[j][q]);
#pragma unroll
        for (int c = 0; c < DD; ++c) {
          const double wv = __ldg(Wn + q * DD + c);
#pragma unroll
          for (int j = 0; j < kNodes; ++j) acc[j][c] = fma(p[j], wv, acc[j][c]);
        }
      }
    }
  }
}

// partials[(chunk, b, c)] for the chunks blockIdx.y, blockIdx.y + gridDim.y,
// ... M > 0: m is M; M = 0: m is runtime (<= kMaxBands). DD = d^2.
template <int M, int DD>
__global__ void __launch_bounds__(kThreads)
transport_gamma_partial(const double* __restrict__ e, const double* __restrict__ W, int64_t K,
                        int m_rt, const double* __restrict__ y1, const double* __restrict__ g1,
                        const double* __restrict__ y2, const double* __restrict__ g2, int B,
                        int64_t nchunks, int same, double* __restrict__ partials) {
  __shared__ double sacc[kTile * DD];
  const int m = M > 0 ? M : m_rt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile0 = blockIdx.x * kTile;
  double py1[kNodes], pg1[kNodes], pgg1[kNodes], py2[kNodes], pg2[kNodes], pgg2[kNodes];
#pragma unroll
  for (int j = 0; j < kNodes; ++j) {
    const int b = tile0 + lane + 32 * j;
    const bool live = b < B;
    py1[j] = live ? y1[b] : 0.0;
    pg1[j] = live ? g1[b] : 1.0;
    py2[j] = live ? y2[b] : 0.0;
    pg2[j] = live ? g2[b] : 1.0;
    pgg1[j] = __dmul_rn(pg1[j], pg1[j]);
    pgg2[j] = __dmul_rn(pg2[j], pg2[j]);
  }
  const int nt = B - tile0 < kTile ? B - tile0 : kTile;  // live pairs of the tile
  for (int64_t ch = blockIdx.y; ch < nchunks; ch += gridDim.y) {
    double acc[kNodes][DD];
#pragma unroll
    for (int j = 0; j < kNodes; ++j)
#pragma unroll
      for (int c = 0; c < DD; ++c) acc[j][c] = 0.0;
    const int64_t k0 = ch * kChunk + warp * kSub;
    const int64_t k1 = k0 + kSub < K ? k0 + kSub : K;
    for (int64_t k = k0; k < k1; ++k)
      point_terms<M, DD>(e, W, k, m, py1, pg1, pgg1, py2, pg2, pgg2, same != 0, acc);
    // the warps' sums, added in warp order
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w) {
#pragma unroll
        for (int j = 0; j < kNodes; ++j)
#pragma unroll
          for (int c = 0; c < DD; ++c) {
            double* slot = sacc + (lane + 32 * j) * DD + c;
            *slot = w == 0 ? acc[j][c] : __dadd_rn(*slot, acc[j][c]);
          }
      }
      __syncthreads();
    }
    double* out = partials + (ch * B + tile0) * DD;
    for (int i = threadIdx.x; i < nt * DD; i += kThreads) out[i] = sacc[i];
    __syncthreads();  // sacc is reused by the next chunk
  }
}

template <int M, int DD>
void launch_partial(dim3 grid, cudaStream_t st, const double* e, const double* W, int64_t K, int m,
                    const double* y1, const double* g1, const double* y2, const double* g2, int B,
                    int64_t nchunks, int same, double* partials) {
  transport_gamma_partial<M, DD><<<grid, kThreads, 0, st>>>(e, W, K, m, y1, g1, y2, g2, B, nchunks, same,
                                                            partials);
}

template <int DD>
void dispatch_m(dim3 grid, cudaStream_t st, const double* e, const double* W, int64_t K, int m,
                const double* y1, const double* g1, const double* y2, const double* g2, int B,
                int64_t nchunks, int same, double* partials) {
  switch (m) {
    case 1: launch_partial<1, DD>(grid, st, e, W, K, m, y1, g1, y2, g2, B, nchunks, same, partials); break;
    case 2: launch_partial<2, DD>(grid, st, e, W, K, m, y1, g1, y2, g2, B, nchunks, same, partials); break;
    case 3: launch_partial<3, DD>(grid, st, e, W, K, m, y1, g1, y2, g2, B, nchunks, same, partials); break;
    default: launch_partial<0, DD>(grid, st, e, W, K, m, y1, g1, y2, g2, B, nchunks, same, partials);
  }
}

}  // namespace

// Rows of the partials scratch for K points: one per chunk of kChunk.
extern "C" long long transport_gamma_num_chunks(long long K) { return (K + kChunk - 1) / kChunk; }

// The largest band count K19 takes.
extern "C" int transport_gamma_max_bands() { return kMaxBands; }

// e: (K, m) float64; W: (K m^2, d^2) float64; y1, g1, y2, g2: (B,) float64;
// same: nonzero when y2 and g2 are y1 and g1 (one Lorentzian per (node,
// band)); partials: (transport_gamma_num_chunks(K), B, d^2) scratch; out:
// (B, d^2) float64, written. Returns cudaErrorInvalidValue for d outside
// 1..3 or m outside 1..transport_gamma_max_bands(), else cudaGetLastError()
// after each launch.
extern "C" int transport_gamma_launch(const void* e, const void* W, long long K, int m, int d,
                                      const void* y1, const void* g1, const void* y2, const void* g2,
                                      long long B, int same, double scale, void* partials,
                                      void* out, void* stream) {
  if (d < 1 || d > 3 || m < 1 || m > kMaxBands || B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nchunks = transport_gamma_num_chunks(K);
  const int64_t n = B * d * d;
  if (nchunks > 0) {
    const dim3 grid(static_cast<unsigned>((B + kTile - 1) / kTile),
                    static_cast<unsigned>(nchunks < kMaxGridY ? nchunks : kMaxGridY));
    const double* ep = static_cast<const double*>(e);
    const double* Wp = static_cast<const double*>(W);
    const double* a = static_cast<const double*>(y1);
    const double* b = static_cast<const double*>(g1);
    const double* c = static_cast<const double*>(y2);
    const double* dd = static_cast<const double*>(g2);
    double* pp = static_cast<double*>(partials);
    const int Bi = static_cast<int>(B);
    switch (d) {
      case 1: dispatch_m<1>(grid, st, ep, Wp, K, m, a, b, c, dd, Bi, nchunks, same, pp); break;
      case 2: dispatch_m<4>(grid, st, ep, Wp, K, m, a, b, c, dd, Bi, nchunks, same, pp); break;
      default: dispatch_m<9>(grid, st, ep, Wp, K, m, a, b, c, dd, Bi, nchunks, same, pp);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return autobz::column_sum_launch(static_cast<const double*>(partials), static_cast<double*>(out), nchunks, n,
                                   scale, st);
}
