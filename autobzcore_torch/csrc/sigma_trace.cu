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
// PTR rule at Z_w = (w + i eta) I: the reference's algorithms/ptr.py:77-83);
//
// for m <= 8 with the inverses of small_inverse.cuh, which take a GENERAL
// complex M (Sigma is not Hermitian, and Z is no multiple of I): the
// reference's closed forms for m <= 3, Gauss-Jordan with partial pivoting
// in place of its `solve` for 4 <= m <= 8.
//
// What bounds it on an H100: at the main path's shape (K = 1e6 points of
// the npt = 100 grid, W = 1000 frequencies, m = 3) the function needs, per
// (w, k) pair, the nine entries of M, the cofactor determinant, the two
// other principal minors and the imaginary part of one quotient, about 131
// FP64 operations: 1.3e11 operations (3.9 ms at 34 TFLOP/s) against a 144
// MB read of H (0.04 ms). The kernel itself takes the trace identity's
// longer route (about 165).
// FP64 arithmetic is the limit; H must not be read once per frequency, and
// the (W, K) matrix of traces must never exist. Above three bands the tiles
// shrink to keep shared memory near 16 KB, and the matrices sit in local
// memory.
//
// The design is K2's (dos_trace.cu), with a matrix Z per lane:
//  * a block covers 32 frequency lanes (one per thread of a warp; each
//    thread keeps its lane's Z in registers) and a chunk of kChunkK
//    k-points; it stages H_k and w_k through shared memory in tiles of
//    kTileK, its four warps taking every fourth k of a tile, all threads of
//    a warp reading the same H_k, which shared memory broadcasts;
//  * the grid's y extent is capped at 65535 and a block row loops over
//    k-chunks, so any K takes one launch;
//  * the cross-block sum is a second pass in chunk order (column_sum.cuh):
//    one partial row per k-chunk, no atomics, so repeats are bit-identical
//    and the sums do not depend on the launch shape;
//  * the pointwise entry runs one thread per point; Z is one matrix per
//    point or one for all (stride 0);
//  * the matrix mode keeps the m^2 complex sums of w_k (G - G^H) per lane
//    in its thread and writes one partial row per (k-chunk, warp), so the
//    fixed-order column sum needs no shared reduction of m^2 entries; A_k
//    is exactly Hermitian by construction, and so is the sum.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"
#include "small_inverse.cuh"

namespace {

using autobz::GeneralInverse;
using autobz::csub;

constexpr int kLanes = 32;     // frequency lanes per block
constexpr int kKWarps = 4;     // warps per block, each over every fourth k
constexpr int kTileK = 128;    // k-points per shared tile for m <= 3
constexpr int kChunkK = 4096;  // k-points per partial row
constexpr int kThreads = kLanes * kKWarps;

// k-points per shared tile: kTileK for m <= 3, else near 16 KB of H
template <int M>
__host__ __device__ constexpr int tile_k() {
  return M <= 3 ? kTileK : 16384 / (16 * M * M);
}

// partials[c, w, j]: j < 1 (trace) or j < M (diagonal)
template <int M, bool Diag>
__global__ void __launch_bounds__(kThreads)
sigma_trace_partials(const double2* __restrict__ H, const double* __restrict__ w,
                     const double2* __restrict__ Z, double* __restrict__ partials, int64_t K, int W) {
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

template <int M>
void launch_partials(bool diag, dim3 grid, cudaStream_t st, const double2* H, const double* w,
                     const double2* Z, double* partials, int64_t K, int W) {
  if (diag) {
    sigma_trace_partials<M, true><<<grid, kThreads, 0, st>>>(H, w, Z, partials, K, W);
  } else {
    sigma_trace_partials<M, false><<<grid, kThreads, 0, st>>>(H, w, Z, partials, K, W);
  }
}

// A(M) entry (a, b) without the 1/(2 pi): (-(Im G_ab + Im G_ba), Re G_ab - Re G_ba)
__device__ __forceinline__ double2 spectral_entry(double2 gab, double2 gba) {
  return make_double2(-(gab.y + gba.y), gab.x - gba.x);
}

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

}  // namespace

// The largest m K27 and K28 take.
extern "C" int sigma_max_bands() { return autobz::kMaxInverse; }

// Rows of the partials scratch: one per k-chunk.
extern "C" long long sigma_trace_num_chunks(long long K) { return (K + kChunkK - 1) / kChunkK; }

// H: (K, m, m) complex128; w: (K,) float64; Z: (W, m, m) complex128;
// partials: (num_chunks(K), W, J) float64 with J = m in the diagonal mode,
// else 1; out: (W, J) float64, factor * sum_k w_k Im(...). Returns
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

// H: (N, m, m) complex128; Z: complex128 with z_stride = m * m (one matrix a
// point) or 0 (one for all); out: (N,) complex128, Tr (Z_n - H_n)^{-1}.
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
    case 1: sigma_trace_points_kernel<1><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N); break;
    case 2: sigma_trace_points_kernel<2><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N); break;
    case 3: sigma_trace_points_kernel<3><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N); break;
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

// H: (K, m, m) complex128; w: (K,) float64; Z: (W, m, m) complex128;
// partials: (num_rows(K), W, m, m) complex128; out: (W, m, m) complex128,
// factor * sum_k w_k (G - G^H) i, the matrix spectral function's weighted
// sum for factor = scale / (2 pi). Returns cudaErrorInvalidValue for m
// outside 1..sigma_max_bands(), else cudaGetLastError() after the launches.
extern "C" int sigma_spectral_sum_launch(const void* H, const void* w, const void* Z, void* partials, void* out,
                                         long long K, int W, int m, double factor, void* stream) {
  if (m < 1 || m > autobz::kMaxInverse) return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nchunks = sigma_trace_num_chunks(K);
  if (nchunks > 0) {
    const dim3 grid((W + kLanes - 1) / kLanes, static_cast<unsigned>(nchunks < 65535 ? nchunks : 65535));
    const auto* Hp = static_cast<const double2*>(H);
    const auto* wp = static_cast<const double*>(w);
    const auto* Zp = static_cast<const double2*>(Z);
    auto* pp = static_cast<double2*>(partials);
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
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return autobz::column_sum_launch(static_cast<const double2*>(partials), static_cast<double2*>(out),
                                   nchunks * kKWarps, static_cast<int64_t>(W) * m * m, factor, st);
}

// H: (N, m, m) complex128; Z: complex128 with z_stride = m * m (one matrix a
// point) or 0 (one for all); out: (N, m, m) complex128, A(Z_n - H_n).
extern "C" int sigma_spectral_points_launch(const void* H, const void* Z, long long z_stride, void* out,
                                            long long N, int m, double inv_2pi, void* stream) {
  if (m < 1 || m > autobz::kMaxInverse || (z_stride != 0 && z_stride != static_cast<long long>(m) * m))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((N + 127) / 128);
  const auto* Hp = static_cast<const double2*>(H);
  const auto* Zp = static_cast<const double2*>(Z);
  auto* op = static_cast<double2*>(out);
  switch (m) {
    case 1: sigma_spectral_points_kernel<1><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    case 2: sigma_spectral_points_kernel<2><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    case 3: sigma_spectral_points_kernel<3><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    case 4: sigma_spectral_points_kernel<4><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    case 5: sigma_spectral_points_kernel<5><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    case 6: sigma_spectral_points_kernel<6><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    case 7: sigma_spectral_points_kernel<7><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
    default: sigma_spectral_points_kernel<8><<<blocks, 128, 0, st>>>(Hp, Zp, z_stride, op, N, inv_2pi); break;
  }
  return static_cast<int>(cudaGetLastError());
}
