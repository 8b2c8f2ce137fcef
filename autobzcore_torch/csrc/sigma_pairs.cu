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
// with A_i = (G_i - G_i^H) / (-2 pi i), G_i = (Z_i - H_k)^{-1} by
// small_inverse.cuh (the adjugate over the determinant for m <= 3,
// Gauss-Jordan for 4 <= m <= 8), v_a = dH/dz_a (d <= 3). When Z2 is Z1 (equal frequencies) the inverse is taken once.
// The kernel works with A' = 2 pi A = i (G - G^H) and folds 1 / (4 pi^2)
// into the final scale.
//
// What bounds it on an H100: FP64 arithmetic. Per (pair, k) at m = d = 3
// the function needs one spectral function (about 230 operations with M and
// the Hermitian A), the products v_c A (405) and, the trace being symmetric
// in (a, c) at equal frequencies, 6 of the 9 traces of m^2 real parts (228
// with the sums): about 860 operations at equal frequencies, 1,610 at
// unequal ones (two spectral functions, v_a A1 and v_c A2, all 9 traces).
// At the main path's 256 equal frequencies over K = 1e6 points that is
// 2.2e11 (6.5 ms at 34 TFLOP/s) against a 576 MB read of H and V (0.17 ms).
// The kernel itself forms all nine traces and the full A.
//
// The design: K2's tile loop. A block covers 32 pair lanes (one per thread
// of a warp) and a chunk of kChunkK points; it stages H_k, V_k and w_k
// through shared memory in tiles of kTileK points, the four warps taking
// every fourth point of a tile, all threads of a warp reading the same
// point, which shared memory broadcasts. For m <= 3 the lanes' Z matrices
// sit in shared memory too (registers go to A1, the d products v_c A2 and
// the d^2 sums); above, the tiles shrink to keep shared memory near 16 KB,
// each thread reads its lane's Z through L1, and the products are loops over
// local memory. The cross-block sum is a second pass in chunk order
// (column_sum.cuh), one partial row per k-chunk: no atomics, repeats are
// bit-identical, and the sums do not depend on the launch shape. The
// pointwise entry runs one thread per point.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"
#include "small_inverse.cuh"

namespace {

using autobz::cmul;
using autobz::csub;
using autobz::GeneralInverse;

constexpr int kLanes = 32;     // pair lanes per block
constexpr int kKWarps = 4;     // warps per block, each over every fourth k
constexpr int kTileK = 32;     // points per shared tile for m <= 3
constexpr int kChunkK = 2048;  // points per partial row
constexpr int kThreads = kLanes * kKWarps;
constexpr double kInvFourPi2 = 0.025330295910584444;  // 1 / (4 pi^2)

// points per shared tile: kTileK for m <= 3, else near 16 KB of H and V
template <int M, int D>
__host__ __device__ constexpr int tile_k() {
  return M <= 3 ? kTileK : 16384 / (16 * (1 + D) * M * M);
}

// A' = i (G - G^H) of M = z - h
template <int M>
__device__ __forceinline__ void spectral(const double2* z, const double2* h, double2* A) {
  constexpr int MM = M * M;
  double2 a[MM], g[MM];
#pragma unroll
  for (int i = 0; i < MM; ++i) a[i] = csub(z[i], h[i]);
  GeneralInverse<M>::inverse(a, g);
#pragma unroll
  for (int j = 0; j < M; ++j) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const double2 x = g[j * M + k], y = g[k * M + j];  // D = x - conj(y); i D
      A[j * M + k] = make_double2(-(x.y + y.y), x.x - y.x);
    }
  }
}

// pair_terms for 4 <= M <= kMaxInverse: the same sums, loops not unrolled
template <int M, int D, bool Same>
__device__ void pair_terms_loop(const double2* v, const double2* A1, const double2* A2, double wk, double* acc) {
  constexpr int MM = M * M;
  double2 vA2[D * MM];               // (v_c A2)[k, i]
  double2 vA1[Same ? 1 : D * MM];    // (v_a A1)[i, k]
#pragma unroll 1
  for (int c = 0; c < D; ++c) {
#pragma unroll 1
    for (int k = 0; k < M; ++k) {
#pragma unroll 1
      for (int i = 0; i < M; ++i) {
        double2 s = make_double2(0.0, 0.0), u = make_double2(0.0, 0.0);
#pragma unroll 1
        for (int l = 0; l < M; ++l) {
          s = autobz::cadd(s, cmul(v[c * MM + k * M + l], A2[l * M + i]));
          if (!Same) u = autobz::cadd(u, cmul(v[c * MM + k * M + l], A1[l * M + i]));
        }
        vA2[c * MM + k * M + i] = s;
        if (!Same) vA1[c * MM + k * M + i] = u;
      }
    }
  }
  const double2* vA = Same ? vA2 : vA1;
#pragma unroll 1
  for (int a = 0; a < D; ++a) {
#pragma unroll 1
    for (int i = 0; i < M; ++i) {
#pragma unroll 1
      for (int c = 0; c < D; ++c) {
        double t = 0.0;
#pragma unroll 1
        for (int k = 0; k < M; ++k) {
          const double2 r = vA[a * MM + i * M + k], y = vA2[c * MM + k * M + i];
          t += r.x * y.x - r.y * y.y;
        }
        acc[a * D + c] += wk * t;
      }
    }
  }
}

// acc[a, c] += wk * Re Tr[v_a A1 v_c A2] for one point (v: D blocks of M x M);
// with Same (A2 is A1) the rows of v_a A1 are those of the products v_c A2
// already formed, so they are read, not computed again
template <int M, int D, bool Same>
__device__ __forceinline__ void pair_terms_small(const double2* v, const double2* A1, const double2* A2, double wk,
                                                 double* acc) {
  constexpr int MM = M * M;
  double2 vA2[D * MM];  // (v_c A2)[k, i]
#pragma unroll
  for (int c = 0; c < D; ++c) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        double2 s = make_double2(0.0, 0.0);
#pragma unroll
        for (int l = 0; l < M; ++l) s = autobz::cadd(s, cmul(v[c * MM + k * M + l], A2[l * M + i]));
        vA2[c * MM + k * M + i] = s;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      double2 r[M];  // row i of v_a A1
#pragma unroll
      for (int k = 0; k < M; ++k) {
        if (Same) {
          r[k] = vA2[a * MM + i * M + k];
        } else {
          double2 s = make_double2(0.0, 0.0);
#pragma unroll
          for (int j = 0; j < M; ++j) s = autobz::cadd(s, cmul(v[a * MM + i * M + j], A1[j * M + k]));
          r[k] = s;
        }
      }
#pragma unroll
      for (int c = 0; c < D; ++c) {
        double t = 0.0;
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const double2 y = vA2[c * MM + k * M + i];
          t += r[k].x * y.x - r[k].y * y.y;
        }
        acc[a * D + c] += wk * t;
      }
    }
  }
}

// the closed-form sizes unrolled, the larger ones as loops
template <int M, int D, bool Same>
__device__ __forceinline__ void pair_terms(const double2* v, const double2* A1, const double2* A2, double wk,
                                           double* acc) {
  if constexpr (M <= 3) {
    pair_terms_small<M, D, Same>(v, A1, A2, wk, acc);
  } else {
    pair_terms_loop<M, D, Same>(v, A1, A2, wk, acc);
  }
}

template <int M, int D, bool Same>
__global__ void __launch_bounds__(kThreads)
sigma_pairs_partials(const double2* __restrict__ H, const double2* __restrict__ V, const double* __restrict__ w,
                     const double2* __restrict__ Z1, const double2* __restrict__ Z2,
                     double* __restrict__ partials, int64_t K, int B) {
  constexpr int MM = M * M;
  constexpr int DD = D * D;
  constexpr int kTile = tile_k<M, D>();
  constexpr bool kZShared = M <= 3;
  __shared__ double2 hs[kTile * MM];
  __shared__ double2 vs[kTile * D * MM];
  __shared__ double ws[kTile];
  __shared__ double2 zs[kZShared ? kLanes * (Same ? 1 : 2) * MM : 1];
  __shared__ double red[kKWarps][kLanes][DD];

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
    double acc[DD];
#pragma unroll
    for (int q = 0; q < DD; ++q) acc[q] = 0.0;
    for (int64_t t0 = kbeg; t0 < kend; t0 += kTile) {
      const int nk = static_cast<int>(kend - t0 < kTile ? kend - t0 : kTile);
      __syncthreads();  // the previous tile (and chunk's reduction) is consumed; zs is written
      for (int i = threadIdx.x; i < nk * MM; i += kThreads) hs[i] = H[t0 * MM + i];
      for (int i = threadIdx.x; i < nk * D * MM; i += kThreads) vs[i] = V[t0 * D * MM + i];
      for (int i = threadIdx.x; i < nk; i += kThreads) ws[i] = w[t0 + i];
      __syncthreads();
      for (int j = kw; j < nk; j += kKWarps) {
        double2 A1[MM];
        spectral<M>(z1, hs + j * MM, A1);
        if (Same) {
          pair_terms<M, D, true>(vs + j * D * MM, A1, A1, ws[j], acc);
        } else {
          double2 A2[MM];
          spectral<M>(z2, hs + j * MM, A2);
          pair_terms<M, D, false>(vs + j * D * MM, A1, A2, ws[j], acc);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < DD; ++q) red[kw][lane][q] = acc[q];
    __syncthreads();
    if (kw == 0 && live) {
#pragma unroll
      for (int q = 0; q < DD; ++q) {
        double s = red[0][lane][q];
#pragma unroll
        for (int u = 1; u < kKWarps; ++u) s += red[u][lane][q];
        partials[(c * B + bi) * DD + q] = s;
      }
    }
  }
}

template <int M, int D>
__global__ void sigma_pairs_points_kernel(const double2* __restrict__ H, const double2* __restrict__ V,
                                          const double2* __restrict__ Z, int64_t z_stride,
                                          double* __restrict__ out, int64_t N) {
  constexpr int MM = M * M;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  double2 z[MM], h[MM], v[D * MM], A[MM];
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    z[i] = Z[n * z_stride + i];
    h[i] = H[n * MM + i];
  }
#pragma unroll
  for (int i = 0; i < D * MM; ++i) v[i] = V[n * D * MM + i];
  spectral<M>(z, h, A);
  double acc[D * D];
#pragma unroll
  for (int q = 0; q < D * D; ++q) acc[q] = 0.0;
  pair_terms<M, D, true>(v, A, A, 1.0, acc);
#pragma unroll
  for (int q = 0; q < D * D; ++q) out[n * D * D + q] = kInvFourPi2 * acc[q];
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
