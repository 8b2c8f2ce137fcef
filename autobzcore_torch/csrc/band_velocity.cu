// K12: band velocities, the diagonal of U^H dH_j U, in FP64.
//
// Replaces autobzcore_tpu/dos/ggr.py:278, the einsum
// "kmi,kdij,kjm->kdm" of conj(U^T), the Jacobian dH and U that XLA runs as
// batched complex products, and its real part. For eigenvectors U (K, m, m)
// (column b is the eigenvector of band b) and the gradient dH (K, d, m, m)
// it computes only the diagonal:
//
//   v[k, j, b] = Re sum_il conj(U[k, i, b]) dH[k, j, i, l] U[k, l, b].
//
// What bounds it on an H100: per (point, direction, band) the inner sums
// take m^2 complex multiply-adds (8 m^2 FP64 operations) and the outer one
// 4 m, against 16 m^2 (1 + d) bytes read per point. At m = 30, d = 3 that is
// ~6.6e5 operations against ~58 KB per point: about 11 operations a byte,
// just above the H100's FP64 ridge (~10 at 34 TFLOP/s over 3.35 TB/s), so
// the two bounds are close; at m = 3 the bytes dominate.
//
// The design: a block of 128 threads takes kpb = max(1, 128 / (d m))
// points, one thread per (point, direction, band) (threads loop over the
// pairs when d m > 128). The points' eigenvectors are staged in shared
// memory when they fit in 48 KB (m <= 54 at kpb = 1), else read through the
// L1 cache. Threads of one direction read the same dH entry at each step, a
// broadcast. The sums run in a fixed order, so repeats are bit-identical.
// At a degenerate eigenvalue the eigenvector basis, and so the per-band
// velocity, is whatever the eigensolver returned (ROADMAP C3).
//
// The fused entry (band_velocity_eigh_launch), m <= 3: replaces the same
// einsum and the jnp.linalg.eigh before it (autobzcore_tpu/dos/ggr.py:276-278),
// which the card otherwise ran as a cuSOLVER batched eigh, a copy of U and
// the entry above. It takes K11's output J (K, 1 + d, m, m), H then dH_j,
// and writes e (K, m) and v (K, d, m); U never reaches device memory.
//
// What bounds it on an H100: a point reads 16 m^2 (1 + d) bytes and writes
// 8 m (1 + d), 576 + 96 at m = 3, d = 3, so 0.20 ms at 1e6 points; the
// eigensolve (csrc/small_eigen.cuh eigh_rn, at most 15 rotations of ~154
// correctly rounded operations) and the d m quadratic forms (~40 each) need
// at most ~2,750 FP64 operations a point, 0.08 ms at 34 TFLOP/s: the bytes
// bound it.
//
// The design: one thread a point, 64 points a block. The block's points are
// one contiguous span of J; its threads copy it into shared memory by
// coalesced 16-byte loads, a point's entries at an odd stride of 16-byte
// words (37 at m = 3, d = 3) so that a quarter-warp's reads of its points'
// same entry hit distinct banks (37,888 bytes, within the 48 KB a block has
// without an opt-in; six blocks an SM). Each thread reads H's Hermitian part,
// runs the register eigensolver, then v[j, b] = Re u_b^H dH_j u_b as a
// quadratic form on dH_j's diagonal and both triangles (exactly the real
// part of the einsum's term for any dH_j). e and v go back through shared
// memory and out in coalesced stores. The sums run in a fixed order, so
// repeats are bit-identical; at exactly degenerate eigenvalues the per-band
// velocities are those of the Jacobi eigenbasis (their sum over the cluster
// is basis-invariant).

#include <cuda_runtime.h>

#include <cstdint>

#include "small_eigen.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStageBytes = 48 * 1024;  // shared memory without an opt-in

// dH[k, j] starts at dH + k * sk + j * sj (in complex entries); its m x m
// entries are contiguous.
__global__ void __launch_bounds__(kThreads)
band_velocity_kernel(const double2* __restrict__ U, const double2* __restrict__ dH,
                     double* __restrict__ v, int64_t K, int d, int m, int64_t sk, int64_t sj,
                     int kpb, int stage) {
  extern __shared__ double2 su[];
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kpb;
  const int nk = static_cast<int>(K - k0 < kpb ? K - k0 : kpb);
  const int64_t mm = static_cast<int64_t>(m) * m;
  if (stage) {
    for (int64_t i = threadIdx.x; i < nk * mm; i += blockDim.x) su[i] = U[k0 * mm + i];
    __syncthreads();
  }
  const int P = d * m;
  for (int idx = threadIdx.x; idx < nk * P; idx += blockDim.x) {
    const int kk = idx / P;
    const int pr = idx - kk * P;
    const int j = pr / m;
    const int b = pr - j * m;
    const int64_t k = k0 + kk;
    const double2* Uk = stage ? su + kk * mm : U + k * mm;
    const double2* Hj = dH + k * sk + j * sj;
    double acc = 0.0;
    for (int i = 0; i < m; ++i) {
      double tx = 0.0, ty = 0.0;  // (dH_j U)[i, b]
      const double2* Hi = Hj + static_cast<int64_t>(i) * m;
      for (int l = 0; l < m; ++l) {
        const double2 h = __ldg(Hi + l);
        const double2 u = Uk[static_cast<int64_t>(l) * m + b];
        tx = fma(h.x, u.x, fma(-h.y, u.y, tx));
        ty = fma(h.x, u.y, fma(h.y, u.x, ty));
      }
      const double2 ui = Uk[static_cast<int64_t>(i) * m + b];
      acc = fma(ui.x, tx, fma(ui.y, ty, acc));  // Re(conj(u_i) t_i)
    }
    v[(k * d + j) * m + b] = acc;
  }
}

constexpr int kEighThreads = 64;

// Re u_b^H A u_b of the column b of U for the m x m complex A at x (row
// major), from its diagonal and both triangles.
template <int M>
__device__ __forceinline__ double quad_form(const double2* x, const double (&ur)[3][3], const double (&ui)[3][3],
                                            int b) {
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < M; ++i) acc = fma(x[i * M + i].x, fma(ur[i][b], ur[i][b], ui[i][b] * ui[i][b]), acc);
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int l = i + 1; l < M; ++l) {
      // w = conj(u_i) u_l; Re(w A_il) + Re(conj(w) A_li)
      const double wr = fma(ur[i][b], ur[l][b], ui[i][b] * ui[l][b]);
      const double wi = fma(ur[i][b], ui[l][b], -(ui[i][b] * ur[l][b]));
      const double2 a = x[i * M + l], c = x[l * M + i];
      acc = fma(a.x + c.x, wr, fma(c.y - a.y, wi, acc));
    }
  }
  return acc;
}

template <int M, int D>
__global__ void __launch_bounds__(kEighThreads)
band_velocity_eigh_kernel(const double2* __restrict__ J, double* __restrict__ e, double* __restrict__ v, int64_t K) {
  constexpr int kN = (1 + D) * M * M;  // complex entries a point
  constexpr int kStride = kN | 1;      // odd, in 16-byte words
  __shared__ double2 s[kEighThreads * kStride];
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kEighThreads;
  const int nk = static_cast<int>(K - k0 < kEighThreads ? K - k0 : kEighThreads);
  const double2* src = J + k0 * kN;
  for (int idx = threadIdx.x; idx < nk * kN; idx += kEighThreads) {
    const int p = idx / kN;
    s[p * kStride + (idx - p * kN)] = src[idx];
  }
  __syncthreads();
  double ev[3], vv[D][3];
  const bool live = static_cast<int>(threadIdx.x) < nk;
  if (live) {
    const double2* x = s + threadIdx.x * kStride;
    double d[3], orr[3], oi[3], ur[3][3], ui[3][3];
    autobz::load_hermitian<M>(x, d, orr, oi);
    autobz::eigh_rn<M>(d, orr, oi, ev, ur, ui);
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
      for (int b = 0; b < M; ++b) vv[j][b] = quad_form<M>(x + (1 + j) * M * M, ur, ui, b);
    }
  }
  __syncthreads();
  // the block's e then its v, each contiguous in shared memory as in device memory
  double* so = reinterpret_cast<double*>(s);
  if (live) {
#pragma unroll
    for (int b = 0; b < M; ++b) so[threadIdx.x * M + b] = ev[b];
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
      for (int b = 0; b < M; ++b) so[kEighThreads * M + (threadIdx.x * D + j) * M + b] = vv[j][b];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nk * M; idx += kEighThreads) e[k0 * M + idx] = so[idx];
  for (int idx = threadIdx.x; idx < nk * D * M; idx += kEighThreads) v[k0 * D * M + idx] = so[kEighThreads * M + idx];
}

template <int M>
void launch_eigh(int d, unsigned blocks, cudaStream_t st, const double2* J, double* e, double* v, int64_t K) {
  if (d == 1) {
    band_velocity_eigh_kernel<M, 1><<<blocks, kEighThreads, 0, st>>>(J, e, v, K);
  } else if (d == 2) {
    band_velocity_eigh_kernel<M, 2><<<blocks, kEighThreads, 0, st>>>(J, e, v, K);
  } else {
    band_velocity_eigh_kernel<M, 3><<<blocks, kEighThreads, 0, st>>>(J, e, v, K);
  }
}

}  // namespace

// U: (K, m, m) complex128, contiguous; dH: (K, d, m, m) complex128 whose
// (m, m) blocks are contiguous, point stride sk and direction stride sj in
// complex entries; v: (K, d, m) float64, written. Returns
// cudaErrorInvalidValue for d or m below 1, else cudaGetLastError() after the
// launch.
extern "C" int band_velocity_launch(const void* U, const void* dH, void* v, long long K, int d,
                                    int m, long long sk, long long sj, void* stream) {
  if (d < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  const int P = d * m;
  const int kpb = P < kThreads ? kThreads / P : 1;
  const long long bytes = static_cast<long long>(kpb) * m * m * 16;
  const int stage = bytes <= kStageBytes ? 1 : 0;
  const unsigned blocks = static_cast<unsigned>((K + kpb - 1) / kpb);
  band_velocity_kernel<<<blocks, kThreads, stage ? static_cast<size_t>(bytes) : 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(U), static_cast<const double2*>(dH), static_cast<double*>(v),
      static_cast<int64_t>(K), d, m, static_cast<int64_t>(sk), static_cast<int64_t>(sj), kpb, stage);
  return static_cast<int>(cudaGetLastError());
}

// J: (K, 1 + d, m, m) complex128, contiguous (K11's output: H, then dH_j);
// e: (K, m) and v: (K, d, m) float64, written. Returns cudaErrorInvalidValue
// for m or d outside 1..3, else cudaGetLastError() after the launch.
extern "C" int band_velocity_eigh_launch(const void* J, void* e, void* v, long long K, int m, int d,
                                         void* stream) {
  if (m < 1 || m > 3 || d < 1 || d > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((K + kEighThreads - 1) / kEighThreads);
  const auto* Jp = static_cast<const double2*>(J);
  auto* ep = static_cast<double*>(e);
  auto* vp = static_cast<double*>(v);
  const int64_t n = static_cast<int64_t>(K);
  if (m == 1) {
    launch_eigh<1>(d, blocks, st, Jp, ep, vp, n);
  } else if (m == 2) {
    launch_eigh<2>(d, blocks, st, Jp, ep, vp, n);
  } else {
    launch_eigh<3>(d, blocks, st, Jp, ep, vp, n);
  }
  return static_cast<int>(cudaGetLastError());
}
