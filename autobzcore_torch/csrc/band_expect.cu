// K30: band-resolved expectation values along a k-path, in FP64.
//
// Replaces autobzcore_tpu/models/kpath.py:86-95 (expectation_path's
// `expect`: the einsum "kin,ij,kjn->kn" after eigh_small, ops/eigh3.py:173,
// with the closed form eigh2 of :27 at m = 2). For eigenvectors U (K, m, m)
// (column n the eigenvector of band n) and an (m, m) operator O it writes
//
//   out[k, n] = Re sum_ij conj(U[k, i, n]) O[i, j] U[k, j, n]      (K, m),
//
// and at m = 2 it takes H (K, 2, 2) itself and forms U by the reference's
// branch-stable closed form (small_eigen.cuh's eigh2, which K21 uses too),
// so the path reads only H.
//
// What bounds it on an H100: at the flagship path (K = 3,787, m = 3) a band
// reads its column of U (48 B) and writes 8 B against 8 m^2 + 2 m FP64
// operations: about 0.9 MB in all, so the launch, not the card, sets its
// time.
//
// The design: O sits in shared memory; one thread per (point, band) output,
// so consecutive threads write consecutive addresses and the threads of a
// point read adjacent entries of each row of U; at m = 2 one thread per
// point forms both bands. The sums run in a fixed order, so repeats are
// bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

#include "small_eigen.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBands = 32;  // O (m, m) staged in 16 KB of shared memory

// Re conj(u)^T O u for the column n of U (row stride m) and O in shared memory.
__device__ __forceinline__ double expect_column(const double2* __restrict__ Uk, const double2* Os, int m, int n) {
  double acc = 0.0;
  for (int i = 0; i < m; ++i) {
    double tx = 0.0, ty = 0.0;  // (O u)[i]
    for (int j = 0; j < m; ++j) {
      const double2 o = Os[i * m + j];
      const double2 u = Uk[j * m + n];
      tx += o.x * u.x - o.y * u.y;
      ty += o.x * u.y + o.y * u.x;
    }
    const double2 ui = Uk[i * m + n];  // Re(conj(u_i) (tx + i ty))
    acc += ui.x * tx + ui.y * ty;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
band_expect_kernel(const double2* __restrict__ U, const double2* __restrict__ O, double* __restrict__ out,
                   int64_t K, int m) {
  __shared__ double2 Os[kMaxBands * kMaxBands];
  for (int i = threadIdx.x; i < m * m; i += kThreads) Os[i] = O[i];
  __syncthreads();
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= K * m) return;
  const int64_t k = idx / m;
  const int n = static_cast<int>(idx - k * m);
  out[idx] = expect_column(U + k * m * m, Os, m, n);
}

__global__ void __launch_bounds__(kThreads)
band_expect_eigh2_kernel(const double2* __restrict__ H, const double2* __restrict__ O, double* __restrict__ out,
                         int64_t K) {
  __shared__ double2 Os[4];
  if (threadIdx.x < 4) Os[threadIdx.x] = O[threadIdx.x];
  __syncthreads();
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= K) return;
  double2 h[4], Uk[4];
  double e[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = H[k * 4 + i];
  autobz::eigh2(h, e, Uk);
  out[k * 2] = expect_column(Uk, Os, 2, 0);
  out[k * 2 + 1] = expect_column(Uk, Os, 2, 1);
}

}  // namespace

// The largest band count K30 takes.
extern "C" int band_expect_max_bands() { return kMaxBands; }

// V: eigenvectors U (K, m, m) complex128, or with fused = 1 (m = 2 only) the
// Hamiltonians H (K, 2, 2); O: (m, m) complex128; out: (K, m) float64,
// written. Returns cudaErrorInvalidValue for m outside
// 1..band_expect_max_bands() or fused at m != 2, else cudaGetLastError()
// after the launch.
extern "C" int band_expect_launch(const void* V, const void* O, void* out, long long K, int m, int fused,
                                  void* stream) {
  if (m < 1 || m > kMaxBands || (fused && m != 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* Vp = static_cast<const double2*>(V);
  const auto* Op = static_cast<const double2*>(O);
  auto* op = static_cast<double*>(out);
  if (fused) {
    band_expect_eigh2_kernel<<<static_cast<unsigned>((K + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        Vp, Op, op, static_cast<int64_t>(K));
  } else {
    const long long n = K * m;
    band_expect_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        Vp, Op, op, static_cast<int64_t>(K), m);
  }
  return static_cast<int>(cudaGetLastError());
}
