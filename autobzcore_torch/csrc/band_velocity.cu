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

#include <cuda_runtime.h>

#include <cstdint>

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
