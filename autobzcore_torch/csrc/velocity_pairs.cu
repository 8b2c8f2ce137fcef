// K18: the band-pair velocity pack of the transport solvers, in FP64.
//
// Replaces autobzcore_tpu/models/observables.py:326-339, the einsums
// "kmi,kdij,kjn->kdmn" (band-basis velocities) and "kanm,kbmn->kabnm" (their
// pair products, real part) of spectral_velocity_pack, and the weighting and
// transpose into the GEMM operand. For eigenvectors U (K, m, m) (column n is
// the eigenvector of band n), gradients dH (K, d, m, m) and weights w (K,) it
// writes, in the reference's layout,
//
//   v[k, a, n, q]              = sum_i conj(U[k, i, n]) sum_j dH[k, a, i, j] U[k, j, q],
//   Wmat[(k, n, q), (a, b)]    = w_k Re[v[k, a, n, q] v[k, b, q, n]].
//
// Both factors of each product are computed, as the reference does: U^H dH U
// is Hermitian only to rounding, so v[k, b, q, n] is not replaced by
// conj(v[k, b, n, q]).
//
// What bounds it on an H100: per point it reads U and dH (16 m^2 (1 + d)
// bytes) and writes m^2 d^2 doubles; the band-basis products take d m^2
// sums of 2 m complex multiply-adds (16 d m^3 FP64 operations). At m = 3,
// d = 3 that is 1,232 bytes against ~1,300 operations a point: the bytes
// bound it (0.08 ms for the flagship's 216,000 points).
//
// The design (K12's staging, band_velocity.cu, extended to the whole
// matrix): a block of 128 threads takes kpb points. It stages their U in
// shared memory, computes the d m^2 band-basis velocities of each point into
// shared memory (one thread per (point, direction, n, q) entry), then writes
// the kpb m^2 d^2 outputs, which are contiguous in Wmat, one thread per
// entry, so the stores coalesce. Up to 48 KB of staging needs no opt-in;
// above that (m > 27 at d = 3) the launch raises the kernel's dynamic shared
// memory limit, up to the card's 227 KB (m <= 59 at d = 3). The sums run in
// a fixed order, so repeats are bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPoints = 32;                 // points a block stages at most
constexpr long long kDefaultShared = 48 * 1024;
constexpr long long kMaxShared = 227 * 1024;   // an H100 block's opt-in limit

// dH[k, a] starts at dH + k * sk + a * sj (in complex entries); its m x m
// entries are contiguous.
__global__ void __launch_bounds__(kThreads)
velocity_pairs_kernel(const double2* __restrict__ U, const double2* __restrict__ dH,
                      const double* __restrict__ w, double* __restrict__ out, int64_t K, int d,
                      int m, int64_t sk, int64_t sj, int kpb) {
  extern __shared__ double2 smem[];
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kpb;
  const int nk = static_cast<int>(K - k0 < kpb ? K - k0 : kpb);
  const int mm = m * m;
  double2* su = smem;                 // (kpb, m, m)
  double2* sv = smem + kpb * mm;      // (kpb, d, m, m)
  for (int i = threadIdx.x; i < nk * mm; i += blockDim.x) su[i] = U[k0 * mm + i];
  __syncthreads();
  const int per = d * mm;
  for (int idx = threadIdx.x; idx < nk * per; idx += blockDim.x) {
    const int kk = idx / per;
    const int r = idx - kk * per;
    const int a = r / mm;
    const int nq = r - a * mm;
    const int n = nq / m;
    const int q = nq - n * m;
    const double2* Uk = su + kk * mm;
    const double2* Ha = dH + (k0 + kk) * sk + a * sj;
    double vx = 0.0, vy = 0.0;
    for (int i = 0; i < m; ++i) {
      double tx = 0.0, ty = 0.0;  // (dH_a U)[i, q]
      const double2* Hi = Ha + static_cast<int64_t>(i) * m;
      for (int j = 0; j < m; ++j) {
        const double2 h = __ldg(Hi + j);
        const double2 u = Uk[j * m + q];
        tx = fma(h.x, u.x, fma(-h.y, u.y, tx));
        ty = fma(h.x, u.y, fma(h.y, u.x, ty));
      }
      const double2 ui = Uk[i * m + n];  // conj(U[i, n]) (tx + i ty)
      vx = fma(ui.x, tx, fma(ui.y, ty, vx));
      vy = fma(ui.x, ty, fma(-ui.y, tx, vy));
    }
    sv[idx] = make_double2(vx, vy);
  }
  __syncthreads();
  const int dd = d * d;
  const int row = mm * dd;  // outputs per point
  double* o = out + k0 * row;
  for (int idx = threadIdx.x; idx < nk * row; idx += blockDim.x) {
    const int kk = idx / row;
    const int r = idx - kk * row;
    const int nq = r / dd;
    const int ab = r - nq * dd;
    const int n = nq / m;
    const int q = nq - n * m;
    const int a = ab / d;
    const int b = ab - a * d;
    const double2 x = sv[(kk * d + a) * mm + n * m + q];
    const double2 y = sv[(kk * d + b) * mm + q * m + n];
    const double re = __dsub_rn(__dmul_rn(x.x, y.x), __dmul_rn(x.y, y.y));
    o[idx] = __dmul_rn(__ldg(w + k0 + kk), re);
  }
}

// Points a block stages: kMaxPoints, or as many as fit in 48 KB (at least
// one).
int points_per_block(int d, int m) {
  const long long per_point = 16LL * m * m * (1 + d);
  long long kpb = kMaxPoints;
  while (kpb > 1 && kpb * per_point > kDefaultShared) --kpb;
  return static_cast<int>(kpb);
}

}  // namespace

// The largest band count K18 takes at d directions (its staging must fit in
// 227 KB of shared memory).
extern "C" int velocity_pairs_max_bands(int d) {
  int m = 1;
  while (16LL * (m + 1) * (m + 1) * (1 + d) <= kMaxShared) ++m;
  return m;
}

// U: (K, m, m) complex128, contiguous; dH: (K, d, m, m) complex128 whose
// (m, m) blocks are contiguous, point stride sk and direction stride sj in
// complex entries; w: (K,) float64; out: (K m^2, d^2) float64, written.
// Returns cudaErrorInvalidValue for d or m below 1 or m above
// velocity_pairs_max_bands(d), else cudaGetLastError() after the launch.
extern "C" int velocity_pairs_launch(const void* U, const void* dH, const void* w, void* out,
                                     long long K, int d, int m, long long sk, long long sj,
                                     void* stream) {
  if (d < 1 || m < 1 || m > velocity_pairs_max_bands(d)) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  const int kpb = points_per_block(d, m);
  const long long bytes = 16LL * kpb * m * m * (1 + d);
  if (bytes > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        velocity_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((K + kpb - 1) / kpb);
  velocity_pairs_kernel<<<blocks, kThreads, static_cast<size_t>(bytes), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(U), static_cast<const double2*>(dH), static_cast<const double*>(w),
      static_cast<double*>(out), static_cast<int64_t>(K), d, m, static_cast<int64_t>(sk),
      static_cast<int64_t>(sj), kpb);
  return static_cast<int>(cudaGetLastError());
}
