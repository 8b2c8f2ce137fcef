// K21: the band-pair terms of the Berry family, in FP64.
//
// Replaces autobzcore_tpu/models/berry.py:101-118 (_band_pair_terms, with
// :85-88 _eigh_batch, which is ops/eigh3.py:27 eigh2 at m = 2), :551-562
// (quantum_metric's slab) and :223-233 (_operator_build_fn's slab). For
// Hamiltonians H (K, m, m), gradients dH (K, d, m, m) and eigenpairs (e, U)
// of H (U's column n the eigenvector of band n), with the band-basis
// velocities v_a = U^H dH_a U and the degeneracy-masked denominators
//
//   inv_p[n, q] = 1 / (e_n - e_q)^p  where |e_n - e_q| > degtol, else 0
//
// (berry.py:91-98, _pair_inv, whose de == 0 test this keeps), it writes per
// point, in the pack's layout:
//
//   mode 0, curvature: e (K, m); Om[k, n, a, b] = -2 sum_q Im(v_a[n, q]
//     v_b[q, n]) inv_2[n, q] and Mm[k, n, a, b] = sum_q Im(v_a[n, q] v_b[q, n])
//     inv_1[n, q] (K, m, d, d); vd[k, n, a] = Re v_a[n, n] (K, m, d);
//   mode 1, metric: g[k, n, a, b] = sum_{q != n} Re(v_a[n, q] v_b[q, n])
//     inv_2[n, q] (K, m, d, d);
//   mode 2, operator: e and OmO, Om's sum with v_a replaced by the
//     symmetrized current J_a = (Ob v_a + v_a Ob) / 2, Ob = U^H O U for an
//     (m, m) operator O.
//
// At m = 2 (the Haldane and Weyl builds) the kernel takes the reference's
// branch-stable closed form eigh2 in registers from H, so a build reads only
// H and dH; at m > 2 it reads (e, U) from torch.linalg.eigh, as the
// reference calls its library there.
//
// What bounds it on an H100: at m = 2, d = 2 a point reads H and dH (192 B)
// and writes e, Om, Mm and vd (176 B), against ~300 FP64 operations: the
// bytes bound it (0.11 ms at 1,048,576 points).
//
// The design (K18's staging, velocity_pairs.cu, extended with the pair
// sums): a block of 128 threads takes kpb points. One thread per point
// forms its eigenpairs in shared memory (closed form, or copied); one thread
// per (point, direction, n, q) entry forms v in shared memory (and the
// operator's Ob and J); then one thread per (point, n, a, b) output runs the
// pair sum over q in a fixed order and writes it, so the stores coalesce and
// repeats are bit-identical. O sits in shared memory. Up to 48 KB of staging
// needs no opt-in; above it the launch raises the kernel's dynamic shared
// memory limit, up to the card's 227 KB.

#include <cuda_runtime.h>

#include <cstdint>

#include "small_eigen.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPoints = 32;
constexpr long long kDefaultShared = 48 * 1024;
constexpr long long kMaxShared = 227 * 1024;

enum Mode { kCurvature = 0, kMetric = 1, kOperator = 2 };

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// (U^H A U)[n, q] for an m x m matrix A (row stride m) and U in shared memory.
__device__ __forceinline__ double2 band_basis(const double2* A, const double2* Uk, int m, int n, int q,
                                              bool global) {
  double vx = 0.0, vy = 0.0;
  for (int i = 0; i < m; ++i) {
    double tx = 0.0, ty = 0.0;  // (A U)[i, q]
    for (int j = 0; j < m; ++j) {
      const double2 h = global ? __ldg(A + i * m + j) : A[i * m + j];
      const double2 u = Uk[j * m + q];
      tx += h.x * u.x - h.y * u.y;
      ty += h.x * u.y + h.y * u.x;
    }
    const double2 ui = Uk[i * m + n];  // conj(U[i, n]) (tx + i ty)
    vx += ui.x * tx + ui.y * ty;
    vy += ui.x * ty - ui.y * tx;
  }
  return make_double2(vx, vy);
}

__device__ __forceinline__ double pair_inv(double de, double degtol, int power) {
  const double safe = de == 0.0 ? 1.0 : de;
  if (!(fabs(de) > degtol)) return 0.0;
  return power == 2 ? 1.0 / (safe * safe) : 1.0 / safe;
}

long long point_bytes(int d, int m, int mode) {
  const long long mats = (1 + d) + (mode == kOperator ? 1 + d : 0);  // U, v (, Ob, J)
  return 16LL * m * m * mats + 8LL * m;
}

long long shared_bytes(int d, int m, int mode, int kpb) {
  return kpb * point_bytes(d, m, mode) + (mode == kOperator ? 16LL * m * m : 0);
}

int points_per_block(int d, int m, int mode) {
  int kpb = kMaxPoints;
  while (kpb > 1 && shared_bytes(d, m, mode, kpb) > kDefaultShared) --kpb;
  return kpb;
}

// dH[k, a] starts at dH + k * sk + a * sj (complex entries), its m x m
// entries contiguous. e_in/U_in are null where the closed form runs (m = 2).
__global__ void __launch_bounds__(kThreads)
berry_pairs_kernel(const double2* __restrict__ H, const double2* __restrict__ dH,
                   const double* __restrict__ e_in, const double2* __restrict__ U_in,
                   const double2* __restrict__ O, double* __restrict__ e_out, double* __restrict__ F1,
                   double* __restrict__ F2, double* __restrict__ vd, int64_t K, int d, int m, int64_t sk,
                   int64_t sj, double degtol, int mode, int kpb) {
  extern __shared__ double2 smem[];
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kpb;
  const int nk = static_cast<int>(K - k0 < kpb ? K - k0 : kpb);
  const int mm = m * m;
  const bool op = mode == kOperator;
  double2* su = smem;                        // (kpb, m, m)
  double2* sv = su + kpb * mm;               // (kpb, d, m, m)
  double2* sob = sv + kpb * d * mm;          // (kpb, m, m), operator mode
  double2* sJ = sob + (op ? kpb * mm : 0);   // (kpb, d, m, m), operator mode
  double2* sO = sJ + (op ? kpb * d * mm : 0);  // (m, m), operator mode
  double* se = reinterpret_cast<double*>(sO + (op ? mm : 0));  // (kpb, m)

  if (U_in == nullptr) {
    for (int kk = threadIdx.x; kk < nk; kk += blockDim.x) autobz::eigh2(H + (k0 + kk) * 4, se + kk * 2, su + kk * 4);
  } else {
    for (int i = threadIdx.x; i < nk * mm; i += blockDim.x) su[i] = U_in[k0 * mm + i];
    for (int i = threadIdx.x; i < nk * m; i += blockDim.x) se[i] = e_in[k0 * m + i];
  }
  if (op) {
    for (int i = threadIdx.x; i < mm; i += blockDim.x) sO[i] = __ldg(O + i);
  }
  __syncthreads();
  const int per = d * mm;
  for (int idx = threadIdx.x; idx < nk * per; idx += blockDim.x) {
    const int kk = idx / per;
    const int r = idx - kk * per;
    const int a = r / mm;
    const int nq = r - a * mm;
    sv[idx] = band_basis(dH + (k0 + kk) * sk + a * sj, su + kk * mm, m, nq / m, nq % m, true);
  }
  if (op) {
    for (int idx = threadIdx.x; idx < nk * mm; idx += blockDim.x) {
      const int kk = idx / mm;
      const int nq = idx - kk * mm;
      sob[idx] = band_basis(sO, su + kk * mm, m, nq / m, nq % m, false);
    }
    __syncthreads();
    // J_a = (Ob v_a + v_a Ob) / 2
    for (int idx = threadIdx.x; idx < nk * per; idx += blockDim.x) {
      const int kk = idx / per;
      const int r = idx - kk * per;
      const int a = r / mm;
      const int nq = r - a * mm;
      const int n = nq / m, q = nq % m;
      const double2* Ob = sob + kk * mm;
      const double2* va = sv + (kk * d + a) * mm;
      double2 s1 = make_double2(0.0, 0.0), s2 = make_double2(0.0, 0.0);
      for (int p = 0; p < m; ++p) {
        const double2 x = cmul(Ob[n * m + p], va[p * m + q]);
        const double2 y = cmul(va[n * m + p], Ob[p * m + q]);
        s1.x += x.x;
        s1.y += x.y;
        s2.x += y.x;
        s2.y += y.y;
      }
      sJ[idx] = make_double2(0.5 * (s1.x + s2.x), 0.5 * (s1.y + s2.y));
    }
  }
  __syncthreads();

  const int dd = d * d;
  const int row = m * dd;  // (n, a, b) outputs per point
  const double2* left = op ? sJ : sv;
  for (int idx = threadIdx.x; idx < nk * row; idx += blockDim.x) {
    const int kk = idx / row;
    const int r = idx - kk * row;
    const int n = r / dd;
    const int ab = r - n * dd;
    const int a = ab / d, b = ab - (ab / d) * d;
    const double2* X = left + (kk * d + a) * mm;
    const double2* Y = sv + (kk * d + b) * mm;
    const double* ek = se + kk * m;
    double s2 = 0.0, s1 = 0.0;
    for (int q = 0; q < m; ++q) {
      const double2 x = X[n * m + q], y = Y[q * m + n];
      const double de = ek[n] - ek[q];
      if (mode == kMetric) {
        if (q != n) s2 += (x.x * y.x - x.y * y.y) * pair_inv(de, degtol, 2);
      } else {
        const double im = x.x * y.y + x.y * y.x;
        s2 += im * pair_inv(de, degtol, 2);
        if (mode == kCurvature) s1 += im * pair_inv(de, degtol, 1);
      }
    }
    const int64_t o = k0 * row + idx;
    if (mode == kMetric) {
      F1[o] = s2;
    } else {
      F1[o] = -2.0 * s2;
      if (mode == kCurvature) F2[o] = s1;
    }
  }
  if (mode == kMetric) return;
  for (int i = threadIdx.x; i < nk * m; i += blockDim.x) e_out[k0 * m + i] = se[i];
  if (mode == kCurvature) {
    for (int idx = threadIdx.x; idx < nk * m * d; idx += blockDim.x) {
      const int kk = idx / (m * d);
      const int r = idx - kk * m * d;
      const int n = r / d, a = r - (r / d) * d;
      vd[k0 * m * d + idx] = sv[(kk * d + a) * mm + n * m + n].x;
    }
  }
}

}  // namespace

// The largest band count K21 takes at d directions in ``mode`` (its staging
// of one point must fit in 227 KB of shared memory).
extern "C" int berry_pairs_max_bands(int d, int mode) {
  int m = 1;
  while (shared_bytes(d, m + 1, mode, 1) <= kMaxShared) ++m;
  return m;
}

// H: (K, 2, 2) complex128 for the closed form (e_in and U_in null, m = 2),
// else unread; e_in (K, m) float64 and U_in (K, m, m) complex128, or null;
// dH: (K, d, m, m) complex128 whose (m, m) blocks are contiguous, point
// stride sk and direction stride sj in complex entries; O: (m, m)
// complex128 in operator mode, else unread. Writes e_out (K, m) (modes 0
// and 2), F1 (K, m, d, d) (Om, g or OmO), F2 (K, m, d, d) (Mm, mode 0) and
// vd (K, m, d) (mode 0). Returns cudaErrorInvalidValue for a shape or mode
// it does not take, else cudaGetLastError() after the launch.
extern "C" int berry_pairs_launch(const void* H, const void* dH, const void* e_in, const void* U_in,
                                  const void* O, void* e_out, void* F1, void* F2, void* vd, long long K,
                                  int d, int m, long long sk, long long sj, double degtol, int mode,
                                  void* stream) {
  if (mode < kCurvature || mode > kOperator || d < 1 || m < 1 || m > berry_pairs_max_bands(d, mode))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((U_in == nullptr) != (e_in == nullptr) || (U_in == nullptr && m != 2) || (mode == kOperator && O == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  const int kpb = points_per_block(d, m, mode);
  const long long bytes = shared_bytes(d, m, mode, kpb);
  if (bytes > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(berry_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (K + kpb - 1) / kpb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  berry_pairs_kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(bytes),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(H), static_cast<const double2*>(dH), static_cast<const double*>(e_in),
      static_cast<const double2*>(U_in), static_cast<const double2*>(O), static_cast<double*>(e_out),
      static_cast<double*>(F1), static_cast<double*>(F2), static_cast<double*>(vd), static_cast<int64_t>(K), d, m,
      static_cast<int64_t>(sk), static_cast<int64_t>(sj), degtol, mode, kpb);
  return static_cast<int>(cudaGetLastError());
}
