// K9: ascending eigenvalues of a batch of Hermitian m x m matrices, m <= 3,
// in FP64, one thread per matrix.
//
// Replaces autobzcore_tpu/ops/eigh3.py:161 eigvalsh_small for m <= 3: the
// real diagonal for m = 1, :17 eigvalsh2 for m = 2 and :61 eigvalsh3 (the
// trigonometric Cardano solution with its degeneracy guard, then a sort)
// for m = 3. The closed forms live in small_eigen.cuh, shared with K7.
//
// What bounds it on an H100: a 3x3 matrix is 144 bytes read and 24 written
// against ~100 FP64 operations (an arccos and two cosines among them), so at
// 1e6 matrices the 168 MB of traffic (50 us at 3.35 TB/s) and the arithmetic
// (about 3 us at 34 TFLOP/s, more with the transcendentals' sequences) are
// both small; the read is the limit. One thread per matrix reads its six
// independent entries (the lower triangle is not read); neighbouring threads
// read neighbouring matrices, so a warp's loads cover whole cache lines.

#include <cuda_runtime.h>

#include <cstdint>

#include "small_eigen.cuh"

namespace {

constexpr int kThreads = 256;

template <int M>
__global__ void __launch_bounds__(kThreads)
eigvalsh_small_kernel(const double2* __restrict__ h, double* __restrict__ out, int64_t K) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= K) return;
  const double2* a = h + k * (M * M);
  double* o = out + k * M;
  if constexpr (M == 1) {
    o[0] = a[0].x;
  } else if constexpr (M == 2) {
    const double2 b = a[1];
    autobz::eig2(a[0].x, a[3].x, b.x, b.y, o[0], o[1]);
  } else {
    const double2 h12 = a[1], h13 = a[2], h23 = a[5];
    double e1, e2, e3;
    autobz::cardano3(a[0].x, a[4].x, a[8].x, h12.x, h12.y, h13.x, h13.y, h23.x, h23.y, e1, e2,
                     e3);
    // ascending sort of (e3, e2, e1), as the reference's jnp.sort
    autobz::swap_if_greater(e3, e2);
    autobz::swap_if_greater(e2, e1);
    autobz::swap_if_greater(e3, e2);
    o[0] = e3;
    o[1] = e2;
    o[2] = e1;
  }
}

}  // namespace

// h: (K, m, m) complex128 as double2, row-major; out: (K, m) float64.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// m outside 1..3 or a grid beyond the launch limit.
extern "C" int eigvalsh_small_launch(const void* h, void* out, long long K, int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (K + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* hp = static_cast<const double2*>(h);
  auto* op = static_cast<double*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (m) {
    case 1:
      eigvalsh_small_kernel<1><<<grid, kThreads, 0, st>>>(hp, op, K);
      break;
    case 2:
      eigvalsh_small_kernel<2><<<grid, kThreads, 0, st>>>(hp, op, K);
      break;
    case 3:
      eigvalsh_small_kernel<3><<<grid, kThreads, 0, st>>>(hp, op, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
