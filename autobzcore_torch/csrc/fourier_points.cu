// K1: evaluation of a Fourier series at scattered points, in FP64.
//
// Replaces autobzcore_tpu/ops/fourier_eval.py:78 evaluate_points (with
// phase_matrix :38 and _batched_contract :97), which XLA lowers to one
// (K, n_d) x (n_1..n_d, V) matmul followed by per-point batched
// contractions. This kernel computes, for every point x_k,
//
//   H(x_k)[v] = sum_n c[n, v] exp(2 pi i sum_j (n_j + o_j) x_kj / t_j)
//
// with the same conventions: offsets o_j, periods t_j, frequencies
// f_j = o_j + 0..n_j-1, coefficients c[(n_1..n_d), V] in C order.
//
// What bounds it on an H100: each (point, coefficient row) pair costs V
// complex multiply-adds (4V FP64 FMAs) plus one phase. At the flagship shape
// (K = 1e6 points, 125 rows, V = 9) that is ~9e9 FP64 flops against 144 MB
// of output, so FP64 arithmetic, not memory, is the limit, and a sincos per
// pair would cost more than the multiply-adds.
//
// What the design does about it:
//  * one thread per point; phases are made in registers. sincospi runs once
//    per innermost row of coefficients, and the remaining phases of the row
//    follow by one complex multiply with exp(2 pi i x_d / t_d) each (at most
//    n_d - 1 steps, so the recurrence error stays near n_d ulp);
//  * coefficients are staged through shared memory in tiles of kTileRows
//    rows x kValChunk values, so the kernel does not assume the whole tensor
//    fits (an 11^3 Wannier box with m = 3 is 191 KB; larger models exceed the
//    227 KB a block may hold). Every thread of a warp reads the same tile
//    entry, which shared memory broadcasts without bank conflicts;
//  * value entries beyond kValChunk (m > 3) are done in further passes over
//    the coefficients, keeping the accumulators in registers.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = 64;  // flattened coefficient rows per shared tile
constexpr int kValChunk = 9;   // complex accumulators per thread (m*m at m = 3)

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Slots 0..2 hold the spatial dimensions right-aligned: for d < 3 the leading
// slots have one frequency (n = 1, o = 0) and coordinate 0.
__global__ void __launch_bounds__(kThreads)
fourier_points_kernel(const double2* __restrict__ c, const double* __restrict__ X,
                      double2* __restrict__ out, int64_t K, int d, int n0, int n1,
                      int n2, int o0, int o1, int o2, double inv_t0, double inv_t1,
                      double inv_t2, int V) {
  __shared__ double2 tile[kTileRows * kValChunk];
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = k < K;

  double u0 = 0.0, u1 = 0.0, u2 = 0.0;  // x_j / t_j per slot
  if (live) {
    const double* xk = X + k * d;
    if (d == 3) {
      u0 = xk[0] * inv_t0;
      u1 = xk[1] * inv_t1;
      u2 = xk[2] * inv_t2;
    } else if (d == 2) {
      u1 = xk[0] * inv_t1;
      u2 = xk[1] * inv_t2;
    } else {
      u2 = xk[0] * inv_t2;
    }
  }
  double s, co;
  sincospi(2.0 * u2, &s, &co);
  const double2 step = make_double2(co, s);  // phase ratio of adjacent innermost rows

  const int N = n0 * n1 * n2;
  for (int v0 = 0; v0 < V; v0 += kValChunk) {
    const int nv = min(kValChunk, V - v0);
    double2 acc[kValChunk];
#pragma unroll
    for (int v = 0; v < kValChunk; ++v) acc[v] = make_double2(0.0, 0.0);
    double2 ph = make_double2(1.0, 0.0);

    for (int r0 = 0; r0 < N; r0 += kTileRows) {
      const int nr = min(kTileRows, N - r0);
      __syncthreads();
      for (int i = threadIdx.x; i < nr * nv; i += blockDim.x) {
        const int r = i / nv;
        const int v = i - r * nv;
        tile[r * kValChunk + v] = c[static_cast<int64_t>(r0 + r) * V + v0 + v];
      }
      __syncthreads();
      if (!live) continue;
      for (int r = 0; r < nr; ++r) {
        const int n = r0 + r;
        const int i2 = n % n2;
        if (i2 == 0 || r == 0) {
          const int i01 = n / n2;
          const int i1 = i01 % n1;
          const int i0 = i01 / n1;
          const double a = 2.0 * ((i0 + o0) * u0 + (i1 + o1) * u1 + (i2 + o2) * u2);
          sincospi(a, &s, &co);
          ph = make_double2(co, s);
        } else {
          ph = cmul(ph, step);
        }
        const double2* row = tile + r * kValChunk;
#pragma unroll
        for (int v = 0; v < kValChunk; ++v) {
          if (v < nv) {
            const double2 cv = row[v];
            acc[v].x = fma(ph.x, cv.x, fma(-ph.y, cv.y, acc[v].x));
            acc[v].y = fma(ph.x, cv.y, fma(ph.y, cv.x, acc[v].y));
          }
        }
      }
    }
    if (live) {
      double2* ok = out + k * V + v0;
#pragma unroll
      for (int v = 0; v < kValChunk; ++v)
        if (v < nv) ok[v] = acc[v];
    }
  }
}

}  // namespace

// c: (n0*n1*n2, V) complex128 as double2; X: (K, d) float64; out: (K, V)
// complex128. Returns cudaGetLastError() after the launch.
extern "C" int fourier_points_launch(const void* c, const void* X, void* out, long long K,
                                     int d, int n0, int n1, int n2, int o0, int o1, int o2,
                                     double t0, double t1, double t2, int V, void* stream) {
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((K + kThreads - 1) / kThreads);
  fourier_points_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(c), static_cast<const double*>(X),
      static_cast<double2*>(out), static_cast<int64_t>(K), d, n0, n1, n2, o0, o1, o2,
      1.0 / t0, 1.0 / t1, 1.0 / t2, V);
  return static_cast<int>(cudaGetLastError());
}
