// K1 and K11: evaluation of a Fourier series, and of its derivatives, at
// scattered points, in FP64.
//
// K1 replaces autobzcore_tpu/ops/fourier_eval.py:78 evaluate_points (with
// phase_matrix :38 and _batched_contract :97), which XLA lowers to one
// (K, n_d) x (n_1..n_d, V) matmul followed by per-point batched
// contractions. K11 replaces the derivative form of the same function and
// :115 evaluate_points_jacobian, which XLA runs as d + 1 such evaluations
// with the phase matrices scaled by (2 pi i f_j)^k_j. For every point x_k and
// each of R <= 4 derivative orders (k_r1..k_rd) this file computes
//
//   out[k, r, v] = sum_n c[n, v] prod_j (2 pi i f_j)^k_rj
//                                exp(2 pi i sum_j f_j x_kj / t_j)
//
// with the reference's conventions: offsets o_j, periods t_j, frequencies
// f_j = o_j + 0..n_j-1, coefficients c[(n_1..n_d), V] in C order, and
// derivatives taken with respect to z_j = x_j / t_j. K1 is the case R = 1 at
// order zero.
//
// What bounds it on an H100: each (point, coefficient row) pair costs R x V
// complex multiply-adds (4 R V FP64 FMAs) plus one phase. At the flagship
// shape (K = 1e6 points, 125 rows, V = 9) that is ~9e9 FP64 flops for K1 and
// ~3.6e10 for the Jacobian (R = 4) against 144 MB (576 MB) of output, so FP64
// arithmetic, not memory, is the limit, and a sincos per pair would cost more
// than the multiply-adds.
//
// What the design does about it:
//  * one thread per point; phases are made in registers. sincospi runs once
//    per innermost row of coefficients, and the remaining phases of the row
//    follow by one complex multiply with exp(2 pi i x_d / t_d) each (at most
//    n_d - 1 steps, so the recurrence error stays near n_d ulp);
//  * a derivative scales the row's phase: q_r = S_r i^(sum_j k_rj) phase
//    with the real S_r = prod_j (2 pi f_j)^k_rj, made once per row and
//    output, so each (row, value, output) costs the same four FMAs as K1's
//    (row, value). At order zero S_r = 1 and q_r is the phase itself, bit
//    for bit;
//  * coefficients are staged through shared memory in tiles of kTileRows
//    rows x VC values, so the kernel does not assume the whole tensor fits
//    (an 11^3 Wannier box with m = 3 is 191 KB; larger models exceed the
//    227 KB a block may hold). Every thread of a warp reads the same tile
//    entry, which shared memory broadcasts without bank conflicts;
//  * value entries are taken VC at a time, keeping the R x VC accumulators
//    in registers: blockIdx.y picks the block's chunk of VC values (and
//    loops over further chunks beyond 65535 of them), so that a wide value
//    (V = 900 at 30 bands: 300 chunks at R = 4) fills the card with blocks
//    even at a few thousand points. VC is 9 for K1 and shrinks as R grows
//    (6, 6, 4, 3 for R = 1..4 with derivatives), so that the accumulators
//    stay at 12-24 doubles a thread and ptxas spills none at
//    __launch_bounds__(128) (at R = 1, VC = 9 spilled 16 bytes). Each value's sum runs
//    over the rows in the same order whatever VC and the grid, so the
//    chunking does not change a bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = 64;  // flattened coefficient rows per shared tile
constexpr int kMaxOut = 4;     // derivative orders per launch (the Jacobian in 3-D)
constexpr double kTwoPi = 6.283185307179586;  // 2 pi, as numpy's 2 * np.pi

// Derivative orders per output, in the three right-aligned slots.
struct Orders {
  int k[kMaxOut][3];
};

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// S i^p ph for p in 0..3.
__device__ __forceinline__ double2 scale_rotate(double2 ph, double S, int p) {
  switch (p & 3) {
    case 0: return make_double2(S * ph.x, S * ph.y);
    case 1: return make_double2(-S * ph.y, S * ph.x);
    case 2: return make_double2(-S * ph.x, -S * ph.y);
    default: return make_double2(S * ph.y, -S * ph.x);
  }
}

// Slots 0..2 hold the spatial dimensions right-aligned: for d < 3 the leading
// slots have one frequency (n = 1, o = 0), coordinate 0 and order 0.
// out is (K, R, V). kDeriv = false is K1: R = 1 at order zero, no scaling.
template <int R, int VC, bool kDeriv>
__global__ void __launch_bounds__(kThreads)
fourier_points_kernel(const double2* __restrict__ c, const double* __restrict__ X,
                      double2* __restrict__ out, int64_t K, int d, int n0, int n1,
                      int n2, int o0, int o1, int o2, double inv_t0, double inv_t1,
                      double inv_t2, int V, Orders ord) {
  __shared__ double2 tile[kTileRows * VC];
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
  int rot[R];  // the power of i of each output
#pragma unroll
  for (int r = 0; r < R; ++r) rot[r] = ord.k[r][0] + ord.k[r][1] + ord.k[r][2];

  const int N = n0 * n1 * n2;
  for (int v0 = blockIdx.y * VC; v0 < V; v0 += gridDim.y * VC) {
    const int nv = min(VC, V - v0);
    double2 acc[R][VC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < VC; ++v) acc[r][v] = make_double2(0.0, 0.0);
    double2 ph = make_double2(1.0, 0.0);
    int i0 = 0, i1 = 0;  // the outer slots' indices, set where a row of n2 starts

    for (int r0 = 0; r0 < N; r0 += kTileRows) {
      const int nr = min(kTileRows, N - r0);
      __syncthreads();
      for (int i = threadIdx.x; i < nr * nv; i += blockDim.x) {
        const int r = i / nv;
        const int v = i - r * nv;
        tile[r * VC + v] = c[static_cast<int64_t>(r0 + r) * V + v0 + v];
      }
      __syncthreads();
      if (!live) continue;
      for (int r = 0; r < nr; ++r) {
        const int n = r0 + r;
        const int i2 = n % n2;
        if (i2 == 0 || r == 0) {
          const int i01 = n / n2;
          i1 = i01 % n1;
          i0 = i01 / n1;
          const double a = 2.0 * ((i0 + o0) * u0 + (i1 + o1) * u1 + (i2 + o2) * u2);
          sincospi(a, &s, &co);
          ph = make_double2(co, s);
        } else {
          ph = cmul(ph, step);
        }
        double2 q[R];
        if constexpr (kDeriv) {
          const double tf0 = kTwoPi * (i0 + o0), tf1 = kTwoPi * (i1 + o1), tf2 = kTwoPi * (i2 + o2);
#pragma unroll
          for (int o = 0; o < R; ++o) {
            double S = 1.0;
            for (int t = 0; t < ord.k[o][0]; ++t) S *= tf0;
            for (int t = 0; t < ord.k[o][1]; ++t) S *= tf1;
            for (int t = 0; t < ord.k[o][2]; ++t) S *= tf2;
            q[o] = scale_rotate(ph, S, rot[o]);
          }
        } else {
          q[0] = ph;
        }
        const double2* row = tile + r * VC;
#pragma unroll
        for (int v = 0; v < VC; ++v) {
          if (v < nv) {
            const double2 cv = row[v];
#pragma unroll
            for (int o = 0; o < R; ++o) {
              acc[o][v].x = fma(q[o].x, cv.x, fma(-q[o].y, cv.y, acc[o][v].x));
              acc[o][v].y = fma(q[o].x, cv.y, fma(q[o].y, cv.x, acc[o][v].y));
            }
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int o = 0; o < R; ++o) {
        double2* ok = out + (k * R + o) * V + v0;
#pragma unroll
        for (int v = 0; v < VC; ++v)
          if (v < nv) ok[v] = acc[o][v];
      }
    }
  }
}

template <int R, int VC, bool kDeriv>
int launch(const void* c, const void* X, void* out, long long K, int d, int n0, int n1, int n2,
           int o0, int o1, int o2, double t0, double t1, double t2, int V, const Orders& ord,
           void* stream) {
  if (K <= 0 || V <= 0) return static_cast<int>(cudaGetLastError());
  const int chunks = (V + VC - 1) / VC;
  const dim3 blocks(static_cast<unsigned>((K + kThreads - 1) / kThreads),
                    static_cast<unsigned>(chunks < 65535 ? chunks : 65535));
  fourier_points_kernel<R, VC, kDeriv><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(c), static_cast<const double*>(X),
      static_cast<double2*>(out), static_cast<int64_t>(K), d, n0, n1, n2, o0, o1, o2,
      1.0 / t0, 1.0 / t1, 1.0 / t2, V, ord);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. c: (n0*n1*n2, V) complex128 as double2; X: (K, d) float64; out: (K, V)
// complex128. Returns cudaGetLastError() after the launch.
extern "C" int fourier_points_launch(const void* c, const void* X, void* out, long long K,
                                     int d, int n0, int n1, int n2, int o0, int o1, int o2,
                                     double t0, double t1, double t2, int V, void* stream) {
  const Orders zero = {};
  return launch<1, 9, false>(c, X, out, K, d, n0, n1, n2, o0, o1, o2, t0, t1, t2, V, zero,
                             stream);
}

// K11. As K1, with R (1..4) derivative orders: orders holds R x d
// non-negative ints, output r's order along spatial dimension j at
// orders[r * d + j]; out: (K, R, V) complex128. Returns cudaErrorInvalidValue
// for R or d out of range or a negative order, else cudaGetLastError()
// after the launch.
extern "C" int fourier_points_derivs_launch(const void* c, const void* X, void* out, long long K,
                                            int d, int n0, int n1, int n2, int o0, int o1, int o2,
                                            double t0, double t1, double t2, int V, int R,
                                            const int* orders, void* stream) {
  if (R < 1 || R > kMaxOut || d < 1 || d > 3) return static_cast<int>(cudaErrorInvalidValue);
  Orders ord = {};
  for (int r = 0; r < R; ++r) {
    for (int j = 0; j < d; ++j) {
      const int kj = orders[r * d + j];
      if (kj < 0) return static_cast<int>(cudaErrorInvalidValue);
      ord.k[r][3 - d + j] = kj;
    }
  }
  switch (R) {
    case 1:
      return launch<1, 6, true>(c, X, out, K, d, n0, n1, n2, o0, o1, o2, t0, t1, t2, V, ord, stream);
    case 2:
      return launch<2, 6, true>(c, X, out, K, d, n0, n1, n2, o0, o1, o2, t0, t1, t2, V, ord, stream);
    case 3:
      return launch<3, 4, true>(c, X, out, K, d, n0, n1, n2, o0, o1, o2, t0, t1, t2, V, ord, stream);
    default:
      return launch<4, 3, true>(c, X, out, K, d, n0, n1, n2, o0, o1, o2, t0, t1, t2, V, ord, stream);
  }
}
