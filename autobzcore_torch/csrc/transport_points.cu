// K31: the Kubo-Greenwood transport distribution at points, in FP64.
//
// Replaces autobzcore_tpu/models/observables.py:175-188
// (transport_distribution) where an adaptive solve evaluates it at its
// nodes: an IAI leaf trip or a TAI trip hands over N points at once. For
// eigenpairs (e, U) of H at each point (U's column n the eigenvector of
// band n), gradients dH (N, d, m, m), frequencies om and broadenings eta
// (N,) it writes
//
//   v_a       = U^H dH_a U                          (band-basis velocities),
//   A_n       = eta / ((om - e_n)^2 + eta^2) / pi,
//   G[p, a, b] = Re sum_nq v_a[n, q] conj(v_b[n, q]) A_n A_q      (N, d, d),
//
// K18's band-basis body (velocity_pairs.cu) with the spectral weights of
// K19 (transport_gamma.cu) and no pair matrix and no k-sum.
//
// What bounds it on an H100: a point reads e, U and dH (8 m + 16 m^2 (1 +
// d) bytes) and writes d^2 doubles against about 16 d m^3 FP64 operations
// for the band basis: at m = 3, d = 2 that is 456 B against ~900
// operations, so the bytes bound it; an IAI leaf trip of some thousand
// points is far below a launch's cost.
//
// The design, the simple one: one thread per point holds U and the d
// band-basis velocities (template arguments M <= 8 and D <= 3; unrolled in
// registers up to m = 4, rolled loops over local memory above); dH is read
// from global memory column by column. G is symmetric in (a, b) exactly, so a <= b is
// summed and mirrored. The sums run in a fixed order, so repeats are
// bit-identical.
//
// The fused entry (transport_points_eigh_launch), m <= 3: the whole of
// transport_distribution at points, the jnp.linalg.eigh at
// autobzcore_tpu/models/observables.py:184 included, which the card
// otherwise ran as a cuSOLVER batched eigh before the entry above. It takes H
// (N, m, m) and dH (N, d, m, m) as views of K11's output, with their
// strides, and om and eta each as one value or one a point (a pointer with
// stride 0 or 1, or a number), so a trip allocates only its output. Each
// thread reads H's Hermitian part, runs the register eigensolver
// (csrc/small_eigen.cuh eigh_rn), forms the band-basis velocities of dH_a's
// Hermitian part (v_a = U^H S_a U, Hermitian: its diagonal and upper
// triangle) and the A_n, and sums G over the diagonal and twice the upper
// pairs. G is invariant under any unitary change of basis inside a
// degenerate subspace, so it does not depend on which eigenbasis the solver
// returns. A trip of some thousand points is bound by the launch; a point
// reads 16 m^2 (1 + d) bytes, 432 at m = 2, d = 2.

#include <cuda_runtime.h>

#include <cstdint>

#include "small_eigen.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBands = 8;

template <int M, int D>
__global__ void __launch_bounds__(kThreads)
transport_points_kernel(const double* __restrict__ e, const double2* __restrict__ U,
                        const double2* __restrict__ dH, const double* __restrict__ om,
                        const double* __restrict__ eta, double* __restrict__ out, int64_t N, int64_t sk,
                        int64_t sj, double inv_pi) {
  // unrolled loops keep U and v in registers up to four bands; above, the
  // loops stay rolled and the arrays sit in local memory, which bounds the
  // build and the spills
  constexpr int kUnroll = M <= 4 ? 64 : 1;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= N) return;
  double2 u[M * M];
#pragma unroll kUnroll
  for (int i = 0; i < M * M; ++i) u[i] = U[p * M * M + i];
  double2 v[D][M * M];
#pragma unroll kUnroll
  for (int a = 0; a < D; ++a) {
    const double2* Ha = dH + p * sk + a * sj;
#pragma unroll kUnroll
    for (int q = 0; q < M; ++q) {
      double2 t[M];  // (dH_a U)[:, q]
#pragma unroll kUnroll
      for (int i = 0; i < M; ++i) {
        double tx = 0.0, ty = 0.0;
#pragma unroll kUnroll
        for (int j = 0; j < M; ++j) {
          const double2 h = __ldg(Ha + i * M + j);
          const double2 uj = u[j * M + q];
          tx += h.x * uj.x - h.y * uj.y;
          ty += h.x * uj.y + h.y * uj.x;
        }
        t[i] = make_double2(tx, ty);
      }
#pragma unroll kUnroll
      for (int n = 0; n < M; ++n) {
        double vx = 0.0, vy = 0.0;  // sum_i conj(U[i, n]) t[i]
#pragma unroll kUnroll
        for (int i = 0; i < M; ++i) {
          const double2 ui = u[i * M + n];
          vx += ui.x * t[i].x + ui.y * t[i].y;
          vy += ui.x * t[i].y - ui.y * t[i].x;
        }
        v[a][n * M + q] = make_double2(vx, vy);
      }
    }
  }
  const double w = om[p], g = eta[p];
  double A[M];
#pragma unroll kUnroll
  for (int n = 0; n < M; ++n) {
    const double x = w - e[p * M + n];
    A[n] = g / (x * x + g * g) * inv_pi;
  }
  double* o = out + p * D * D;
#pragma unroll kUnroll
  for (int a = 0; a < D; ++a) {
#pragma unroll kUnroll
    for (int b = a; b < D; ++b) {
      double acc = 0.0;
#pragma unroll kUnroll
      for (int n = 0; n < M; ++n) {
        double row = 0.0;
#pragma unroll kUnroll
        for (int q = 0; q < M; ++q) {
          const double2 x = v[a][n * M + q], y = v[b][n * M + q];
          row += (x.x * y.x + x.y * y.y) * A[q];
        }
        acc += row * A[n];
      }
      o[a * D + b] = acc;
      o[b * D + a] = acc;
    }
  }
}

template <int M>
void launch_m(int d, unsigned blocks, cudaStream_t st, const double* e, const double2* U, const double2* dH,
              const double* om, const double* eta, double* out, int64_t N, int64_t sk, int64_t sj,
              double inv_pi) {
  if (d == 1) {
    transport_points_kernel<M, 1><<<blocks, kThreads, 0, st>>>(e, U, dH, om, eta, out, N, sk, sj, inv_pi);
  } else if (d == 2) {
    transport_points_kernel<M, 2><<<blocks, kThreads, 0, st>>>(e, U, dH, om, eta, out, N, sk, sj, inv_pi);
  } else {
    transport_points_kernel<M, 3><<<blocks, kThreads, 0, st>>>(e, U, dH, om, eta, out, N, sk, sj, inv_pi);
  }
}

template <int M, int D>
__global__ void __launch_bounds__(kThreads)
transport_points_eigh_kernel(const double2* __restrict__ H, int64_t sh, const double2* __restrict__ dH, int64_t sk,
                             int64_t sj, const double* __restrict__ om, int64_t som, double om0,
                             const double* __restrict__ eta, int64_t seta, double eta0, double* __restrict__ out,
                             int64_t N, double inv_pi) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= N) return;
  double d[3], orr[3], oi[3], e[3], ur[3][3], ui[3][3];
  autobz::load_hermitian<M>(H + p * sh, d, orr, oi);
  autobz::eigh_rn<M>(d, orr, oi, e, ur, ui);
  // band-basis velocities of S_a, the Hermitian part of dH_a: the real
  // diagonal vd[a][n] and the upper entries (vr + i vi)[a][k], k over n < q
  constexpr int kUpper = M * (M - 1) / 2 > 0 ? M * (M - 1) / 2 : 1;
  double vd[D][3], vr[D][kUpper], vi[D][kUpper];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    double sd[3], sr[3], si[3];
    autobz::load_hermitian<M>(dH + p * sk + a * sj, sd, sr, si);
    // T = S_a U, S_a's lower entries the conjugates of its upper ones
    double tr[3][3], ti[3][3];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int q = 0; q < M; ++q) {
        double xr = sd[i] * ur[i][q], xi = sd[i] * ui[i][q];
#pragma unroll
        for (int l = 0; l < M; ++l) {
          if (l == i) continue;
          const int k = i < l ? (i == 0 ? l - 1 : 2) : (l == 0 ? i - 1 : 2);  // (0,1) 0, (0,2) 1, (1,2) 2
          const double hr = sr[k], hi = i < l ? si[k] : -si[k];
          xr = fma(hr, ur[l][q], fma(-hi, ui[l][q], xr));
          xi = fma(hr, ui[l][q], fma(hi, ur[l][q], xi));
        }
        tr[i][q] = xr;
        ti[i][q] = xi;
      }
    }
    // v[n][q] = sum_i conj(u_in) T[i][q] for n <= q
    int k = 0;
#pragma unroll
    for (int n = 0; n < M; ++n) {
#pragma unroll
      for (int q = n; q < M; ++q) {
        double xr = 0.0, xi = 0.0;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          xr = fma(ur[i][n], tr[i][q], fma(ui[i][n], ti[i][q], xr));
          xi = fma(ur[i][n], ti[i][q], fma(-ui[i][n], tr[i][q], xi));
        }
        if (q == n) {
          vd[a][n] = xr;
        } else {
          vr[a][k] = xr;
          vi[a][k] = xi;
          ++k;
        }
      }
    }
  }
  const double w = om != nullptr ? om[p * som] : om0;
  const double g = eta != nullptr ? eta[p * seta] : eta0;
  double A[3];
#pragma unroll
  for (int n = 0; n < M; ++n) {
    const double x = w - e[n];
    A[n] = g / (x * x + g * g) * inv_pi;
  }
  double* o = out + p * D * D;
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = a; b < D; ++b) {
      double acc = 0.0;
      int k = 0;
#pragma unroll
      for (int n = 0; n < M; ++n) {
        double row = vd[a][n] * vd[b][n] * A[n];
        double up = 0.0;
#pragma unroll
        for (int q = n + 1; q < M; ++q, ++k) up = fma(fma(vr[a][k], vr[b][k], vi[a][k] * vi[b][k]), A[q], up);
        row = fma(2.0, up, row);
        acc = fma(row, A[n], acc);
      }
      o[a * D + b] = acc;
      o[b * D + a] = acc;
    }
  }
}

template <int M>
void launch_eigh(int d, unsigned blocks, cudaStream_t st, const double2* H, int64_t sh, const double2* dH,
                 int64_t sk, int64_t sj, const double* om, int64_t som, double om0, const double* eta, int64_t seta,
                 double eta0, double* out, int64_t N, double inv_pi) {
  if (d == 1) {
    transport_points_eigh_kernel<M, 1><<<blocks, kThreads, 0, st>>>(H, sh, dH, sk, sj, om, som, om0, eta, seta,
                                                                     eta0, out, N, inv_pi);
  } else if (d == 2) {
    transport_points_eigh_kernel<M, 2><<<blocks, kThreads, 0, st>>>(H, sh, dH, sk, sj, om, som, om0, eta, seta,
                                                                     eta0, out, N, inv_pi);
  } else {
    transport_points_eigh_kernel<M, 3><<<blocks, kThreads, 0, st>>>(H, sh, dH, sk, sj, om, som, om0, eta, seta,
                                                                     eta0, out, N, inv_pi);
  }
}

}  // namespace

// The largest band count K31 takes.
extern "C" int transport_points_max_bands() { return kMaxBands; }

// e: (N, m) float64; U: (N, m, m) complex128, contiguous; dH: complex128
// with the (m, m) block of (point p, direction a) at dH + p * sk + a * sj
// (complex entries), its entries contiguous; om, eta: (N,) float64; out:
// (N, d, d) float64, written. Returns cudaErrorInvalidValue for m outside
// 1..transport_points_max_bands() or d outside 1..3, else
// cudaGetLastError() after the launch.
extern "C" int transport_points_launch(const void* e, const void* U, const void* dH, const void* om,
                                       const void* eta, void* out, long long N, int m, int d, long long sk,
                                       long long sj, double inv_pi, void* stream) {
  if (m < 1 || m > kMaxBands || d < 1 || d > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((N + kThreads - 1) / kThreads);
  const auto* ep = static_cast<const double*>(e);
  const auto* Up = static_cast<const double2*>(U);
  const auto* Hp = static_cast<const double2*>(dH);
  const auto* wp = static_cast<const double*>(om);
  const auto* gp = static_cast<const double*>(eta);
  auto* op = static_cast<double*>(out);
  const int64_t n = static_cast<int64_t>(N);
  switch (m) {
    case 1: launch_m<1>(d, blocks, st, ep, Up, Hp, wp, gp, op, n, sk, sj, inv_pi); break;
    case 2: launch_m<2>(d, blocks, st, ep, Up, Hp, wp, gp, op, n, sk, sj, inv_pi); break;
    case 3: launch_m<3>(d, blocks, st, ep, Up, Hp, wp, gp, op, n, sk, sj, inv_pi); break;
    case 4: launch_m<4>(d, blocks, st, ep, Up, Hp, wp, gp, op, n, sk, sj, inv_pi); break;
    case 5: launch_m<5>(d, blocks, st, ep, Up, Hp, wp, gp, op, n, sk, sj, inv_pi); break;
    case 6: launch_m<6>(d, blocks, st, ep, Up, Hp, wp, gp, op, n, sk, sj, inv_pi); break;
    case 7: launch_m<7>(d, blocks, st, ep, Up, Hp, wp, gp, op, n, sk, sj, inv_pi); break;
    default: launch_m<8>(d, blocks, st, ep, Up, Hp, wp, gp, op, n, sk, sj, inv_pi); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// H: complex128, the (m, m) block of point p at H + p * sh, its entries
// contiguous; dH: complex128, the block of (point p, direction a) at dH + p *
// sk + a * sj (complex entries); om, eta: float64 at om + p * som (stride 0
// for one value), or null and then om0 (eta0) for every point; out: (N, d,
// d) float64, written. Returns cudaErrorInvalidValue for m or d outside
// 1..3, else cudaGetLastError() after the launch.
extern "C" int transport_points_eigh_launch(const void* H, long long sh, const void* dH, long long sk, long long sj,
                                            const void* om, long long som, double om0, const void* eta,
                                            long long seta, double eta0, void* out, long long N, int m, int d,
                                            double inv_pi, void* stream) {
  if (m < 1 || m > 3 || d < 1 || d > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((N + kThreads - 1) / kThreads);
  const auto* Hp = static_cast<const double2*>(H);
  const auto* dp = static_cast<const double2*>(dH);
  const auto* wp = static_cast<const double*>(om);
  const auto* gp = static_cast<const double*>(eta);
  auto* op = static_cast<double*>(out);
  const int64_t n = static_cast<int64_t>(N);
  if (m == 1) {
    launch_eigh<1>(d, blocks, st, Hp, sh, dp, sk, sj, wp, som, om0, gp, seta, eta0, op, n, inv_pi);
  } else if (m == 2) {
    launch_eigh<2>(d, blocks, st, Hp, sh, dp, sk, sj, wp, som, om0, gp, seta, eta0, op, n, inv_pi);
  } else {
    launch_eigh<3>(d, blocks, st, Hp, sh, dp, sk, sj, wp, som, om0, gp, seta, eta0, op, n, inv_pi);
  }
  return static_cast<int>(cudaGetLastError());
}
