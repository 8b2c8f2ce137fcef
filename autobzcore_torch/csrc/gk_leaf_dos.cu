// K4: the innermost level of a nested Gauss-Kronrod DOS solve, fused, in
// FP64.
//
// Replaces, at the leaf of autobzcore_tpu/algorithms/nested.py:445-517
// (solve_level with d_rem == 1), the chain of
//   * autobzcore_tpu/fourier.py:394-410 FourierCarrier.eval_batch (the 1-D
//     series values: phase_matrix at the nodes times the lane's coefficients),
//   * autobzcore_tpu/models/observables.py:149 dos_trace (through :108 and
//     :73 _trace_inv_small) at every node, and
//   * autobzcore_tpu/ops/adaptive.py:72 gk_rule_eval (the K15 and G7 sums,
//     err = |vK - vG|, the L1 estimate, dead-slot masking at :124-139).
// For lane l (a (mid lane, node) pair of the nest) and each of its intervals
// [a, b] it computes, over the Kronrod nodes x_p = mid + half * xk_p,
//
//   H(x_p) = sum_n c[cmap[l], n] exp(2 pi i (o + n) x_p / t)   (m x m),
//   D(x_p) = -Im Tr (om_l + i eta_l - H(x_p))^{-1} / pi,
//   val = half sum_p wk_p D_p,  err = |val - half sum_p wg_p D_p|,
//   l1 = half sum_p wk_p |D_p|,
//
// and the lane's count, I * npts, for live lanes. Zero-width (dead) intervals
// give exactly 0; inactive lanes give zeros and count nothing.
//
// What bounds it on an H100: per node, n complex multiply-adds of m^2 values
// (8 n m^2 flops), two sincospi and the closed-form trace (~200 flops at
// m = 3): ~600 FP64 flops per node, ~9e3 per interval, against reading the
// lane's n m^2 coefficients (720 B at the flagship) and writing 24 B. So FP64
// arithmetic bounds it; node values never reach device memory, which is
// the point of fusing.
//
// What the design does about it:
//  * one thread per (lane, interval); the nodes and weights sit in shared
//    memory; H(x) is accumulated in registers with one sincospi pair per node
//    and a complex-multiply phase recurrence over the n frequencies (at most
//    n - 1 steps, so the recurrence error stays near n ulp);
//  * the closed-form trace is small_trace.cuh's, shared with K2;
//  * a lane map entry outside 0..Lc-1 reads nothing and gives NaN values.
//
// Over an omega block (autobzcore_tpu/models/observables.py:138-144, where z
// carries a leading axis of W frequencies, SweepSolver(block=W)) lane l
// carries W frequencies om[l, :] and broadenings eta[l, :], and each node's
// series value H(x_p) serves every channel:
//
//   val[l, i, w] = half sum_p wk_p D_w(x_p),
//   err = || vK - vG ||_2 over the channels, l1 = || vL ||_2 over them,
//
// the reference's _err_norm of the per-channel sums (ops/adaptive.py:72). One
// frequency per lane is the case W = 1 (err = |vK - vG|, l1 = |vL|).
// Channels go in groups of G <= 8, a template argument, so a group's sums
// stay in registers; a block of up to 8 channels is one group and evaluates
// the series once per node, a wider one re-evaluates it once per group and
// carries the squared norms across groups. The per-node trace is
// small_trace.cuh's per-z form, once per channel: ~200 flops at m = 3 beside
// the shared series evaluation.

#include <cuda_runtime.h>

#include <cstdint>

#include "small_trace.cuh"

namespace {

using autobz::cmul;
using autobz::trace_inv_imag;

constexpr int kThreads = 128;
constexpr int kMaxNodes = 64;
constexpr int kMaxGroup = 8;  // frequency channels per group (see the header)

// W channels per lane, in groups of G.
template <int M, int G>
__global__ void __launch_bounds__(kThreads)
gk_leaf_dos_kernel(const double2* __restrict__ c, const int64_t* __restrict__ cmap,
                   const double* __restrict__ ca, const double* __restrict__ cb,
                   const double* __restrict__ om, const double* __restrict__ eta,
                   const bool* __restrict__ active, const double* __restrict__ xk,
                   const double* __restrict__ wk, const double* __restrict__ wg,
                   double* __restrict__ val, double* __restrict__ err, double* __restrict__ l1,
                   double* __restrict__ count, int64_t L, int64_t Lc, int I, int P, int n, int W,
                   int offset, double inv_t, double neg_inv_pi) {
  constexpr int MM = M * M;
  __shared__ double sx[kMaxNodes], swk[kMaxNodes], swg[kMaxNodes];
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    sx[p] = xk[p];
    swk[p] = wk[p];
    swg[p] = wg[p];
  }
  __syncthreads();
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= L * I) return;
  const int64_t l = t / I;
  const int i = static_cast<int>(t - l * I);
  const bool live = active[l];
  if (i == 0) count[l] = live ? static_cast<double>(I) * P : 0.0;
  const double a = ca[t], b = cb[t];
  const double half = (b - a) / 2;
  double* vrow = val + t * W;
  if (!live || half == 0.0) {
    for (int w = 0; w < W; ++w) vrow[w] = 0.0;
    err[t] = 0.0;
    l1[t] = 0.0;
    return;
  }
  const int64_t cm = cmap[l];
  if (cm < 0 || cm >= Lc) {
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    for (int w = 0; w < W; ++w) vrow[w] = nan;
    err[t] = nan;
    l1[t] = nan;
    return;
  }
  const double mid = (a + b) / 2;
  const double2* cl = c + cm * static_cast<int64_t>(n) * MM;
  double e2 = 0.0, l2 = 0.0;
  for (int w0 = 0; w0 < W; w0 += G) {
    const int nw = W - w0 < G ? W - w0 : G;  // channels of this group
    double2 z[G];
    double sk[G], sg[G], sl[G];
#pragma unroll
    for (int w = 0; w < G; ++w) {
      if (w < nw) z[w] = make_double2(om[l * W + w0 + w], eta[l * W + w0 + w]);
      sk[w] = sg[w] = sl[w] = 0.0;
    }
    for (int p = 0; p < P; ++p) {
      const double u = (mid + half * sx[p]) * inv_t;
      double s, co;
      sincospi(2.0 * u, &s, &co);
      const double2 step = make_double2(co, s);
      sincospi(2.0 * (offset * u), &s, &co);
      double2 ph = make_double2(co, s);
      double2 h[MM];
#pragma unroll
      for (int v = 0; v < MM; ++v) h[v] = make_double2(0.0, 0.0);
      for (int f = 0; f < n; ++f) {
        const double2* row = cl + static_cast<int64_t>(f) * MM;
#pragma unroll
        for (int v = 0; v < MM; ++v) {
          const double2 cv = row[v];
          h[v].x = fma(ph.x, cv.x, fma(-ph.y, cv.y, h[v].x));
          h[v].y = fma(ph.x, cv.y, fma(ph.y, cv.x, h[v].y));
        }
        ph = cmul(ph, step);
      }
#pragma unroll
      for (int w = 0; w < G; ++w) {
        if (w < nw) {
          const double d = neg_inv_pi * trace_inv_imag<M>(h, z[w]);
          sk[w] += swk[p] * d;
          sg[w] += swg[p] * d;
          sl[w] += swk[p] * fabs(d);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < G; ++w) {
      if (w < nw) {
        const double vk = sk[w] * half, vg = sg[w] * half, vl = sl[w] * half;
        const double dv = vk - vg;
        vrow[w0 + w] = vk;
        e2 += dv * dv;
        l2 += vl * vl;
      }
    }
  }
  err[t] = sqrt(e2);
  l1[t] = sqrt(l2);
}

struct LeafArgs {
  const double2* c;
  const int64_t* cmap;
  const double *ca, *cb, *om, *eta;
  const bool* active;
  const double *xk, *wk, *wg;
  double *val, *err, *l1, *count;
  int64_t L, Lc;
  int I, P, n, W, offset;
  double inv_t, neg_inv_pi;
};

template <int M, int G>
void launch(unsigned blocks, cudaStream_t st, const LeafArgs& q) {
  gk_leaf_dos_kernel<M, G><<<blocks, kThreads, 0, st>>>(
      q.c, q.cmap, q.ca, q.cb, q.om, q.eta, q.active, q.xk, q.wk, q.wg, q.val, q.err, q.l1,
      q.count, q.L, q.Lc, q.I, q.P, q.n, q.W, q.offset, q.inv_t, q.neg_inv_pi);
}

// one group of all W channels up to kMaxGroup, groups of kMaxGroup above
template <int M>
void dispatch(unsigned blocks, cudaStream_t st, const LeafArgs& q) {
  switch (q.W < kMaxGroup ? q.W : kMaxGroup) {
    case 1: launch<M, 1>(blocks, st, q); break;
    case 2: launch<M, 2>(blocks, st, q); break;
    case 3: launch<M, 3>(blocks, st, q); break;
    case 4: launch<M, 4>(blocks, st, q); break;
    case 5: launch<M, 5>(blocks, st, q); break;
    case 6: launch<M, 6>(blocks, st, q); break;
    case 7: launch<M, 7>(blocks, st, q); break;
    default: launch<M, kMaxGroup>(blocks, st, q); break;
  }
}

}  // namespace

// c: (Lc, n, m*m) complex128 as double2; cmap: (L,) int64 into Lc; ca, cb:
// (L, I); om, eta: (L, W); active: (L,) bool; xk, wk, wg: (P,); val: (L, I,
// W); err, l1: (L, I); count: (L,). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for m outside 1..3, W < 1 or more than
// kMaxNodes nodes.
extern "C" int gk_leaf_dos_launch(const void* c, const void* cmap, const void* ca, const void* cb,
                                  const void* om, const void* eta, const void* active,
                                  const void* xk, const void* wk, const void* wg, void* val,
                                  void* err, void* l1, void* count, long long L, long long Lc,
                                  int I, int P, int n, int m, int W, int offset, double period,
                                  void* stream) {
  if (m < 1 || m > 3 || P < 1 || P > kMaxNodes || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L <= 0 || I <= 0) return static_cast<int>(cudaGetLastError());
  const long long threads = L * I;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LeafArgs q{static_cast<const double2*>(c), static_cast<const int64_t*>(cmap),
                   static_cast<const double*>(ca), static_cast<const double*>(cb),
                   static_cast<const double*>(om), static_cast<const double*>(eta),
                   static_cast<const bool*>(active), static_cast<const double*>(xk),
                   static_cast<const double*>(wk), static_cast<const double*>(wg),
                   static_cast<double*>(val), static_cast<double*>(err), static_cast<double*>(l1),
                   static_cast<double*>(count), L, Lc, I, P, n, W, offset, 1.0 / period,
                   -0.31830988618379067154 /* -1/pi */};
  if (m == 1) {
    dispatch<1>(blocks, st, q);
  } else if (m == 2) {
    dispatch<2>(blocks, st, q);
  } else {
    dispatch<3>(blocks, st, q);
  }
  return static_cast<int>(cudaGetLastError());
}
