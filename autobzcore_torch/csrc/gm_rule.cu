// K14 and K15: the degree-7(5) Genz-Malik box rule, in FP64.
//
// Replaces autobzcore_tpu/ops/genz_malik.py:93 gm_box_eval's reduction
// (:103-148): for each box with node values f_p (p < P, the rule's nodes
// centre + half * pts_p) and volume vol = prod(2 half),
//
//   val7 = (sum_p wk_p f_p) vol,  val5 = (sum_p we_p f_p) vol,
//   err = || val7 - val5 ||_2 over the value's channels,
//   dd_i = (f[+l2 e_i] + f[-l2 e_i] - 2 f[0]) - r (f[+l3 e_i] + f[-l3 e_i] - 2 f[0]),
//   splitdim = argmax_i sum_channels |dd_i|^2   (the first index on a tie,
//              the first NaN where there is one, as jnp.argmax),
//
// with r = (l2 / l3)^2, and zero-volume (dead) boxes' val and err set to
// exactly 0 by a select (their nodes all sit at the origin, where the
// integrand may be NaN, and NaN * 0 is NaN; :115-127). Their splitdim is
// computed as the reference computes it.
//
//  * K14 gm_rule_reduce takes node values the caller computed: fx (B, P, V)
//    float64, or V complex values as (re, im) pairs.
//  * K15 gm_leaf_dos fuses B3 (autobzcore_tpu/models/observables.py:149
//    dos_trace, D = -Im Tr (om + i eta - H)^{-1} / pi) at the nodes into the
//    rule: it takes H (B, P, m, m) complex128 from K1 and W frequencies and
//    broadenings per box, and the node values never reach device memory. The
//    trace is small_trace.cuh's closed form (K2, K4), for m <= 3, with its
//    rounded arithmetic.
//
// What bounds it on an H100: per box K14 reads P V doubles (264 B at P = 33,
// V = 1) and does ~4 P V flops, so bytes bound it, and at the box pool's
// widths (a few hundred boxes a trip) launch latency. K15 reads P m^2
// complex values (4.75 KB a box at m = 3) and does ~120 flops of trace per
// node and channel: bytes again, and launch latency at these widths.
//
// What the design does about it:
//  * K14 takes one thread per box, K15 one block per box with a thread per
//    node filling a shared-memory row of traces; one thread then reduces the
//    box in a fixed order (nodes, then channels), so repeats are
//    bit-identical;
//  * every operation that reaches the pool (the node sums in node order, the
//    fourth differences, K15's trace) uses round-to-nearest intrinsics, never
//    a fused multiply-add, in the order of the plain versions' separate
//    tensor operations: kernel and plain version give the same bits, so a
//    solve on the kernels refines the same boxes as one on the plain
//    versions (errors that tie within rounding would otherwise pick other
//    boxes), and splitdim follows the plain version wherever two dimensions
//    tie exactly (symmetric integrands do).

#include <cuda_runtime.h>

#include <cstdint>

#include "small_trace.cuh"

namespace {

using autobz::RoundedOps;
using autobz::trace_inv_imag;

constexpr int kReduceThreads = 128;
constexpr int kLeafThreads = 128;  // threads per box in K15: one per node

// |x|^2 as the plain version computes it: abs(x) ** 2 (hypot for a complex value)
__device__ __forceinline__ double abs2(double re, double im, int is_complex) {
  const double a = is_complex ? hypot(re, im) : fabs(re);
  return __dmul_rn(a, a);
}

// One box: f holds the box's P node rows of W doubles (V values, complex ones
// as W = 2 V (re, im) pairs). Writes val[0..W), *err and *sd.
__device__ void box_rule(const double* f, int P, int V, int is_complex, double vol,
                         const double* __restrict__ wk, const double* __restrict__ we,
                         const int* __restrict__ diff_idx, int d, double ratio, double* val,
                         double* err, int* sd) {
  const int W = is_complex ? 2 * V : V;
  const bool dead = vol == 0.0;
  double e2 = 0.0;
  for (int v = 0; v < V; ++v) {
    double s7[2] = {0.0, 0.0}, s5[2] = {0.0, 0.0};
    const int nc = is_complex ? 2 : 1;
    for (int p = 0; p < P; ++p) {
      for (int q = 0; q < nc; ++q) {
        const double x = f[p * W + nc * v + q];
        s7[q] = __dadd_rn(s7[q], __dmul_rn(wk[p], x));
        s5[q] = __dadd_rn(s5[q], __dmul_rn(we[p], x));
      }
    }
    // val7 and val5 as the plain version forms them, then their difference
    const double v7r = __dmul_rn(s7[0], vol), v7i = __dmul_rn(s7[1], vol);
    const double dr = __dsub_rn(v7r, __dmul_rn(s5[0], vol));
    const double di = __dsub_rn(v7i, __dmul_rn(s5[1], vol));
    e2 = __dadd_rn(e2, abs2(dr, di, is_complex));
    val[nc * v] = dead ? 0.0 : v7r;
    if (is_complex) val[nc * v + 1] = dead ? 0.0 : v7i;
  }
  *err = dead ? 0.0 : sqrt(e2);
  int best = 0;
  double bv = 0.0;
  for (int i = 0; i < d; ++i) {
    const int* ix = diff_idx + 5 * i;
    double t = 0.0;
    for (int v = 0; v < V; ++v) {
      double dd[2] = {0.0, 0.0};
      const int nc = is_complex ? 2 : 1;
      for (int q = 0; q < nc; ++q) {
        const int o = nc * v + q;
        const double c2 = __dmul_rn(2.0, f[ix[0] * W + o]);
        const double t2 = __dsub_rn(__dadd_rn(f[ix[1] * W + o], f[ix[2] * W + o]), c2);
        const double t3 = __dsub_rn(__dadd_rn(f[ix[3] * W + o], f[ix[4] * W + o]), c2);
        dd[q] = __dsub_rn(t2, __dmul_rn(ratio, t3));
      }
      t = __dadd_rn(t, abs2(dd[0], dd[1], is_complex));
    }
    // first NaN, else the first of the largest
    if (i == 0 || (!isnan(bv) && (isnan(t) || t > bv))) {
      best = i;
      bv = t;
    }
  }
  *sd = best;
}

// K14: one thread per box.
__global__ void __launch_bounds__(kReduceThreads)
gm_rule_reduce_kernel(const double* __restrict__ fx, const double* __restrict__ vol,
                      const double* __restrict__ wk, const double* __restrict__ we,
                      const int* __restrict__ diff_idx, double* __restrict__ val,
                      double* __restrict__ err, int* __restrict__ sd, int64_t B, int P, int V,
                      int is_complex, int d, double ratio) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= B) return;
  const int W = is_complex ? 2 * V : V;
  box_rule(fx + k * P * W, P, V, is_complex, vol[k], wk, we, diff_idx, d, ratio, val + k * W,
           err + k, sd + k);
}

// K15: one block per box; thread p < P writes D at node p for every channel
// into shared memory, then thread 0 applies the rule.
template <int M>
__global__ void __launch_bounds__(kLeafThreads)
gm_leaf_dos_kernel(const double2* __restrict__ H, const double* __restrict__ om,
                   const double* __restrict__ eta, const double* __restrict__ vol,
                   const double* __restrict__ wk, const double* __restrict__ we,
                   const int* __restrict__ diff_idx, double* __restrict__ val,
                   double* __restrict__ err, int* __restrict__ sd, int P, int W, int d,
                   double ratio, double neg_inv_pi) {
  extern __shared__ double sD[];  // (P, W)
  constexpr int MM = M * M;
  const int64_t k = blockIdx.x;
  const int p = threadIdx.x;
  if (p < P) {
    double2 h[MM];
    const double2* hp = H + (k * P + p) * MM;
#pragma unroll
    for (int v = 0; v < MM; ++v) h[v] = hp[v];
    for (int w = 0; w < W; ++w) {
      const double2 z = make_double2(om[k * W + w], eta[k * W + w]);
      sD[p * W + w] = __dmul_rn(neg_inv_pi, trace_inv_imag<M, RoundedOps>(h, z));
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    box_rule(sD, P, W, 0, vol[k], wk, we, diff_idx, d, ratio, val + k * W, err + k, sd + k);
}

}  // namespace

// fx: (B, P, V) float64, or V complex values as (re, im) pairs when
// is_complex; vol: (B,); wk, we: (P,); diff_idx: (d, 5) int32; val: like fx
// without P; err: (B,); sd: (B,) int32. Returns cudaGetLastError() after the
// launch.
extern "C" int gm_rule_reduce_launch(const void* fx, const void* vol, const void* wk,
                                     const void* we, const void* diff_idx, void* val, void* err,
                                     void* sd, long long B, int P, int V, int is_complex, int d,
                                     double ratio, void* stream) {
  if (P < 1 || V < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((B + kReduceThreads - 1) / kReduceThreads);
  gm_rule_reduce_kernel<<<blocks, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(fx), static_cast<const double*>(vol),
      static_cast<const double*>(wk), static_cast<const double*>(we),
      static_cast<const int*>(diff_idx), static_cast<double*>(val), static_cast<double*>(err),
      static_cast<int*>(sd), B, P, V, is_complex, d, ratio);
  return static_cast<int>(cudaGetLastError());
}

// H: (B, P, m, m) complex128 as double2; om, eta: (B, W); vol: (B,); wk, we:
// (P,); diff_idx: (d, 5) int32; val: (B, W); err: (B,); sd: (B,) int32;
// neg_inv_pi: -1/pi as the caller rounds it.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for m
// outside 1..3, more than kLeafThreads nodes or a (P, W) row of traces past
// 48 KB of shared memory.
extern "C" int gm_leaf_dos_launch(const void* H, const void* om, const void* eta, const void* vol,
                                  const void* wk, const void* we, const void* diff_idx, void* val,
                                  void* err, void* sd, long long B, int P, int m, int W, int d,
                                  double ratio, double neg_inv_pi, void* stream) {
  const size_t shared = static_cast<size_t>(P) * W * sizeof(double);
  if (m < 1 || m > 3 || P < 1 || P > kLeafThreads || W < 1 || d < 1 || shared > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double2* h = static_cast<const double2*>(H);
  const double *o = static_cast<const double*>(om), *e = static_cast<const double*>(eta);
  const double *v = static_cast<const double*>(vol), *a = static_cast<const double*>(wk),
               *b = static_cast<const double*>(we);
  const int* di = static_cast<const int*>(diff_idx);
  double *out = static_cast<double*>(val), *er = static_cast<double*>(err);
  int* s = static_cast<int*>(sd);
  if (m == 1) {
    gm_leaf_dos_kernel<1><<<blocks, kLeafThreads, shared, st>>>(h, o, e, v, a, b, di, out, er, s,
                                                                P, W, d, ratio, neg_inv_pi);
  } else if (m == 2) {
    gm_leaf_dos_kernel<2><<<blocks, kLeafThreads, shared, st>>>(h, o, e, v, a, b, di, out, er, s,
                                                                P, W, d, ratio, neg_inv_pi);
  } else {
    gm_leaf_dos_kernel<3><<<blocks, kLeafThreads, shared, st>>>(h, o, e, v, a, b, di, out, er, s,
                                                                P, W, d, ratio, neg_inv_pi);
  }
  return static_cast<int>(cudaGetLastError());
}
