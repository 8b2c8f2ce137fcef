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
// widths (a few hundred boxes a trip) the latency of one launch and, on the
// host, the cost of the call. K15 reads P m^2 complex values (4.75 KB a box
// at m = 3) and does ~120 flops of trace per node and channel: bytes again,
// and launch latency at these widths.
//
// What the design does about it:
//  * K14 takes kReduceBoxes boxes a block (264 boxes: 33 blocks): the
//    block copies their node rows into shared memory in one coalesced pass,
//    then one thread per (box, channel) forms the two node sums, one thread
//    per (box, dimension) the fourth difference, side by side, and one
//    thread per box adds the channel errors in channel order and picks the
//    split dimension. Where the boxes' rows pass kReduceShared (wide
//    values: more than ~150 channels at P = 33), the same threads read the
//    rows from device memory instead (adjacent channels, adjacent
//    addresses), and the channels go in tiles whose errors fit in shared
//    memory, each tile's added to the box's sum in channel order. K15 takes
//    one block per box with a thread per node filling a shared-memory row
//    of traces, then one thread reduces the box. Each sum runs in a fixed
//    order (nodes, then channels), so repeats are bit-identical;
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
constexpr int kReduceBoxes = 8;          // boxes a K14 block
constexpr int kReduceShared = 40 * 1024;  // K14's staged rows and scratch, at most
constexpr int kLeafThreads = 128;  // threads per box in K15: one per node

// |x|^2 as the plain version computes it: abs(x) ** 2 (hypot for a complex value)
__device__ __forceinline__ double abs2(double re, double im, int is_complex) {
  const double a = is_complex ? hypot(re, im) : fabs(re);
  return __dmul_rn(a, a);
}

// Channel v of a box whose P node rows of W doubles (V values, complex ones
// as W = 2 V (re, im) pairs) are f: the two node sums in node order, val7
// into val[nc v ..] (0 for a dead box) and |val7 - val5|^2 returned.
__device__ __forceinline__ double channel_rule(const double* f, int P, int W, int v, int is_complex,
                                               double vol, const double* __restrict__ wk,
                                               const double* __restrict__ we, double* val) {
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
  const bool dead = vol == 0.0;
  val[nc * v] = dead ? 0.0 : v7r;
  if (is_complex) val[nc * v + 1] = dead ? 0.0 : v7i;
  return abs2(dr, di, is_complex);
}

// The fourth difference along the dimension whose five node indices are ix,
// summed over the V channels in channel order: sum |dd|^2.
__device__ __forceinline__ double fourth_difference(const double* f, int W, int V, int is_complex,
                                                    const int* __restrict__ ix, double ratio) {
  double t = 0.0;
  const int nc = is_complex ? 2 : 1;
  for (int v = 0; v < V; ++v) {
    double dd[2] = {0.0, 0.0};
    for (int q = 0; q < nc; ++q) {
      const int o = nc * v + q;
      const double c2 = __dmul_rn(2.0, f[ix[0] * W + o]);
      const double t2 = __dsub_rn(__dadd_rn(f[ix[1] * W + o], f[ix[2] * W + o]), c2);
      const double t3 = __dsub_rn(__dadd_rn(f[ix[3] * W + o], f[ix[4] * W + o]), c2);
      dd[q] = __dsub_rn(t2, __dmul_rn(ratio, t3));
    }
    t = __dadd_rn(t, abs2(dd[0], dd[1], is_complex));
  }
  return t;
}

// One step of the split dimension's argmax over the differences t_i in
// order: the first NaN, else the first of the largest (jnp.argmax).
__device__ __forceinline__ void split_step(int i, double t, int& best, double& bv) {
  if (i == 0 || (!isnan(bv) && (isnan(t) || t > bv))) {
    best = i;
    bv = t;
  }
}

// One box by one thread (K15): f holds the box's P node rows of W doubles.
// Writes val[0..W), *err and *sd.
__device__ void box_rule(const double* f, int P, int V, int is_complex, double vol,
                         const double* __restrict__ wk, const double* __restrict__ we,
                         const int* __restrict__ diff_idx, int d, double ratio, double* val,
                         double* err, int* sd) {
  const int W = is_complex ? 2 * V : V;
  double e2 = 0.0;
  for (int v = 0; v < V; ++v) e2 = __dadd_rn(e2, channel_rule(f, P, W, v, is_complex, vol, wk, we, val));
  *err = vol == 0.0 ? 0.0 : sqrt(e2);
  int best = 0;
  double bv = 0.0;
  for (int i = 0; i < d; ++i)
    split_step(i, fourth_difference(f, W, V, is_complex, diff_idx + 5 * i, ratio), best, bv);
  *sd = best;
}

// K14: a block takes nb boxes. Their node rows are staged in shared memory
// (one coalesced copy) where they fit, else read from fx. The channels go
// in tiles of cs (cs = V where the rows are staged): thread i < nb cs forms
// box i / cs's node sums for the tile's channel i % cs into the scratch se,
// and in the first tile thread nb cs + i < nb (cs + d) box i / d's fourth
// difference along dimension i % d; thread b < nb then adds box b's errors
// of the tile to its sum in channel order. Last, thread b < nb picks box b's
// split dimension.
__global__ void __launch_bounds__(kReduceThreads)
gm_rule_reduce_kernel(const double* __restrict__ fx, const double* __restrict__ vol,
                      const double* __restrict__ wk, const double* __restrict__ we,
                      const int* __restrict__ diff_idx, double* __restrict__ val,
                      double* __restrict__ err, int* __restrict__ sd, int64_t B, int P, int V,
                      int is_complex, int d, double ratio, int nb, int cs, int staged) {
  // staged: nb P W node values; then nb cs channel errors, nb d differences
  extern __shared__ double sm[];
  const int W = is_complex ? 2 * V : V;
  const int64_t box0 = static_cast<int64_t>(blockIdx.x) * nb;
  const int nbox = static_cast<int>(B - box0 < nb ? B - box0 : nb);
  const int64_t row = static_cast<int64_t>(P) * W;
  const double* f = fx + box0 * row;
  double* se = staged ? sm + nb * row : sm;
  double* sdiff = se + nb * cs;
  if (staged) {
    for (int i = threadIdx.x; i < nbox * row; i += blockDim.x) sm[i] = f[i];
    f = sm;
    __syncthreads();
  }
  double e2 = 0.0;  // thread b < nbox: box b's channel errors so far
  for (int c0 = 0; c0 < V; c0 += cs) {
    const int nc = V - c0 < cs ? V - c0 : cs;
    const int nd = c0 == 0 ? d : 0;
    for (int i = threadIdx.x; i < nbox * (nc + nd); i += blockDim.x) {
      if (i < nbox * nc) {
        const int b = i / nc, v = i % nc;
        se[b * cs + v] = channel_rule(f + b * row, P, W, c0 + v, is_complex, vol[box0 + b], wk, we,
                                      val + (box0 + b) * W);
      } else {
        const int b = (i - nbox * nc) / d, k = (i - nbox * nc) % d;
        sdiff[b * d + k] = fourth_difference(f + b * row, W, V, is_complex, diff_idx + 5 * k, ratio);
      }
    }
    __syncthreads();
    if (threadIdx.x < nbox)
      for (int v = 0; v < nc; ++v) e2 = __dadd_rn(e2, se[threadIdx.x * cs + v]);
    __syncthreads();
  }
  if (threadIdx.x < nbox) {
    const int64_t k = box0 + threadIdx.x;
    err[k] = vol[k] == 0.0 ? 0.0 : sqrt(e2);
    int best = 0;
    double bv = 0.0;
    for (int i = 0; i < d; ++i) split_step(i, sdiff[threadIdx.x * d + i], best, bv);
    sd[k] = best;
  }
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
  // boxes a block: kReduceBoxes, fewer where their staged rows and scratch
  // would pass kReduceShared; where one box's do, kReduceBoxes boxes read
  // from device memory, with channel tiles that fit the scratch
  const size_t W = is_complex ? 2 * static_cast<size_t>(V) : V;
  const size_t box = (P * W + V + d) * sizeof(double);
  const size_t slots = kReduceShared / sizeof(double);
  const int staged = box <= static_cast<size_t>(kReduceShared);
  int nb = kReduceBoxes, cs = V;
  if (staged) {
    const size_t fit = kReduceShared / box;
    if (fit < static_cast<size_t>(nb)) nb = static_cast<int>(fit);
  } else {
    if (static_cast<size_t>(nb) * (d + 1) > slots) return static_cast<int>(cudaErrorInvalidValue);
    const size_t tile = slots / nb - d;
    if (tile < static_cast<size_t>(cs)) cs = static_cast<int>(tile);
  }
  const long long blocks = (B + nb - 1) / nb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = ((staged ? nb * P * W : 0) + static_cast<size_t>(nb) * (cs + d)) * sizeof(double);
  gm_rule_reduce_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, shared,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(fx), static_cast<const double*>(vol),
      static_cast<const double*>(wk), static_cast<const double*>(we),
      static_cast<const int*>(diff_idx), static_cast<double*>(val), static_cast<double*>(err),
      static_cast<int*>(sd), B, P, V, is_complex, d, ratio, nb, cs, staged);
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
