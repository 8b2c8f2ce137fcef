// K5: the step of the lane-batched Gauss-Kronrod interval pool, in FP64.
//
// Replaces autobzcore_tpu/ops/adaptive.py:236 gk_adaptive's loop test
// (cond, :410-420), its body (:422-465: lax.top_k over the errors, the
// bisection, the two sequential scatters, n += nbisect, evals += count) and
// the totals it recomputes each trip (:393-396), plus the reduction of
// :72 gk_rule_eval (:99-140) that non-leaf nest levels apply to the values
// and counts of their inner solves. The reference runs one pool per solve
// under vmap; here every pool is one row of (L, cap) tensors and three
// entry points serve all lanes:
//
//  * select: per live lane, the loop test tot_err > tol, n + nbisect <= cap,
//    evals < max_evals; where it holds, the worst nbisect intervals, ties to
//    the lower index (what lax.top_k does), and their children's endpoints
//    (left halves first); where it fails, the lane goes inactive for good;
//  * update: for live lanes, left children over their parents, then right
//    children to n..n+nbisect-1 (two sequential scatters: while n < nbisect a
//    picked dead slot collides with a fresh slot and the right child must
//    win), n += nbisect, evals += count; then, for those lanes (or for every
//    lane in totals mode), tot_val and tot_err over the whole pool and
//    tol = max(atol, rtol |tot_val|_2), summed in a fixed order;
//  * rule reduce: node values (L, I, npts, V) and per-node counts to val,
//    err = |vK - vG|_2, l1 and a count per lane, dead intervals exactly 0;
//  * seed: the warm start's chunk write (autobzcore_tpu/ops/adaptive.py:
//    309-359, seed_body :344-353): per seeding lane, a chunk of C
//    re-evaluated seed intervals to the contiguous slots start..start+C-1,
//    n = n0, evals += the chunk's count (every slot counts, dead ones and
//    re-evaluated overlap too); then every lane's totals and tolerance. The
//    seed pools' per-lane affine remap and dead-slot masking
//    (autobzcore_tpu/algorithms/nested.py:198-231 _mid_seed_pool) stay plain
//    tensor ops in the caller, as does the choice of start = min(k C, cap - C).
//
// What bounds it on an H100: a select reads a lane's cap errors nbisect times
// and an update reads its cap (V + 1) pool entries once, ~a few KB per lane:
// at the flagship's widest level (30,000 leaf lanes, cap 64) a call moves
// ~20-40 MB and does almost no arithmetic, so bytes (and, at small widths,
// launch latency) bound it.
//
// What the design does about it:
//  * one block per lane for select and update: the lane's pool is read by
//    the block in coalesced strides and reduced in shared memory in a fixed
//    tree order, so totals are deterministic from run to run;
//  * select does nbisect rounds of a (value, index) arg-max with exclusion of
//    the slots already taken, which gives lax.top_k's order exactly;
//  * the scatters are split by phase, with a barrier between the left and
//    right children, so the collision resolves as in the reference;
//  * rule reduce takes one thread per (lane, interval);
//  * an update whose picks lie outside the lane's cap slots, or which has no
//    room for its right children, writes nothing and sets the lane's totals
//    to NaN, so the lane stops unconverged instead of writing out of bounds.

#include <cuda_runtime.h>

#include <cstdint>

#include "pool_common.cuh"

namespace {

using autobz::kMaxBisect;
using autobz::pool_lane_totals;
using autobz::pool_select_worst;
constexpr int kThreads = autobz::kPoolThreads;

__global__ void __launch_bounds__(kThreads)
gk_pool_select_kernel(const double* __restrict__ a, const double* __restrict__ b,
                      const double* __restrict__ err, const int64_t* __restrict__ n,
                      const double* __restrict__ evals, const double* __restrict__ tot_err,
                      const double* __restrict__ tol, bool* __restrict__ active,
                      int64_t* __restrict__ idx, double* __restrict__ ca, double* __restrict__ cb,
                      int cap, int nb, double max_evals) {
  __shared__ double rv[kThreads];
  __shared__ int rs[kThreads];
  __shared__ int chosen[kMaxBisect];
  const int64_t l = blockIdx.x;
  const bool live = active[l] && tot_err[l] > tol[l] && n[l] + nb <= cap && evals[l] < max_evals;
  double* cal = ca + l * 2 * nb;
  double* cbl = cb + l * 2 * nb;
  if (!live) {
    for (int j = threadIdx.x; j < 2 * nb; j += blockDim.x) {
      cal[j] = 0.0;
      cbl[j] = 0.0;
    }
    for (int j = threadIdx.x; j < nb; j += blockDim.x) idx[l * nb + j] = 0;
    if (threadIdx.x == 0) active[l] = false;
    return;
  }
  pool_select_worst(err + l * cap, cap, nb, chosen, rv, rs);
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    const int s = chosen[j];
    const double aa = a[l * cap + s], bb = b[l * cap + s];
    const double mm = (aa + bb) / 2;
    idx[l * nb + j] = s;
    cal[j] = aa;
    cal[nb + j] = mm;
    cbl[j] = mm;
    cbl[nb + j] = bb;
  }
}

// One block per lane. With `update`, only live lanes act: the two scatters,
// n and evals, then their totals; without it (totals mode), every lane
// recomputes its totals.
__global__ void __launch_bounds__(kThreads)
gk_pool_update_kernel(double* __restrict__ a, double* __restrict__ b, double* __restrict__ err,
                      double* __restrict__ l1, double* __restrict__ val, int64_t* __restrict__ n,
                      double* __restrict__ evals, double* __restrict__ tot_val,
                      double* __restrict__ tot_err, double* __restrict__ tol,
                      const double* __restrict__ atol, const bool* __restrict__ active,
                      const int64_t* __restrict__ idx, const double* __restrict__ ca,
                      const double* __restrict__ cb, const double* __restrict__ cval,
                      const double* __restrict__ cerr, const double* __restrict__ cl1,
                      const double* __restrict__ count, int cap, int V, int nb, double rtol,
                      int update) {
  __shared__ double red[kThreads];
  __shared__ bool bad;
  const int64_t l = blockIdx.x;
  if (update) {
    if (!active[l]) return;
    const int64_t n0 = n[l];
    const int64_t base = l * cap;
    const int64_t c0 = l * 2 * nb;
    if (threadIdx.x == 0) {
      bad = n0 < 0 || n0 + nb > cap;
      for (int j = 0; j < nb; ++j) bad |= idx[l * nb + j] < 0 || idx[l * nb + j] >= cap;
    }
    __syncthreads();
    if (bad) {
      const double nan = __longlong_as_double(0x7ff8000000000000LL);
      for (int f = threadIdx.x; f < V; f += blockDim.x) tot_val[l * V + f] = nan;
      if (threadIdx.x == 0) tot_err[l] = nan;
      return;
    }
    for (int phase = 0; phase < 2; ++phase) {
      // phase 0: left children over their parents; phase 1: right children
      // to the fresh slots, after every left child is written
      for (int q = threadIdx.x; q < nb * (V + 4); q += blockDim.x) {
        const int j = q % nb;
        const int f = q / nb;  // 0..3: a, b, err, l1; 4..: value entries
        const int64_t slot = base + (phase == 0 ? idx[l * nb + j] : n0 + j);
        const int64_t ch = c0 + phase * nb + j;
        if (f == 0) a[slot] = ca[ch];
        else if (f == 1) b[slot] = cb[ch];
        else if (f == 2) err[slot] = cerr[ch];
        else if (f == 3) l1[slot] = cl1[ch];
        else val[slot * V + (f - 4)] = cval[ch * V + (f - 4)];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      n[l] = n0 + nb;
      evals[l] += count[l];
    }
  }
  pool_lane_totals(err, val, tot_val, tot_err, tol, atol, red, l, cap, V, rtol);
}

// One block per lane: a seeding lane writes its chunk (ca, cb, cval, cerr,
// cl1) (L, C) to slots start..start+C-1, sets n = n0 and adds the chunk's
// count to evals; then every lane recomputes its totals.
__global__ void __launch_bounds__(kThreads)
gk_pool_seed_kernel(double* __restrict__ a, double* __restrict__ b, double* __restrict__ err,
                    double* __restrict__ l1, double* __restrict__ val, int64_t* __restrict__ n,
                    double* __restrict__ evals, double* __restrict__ tot_val,
                    double* __restrict__ tot_err, double* __restrict__ tol,
                    const double* __restrict__ atol, const bool* __restrict__ seeding,
                    const int64_t* __restrict__ n0, const double* __restrict__ ca,
                    const double* __restrict__ cb, const double* __restrict__ cval,
                    const double* __restrict__ cerr, const double* __restrict__ cl1,
                    const double* __restrict__ count, int cap, int V, int C, int start,
                    double rtol) {
  __shared__ double red[kThreads];
  const int64_t l = blockIdx.x;
  if (seeding[l]) {
    const int64_t base = l * cap + start;
    const int64_t c0 = l * C;
    for (int q = threadIdx.x; q < C * (V + 4); q += blockDim.x) {
      const int j = q % C;
      const int f = q / C;  // 0..3: a, b, err, l1; 4..: value entries
      const int64_t slot = base + j;
      const int64_t ch = c0 + j;
      if (f == 0) a[slot] = ca[ch];
      else if (f == 1) b[slot] = cb[ch];
      else if (f == 2) err[slot] = cerr[ch];
      else if (f == 3) l1[slot] = cl1[ch];
      else val[slot * V + (f - 4)] = cval[ch * V + (f - 4)];
    }
    if (threadIdx.x == 0) {
      n[l] = n0[l];
      evals[l] += count[l];
    }
    __syncthreads();
  }
  pool_lane_totals(err, val, tot_val, tot_err, tol, atol, red, l, cap, V, rtol);
}

// One thread per (lane, interval). fx: (L, I, P, V) doubles, or V complex
// values as (re, im) pairs when is_complex.
__global__ void gk_rule_reduce_kernel(const double* __restrict__ fx,
                                      const double* __restrict__ counts,
                                      const double* __restrict__ half_w,
                                      const double* __restrict__ wk, const double* __restrict__ wg,
                                      double* __restrict__ val, double* __restrict__ err,
                                      double* __restrict__ l1, double* __restrict__ count,
                                      int64_t L, int I, int P, int V, int is_complex) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= L * I) return;
  const int64_t l = t / I;
  const int i = static_cast<int>(t - l * I);
  if (i == 0) {
    double s = static_cast<double>(I) * P;
    if (counts != nullptr) {
      s = 0.0;
      for (int64_t q = 0; q < static_cast<int64_t>(I) * P; ++q) s += counts[l * I * P + q];
    }
    count[l] = s;
  }
  const double half = half_w[t];
  const int W = is_complex ? 2 * V : V;  // doubles per node
  const double* f0 = fx + t * P * W;
  double* vo = val + t * W;
  if (half == 0.0) {
    for (int q = 0; q < W; ++q) vo[q] = 0.0;
    err[t] = 0.0;
    l1[t] = 0.0;
    return;
  }
  double e2 = 0.0, l2 = 0.0;
  for (int v = 0; v < V; ++v) {
    if (is_complex) {
      double kr = 0.0, ki = 0.0, gr = 0.0, gi = 0.0, sl = 0.0;
      for (int p = 0; p < P; ++p) {
        const double re = f0[p * W + 2 * v], im = f0[p * W + 2 * v + 1];
        kr += wk[p] * re;
        ki += wk[p] * im;
        gr += wg[p] * re;
        gi += wg[p] * im;
        sl += wk[p] * hypot(re, im);
      }
      kr *= half;
      ki *= half;
      gr *= half;
      gi *= half;
      sl *= half;
      vo[2 * v] = kr;
      vo[2 * v + 1] = ki;
      e2 += (kr - gr) * (kr - gr) + (ki - gi) * (ki - gi);
      l2 += sl * sl;
    } else {
      double k = 0.0, g = 0.0, sl = 0.0;
      for (int p = 0; p < P; ++p) {
        const double x = f0[p * W + v];
        k += wk[p] * x;
        g += wg[p] * x;
        sl += wk[p] * fabs(x);
      }
      k *= half;
      g *= half;
      sl *= half;
      vo[v] = k;
      e2 += (k - g) * (k - g);
      l2 += sl * sl;
    }
  }
  err[t] = sqrt(e2);
  l1[t] = sqrt(l2);
}

}  // namespace

// a, b, err: (L, cap); n: (L,) int64; evals, tot_err, tol: (L,); active: (L,)
// bool, updated in place; idx: (L, nb) int64; ca, cb: (L, 2 nb). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for nb
// outside 1..kMaxBisect.
extern "C" int gk_pool_select_launch(const void* a, const void* b, const void* err, const void* n,
                                     const void* evals, const void* tot_err, const void* tol,
                                     void* active, void* idx, void* ca, void* cb, long long L,
                                     int cap, int nb, double max_evals, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  if (nb < 1 || nb > kMaxBisect || L > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gk_pool_select_kernel<<<static_cast<unsigned>(L), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(b),
      static_cast<const double*>(err), static_cast<const int64_t*>(n),
      static_cast<const double*>(evals), static_cast<const double*>(tot_err),
      static_cast<const double*>(tol), static_cast<bool*>(active), static_cast<int64_t*>(idx),
      static_cast<double*>(ca), static_cast<double*>(cb), cap, nb, max_evals);
  return static_cast<int>(cudaGetLastError());
}

// Pools as in select, plus l1: (L, cap), val: (L, cap, V) doubles (complex
// values as (re, im) pairs, V counting doubles), tot_val: (L, V), atol: (L,);
// the children idx, ca, cb, cerr, cl1: (L, 2 nb), cval: (L, 2 nb, V), count:
// (L,). With update = 0 the child pointers may be null and only the totals
// are recomputed, for every lane.
// Pools as in update; seeding: (L,) bool; n0: (L,) int64; the chunk ca, cb,
// cerr, cl1: (L, C), cval: (L, C, V); count: (L,). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue when the
// chunk does not fit slots 0..cap-1.
extern "C" int gk_pool_seed_launch(void* a, void* b, void* err, void* l1, void* val, void* n,
                                   void* evals, void* tot_val, void* tot_err, void* tol,
                                   const void* atol, const void* seeding, const void* n0,
                                   const void* ca, const void* cb, const void* cval,
                                   const void* cerr, const void* cl1, const void* count,
                                   long long L, int cap, int V, int C, int start, double rtol,
                                   void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  if (L > 0x7fffffffLL || C < 1 || start < 0 || start + C > cap)
    return static_cast<int>(cudaErrorInvalidValue);
  gk_pool_seed_kernel<<<static_cast<unsigned>(L), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(a), static_cast<double*>(b), static_cast<double*>(err),
      static_cast<double*>(l1), static_cast<double*>(val), static_cast<int64_t*>(n),
      static_cast<double*>(evals), static_cast<double*>(tot_val), static_cast<double*>(tot_err),
      static_cast<double*>(tol), static_cast<const double*>(atol),
      static_cast<const bool*>(seeding), static_cast<const int64_t*>(n0),
      static_cast<const double*>(ca), static_cast<const double*>(cb),
      static_cast<const double*>(cval), static_cast<const double*>(cerr),
      static_cast<const double*>(cl1), static_cast<const double*>(count), cap, V, C, start, rtol);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gk_pool_update_launch(void* a, void* b, void* err, void* l1, void* val, void* n,
                                     void* evals, void* tot_val, void* tot_err, void* tol,
                                     const void* atol, const void* active, const void* idx,
                                     const void* ca, const void* cb, const void* cval,
                                     const void* cerr, const void* cl1, const void* count,
                                     long long L, int cap, int V, int nb, double rtol, int update,
                                     void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  if (L > 0x7fffffffLL || (update && (nb < 1 || nb > kMaxBisect)))
    return static_cast<int>(cudaErrorInvalidValue);
  gk_pool_update_kernel<<<static_cast<unsigned>(L), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(a), static_cast<double*>(b), static_cast<double*>(err),
      static_cast<double*>(l1), static_cast<double*>(val), static_cast<int64_t*>(n),
      static_cast<double*>(evals), static_cast<double*>(tot_val), static_cast<double*>(tot_err),
      static_cast<double*>(tol), static_cast<const double*>(atol),
      static_cast<const bool*>(active), static_cast<const int64_t*>(idx),
      static_cast<const double*>(ca), static_cast<const double*>(cb),
      static_cast<const double*>(cval), static_cast<const double*>(cerr),
      static_cast<const double*>(cl1), static_cast<const double*>(count), cap, V, nb, rtol,
      update);
  return static_cast<int>(cudaGetLastError());
}

// fx: (L, I, P, V) float64 or complex128 (is_complex); counts: (L, I, P)
// float64 or null; half: (L, I); wk, wg: (P,); val: like fx without P; err,
// l1: (L, I); count: (L,). Returns cudaGetLastError() after the launch.
extern "C" int gk_rule_reduce_launch(const void* fx, const void* counts, const void* half,
                                     const void* wk, const void* wg, void* val, void* err,
                                     void* l1, void* count, long long L, int I, int P, int V,
                                     int is_complex, void* stream) {
  if (L <= 0 || I <= 0) return static_cast<int>(cudaGetLastError());
  const long long threads = L * I;
  const unsigned blocks = static_cast<unsigned>((threads + 127) / 128);
  gk_rule_reduce_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(fx), static_cast<const double*>(counts),
      static_cast<const double*>(half), static_cast<const double*>(wk),
      static_cast<const double*>(wg), static_cast<double*>(val), static_cast<double*>(err),
      static_cast<double*>(l1), static_cast<double*>(count), L, I, P, V, is_complex);
  return static_cast<int>(cudaGetLastError());
}
