// K16: the step of the lane-batched Genz-Malik box pool, in FP64.
//
// Replaces autobzcore_tpu/ops/genz_malik.py:152 gm_adaptive's loop test
// (cond, :196-200) and body (:202-230). The reference runs one pool per
// solve; here every pool is one row of (L, cap) tensors (centres and halves
// (L, cap, d), err (L, cap), splitdim (L, cap) int32, values (L, cap, V)) and
// two entry points serve all lanes:
//
//  * select: per active lane, the worst nbisect boxes (ties to the lower
//    slot, as lax.top_k; pool_common.cuh, shared with K5) and their children:
//    each box halved along its splitdim, new half = h (1 - onehot / 2), the
//    centres c -/+ h onehot / 2, left children first (:204-214); inactive
//    lanes get zero children;
//  * update: for active lanes, left children over their parents, then right
//    children to n..n+nbisect-1 (two sequential scatters: while fewer than
//    nbisect boxes are live the picks include dead slots that collide with
//    fresh ones, and the fresh slots must win, :216-228), n += nbisect,
//    evals += 2 nbisect P (the dead boxes count too, :230); then tot_val,
//    tot_err and tol = max(atol, rtol |tot_val|_2) summed in a fixed tree
//    order, and the loop test for the next trip, tot_err > tol,
//    n + nbisect <= cap, evals < max_evals, into the lane's active flag.
//    Without `update` (totals mode) every lane recomputes its totals and
//    narrows its flag by the test, which starts the loop.
//
// What bounds it on an H100: a select reads a lane's cap errors nbisect times
// and a few boxes; an update writes 2 nbisect boxes and reads the lane's
// cap (V + 1) pool entries once: at cap 4096 and V = 1, ~66 KB a lane, ~2 MB
// for 33 lanes, so bytes bound it (0.6 us), and at these widths launch
// latency.
//
// What the design does about it: one block per lane, the lane's pool read in
// coalesced strides and reduced in shared memory in a fixed order, so totals
// are deterministic; an update whose picks lie outside the lane's cap slots,
// or which has no room for its right children, writes nothing, sets the
// lane's totals to NaN and stops it unconverged.

#include <cuda_runtime.h>

#include <cstdint>

#include "pool_common.cuh"

namespace {

using autobz::kMaxBisect;
using autobz::pool_lane_totals;
using autobz::pool_select_worst;
constexpr int kThreads = autobz::kPoolThreads;

__global__ void __launch_bounds__(kThreads)
gm_pool_select_kernel(const double* __restrict__ c, const double* __restrict__ h,
                      const double* __restrict__ err, const int* __restrict__ sd,
                      const bool* __restrict__ active, int64_t* __restrict__ idx,
                      double* __restrict__ cc, double* __restrict__ hh, int cap, int d, int nb) {
  __shared__ double rv[kThreads];
  __shared__ int rs[kThreads];
  __shared__ int chosen[kMaxBisect];
  const int64_t l = blockIdx.x;
  double* ccl = cc + l * 2 * nb * d;
  double* hhl = hh + l * 2 * nb * d;
  if (!active[l]) {
    for (int j = threadIdx.x; j < 2 * nb * d; j += blockDim.x) {
      ccl[j] = 0.0;
      hhl[j] = 0.0;
    }
    for (int j = threadIdx.x; j < nb; j += blockDim.x) idx[l * nb + j] = 0;
    return;
  }
  pool_select_worst(err + l * cap, cap, nb, chosen, rv, rs);
  for (int q = threadIdx.x; q < nb * d; q += blockDim.x) {
    const int j = q / d, i = q % d;
    const int s = chosen[j];
    const int64_t src = (l * cap + s) * d + i;
    const double h0 = h[src], c0 = c[src];
    // the reference's one-hot arithmetic: h (1 - onehot / 2), h onehot / 2
    const double onehot = sd[l * cap + s] == i ? 1.0 : 0.0;
    const double nh = h0 * (1.0 - onehot / 2.0);
    const double off = h0 * onehot / 2.0;
    ccl[j * d + i] = c0 - off;
    ccl[(nb + j) * d + i] = c0 + off;
    hhl[j * d + i] = nh;
    hhl[(nb + j) * d + i] = nh;
    if (i == 0) idx[l * nb + j] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
gm_pool_update_kernel(double* __restrict__ c, double* __restrict__ h, double* __restrict__ err,
                      int* __restrict__ sd, double* __restrict__ val, int64_t* __restrict__ n,
                      double* __restrict__ evals, double* __restrict__ tot_val,
                      double* __restrict__ tot_err, double* __restrict__ tol,
                      const double* __restrict__ atol, bool* __restrict__ active,
                      const int64_t* __restrict__ idx, const double* __restrict__ cc,
                      const double* __restrict__ hh, const double* __restrict__ cval,
                      const double* __restrict__ cerr, const int* __restrict__ csd, int cap,
                      int d, int V, int nb, double trip_evals, double rtol, double max_evals,
                      int update) {
  __shared__ double red[kThreads];
  __shared__ bool bad;
  const int64_t l = blockIdx.x;
  if (!active[l]) {
    if (update) return;
  } else if (update) {
    const int64_t n0 = n[l];
    if (threadIdx.x == 0) {
      bad = n0 < 0 || n0 + nb > cap;
      for (int j = 0; j < nb; ++j) bad |= idx[l * nb + j] < 0 || idx[l * nb + j] >= cap;
    }
    __syncthreads();
    if (bad) {
      const double nan = __longlong_as_double(0x7ff8000000000000LL);
      for (int f = threadIdx.x; f < V; f += blockDim.x) tot_val[l * V + f] = nan;
      if (threadIdx.x == 0) {
        tot_err[l] = nan;
        active[l] = false;
      }
      return;
    }
    const int F = 2 * d + 2 + V;  // fields of a box: c (d), h (d), err, splitdim, values (V)
    for (int phase = 0; phase < 2; ++phase) {
      // phase 0: left children over their parents; phase 1: right children
      // to the fresh slots, after every left child is written
      for (int q = threadIdx.x; q < nb * F; q += blockDim.x) {
        const int j = q % nb;
        const int f = q / nb;
        const int64_t slot = l * cap + (phase == 0 ? idx[l * nb + j] : n0 + j);
        const int64_t ch = l * 2 * nb + phase * nb + j;
        if (f < d) c[slot * d + f] = cc[ch * d + f];
        else if (f < 2 * d) h[slot * d + f - d] = hh[ch * d + f - d];
        else if (f == 2 * d) err[slot] = cerr[ch];
        else if (f == 2 * d + 1) sd[slot] = csd[ch];
        else val[slot * V + (f - 2 * d - 2)] = cval[ch * V + (f - 2 * d - 2)];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      n[l] = n0 + nb;
      evals[l] += trip_evals;
    }
  }
  pool_lane_totals(err, val, tot_val, tot_err, tol, atol, red, l, cap, V, rtol);
  if (threadIdx.x == 0)
    active[l] = active[l] && tot_err[l] > tol[l] && n[l] + nb <= cap && evals[l] < max_evals;
}

}  // namespace

// c, h: (L, cap, d); err: (L, cap); sd: (L, cap) int32; active: (L,) bool;
// idx: (L, nb) int64; cc, hh: (L, 2 nb, d). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for nb outside 1..kMaxBisect.
extern "C" int gm_pool_select_launch(const void* c, const void* h, const void* err, const void* sd,
                                     const void* active, void* idx, void* cc, void* hh,
                                     long long L, int cap, int d, int nb, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  if (nb < 1 || nb > kMaxBisect || d < 1 || L > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  gm_pool_select_kernel<<<static_cast<unsigned>(L), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(c), static_cast<const double*>(h),
      static_cast<const double*>(err), static_cast<const int*>(sd),
      static_cast<const bool*>(active), static_cast<int64_t*>(idx), static_cast<double*>(cc),
      static_cast<double*>(hh), cap, d, nb);
  return static_cast<int>(cudaGetLastError());
}

// Pools as in select, plus val: (L, cap, V) doubles (complex values as (re,
// im) pairs, V counting doubles), n: (L,) int64, evals, tot_err, tol, atol:
// (L,), tot_val: (L, V); the children idx, cc, hh as select gives them, cval:
// (L, 2 nb, V), cerr: (L, 2 nb), csd: (L, 2 nb) int32. With update = 0 the
// child pointers may be null. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for nb outside 1..kMaxBisect.
extern "C" int gm_pool_update_launch(void* c, void* h, void* err, void* sd, void* val, void* n,
                                     void* evals, void* tot_val, void* tot_err, void* tol,
                                     const void* atol, void* active, const void* idx,
                                     const void* cc, const void* hh, const void* cval,
                                     const void* cerr, const void* csd, long long L, int cap,
                                     int d, int V, int nb, double trip_evals, double rtol,
                                     double max_evals, int update, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  if (L > 0x7fffffffLL || nb < 1 || nb > kMaxBisect || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  gm_pool_update_kernel<<<static_cast<unsigned>(L), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(c), static_cast<double*>(h), static_cast<double*>(err),
      static_cast<int*>(sd), static_cast<double*>(val), static_cast<int64_t*>(n),
      static_cast<double*>(evals), static_cast<double*>(tot_val), static_cast<double*>(tot_err),
      static_cast<double*>(tol), static_cast<const double*>(atol), static_cast<bool*>(active),
      static_cast<const int64_t*>(idx), static_cast<const double*>(cc),
      static_cast<const double*>(hh), static_cast<const double*>(cval),
      static_cast<const double*>(cerr), static_cast<const int*>(csd), cap, d, V, nb, trip_evals,
      rtol, max_evals, update);
  return static_cast<int>(cudaGetLastError());
}
