// Pool pieces shared by the interval pool (K5, gk_pool.cu) and the fused
// leaf solve (gk_leaf_dos.cu): the worst-k selection and the lane totals
// (the box pool, K16 in gm_pool.cu, takes only the constants and keeps the
// totals' order in its own one-pass form). Every thread of the block calls
// each function; blockDim.x is a power of two up to kPoolThreads.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace autobz {

constexpr int kPoolThreads = 256;
constexpr int kMaxBisect = 64;

// the better of two (error, slot) candidates: larger error, then lower slot
__device__ __forceinline__ bool pool_better(double v, int s, double bv, int bs) {
  return v > bv || (v == bv && s < bs);
}

// The slots of the nb largest of the cap errors el[0..cap), in descending
// order with ties to the lower slot (what lax.top_k gives), into chosen[0..nb):
// nb rounds of a (value, slot) arg-max that excludes the slots already taken.
// rv, rs: kPoolThreads shared scratch entries.
__device__ inline void pool_select_worst(const double* __restrict__ el, int cap, int nb,
                                         int* chosen, double* rv, int* rs) {
  for (int k = 0; k < nb; ++k) {
    double bv = -1.0 / 0.0;
    int bs = 0x7fffffff;
    for (int s = threadIdx.x; s < cap; s += blockDim.x) {
      bool taken = false;
      for (int q = 0; q < k; ++q) taken |= chosen[q] == s;
      if (!taken && pool_better(el[s], s, bv, bs)) {
        bv = el[s];
        bs = s;
      }
    }
    rv[threadIdx.x] = bv;
    rs[threadIdx.x] = bs;
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w && pool_better(rv[threadIdx.x + w], rs[threadIdx.x + w], rv[threadIdx.x],
                                         rs[threadIdx.x])) {
        rv[threadIdx.x] = rv[threadIdx.x + w];
        rs[threadIdx.x] = rs[threadIdx.x + w];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) chosen[k] = rs[0];
    __syncthreads();
  }
}

// tot_val, tot_err over lane l's whole pool (err: (L, cap), val: (L, cap, V))
// and tol = max(atol, rtol |tot_val|_2), reduced in a fixed tree order; red:
// kPoolThreads shared scratch entries. The order is that of kPoolThreads
// threads whatever blockDim.x (a power of two up to kPoolThreads): entry v
// of red sums slots v, v + kPoolThreads, ... in order, then a tree halves
// the entries, so a smaller block (the fused leaf solve, gk_leaf_dos.cu)
// gets the bits of the pool kernels' totals.
__device__ inline void pool_lane_totals(const double* __restrict__ err,
                                        const double* __restrict__ val,
                                        double* __restrict__ tot_val, double* __restrict__ tot_err,
                                        double* __restrict__ tol, const double* __restrict__ atol,
                                        double* red, int64_t l, int cap, int V, double rtol) {
  double norm2 = 0.0;
  for (int f = -1; f < V; ++f) {
    for (int v = threadIdx.x; v < kPoolThreads; v += blockDim.x) {
      double s = 0.0;
      for (int q = v; q < cap; q += kPoolThreads)
        s += f < 0 ? err[l * cap + q] : val[(l * cap + q) * V + f];
      red[v] = s;
    }
    __syncthreads();
    for (int w = kPoolThreads / 2; w > 0; w >>= 1) {
      for (int v = threadIdx.x; v < w; v += blockDim.x) red[v] += red[v + w];
      __syncthreads();
    }
    const double tot = red[0];
    __syncthreads();
    if (f < 0) {
      if (threadIdx.x == 0) tot_err[l] = tot;
    } else {
      if (threadIdx.x == 0) tot_val[l * V + f] = tot;
      norm2 += tot * tot;
    }
  }
  if (threadIdx.x == 0) tol[l] = fmax(atol[l], rtol * sqrt(norm2));
}

}  // namespace autobz
