// Pool pieces shared by the interval pool (K5, gk_pool.cu) and the fused
// leaf solve (gk_leaf_dos.cu): the worst-k selection and the lane totals,
// each in a block form (every thread of the block calls it; blockDim.x is a
// power of two up to kPoolThreads) and a warp form (the 32 lanes of one warp
// call it), which picks the same slots and sums in the same order, so it
// gives the block form's bits. The box pool, K16 in gm_pool.cu, takes only
// the constants and keeps the totals' order in its own one-pass form.
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

constexpr unsigned kWarpMask = 0xffffffffu;

// Warp form of pool_select_worst: lane t scans slots t, t + 32, ... for the
// best slot that comes after the last pick in the (larger error, lower slot)
// order, which excludes exactly the slots already taken, and a butterfly
// arg-max finds the round's pick; chosen: nb entries of this warp's shared
// scratch, written by lane 0.
__device__ inline void pool_select_worst_warp(const double* __restrict__ el, int cap, int nb,
                                              int* chosen) {
  const int t = threadIdx.x & 31;
  double pv = 1.0 / 0.0;
  int ps = -1;  // a pick before every slot
  for (int k = 0; k < nb; ++k) {
    double bv = -1.0 / 0.0;
    int bs = 0x7fffffff;
    for (int s = t; s < cap; s += 32) {
      const double v = el[s];
      if ((v < pv || (v == pv && s > ps)) && pool_better(v, s, bv, bs)) {
        bv = v;
        bs = s;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_xor_sync(kWarpMask, bv, off);
      const int os = __shfl_xor_sync(kWarpMask, bs, off);
      if (pool_better(ov, os, bv, bs)) {
        bv = ov;
        bs = os;
      }
    }
    if (t == 0) chosen[k] = bs;
    pv = bv;
    ps = bs;
  }
  __syncwarp();
}

// One field of pool_lane_totals in the warp form: x[q * stride] over the
// slots q < cap. Entry v of the kPoolThreads sums slots v, v + kPoolThreads,
// ... in order; lane t holds entries t + 32 j, so the tree's levels 128, 64
// and 32 add in its registers and the last five by shuffles (lane t takes
// lane t + w), the block form's pairs in its order. Every lane gets the sum.
__device__ __forceinline__ double warp_entry(const double* __restrict__ x, int64_t stride, int cap, int v) {
  double s = 0.0;
  for (int q = v; q < cap; q += kPoolThreads) s += x[q * stride];
  return s;
}

__device__ __forceinline__ double warp_tree_sum(const double* __restrict__ x, int64_t stride, int cap) {
  const int t = threadIdx.x & 31;
  // the 128 level pairs entries j and j + 4 (j < 4), the 64 level j and
  // j + 2, the 32 level 0 and 1; entries past cap are 0 and need no loads
  double e0 = warp_entry(x, stride, cap, t) + warp_entry(x, stride, cap, t + 128);
  double e1 = warp_entry(x, stride, cap, t + 32) + warp_entry(x, stride, cap, t + 160);
  if (cap > 64) {
    e0 += warp_entry(x, stride, cap, t + 64) + warp_entry(x, stride, cap, t + 192);
    e1 += warp_entry(x, stride, cap, t + 96) + warp_entry(x, stride, cap, t + 224);
  } else {
    e0 += 0.0 + 0.0;
    e1 += 0.0 + 0.0;
  }
  e0 += e1;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) e0 += __shfl_down_sync(kWarpMask, e0, w);
  return __shfl_sync(kWarpMask, e0, 0);
}

// Warp form of pool_lane_totals, bit for bit: lane 0 writes tot_err,
// tot_val and tol; every lane gets tot_err in te and tol in tl.
__device__ inline void pool_lane_totals_warp(const double* __restrict__ err,
                                             const double* __restrict__ val,
                                             double* __restrict__ tot_val,
                                             double* __restrict__ tot_err, double* __restrict__ tol,
                                             const double* __restrict__ atol, int64_t l, int cap,
                                             int V, double rtol, double& te, double& tl) {
  const bool first = (threadIdx.x & 31) == 0;
  te = warp_tree_sum(err + l * cap, 1, cap);
  double norm2 = 0.0;
  for (int f = 0; f < V; ++f) {
    const double tot = warp_tree_sum(val + l * cap * V + f, V, cap);
    if (first) tot_val[l * V + f] = tot;
    norm2 += tot * tot;
  }
  tl = fmax(atol[l], rtol * sqrt(norm2));
  if (first) {
    tot_err[l] = te;
    tol[l] = tl;
  }
}

}  // namespace autobz
