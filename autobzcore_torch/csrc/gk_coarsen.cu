// K6: error-guided sibling coarsening of warm-start interval pools, in FP64.
//
// Replaces autobzcore_tpu/ops/adaptive.py:143-225 coarsen_pool, which the
// warm start runs on the inherited pool before re-evaluating it
// (autobzcore_tpu/ops/adaptive.py:315-319). The reference coarsens one pool
// per solve under vmap; here every pool is one row of (L, cap) tensors and
// one thread block coarsens one lane:
//
//  1. stable argsort of where(slot < n, a, +inf): live slots by left
//     endpoint, ties and dead slots in index order;
//  2. per sorted slot: live (slot < n and width > 0), segment id
//     (searchsorted(segs, a, right) - 1, clipped), the dyadic left-child test
//     |k - rint(k/2) 2| < 1e-6 with k = (a - s0) / w, and with its right
//     neighbour (fills: width 0, live false, segment -1 past the end) the
//     sibling test, the share tol (w + w_n) / max(L, tiny) and the cost
//     e + e_n;
//  3. two merge triggers: cost < merge_factor share, and cap pressure (the
//     `need` cheapest sibling pairs, need = n_live - max(int(target_mult
//     load), nseg + 1, 8), load counting e > 0.1 tol w / L; merge where
//     cost <= the need-th smallest sibling cost, if that is finite, so ties
//     merge more than `need`);
//  4. the right halves of merged pairs drop, merged left halves take their
//     neighbour's b, and a stable argsort of !keep compacts the survivors to
//     the front; the rest of the row is zero, n2 the survivor count.
//
// Every test is the reference's operation for operation (division, no fused
// multiply-add in any compared quantity), so a2, b2 and n2 are bit-identical
// to it and to the plain version (autobzcore_torch/ops/adaptive.py
// coarsen_pool_plain).
//
// What bounds it on an H100: a lane is at most 2048 slots (48 KB of pool);
// three bitonic sorts of <= 2048 keys in shared memory (66 compare-exchange
// steps each) and a few passes over the slots. The warm sweep calls it with
// one lane (the outer pool, or the harvest's), so one block on one SM and
// the launch bound it; the bytes are ~5 cap x 8 B per lane.
//
// What the design does about it:
//  * one block of 1024 threads per lane, every step in shared memory, so a
//    call is one launch with no global round trips between the steps;
//  * bitonic sort on (key, index) pairs padded to a power of two with
//    (+inf, large index), which is a stable sort, so the three sorts share
//    one routine;
//  * counts (n_live, load, n2) are integer shared-memory atomics, exact in
//    any order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxCap = 2048;
constexpr int kMaxSegs = 64;

__device__ __forceinline__ bool pair_less(double ka, int ia, double kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// ascending bitonic sort of np (a power of two) (key, idx) pairs
__device__ void bitonic_sort(double* key, int* idx, int np) {
  for (int k = 2; k <= np; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < np; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const bool up = (i & k) == 0;
          const bool swap = up ? pair_less(key[p], idx[p], key[i], idx[i])
                               : pair_less(key[i], idx[i], key[p], idx[p]);
          if (swap) {
            const double tk = key[i];
            key[i] = key[p];
            key[p] = tk;
            const int ti = idx[i];
            idx[i] = idx[p];
            idx[p] = ti;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gk_coarsen_kernel(const double* __restrict__ a, const double* __restrict__ b,
                  const double* __restrict__ e, const int64_t* __restrict__ n,
                  const double* __restrict__ segs, const double* __restrict__ tol,
                  double* __restrict__ a2, double* __restrict__ b2, int64_t* __restrict__ n2,
                  int cap, int S1, double merge_factor, double target_mult) {
  __shared__ double key[kMaxCap];
  __shared__ int idx[kMaxCap];
  __shared__ int perm[kMaxCap];
  __shared__ unsigned char flag[kMaxCap];  // bit 0 live_s, bit 1 siblings, bit 2 merge
  __shared__ double sg[kMaxSegs];
  __shared__ int n_live, load, kept;
  const int64_t l = blockIdx.x;
  const double* al = a + l * cap;
  const double* bl = b + l * cap;
  const double* el = e + l * cap;
  const int64_t nl = n[l];
  const double tl = tol[l];
  int np = 1;
  while (np < cap) np <<= 1;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  for (int i = threadIdx.x; i < S1; i += blockDim.x) sg[i] = segs[l * S1 + i];
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    key[i] = (i < cap && i < nl) ? al[i] : inf;
    idx[i] = i;
  }
  if (threadIdx.x == 0) {
    n_live = 0;
    load = 0;
    kept = 0;
  }
  __syncthreads();
  bitonic_sort(key, idx, np);
  for (int i = threadIdx.x; i < cap; i += blockDim.x) perm[i] = idx[i];
  __syncthreads();

  const int nseg = S1 - 1;
  const double span = sg[S1 - 1] - sg[0];
  const double tiny = 2.2250738585072014e-308;
  const double lsafe = span > tiny ? span : tiny;
  // per sorted slot: live, then (reading the neighbour) siblings and cost
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const int s = perm[i];
    const double w = bl[s] - al[s];
    const bool live = s < nl && w > 0;
    flag[i] = live ? 1 : 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const int s = perm[i];
    const double as = al[s], bs = bl[s], es = el[s];
    const double w = bs - as;
    const bool live = flag[i] & 1;
    int cnt = 0;
    for (int q = 0; q < S1; ++q) cnt += sg[q] <= as;
    int seg = cnt - 1;
    seg = seg < 0 ? 0 : (seg > nseg - 1 ? nseg - 1 : seg);
    const double k = (as - sg[seg]) / (w > 0 ? w : 1.0);
    const bool is_left = fabs(__dsub_rn(k, __dmul_rn(rint(k / 2), 2.0))) < 1e-6;
    double an = 0.0, bn = 0.0, en = 0.0;
    bool live_n = false;
    int seg_n = -1;
    if (i + 1 < cap) {
      const int t = perm[i + 1];
      an = al[t];
      bn = bl[t];
      en = el[t];
      live_n = flag[i + 1] & 1;
      int c2 = 0;
      for (int q = 0; q < S1; ++q) c2 += sg[q] <= an;
      seg_n = c2 - 1;
      seg_n = seg_n < 0 ? 0 : (seg_n > nseg - 1 ? nseg - 1 : seg_n);
    }
    const double wn = bn - an;
    const double eps_w = 1e-9 * (w > wn ? w : wn);
    const bool sib = live && live_n && is_left && w > 0 && fabs(bs - an) <= eps_w &&
                     fabs(w - wn) <= eps_w && seg == seg_n;
    const double share = __ddiv_rn(__dmul_rn(tl, __dadd_rn(w, wn)), lsafe);
    const double cost = __dadd_rn(es, en);
    const bool mabs = sib && cost < __dmul_rn(merge_factor, share);
    if (live) atomicAdd(&n_live, 1);
    if (live && es > __ddiv_rn(__dmul_rn(__dmul_rn(0.1, tl), w), lsafe)) atomicAdd(&load, 1);
    key[i] = sib ? cost : inf;  // the sibling costs, for the k-th smallest
    idx[i] = i;
    flag[i] = (live ? 1 : 0) | (sib ? 2 : 0) | (mabs ? 4 : 0);
  }
  for (int i = cap + threadIdx.x; i < np; i += blockDim.x) {
    key[i] = inf;
    idx[i] = i;
  }
  __syncthreads();
  long long target = static_cast<long long>(target_mult * static_cast<double>(load));
  if (target < nseg + 1) target = nseg + 1;
  if (target < 8) target = 8;
  long long need = n_live - target;
  need = need < 0 ? 0 : (need > cap ? cap : need);
  if (need > 0) {  // the same branch in every thread: need is block-uniform
    // the sort scrambles key, so each sibling's cost is recomputed from the
    // pool below (the same two operands, the same sum)
    bitonic_sort(key, idx, np);
    long long q = need - 1;
    q = q < 0 ? 0 : (q > cap - 1 ? cap - 1 : q);
    const double kth = key[q];
    __syncthreads();
    if (isfinite(kth)) {
      for (int i = threadIdx.x; i < cap; i += blockDim.x) {
        if (!(flag[i] & 2)) continue;
        const int s = perm[i], t = perm[i + 1];  // a sibling has a right neighbour
        const double cost = __dadd_rn(el[s], el[t]);
        if (cost <= kth) flag[i] |= 4;
      }
    }
    __syncthreads();
  }
  // keep = live and not the right half of a merge; compaction key !keep
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    bool keep = false;
    if (i < cap) {
      const bool merged_right = i > 0 && (flag[i - 1] & 4);
      keep = (flag[i] & 1) && !merged_right;
      if (keep) atomicAdd(&kept, 1);
    }
    key[i] = (i < cap) ? (keep ? 0.0 : 1.0) : inf;
    idx[i] = i;
  }
  __syncthreads();
  bitonic_sort(key, idx, np);
  double* a2l = a2 + l * cap;
  double* b2l = b2 + l * cap;
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const int j = idx[i];  // sorted position of the i-th survivor
    if (i < kept) {
      const int s = perm[j];
      a2l[i] = al[s];
      b2l[i] = (flag[j] & 4) ? bl[perm[j + 1]] : bl[s];
    } else {
      a2l[i] = 0.0;
      b2l[i] = 0.0;
    }
  }
  if (threadIdx.x == 0) n2[l] = kept;
}

}  // namespace

// a, b, e, a2, b2: (L, cap) float64; n, n2: (L,) int64; segs: (L, S1)
// float64 breakpoints; tol: (L,). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for cap outside 1..2048 or S1 outside
// 2..64.
extern "C" int gk_coarsen_launch(const void* a, const void* b, const void* e, const void* n,
                                 const void* segs, const void* tol, void* a2, void* b2, void* n2,
                                 long long L, int cap, int S1, double merge_factor,
                                 double target_mult, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  if (cap < 1 || cap > kMaxCap || S1 < 2 || S1 > kMaxSegs || L > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  gk_coarsen_kernel<<<static_cast<unsigned>(L), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(b),
      static_cast<const double*>(e), static_cast<const int64_t*>(n),
      static_cast<const double*>(segs), static_cast<const double*>(tol),
      static_cast<double*>(a2), static_cast<double*>(b2), static_cast<int64_t*>(n2), cap, S1,
      merge_factor, target_mult);
  return static_cast<int>(cudaGetLastError());
}
