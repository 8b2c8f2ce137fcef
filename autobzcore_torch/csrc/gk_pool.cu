// K5: the lane-batched Gauss-Kronrod interval pool, in FP64.
//
// Replaces autobzcore_tpu/ops/adaptive.py:236 gk_adaptive's start (the
// breakpoints' segments evaluated and padded to the pool, :380-396), its loop
// test (cond, :410-420) and body (:422-465: lax.top_k over the errors, the
// bisection, the two sequential scatters, n += nbisect, evals += count), the
// totals it recomputes each trip (:393-396), the warm start's chunk write
// (:309-359, seed_body :344-353), and the reduction of :72 gk_rule_eval
// (:99-140) that every trip applies to the children's node values. The
// reference runs one pool per solve under vmap; here every pool is one row of
// (L, cap) tensors and three entries serve a solve:
//
//  * start: the cold pool from the rule's outputs on the breakpoints'
//    segments (slots 0..K-1, zeros to cap), n = K, evals = their count, the
//    lane live; or, given no children, the pool as it stands. Then every
//    lane's totals, and with `select` the first loop test and picks;
//  * seed: one chunk of re-evaluated seed intervals to the contiguous slots
//    start..start+C-1 of each seeding lane, n = n0, evals += the chunk's count
//    (every slot counts); with `partition`, the first chunk of a solve, every
//    slot of every lane starts from the inherited partition with zero values
//    and counts. Then every lane's totals, and with `select` the test and
//    picks. The per-lane remap and dead-slot masking of the seed pools
//    (autobzcore_tpu/algorithms/nested.py:198-231 _mid_seed_pool), and the
//    choice of start = min(k C, cap - C), stay in the caller;
//  * step, one launch a trip after the rule: per live lane, the children's
//    rule reduction (from their node values, or as the rule reduced them),
//    left children over their parents and right children to n..n+nb-1 (the
//    reference's two sequential scatters: while n < nb a picked dead slot
//    collides with a fresh slot and the right child wins, so such a left
//    child is not written), n += nb, evals += the count, the totals and
//    tol = max(atol, rtol |tot_val|_2), the loop test tot_err > tol,
//    n + nb <= cap, evals < max_evals, and where it holds the next trip's
//    worst nb intervals (ties to the lower slot, as lax.top_k) and their
//    children (left halves first); where it fails the lane stops for good.
//
// gk_rule_reduce is the rule's reduction alone, on no solver's path: it
// serves the public gk_rule_eval (a rule on one set of intervals, outside a
// pool), and the card tests, which hand the plain pool versions the step's
// reduction bits with it (the step reduces with the same code).
//
// What bounds it on an H100: a step reads a lane's cap (V + 1) pool entries
// and its children's 2 nb P node values and writes 2 nb slots and the next
// children: at the nest's mid level (990 lanes, cap 64, nb 1, 15 nodes) ~0.9
// MB, a quarter microsecond of device memory; the leaf start writes its 29,700
// pools whole (76 MB at cap 64, V = 1), ~23 us. A trip's launch is short and
// its lanes few, so the chain of dependent steps inside a lane, and launch
// latency, set its time.
//
// What the design does about it:
//  * a team of threads a lane: one warp (8 lanes a block of 256) up to cap
//    256, so no lane waits on a block barrier and a small level fills the
//    card with blocks of 8 lanes; one block above (the outermost level's cap
//    2048), where a warp's 64 slots a thread would serialize its loads. The
//    two teams give the same bits: the warp forms of the totals and of the
//    select in pool_common.cuh keep the block forms' order;
//  * the reduction takes a thread a child, the children's nodes in order
//    and their values in order, the code of the reduction alone; the count is
//    a sum of integers, exact in any order, taken by warp shuffles;
//  * the scatters need no order: a left child whose parent slot is a fresh
//    slot is not written, so every child is written at once;
//  * an update whose picks lie outside the lane's cap slots, or which has no
//    room for its right children, writes nothing and sets the lane's totals
//    to NaN, so the lane stops unconverged instead of writing out of bounds.

#include <cuda_runtime.h>

#include <cstdint>

#include "pool_common.cuh"

namespace {

using autobz::kMaxBisect;
using autobz::kWarpMask;
constexpr int kBlock = autobz::kPoolThreads;  // threads a block, in either team
constexpr int kWarpLanes = kBlock / 32;       // lanes a block in the warp team
constexpr int kWarpTeamMaxCap = 256;          // above this cap a lane takes a block
constexpr int kWarpTeamBlocks = 4;            // blocks an SM in the warp team (64 registers a thread)

// One interval's rule from its P node values f0 (P x W doubles, W = V, or 2 V
// for complex values as (re, im) pairs) and half width: its W values to vo,
// err = |vK - vG|_2 and l1 = |sum_p wk_p |f_p|| half, over the V values in
// order; a dead interval (half = 0) is exactly 0.
__device__ __forceinline__ void gk_rule_child(const double* __restrict__ f0, double half,
                                              const double* __restrict__ wk,
                                              const double* __restrict__ wg, int P, int V,
                                              int is_complex, double* __restrict__ vo, double& err,
                                              double& l1) {
  const int W = is_complex ? 2 * V : V;  // doubles per node
  if (half == 0.0) {
    for (int q = 0; q < W; ++q) vo[q] = 0.0;
    err = 0.0;
    l1 = 0.0;
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
  err = sqrt(e2);
  l1 = sqrt(l2);
}

// A lane's pool and its state (see gk_pool_step_launch).
struct Pool {
  double *a, *b, *err, *l1, *val;
  int64_t* n;
  double *evals, *tot_val, *tot_err, *tol;
  const double* atol;
  bool* active;
  int64_t* idx;    // (L, nb): the next trip's picks
  double *ca, *cb; // (L, 2 nb): their children, left halves first
  int cap, Vd, nb; // Vd: doubles a slot's value
  double rtol, max_evals;
};

// The rule's children, K a row: node values (form 1) fx (R, K, P, Vd) with
// per-node counts (R, K, P) or none and half widths (R, K), or reduced (form
// 0) values (R, K, Vd), err, l1 (R, K) and a count a row (R,).
struct Kids {
  int form;
  const double *v, *counts, *half, *wk, *wg, *err, *l1, *count;
  int K, P, cplx;
};

template <int T>
struct Team;

template <>
struct Team<32> {
  __device__ static int rank() { return threadIdx.x & 31; }
  __device__ static int64_t lane() {
    return static_cast<int64_t>(blockIdx.x) * kWarpLanes + (threadIdx.x >> 5);
  }
  __device__ static void sync() { __syncwarp(); }
  __device__ static bool any(bool x) { return __any_sync(kWarpMask, x); }
  __device__ static double bcast(double x, double*) { return __shfl_sync(kWarpMask, x, 0); }
};

template <>
struct Team<kBlock> {
  __device__ static int rank() { return threadIdx.x; }
  __device__ static int64_t lane() { return blockIdx.x; }
  __device__ static void sync() { __syncthreads(); }
  __device__ static bool any(bool x) { return __syncthreads_or(x); }
  __device__ static double bcast(double x, double* slot) {
    if (threadIdx.x == 0) *slot = x;
    __syncthreads();
    const double y = *slot;
    __syncthreads();
    return y;
  }
};

// Shared scratch of a block: the block team's reduction and selection
// entries, and each lane's picks.
struct Scratch {
  double rv[kBlock], red[kBlock];
  int rs[kBlock];
  int chosen[kWarpLanes][kMaxBisect];
  double cast;
};

// Child k of row `row` (row < 0: zero values and count, the rows the rule
// did not evaluate) to the pool slot `slot` with the interval (a, b).
__device__ __forceinline__ void put_child(const Pool& p, const Kids& c, int64_t row, int k,
                                          int64_t slot, double a, double b) {
  p.a[slot] = a;
  p.b[slot] = b;
  double* vo = p.val + slot * p.Vd;
  if (row < 0) {
    for (int q = 0; q < p.Vd; ++q) vo[q] = 0.0;
    p.err[slot] = 0.0;
    p.l1[slot] = 0.0;
    return;
  }
  const int64_t t = row * c.K + k;
  if (c.form == 1) {
    double e, l;
    const int V = c.cplx ? p.Vd / 2 : p.Vd;
    gk_rule_child(c.v + t * c.P * p.Vd, c.half[t], c.wk, c.wg, c.P, V, c.cplx, vo, e, l);
    p.err[slot] = e;
    p.l1[slot] = l;
  } else {
    for (int q = 0; q < p.Vd; ++q) vo[q] = c.v[t * p.Vd + q];
    p.err[slot] = c.err[t];
    p.l1[slot] = c.l1[t];
  }
}

// The count of row `row` on the team's rank 0: its K P node counts summed
// (integers, exact in any order) by the team's first warp, K P without
// counts, the rule's count when reduced, 0 for row < 0.
__device__ __forceinline__ double row_count(const Kids& c, int64_t row, int r) {
  if (row < 0) return 0.0;
  if (c.form == 0) return c.count[row];
  if (c.counts == nullptr) return static_cast<double>(c.K) * c.P;
  if (r >= 32) return 0.0;
  const int m = c.K * c.P;
  const double* x = c.counts + row * m;
  double s = 0.0;
  for (int q = r; q < m; q += 32) s += x[q];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kWarpMask, s, off);
  return s;
}

template <int T>
__device__ __forceinline__ void lane_totals(const Pool& p, int64_t l, Scratch& sc, double& te,
                                            double& tl) {
  if constexpr (T == 32) {
    autobz::pool_lane_totals_warp(p.err, p.val, p.tot_val, p.tot_err, p.tol, p.atol, l, p.cap, p.Vd,
                                  p.rtol, te, tl);
  } else {
    autobz::pool_lane_totals(p.err, p.val, p.tot_val, p.tot_err, p.tol, p.atol, sc.red, l, p.cap,
                             p.Vd, p.rtol);
    __syncthreads();
    te = p.tot_err[l];
    tl = p.tol[l];
  }
}

// The loop test's outcome `go` for lane l: its worst nb intervals and their
// children, or, where the test fails, zero children and the lane stopped.
template <int T>
__device__ __forceinline__ void select_or_stop(const Pool& p, int64_t l, bool go, Scratch& sc) {
  const int r = Team<T>::rank(), nb = p.nb, cap = p.cap;
  double* cal = p.ca + l * 2 * nb;
  double* cbl = p.cb + l * 2 * nb;
  if (!go) {
    for (int j = r; j < 2 * nb; j += T) {
      cal[j] = 0.0;
      cbl[j] = 0.0;
    }
    for (int j = r; j < nb; j += T) p.idx[l * nb + j] = 0;
    if (r == 0) p.active[l] = false;
    return;
  }
  int* chosen = sc.chosen[T == 32 ? (threadIdx.x >> 5) : 0];
  if constexpr (T == 32) {
    autobz::pool_select_worst_warp(p.err + l * cap, cap, nb, chosen);
  } else {
    autobz::pool_select_worst(p.err + l * cap, cap, nb, chosen, sc.rv, sc.rs);
  }
  for (int j = r; j < nb; j += T) {
    const int s = chosen[j];
    const bool ok = s >= 0 && s < cap;
    const double aa = ok ? p.a[l * cap + s] : 0.0, bb = ok ? p.b[l * cap + s] : 0.0;
    const double mm = (aa + bb) / 2;
    p.idx[l * nb + j] = s;
    cal[j] = aa;
    cal[nb + j] = mm;
    cbl[j] = mm;
    cbl[nb + j] = bb;
  }
  if (r == 0) p.active[l] = true;
}

// A team a lane: with children, the cold pool (slots 0..K-1 from the
// children, whose intervals are ia, ib (L, K), zeros to cap; n = K, evals =
// their count, the lane live); then the totals, and with `select` the loop
// test and the first picks.
template <int T>
__global__ void __launch_bounds__(kBlock, T == 32 ? kWarpTeamBlocks : 1)
gk_pool_start_kernel(Pool p, Kids c, const double* __restrict__ ia, const double* __restrict__ ib,
                     int64_t L, int select) {
  __shared__ Scratch sc;
  const int64_t l = Team<T>::lane();
  if (l >= L) return;
  const int r = Team<T>::rank();
  const int cap = p.cap;
  if (c.form >= 0) {
    const int K = c.K;
    for (int s = r; s < cap; s += T) {
      const int64_t slot = l * cap + s;
      if (s < K) {
        put_child(p, c, l, s, slot, ia[l * K + s], ib[l * K + s]);
      } else {
        p.a[slot] = 0.0;
        p.b[slot] = 0.0;
        p.err[slot] = 0.0;
        p.l1[slot] = 0.0;
        for (int q = 0; q < p.Vd; ++q) p.val[slot * p.Vd + q] = 0.0;
      }
    }
    const double cnt = row_count(c, l, r);
    if (r == 0) {
      p.n[l] = K;
      p.evals[l] = cnt;
      p.active[l] = true;
    }
    Team<T>::sync();
  }
  double te, tl;
  lane_totals<T>(p, l, sc, te, tl);
  if (select) {
    Team<T>::sync();
    const bool go = p.active[l] && te > tl && p.n[l] + p.nb <= cap && p.evals[l] < p.max_evals;
    select_or_stop<T>(p, l, go, sc);
  }
}

// A team a lane: a seeding lane writes its chunk (children row rows[l], or
// l where rows is null; intervals from the pool's own a, b) to slots
// start..start+K-1, sets n = n0 and adds the chunk's count to evals; with
// `part` (pa, pb (L, cap)), every lane first starts from the partition with
// zero values, n = 0, evals = 0 and the lane live. Then every lane's totals,
// and with `select` the loop test and the first picks.
template <int T>
__global__ void __launch_bounds__(kBlock, T == 32 ? kWarpTeamBlocks : 1)
gk_pool_seed_kernel(Pool p, Kids c, const double* __restrict__ pa, const double* __restrict__ pb,
                    const int64_t* __restrict__ n0, const bool* __restrict__ seeding,
                    const int64_t* __restrict__ rows, int64_t L, int start, int select) {
  __shared__ Scratch sc;
  const int64_t l = Team<T>::lane();
  if (l >= L) return;
  const int r = Team<T>::rank();
  const int cap = p.cap, K = c.K;
  const bool seeds = seeding[l];
  const int64_t row = rows != nullptr ? rows[l] : l;
  if (pa != nullptr) {
    for (int s = r; s < cap; s += T) {
      const int64_t slot = l * cap + s;
      if (seeds && s >= start && s < start + K) {
        put_child(p, c, row, s - start, slot, pa[slot], pb[slot]);
      } else {
        p.a[slot] = pa[slot];
        p.b[slot] = pb[slot];
        p.err[slot] = 0.0;
        p.l1[slot] = 0.0;
        for (int q = 0; q < p.Vd; ++q) p.val[slot * p.Vd + q] = 0.0;
      }
    }
  } else if (seeds) {
    for (int k = r; k < K; k += T) {
      const int64_t slot = l * cap + start + k;
      put_child(p, c, row, k, slot, p.a[slot], p.b[slot]);
    }
  }
  const double cnt = seeds ? row_count(c, row, r) : 0.0;
  if (r == 0) {
    const double before = pa != nullptr ? 0.0 : p.evals[l];
    if (seeds) {
      p.n[l] = n0[l];
      p.evals[l] = before + cnt;
    } else if (pa != nullptr) {
      p.n[l] = 0;
      p.evals[l] = 0.0;
    }
    if (pa != nullptr) p.active[l] = true;
  }
  Team<T>::sync();
  double te, tl;
  lane_totals<T>(p, l, sc, te, tl);
  if (select) {
    Team<T>::sync();
    const bool go = p.active[l] && te > tl && p.n[l] + p.nb <= cap && p.evals[l] < p.max_evals;
    select_or_stop<T>(p, l, go, sc);
  }
}

// A team a children row i (R rows, lane live[i], or i where live is null),
// on live lanes: the trip's update, totals, loop test and next picks.
template <int T>
__global__ void __launch_bounds__(kBlock, T == 32 ? kWarpTeamBlocks : 1)
gk_pool_step_kernel(Pool p, Kids c, const int64_t* __restrict__ live, int64_t R) {
  __shared__ Scratch sc;
  const int64_t i = Team<T>::lane();
  if (i >= R) return;
  const int64_t l = live != nullptr ? live[i] : i;
  if (!p.active[l]) return;
  const int r = Team<T>::rank();
  const int nb = p.nb, cap = p.cap;
  const int64_t n0 = p.n[l];
  const double ev0 = p.evals[l];
  bool bad = n0 < 0 || n0 + nb > cap;
  for (int j = r; j < nb; j += T) {
    const int64_t s = p.idx[l * nb + j];
    bad |= s < 0 || s >= cap;
  }
  bad = Team<T>::any(bad);
  double te, tl;
  int64_t n1 = n0;
  double ev1 = ev0;
  if (bad) {
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    for (int f = r; f < p.Vd; f += T) p.tot_val[l * p.Vd + f] = nan;
    if (r == 0) p.tot_err[l] = nan;
    te = nan;
    tl = 0.0;
  } else {
    const double* cal = p.ca + l * 2 * nb;
    const double* cbl = p.cb + l * 2 * nb;
    for (int k = r; k < 2 * nb; k += T) {
      int64_t s;
      if (k < nb) {
        s = p.idx[l * nb + k];
        if (s >= n0 && s < n0 + nb) continue;  // a fresh slot: its right child wins
      } else {
        s = n0 + (k - nb);
      }
      put_child(p, c, i, k, l * cap + s, cal[k], cbl[k]);
    }
    const double cnt = Team<T>::bcast(row_count(c, i, r), &sc.cast);
    n1 = n0 + nb;
    ev1 = ev0 + cnt;
    Team<T>::sync();
    if (r == 0) {
      p.n[l] = n1;
      p.evals[l] = ev1;
    }
    lane_totals<T>(p, l, sc, te, tl);
    Team<T>::sync();
  }
  select_or_stop<T>(p, l, te > tl && n1 + nb <= cap && ev1 < p.max_evals, sc);
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
  const int W = is_complex ? 2 * V : V;
  double e, l1v;
  gk_rule_child(fx + t * P * W, half_w[t], wk, wg, P, V, is_complex, val + t * W, e, l1v);
  err[t] = e;
  l1[t] = l1v;
}

Pool make_pool(void* const* q, int cap, int Vd, int nb, double rtol, double max_evals) {
  Pool p;
  p.a = static_cast<double*>(q[0]);
  p.b = static_cast<double*>(q[1]);
  p.err = static_cast<double*>(q[2]);
  p.l1 = static_cast<double*>(q[3]);
  p.val = static_cast<double*>(q[4]);
  p.n = static_cast<int64_t*>(q[5]);
  p.evals = static_cast<double*>(q[6]);
  p.tot_val = static_cast<double*>(q[7]);
  p.tot_err = static_cast<double*>(q[8]);
  p.tol = static_cast<double*>(q[9]);
  p.atol = static_cast<const double*>(q[10]);
  p.active = static_cast<bool*>(q[11]);
  p.idx = static_cast<int64_t*>(q[12]);
  p.ca = static_cast<double*>(q[13]);
  p.cb = static_cast<double*>(q[14]);
  p.cap = cap;
  p.Vd = Vd;
  p.nb = nb;
  p.rtol = rtol;
  p.max_evals = max_evals;
  return p;
}

Kids make_kids(int form, const void* v, const void* counts, const void* half, const void* wk,
               const void* wg, const void* err, const void* l1, const void* count, int K, int P,
               int cplx) {
  Kids c;
  c.form = form;
  c.v = static_cast<const double*>(v);
  c.counts = static_cast<const double*>(counts);
  c.half = static_cast<const double*>(half);
  c.wk = static_cast<const double*>(wk);
  c.wg = static_cast<const double*>(wg);
  c.err = static_cast<const double*>(err);
  c.l1 = static_cast<const double*>(l1);
  c.count = static_cast<const double*>(count);
  c.K = K;
  c.P = P;
  c.cplx = cplx;
  return c;
}

// The team of a pool's lanes: a warp up to cap 256, a block above.
int pick_team(int cap) { return cap <= kWarpTeamMaxCap ? 32 : kBlock; }

unsigned grid_of(int team, long long lanes) {
  return static_cast<unsigned>(team == 32 ? (lanes + kWarpLanes - 1) / kWarpLanes : lanes);
}

bool bad_pool(long long L, int cap, int Vd, int nb) {
  return L > 0x7fffffffLL || cap < 1 || cap > (1 << 16) || Vd < 1 || nb < 1 || nb > kMaxBisect;
}

}  // namespace

// The pool's 15 pointers (q): a, b, err, l1 (L, cap) float64; val (L, cap, Vd)
// float64 (complex values as (re, im) pairs, Vd counting doubles); n (L,)
// int64; evals, tot_val (L, Vd), tot_err, tol, atol (L,) float64; active (L,)
// bool; idx (L, nb) int64; ca, cb (L, 2 nb) float64. The children (form 1,
// node values): v = fx (R, K, P, Vd), counts (R, K, P) or null, half (R, K),
// wk, wg (P,); (form 0, reduced): v = values (R, K, Vd), err, l1 (R, K),
// count (R,). Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for arguments it does not take.

// The cold start (form 0 or 1, R = L rows in lane order, ia, ib (L, K), K <=
// cap) or, with form -1, the totals of the pool as it stands; `select`
// adds the loop test and the first picks.
extern "C" int gk_pool_start_launch(void* const* q, const void* ia, const void* ib, int form,
                                    const void* v, const void* counts, const void* half,
                                    const void* wk, const void* wg, const void* err,
                                    const void* l1, const void* count, long long L, int cap,
                                    int Vd, int nb, double rtol, double max_evals, int K, int P,
                                    int cplx, int select, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  const int team = pick_team(cap);
  if (bad_pool(L, cap, Vd, nb) || form < -1 || form > 1 || (form >= 0 && (K < 1 || K > cap)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Pool p = make_pool(q, cap, Vd, nb, rtol, max_evals);
  const Kids c = make_kids(form, v, counts, half, wk, wg, err, l1, count, K, P, cplx);
  const auto* a0 = static_cast<const double*>(ia);
  const auto* b0 = static_cast<const double*>(ib);
  auto* s = static_cast<cudaStream_t>(stream);
  if (team == 32)
    gk_pool_start_kernel<32><<<grid_of(team, L), kBlock, 0, s>>>(p, c, a0, b0, L, select);
  else
    gk_pool_start_kernel<kBlock><<<grid_of(team, L), kBlock, 0, s>>>(p, c, a0, b0, L, select);
  return static_cast<int>(cudaGetLastError());
}

// One seed chunk of K slots at `start` (form 0 or 1); pa, pb (L, cap) the
// partition for the first chunk, or null; n0 (L,) int64; seeding (L,) bool;
// rows (L,) int64, each lane's children row or -1, or null for rows in lane
// order; `select` adds the loop test and the first picks.
extern "C" int gk_pool_seed_launch(void* const* q, const void* pa, const void* pb, const void* n0,
                                   const void* seeding, const void* rows, int form, const void* v,
                                   const void* counts, const void* half, const void* wk,
                                   const void* wg, const void* err, const void* l1,
                                   const void* count, long long L, int cap, int Vd, int nb,
                                   double rtol, double max_evals, int K, int P, int cplx, int start,
                                   int select, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  const int team = pick_team(cap);
  if (bad_pool(L, cap, Vd, nb) || form < 0 || form > 1 || K < 1 || start < 0 ||
      start + K > cap)
    return static_cast<int>(cudaErrorInvalidValue);
  const Pool p = make_pool(q, cap, Vd, nb, rtol, max_evals);
  const Kids c = make_kids(form, v, counts, half, wk, wg, err, l1, count, K, P, cplx);
  const auto* a0 = static_cast<const double*>(pa);
  const auto* b0 = static_cast<const double*>(pb);
  const auto* m = static_cast<const int64_t*>(n0);
  const auto* sd = static_cast<const bool*>(seeding);
  const auto* rw = static_cast<const int64_t*>(rows);
  auto* s = static_cast<cudaStream_t>(stream);
  if (team == 32)
    gk_pool_seed_kernel<32><<<grid_of(team, L), kBlock, 0, s>>>(p, c, a0, b0, m, sd, rw, L, start, select);
  else
    gk_pool_seed_kernel<kBlock><<<grid_of(team, L), kBlock, 0, s>>>(p, c, a0, b0, m, sd, rw, L, start,
                                                                    select);
  return static_cast<int>(cudaGetLastError());
}

// A trip's step: R children rows of K = 2 nb children (form 0 or 1), row i
// belonging to lane live[i] (live (R,) int64), or to lane i (live null, R =
// L).
extern "C" int gk_pool_step_launch(void* const* q, const void* live, const void* v,
                                   const void* counts, const void* half, const void* wk,
                                   const void* wg, const void* err, const void* l1,
                                   const void* count, long long L, long long R, int cap, int Vd,
                                   int nb, double rtol, double max_evals, int P, int cplx,
                                   int form, void* stream) {
  if (L <= 0 || R <= 0) return static_cast<int>(cudaGetLastError());
  const int team = pick_team(cap);
  if (bad_pool(L, cap, Vd, nb) || form < 0 || form > 1 || R > L)
    return static_cast<int>(cudaErrorInvalidValue);
  const Pool p = make_pool(q, cap, Vd, nb, rtol, max_evals);
  const Kids c = make_kids(form, v, counts, half, wk, wg, err, l1, count, 2 * nb, P, cplx);
  const auto* lv = static_cast<const int64_t*>(live);
  auto* s = static_cast<cudaStream_t>(stream);
  if (team == 32)
    gk_pool_step_kernel<32><<<grid_of(team, R), kBlock, 0, s>>>(p, c, lv, R);
  else
    gk_pool_step_kernel<kBlock><<<grid_of(team, R), kBlock, 0, s>>>(p, c, lv, R);
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
