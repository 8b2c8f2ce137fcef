// K16: the step of the lane-batched Genz-Malik box pool, in FP64.
//
// Replaces autobzcore_tpu/ops/genz_malik.py:152 gm_adaptive's loop test
// (cond, :196-200) and body (:202-230) around the rule. The reference runs
// one pool per solve; here every pool is one row of (L, cap) tensors
// (centres and halves (L, cap, d), err (L, cap), splitdim (L, cap) int32,
// values (L, cap, V)), and one kernel, a block per lane, does in this
// order:
//
//  * update (a step's active lanes): left children over their parents, right
//    children to n..n+nbisect-1 (the reference's two sequential scatters:
//    while fewer than nbisect boxes are live the picks include dead slots
//    that collide with fresh ones, and the fresh slots must win, :216-228;
//    here such a left child is not written), n += nbisect,
//    evals += 2 nbisect P (the dead boxes count too, :230);
//  * totals: tot_val, tot_err and tol = max(atol, rtol |tot_val|_2), and the
//    loop test of the next trip, tot_err > tol, n + nbisect <= cap, evals <
//    max_evals, into the lane's active flag (in a step only on the lanes
//    it updated, at the start on every lane);
//  * select (lanes then active): the worst nbisect boxes (larger error
//    first, ties to the lower slot, as lax.top_k) and their children, each
//    box halved along its splitdim, new half = h (1 - onehot / 2), the
//    centres c -/+ h onehot / 2, left children first (:204-214); other
//    lanes get zero children.
//
// A trip of a solve is the rule on the children and then one launch as a
// step (update, totals, select): the select makes the next trip's children.
// The pool's start is one launch of totals and select.
//
// What bounds it on an H100: a step reads a lane's cap (V + 1) pool
// entries once and writes 2 nbisect boxes and the next children: at cap
// 4096 and V = 1, ~66 KB a lane, ~2 MB for 33 lanes, so bytes bound it
// (0.6 us); at 33 lanes the block's chain of dependent steps (a pass over
// the pool, the reductions, nbisect rounds of the selection) sets its time.
//
// What the design does about it (a launch is a chain of dependent steps on
// 33 SMs, so each step is made one memory latency or one barrier):
//  * the lane's flag, n, evals, atol and picks are read in one batch at
//    the start; the update's writes need no order among themselves (a left
//    child whose parent is a fresh slot is not written), so they are one
//    pass and one barrier;
//  * one pass over the pool: a thread v takes slots v, v + 256, ..., loads
//    kBatch of a field's slots at once (cap 4096 in one batch), adds the
//    error and up to 7 value fields (more take further passes of 8), and
//    stages the errors in shared memory (caps up to kStageCap);
//  * the totals keep the order of the tree they replace, bit for bit:
//    entry v sums its slots in order, then the halving tree over the 256
//    entries, its three cross-warp levels added by one warp a field from
//    shared memory in the tree's pairing, the five within a warp by
//    shuffles (lane v takes lane v + w);
//  * the select, up to kFast picks: each thread keeps its kFast best slots
//    in order (a candidate carried down its list), a warp merges its lanes'
//    lists by kFast rounds of a butterfly arg-max over the heads, and warp
//    0 merges the 8 warps' lists the same way: two block barriers in all.
//    Above kFast (up to kMaxBisect), rounds of a block arg-max, one
//    barrier a round, in which a slot is excluded by the order itself (it
//    comes after the last pick, not a loop over the earlier picks) and only
//    the thread that owned the pick rescans its staged slots. A NaN error
//    is never picked (on a live lane of a solve none is: a NaN makes
//    tot_err NaN and stops the lane); a pick with no candidate left gets
//    slot -1 and zero children;
//  * an update whose picks lie outside the lane's cap slots, or which has
//    no room for its right children, writes nothing, sets the lane's
//    totals to NaN and stops it unconverged.

#include <cuda_runtime.h>

#include <cstdint>

#include "pool_common.cuh"

namespace {

using autobz::kMaxBisect;
constexpr int kThreads = autobz::kPoolThreads;  // 256: the totals' tree has 256 entries
constexpr int kWarps = kThreads / 32;
constexpr int kPassFields = kWarps;             // fields summed in one pass, a warp each
constexpr int kStageCap = 16384;                // errors staged in shared memory up to this cap
constexpr int kBatch = 16;                      // slots a thread loads at once: cap 4096 in one batch
constexpr int kFast = 4;                        // up to this nbisect, picks by merged per-thread lists
constexpr int kNone = 0x7fffffff;               // no candidate
constexpr unsigned kFull = 0xffffffffu;

// (v, s) before (bv, bs): the larger error, then the lower slot
__device__ __forceinline__ bool better(double v, int s, double bv, int bs) {
  return v > bv || (v == bv && s < bs);
}

// (v, s) after the pick (pv, ps) in that order: not yet picked
__device__ __forceinline__ bool after(double v, int s, double pv, int ps) {
  return v < pv || (v == pv && s > ps);
}

// every lane of the warp ends with the warp's best (v, s)
__device__ __forceinline__ void warp_best(double& v, int& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(kFull, v, off);
    const int os = __shfl_xor_sync(kFull, s, off);
    if (better(ov, os, v, s)) {
      v = ov;
      s = os;
    }
  }
}

// This thread's best slot among v, v + 256, ... of el[0..cap) that come
// after the pick (pv, ps), reading kBatch slots at a time.
__device__ __forceinline__ void thread_best(const double* el, int cap, double pv, int ps, double& bv,
                                            int& bs) {
  bv = -1.0 / 0.0;
  bs = kNone;
  for (int base = threadIdx.x; base < cap; base += kThreads * kBatch) {
    double x[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int s = base + i * kThreads;
      x[i] = s < cap ? el[s] : 0.0;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int s = base + i * kThreads;
      if (s < cap && after(x[i], s, pv, ps) && better(x[i], s, bv, bs)) {
        bv = x[i];
        bs = s;
      }
    }
  }
}

// The best of the lists' heads of a warp's lanes, nb times: each lane's
// list (v, s)[0..kFast) in order; the lane whose head wins pops it. Every
// lane ends with the warp's nb best in order in (wv, ws).
__device__ __forceinline__ void warp_merge(double (&v)[kFast], int (&s)[kFast], int nb, double (&wv)[kFast],
                                           int (&ws)[kFast]) {
#pragma unroll
  for (int r = 0; r < kFast; ++r) {
    if (r >= nb) break;
    double bv = v[0];
    int bs = s[0];
    warp_best(bv, bs);
    wv[r] = bv;
    ws[r] = bs;
    if (bs == s[0] && bs != kNone) {
#pragma unroll
      for (int i = 0; i + 1 < kFast; ++i) {
        v[i] = v[i + 1];
        s[i] = s[i + 1];
      }
      v[kFast - 1] = -1.0 / 0.0;
      s[kFast - 1] = kNone;
    }
  }
}

struct Shared {
  double win_v[2][kWarps];  // a round's warp winners, double-buffered; the warps' lists
  int win_s[2][kWarps];
  double cand_v[kWarps * kFast];
  int cand_s[kWarps * kFast];
  double tot[kPassFields];  // a pass's field totals
  double tot0;              // tot_err
  int picks[kMaxBisect];
  int64_t upd[kMaxBisect];  // the update's picks
  int live;
};

// One pass over lane l's pool for the fields f0..f0+G-1 (field 0 the
// error, field 1 + j value j): red[g][v] = the sum of field f0 + g over
// slots v, v + 256, ... in order, then sh.tot[g] = the tree's total. A
// pass from field 0 also stages the errors in el_sh (where not null) and
// puts this thread's best slot in (bv, bs). A thread loads kBatch
// slots of a field at once, so that a field costs one memory latency a
// batch, not one a slot.
__device__ __forceinline__ void pool_pass(const double* el, const double* vl, int cap, int V, int f0,
                                          int G, double* red, double* el_sh, double& bv,
                                          int& bs, Shared& sh) {
  double acc[kPassFields];
#pragma unroll
  for (int g = 0; g < kPassFields; ++g) acc[g] = 0.0;
  for (int base = threadIdx.x; base < cap; base += kThreads * kBatch) {
#pragma unroll
    for (int g = 0; g < kPassFields; ++g) {
      if (g < G) {
        const int f = f0 + g;
        const double* p = f == 0 ? el : vl + (f - 1);
        const int64_t stride = f == 0 ? 1 : V;
        double x[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int s = base + i * kThreads;
          x[i] = s < cap ? p[s * stride] : 0.0;
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int s = base + i * kThreads;
          if (s < cap) {
            acc[g] += x[i];
            if (f == 0) {
              if (el_sh != nullptr) el_sh[s] = x[i];
              if (better(x[i], s, bv, bs)) {
                bv = x[i];
                bs = s;
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kPassFields; ++g) {
    if (g < G) red[g * kThreads + threadIdx.x] = acc[g];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, v = threadIdx.x & 31;
  if (warp < G) {
    // the tree's levels 128, 64 and 32 in their pairing, then 16 .. 1
    const double* r = red + warp * kThreads;
    double c = ((r[v] + r[v + 128]) + (r[v + 64] + r[v + 192])) +
               ((r[v + 32] + r[v + 160]) + (r[v + 96] + r[v + 224]));
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) c += __shfl_down_sync(kFull, c, w);
    if (v == 0) sh.tot[warp] = c;
  }
  __syncthreads();
}

// c, h: (L, cap, d); err: (L, cap); sd: (L, cap) int32; val: (L, cap, V);
// n: (L,) int64; evals, atol, tot_err, tol: (L,); tot_val: (L, V); active:
// (L,) bool; idx: (L, nb) int64; cc, hh: (L, 2 nb, d); cval: (L, 2 nb, V),
// cerr: (L, 2 nb), csd: (L, 2 nb) int32. The pool's arrays are read and
// written in one launch, so none is read through the read-only path.
__global__ void __launch_bounds__(kThreads)
gm_pool_kernel(bool step, double* c, double* h, double* err, int* sd, double* val, int64_t* n,
               double* evals, double* __restrict__ tot_val, double* __restrict__ tot_err,
               double* __restrict__ tol, const double* __restrict__ atol, bool* active, int64_t* idx,
               double* cc, double* hh, const double* __restrict__ cval,
               const double* __restrict__ cerr, const int* __restrict__ csd, int cap, int d, int V,
               int nb, double trip_evals, double rtol, double max_evals) {
  extern __shared__ __align__(16) double dyn[];
  __shared__ Shared sh;
  const int64_t l = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G0 = V + 1 < kPassFields ? V + 1 : kPassFields;  // fields of the first pass
  double* red = dyn;                                         // (G0, kThreads)
  double* el_sh = cap <= kStageCap ? dyn + G0 * kThreads : nullptr;
  double* el = err + l * cap;
  double* vl = val + l * cap * V;
  // the lane's flag, counts and picks in one batch of loads
  bool live = active[l];
  const int64_t n0 = n[l];
  const int64_t pick = step && tid < nb ? idx[l * nb + tid] : 0;
  double ev0 = 0.0, at0 = 0.0;
  if (tid == 0) {
    ev0 = evals[l];
    at0 = atol[l];
  }
  __syncthreads();  // every thread has read the flag before thread 0 may write it

  int64_t n1 = n0;  // n after the update
  if (step && live) {
    bool bad = n0 < 0 || n0 + nb > cap || (tid < nb && (pick < 0 || pick >= cap));
    if (tid < nb) sh.upd[tid] = pick;
    if (__syncthreads_or(bad)) {
      const double nan = __longlong_as_double(0x7ff8000000000000LL);
      for (int f = tid; f < V; f += kThreads) tot_val[l * V + f] = nan;
      if (tid == 0) {
        tot_err[l] = nan;
        active[l] = false;
      }
      live = false;
    } else {
      // left children over their parents, right children to the fresh
      // slots; a left child whose parent is a fresh slot (a picked dead
      // slot) is not written, so the right child there wins, as the
      // reference's second scatter makes it, without an order between them
      const int F = 2 * d + 2 + V;  // fields of a box: c (d), h (d), err, splitdim, values (V)
      for (int q = tid; q < 2 * nb * F; q += kThreads) {
        const int j = q % (2 * nb);  // the child, left ones first
        const int f = q / (2 * nb);
        const int64_t at = j < nb ? sh.upd[j] : n0 + (j - nb);
        if (j < nb && at >= n0 && at < n0 + nb) continue;
        const int64_t slot = l * cap + at;
        const int64_t ch = l * 2 * nb + j;
        if (f < d) c[slot * d + f] = cc[ch * d + f];
        else if (f < 2 * d) h[slot * d + f - d] = hh[ch * d + f - d];
        else if (f == 2 * d) err[slot] = cerr[ch];
        else if (f == 2 * d + 1) sd[slot] = csd[ch];
        else val[slot * V + (f - 2 * d - 2)] = cval[ch * V + (f - 2 * d - 2)];
      }
      __syncthreads();
      n1 = n0 + nb;
      ev0 += trip_evals;
      if (tid == 0) {
        n[l] = n1;
        evals[l] = ev0;
      }
    }
  }

  double bv = -1.0 / 0.0;
  int bs = kNone;
  if (live || !step) {
    // tot_err and the first values in one pass with the staging, the rest
    // 8 fields a pass; norm2 in field order, as the tree it replaces
    double norm2 = 0.0;
    for (int f0 = 0; f0 <= V; f0 += kPassFields) {
      const int G = V + 1 - f0 < kPassFields ? V + 1 - f0 : kPassFields;
      pool_pass(el, vl, cap, V, f0, G, red, el_sh, bv, bs, sh);
      if (tid == 0) {
        for (int g = 0; g < G; ++g) {
          const double t = sh.tot[g];
          if (f0 + g == 0) {
            tot_err[l] = t;
            sh.tot0 = t;
          } else {
            tot_val[l * V + f0 + g - 1] = t;
            norm2 += t * t;
          }
        }
      }
      __syncthreads();  // sh.tot and red are free for the next pass
    }
    if (tid == 0) {
      const double tl = fmax(at0, rtol * sqrt(norm2));
      tol[l] = tl;
      const bool go = live && sh.tot0 > tl && n1 + nb <= cap && ev0 < max_evals;
      active[l] = go;
      sh.live = go;
    }
    __syncthreads();
    live = sh.live;
  }

  double* ccl = cc + l * 2 * nb * d;
  double* hhl = hh + l * 2 * nb * d;
  if (!live) {
    for (int j = tid; j < 2 * nb * d; j += kThreads) {
      ccl[j] = 0.0;
      hhl[j] = 0.0;
    }
    for (int j = tid; j < nb; j += kThreads) idx[l * nb + j] = 0;
    return;
  }
  __syncthreads();  // the staged errors
  const double* es = el_sh != nullptr ? el_sh : el;
  int k = 0;
  if (nb <= kFast) {
    // this thread's kFast best slots in order (a candidate carried down the
    // list), the warp's nb best by nb rounds over the lists' heads, then
    // warp 0 merges the warps' lists the same way
    double tv[kFast], mv[kFast];
    int ts[kFast], ms[kFast];
#pragma unroll
    for (int i = 0; i < kFast; ++i) {
      tv[i] = -1.0 / 0.0;
      ts[i] = kNone;
    }
    for (int base = tid; base < cap; base += kThreads * kBatch) {
      double x[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int s = base + i * kThreads;
        x[i] = s < cap ? es[s] : 0.0;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        double cv = x[i];
        int cs = base + i * kThreads;
        if (cs >= cap || !better(cv, cs, tv[kFast - 1], ts[kFast - 1])) continue;
#pragma unroll
        for (int q = 0; q < kFast; ++q) {
          if (better(cv, cs, tv[q], ts[q])) {
            const double t = tv[q];
            const int u = ts[q];
            tv[q] = cv;
            ts[q] = cs;
            cv = t;
            cs = u;
          }
        }
      }
    }
    warp_merge(tv, ts, nb, mv, ms);
    if (lane < nb) {
      sh.cand_v[warp * kFast + lane] = lane == 0 ? mv[0] : (lane == 1 ? mv[1] : (lane == 2 ? mv[2] : mv[3]));
      sh.cand_s[warp * kFast + lane] = lane == 0 ? ms[0] : (lane == 1 ? ms[1] : (lane == 2 ? ms[2] : ms[3]));
    }
    __syncthreads();
    if (warp == 0) {
      // lane i holds candidate i of the warps' lists, as a list of one
      double cv[kFast];
      int cs[kFast];
      const bool has = lane < kWarps * kFast && (lane % kFast) < nb;
      cv[0] = has ? sh.cand_v[lane] : -1.0 / 0.0;
      cs[0] = has ? sh.cand_s[lane] : kNone;
#pragma unroll
      for (int i = 1; i < kFast; ++i) {
        cv[i] = -1.0 / 0.0;
        cs[i] = kNone;
      }
      warp_merge(cv, cs, nb, mv, ms);
      if (lane < nb) sh.picks[lane] = (lane == 0 ? ms[0] : (lane == 1 ? ms[1] : (lane == 2 ? ms[2] : ms[3])));
    }
    __syncthreads();
    for (int j = tid; j < nb; j += kThreads) {
      if (sh.picks[j] == kNone) sh.picks[j] = -1;
    }
    k = nb;
  }
  double wv = bv;
  int ws = bs;
  if (k < nb) warp_best(wv, ws);
  for (; k < nb; ++k) {
    const int b = k & 1;
    if (lane == 0) {
      sh.win_v[b][warp] = wv;
      sh.win_s[b][warp] = ws;
    }
    __syncthreads();
    double pv = sh.win_v[b][0];
    int ps = sh.win_s[b][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (better(sh.win_v[b][w], sh.win_s[b][w], pv, ps)) {
        pv = sh.win_v[b][w];
        ps = sh.win_s[b][w];
      }
    }
    if (ps == kNone) break;  // no candidate left: the same for every thread
    if (tid == 0) sh.picks[k] = ps;
    if (k + 1 < nb && warp == (ps % kThreads) >> 5) {
      if (tid == ps % kThreads) thread_best(es, cap, pv, ps, bv, bs);
      wv = bv;
      ws = bs;
      warp_best(wv, ws);
    }
  }
  for (int j = k + tid; j < nb; j += kThreads) sh.picks[j] = -1;
  __syncthreads();
  for (int q = tid; q < nb * d; q += kThreads) {
    const int j = q / d, i = q % d;
    const int s = sh.picks[j];
    double left = 0.0, right = 0.0, nh = 0.0;
    if (s >= 0) {
      const int64_t src = (l * cap + s) * d + i;
      const double h0 = h[src], c0 = c[src];
      // the reference's one-hot arithmetic: h (1 - onehot / 2), h onehot / 2
      const double onehot = sd[l * cap + s] == i ? 1.0 : 0.0;
      nh = h0 * (1.0 - onehot / 2.0);
      const double off = h0 * onehot / 2.0;
      left = c0 - off;
      right = c0 + off;
    }
    ccl[j * d + i] = left;
    ccl[(nb + j) * d + i] = right;
    hhl[j * d + i] = nh;
    hhl[(nb + j) * d + i] = nh;
    if (i == 0) idx[l * nb + j] = s;
  }
}

}  // namespace

// One launch of K16: with step 0 a pool's start (totals and select on
// every lane; cval, cerr and csd unused and may be null), with step 1 a
// trip's step (update, totals and select on the active lanes). Pools as
// above. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for step outside 0..1, nb outside 1..kMaxBisect,
// d, V or cap below 1.
extern "C" int gm_pool_launch(int step, void* c, void* h, void* err, void* sd, void* val, void* n,
                              void* evals, void* tot_val, void* tot_err, void* tol, const void* atol,
                              void* active, void* idx, void* cc, void* hh, const void* cval,
                              const void* cerr, const void* csd, long long L, int cap, int d, int V,
                              int nb, double trip_evals, double rtol, double max_evals, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  if (step < 0 || step > 1 || L > 0x7fffffffLL || nb < 1 || nb > kMaxBisect || d < 1 || V < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G0 = V + 1 < kPassFields ? V + 1 : kPassFields;
  const size_t smem = sizeof(double) * (static_cast<size_t>(G0) * kThreads + (cap <= kStageCap ? cap : 0));
  if (smem > 46 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(gm_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gm_pool_kernel<<<static_cast<unsigned>(L), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      step != 0, static_cast<double*>(c), static_cast<double*>(h), static_cast<double*>(err),
      static_cast<int*>(sd), static_cast<double*>(val), static_cast<int64_t*>(n),
      static_cast<double*>(evals), static_cast<double*>(tot_val), static_cast<double*>(tot_err),
      static_cast<double*>(tol), static_cast<const double*>(atol), static_cast<bool*>(active),
      static_cast<int64_t*>(idx), static_cast<double*>(cc), static_cast<double*>(hh),
      static_cast<const double*>(cval), static_cast<const double*>(cerr),
      static_cast<const int*>(csd), cap, d, V, nb, trip_evals, rtol, max_evals);
  return static_cast<int>(cudaGetLastError());
}
