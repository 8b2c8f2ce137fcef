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
//  * the per-node arithmetic is one device function that is never inlined
//    (leaf_node_dos), and the rule's sums two small ones (rule_add,
//    rule_close), shared with the fused solve below: one compiled copy of
//    the node arithmetic, so both give the same bits;
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

#include "pool_common.cuh"
#include "small_trace.cuh"

namespace {

using autobz::cmul;
using autobz::trace_inv_imag;

constexpr int kThreads = 128;
constexpr int kMaxNodes = 64;
constexpr int kMaxGroup = 8;  // frequency channels per group (see the header)
constexpr double kNegInvPi = -0.31830988618379067154;  // -1/pi

// D_w at the node x (in [-1, 1]) of the interval [a, b], for the nw <= 8
// channels z_w = om[w] + i eta[w], into d[0..nw): the series of the lane's
// coefficients cl (n terms of m*m values) and the closed-form trace. Never
// inlined, so K4 and the fused solve run one compiled copy of it.
template <int M>
__device__ __noinline__ void leaf_node_dos(const double2* __restrict__ cl, int n, int offset, double inv_t, double a,
                                           double b, double x, const double* om, const double* eta, int nw,
                                           double* d) {
  constexpr int MM = M * M;
  const double mid = (a + b) / 2, half = (b - a) / 2;
  const double u = (mid + half * x) * inv_t;
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
  for (int w = 0; w < nw; ++w) d[w] = kNegInvPi * trace_inv_imag<M>(h, make_double2(om[w], eta[w]));
}

// one node's terms of a channel's Kronrod, Gauss and L1 sums
__device__ __forceinline__ void rule_add(double& sk, double& sg, double& sl, double wk, double wg, double d) {
  sk += wk * d;
  sg += wg * d;
  sl += wk * fabs(d);
}

// a channel's value; its squared error and squared L1 go to e2, l2
__device__ __forceinline__ double rule_close(double sk, double sg, double sl, double half, double& e2, double& l2) {
  const double vk = sk * half, vg = sg * half, vl = sl * half;
  const double dv = vk - vg;
  e2 += dv * dv;
  l2 += vl * vl;
  return vk;
}

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
                   int offset, double inv_t) {
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
  const bool live = active[l];
  if (t - l * I == 0) count[l] = live ? static_cast<double>(I) * P : 0.0;
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
  const double2* cl = c + cm * static_cast<int64_t>(n) * MM;
  double e2 = 0.0, l2 = 0.0;
  for (int w0 = 0; w0 < W; w0 += G) {
    const int nw = W - w0 < G ? W - w0 : G;  // channels of this group
    double sk[G], sg[G], sl[G], d[G];
#pragma unroll
    for (int w = 0; w < G; ++w) sk[w] = sg[w] = sl[w] = 0.0;
    for (int p = 0; p < P; ++p) {
      leaf_node_dos<M>(cl, n, offset, inv_t, a, b, sx[p], om + l * W + w0, eta + l * W + w0, nw, d);
#pragma unroll
      for (int w = 0; w < G; ++w) {
        if (w < nw) rule_add(sk[w], sg[w], sl[w], swk[p], swg[p], d[w]);
      }
    }
#pragma unroll
    for (int w = 0; w < G; ++w) {
      if (w < nw) vrow[w0 + w] = rule_close(sk[w], sg[w], sl[w], half, e2, l2);
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
  double inv_t;
};

template <int M, int G>
void launch(unsigned blocks, cudaStream_t st, const LeafArgs& q) {
  gk_leaf_dos_kernel<M, G><<<blocks, kThreads, 0, st>>>(
      q.c, q.cmap, q.ca, q.cb, q.om, q.eta, q.active, q.xk, q.wk, q.wg, q.val, q.err, q.l1,
      q.count, q.L, q.Lc, q.I, q.P, q.n, q.W, q.offset, q.inv_t);
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

// --- the leaf-level solve in one launch (gk_leaf_dos_solve) --------------------
//
// Replaces, at the leaf of autobzcore_tpu/algorithms/nested.py:445-517
// (solve_level with d_rem == 1), the whole while loop of
// autobzcore_tpu/ops/adaptive.py:236-471 gk_adaptive under vmap: every
// lane's pool (after its cold or seeded start) refines to its own end, as
// the trip route does it: K5's select (the loop test tot_err > tol, n +
// nbisect <= cap, evals < max_evals; the nbisect worst slots with
// lax.top_k's ties, :427), K4's rule at the 2 nbisect children, K5's update
// (left children over their parents, then right children to n..n+nbisect-1,
// so the right child wins where they collide; n, evals; the totals in
// pool_common.cuh's order). The trip route's three launches per trip and
// the host's test between trips become one launch per leaf-level solve.
//
// What bounds it on an H100: the FP64 arithmetic of the nodes (~600
// operations a node at m = 3, 2 nbisect x 15 nodes a trip), the same work
// as the trip route's K4; the trip route moves the pool through device
// memory three times a trip and waits on the host. Here a block of
// kSolveThreads threads owns one lane for all its trips:
//  * the lane's pool (a, b, err, l1, val: cap (4 + W) doubles, 2.5 KB at
//    cap 64, W = 1) lives in shared memory, read once and written once;
//  * the lane's coefficients (n m^2 complex values, 720 B at the flagship)
//    are staged once by cp.async;
//  * a trip: the select over shared memory; then one thread per (child,
//    node) (2 nbisect x 15 = 120 at the flagship) evaluates leaf_node_dos
//    into shared memory; one thread per child adds its K15, G7 and L1 sums
//    in node order and channel order, as K4 adds them; then the two
//    scatters and the totals, in the pool kernels' order.
// So pools, totals, n, evals and active come out equal to the trip route's.

constexpr int kSolveThreads = 128;

struct SolveArgs {
  double *a, *b, *err, *l1, *val;
  int64_t* n;
  double *evals, *tot_val, *tot_err, *tol;
  const double* atol;
  bool* active;
  int64_t* trips;
  const double2* c;
  const int64_t* cmap;
  const double *om, *eta, *xk, *wk, *wg;
  int64_t Lc;
  int cap, W, nb, P, nterms, offset;
  double inv_t, rtol, max_evals;
};

// The dynamic shared memory of one lane, in doubles: the coefficients first
// (16-byte aligned for cp.async), then the pool, the rule, the channels,
// the totals, the node values and the children.
struct SolveLayout {
  int coef, pa, pb, perr, pl1, pval, sx, swk, swg, som, seta, stot, dnode, cha, chb, cerr, cl1, cval, total;
  __host__ __device__ SolveLayout(int cap, int W, int nb, int P, int nterms, int mm) {
    coef = 0;
    pa = coef + 2 * nterms * mm;
    pb = pa + cap;
    perr = pb + cap;
    pl1 = perr + cap;
    pval = pl1 + cap;
    sx = pval + cap * W;
    swk = sx + P;
    swg = swk + P;
    som = swg + P;
    seta = som + W;
    stot = seta + W;
    dnode = stot + W;
    cha = dnode + 2 * nb * P * W;
    chb = cha + 2 * nb;
    cerr = chb + 2 * nb;
    cl1 = cerr + 2 * nb;
    cval = cl1 + 2 * nb;
    total = cval + 2 * nb * W;
  }
};

__device__ __forceinline__ void stage16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

template <int M>
__global__ void __launch_bounds__(kSolveThreads) gk_leaf_dos_solve_kernel(SolveArgs q) {
  constexpr int MM = M * M;
  extern __shared__ __align__(16) double sm[];
  __shared__ double rv[autobz::kPoolThreads], red[autobz::kPoolThreads];
  __shared__ int rs[autobz::kPoolThreads];
  __shared__ int chosen[autobz::kMaxBisect];
  __shared__ int64_t s_n;
  __shared__ double s_evals, s_tot_err, s_tol, s_atol;
  const int64_t l = blockIdx.x;
  const int tid = threadIdx.x;
  if (!q.active[l]) {
    if (tid == 0) q.trips[l] = 0;
    return;
  }
  const int cap = q.cap, W = q.W, nb = q.nb, P = q.P;
  const SolveLayout lay(cap, W, nb, P, q.nterms, MM);
  double2* coef = reinterpret_cast<double2*>(sm + lay.coef);
  double *pa = sm + lay.pa, *pb = sm + lay.pb, *perr = sm + lay.perr, *pl1 = sm + lay.pl1, *pval = sm + lay.pval;
  double *sx = sm + lay.sx, *swk = sm + lay.swk, *swg = sm + lay.swg, *som = sm + lay.som, *seta = sm + lay.seta;
  double *stot = sm + lay.stot, *dnode = sm + lay.dnode, *cha = sm + lay.cha, *chb = sm + lay.chb;
  double *cerr = sm + lay.cerr, *cl1 = sm + lay.cl1, *cval = sm + lay.cval;
  const int64_t cm = q.cmap[l];
  const bool cm_ok = cm >= 0 && cm < q.Lc;
  if (cm_ok) {
    const double2* src = q.c + cm * static_cast<int64_t>(q.nterms) * MM;
    for (int i = tid; i < q.nterms * MM; i += blockDim.x) stage16(coef + i, src + i);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  const int64_t base = l * cap;
  for (int i = tid; i < cap; i += blockDim.x) {
    pa[i] = q.a[base + i];
    pb[i] = q.b[base + i];
    perr[i] = q.err[base + i];
    pl1[i] = q.l1[base + i];
  }
  for (int i = tid; i < cap * W; i += blockDim.x) pval[i] = q.val[base * W + i];
  for (int i = tid; i < P; i += blockDim.x) {
    sx[i] = q.xk[i];
    swk[i] = q.wk[i];
    swg[i] = q.wg[i];
  }
  for (int i = tid; i < W; i += blockDim.x) {
    som[i] = q.om[l * W + i];
    seta[i] = q.eta[l * W + i];
    stot[i] = q.tot_val[l * W + i];
  }
  if (tid == 0) {
    s_n = q.n[l];
    s_evals = q.evals[l];
    s_tot_err = q.tot_err[l];
    s_tol = q.tol[l];
    s_atol = q.atol[l];
  }
  if (cm_ok) asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  const int I = 2 * nb;
  int64_t trips = 0;
  while (s_tot_err > s_tol && s_n + nb <= cap && s_evals < q.max_evals) {
    autobz::pool_select_worst(perr, cap, nb, chosen, rv, rs);
    for (int j = tid; j < nb; j += blockDim.x) {
      const double aa = pa[chosen[j]], bb = pb[chosen[j]];
      const double mm = (aa + bb) / 2;
      cha[j] = aa;
      chb[j] = mm;
      cha[nb + j] = mm;
      chb[nb + j] = bb;
    }
    __syncthreads();
    // the node values, one thread per (child, node)
    if (cm_ok) {
      for (int t = tid; t < I * P; t += blockDim.x) {
        const int i = t / P, p = t - (t / P) * P;
        const double a = cha[i], b = chb[i];
        if ((b - a) / 2 == 0.0) continue;
        for (int w0 = 0; w0 < W; w0 += kMaxGroup) {
          const int nw = W - w0 < kMaxGroup ? W - w0 : kMaxGroup;
          leaf_node_dos<M>(coef, q.nterms, q.offset, q.inv_t, a, b, sx[p], som + w0, seta + w0, nw,
                           dnode + static_cast<int64_t>(t) * W + w0);
        }
      }
    }
    __syncthreads();
    // each child's sums in node order, channels in order (K4's order)
    for (int i = tid; i < I; i += blockDim.x) {
      const double half = (chb[i] - cha[i]) / 2;
      double* cv = cval + i * W;
      if (half == 0.0) {
        for (int w = 0; w < W; ++w) cv[w] = 0.0;
        cerr[i] = 0.0;
        cl1[i] = 0.0;
      } else if (!cm_ok) {
        const double nan = __longlong_as_double(0x7ff8000000000000LL);
        for (int w = 0; w < W; ++w) cv[w] = nan;
        cerr[i] = nan;
        cl1[i] = nan;
      } else {
        double e2 = 0.0, l2 = 0.0;
        for (int w = 0; w < W; ++w) {
          double sk = 0.0, sg = 0.0, sl = 0.0;
          for (int p = 0; p < P; ++p) rule_add(sk, sg, sl, swk[p], swg[p], dnode[(i * P + p) * W + w]);
          cv[w] = rule_close(sk, sg, sl, half, e2, l2);
        }
        cerr[i] = sqrt(e2);
        cl1[i] = sqrt(l2);
      }
    }
    __syncthreads();
    const int64_t n0 = s_n;
    if (n0 < 0) {
      // the pool kernels' answer to a pool they cannot write: NaN totals,
      // so the lane stops unconverged
      const double nan = __longlong_as_double(0x7ff8000000000000LL);
      for (int f = tid; f < W; f += blockDim.x) stot[f] = nan;
      if (tid == 0) s_tot_err = nan;
      ++trips;
      __syncthreads();
      continue;
    }
    for (int phase = 0; phase < 2; ++phase) {
      // phase 0: left children over their parents; phase 1: right children
      // to the fresh slots, after every left child is written
      for (int t = tid; t < nb * (W + 4); t += blockDim.x) {
        const int j = t % nb, f = t / nb;  // f 0..3: a, b, err, l1; 4..: value entries
        const int slot = phase == 0 ? chosen[j] : static_cast<int>(n0) + j;
        const int ch = phase * nb + j;
        if (f == 0) pa[slot] = cha[ch];
        else if (f == 1) pb[slot] = chb[ch];
        else if (f == 2) perr[slot] = cerr[ch];
        else if (f == 3) pl1[slot] = cl1[ch];
        else pval[slot * W + (f - 4)] = cval[ch * W + (f - 4)];
      }
      __syncthreads();
    }
    if (tid == 0) {
      s_n = n0 + nb;
      s_evals += static_cast<double>(I) * P;  // K4's count, added as K5 adds it
    }
    autobz::pool_lane_totals(perr, pval, stot, &s_tot_err, &s_tol, &s_atol, red, 0, cap, W, q.rtol);
    __syncthreads();
    ++trips;
  }
  if (trips > 0) {
    for (int i = tid; i < cap; i += blockDim.x) {
      q.a[base + i] = pa[i];
      q.b[base + i] = pb[i];
      q.err[base + i] = perr[i];
      q.l1[base + i] = pl1[i];
    }
    for (int i = tid; i < cap * W; i += blockDim.x) q.val[base * W + i] = pval[i];
    for (int i = tid; i < W; i += blockDim.x) q.tot_val[l * W + i] = stot[i];
  }
  if (tid == 0) {
    if (trips > 0) {
      q.n[l] = s_n;
      q.evals[l] = s_evals;
      q.tot_err[l] = s_tot_err;
      q.tol[l] = s_tol;
    }
    q.active[l] = false;
    q.trips[l] = trips;
  }
}

size_t solve_smem_bytes(int cap, int W, int nb, int P, int nterms, int m) {
  return static_cast<size_t>(SolveLayout(cap, W, nb, P, nterms, m * m).total) * sizeof(double);
}

template <int M>
int solve_launch(long long L, size_t smem, cudaStream_t st, const SolveArgs& q) {
  if (smem > 40 * 1024) {  // with the static scratch, past the 48 KB a block gets unasked
    const cudaError_t e = cudaFuncSetAttribute(gk_leaf_dos_solve_kernel<M>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gk_leaf_dos_solve_kernel<M><<<static_cast<unsigned>(L), kSolveThreads, smem, st>>>(q);
  return static_cast<int>(cudaGetLastError());
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
                   static_cast<double*>(count), L, Lc, I, P, n, W, offset, 1.0 / period};
  if (m == 1) {
    dispatch<1>(blocks, st, q);
  } else if (m == 2) {
    dispatch<2>(blocks, st, q);
  } else {
    dispatch<3>(blocks, st, q);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of shared memory the solve takes per lane (the most a block may
// take on an H100 is 227 KB).
extern "C" long long gk_leaf_dos_solve_smem(int cap, int W, int nb, int P, int nterms, int m) {
  return static_cast<long long>(solve_smem_bytes(cap, W, nb, P, nterms, m));
}

// The pool a, b, err, l1: (L, cap); val: (L, cap, W); n: (L,) int64; evals,
// tot_err, tol, atol: (L,); tot_val: (L, W); active: (L,) bool; all but
// atol updated in place. trips: (L,) int64, written: each lane's trips.
// c: (Lc, nterms, m*m) complex128 as double2, 16-byte aligned; cmap: (L,)
// int64 into Lc; om, eta: (L, W); xk, wk, wg: (P,). Returns
// cudaErrorInvalidValue for m outside 1..3, W < 1, P outside 1..kMaxNodes,
// nb outside 1..kMaxBisect or an unaligned c, else cudaGetLastError() after
// the launch.
extern "C" int gk_leaf_dos_solve_launch(void* a, void* b, void* err, void* l1, void* val, void* n, void* evals,
                                        void* tot_val, void* tot_err, void* tol, const void* atol, void* active,
                                        void* trips, const void* c, const void* cmap, const void* om,
                                        const void* eta, const void* xk, const void* wk, const void* wg, long long L,
                                        long long Lc, int cap, int W, int nb, int P, int nterms, int m, int offset,
                                        double period, double rtol, double max_evals, void* stream) {
  if (m < 1 || m > 3 || W < 1 || P < 1 || P > kMaxNodes || nb < 1 || nb > autobz::kMaxBisect || cap < 1 ||
      nterms < 1 || L > 0x7fffffffLL || (reinterpret_cast<uintptr_t>(c) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  const SolveArgs q{static_cast<double*>(a), static_cast<double*>(b), static_cast<double*>(err),
                    static_cast<double*>(l1), static_cast<double*>(val), static_cast<int64_t*>(n),
                    static_cast<double*>(evals), static_cast<double*>(tot_val), static_cast<double*>(tot_err),
                    static_cast<double*>(tol), static_cast<const double*>(atol), static_cast<bool*>(active),
                    static_cast<int64_t*>(trips), static_cast<const double2*>(c), static_cast<const int64_t*>(cmap),
                    static_cast<const double*>(om), static_cast<const double*>(eta),
                    static_cast<const double*>(xk), static_cast<const double*>(wk),
                    static_cast<const double*>(wg), static_cast<int64_t>(Lc), cap, W, nb, P, nterms, offset,
                    1.0 / period, rtol, max_evals};
  const size_t smem = solve_smem_bytes(cap, W, nb, P, nterms, m);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 1) return solve_launch<1>(L, smem, st, q);
  if (m == 2) return solve_launch<2>(L, smem, st, q);
  return solve_launch<3>(L, smem, st, q);
}
