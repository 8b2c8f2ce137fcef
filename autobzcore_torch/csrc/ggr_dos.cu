// K13: the spectral-grid DOS sums of GGR (box mode) and of adaptive
// Gaussian broadening (Gaussian mode), in FP64.
//
// Replaces autobzcore_tpu/dos/ggr.py:30-75 (_ggr_1d, _ggr_2d, _ggr_3d) with
// the per-energy sum of :303-307, and autobzcore_tpu/dos/tetrahedron.py:325-327
// (the dense Gaussian sum of AdaptiveGaussianBroadening). Over the terms
// t = (k, band) of the spectral grid (energies e (K, m), weights w (K,)) it
// computes, for each energy E_j,
//
//   box:      out[j] = sum_t w_k f_d(b, |E_j - e_t|, sorted |v_t|)
//   Gaussian: out[j] = scale * sum_t w_k norm_t exp(-0.5 ((E_j - e_t) / sigma_t)^2)
//
// with f_d the reference's closed forms of a box-broadened delta in d = 1,
// 2, 3 (velocities v (K, d, m)), in its branch order (dw <= w1, then
// v1 >= v2 + v3; dw <= w2, w3, w4), its _EPS = 1e-300 guards and its gate
// v1 > vtol on the largest |v|. |v| of each term is sorted in registers by a
// min/max network (exact).
//
// What bounds it on an H100: in box mode a term is zero outside
// |E - e| <= b (v1 + v2 + v3), so the work the function needs is one
// support test per term and ~30 FP64 operations per (energy, term) pair
// inside the support (3.7e7 pairs at the flagship's 3e6 terms x 1001
// energies, 1.2 % of all pairs); in Gaussian mode ~40 per pair whose exp
// does not underflow (1.7e9 there). FP64 throughput is the limit; the
// inputs are 100 MB.
//
// The design: a term reaches only the energies of its support.
//  * Above kFewE the energies come sorted (the wrapper sorts a copy and
//    puts the values back, as K10's). A block owns a chunk of up to kChunkE of them
//    (blockIdx.y), staged in shared memory with the block's sums, and walks
//    tiles of kThreads consecutive k-points of one band (band-major), so
//    that a tile's energies are close and its range narrow.
//  * A thread stages one term of a tile: its constants in shared memory (in
//    box mode the sorted |v|, the thresholds w1..w4 and the per-term parts
//    of the closed forms; in Gaussian mode e, w, 1 / sigma and the norm)
//    and its support as a range [lo, hi) of energy indices, by two binary
//    searches with the pair's own test (|E - e| <= wmax in box mode, t^2 <=
//    1500 in Gaussian mode, as the sum tests it): rounding is monotone, so
//    the energies that pass form one range. A gated term (v1 <= vtol) has
//    none. The tile's range is the union.
//  * Box mode (narrow supports, ~12 energies a term at the flagship): the
//    tile's (term, energy) pairs are numbered in term order by a block scan
//    of the supports' sizes and evaluated a pair a thread, in rounds of
//    kPairs values in shared memory, so that every lane of a warp
//    evaluates. Then over the tile's range a thread owns an energy (128
//    consecutive ones a step), walks the tile's terms in order and adds the
//    values of those whose support holds it: a warp walks only the terms a
//    ballot finds in its 32 energies.
//  * Gaussian mode (wide supports, ~580 energies a term): the owner of an
//    energy evaluates its pairs in place, walking the tile's terms two at a
//    time (two independent chains of FP64 operations in flight) and adding
//    them in term order.
//  * Each energy has one owner in a tile, so the block's sums in shared
//    memory take the tiles, and in a tile the terms, in a fixed order.
//  * Blocks run in no order, so the cross-block sum is a second pass over
//    lane-major partials, 256 threads an energy in a fixed order
//    (column_sum.cuh's lane_sum: one thread an energy down ~1,000 block
//    rows waits on each load in turn). No atomics on floating-point
//    values: repeats are bit-identical.
//  * At most kFewE energies go term by term: a thread per (k, band) term
//    with the energies in registers, a fixed tree over the block.
// In Gaussian mode staged pairs (~74,000 a tile) would take ~50 rounds a
// tile, each with a walk over the tile's terms; there nearly every lane of
// a warp is inside the support anyway.
//
// Arithmetic: every term of box mode is computed with the plain version's
// operations, unfused (see mul below), so a term's bits are those of the
// per-term closed form; a case's numerator and denominator are chosen first
// and divided once. Gaussian mode multiplies by one reciprocal of sigma per
// term (staged) in place of a division per pair, and takes exp(-t^2 / 2)
// from exp_neg, a polynomial specialised to arguments in [-750, 0]: both
// change a term's bits at the 1e-16 level (ROADMAP C6). The sums run in
// another order than the plain version's.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"

namespace {

constexpr int kThreads = 128;        // threads a block = terms a tile
constexpr int kWarps = kThreads / 32;
constexpr int kChunkE = 1024;        // sorted energies a block row
constexpr int kFewE = 4;             // at most this many energies go term by term
constexpr int kPairs = 1536;         // box mode: (term, energy) pairs a round
constexpr int kMaxBlocks = 8 * 132;  // blocks over all the energy chunks
constexpr unsigned kFull = 0xffffffffu;
constexpr double kEps = 1e-300;      // the reference's _EPS
constexpr double kUnderflow = 1500;  // t^2 above which exp(-0.5 t^2) is 0.0

// Sums of products are written with the rounding intrinsics, which nvcc
// does not fuse into FMAs: each term then rounds as the plain version's
// separate multiplies and adds do. Where a closed form cancels (one |v| at
// rounding level, e.g. at a symmetric k-point), the term's value is made of
// its rounding errors, and only the same operations give the same value.
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

__device__ __forceinline__ void cswap_desc(double& a, double& b) {
  const double hi = fmax(a, b), lo = fmin(a, b);
  a = hi;
  b = lo;
}

// 2^(j/32), j = 0..31, rounded to double
__constant__ double kExp2Table[32] = {
    0x1.0000000000000p+0, 0x1.059b0d3158574p+0, 0x1.0b5586cf9890fp+0, 0x1.11301d0125b51p+0,
    0x1.172b83c7d517bp+0, 0x1.1d4873168b9aap+0, 0x1.2387a6e756238p+0, 0x1.29e9df51fdee1p+0,
    0x1.306fe0a31b715p+0, 0x1.371a7373aa9cbp+0, 0x1.3dea64c123422p+0, 0x1.44e086061892dp+0,
    0x1.4bfdad5362a27p+0, 0x1.5342b569d4f82p+0, 0x1.5ab07dd485429p+0, 0x1.6247eb03a5585p+0,
    0x1.6a09e667f3bcdp+0, 0x1.71f75e8ec5f74p+0, 0x1.7a11473eb0187p+0, 0x1.82589994cce13p+0,
    0x1.8ace5422aa0dbp+0, 0x1.93737b0cdc5e5p+0, 0x1.9c49182a3f090p+0, 0x1.a5503b23e255dp+0,
    0x1.ae89f995ad3adp+0, 0x1.b7f76f2fb5e47p+0, 0x1.c199bdd85529cp+0, 0x1.cb720dcef9069p+0,
    0x1.d5818dcfba487p+0, 0x1.dfc97337b9b5fp+0, 0x1.ea4afa2a490dap+0, 0x1.f50765b6e4540p+0};

// exp(x) for x in [-750, 0] from tab, a copy of kExp2Table in shared
// memory: x = (32 k + j) ln 2 / 32 + r with |r| <= ln 2 / 64 (n = 32 k + j
// rounded by adding 1.5 2^52, which leaves it in the low bits), exp(r) by
// its Taylor polynomial to r^6 (relative error below 1e-17 on that range),
// times 2^(j/32) from the table, then 2^k added to the exponent where the
// result is normal; below 2^-1020 it is multiplied in as two normal powers
// of two, so that the result rounds once more, to a subnormal, and
// exp(-750) to 0. A result is within ~2 ulp of exp(x).
__device__ __forceinline__ double exp_neg(double x, const double* tab) {
  constexpr double kShift = 6755399441055744.0;  // 1.5 2^52
  const double t = fma(x, 46.166241308446828, kShift);  // 32 / ln 2
  const double n = t - kShift;
  const int nn = __double2loint(t);  // in [-34,624, 0]
  double r = fma(n, -2.1660849392498290e-02, x);      // ln 2 / 32, split in two
  r = fma(n, -7.247021293269686e-19, r);
  double p = 1.0 / 720.0;
  p = fma(p, r, 1.0 / 120.0);
  p = fma(p, r, 1.0 / 24.0);
  p = fma(p, r, 1.0 / 6.0);
  p = fma(p, r, 0.5);
  p = fma(p, r, 1.0);
  p = fma(p, r, 1.0);
  p *= tab[nn & 31];
  const int k = nn >> 5;  // floor(n / 32), in [-1083, 0]
  if (k >= -1020) return __longlong_as_double(__double_as_longlong(p) + (static_cast<long long>(k) << 52));
  const int k1 = k / 2, k2 = k - k1;
  return p * __longlong_as_double(static_cast<long long>(k1 + 1023) << 52) *
         __longlong_as_double(static_cast<long long>(k2 + 1023) << 52);
}

// Per-term constants, field-major (stride s). Box fields by d:
//  d = 1: r = 1 / max(v1, EPS)
//  d = 2: w1, r1 = 2b / max(v1, EPS), d12 = max(v1 v2, EPS)
//  d = 3: w1, w2, w3, caseA, PB = 2 b^2 (v1 v2 + v2 v3 + v3 v1), vvb2 = (vv b)^2,
//         d123, PC = b^2 (v1 v2 + 3 v2 v3 + v3 v1), PC2 = -v1 + v2 + v3,
//         PD = b (v1 + v2), d12, ab = (v1 >= v2 + v3)
// after e, w and the support half-width wmax (b v1, b (v1 + v2), w4), or
// wmax = -1 for a term the gate v1 > vtol drops. Gaussian fields: e, w,
// 1 / sigma, norm.
constexpr int kFields = 15;
enum { F_E, F_W, F_WMAX, F_0 };

template <int D>
__host__ __device__ constexpr int num_fields() {
  return D < 2 ? F_0 + 1 : (D == 2 ? F_0 + 3 : F_0 + 12);
}

// Box mode: term (e, w, velocities vk[0], vk[m], vk[2m]) into f[i s].
template <int D>
__device__ __forceinline__ void box_term(double* f, int s, double e, double w, const double* vk, int m,
                                         double b, double vtol) {
  double v1 = fabs(vk[0]), v2 = D > 1 ? fabs(vk[m]) : 0.0, v3 = D > 2 ? fabs(vk[2 * m]) : 0.0;
  if constexpr (D == 2) cswap_desc(v1, v2);
  if constexpr (D == 3) {
    cswap_desc(v1, v2);
    cswap_desc(v2, v3);
    cswap_desc(v1, v2);
  }
  f[F_E * s] = e;
  f[F_W * s] = w;
  if (!(v1 > vtol)) {
    f[F_WMAX * s] = -1.0;
    return;
  }
  if constexpr (D == 1) {
    f[F_WMAX * s] = b * v1;
    f[F_0 * s] = 1.0 / fmax(v1, kEps);
  } else if constexpr (D == 2) {
    f[F_WMAX * s] = b * (v1 + v2);
    f[F_0 * s] = b * fabs(v1 - v2);
    f[(F_0 + 1) * s] = 2 * b / fmax(v1, kEps);
    f[(F_0 + 2) * s] = fmax(v1 * v2, kEps);
  } else {
    const double vv = sqrt(add(add(mul(v1, v1), mul(v2, v2)), mul(v3, v3)));
    f[F_WMAX * s] = b * (v1 + v2 + v3);
    f[F_0 * s] = b * fabs(v1 - v2 - v3);
    f[(F_0 + 1) * s] = b * (v1 - v2 + v3);
    f[(F_0 + 2) * s] = b * (v1 + v2 - v3);
    f[(F_0 + 3) * s] = 4 * (b * b) / fmax(v1, kEps);
    f[(F_0 + 4) * s] = 2 * (b * b) * add(add(mul(v1, v2), mul(v2, v3)), mul(v3, v1));
    f[(F_0 + 5) * s] = (vv * b) * (vv * b);
    f[(F_0 + 6) * s] = fmax(v1 * v2 * v3, kEps);
    f[(F_0 + 7) * s] = (b * b) * add(add(mul(v1, v2), mul(3 * v2, v3)), mul(v3, v1));
    f[(F_0 + 8) * s] = -v1 + v2 + v3;
    f[(F_0 + 9) * s] = b * (v1 + v2);
    f[(F_0 + 10) * s] = fmax(v1 * v2, kEps);
    f[(F_0 + 11) * s] = v1 >= v2 + v3 ? 1.0 : 0.0;
  }
}

// The closed form at dw <= wmax, from the term's fields (stride s): the
// case's numerator and denominator, then one division.
template <int D>
__device__ __forceinline__ double box_value(const double* f, int s, double dw, double b) {
  if constexpr (D == 1) {
    return f[F_0 * s];
  } else if constexpr (D == 2) {
    const double r = (f[F_WMAX * s] - dw) / f[(F_0 + 2) * s];
    return dw <= f[F_0 * s] ? f[(F_0 + 1) * s] : r;
  } else {
    const double q = add(mul(dw, dw), f[(F_0 + 5) * s]);  // dw^2 + (vv b)^2
    double num, den = f[(F_0 + 6) * s];
    if (dw <= f[F_0 * s]) {
      const bool a = f[(F_0 + 11) * s] != 0.0;
      num = a ? f[(F_0 + 3) * s] : sub(f[(F_0 + 4) * s], q);
      den = a ? 1.0 : den;
    } else if (dw <= f[(F_0 + 1) * s]) {
      const double lin = mul(mul(b, dw), f[(F_0 + 8) * s]);
      num = sub(sub(f[(F_0 + 7) * s], lin), q / 2);
    } else if (dw <= f[(F_0 + 2) * s]) {
      num = 2 * b * (f[(F_0 + 9) * s] - dw);
      den = f[(F_0 + 10) * s];
    } else {
      const double x = f[F_WMAX * s] - dw;
      num = mul(x, x);
      den = 2 * f[(F_0 + 6) * s];
    }
    return num / den;
  }
}

// Term (k, band) of the spectral grid into f (stride s). D = 1..3 is box
// mode (a the velocities (K, D, m)), D = 0 Gaussian mode (a the widths
// (K, m), nrm the norms).
template <int D>
struct Terms {
  const double* __restrict__ e;
  const double* __restrict__ a;
  const double* __restrict__ nrm;
  const double* __restrict__ w;
  int64_t K;
  int m;
  double b, vtol;

  __device__ __forceinline__ void stage(double* f, int s, int64_t k, int band) const {
    const int64_t p = k * m + band;
    if constexpr (D == 0) {
      f[F_E * s] = e[p];
      f[F_W * s] = w[k];
      f[F_WMAX * s] = 1.0 / a[p];
      f[F_0 * s] = nrm[p];
    } else {
      box_term<D>(f, s, e[p], w[k], a + k * D * m + band, m, b, vtol);
    }
  }

  // the term's addend at energy En: whether it is inside the support, and
  // the value w f there (tab: exp_neg's table, Gaussian mode)
  __device__ __forceinline__ bool value(const double* f, int s, double En, double& out,
                                        const double* tab) const {
    const double et = f[F_E * s];
    if constexpr (D == 0) {
      // computed whatever the test (exp(0) outside it), without a branch
      const double x = (En - et) * f[F_WMAX * s];
      const double x2 = x * x;
      const bool in = x2 <= kUnderflow;
      out = mul(f[F_W * s], f[F_0 * s] * exp_neg(in ? -0.5 * x2 : 0.0, tab));
      return in;
    } else {
      const double dw = fabs(En - et);
      if (!(dw <= f[F_WMAX * s])) return false;
      out = mul(f[F_W * s], box_value<D>(f, s, dw, b));
    }
    return true;
  }

  // whether the energy En lies beyond the term's support on the side of
  // the larger energies (above) or of the smaller (below): the pair's own
  // test, so the energies inside form one range of the sorted energies
  __device__ __forceinline__ bool beyond(const double* f, int s, double En, bool above) const {
    const double et = f[F_E * s];
    if (above ? !(En > et) : !(En < et)) return false;
    if constexpr (D == 0) {
      const double x = (En - et) * f[F_WMAX * s];
      return x * x > kUnderflow;
    } else {
      return fabs(En - et) > f[F_WMAX * s];
    }
  }

  // whether the term reaches no energy: gated off, or NaN constants
  __device__ __forceinline__ bool empty(const double* f, int s) const {
    const double et = f[F_E * s];
    if constexpr (D == 0) return !(et == et) || !(f[F_WMAX * s] == f[F_WMAX * s]);
    else return !(et == et) || !(f[F_WMAX * s] >= 0.0);
  }
};

// the first j of [0, n) at which pred(j) turns true (false before, true
// from there on), or n
template <class Pred>
__device__ __forceinline__ int first_true(int n, Pred pred) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (!pred(lo + half)) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

template <int D>
struct TileShared {
  static constexpr int NF = num_fields<D>();
  double sf[NF * kThreads];  // the tile's terms, field-major
  int2 sup[kThreads];        // their supports [lo, hi); (0, 0) when empty
  int off[kThreads];         // box mode: their first pairs
  double tab[32];            // Gaussian mode: exp_neg's table
  double sE[kChunkE], acc[kChunkE];
  int wlo[kWarps], whi[kWarps], wsum[kWarps];
};

// partials[j, blockIdx.x] = the block's sum over its tiles' terms at energy
// j of its chunk (lane-major); E (W,) sorted ascending. At each energy the
// terms add in tile order, and in a tile in term order.
template <int D>
__global__ void __launch_bounds__(kThreads)
ggr_partials_kernel(Terms<D> in, const double* __restrict__ E, int W, double* __restrict__ partials) {
  __shared__ TileShared<D> sh;
  // box mode: a round's values, pair by pair, and their terms
  extern __shared__ __align__(16) double pair_val[];
  unsigned char* pair_q = reinterpret_cast<unsigned char*>(pair_val + kPairs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int J0 = blockIdx.y * kChunkE;
  const int nE = W - J0 < kChunkE ? W - J0 : kChunkE;
  for (int j = tid; j < nE; j += kThreads) {
    sh.sE[j] = E[J0 + j];
    sh.acc[j] = 0.0;
  }
  if (tid < 32) sh.tab[tid] = kExp2Table[tid];
  const int64_t tpb = (in.K + kThreads - 1) / kThreads;  // tiles a band
  const int64_t ntiles = tpb * in.m;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int band = static_cast<int>(t / tpb);
    const int64_t k0 = (t - band * tpb) * kThreads, k = k0 + tid;
    __syncthreads();  // the energies are staged; the previous tile is consumed
    double* f = sh.sf + tid;
    int lo = 0, hi = 0;
    if (k < in.K) {
      in.stage(f, kThreads, k, band);
      if (!in.empty(f, kThreads)) {
        lo = first_true(nE, [&](int j) { return !in.beyond(f, kThreads, sh.sE[j], false); });
        hi = first_true(nE, [&](int j) { return in.beyond(f, kThreads, sh.sE[j], true); });
      }
    }
    sh.sup[tid] = make_int2(lo, hi);
    const int cnt = hi - lo;
    int tlo = cnt > 0 ? lo : kChunkE, thi = cnt > 0 ? hi : 0;
    tlo = __reduce_min_sync(kFull, tlo);
    thi = __reduce_max_sync(kFull, thi);
    // box mode: the pairs numbered in term order, by a block scan of the counts
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 0) {
      sh.wlo[warp] = tlo;
      sh.whi[warp] = thi;
    }
    if (lane == 31) sh.wsum[warp] = incl;
    __syncthreads();
    int rlo = sh.wlo[0], rhi = sh.whi[0], base = 0, npairs = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      rlo = min(rlo, sh.wlo[w]);
      rhi = max(rhi, sh.whi[w]);
      if (w < warp) base += sh.wsum[w];
      npairs += sh.wsum[w];
    }
    const int nt = in.K - k0 < kThreads ? static_cast<int>(in.K - k0) : kThreads;
    if constexpr (D == 0) {
      // Gaussian mode: supports are wide, so the owner of an energy
      // evaluates its pairs in place, two terms a step (two independent
      // chains), adding them in term order
      for (int j = rlo + tid; j < rhi; j += kThreads) {
        const double En = sh.sE[j];
        double a = sh.acc[j];
        int q = 0;
        for (; q + 1 < nt; q += 2) {
          const int2 s0 = sh.sup[q], s1 = sh.sup[q + 1];
          const bool t0 = j >= s0.x && j < s0.y, t1 = j >= s1.x && j < s1.y;
          if (t0 || t1) {
            double x0, x1;
            const bool i0 = in.value(sh.sf + q, kThreads, En, x0, sh.tab) && t0;
            const bool i1 = in.value(sh.sf + q + 1, kThreads, En, x1, sh.tab) && t1;
            if (i0) a = add(a, x0);
            if (i1) a = add(a, x1);
          }
        }
        if (q < nt) {
          const int2 s0 = sh.sup[q];
          double x0;
          if (j >= s0.x && j < s0.y && in.value(sh.sf + q, kThreads, En, x0, sh.tab)) a = add(a, x0);
        }
        sh.acc[j] = a;
      }
    } else {
      // box mode: supports are narrow, so the pairs are evaluated a pair a
      // thread in rounds of kPairs (all lanes busy), then the owner of an
      // energy adds its pairs in term order; a warp walks only the terms
      // whose supports meet its 32 energies (a ballot over the tile's terms)
      const int first = base + incl - cnt;
      sh.off[tid] = first;
      for (int r0 = 0; r0 < npairs; r0 += kPairs) {
        const int np = npairs - r0 < kPairs ? npairs - r0 : kPairs;
        // each term marks its own pairs of the round
        const int p0 = max(first, r0), p1 = min(first + cnt, r0 + np);
        for (int p = p0; p < p1; ++p) pair_q[p - r0] = static_cast<unsigned char>(tid);
        __syncthreads();
        for (int i = tid; i < np; i += kThreads) {
          const int q = pair_q[i];
          const int j = sh.sup[q].x + (r0 + i - sh.off[q]);
          double x = 0.0;
          pair_val[i] = in.value(sh.sf + q, kThreads, sh.sE[j], x, nullptr) ? x : 0.0;
        }
        __syncthreads();
        for (int j0 = rlo + warp * 32; j0 < rhi; j0 += kThreads) {
          const int j = j0 + lane;
          unsigned hit[kThreads / 32];
#pragma unroll
          for (int c = 0; c < kThreads / 32; ++c) {
            const int q = c * 32 + lane;
            const int2 sp = sh.sup[q];
            const int pa = sh.off[q] - r0, pb = pa + (sp.y - sp.x);
            hit[c] = __ballot_sync(kFull, q < nt && sp.x < j0 + 32 && sp.y > j0 && pb > 0 && pa < np);
          }
          double a = j < rhi ? sh.acc[j] : 0.0;
#pragma unroll
          for (int c = 0; c < kThreads / 32; ++c) {
            for (unsigned m = hit[c]; m != 0; m &= m - 1) {
              const int q = c * 32 + __ffs(m) - 1;
              const int2 sp = sh.sup[q];
              const int p = sh.off[q] + (j - sp.x) - r0;
              if (j >= sp.x && j < sp.y && p >= 0 && p < np) a = add(a, pair_val[p]);
            }
          }
          if (j < rhi) sh.acc[j] = a;
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < nE; j += kThreads) {
    partials[static_cast<int64_t>(J0 + j) * gridDim.x + blockIdx.x] = sh.acc[j];
  }
}

// At most kFewE energies, in any order: a thread per (k, band) term,
// grid-stride, its constants and the energies in registers; a block's sums
// are a fixed tree over its threads.
template <int D>
__global__ void __launch_bounds__(kThreads)
ggr_few_kernel(Terms<D> in, const double* __restrict__ E, int W, double* __restrict__ partials) {
  __shared__ double red[kFewE][kThreads];
  __shared__ double tab[32];
  const int tid = threadIdx.x;
  if (tid < 32) tab[tid] = kExp2Table[tid];
  __syncthreads();
  double en[kFewE], sum[kFewE];
#pragma unroll
  for (int w = 0; w < kFewE; ++w) {
    en[w] = w < W ? E[w] : 0.0;
    sum[w] = 0.0;
  }
  const int64_t nterms = in.K * in.m;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + tid; p < nterms;
       p += static_cast<int64_t>(gridDim.x) * kThreads) {
    double f[kFields];
    in.stage(f, 1, p / in.m, static_cast<int>(p % in.m));
    if (in.empty(f, 1)) continue;
#pragma unroll
    for (int w = 0; w < kFewE; ++w) {
      double x;
      if (w < W && in.value(f, 1, en[w], x, tab)) sum[w] = add(sum[w], x);
    }
  }
#pragma unroll
  for (int w = 0; w < kFewE; ++w) red[w][tid] = sum[w];
  for (int st = kThreads / 2; st > 0; st >>= 1) {
    __syncthreads();
    if (tid < st) {
#pragma unroll
      for (int w = 0; w < kFewE; ++w) red[w][tid] += red[w][tid + st];
    }
  }
  __syncthreads();
  if (tid < W) partials[static_cast<int64_t>(tid) * gridDim.x + blockIdx.x] = red[tid][0];
}

// Blocks along x for K k-points of m bands and W energies, one partial row
// each: at most kMaxBlocks over the terms for W <= kFewE, else at most
// kMaxBlocks over the energy chunks and one a tile.
int64_t num_blocks(int64_t K, int m, int W) {
  int64_t g;
  if (W <= kFewE) {
    g = (K * m + kThreads - 1) / kThreads;
    if (g > kMaxBlocks) g = kMaxBlocks;
  } else {
    g = kMaxBlocks / ((static_cast<int64_t>(W) + kChunkE - 1) / kChunkE);
    const int64_t tiles = (K + kThreads - 1) / kThreads * m;
    if (g > tiles) g = tiles;
  }
  return g > 0 ? g : 1;
}

template <int D>
int launch(const Terms<D>& in, const double* E, int W, double scale, double* partials, double* out,
           cudaStream_t st) {
  const int64_t g = num_blocks(in.K, in.m, W);
  const bool any = in.K > 0;
  if (any && W <= kFewE) {
    ggr_few_kernel<D><<<static_cast<unsigned>(g), kThreads, 0, st>>>(in, E, W, partials);
  } else if (any) {
    const int64_t chunks = (static_cast<int64_t>(W) + kChunkE - 1) / kChunkE;
    if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = D == 0 ? 0 : kPairs * static_cast<int>(sizeof(double) + 1);
    if (smem + static_cast<int>(sizeof(TileShared<D>)) > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(ggr_partials_kernel<D>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    ggr_partials_kernel<D><<<dim3(static_cast<unsigned>(g), static_cast<unsigned>(chunks)), kThreads, smem, st>>>(
        in, E, W, partials);
  }
  if (any) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return autobz::lane_sum_launch(partials, out, any ? g : 0, W, scale, st);
}

}  // namespace

// Rows of the partials scratch of K13 for K k-points of m bands and W
// energies: one per block.
extern "C" long long ggr_dos_num_blocks(long long K, int m, int W) { return num_blocks(K, m, W); }

// e: (K, m) float64; w: (K,); E: (W,), sorted ascending above kFewE
// energies; partials: W x ggr_dos_num_blocks(K, m, W) scratch; out: (W,),
// written. d = 1..3 is box mode, with a the velocities (K, d, m), b the
// half box width and vtol the gate, nrm unused; d = 0 is Gaussian mode,
// with a the widths sigma (K, m) and nrm the norms (K, m). Every output is
// multiplied by scale. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for d outside 0..3 or m < 1.
extern "C" int ggr_dos_launch(int d, const void* e, const void* a, const void* nrm, const void* w,
                              long long K, int m, const void* E, int W, double b, double vtol,
                              double scale, void* partials, void* out, void* stream) {
  if (d < 0 || d > 3 || m < 1 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ep = static_cast<const double*>(e);
  const auto* ap = static_cast<const double*>(a);
  const auto* np = static_cast<const double*>(nrm);
  const auto* wp = static_cast<const double*>(w);
  const auto* Ep = static_cast<const double*>(E);
  auto* pp = static_cast<double*>(partials);
  auto* op = static_cast<double*>(out);
  switch (d) {
    case 0: return launch(Terms<0>{ep, ap, np, wp, K, m, b, vtol}, Ep, W, scale, pp, op, st);
    case 1: return launch(Terms<1>{ep, ap, np, wp, K, m, b, vtol}, Ep, W, scale, pp, op, st);
    case 2: return launch(Terms<2>{ep, ap, np, wp, K, m, b, vtol}, Ep, W, scale, pp, op, st);
    default: return launch(Terms<3>{ep, ap, np, wp, K, m, b, vtol}, Ep, W, scale, pp, op, st);
  }
}
