// K2: weighted k-sum of the Lorentzian-broadened DOS trace, in FP64.
//
// Replaces autobzcore_tpu/models/observables.py:149 dos_trace (through
// :108 greens_function_trace and :73 _trace_inv_small) as summed by the PTR
// rule, autobzcore_tpu/algorithms/ptr.py:77-83 (utils/tree.py:39
// tree_weighted_sum). For every frequency lane w it computes
//
//   D(w) = scale * sum_k w_k * (-Im Tr (z_w I - H_k)^{-1}) / pi,
//   z_w = omega_w + i eta_w,
//
// for any complex H (K, m, m), m <= 3: Tr M^{-1} = S / det M with M = z I -
// H, S the sum of M's principal (m-1)-minors (1 at m = 1, the trace at m =
// 2), the reference's closed forms (1/M, tr/det, and (tr^2 - tr M^2) / (2
// det) = S / det at m = 3) regrouped.
//
// What bounds it on an H100: FP64 arithmetic. At the PTR leg's shape (W =
// 264, K = 1e6) there are 2.64e8 (lane, k) pairs against a 152 MB read of H
// and w; below about 18 lanes the read of H is the limit (an AutoPTR
// ladder's late rungs: 1.25e8 k-points, a few lanes).
//
// What the design does about it:
//  * only M's diagonal depends on z. Each k's invariants are formed once, in
//    registers, from the diagonal h_ii, the products p_ij = h_ij h_ji and
//    the cyclic term c = h01 h12 h20 + h02 h21 h10 (complex; H need not be
//    Hermitian), and each pair forms only the z-dependent part from the
//    shifts d_i = z - h_ii:
//      A = d0 d1 - p01,  S = A + d2 (d0 + d1) - (p02 + p12),
//      det = d2 A - d0 p12 - d1 p02 - c,
//    about 42 FP64 instructions a pair where the whole-matrix form took
//    ~100. The products stay in diagonal shifts as the reference's form
//    does (no expansion into polynomial coefficients in z, which loses the
//    digits near a degenerate pole at small eta);
//  * Im(S / det) = Im(S conj det) / |det|^2 takes one reciprocal, by
//    rcp.approx and two Newton steps (within an ulp or two). Where |det|^2
//    lies outside [2^-1021, 2^1022) (|det| outside about (1.5e-154,
//    6.7e153): a tiny eta on a pole) the thread redoes its chunk, and those
//    pairs divide by det scaled by a power of two to about 1 (exact), so the
//    quotient keeps its digits wherever it is itself a normal number; every
//    other pair gives the same bits again;
//  * a warp takes a chunk of kChunkK k-points, its thread s every k = s mod
//    32 in k order (a warp reads 32 consecutive H_k, 4,608 contiguous
//    bytes, a step), and R lanes (R = 1, 2, 4, 8 or 16, chosen by the
//    launch to fit W: a rung of 8 lanes is not padded to 32). The lanes'
//    (omega, eta) sit in shared memory, read by all the warp's threads at
//    once. Lane groups of one chunk are adjacent in launch order, so H comes
//    from device memory about once and from L2 for the other groups;
//  * a lane's partial for a chunk is the 32 substreams' sequential sums
//    met in a fixed butterfly; every operation rounds explicitly (no
//    contraction is left to the compiler, whose choices may differ between
//    the R instances), so a lane's partial is the same bits whatever W, R or
//    its place among the lanes;
//  * the grid's y extent is capped (at 65535, the hardware's limit, unless
//    the caller lowers it), and a warp loops over the chunks blockIdx.y *
//    kWarps + warp, + gridDim.y * kWarps, ..., so any number of k-points
//    takes one launch and the cap does not change a chunk's partial;
//  * blocks run in no order, so the cross-chunk sum is a second pass: each
//    chunk writes one partial per lane, laid out lane by lane, and
//    column_sum.cuh's lane_sum adds a lane's partials in a fixed order with
//    256 threads (a ladder rung of 1.25e8 k-points has 30,518 of them). No
//    atomics: repeated runs are bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"

namespace {

constexpr int kSub = 32;       // k substreams of a chunk: a warp's threads
constexpr int kChunkK = 4096;  // k-points per chunk (one partial per lane)
constexpr int kWarps = 4;      // warps per block, each on chunks of its own
constexpr int kThreads = kSub * kWarps;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(__fma_rn(a.x, b.x, -__dmul_rn(a.y, b.y)), __fma_rn(a.x, b.y, __dmul_rn(a.y, b.x)));
}

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
}

// z - a for z = (x, y)
__device__ __forceinline__ double2 shift(double x, double y, double2 a) {
  return make_double2(__dsub_rn(x, a.x), __dsub_rn(y, a.y));
}

// |den| of a pair outside [2^-1021, 2^1022): the reciprocal's fast form
// does not hold there (den >= 0 or NaN, so the high word's exponent bits
// decide)
__device__ __forceinline__ bool out_of_range(double den) {
  return static_cast<unsigned>(__double2hiint(den)) - 0x00200000u >= 0x7fb00000u;
}

// num / den by rcp.approx and two Newton steps, for den in range
__device__ __forceinline__ double quotient(double num, double den) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(den));
  r = __fma_rn(r, __fma_rn(-den, r, 1.0), r);
  r = __fma_rn(r, __fma_rn(-den, r, 1.0), r);
  return __dmul_rn(num, r);
}

// Im(S / det) for any det: det scaled by 2^-e to about 1 (exact), a
// correctly rounded division, then 2^-e
__device__ __forceinline__ double scaled_im_quotient(double2 S, double2 det) {
  int e;
  frexp(fmax(fabs(det.x), fabs(det.y)), &e);
  const double dx = ldexp(det.x, -e), dy = ldexp(det.y, -e);
  return ldexp(__ddiv_rn(__fma_rn(S.y, dx, -__dmul_rn(S.x, dy)), __fma_rn(dx, dx, __dmul_rn(dy, dy))), -e);
}

// num / den = Im(S / det) = Im Tr (z I - H_k)^{-1}, from H_k's invariants:
// frac gives S and det, pair num = Im(S conj det) and den = |det|^2.
template <int M>
struct Invariants;

template <class F>
__device__ __forceinline__ void num_den(const F& v, double x, double y, double& num, double& den) {
  double2 S, det;
  v.frac(x, y, S, det);
  num = __fma_rn(S.y, det.x, -__dmul_rn(S.x, det.y));
  den = __fma_rn(det.x, det.x, __dmul_rn(det.y, det.y));
}

template <>
struct Invariants<1> {
  double2 a;
  __device__ __forceinline__ void load(const double2* __restrict__ h) { a = __ldg(h); }
  __device__ __forceinline__ void frac(double x, double y, double2& S, double2& det) const {
    S = make_double2(1.0, 0.0);
    det = shift(x, y, a);
  }
  // Im 1/d = -d.y / |d|^2
  __device__ __forceinline__ void pair(double x, double y, double& num, double& den) const {
    const double2 d = shift(x, y, a);
    num = -d.y;
    den = __fma_rn(d.x, d.x, __dmul_rn(d.y, d.y));
  }
};

template <>
struct Invariants<2> {
  double2 a0, a1, p;  // h00, h11, h01 h10
  __device__ __forceinline__ void load(const double2* __restrict__ h) {
    a0 = __ldg(h);
    a1 = __ldg(h + 3);
    p = cmul(__ldg(h + 1), __ldg(h + 2));
  }
  // Tr M^-1 = (d0 + d1) / (d0 d1 - p)
  __device__ __forceinline__ void frac(double x, double y, double2& S, double2& det) const {
    const double2 d0 = shift(x, y, a0), d1 = shift(x, y, a1);
    det = make_double2(__fma_rn(d0.x, d1.x, __fma_rn(-d0.y, d1.y, -p.x)),
                       __fma_rn(d0.x, d1.y, __fma_rn(d0.y, d1.x, -p.y)));
    S = cadd(d0, d1);
  }
  __device__ __forceinline__ void pair(double x, double y, double& num, double& den) const {
    num_den(*this, x, y, num, den);
  }
};

template <>
struct Invariants<3> {
  double2 a0, a1, a2, p01, p02, p12, q, c;  // q = p02 + p12
  __device__ __forceinline__ void load(const double2* __restrict__ h) {
    const double2 h01 = __ldg(h + 1), h02 = __ldg(h + 2), h10 = __ldg(h + 3), h12 = __ldg(h + 5);
    const double2 h20 = __ldg(h + 6), h21 = __ldg(h + 7);
    a0 = __ldg(h);
    a1 = __ldg(h + 4);
    a2 = __ldg(h + 8);
    p01 = cmul(h01, h10);
    p02 = cmul(h02, h20);
    p12 = cmul(h12, h21);
    q = cadd(p02, p12);
    c = cadd(cmul(cmul(h01, h12), h20), cmul(cmul(h02, h21), h10));
  }
  // Tr M^-1 = S / det: A = d0 d1 - p01, S = A - q + d2 (d0 + d1),
  // det = d2 A - d0 p12 - d1 p02 - c
  __device__ __forceinline__ void frac(double x, double y, double2& S, double2& det) const {
    const double2 d0 = shift(x, y, a0), d1 = shift(x, y, a1), d2 = shift(x, y, a2);
    const double2 A = make_double2(__fma_rn(d0.x, d1.x, __fma_rn(-d0.y, d1.y, -p01.x)),
                                   __fma_rn(d0.x, d1.y, __fma_rn(d0.y, d1.x, -p01.y)));
    const double2 s = cadd(d0, d1);
    const double Bx = __dsub_rn(A.x, q.x), By = __dsub_rn(A.y, q.y);
    S = make_double2(__fma_rn(d2.x, s.x, __fma_rn(-d2.y, s.y, Bx)), __fma_rn(d2.x, s.y, __fma_rn(d2.y, s.x, By)));
    det = make_double2(__fma_rn(d2.x, A.x, __fma_rn(-d2.y, A.y, __fma_rn(-d0.x, p12.x, __fma_rn(d0.y, p12.y,
                       __fma_rn(-d1.x, p02.x, __fma_rn(d1.y, p02.y, -c.x)))))),
                       __fma_rn(d2.x, A.y, __fma_rn(d2.y, A.x, __fma_rn(-d0.x, p12.y, __fma_rn(-d0.y, p12.x,
                       __fma_rn(-d1.x, p02.y, __fma_rn(-d1.y, p02.x, -c.y)))))));
  }
  __device__ __forceinline__ void pair(double x, double y, double& num, double& den) const {
    num_den(*this, x, y, num, den);
  }
};

// acc[r] += sum over the thread's k of the chunk [kbeg, kend) of w_k Im Tr
// (z_r - H_k)^{-1}; returns whether a pair's den was out of the
// reciprocal's range (only the fast pass counts them; the exact pass takes
// scaled_im_quotient there).
template <int M, int R, bool kExact>
__device__ __forceinline__ bool chunk_sums(const double2* __restrict__ H, const double* __restrict__ w,
                                           const double2* zs, int64_t kbeg, int64_t kend, double* acc) {
  unsigned bad = 0;
  for (int64_t k = kbeg + threadIdx.x % kSub; k < kend; k += kSub) {
    Invariants<M> v;
    v.load(H + k * (M * M));
    const double wk = __ldg(w + k);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const double2 z = zs[r];
      double num, den;
      v.pair(z.x, z.y, num, den);
      double val;
      if (kExact && out_of_range(den)) {
        double2 S, det;
        v.frac(z.x, z.y, S, det);
        val = scaled_im_quotient(S, det);
      } else {
        if (!kExact) bad |= out_of_range(den);
        val = quotient(num, den);
      }
      acc[r] = __fma_rn(wk, val, acc[r]);
    }
  }
  return bad != 0;
}

// partials[lane, c] = sum_{k in chunk c} w_k Im Tr (z_lane - H_k)^{-1} for
// the R lanes of lane group blockIdx.x
template <int M, int R>
__global__ void __launch_bounds__(kThreads)
dos_pairs_kernel(const double2* __restrict__ H, const double* __restrict__ w, const double* __restrict__ omega,
                 const double* __restrict__ eta, double* __restrict__ partials, int64_t K, int W,
                 int64_t nchunks) {
  __shared__ double2 zs[R];
  const int lane0 = blockIdx.x * R;
  if (threadIdx.x < R) {
    const int l = lane0 + threadIdx.x;
    zs[threadIdx.x] = l < W ? make_double2(omega[l], eta[l]) : make_double2(0.0, 1.0);  // a dead lane's z
  }
  __syncthreads();
  const int s = threadIdx.x % kSub;
  for (int64_t c = static_cast<int64_t>(blockIdx.y) * kWarps + threadIdx.x / kSub; c < nchunks;
       c += static_cast<int64_t>(gridDim.y) * kWarps) {
    const int64_t kbeg = c * kChunkK;
    const int64_t kend = K < kbeg + kChunkK ? K : kbeg + kChunkK;
    double acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0;
    if (chunk_sums<M, R, false>(H, w, zs, kbeg, kend, acc)) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0;
      chunk_sums<M, R, true>(H, w, zs, kbeg, kend, acc);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = kSub / 2; off > 0; off >>= 1) acc[r] = __dadd_rn(acc[r], __shfl_xor_sync(0xffffffffu, acc[r], off));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (s == r && lane0 + r < W) partials[static_cast<int64_t>(lane0 + r) * nchunks + c] = acc[r];
    }
  }
}

// Lanes a thread for W lanes: the R of 1, 2, 4, 8, 16 with the least
// estimated work, ceil(W / R) groups of R pairs (~42 instructions each) and
// a k's load and invariants (~60) a group.
int lanes_per_thread(int W) {
  int best = 1;
  long long best_cost = -1;
  for (int R = 1; R <= 16; R *= 2) {
    const long long cost = (W + R - 1) / R * (42LL * R + 60);
    if (best_cost < 0 || cost < best_cost) best = R, best_cost = cost;
  }
  return best;
}

template <int M, int R>
void launch_pairs(const double2* H, const double* w, const double* omega, const double* eta, double* partials,
                  int64_t K, int W, int64_t nchunks, int cap, cudaStream_t st) {
  const int64_t rows = (nchunks + kWarps - 1) / kWarps;
  const dim3 grid(static_cast<unsigned>((W + R - 1) / R), static_cast<unsigned>(rows < cap ? rows : cap));
  dos_pairs_kernel<M, R><<<grid, kThreads, 0, st>>>(H, w, omega, eta, partials, K, W, nchunks);
}

template <int M>
void launch_m(const double2* H, const double* w, const double* omega, const double* eta, double* partials,
              int64_t K, int W, int64_t nchunks, int cap, cudaStream_t st) {
  switch (lanes_per_thread(W)) {
    case 1: launch_pairs<M, 1>(H, w, omega, eta, partials, K, W, nchunks, cap, st); break;
    case 2: launch_pairs<M, 2>(H, w, omega, eta, partials, K, W, nchunks, cap, st); break;
    case 4: launch_pairs<M, 4>(H, w, omega, eta, partials, K, W, nchunks, cap, st); break;
    case 8: launch_pairs<M, 8>(H, w, omega, eta, partials, K, W, nchunks, cap, st); break;
    default: launch_pairs<M, 16>(H, w, omega, eta, partials, K, W, nchunks, cap, st); break;
  }
}

}  // namespace

// Number of k-chunks: the partials scratch the caller allocates holds this
// many entries per lane.
extern "C" long long dos_trace_num_chunks(long long K) { return (K + kChunkK - 1) / kChunkK; }

// H: (K, m, m) complex128 as double2; w: (K,); omega, eta: (W,); partials:
// (W, num_chunks(K)) scratch; out: (W,), all float64. out = -scale/pi * sum_k w_k Im Tr(...).
// max_grid_y caps the grid's y extent (<= 0 or above 65535: 65535); a lower
// cap makes every warp loop over more k-chunks and gives the same bits.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for m outside 1..3.
extern "C" int dos_trace_weighted_sum_launch(const void* H, const void* w, const void* omega,
                                             const void* eta, void* partials, void* out,
                                             long long K, int W, int m, double factor,
                                             int max_grid_y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nchunks = dos_trace_num_chunks(K);
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  if (m < 1 || m > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = max_grid_y <= 0 || max_grid_y > kMaxGridY ? kMaxGridY : max_grid_y;
  if (nchunks > 0) {
    const auto* Hp = static_cast<const double2*>(H);
    const auto* wp = static_cast<const double*>(w);
    const auto* op = static_cast<const double*>(omega);
    const auto* ep = static_cast<const double*>(eta);
    auto* pp = static_cast<double*>(partials);
    if (m == 1) {
      launch_m<1>(Hp, wp, op, ep, pp, K, W, nchunks, cap, st);
    } else if (m == 2) {
      launch_m<2>(Hp, wp, op, ep, pp, K, W, nchunks, cap, st);
    } else {
      launch_m<3>(Hp, wp, op, ep, pp, K, W, nchunks, cap, st);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return autobz::lane_sum_launch(static_cast<const double*>(partials), static_cast<double*>(out), nchunks, W,
                                 factor, st);
}
