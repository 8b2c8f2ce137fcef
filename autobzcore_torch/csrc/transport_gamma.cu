// K19: the Lorentzian-pair transport contraction, in FP64, on the tensor cores.
//
// Replaces autobzcore_tpu/models/observables.py:379-383 (TransportSolver's
// chunk: the spectral functions at each frequency, their pair products and
// the (C, K m^2) x (K m^2, d^2) product by Wmat) and
// autobzcore_tpu/models/transport.py:160-181 (KineticCoefficientSolver's
// integrand, the same at the node pair (w, w + Omega)). For B node pairs b
// it computes
//
//   G[b, c] = scale * sum_k sum_{n, q} A(y1_b - e[k, n]; g1_b)
//                                      A(y2_b - e[k, q]; g2_b) Wmat[(k, n, q), c],
//   A(x; g) = g / (x * x + g * g) / pi,
//
// with y = w - Re Sigma(w) and g = -Im Sigma(w) at each node (0 and eta
// without a self-energy), the reference's expression in both cases.
//
// What bounds it on an H100: FP64 arithmetic of two kinds. The contraction
// is a (B, K m^2) x (K m^2, d^2) real matrix product, 2 m^2 d^2 operations
// per (pair, point), which the FP64 tensor cores (DMMA) run at 67 TFLOP/s;
// the left operand, the pair products (15.5 MB a pair at the flagship's
// 216,000 points), must never exist in device memory. Making it takes the
// CUDA cores (34 TFLOP/s): 2m Lorentzians per (pair, point) (m at equal
// frequencies), each a subtraction, a square, a sum and a reciprocal, and
// the m^2 products. At m = d = 3 the two kinds of work are of one size, so
// the design keeps both units busy and wastes little of either.
//
// The design:
//  * the product runs on the FP64 tensor cores (mma.sync m16n8k8 f64,
//    dmma.cuh): the A operand is the pair products, a warp's 16 pairs by 8
//    terms of the depth (k, n, q), the B operand Wmat's 8 terms by its
//    first 8 columns; at d = 3 the ninth column is one FMA per (pair, term)
//    on the CUDA cores, summed over the quad at the end of a chunk in a
//    fixed order. (With Wmat^T as the A operand the 9 columns would pad to
//    16 rows and double the DMMA work, and the DMMA share of the function
//    is as large as the CUDA cores'.) A block of up to 8 warps owns up to
//    128 pairs, so B = 64 runs as 4 full warps and B = 960 as 8 blocks of
//    128 pairs;
//  * the pair products are made in registers, each by the one thread whose
//    A fragment holds it: the four threads of a quad (threadID_in_group t)
//    hold the depth columns t and t + 4 of each k-step for the quad's two
//    pairs (rows g and g + 8), and the depth is laid out so that thread t's
//    columns are all the terms of its own points (t, t + 4, ... of each run
//    of 4 R points). So each thread computes the Lorentzians of its points
//    for its two pairs, once per (pair, point, band), and no table of them
//    is staged or read. The term axis is walked across point boundaries
//    (for odd m, two points a thread per run: R m^2 terms, an even count),
//    not padded per point: padding 9 terms to 16 at m = 3 would double the
//    tensor-core work;
//  * Wmat and the points' energies are staged in shared memory, 16 points
//    a stage, double-buffered by cp.async, Wmat permuted on its way in to
//    the fragment order [k-step][column t or t + 4 of the depth][Wmat
//    column][t] (each element's place read from a table the block fills
//    once), so that a warp's B fragment loads read 256 contiguous bytes;
//    columns past d^2 are zeros in registers, not in shared memory.
//    Every warp of the block reads the same stage, so a point's Wmat comes
//    from L2 once per 128 pairs; the pair tile is the fastest grid index,
//    so it comes from device memory about once;
//  * the Lorentzian's factor g / pi does not depend on the point: the
//    product (g1 / pi)(g2 / pi) multiplies a pair's partial row once per
//    chunk, and per (pair, point, band) the kernel forms only 1 / (x^2 +
//    g^2), by rcp.approx and two Newton steps (within an ulp or two, with
//    no slow path to branch to; x^2 + g^2 is positive and normal for any
//    width g > 1e-154 and |x| < 1e154). A correctly rounded division
//    there costs a quarter more time at the trip of 960 pairs
//    (tools/transport_variants.py, PERF.md). The plain
//    version keeps the reference's two divisions; the two agree far inside
//    1e-12. Every CUDA-core step that builds a fragment rounds explicitly
//    (no contraction into FMAs is left to the compiler), so the pairs'
//    unrolled copies round alike and a pair's value does not depend on its
//    row;
//  * a chunk of kChunk points gives one partial row per pair; blockIdx.y
//    walks the chunks (grid-stride past the grid's limit), and
//    column_sum.cuh's second pass adds each pair's partials in chunk order
//    and multiplies by scale. The chunks and the k-step order do not depend
//    on B or on the block's size, so a pair's value does not depend on the
//    other pairs of its launch, and with no atomics repeated runs are
//    bit-identical;
//  * at equal frequencies (the caller's `same`: the wrapper passes it when
//    the two node vectors are the same tensors) each Lorentzian is computed
//    once and serves both factors, with the bits of two equal computations;
//  * above three bands (runtime m <= 64) the depth is padded per point to
//    an even count, the Lorentzians of a point are kept in local memory,
//    and the B fragments are read straight from L1/L2: a path off the main
//    one, kept simple.

#include <cuda_runtime.h>

#include <cstdint>

#include "column_sum.cuh"
#include "dmma.cuh"

namespace {

using autobz::dmma;

constexpr int kWarpPairs = 16;     // pairs a warp: the m16 rows of its tile
constexpr int kMaxWarps = 8;       // warps a block: 128 pairs
constexpr int kChunk = 512;        // points per partial row
constexpr int kStage = 16;         // points of Wmat staged at once
constexpr int kMaxBands = 64;      // the runtime-m path's local arrays
constexpr int kMaxGridY = 65535;
constexpr double kPi = 3.141592653589793;

// 1 / (x^2 + gg) with x = y - e: rcp.approx and two Newton steps.
__device__ __forceinline__ double lorentz_inv(double y, double e, double gg) {
  const double x = __dsub_rn(y, e);
  const double den = __dadd_rn(__dmul_rn(x, x), gg);
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(den));
  r = __fma_rn(r, __fma_rn(-den, r, 1.0), r);
  return __fma_rn(r, __fma_rn(-den, r, 1.0), r);
}

// A lane's two pairs p0 + g + 8 h (h = 0, 1): y, g^2 at both nodes and the
// pair's factor (g1 / pi)(g2 / pi).
struct Nodes {
  double y1[2], gg1[2], y2[2], gg2[2], f[2];
};

__device__ __forceinline__ void load_nodes(Nodes& nd, const double* __restrict__ y1,
                                           const double* __restrict__ g1, const double* __restrict__ y2,
                                           const double* __restrict__ g2, int p0, int g, int B) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = p0 + g + 8 * h;
    const bool live = b < B;
    const double a1 = live ? g1[b] : 1.0, a2 = live ? g2[b] : 1.0;
    nd.y1[h] = live ? y1[b] : 0.0;
    nd.y2[h] = live ? y2[b] : 0.0;
    nd.gg1[h] = __dmul_rn(a1, a1);
    nd.gg2[h] = __dmul_rn(a2, a2);
    nd.f[h] = __dmul_rn(__ddiv_rn(a1, kPi), __ddiv_rn(a2, kPi));
  }
}

// The live halves (rows g, then g + 8) of a warp's tile whose first pair is p0.
__device__ __forceinline__ int live_halves(int p0, int B) {
  const int left = B - p0;
  return left <= 0 ? 0 : (left > 8 ? 2 : 1);
}

// The warp's sums of chunk ch into partials[(ch, b, c)], each times its
// pair's factor: d_i is (pair p0 + g + 8 (i / 2), column 2 t + i % 2); at
// d = 3 the ninth column's per-thread sums s8 are added over the quad
// (xor 1, then xor 2: the same bits in every lane).
template <int DD>
__device__ __forceinline__ void store_partials(double* __restrict__ partials, int64_t ch, int B, int p0,
                                               int g, int t, const Nodes& nd, const double (&d)[4],
                                               const double (&s8)[2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = p0 + g + 8 * (i >> 1);
    const int c = 2 * t + (i & 1);
    if (b < B && c < DD && c < 8) partials[(ch * B + b) * DD + c] = __dmul_rn(d[i], nd.f[i >> 1]);
  }
  if (DD == 9) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double v = __dadd_rn(s8[h], __shfl_xor_sync(0xffffffffu, s8[h], 1));
      v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const int b = p0 + g + 8 * h;
      if (t == 0 && b < B) partials[(ch * B + b) * DD + 8] = __dmul_rn(v, nd.f[h]);
    }
  }
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The depth's layout at compile-time m = MB: thread t's columns of a k-step
// run are the MB^2 terms of each of its R points t + 4 r (r < R), in (r, n,
// q) order, two a k-step; R = 2 for odd MB, so that R MB^2 is even.
template <int MB>
struct Run {
  static constexpr int R = (MB & 1) ? 2 : 1;
  static constexpr int S = R * MB * MB / 2;  // k-steps a run
  static constexpr int PTS = 4 * R;          // points a run
};

// Where element f of a stage's Wmat rows goes in the staged buffer, the
// fragment order: k-step s of run M is a record of 8 DD doubles, [j][c <
// CW][t] (depth column t + 4 j, Wmat column c; CW = min(DD, 8)) then, for
// DD = 9, [j][t] (Wmat column 8). The same for every stage: a block fills
// the table once.
template <int MB, int DD>
__device__ __forceinline__ int stage_slot(int f) {
  using Rn = Run<MB>;
  constexpr int CW = DD < 8 ? DD : 8;
  constexpr int MM = MB * MB;
  const int c = f % DD;
  int w = f / DD;
  const int q = w % MB;
  w /= MB;
  const int n = w % MB;
  const int kk = w / MB;
  const int run = kk / Rn::PTS, rem = kk % Rn::PTS;
  const int t = rem & 3, r = rem >> 2;
  const int u = r * MM + n * MB + q;
  const int rec = (run * Rn::S + (u >> 1)) * 8 * DD;
  const int j = u & 1;
  return rec + (c < 8 ? (j * CW + c) * 4 + t : 8 * CW + j * 4 + t);
}

// Stage kStage points from point k0: their Wmat rows into buf by the table
// slot, their energies (kStage MB doubles) into es. Points past K stage
// zeros.
template <int MB, int DD>
__device__ __forceinline__ void stage_points(double* buf, double* es, const int* slot, const double* __restrict__ W,
                                             const double* __restrict__ e, int64_t k0, int64_t K) {
  constexpr int ROW = MB * MB * DD;  // a point's Wmat
  constexpr int N = kStage * ROW;
  const double* src = W + k0 * ROW;
  if (k0 + kStage <= K) {
    for (int f = threadIdx.x; f < N; f += blockDim.x) cp_async8(buf + slot[f], src + f);
    for (int f = threadIdx.x; f < kStage * MB; f += blockDim.x) cp_async8(es + f, e + k0 * MB + f);
    return;
  }
  for (int f = threadIdx.x; f < N; f += blockDim.x) {
    if (k0 + f / ROW < K)
      cp_async8(buf + slot[f], src + f);
    else
      buf[slot[f]] = 0.0;
  }
  for (int f = threadIdx.x; f < kStage * MB; f += blockDim.x) {
    if (k0 + f / MB < K)
      cp_async8(es + f, e + k0 * MB + f);
    else
      es[f] = 0.0;
  }
}

// The reciprocal Lorentzians of the thread's points kk0 + t + 4 r of a
// stage (es holds the stage's energies) for its live pairs: l1[r][h][n] =
// 1 / ((y1 - e[k, n])^2 + g1^2) of pair p0 + g + 8 h, 0 for a point past K;
// l2 the same at (y2, g2), or l1 when same.
template <int MB, int R>
__device__ __forceinline__ void run_lorentzians(const double* es, int kk0, int64_t k0, int64_t K, const Nodes& nd,
                                                bool same, int nh, int t, double (&l1)[R][2][MB],
                                                double (&l2)[R][2][MB]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kk = kk0 + t + 4 * r;
    const bool kin = k0 + kk < K;
#pragma unroll
    for (int n = 0; n < MB; ++n) {
      const double en = es[kk * MB + n];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h < nh) {
          const double a = lorentz_inv(nd.y1[h], en, nd.gg1[h]);
          l1[r][h][n] = kin ? a : 0.0;
          if (same) {
            l2[r][h][n] = l1[r][h][n];
          } else {
            const double b = lorentz_inv(nd.y2[h], en, nd.gg2[h]);
            l2[r][h][n] = kin ? b : 0.0;
          }
        }
      }
    }
  }
}

// One k-step: the A fragment (pair rows g, g + 8 by depth columns t, t + 4)
// from the products p[h][j], the B fragment (b0, b1) and, at DD = 9, the
// ninth column's FMAs by w0, w1.
template <int DD>
__device__ __forceinline__ void kstep(double (&acc)[4], double (&s8)[2], const double (&p)[2][2], double b0,
                                      double b1, double w0, double w1) {
  const double a[4] = {p[0][0], p[1][0], p[0][1], p[1][1]};
  dmma(acc, a, b0, b1);
  if (DD == 9) {
#pragma unroll
    for (int h = 0; h < 2; ++h) s8[h] = __fma_rn(p[h][1], w1, __fma_rn(p[h][0], w0, s8[h]));
  }
}

// One stage's terms for a warp's pairs: the Lorentzians of the thread's
// points, the pair products as A fragments and the DMMA by the staged Wmat.
template <int MB, int DD>
__device__ __forceinline__ void stage_terms(const double* buf, const double* es, int64_t k0, int64_t K,
                                            const Nodes& nd, bool same, int nh, int g, int t, double (&acc)[4],
                                            double (&s8)[2]) {
  using Rn = Run<MB>;
  constexpr int CW = DD < 8 ? DD : 8;
  constexpr int MM = MB * MB;
  const bool gin = g < CW;
#pragma unroll 1
  for (int run = 0; run < kStage / Rn::PTS; ++run) {
    double l1[Rn::R][2][MB], l2[Rn::R][2][MB];
    run_lorentzians<MB, Rn::R>(es, run * Rn::PTS, k0, K, nd, same, nh, t, l1, l2);
    const double* recs = buf + run * Rn::S * 8 * DD;
#pragma unroll
    for (int s = 0; s < Rn::S; ++s) {
      const double* rec = recs + s * 8 * DD;
      const double b0 = gin ? rec[g * 4 + t] : 0.0;
      const double b1 = gin ? rec[(CW + g) * 4 + t] : 0.0;
      const double w0 = DD == 9 ? rec[8 * CW + t] : 0.0;
      const double w1 = DD == 9 ? rec[8 * CW + 4 + t] : 0.0;
      const int u0 = 2 * s, u1 = 2 * s + 1;
      const int r0 = u0 / MM, n0 = (u0 % MM) / MB, q0 = u0 % MB;
      const int r1 = u1 / MM, n1 = (u1 % MM) / MB, q1 = u1 % MB;
      double p[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h][0] = h < nh ? __dmul_rn(l1[r0][h][n0], l2[r0][h][q0]) : 0.0;
        p[h][1] = h < nh ? __dmul_rn(l1[r1][h][n1], l2[r1][h][q1]) : 0.0;
      }
      kstep<DD>(acc, s8, p, b0, b1, w0, w1);
    }
  }
}

// partials[(chunk, b, c)] for the chunks blockIdx.y, blockIdx.y + gridDim.y,
// ... at compile-time m = MB <= 3 and DD = d^2; blockDim.x = 32 x warps.
template <int MB, int DD>
__global__ void __launch_bounds__(32 * kMaxWarps)
transport_gamma_partial(const double* __restrict__ e, const double* __restrict__ W, int64_t K,
                        const double* __restrict__ y1, const double* __restrict__ g1,
                        const double* __restrict__ y2, const double* __restrict__ g2, int B,
                        int64_t nchunks, int same, double* __restrict__ partials) {
  // two stages of kStage MB^2 DD doubles of Wmat, then of kStage MB energies, then the slot table
  extern __shared__ double stage[];
  constexpr int SZ = kStage * MB * MB * DD;
  double* es = stage + 2 * SZ;
  int* slot = reinterpret_cast<int*>(es + 2 * kStage * MB);
  for (int f = threadIdx.x; f < SZ; f += blockDim.x) slot[f] = stage_slot<MB, DD>(f);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int p0 = (blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5)) * kWarpPairs;
  const int nh = live_halves(p0, B);
  Nodes nd;
  load_nodes(nd, y1, g1, y2, g2, p0, g, B);
  for (int64_t ch = blockIdx.y; ch < nchunks; ch += gridDim.y) {
    double acc[4] = {0.0, 0.0, 0.0, 0.0}, s8[2] = {0.0, 0.0};
    const int64_t kc = ch * kChunk;
    const int64_t left = K - kc < kChunk ? K - kc : kChunk;
    const int nst = static_cast<int>((left + kStage - 1) / kStage);
    stage_points<MB, DD>(stage, es, slot, W, e, kc, K);
    cp_async_commit();
    for (int i = 0; i < nst; ++i) {
      if (i + 1 < nst) {
        stage_points<MB, DD>(stage + ((i + 1) & 1) * SZ, es + ((i + 1) & 1) * kStage * MB, slot, W, e,
                             kc + (i + 1) * kStage, K);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (nh > 0)
        stage_terms<MB, DD>(stage + (i & 1) * SZ, es + (i & 1) * kStage * MB, kc + i * kStage, K, nd, same != 0,
                            nh, g, t, acc, s8);
      __syncthreads();  // the next stage overwrites this buffer
    }
    if (nh > 0) store_partials<DD>(partials, ch, B, p0, g, t, nd, acc, s8);
  }
}

// The same above three bands, m runtime (<= kMaxBands): per point the m^2
// terms padded to an even count, one point a thread per run of 4; the
// Lorentzians of the point in local memory; B fragments from L1/L2.
template <int DD>
__global__ void __launch_bounds__(32 * kMaxWarps)
transport_gamma_partial_any(const double* __restrict__ e, const double* __restrict__ W, int64_t K, int m,
                            const double* __restrict__ y1, const double* __restrict__ g1,
                            const double* __restrict__ y2, const double* __restrict__ g2, int B,
                            int64_t nchunks, int same, double* __restrict__ partials) {
  constexpr int CW = DD < 8 ? DD : 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int p0 = (blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5)) * kWarpPairs;
  const int nh = live_halves(p0, B);
  if (nh == 0) return;  // no block-wide synchronisation below
  Nodes nd;
  load_nodes(nd, y1, g1, y2, g2, p0, g, B);
  const int mm = m * m;
  const int steps = (mm + 1) / 2;
  const bool gin = g < CW;
  for (int64_t ch = blockIdx.y; ch < nchunks; ch += gridDim.y) {
    double acc[4] = {0.0, 0.0, 0.0, 0.0}, s8[2] = {0.0, 0.0};
    const int64_t kc = ch * kChunk;
    const int64_t left = K - kc < kChunk ? K - kc : kChunk;
#pragma unroll 1
    for (int64_t k4 = 0; k4 < left; k4 += 4) {
      const int64_t k = kc + k4 + t;
      const bool kin = k < K;
      double l1[2][kMaxBands], l2[2][kMaxBands];
#pragma unroll 1
      for (int n = 0; n < m; ++n) {
        const double en = kin ? __ldg(e + k * m + n) : 0.0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < nh) {
            const double a = lorentz_inv(nd.y1[h], en, nd.gg1[h]);
            l1[h][n] = kin ? a : 0.0;
            if (same) {
              l2[h][n] = l1[h][n];
            } else {
              const double b = lorentz_inv(nd.y2[h], en, nd.gg2[h]);
              l2[h][n] = kin ? b : 0.0;
            }
          }
        }
      }
      const double* Wk = W + (kin ? k : 0) * mm * DD;
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        double b[2] = {0.0, 0.0}, w[2] = {0.0, 0.0}, p[2][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int u = 2 * s + jj;
          const bool live = kin && u < mm;
          const int n = live ? u / m : 0, q = live ? u % m : 0;
          if (live) {
            if (gin) b[jj] = __ldg(Wk + u * DD + g);
            if (DD == 9) w[jj] = __ldg(Wk + u * DD + 8);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) p[h][jj] = live && h < nh ? __dmul_rn(l1[h][n], l2[h][q]) : 0.0;
        }
        kstep<DD>(acc, s8, p, b[0], b[1], w[0], w[1]);
      }
    }
    store_partials<DD>(partials, ch, B, p0, g, t, nd, acc, s8);
  }
}

template <int MB, int DD>
int launch_partial(dim3 grid, unsigned threads, cudaStream_t st, const double* e, const double* W, int64_t K,
                   int m, const double* y1, const double* g1, const double* y2, const double* g2, int B,
                   int64_t nchunks, int same, double* partials) {
  if constexpr (MB > 0) {
    const size_t shared = 2 * kStage * (MB * MB * DD + MB) * sizeof(double) + kStage * MB * MB * DD * sizeof(int);
    transport_gamma_partial<MB, DD><<<grid, threads, shared, st>>>(e, W, K, y1, g1, y2, g2, B, nchunks, same,
                                                                   partials);
  } else {
    transport_gamma_partial_any<DD><<<grid, threads, 0, st>>>(e, W, K, m, y1, g1, y2, g2, B, nchunks, same,
                                                              partials);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DD>
int dispatch_m(dim3 grid, unsigned threads, cudaStream_t st, const double* e, const double* W, int64_t K, int m,
               const double* y1, const double* g1, const double* y2, const double* g2, int B, int64_t nchunks,
               int same, double* partials) {
  switch (m) {
    case 1: return launch_partial<1, DD>(grid, threads, st, e, W, K, m, y1, g1, y2, g2, B, nchunks, same, partials);
    case 2: return launch_partial<2, DD>(grid, threads, st, e, W, K, m, y1, g1, y2, g2, B, nchunks, same, partials);
    case 3: return launch_partial<3, DD>(grid, threads, st, e, W, K, m, y1, g1, y2, g2, B, nchunks, same, partials);
    default: return launch_partial<0, DD>(grid, threads, st, e, W, K, m, y1, g1, y2, g2, B, nchunks, same, partials);
  }
}

}  // namespace

// Rows of the partials scratch for K points: one per chunk of kChunk.
extern "C" long long transport_gamma_num_chunks(long long K) { return (K + kChunk - 1) / kChunk; }

// The largest band count K19 takes.
extern "C" int transport_gamma_max_bands() { return kMaxBands; }

// e: (K, m) float64; W: (K m^2, d^2) float64; y1, g1, y2, g2: (B,) float64;
// same: nonzero when y2 and g2 are y1 and g1 (one Lorentzian per (node,
// band)); partials: (transport_gamma_num_chunks(K), B, d^2) scratch; out:
// (B, d^2) float64, written. Returns cudaErrorInvalidValue for d outside
// 1..3 or m outside 1..transport_gamma_max_bands(), else cudaGetLastError()
// after each launch.
extern "C" int transport_gamma_launch(const void* e, const void* W, long long K, int m, int d,
                                      const void* y1, const void* g1, const void* y2, const void* g2,
                                      long long B, int same, double scale, void* partials,
                                      void* out, void* stream) {
  if (d < 1 || d > 3 || m < 1 || m > kMaxBands || B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nchunks = transport_gamma_num_chunks(K);
  const int64_t n = B * d * d;
  if (nchunks > 0) {
    // warps a block: enough for the pairs, up to kMaxWarps (the pair tile)
    const int64_t warps64 = (B + kWarpPairs - 1) / kWarpPairs;
    const int warps = static_cast<int>(warps64 < kMaxWarps ? warps64 : kMaxWarps);
    const int64_t tile = static_cast<int64_t>(warps) * kWarpPairs;
    const dim3 grid(static_cast<unsigned>((B + tile - 1) / tile),
                    static_cast<unsigned>(nchunks < kMaxGridY ? nchunks : kMaxGridY));
    const unsigned threads = 32u * warps;
    const double* ep = static_cast<const double*>(e);
    const double* Wp = static_cast<const double*>(W);
    const double* a = static_cast<const double*>(y1);
    const double* b = static_cast<const double*>(g1);
    const double* c = static_cast<const double*>(y2);
    const double* dd = static_cast<const double*>(g2);
    double* pp = static_cast<double*>(partials);
    const int Bi = static_cast<int>(B);
    int err;
    switch (d) {
      case 1: err = dispatch_m<1>(grid, threads, st, ep, Wp, K, m, a, b, c, dd, Bi, nchunks, same, pp); break;
      case 2: err = dispatch_m<4>(grid, threads, st, ep, Wp, K, m, a, b, c, dd, Bi, nchunks, same, pp); break;
      default: err = dispatch_m<9>(grid, threads, st, ep, Wp, K, m, a, b, c, dd, Bi, nchunks, same, pp);
    }
    if (err != cudaSuccess) return err;
  }
  return autobz::column_sum_launch(static_cast<const double*>(partials), static_cast<double*>(out), nchunks, n,
                                   scale, st);
}
