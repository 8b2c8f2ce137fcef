// K1 and K11: evaluation of a Fourier series, and of its derivatives, at
// scattered points, in FP64 on the tensor cores.
//
// K1 replaces autobzcore_tpu/ops/fourier_eval.py:78 evaluate_points (with
// phase_matrix :38 and _batched_contract :97), which XLA lowers to one
// (K, n_d) x (n_1..n_d, V) matmul followed by per-point batched
// contractions. K11 replaces the derivative form of the same function and
// :115 evaluate_points_jacobian, which XLA runs as d + 1 such evaluations
// with the phase matrices scaled by (2 pi i f_j)^k_j. For every point x_k and
// each of R <= 4 derivative orders (k_r1..k_rd) this file computes
//
//   out[k, r, v] = sum_n c[n, v] prod_j (2 pi i f_j)^k_rj
//                                exp(2 pi i sum_j f_j x_kj / t_j)
//
// with the reference's conventions: offsets o_j, periods t_j, frequencies
// f_j = o_j + 0..n_j-1, coefficients c[(n_1..n_d), V] in C order, and
// derivatives taken with respect to z_j = x_j / t_j. K1 is the case R = 1 at
// order zero.
//
// What bounds it on an H100: the function is a complex matrix product, the
// generated (K x N) phase matrix by the (N x R V) derivative coefficients
// c_r[n, v] = S_r(n) i^(p_r) c[n, v] (S_r = prod_j (2 pi f_j)^k_rj, p_r =
// sum_j k_rj). At the flagship shape (K = 1e6 points, N = 125 rows, V = 9)
// that is ~9e9 FP64 flops for K1 and ~3.6e10 for the Jacobian (R = 4)
// against 144 MB (576 MB) of output: FP64 arithmetic, not memory, is the
// limit, at the tensor cores' 67 TFLOP/s.
//
// What the design does about it:
//  * the product runs on the FP64 tensor cores (mma.sync .f64, DMMA) as a
//    real product: the phases are the A operand, [Re ph | Im ph] along k,
//    against the real block form [[Re c, Im c], [-Im c, Re c]] of the
//    coefficients, whose columns interleave (Re, Im) of each output, so
//    that the accumulator fragment holds whole complex outputs;
//  * the rows are dealt into four streams of L = ceil(N / 4) consecutive
//    rows; a k-slab of the product holds one row of each stream, and the
//    lane of the A fragment with threadID_in_group t holds row t L + s of
//    slab s, real and imaginary part at k = t and t + 4 of the m16n8k8
//    product (the depth that timed best against m16n8k4 and m16n8k16, as
//    PERF.md records). So each thread makes the
//    phases of its own fragment in registers, for its two points, with no
//    shared-memory A tile: sincospi where a stream starts and every
//    kRestart slabs (warp-uniform), and between them one complex multiply
//    by exp(2 pi i x_j / t_j) a row, a second where a row of n_d or a block
//    of n_(d-1) n_d ends (cheap where the four streams of a warp diverge;
//    the recurrence error stays near n_1 + .. + n_d ulp);
//  * the derivative factors are folded into the coefficients once per block
//    and row as the block stages them into shared memory, so output r is
//    just more columns of the one product. At order zero the factor is
//    exactly 1, so K1 is the zero-order instance, bit for bit: every output
//    is the same sequence of products over the same k order, whatever the
//    other columns;
//  * a block of four warps takes tiles of 64 points (16 a warp) by up to
//    36 complex outputs (nine n8 tiles: 72 accumulator registers a thread);
//    wider outputs take several column tiles, and so do narrower ones where
//    the point tiles alone would leave SMs idle (a chunk of 4,096 points is
//    64 point tiles on 132 SMs). The output is stored straight from the
//    accumulator fragments: staging it through shared memory to write
//    whole lines timed slower (tools/fourier_variants.py, PERF.md). The
//    staged slab is laid out [slab][n8 tile][column / 2][t] so that a
//    warp's B fragment loads read 256 contiguous bytes, free of bank
//    conflicts. The grid is the blocks
//    the card holds at once, each walking over its tiles: where the whole
//    slab stack fits (N <= 128 rows at 36 outputs) a block stages it once
//    per column tile; larger boxes are staged in chunks of rows per tile;
//  * each output's sum runs over the same k order whatever the grid and the
//    column tiling, and nothing is summed across blocks: bit-identical on
//    repeat.

#include <cuda_runtime.h>

#include <cstdint>

#include "dmma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTilePoints = 16 * kWarps;  // points per block tile: a warp's m16
constexpr int kMaxTN = 9;                 // n8 tiles per block: 36 complex outputs
constexpr int kSmemBudget = 72 * 1024;    // staged coefficients per block: three blocks an SM
constexpr int kMaxOut = 4;                // derivative orders per launch (the Jacobian in 3-D)
constexpr int kRestart = 32;              // slabs between sincospi restarts of a stream
constexpr double kTwoPi = 6.283185307179586;  // 2 pi, as numpy's 2 * np.pi

// Derivative orders per output, in the three right-aligned slots.
struct Orders {
  int k[kMaxOut][3];
};

// Slots 0..2 hold the spatial dimensions right-aligned: for d < 3 the leading
// slots have one frequency (n = 1, o = 0), coordinate 0 and order 0.
struct Geometry {
  int n0, n1, n2, o0, o1, o2;
  double inv_t0, inv_t1, inv_t2;
  int N;   // coefficient rows n0 n1 n2
  int L;   // slabs: rows per stream
  int CS;  // slabs staged at once
  int V;   // values per row
  int VP;  // complex outputs per point, R V
};

// The per-point arithmetic below rounds explicitly (no contraction left to
// the compiler): a thread makes the phases of two points, rows g and g + 8,
// in two inlined copies of the same code, and both copies must round alike,
// so that a point's value does not depend on its place in the launch.
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(__fma_rn(a.x, b.x, -__dmul_rn(a.y, b.y)), __fma_rn(a.x, b.y, __dmul_rn(a.y, b.x)));
}

// S i^p z for p in 0..3.
__device__ __forceinline__ double2 scale_rotate(double2 z, double S, int p) {
  switch (p & 3) {
    case 0: return make_double2(S * z.x, S * z.y);
    case 1: return make_double2(-S * z.y, S * z.x);
    case 2: return make_double2(-S * z.x, -S * z.y);
    default: return make_double2(S * z.y, -S * z.x);
  }
}

using autobz::dmma;

__device__ __forceinline__ void load_u(const double* __restrict__ X, int64_t k, int64_t K, int d,
                                       const Geometry& G, double (&u)[3]) {
  u[0] = u[1] = u[2] = 0.0;
  if (k >= K) return;
  const double* xk = X + k * d;
  if (d == 3) {
    u[0] = __dmul_rn(xk[0], G.inv_t0);
    u[1] = __dmul_rn(xk[1], G.inv_t1);
    u[2] = __dmul_rn(xk[2], G.inv_t2);
  } else if (d == 2) {
    u[1] = __dmul_rn(xk[0], G.inv_t1);
    u[2] = __dmul_rn(xk[1], G.inv_t2);
  } else {
    u[2] = __dmul_rn(xk[0], G.inv_t2);
  }
}

// One thread's row stream: row n = t L + s of slab s, its indices, and per
// point (rows g and g + 8 of the warp's tile) the phase of the row, of its
// innermost row's start (i2 = 0) and of its outer block's start (i1 = i2 =
// 0), with the phase ratios of adjacent frequencies along each slot.
struct PointPhase {
  double2 ph, rs, r0, s0, s1, s2;
};

struct Stream {
  int i0, i1, i2;
  PointPhase A, B;
};

__device__ __forceinline__ double2 expi2pi(double a) {
  double sn, cs;
  sincospi(2.0 * a, &sn, &cs);
  return make_double2(cs, sn);
}

__device__ __forceinline__ void point_steps(PointPhase& P, const double (&u)[3]) {
  P.s0 = expi2pi(u[0]);
  P.s1 = expi2pi(u[1]);
  P.s2 = expi2pi(u[2]);
}

__device__ __forceinline__ void point_restart(PointPhase& P, const double (&u)[3], const Stream& st,
                                              const Geometry& G) {
  const double a0 = __dmul_rn(st.i0 + G.o0, u[0]);
  const double a01 = __dadd_rn(a0, __dmul_rn(st.i1 + G.o1, u[1]));
  const double b2 = __dmul_rn(G.o2, u[2]);
  P.ph = expi2pi(__dadd_rn(a01, __dmul_rn(st.i2 + G.o2, u[2])));
  P.rs = expi2pi(__dadd_rn(a01, b2));
  P.r0 = expi2pi(__dadd_rn(__dadd_rn(a0, __dmul_rn(G.o1, u[1])), b2));
}

// The next row's phase: ph s2 within a row of n_d, rs s1 at a new row, r0 s0
// at a new block.
__device__ __forceinline__ void point_advance(PointPhase& P, bool wrap2, bool wrap1) {
  if (!wrap2) {
    P.ph = cmul(P.ph, P.s2);
  } else {
    if (!wrap1) {
      P.rs = cmul(P.rs, P.s1);
    } else {
      P.r0 = cmul(P.r0, P.s0);
      P.rs = P.r0;
    }
    P.ph = P.rs;
  }
}

__device__ __forceinline__ void stream_start(Stream& st, int n, const Geometry& G) {
  st.i2 = n % G.n2;
  const int q = n / G.n2;
  st.i1 = q % G.n1;
  st.i0 = q / G.n1;
}

// The phases of row n = t L + s at slab s (0 on pad rows), then the stream
// moves to row n + 1. sincospi restarts the recurrence where a stream starts
// and every kRestart slabs (warp-uniform); between, one complex multiply a
// row and point, so the recurrence error stays near n_0 + n_1 + n_2 ulp.
__device__ __forceinline__ void stream_phase(Stream& st, int s, int n, const Geometry& G,
                                             const double* __restrict__ X, int64_t kA, int64_t kB,
                                             int64_t K, int d, double2& pA, double2& pB) {
  if ((s & (kRestart - 1)) == 0) {
    double u[3];
    load_u(X, kA, K, d, G, u);
    point_restart(st.A, u, st, G);
    load_u(X, kB, K, d, G, u);
    point_restart(st.B, u, st, G);
  }
  if (n < G.N) {
    pA = st.A.ph;
    pB = st.B.ph;
  } else {
    pA = make_double2(0.0, 0.0);
    pB = make_double2(0.0, 0.0);
  }
  const bool wrap2 = ++st.i2 == G.n2;
  bool wrap1 = false;
  if (wrap2) {
    st.i2 = 0;
    wrap1 = ++st.i1 == G.n1;
    if (wrap1) {
      st.i1 = 0;
      ++st.i0;
    }
  }
  point_advance(st.A, wrap2, wrap1);
  point_advance(st.B, wrap2, wrap1);
}

// Stage slabs s0 .. s0 + cs - 1 of the block's columns j0 .. j0 + 4 TN - 1
// (zero beyond R V and on pad rows), derivative factors folded in:
// Bs[(sl TN + jl / 4) 16 + (jl % 4) 4 + t] = c_r[t L + s0 + sl, v], j = r V + v.
template <int TN, bool kDeriv>
__device__ __forceinline__ void stage(double2* Bs, const double2* __restrict__ c, const Geometry& G,
                                      const Orders& ord, int s0, int cs, int j0) {
  constexpr int JB = 4 * TN;
  for (int e = threadIdx.x; e < cs * 4 * JB; e += kThreads) {
    const int jl = e % JB;
    const int rs = e / JB;
    const int t = rs & 3, sl = rs >> 2;
    const int n = t * G.L + s0 + sl;
    const int j = j0 + jl;
    double2 val = make_double2(0.0, 0.0);
    if (n < G.N && j < G.VP) {
      const int r = j / G.V;
      const int v = j - r * G.V;
      val = c[static_cast<int64_t>(n) * G.V + v];
      if constexpr (kDeriv) {
        const int i2 = n % G.n2, q = n / G.n2;
        const int i1 = q % G.n1, i0 = q / G.n1;
        const double tf0 = kTwoPi * (i0 + G.o0), tf1 = kTwoPi * (i1 + G.o1), tf2 = kTwoPi * (i2 + G.o2);
        double S = 1.0;
        for (int m = 0; m < ord.k[r][0]; ++m) S *= tf0;
        for (int m = 0; m < ord.k[r][1]; ++m) S *= tf1;
        for (int m = 0; m < ord.k[r][2]; ++m) S *= tf2;
        val = scale_rotate(val, S, ord.k[r][0] + ord.k[r][1] + ord.k[r][2]);
      }
    }
    Bs[(sl * TN + (jl >> 2)) * 16 + (jl & 3) * 4 + t] = val;
  }
}

// out is (K, R, V): complex column j = r V + v of point k at k VP + j.
// kDeriv = false is K1: R = 1 at order zero, no folding. Tile w is column
// tile w / ptiles and point tile w % ptiles. With one column tile the blocks
// stride over the point tiles, so that the card writes one stretch of the
// output at a time; with several each block takes an even, contiguous share
// of the tiles and restages where its column tile changes (and every tile
// where the slab stack takes several chunks).
template <int TN, bool kDeriv>
__global__ void __launch_bounds__(kThreads, 3)
fourier_points_kernel(const double2* __restrict__ c, const double* __restrict__ X,
                      double2* __restrict__ out, int64_t K, int d, Geometry G, Orders ord,
                      int ptiles, int tiles) {
  extern __shared__ double2 Bs[];
  constexpr int JB = 4 * TN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool odd = g & 1;  // the lane's B column is the imaginary part of its output
  const bool resident = G.CS >= G.L;
  const bool strided = tiles == ptiles;
  const int w0 = strided ? blockIdx.x : static_cast<int>(static_cast<int64_t>(tiles) * blockIdx.x / gridDim.x);
  const int w1 = strided ? tiles : static_cast<int>(static_cast<int64_t>(tiles) * (blockIdx.x + 1) / gridDim.x);
  const int step = strided ? gridDim.x : 1;
  int staged = -1;  // the column tile in shared memory

  for (int w = w0; w < w1; w += step) {
    const int ct = w / ptiles, pt = w - ct * ptiles;
    const int j0 = ct * JB;
    const int64_t kA = static_cast<int64_t>(pt) * kTilePoints + warp * 16 + g, kB = kA + 8;
    Stream st;
    stream_start(st, t * G.L, G);
    double u[3];
    load_u(X, kA, K, d, G, u);
    point_steps(st.A, u);
    load_u(X, kB, K, d, G, u);
    point_steps(st.B, u);
    double acc[TN][4];
#pragma unroll
    for (int nt = 0; nt < TN; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0;

    for (int s0 = 0; s0 < G.L; s0 += G.CS) {
      const int ncs = min(G.CS, G.L - s0);
      if (!resident || staged != ct) {
        __syncthreads();
        stage<TN, kDeriv>(Bs, c, G, ord, s0, ncs, j0);
        __syncthreads();
        staged = ct;
      }
      for (int sl = 0; sl < ncs; ++sl) {
        const int s = s0 + sl, n = t * G.L + s;
        const double2* brow = Bs + sl * TN * 16 + (g >> 1) * 4 + t;
        double2 pA, pB;
        stream_phase(st, s, n, G, X, kA, kB, K, d, pA, pB);
        const double a[4] = {pA.x, pB.x, pA.y, pB.y};
#pragma unroll
        for (int nt = 0; nt < TN; ++nt) {
          const double2 cv = brow[nt * 16];
          dmma(acc[nt], a, odd ? cv.y : cv.x, odd ? cv.x : -cv.y);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < TN; ++nt) {
      const int j = j0 + nt * 4 + t;
      if (j < G.VP) {
        if (kA < K) out[kA * G.VP + j] = make_double2(acc[nt][0], acc[nt][1]);
        if (kB < K) out[kB * G.VP + j] = make_double2(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// The card's SM count, read at the first launch (one card a process).
int sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *sms = cached;
  return 0;
}

template <int TN, bool kDeriv>
int launch_tn(const void* c, const void* X, void* out, long long K, int d, const Geometry& G0,
              const Orders& ord, long long ctiles, int sms, cudaStream_t stream) {
  auto kernel = fourier_points_kernel<TN, kDeriv>;
  constexpr int slab_bytes = TN * 16 * static_cast<int>(sizeof(double2));
  constexpr int max_cs = kSmemBudget / slab_bytes;  // 32 slabs at TN = 9
  Geometry G = G0;
  G.CS = G.L < max_cs ? G.L : max_cs;
  const int smem = G.CS * slab_bytes;
  // the opt-in above 48 KB, once, and the resident blocks an SM at each
  // staged depth, once each
  static bool attr = false;
  static int per_sm_at[max_cs + 1] = {};
  cudaError_t err;
  if (!attr) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  int per_sm = per_sm_at[G.CS];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    per_sm_at[G.CS] = per_sm;
  }
  const long long ptiles = (K + kTilePoints - 1) / kTilePoints, tiles = ctiles * ptiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long blocks = tiles < resident ? tiles : resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const double2*>(c), static_cast<const double*>(X), static_cast<double2*>(out),
      static_cast<int64_t>(K), d, G, ord, static_cast<int>(ptiles), static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <bool kDeriv>
int launch(const void* c, const void* X, void* out, long long K, int d, int n0, int n1, int n2,
           int o0, int o1, int o2, double t0, double t1, double t2, int V, int R, const Orders& ord,
           void* stream) {
  if (K <= 0 || V <= 0) return static_cast<int>(cudaGetLastError());
  const long long N = static_cast<long long>(n0) * n1 * n2;
  if (n0 < 1 || n1 < 1 || n2 < 1 || N > 0x1fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Geometry G;
  G.n0 = n0, G.n1 = n1, G.n2 = n2, G.o0 = o0, G.o1 = o1, G.o2 = o2;
  G.inv_t0 = 1.0 / t0, G.inv_t1 = 1.0 / t1, G.inv_t2 = 1.0 / t2;
  G.N = static_cast<int>(N);
  G.L = static_cast<int>((N + 3) / 4);
  G.V = V;
  const long long VP = static_cast<long long>(R) * V;
  if (VP > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  G.VP = static_cast<int>(VP);
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  // column tiles of at most 36 outputs, as even as the tiles of four allow;
  // more of them, down to four outputs, where the point tiles alone give
  // the card fewer than two tiles an SM (at 4,096 points, R = 4, V = 9,
  // five column tiles timed best of 1, 2, 3, 5 and 9: tools/fourier_variants.py)
  const long long ptiles = (K + kTilePoints - 1) / kTilePoints;
  long long ctiles = (VP + 4 * kMaxTN - 1) / (4 * kMaxTN);
  if (ctiles * ptiles < 2LL * sms) {
    const long long fill = (2LL * sms + ptiles - 1) / ptiles, most = (VP + 3) / 4;
    ctiles = fill < most ? fill : most;
  }
  const int tn = static_cast<int>(((VP + ctiles - 1) / ctiles + 3) / 4);
  ctiles = (VP + 4 * tn - 1) / (4 * tn);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tn) {
    case 1: return launch_tn<1, kDeriv>(c, X, out, K, d, G, ord, ctiles, sms, s);
    case 2: return launch_tn<2, kDeriv>(c, X, out, K, d, G, ord, ctiles, sms, s);
    case 3: return launch_tn<3, kDeriv>(c, X, out, K, d, G, ord, ctiles, sms, s);
    case 4: return launch_tn<4, kDeriv>(c, X, out, K, d, G, ord, ctiles, sms, s);
    case 5: return launch_tn<5, kDeriv>(c, X, out, K, d, G, ord, ctiles, sms, s);
    case 6: return launch_tn<6, kDeriv>(c, X, out, K, d, G, ord, ctiles, sms, s);
    case 7: return launch_tn<7, kDeriv>(c, X, out, K, d, G, ord, ctiles, sms, s);
    case 8: return launch_tn<8, kDeriv>(c, X, out, K, d, G, ord, ctiles, sms, s);
    default: return launch_tn<9, kDeriv>(c, X, out, K, d, G, ord, ctiles, sms, s);
  }
}

}  // namespace

// K1. c: (n0*n1*n2, V) complex128 as double2; X: (K, d) float64; out: (K, V)
// complex128. Returns cudaGetLastError() after the launch.
extern "C" int fourier_points_launch(const void* c, const void* X, void* out, long long K,
                                     int d, int n0, int n1, int n2, int o0, int o1, int o2,
                                     double t0, double t1, double t2, int V, void* stream) {
  if (d < 1 || d > 3) return static_cast<int>(cudaErrorInvalidValue);
  const Orders zero = {};
  return launch<false>(c, X, out, K, d, n0, n1, n2, o0, o1, o2, t0, t1, t2, V, 1, zero, stream);
}

// K11. As K1, with R (1..4) derivative orders: orders holds R x d
// non-negative ints, output r's order along spatial dimension j at
// orders[r * d + j]; out: (K, R, V) complex128. Returns cudaErrorInvalidValue
// for R or d out of range or a negative order, else cudaGetLastError()
// after the launch.
extern "C" int fourier_points_derivs_launch(const void* c, const void* X, void* out, long long K,
                                            int d, int n0, int n1, int n2, int o0, int o1, int o2,
                                            double t0, double t1, double t2, int V, int R,
                                            const int* orders, void* stream) {
  if (R < 1 || R > kMaxOut || d < 1 || d > 3) return static_cast<int>(cudaErrorInvalidValue);
  Orders ord = {};
  for (int r = 0; r < R; ++r) {
    for (int j = 0; j < d; ++j) {
      const int kj = orders[r * d + j];
      if (kj < 0) return static_cast<int>(cudaErrorInvalidValue);
      ord.k[r][3 - d + j] = kj;
    }
  }
  return launch<true>(c, X, out, K, d, n0, n1, n2, o0, o1, o2, t0, t1, t2, V, R, ord, stream);
}
