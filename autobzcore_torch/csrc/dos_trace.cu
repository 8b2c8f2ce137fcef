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
// with the reference's closed forms for m <= 3: 1/M for m = 1, tr/det for
// m = 2 and the adjugate identity (tr^2 - tr M^2) / (2 det) for m = 3.
//
// What bounds it on an H100: every (w, k) pair costs one 3x3 complex
// determinant, a trace of M^2 and a complex division, about 200 FP64 flops.
// At the flagship shape (W = 264, K = 1e6) that is ~5e10 flops against a
// 144 MB read of H, so FP64 arithmetic is the limit; H must not be read
// once per frequency, and the (W, K) matrix of traces must never exist.
//
// What the design does about it:
//  * a block covers 32 frequency lanes (one per thread of a warp) and a
//    chunk of kChunkK k-points; it stages H_k and w_k through shared memory
//    in tiles of kTileK, and its four warps take every fourth k of a tile.
//    All threads of a warp read the same H_k, which shared memory broadcasts;
//  * blocks of one k-chunk are adjacent in launch order (frequency tiles on
//    blockIdx.x), so H is fetched from device memory about once and re-read
//    from L2 by the other frequency tiles;
//  * blocks run in no order, so the cross-block sum is a second pass: each
//    block writes one partial per lane, and dos_reduce_kernel adds the
//    partials of each lane in chunk order. No atomics, so repeated runs are
//    bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;     // frequency lanes per block
constexpr int kKWarps = 4;     // warps per block, each over every fourth k
constexpr int kTileK = 128;    // k-points per shared tile
constexpr int kChunkK = 4096;  // k-points per block (one partial per lane)
constexpr int kThreads = kLanes * kKWarps;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
// Im(a / b)
__device__ __forceinline__ double cdiv_imag(double2 a, double2 b) {
  return (a.y * b.x - a.x * b.y) / (b.x * b.x + b.y * b.y);
}

// Im Tr (z I - H)^{-1} for one row-major m x m matrix h.
template <int M>
__device__ __forceinline__ double trace_inv_imag(const double2* h, double2 z);

template <>
__device__ __forceinline__ double trace_inv_imag<1>(const double2* h, double2 z) {
  return cdiv_imag(make_double2(1.0, 0.0), csub(z, h[0]));
}

template <>
__device__ __forceinline__ double trace_inv_imag<2>(const double2* h, double2 z) {
  const double2 m00 = csub(z, h[0]), m11 = csub(z, h[3]);
  const double2 m01 = h[1], m10 = h[2];  // off-diagonal of M is -h; the signs cancel in det
  const double2 det = csub(cmul(m00, m11), cmul(m01, m10));
  return cdiv_imag(cadd(m00, m11), det);
}

template <>
__device__ __forceinline__ double trace_inv_imag<3>(const double2* h, double2 z) {
  double2 m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = make_double2(-h[i].x, -h[i].y);
  m[0] = csub(z, h[0]);
  m[4] = csub(z, h[4]);
  m[8] = csub(z, h[8]);
  const double2 tr = cadd(cadd(m[0], m[4]), m[8]);
  // tr(M^2) = sum_ij M_ij M_ji
  double2 tr2 = cadd(cadd(cmul(m[0], m[0]), cmul(m[4], m[4])), cmul(m[8], m[8]));
  const double2 off = cadd(cadd(cmul(m[1], m[3]), cmul(m[2], m[6])), cmul(m[5], m[7]));
  tr2 = cadd(tr2, cadd(off, off));
  // cofactor expansion along the first row
  const double2 c0 = csub(cmul(m[4], m[8]), cmul(m[5], m[7]));
  const double2 c1 = csub(cmul(m[3], m[8]), cmul(m[5], m[6]));
  const double2 c2 = csub(cmul(m[3], m[7]), cmul(m[4], m[6]));
  const double2 det = cadd(csub(cmul(m[0], c0), cmul(m[1], c1)), cmul(m[2], c2));
  const double2 num = csub(cmul(tr, tr), tr2);
  return 0.5 * cdiv_imag(num, det);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
dos_partials_kernel(const double2* __restrict__ H, const double* __restrict__ w,
                    const double* __restrict__ omega, const double* __restrict__ eta,
                    double* __restrict__ partials, int64_t K, int W) {
  constexpr int MM = M * M;
  __shared__ double2 hs[kTileK * MM];
  __shared__ double ws[kTileK];
  __shared__ double red[kKWarps][kLanes];

  const int lane = threadIdx.x % kLanes;
  const int kw = threadIdx.x / kLanes;
  const int wi = blockIdx.x * kLanes + lane;
  const bool live = wi < W;
  const double2 z = live ? make_double2(omega[wi], eta[wi]) : make_double2(0.0, 1.0);

  const int64_t kbeg = static_cast<int64_t>(blockIdx.y) * kChunkK;
  const int64_t kend = K < kbeg + kChunkK ? K : kbeg + kChunkK;
  double acc = 0.0;
  for (int64_t t0 = kbeg; t0 < kend; t0 += kTileK) {
    const int nk = static_cast<int>(kend - t0 < kTileK ? kend - t0 : kTileK);
    __syncthreads();
    for (int i = threadIdx.x; i < nk * MM; i += kThreads) hs[i] = H[t0 * MM + i];
    for (int i = threadIdx.x; i < nk; i += kThreads) ws[i] = w[t0 + i];
    __syncthreads();
    for (int j = kw; j < nk; j += kKWarps) acc += ws[j] * trace_inv_imag<M>(hs + j * MM, z);
  }
  red[kw][lane] = acc;
  __syncthreads();
  if (kw == 0 && live) {
    double s = red[0][lane];
#pragma unroll
    for (int q = 1; q < kKWarps; ++q) s += red[q][lane];
    partials[static_cast<int64_t>(blockIdx.y) * W + wi] = s;
  }
}

// out[w] = factor * sum_c partials[c, w], summed in chunk order.
__global__ void dos_reduce_kernel(const double* __restrict__ partials, double* __restrict__ out,
                                  int nchunks, int W, double factor) {
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= W) return;
  double s = 0.0;
  for (int c = 0; c < nchunks; ++c) s += partials[static_cast<int64_t>(c) * W + wi];
  out[wi] = factor * s;
}

}  // namespace

// Number of k-chunks, i.e. rows of the partials scratch the caller allocates.
extern "C" long long dos_trace_num_chunks(long long K) { return (K + kChunkK - 1) / kChunkK; }

// H: (K, m, m) complex128 as double2; w: (K,); omega, eta: (W,); partials:
// (num_chunks(K), W); out: (W,), all float64. out = -scale/pi * sum_k w_k Im Tr(...).
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// m outside 1..3 or a chunk count beyond the grid limit.
extern "C" int dos_trace_weighted_sum_launch(const void* H, const void* w, const void* omega,
                                             const void* eta, void* partials, void* out,
                                             long long K, int W, int m, double factor,
                                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nchunks = dos_trace_num_chunks(K);
  if (W <= 0) return static_cast<int>(cudaGetLastError());
  if (nchunks > 65535 || m < 1 || m > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks > 0) {
    const dim3 grid((W + kLanes - 1) / kLanes, static_cast<unsigned>(nchunks));
    const auto* Hp = static_cast<const double2*>(H);
    const auto* wp = static_cast<const double*>(w);
    const auto* op = static_cast<const double*>(omega);
    const auto* ep = static_cast<const double*>(eta);
    auto* pp = static_cast<double*>(partials);
    if (m == 1) {
      dos_partials_kernel<1><<<grid, kThreads, 0, st>>>(Hp, wp, op, ep, pp, K, W);
    } else if (m == 2) {
      dos_partials_kernel<2><<<grid, kThreads, 0, st>>>(Hp, wp, op, ep, pp, K, W);
    } else {
      dos_partials_kernel<3><<<grid, kThreads, 0, st>>>(Hp, wp, op, ep, pp, K, W);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dos_reduce_kernel<<<(W + 127) / 128, 128, 0, st>>>(static_cast<const double*>(partials),
                                                     static_cast<double*>(out),
                                                     static_cast<int>(nchunks), W, factor);
  return static_cast<int>(cudaGetLastError());
}
