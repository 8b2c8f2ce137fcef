// K3: lane-batched contraction of Fourier coefficients at per-lane points,
// in FP64.
//
// Replaces autobzcore_tpu/ops/fourier_eval.py:104 contract (with
// phase_matrix :38), as the nested solver calls it through
// autobzcore_tpu/fourier.py:105,391 (FourierCarrier.fix, one contraction per
// outer node under vmap) and the 1-D series values of
// FourierCarrier.eval_batch (fourier.py:394-410). For lane l, node j, the
// remaining coefficient row r and value v it computes
//
//   out[l, j, r, v] = sum_n c[cmap[l], r, n, v] exp(2 pi i (o + n) x[l, j] / t)
//
// with the reference's conventions: frequencies o + 0..n-1 of the contracted
// (last spatial) axis, coefficients c[(rows), n, V] in C order.
//
// What bounds it on an H100: each output costs n complex multiply-adds
// (8n FP64 flops) and reads n coefficients; the phases are shared by all
// outputs of a (lane, node) pair. On the nest's shapes (5^3 or 5^2 rows of
// V = 9, 30 nodes per lane) the whole call moves a few MB and does ~1e7
// flops, so it is bound by launch and latency, not by FP64 rate or bytes.
//
// What the design does about it:
//  * one block per (lane, node) pair: its threads make the pair's n phases
//    once with sincospi, straight from the frequency (no recurrence), into
//    shared memory, then each thread computes whole outputs, reading its
//    coefficients from device memory (a Wannier box need not fit in shared
//    memory; the lane's coefficients are re-read from L2 by the pair's
//    other nodes);
//  * consecutive threads take consecutive (row, value) outputs, so the
//    coefficient reads of a warp are contiguous in v;
//  * a lane map entry outside 0..Lc-1 reads nothing and gives NaN outputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 1024;  // frequencies of the contracted axis kept in shared memory

__global__ void __launch_bounds__(kThreads)
fourier_contract_kernel(const double2* __restrict__ c, const int64_t* __restrict__ cmap,
                        const double* __restrict__ x, double2* __restrict__ out, int J,
                        int R, int n, int V, int64_t Lc, int offset, double inv_t) {
  __shared__ double2 ph[kMaxN];
  const int64_t pair = blockIdx.x;  // l * J + j
  const int64_t l = pair / J;
  const double u = x[pair] * inv_t;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    double s, co;
    sincospi(2.0 * (static_cast<double>(offset + i) * u), &s, &co);
    ph[i] = make_double2(co, s);
  }
  __syncthreads();
  const int64_t RV = static_cast<int64_t>(R) * V;
  const int64_t cm = cmap[l];
  double2* o = out + pair * RV;
  if (cm < 0 || cm >= Lc) {
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    for (int64_t q = threadIdx.x; q < RV; q += blockDim.x) o[q] = make_double2(nan, nan);
    return;
  }
  const double2* cl = c + cm * RV * n;
  for (int64_t q = threadIdx.x; q < RV; q += blockDim.x) {
    const int64_t r = q / V;
    const int64_t v = q - r * V;
    const double2* src = cl + r * n * V + v;
    double2 acc = make_double2(0.0, 0.0);
    for (int i = 0; i < n; ++i) {
      const double2 cv = src[static_cast<int64_t>(i) * V];
      const double2 p = ph[i];
      acc.x = fma(p.x, cv.x, fma(-p.y, cv.y, acc.x));
      acc.y = fma(p.x, cv.y, fma(p.y, cv.x, acc.y));
    }
    o[q] = acc;
  }
}

}  // namespace

// c: (Lc, R, n, V) complex128 as double2; cmap: (L,) int64 into Lc; x: (L, J)
// float64; out: (L, J, R, V) complex128. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for n beyond the shared phase table.
extern "C" int fourier_contract_launch(const void* c, const void* cmap, const void* x, void* out,
                                       long long L, int J, long long R, int n, int V,
                                       long long Lc, int offset, double period, void* stream) {
  if (L <= 0 || J <= 0) return static_cast<int>(cudaGetLastError());
  if (n < 1 || n > kMaxN || R > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long blocks = static_cast<unsigned long long>(L) * J;
  if (blocks > 0x7fffffffULL) return static_cast<int>(cudaErrorInvalidValue);
  fourier_contract_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(c), static_cast<const int64_t*>(cmap),
      static_cast<const double*>(x), static_cast<double2*>(out), J, static_cast<int>(R), n, V, Lc,
      offset, 1.0 / period);
  return static_cast<int>(cudaGetLastError());
}
