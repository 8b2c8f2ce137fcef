// K20: the Fermi count of a band grid, in FP64.
//
// Replaces autobzcore_tpu/models/transport.py:302-309, ElectronCountSolver's
// count, the masked reduction
//
//   n(mu, beta) = sum_k w_k sum_b occ(e[k, b] - mu),
//   occ(x) = 1 / (1 + exp(beta x))  (finite beta: the reference's
//            sigmoid(-beta x), which saturates to 0 or 1 without overflow),
//   occ(x) = (x < 0)                 (beta = inf: the zero-temperature step),
//
// for energies e (K, m) and weights w (K,) (orbit multiplicities over
// npt^d), one (mu, beta) a launch.
//
// What bounds it on an H100: nothing but the launch. The flagship's
// 216,000 x 3 energies are 5.2 MB (1.5 us at 3.35 TB/s) and ~25 operations a
// term (the exp); find_mu runs one launch and one host read per bisection
// step.
//
// The design: a two-level reduction in a fixed order. Each block of 256
// threads takes a chunk of kChunk consecutive terms (k, b), each thread a
// strided quarter of them in order, then a tree over the block's threads in
// shared memory, and writes one partial; a second pass of one block adds the
// partials in chunk order the same way. No atomics, so repeats are
// bit-identical.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;  // terms per partial

__device__ __forceinline__ double block_sum(double v, double* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

__global__ void __launch_bounds__(kThreads)
fermi_count_partial(const double* __restrict__ e, const double* __restrict__ w, int64_t K, int m,
                    double mu, double beta, int step, double* __restrict__ partials) {
  __shared__ double sh[kThreads];
  const int64_t n = K * m;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kChunk;
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t t = t0 + j * kThreads + threadIdx.x;
    if (t < n) {
      const double x = __dsub_rn(__ldg(e + t), mu);
      const double occ = step ? (x < 0.0 ? 1.0 : 0.0) : 1.0 / (1.0 + exp(__dmul_rn(beta, x)));
      s += __dmul_rn(__ldg(w + t / m), occ);
    }
  }
  const double tot = block_sum(s, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(kThreads)
fermi_count_reduce(const double* __restrict__ partials, int64_t nparts, double* __restrict__ out) {
  __shared__ double sh[kThreads];
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < nparts; i += kThreads) s += partials[i];
  const double tot = block_sum(s, sh);
  if (threadIdx.x == 0) out[0] = tot;
}

}  // namespace

// Rows of the partials scratch for K points of m bands.
extern "C" long long fermi_count_num_chunks(long long K, int m) {
  return (K * m + kChunk - 1) / kChunk;
}

// e: (K, m) float64; w: (K,) float64; partials: (fermi_count_num_chunks(K,
// m),) scratch; out: (1,) float64, written. beta = inf takes the step.
// Returns cudaErrorInvalidValue for m below 1, else cudaGetLastError() after
// each launch.
extern "C" int fermi_count_launch(const void* e, const void* w, long long K, int m, double mu,
                                  double beta, void* partials, void* out, void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nparts = fermi_count_num_chunks(K, m);
  if (nparts > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (nparts > 0) {
    fermi_count_partial<<<static_cast<unsigned>(nparts), kThreads, 0, st>>>(
        static_cast<const double*>(e), static_cast<const double*>(w), static_cast<int64_t>(K), m, mu,
        beta, std::isinf(beta) ? 1 : 0, static_cast<double*>(partials));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fermi_count_reduce<<<1, kThreads, 0, st>>>(static_cast<const double*>(partials), nparts,
                                             static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
