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
// (8n FP64 flops) and reads n coefficients, which every node of the lane
// shares; the phases are shared by all outputs of a (lane, node) pair. On
// the nest's shapes (5^3 or 5^2 rows of V = 9, n = 5, 30 nodes per lane)
// the whole call moves a few to 25 MB and does ~1e7 flops, so it is bound by
// bytes (the outputs) and by latency, not by FP64 rate. The contraction is
// too shallow (n = 5) for a tensor-core product.
//
// What the design does about it:
//  * one block of 256 threads per (lane, chunk of (row, value) outputs,
//    chunk of nodes), the chunks chosen from L so that the grid holds about
//    two blocks an SM: 990 mid lanes take a lane a block (45 outputs by 30
//    nodes); 33 outer lanes split their 225 outputs into 8 chunks of 29,
//    each over all 30 nodes, so that a staged coefficient still serves 30
//    nodes; a slab beyond shared memory takes more, smaller output chunks.
//    (128 threads, or splitting the outer lanes' nodes rather than their
//    outputs, left the outer level's call slower than a block per (lane,
//    node) pair; tools/fourier_ab.py times both shapes);
//  * the block copies the lane's coefficient slab (its chunk of outputs)
//    into shared memory once, with cp.async, while its threads make the
//    chunk's J_c x n phases with sincospi, straight from the frequency (no
//    recurrence);
//  * consecutive threads compute consecutive (node, row, value) outputs, so
//    the block writes its part of the lane's output slab out[l, j0:j1],
//    which is contiguous, in whole lines; each output is the same fma
//    sequence over n in order as the plain version's terms, whatever the
//    chunking, and nothing is summed across blocks: bit-identical on repeat;
//  * a lane map entry outside 0..Lc-1 reads nothing and gives NaN outputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 1024;                      // frequencies of the contracted axis
constexpr int kSmemEntries = 48 * 1024 / 16;     // complex entries of shared memory a block
constexpr int kBlocksPerSm = 2;                  // the grid the chunks aim at

__device__ __forceinline__ void copy16_async(double2* dst, const double2* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// c: (Lc, R, n, V); out: (L, J, RV), RV = R V. Block b covers lane l, nodes
// j0 .. j0 + nj - 1 and outputs q0 .. q0 + nq - 1 of each node.
__global__ void __launch_bounds__(kThreads)
fourier_contract_kernel(const double2* __restrict__ c, const int64_t* __restrict__ cmap,
                        const double* __restrict__ x, double2* __restrict__ out, int J, int RV,
                        int n, int V, int64_t Lc, int offset, double inv_t, int Jc, int jchunks,
                        int Q, int qchunks) {
  extern __shared__ double2 sm[];
  double2* cs = sm;          // n x Q: cs[i Q + ql] = c[cm, r, i, v], q0 + ql = r V + v
  double2* ph = sm + n * Q;  // Jc x n
  const int64_t b = blockIdx.x;
  const int qc = static_cast<int>(b % qchunks);
  const int64_t rest = b / qchunks;
  const int jc = static_cast<int>(rest % jchunks);
  const int64_t l = rest / jchunks;
  const int j0 = jc * Jc, nj = min(Jc, J - j0);
  const int q0 = qc * Q, nq = min(Q, RV - q0);
  const int64_t cm = cmap[l];
  double2* o = out + (l * J + j0) * RV + q0;
  if (cm < 0 || cm >= Lc) {
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    for (int e = threadIdx.x; e < nj * nq; e += kThreads) {
      const int jj = e / nq;
      o[static_cast<int64_t>(jj) * RV + (e - jj * nq)] = make_double2(nan, nan);
    }
    return;
  }
  const double2* cl = c + cm * RV * static_cast<int64_t>(n);
  for (int e = threadIdx.x; e < n * nq; e += kThreads) {
    const int i = e / nq;
    const int ql = e - i * nq;
    const int q = q0 + ql;
    const int r = q / V;
    copy16_async(cs + i * Q + ql, cl + (static_cast<int64_t>(r) * n + i) * V + (q - r * V));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const double* xl = x + l * J + j0;
  for (int e = threadIdx.x; e < nj * n; e += kThreads) {
    const int jj = e / n;
    const int i = e - jj * n;
    const double u = xl[jj] * inv_t;
    double s, co;
    sincospi(2.0 * (static_cast<double>(offset + i) * u), &s, &co);
    ph[e] = make_double2(co, s);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int e = threadIdx.x; e < nj * nq; e += kThreads) {
    const int jj = e / nq;
    const int ql = e - jj * nq;
    const double2* p = ph + jj * n;
    double2 acc = make_double2(0.0, 0.0);
    for (int i = 0; i < n; ++i) {
      const double2 cv = cs[i * Q + ql];
      const double2 pv = p[i];
      acc.x = fma(pv.x, cv.x, fma(-pv.y, cv.y, acc.x));
      acc.y = fma(pv.x, cv.y, fma(pv.y, cv.x, acc.y));
    }
    o[static_cast<int64_t>(jj) * RV + ql] = acc;
  }
}

}  // namespace

// c: (Lc, R, n, V) complex128 as double2; cmap: (L,) int64 into Lc; x: (L, J)
// float64; out: (L, J, R, V) complex128. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for n beyond kMaxN or a grid beyond 2^31 - 1
// blocks.
extern "C" int fourier_contract_launch(const void* c, const void* cmap, const void* x, void* out,
                                       long long L, int J, long long R, int n, int V,
                                       long long Lc, int offset, double period, void* stream) {
  if (L <= 0 || J <= 0) return static_cast<int>(cudaGetLastError());
  if (n < 1 || n > kMaxN || V < 1 || R < 1 || R * V > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int RV = static_cast<int>(R * V);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // enough blocks to fill the card: a lane's outputs split first into
  // chunks of at least 32 (row, value) outputs, each over all nodes, so that
  // every staged coefficient serves all J nodes; then into chunks of nodes.
  // Shared memory caps both: the phase table takes at most half, the
  // coefficient slab the rest
  const long long target = static_cast<long long>(kBlocksPerSm) * sms;
  const long long per_lane = (target + L - 1) / L;
  long long qc = (RV + 31) / 32;
  if (qc > per_lane) qc = per_lane;
  long long jc = (per_lane + qc - 1) / qc;
  if (jc > J) jc = J;
  int Jc = static_cast<int>((J + jc - 1) / jc);
  if (Jc * n > kSmemEntries / 2) Jc = kSmemEntries / 2 / n;
  const int jchunks = (J + Jc - 1) / Jc;
  int Q = static_cast<int>((RV + qc - 1) / qc);
  if (Q * n > kSmemEntries - Jc * n) Q = (kSmemEntries - Jc * n) / n;
  const int qchunks = (RV + Q - 1) / Q;
  const unsigned long long blocks = static_cast<unsigned long long>(L) * jchunks * qchunks;
  if (blocks > 0x7fffffffULL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n * Q + Jc * n) * sizeof(double2);
  fourier_contract_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(c), static_cast<const int64_t*>(cmap),
      static_cast<const double*>(x), static_cast<double2*>(out), J, RV, n, V, Lc, offset,
      1.0 / period, Jc, jchunks, Q, qchunks);
  return static_cast<int>(cudaGetLastError());
}
