// K22 and K23: the link overlaps of the Berry family, in FP64.
//
// K22, plaquette_flux, replaces autobzcore_tpu/models/berry.py:298-336
// (_lattice_chern_fn): for the occupied-band frames V (n1, n2, m, nb) of a
// periodic 2-D grid, the Fukui-Hatsuda-Suzuki field
//
//   L_j(k) = det(V(k)^H V(k + e_j)) / |det(...)|,
//   F(k)   = -arg(L_1(k) L_2(k + e_1) conj(L_1(k + e_2)) conj(L_2(k))),
//
// summed over the n1 n2 plaquettes (a scalar; the Chern number is the sum
// over 2 pi). The sum is gauge-invariant, so frames from the closed-form
// eigh2 and from LAPACK's eigh (the reference's jnp.linalg.eigh at
// berry.py:314) give the same field up to rounding.
//
// K23, wilson_loops, replaces berry.py:368-385 (wilson_loop_spectrum's
// loops): for each k2 row y the ordered product over k1 of the link
// matrices, W(y) = prod_{x = 0}^{n1 - 1} V(x, y)^H V(x + 1, y) (nb x nb),
// the reference's lax.scan of W <- W L. The links are formed on the fly,
// never stored as the reference's (n1, n2, nb, nb) L. The (n2, nb, nb)
// result goes to the host's eigvals.
//
// What bounds them on an H100: nothing but the launch at the example's npt
// of 24 (576 plaquettes); at npt = 1024, K22 reads V once (32 MB at m = 2,
// nb = 1: 0.010 ms at 3.35 TB/s) against 4 links of nb^2 m complex
// multiply-adds, a determinant and an atan2 a plaquette (~200 FP64
// operations at nb = 1: 0.006 ms at 34 TFLOP/s), so the bytes bound it.
//
// The design: K22 runs one thread per plaquette. It forms its four nb x nb
// overlaps in registers, takes each determinant (closed form for nb <= 2,
// pivoted elimination up to kMaxNb = 8), normalises, multiplies the loop in
// the reference's order and takes the angle. Each block of 256 threads sums
// a chunk of 1,024 plaquettes (a fixed tree in shared memory) into one
// partial; a second pass of one block adds the partials in chunk order. No
// atomics, so repeats are bit-identical. K23 runs one warp per k2 row: the
// lanes form the nb^2 entries of each link and of the product in shared
// memory, in a fixed order along k1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxNb = 8;  // the most occupied bands (models/berry.py MAX_LINK_BANDS)
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;  // plaquettes per partial
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double2 conjd(double2 a) { return make_double2(a.x, -a.y); }

// (Vp^H Vq)[r, s] = sum_i conj(Vp[i, r]) Vq[i, s] for frames (m, nb), row major.
__device__ __forceinline__ double2 overlap(const double2* __restrict__ Vp, const double2* __restrict__ Vq, int m,
                                           int nb, int r, int s) {
  double x = 0.0, y = 0.0;
  for (int i = 0; i < m; ++i) {
    const double2 a = __ldg(Vp + i * nb + r), b = __ldg(Vq + i * nb + s);
    x += a.x * b.x + a.y * b.y;
    y += a.x * b.y - a.y * b.x;
  }
  return make_double2(x, y);
}

// det(Vp^H Vq) / |det|: closed forms for nb <= 2, else Gaussian elimination
// with partial pivoting (by |.|^2) in local memory.
__device__ double2 link(const double2* __restrict__ Vp, const double2* __restrict__ Vq, int m, int nb) {
  double2 det;
  if (nb == 1) {
    det = overlap(Vp, Vq, m, 1, 0, 0);
  } else if (nb == 2) {
    const double2 a = overlap(Vp, Vq, m, 2, 0, 0), b = overlap(Vp, Vq, m, 2, 0, 1);
    const double2 c = overlap(Vp, Vq, m, 2, 1, 0), e = overlap(Vp, Vq, m, 2, 1, 1);
    const double2 ae = cmul(a, e), bc = cmul(b, c);
    det = make_double2(ae.x - bc.x, ae.y - bc.y);
  } else {
    double2 M[kMaxNb * kMaxNb];
    for (int r = 0; r < nb; ++r)
      for (int s = 0; s < nb; ++s) M[r * nb + s] = overlap(Vp, Vq, m, nb, r, s);
    det = make_double2(1.0, 0.0);
    for (int c = 0; c < nb; ++c) {
      int piv = c;
      double best = M[c * nb + c].x * M[c * nb + c].x + M[c * nb + c].y * M[c * nb + c].y;
      for (int r = c + 1; r < nb; ++r) {
        const double v = M[r * nb + c].x * M[r * nb + c].x + M[r * nb + c].y * M[r * nb + c].y;
        if (v > best) {
          best = v;
          piv = r;
        }
      }
      if (piv != c) {
        for (int s = 0; s < nb; ++s) {
          const double2 t = M[c * nb + s];
          M[c * nb + s] = M[piv * nb + s];
          M[piv * nb + s] = t;
        }
        det = make_double2(-det.x, -det.y);
      }
      const double2 p = M[c * nb + c];
      det = cmul(det, p);
      if (best == 0.0) break;  // singular: det = 0
      const double pd = best;  // 1/p = conj(p) / |p|^2
      for (int r = c + 1; r < nb; ++r) {
        const double2 f0 = cmul(M[r * nb + c], conjd(p));
        const double2 f = make_double2(f0.x / pd, f0.y / pd);
        for (int s = c + 1; s < nb; ++s) {
          const double2 t = cmul(f, M[c * nb + s]);
          M[r * nb + s].x -= t.x;
          M[r * nb + s].y -= t.y;
        }
      }
    }
  }
  const double a = hypot(det.x, det.y);
  return make_double2(det.x / a, det.y / a);
}

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
plaquette_flux_partial(const double2* __restrict__ V, int n1, int n2, int m, int nb, double* __restrict__ partials) {
  __shared__ double sh[kThreads];
  const int64_t n = static_cast<int64_t>(n1) * n2;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t fs = static_cast<int64_t>(m) * nb;  // entries per frame
  double s = 0.0;
#pragma unroll 1
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t t = t0 + j * kThreads + threadIdx.x;
    if (t < n) {
      const int x = static_cast<int>(t / n2), y = static_cast<int>(t - (t / n2) * n2);
      const int x1 = x + 1 == n1 ? 0 : x + 1, y1 = y + 1 == n2 ? 0 : y + 1;
      const double2* v00 = V + (static_cast<int64_t>(x) * n2 + y) * fs;
      const double2* v10 = V + (static_cast<int64_t>(x1) * n2 + y) * fs;
      const double2* v01 = V + (static_cast<int64_t>(x) * n2 + y1) * fs;
      const double2* v11 = V + (static_cast<int64_t>(x1) * n2 + y1) * fs;
      double2 p = cmul(link(v00, v10, m, nb), link(v10, v11, m, nb));  // L1(k) L2(k + e1)
      p = cmul(p, conjd(link(v01, v11, m, nb)));                       // conj(L1(k + e2))
      p = cmul(p, conjd(link(v00, v01, m, nb)));                       // conj(L2(k))
      s += -atan2(p.y, p.x);
    }
  }
  const double tot = block_sum(s, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(kThreads)
plaquette_flux_reduce(const double* __restrict__ partials, int64_t nparts, double* __restrict__ out) {
  __shared__ double sh[kThreads];
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < nparts; i += kThreads) s += partials[i];
  const double tot = block_sum(s, sh);
  if (threadIdx.x == 0) out[0] = tot;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
wilson_loops_kernel(const double2* __restrict__ V, int n1, int n2, int m, int nb, double2* __restrict__ out) {
  __shared__ double2 sw[kWarpsPerBlock][3][kMaxNb * kMaxNb];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int y = blockIdx.x * kWarpsPerBlock + warp;
  if (y >= n2) return;
  double2* W = sw[warp][0];
  double2* L = sw[warp][1];
  double2* Wn = sw[warp][2];
  const int nbb = nb * nb;
  const int64_t fs = static_cast<int64_t>(m) * nb;
  for (int e = lane; e < nbb; e += 32) W[e] = make_double2(e / nb == e % nb ? 1.0 : 0.0, 0.0);
  __syncwarp();
  for (int x = 0; x < n1; ++x) {
    const int x1 = x + 1 == n1 ? 0 : x + 1;
    const double2* vp = V + (static_cast<int64_t>(x) * n2 + y) * fs;
    const double2* vq = V + (static_cast<int64_t>(x1) * n2 + y) * fs;
    for (int e = lane; e < nbb; e += 32) L[e] = overlap(vp, vq, m, nb, e / nb, e % nb);
    __syncwarp();
    for (int e = lane; e < nbb; e += 32) {
      const int r = e / nb, s = e % nb;
      double2 acc = make_double2(0.0, 0.0);
      for (int p = 0; p < nb; ++p) {
        const double2 t = cmul(W[r * nb + p], L[p * nb + s]);
        acc.x += t.x;
        acc.y += t.y;
      }
      Wn[e] = acc;
    }
    __syncwarp();
    for (int e = lane; e < nbb; e += 32) W[e] = Wn[e];
    __syncwarp();
  }
  for (int e = lane; e < nbb; e += 32) out[static_cast<int64_t>(y) * nbb + e] = W[e];
}

}  // namespace

// Rows of K22's partials scratch for an n1 x n2 grid.
extern "C" long long plaquette_flux_num_chunks(long long n1, long long n2) {
  return (n1 * n2 + kChunk - 1) / kChunk;
}

// V: (n1, n2, m, nb) complex128, contiguous; partials:
// (plaquette_flux_num_chunks(n1, n2),) float64 scratch; out: (1,) float64,
// written (the sum of the plaquette field). Returns cudaErrorInvalidValue
// for a shape it does not take, else cudaGetLastError() after each launch.
extern "C" int plaquette_flux_launch(const void* V, int n1, int n2, int m, int nb, void* partials, void* out,
                                     void* stream) {
  if (n1 < 1 || n2 < 1 || m < 1 || nb < 1 || nb > kMaxNb || nb > m) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nparts = plaquette_flux_num_chunks(n1, n2);
  if (nparts > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  plaquette_flux_partial<<<static_cast<unsigned>(nparts), kThreads, 0, st>>>(
      static_cast<const double2*>(V), n1, n2, m, nb, static_cast<double*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plaquette_flux_reduce<<<1, kThreads, 0, st>>>(static_cast<const double*>(partials), nparts,
                                                static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// V: (n1, n2, m, nb) complex128, contiguous; out: (n2, nb, nb) complex128,
// written. Returns cudaErrorInvalidValue for a shape it does not take, else
// cudaGetLastError() after the launch.
extern "C" int wilson_loops_launch(const void* V, int n1, int n2, int m, int nb, void* out, void* stream) {
  if (n1 < 1 || n2 < 1 || m < 1 || nb < 1 || nb > kMaxNb || nb > m) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n2 + kWarpsPerBlock - 1) / kWarpsPerBlock);
  wilson_loops_kernel<<<blocks, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(V), n1, n2, m, nb, static_cast<double2*>(out));
  return static_cast<int>(cudaGetLastError());
}
