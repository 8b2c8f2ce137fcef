// K24: the occupation-weighted zone average of the Berry family, in FP64.
//
// Replaces autobzcore_tpu/models/berry.py:462-470 (_cart_average's
// jnp.mean of einsum("km,kmab->kab", w, F)) with the band weights of
// :487-490 (ahc), :505-507 (anomalous_nernst), :521-525
// (berry_curvature_dipole, a (d, d, d) result), :606-610 (operator_hall)
// and :627-634 (orbital_magnetization), and chern()'s per-band mean at
// :478. For energies e (K, m) and a field F (K, m, C) it writes the zone
// mean
//
//   X[j] = (1 / K) sum_k sum_n w(e[k, n]) F[k, n, j]            (C columns),
//   X[a, j] = (1 / K) sum_k sum_n w(e[k, n]) vd[k, n, a] F[k, n, j]
//                                                 (dipole, d C columns),
//   X[n, j] = (1 / K) sum_k F[k, n, j]                     (per band, m C),
//
// with x = beta (e - mu) and the weight w a mode: 0 the step (e < mu); 1
// the Fermi function 1 / (1 + e^x); 2 the entropy softplus(x) - x
// sigmoid(x), softplus(x) = max(x, 0) + log1p(e^-|x|) (the reference's
// logaddexp(x, 0), exact at every x); 3 -df/de = beta f (1 - f), times
// vd_a; 4 the grand potential softplus(-x) / beta, or max(mu - e, 0) at
// beta = inf; 5 one, per band. The B^-T X B^-1 and |det B| / (2 pi)^d tail
// stays on the host in float64, as in the reference.
//
// What bounds it on an H100: the bytes. The Weyl 3-D AHC reads e and Om at
// 7,077,888 points (16 + 144 B a point, 1.13 GB: 0.34 ms at 3.35 TB/s)
// against a weight (~40 FP64 operations at most) and 2 per term.
//
// The design, for the bytes:
//  * a block streams contiguous chunks of kc points of e, F (and vd) into
//    shared memory with Hopper's bulk asynchronous copy (cp.async.bulk, the
//    TMA's 1-D form, completing on an mbarrier), kStages chunks in flight,
//    so each load moves whole rows and no thread waits on a scattered load;
//    a chunk that is not 16-byte aligned (a base pointer or the ragged last
//    chunk) is copied by the threads instead;
//  * each weight is computed once per (k, n) into shared memory, and the
//    columns accumulate from there: thread (lane l, column j) sums points
//    l, l + L, ... of each chunk in order, over the bands;
//  * a fixed-order two-pass sum: a block takes the chunks blockIdx.x,
//    blockIdx.x + gridDim.x, ... (a grid of the blocks the card holds at
//    once) and adds its L lanes of each column in lane order into its
//    partial row; a second pass, one block per column, adds the partial
//    rows in a fixed tree. No atomics, so repeats are bit-identical.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;            // chunks in flight per block
constexpr int kStageBytes = 14336;    // a chunk of e, F (and vd) fits this, at least 2 points

enum Mode { kStep = 0, kFermi = 1, kEntropy = 2, kDipole = 3, kGrand = 4, kBand = 5 };

__device__ __forceinline__ double softplus(double x) { return fmax(x, 0.0) + log1p(exp(-fabs(x))); }

__device__ __forceinline__ double weight(int mode, double e, double mu, double beta) {
  switch (mode) {
    case kStep:
      return e < mu ? 1.0 : 0.0;
    case kFermi:
      return 1.0 / (1.0 + exp(beta * (e - mu)));
    case kEntropy: {
      const double x = beta * (e - mu);
      return softplus(x) - x * (1.0 / (1.0 + exp(-x)));
    }
    case kDipole: {
      const double f = 1.0 / (1.0 + exp(beta * (e - mu)));
      return beta * f * (1.0 - f);
    }
    case kGrand:
      return isinf(beta) ? fmax(mu - e, 0.0) : softplus(-(beta * (e - mu))) / beta;
    default:
      return 1.0;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(1));
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// one bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

struct Chunk {
  int64_t k0;
  int kr;  // points in the chunk
};

// The stage layout: e (kc m), F (kc m C), vd (kc m d, dipole only).
struct Layout {
  int kc, m, C, dv;  // dv: d in the dipole mode, else 0
  __device__ __forceinline__ int e_off() const { return 0; }
  __device__ __forceinline__ int f_off() const { return kc * m; }
  __device__ __forceinline__ int v_off() const { return kc * m * (1 + C); }
  __host__ __device__ int doubles() const { return kc * m * (1 + C + dv); }
};

// Whether a chunk of kr points moves by bulk copies: 16-byte aligned bases
// (`aligned`) and every piece a multiple of 16 bytes, which an even kr m
// gives (kc is even, so only the ragged last chunk can fail that).
__device__ __forceinline__ bool bulk(int aligned, int kr, int m) { return aligned && (kr * m) % 2 == 0; }

__device__ __forceinline__ void fetch(double* st, uint64_t* bar, const double* e, const double* F,
                                      const double* vd, const Layout& lay, Chunk ch) {
  const unsigned be = ch.kr * lay.m * 8, bf = be * lay.C, bv = be * lay.dv;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  bar_expect(bar, be + bf + bv);
  bulk_load(st + lay.e_off(), e + ch.k0 * lay.m, be, bar);
  bulk_load(st + lay.f_off(), F + ch.k0 * lay.m * lay.C, bf, bar);
  if (bv) bulk_load(st + lay.v_off(), vd + ch.k0 * lay.m * lay.dv, bv, bar);
}

// Columns J of the result; a tile of jt of them per block (blockIdx.y).
__global__ void __launch_bounds__(kThreads)
zone_average_partial(const double* __restrict__ e, const double* __restrict__ F, const double* __restrict__ vd,
                     int64_t K, int m, int C, int d, int J, int jt, int mode, double mu, double beta, int kc,
                     int aligned, double* __restrict__ partials) {
  extern __shared__ __align__(16) double smem[];
  __shared__ uint64_t bars[kStages];
  __shared__ double sh[kThreads];
  const Layout lay{kc, m, C, mode == kDipole ? d : 0};
  const int sd = lay.doubles();
  double* ws = smem + kStages * sd;  // the chunk's weights (kc m)
  const int64_t nchunks = (K + kc - 1) / kc;
  const int L = kThreads / jt;  // point lanes
  const int lane = threadIdx.x / jt, jc = threadIdx.x - (threadIdx.x / jt) * jt;
  const int j = blockIdx.y * jt + jc;
  const bool live = lane < L && j < J;
  const int a = mode == kDipole ? j / C : 0;
  const int c = mode == kBand ? j % C : (mode == kDipole ? j - a * C : j);
  const int nb = mode == kBand ? j / C : 0;
  auto chunk = [&](int64_t q) {
    const int64_t k0 = q * kc;
    return Chunk{k0, static_cast<int>(K - k0 < kc ? K - k0 : kc)};
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kStages; ++s) {
      const int64_t q = blockIdx.x + static_cast<int64_t>(s) * gridDim.x;
      if (q < nchunks && bulk(aligned, chunk(q).kr, m))
        fetch(smem + s * sd, &bars[s], e, F, vd, lay, chunk(q));
    }
  }
  __syncthreads();
  unsigned parity = 0;  // bit s: the phase stage s waits for next
  double acc = 0.0;
  int s = 0;
  for (int64_t q = blockIdx.x; q < nchunks; q += gridDim.x) {
    const Chunk ch = chunk(q);
    double* st = smem + s * sd;
    const double* es = st + lay.e_off();
    const double* fs = st + lay.f_off();
    const double* vs = st + lay.v_off();
    if (bulk(aligned, ch.kr, m)) {
      bar_wait(&bars[s], (parity >> s) & 1u);
      parity ^= 1u << s;
    } else {
      for (int i = threadIdx.x; i < ch.kr * m; i += kThreads) st[lay.e_off() + i] = e[ch.k0 * m + i];
      for (int i = threadIdx.x; i < ch.kr * m * C; i += kThreads) st[lay.f_off() + i] = F[ch.k0 * m * C + i];
      for (int i = threadIdx.x; i < ch.kr * m * lay.dv; i += kThreads)
        st[lay.v_off() + i] = vd[ch.k0 * m * lay.dv + i];
      __syncthreads();
    }
    if (mode != kBand) {
      for (int i = threadIdx.x; i < ch.kr * m; i += kThreads) ws[i] = weight(mode, es[i], mu, beta);
      __syncthreads();
    }
    if (live) {
      if (mode == kBand) {
        for (int k = lane; k < ch.kr; k += L) acc += fs[(k * m + nb) * C + c];
      } else {
        for (int k = lane; k < ch.kr; k += L) {
          for (int n = 0; n < m; ++n) {
            double w = ws[k * m + n];
            if (mode == kDipole) w *= vs[(k * m + n) * d + a];
            acc += w * fs[(k * m + n) * C + c];
          }
        }
      }
    }
    __syncthreads();  // stage s and the weights are free again
    const int64_t next = q + static_cast<int64_t>(kStages) * gridDim.x;
    if (threadIdx.x == 0 && next < nchunks && bulk(aligned, chunk(next).kr, m))
      fetch(st, &bars[s], e, F, vd, lay, chunk(next));
    s = s + 1 == kStages ? 0 : s + 1;
  }
  sh[threadIdx.x] = live ? acc : 0.0;
  __syncthreads();
  if (threadIdx.x < jt && j < J) {
    double t = 0.0;
    for (int l = 0; l < L; ++l) t += sh[l * jt + jc];
    partials[static_cast<int64_t>(blockIdx.x) * J + j] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
zone_average_reduce(const double* __restrict__ partials, int64_t nparts, int J, double nk, double* __restrict__ out) {
  __shared__ double sh[kThreads];
  const int j = blockIdx.x;
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < nparts; i += kThreads) s += partials[i * J + j];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int t = kThreads / 2; t > 0; t >>= 1) {
    if (threadIdx.x < t) sh[threadIdx.x] += sh[threadIdx.x + t];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = sh[0] / nk;  // the mean, as jnp.mean divides
}

int columns(int mode, int m, int C, int d) { return mode == kBand ? m * C : (mode == kDipole ? d * C : C); }

// Points per chunk: the most (even) that fit kStageBytes, at least 2.
int chunk_points(int m, int C, int d, int mode) {
  const int per_point = m * (1 + C + (mode == kDipole ? d : 0)) * 8;
  const int kc = (kStageBytes / per_point) & ~1;
  return kc < 2 ? 2 : kc;
}

size_t smem_bytes(int m, int C, int d, int mode) {
  const int kc = chunk_points(m, C, d, mode);
  const Layout lay{kc, m, C, mode == kDipole ? d : 0};
  return (static_cast<size_t>(kStages) * lay.doubles() + static_cast<size_t>(kc) * m) * sizeof(double);
}

// Blocks of zone_average_partial that card `dev` holds at once with `smem`
// bytes of dynamic shared memory. The card is asked once per device and
// size; the first ask on a device also lets the kernel take all the shared
// memory a block may opt into, so no later launch needs the attribute set.
// -1 where the card refuses.
long long resident_blocks(int dev, size_t smem) {
  struct Seen {
    int dev;
    size_t smem;
    long long blocks;
  };
  static std::mutex lock;
  static std::vector<Seen> seen;
  const std::lock_guard<std::mutex> guard(lock);
  for (const Seen& x : seen)
    if (x.dev == dev && x.smem == smem) return x.blocks;
  int cur = 0, sms = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes attr{};
  long long blocks = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || (cur != dev && cudaSetDevice(dev) != cudaSuccess)) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) == cudaSuccess &&
      cudaFuncGetAttributes(&attr, zone_average_partial) == cudaSuccess &&
      cudaFuncSetAttribute(zone_average_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - static_cast<int>(attr.sharedSizeBytes)) == cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, zone_average_partial, kThreads, smem) == cudaSuccess &&
      per_sm > 0)
    blocks = static_cast<long long>(sms) * per_sm;
  if (cur != dev) cudaSetDevice(cur);
  if (blocks > 0) seen.push_back({dev, smem, blocks});
  return blocks;
}

}  // namespace

// Rows of the partials scratch for K points in a mode on card `dev` (each
// row holds every column): one per block of a grid the card holds at once,
// at most one per chunk; -1 where the card refuses the kernel's shared
// memory.
extern "C" long long zone_average_num_rows(long long K, int m, int C, int d, int mode, int dev) {
  if (K < 1 || m < 1 || C < 1) return -1;
  const long long kc = chunk_points(m, C, d, mode);
  const long long nchunks = (K + kc - 1) / kc;
  const long long grid = resident_blocks(dev, smem_bytes(m, C, d, mode));
  if (grid < 1) return -1;
  return nchunks < grid ? nchunks : grid;
}

// e: (K, m) float64; F: (K, m, C) float64; vd: (K, m, d) float64 in the
// dipole mode (else unread; d is then unread too), on the current card;
// partials: (rows, J) float64 scratch, rows from zone_average_num_rows(K,
// m, C, d, mode, the card), J the result's columns; out: (J,) float64,
// written: (C,), (d, C) in the dipole mode, (m, C) per band. beta = inf
// takes the grand potential's zero-temperature form. Returns cudaErrorInvalidValue for a mode or shape
// it does not take, else cudaGetLastError() after each launch.
extern "C" int zone_average_launch(const void* e, const void* F, const void* vd, long long K, int m, int C, int d,
                                   int mode, double mu, double beta, long long rows, void* partials, void* out,
                                   void* stream) {
  if (mode < kStep || mode > kBand || K < 1 || m < 1 || C < 1 || (mode == kDipole && (d < 1 || vd == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int J = columns(mode, m, C, d);
  const int jt = J < kThreads ? J : kThreads;
  const int kc = chunk_points(m, C, d, mode);
  if (rows < 1 || rows > (K + kc - 1) / kc || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const int aligned = a16(e) && a16(F) && (mode != kDipole || a16(vd));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>((J + jt - 1) / jt));
  zone_average_partial<<<grid, kThreads, smem_bytes(m, C, d, mode), st>>>(
      static_cast<const double*>(e), static_cast<const double*>(F), static_cast<const double*>(vd),
      static_cast<int64_t>(K), m, C, d, J, jt, mode, mu, beta, kc, aligned, static_cast<double*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  zone_average_reduce<<<static_cast<unsigned>(J), kThreads, 0, st>>>(static_cast<const double*>(partials), rows, J,
                                                                     static_cast<double>(K),
                                                                     static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
