// Native symmetry reduction of PTR grids.
//
// C++ implementation of the orbit-canonicalization inner loop of
// ops/symptr.py::symptr_rule (the reference's AutoSymPTR.symptr_rule role,
// observed at src/fourier.jl:271): for every point of an npt^d grid, find the
// minimal linear index in its orbit under a set of integer symmetry matrices.
// This is the dominant host-side cost when building large symmetrized rules
// (npt=200, d=3, 48 ops => ~400M index-map operations); OpenMP-parallel here.
//
// Built on demand by native/build.py; ops/symptr.py falls back to numpy when
// the shared library is unavailable.

#include <cstdint>

extern "C" {

// syms: (nsyms, d, d) row-major int64, acting on grid index vectors mod npt.
// best: (npt^d,) int64 output: canonical (minimal) linear orbit index.
void symptr_canonicalize(int64_t npt, int64_t d, int64_t nsyms,
                         const int64_t *syms, int64_t *best) {
  int64_t total = 1;
  for (int64_t j = 0; j < d; ++j) total *= npt;

  // strides for C-order linearization: stride[j] = npt^(d-1-j)
  int64_t strides[8];
  strides[d - 1] = 1;
  for (int64_t j = d - 2; j >= 0; --j) strides[j] = strides[j + 1] * npt;

#pragma omp parallel for schedule(static)
  for (int64_t lin = 0; lin < total; ++lin) {
    int64_t idx[8];
    int64_t rem = lin;
    for (int64_t j = 0; j < d; ++j) {
      idx[j] = rem / strides[j];
      rem -= idx[j] * strides[j];
    }
    int64_t mn = lin;
    for (int64_t s = 0; s < nsyms; ++s) {
      const int64_t *S = syms + s * d * d;
      int64_t mapped = 0;
      for (int64_t r = 0; r < d; ++r) {
        int64_t acc = 0;
        for (int64_t c = 0; c < d; ++c) acc += S[r * d + c] * idx[c];
        acc %= npt;
        if (acc < 0) acc += npt;
        mapped += acc * strides[r];
      }
      if (mapped < mn) mn = mapped;
    }
    best[lin] = mn;
  }
}

}  // extern "C"
