// The FP64 tensor-core products (DMMA) shared by K1/K11 (fourier_points.cu),
// K19 (transport_gamma.cu) and K27's sums (sigma_trace.cu).
#pragma once

namespace autobz {

// d += A B on the FP64 tensor cores, m16n8k8. Fragments (groupID g = lane
// / 4, threadID_in_group t = lane % 4): a_i at row g + 8 (i % 2), column t +
// 4 (i / 2); b_i at row t + 4 i, column g; d_i at row g + 8 (i / 2), column
// 2 t + i % 2.
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4], double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// d += A B, m16n8k4: a_0 at row g, column t; a_1 at row g + 8, column t;
// b_0 at row t, column g; d as for m16n8k8.
__device__ __forceinline__ void dmma_k4(double (&d)[4], const double (&a)[2], double b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b0));
}

}  // namespace autobz
