// The warp-level fragment helpers of the bf16 policy's tensor-core kernels
// (csrc/coupling_mma.cuh) and of the tensor core's probe (csrc/mma_probe.cu):
// ldmatrix, the bfloat16 packing, mma.sync.m16n8k16 on bfloat16 and
// mma.sync.m16n8k16 / m16n8k4 on float64, in inline PTX.
// tests/mma_emulation.h writes the same helpers for the host.

#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Fragments. Lane (g, t) = (lane / 4, lane % 4) holds of a 16×16 A fragment
// a[0] = (row g, k 2t..2t+1), a[1] = (row g + 8, the same k), a[2], a[3] the
// same at k + 8; of a 16×8 C fragment c[0..1] = (row g, n 2t..2t+1) and
// c[2..3] = (row g + 8, the same n); of a B fragment b0 = (k 2t..2t+1, n g),
// b1 = (k + 8, n g). A register holds two bfloat16, the lower k (or n) in
// its low half.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_at(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// lo and hi rounded to bfloat16 (to nearest even), packed
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float lo_of(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_of(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// ldmatrix.trans: 8×8 matrices of bfloat16, each row 16 bytes at the
// address one lane gives (lanes 8j..8j+7 matrix j), each lane handed the
// transpose's pair.
__device__ __forceinline__ void ldsm_x2_t(unsigned a, uint32_t& r0,
                                          uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned a, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(a));
}

// c += A·B on the tensor cores: bfloat16 operands, float32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The float64 tensor cores (sm_90): every operand float64. Lane (g, t)
// holds of m16n8k16's A a[i] = (row g + 8(i % 2), k t + 4(i / 2)), of its
// B b[i] = (k t + 4i, n g); of m16n8k4's A a0 = (row g, k t), a1 = (row
// g + 8, k t), of its B b0 = (k t, n g); C as the bfloat16 mma's, c[i] =
// (row g + 8(i / 2), n 2t + i % 2). chip_smoke.py phase 60 measures their
// sums (csrc/mma_probe.cu).
__device__ __forceinline__ void dmma16816(double (&c)[4], const double (&a)[8],
                                          const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
__device__ __forceinline__ void dmma1684(double (&c)[4], double a0,
                                         double a1, double b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

}  // namespace
