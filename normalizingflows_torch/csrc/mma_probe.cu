// A probe of the tensor core's float32 sum: one
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 a case on operands
// the caller crafts, by the same fragment helper (csrc/mma_frag.cuh) that
// the bf16 policy's K4/K5 (csrc/coupling_mma.cuh) take their products
// from. A test kernel: it replaces no TPU kernel. chip_smoke.py phase 59
// holds its results against the exact sums and reads from them how the
// tensor core aligns, truncates and normalises; tests/mma_emulation.h
// models the sum so, and the CPU tests hold the emulation to the card's
// bits recorded from this probe.
//
// Case i: A (16 × 16, row-major, m by k) at a + 256 i, B (8 × 16, n by k:
// column n's 16 k in a row) at b + 128 i, C and D (16 × 8, row-major) at
// c + 128 i and d + 128 i, bfloat16 bits for A and B; D = A·B + C. One warp
// a CTA walks the cases. Bound by nothing worth stating: a few hundred
// cases.

#include "mma_frag.cuh"

namespace {

__global__ void mma_probe(const unsigned short* __restrict__ a,
                          const unsigned short* __restrict__ b,
                          const float* __restrict__ c, float* __restrict__ d,
                          int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const unsigned short* A = a + 256 * (long long)i;
    const unsigned short* B = b + 128 * (long long)i;
    const float* C = c + 128 * (long long)i;
    float* D = d + 128 * (long long)i;
    // two neighbouring k of a row of A (or of a column of B), the lower k
    // in the low half
    auto pair = [](const unsigned short* p) {
      return (uint32_t)p[0] | ((uint32_t)p[1] << 16);
    };
    float acc[4] = {C[g * 8 + t2], C[g * 8 + t2 + 1], C[(g + 8) * 8 + t2],
                    C[(g + 8) * 8 + t2 + 1]};
    mma16816(acc, pair(A + g * 16 + t2), pair(A + (g + 8) * 16 + t2),
             pair(A + g * 16 + t2 + 8), pair(A + (g + 8) * 16 + t2 + 8),
             pair(B + g * 16 + t2), pair(B + g * 16 + t2 + 8));
    D[g * 8 + t2] = acc[0];
    D[g * 8 + t2 + 1] = acc[1];
    D[(g + 8) * 8 + t2] = acc[2];
    D[(g + 8) * 8 + t2 + 1] = acc[3];
  }
}

}  // namespace

extern "C" {

// n cases (layout above) on the stream; 0 or the launch's CUDA error
int mma_probe_bf16(const void* a, const void* b, const void* c, void* d,
                   int n, void* stream) {
  if (n <= 0) return 0;
  mma_probe<<<n < 1024 ? n : 1024, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(a),
      static_cast<const unsigned short*>(b), static_cast<const float*>(c),
      static_cast<float*>(d), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
