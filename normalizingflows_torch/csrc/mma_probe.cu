// Probes of the tensor cores' sums: one
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 a case
// (`mma_probe_bf16`), or one m16n8k16 .f64 (or four m16n8k4 .f64 in k
// order) a case (`mma_probe_f64`), on operands the caller crafts, by the
// same fragment helpers (csrc/mma_frag.cuh) that the bf16 policy's K4/K5
// (csrc/coupling_mma.cuh) take their products from. Test kernels: they
// replace no TPU kernel. chip_smoke.py phases 59 and 60 hold their results
// against the exact sums and read from them how each tensor core rounds;
// tests/mma_emulation.h models the sums so, and the CPU tests hold the
// emulation to the card's bits recorded from these probes.
//
// Case i: A (16 × 16, row-major, m by k) at a + 256 i, B (8 × 16, n by k:
// column n's 16 k in a row) at b + 128 i, C and D (16 × 8, row-major) at
// c + 128 i and d + 128 i; bfloat16 bits for A and B and float32 C and D,
// or float64 throughout; D = A·B + C. One warp a CTA walks the cases.
// Bound by nothing worth stating: a few hundred cases.

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

// The float64 probe: m16n8k16 (k16) or four m16n8k4 in k order, each
// taking the last one's D as its C
__global__ void mma_probe_d(const double* __restrict__ a,
                            const double* __restrict__ b,
                            const double* __restrict__ c,
                            double* __restrict__ d, int n, bool k16) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const double* A = a + 256 * (long long)i;
    const double* B = b + 128 * (long long)i;
    const double* C = c + 128 * (long long)i;
    double* D = d + 128 * (long long)i;
    double acc[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1],
                     C[(g + 8) * 8 + 2 * t], C[(g + 8) * 8 + 2 * t + 1]};
    if (k16) {
      double fa[8], fb[4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        fa[j] = A[(g + 8 * (j & 1)) * 16 + t + 4 * (j >> 1)];
#pragma unroll
      for (int j = 0; j < 4; ++j) fb[j] = B[g * 16 + t + 4 * j];
      dmma16816(acc, fa, fb);
    } else {
#pragma unroll
      for (int k0 = 0; k0 < 16; k0 += 4)
        dmma1684(acc, A[g * 16 + k0 + t], A[(g + 8) * 16 + k0 + t],
                 B[g * 16 + k0 + t]);
    }
    D[g * 8 + 2 * t] = acc[0];
    D[g * 8 + 2 * t + 1] = acc[1];
    D[(g + 8) * 8 + 2 * t] = acc[2];
    D[(g + 8) * 8 + 2 * t + 1] = acc[3];
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

// n float64 cases (layout above) by m16n8k16 (k16 1) or four m16n8k4
// (k16 0); 0 or the launch's CUDA error
int mma_probe_f64(const void* a, const void* b, const void* c, void* d,
                  int n, int k16, void* stream) {
  if (n <= 0) return 0;
  mma_probe_d<<<n < 1024 ? n : 1024, 32, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(b),
      static_cast<const double*>(c), static_cast<double*>(d), n, k16 != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
