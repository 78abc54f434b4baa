// K4/K5's C entries in bfloat16: the port of the Pallas coupling kernels'
// `compute_dtype` (experimental/coupling_pallas.py:80-90, `_dot(a, b, cd)`
// in `_tile_flow` and `_mlp_bwd`), and bfloat16 parameters.
//
//   *_f32_cbf16  x and weights float32, the bf16 policy: each conditioner
//                product rounds its two operands to bfloat16 in registers
//                (h and W forward; the layer input, the cotangent and W
//                backward) and sums in float32 on the CUDA cores; the
//                selections and everything else exact float32, as
//                `_dot(a, b, cd)` leaves them.
//   *_bf16       x, weights, y, ld, gx and the weight gradients stored in
//                bfloat16; the staged weights are widened to float32 as
//                they are copied in, the arithmetic is float32 and each
//                output is rounded once (the partial weight gradients are
//                float32 until the reduce). The Pallas kernel computes a
//                bfloat16 flow in bfloat16.
//
// What bounds them: as the float32 kernels (csrc/coupling_kernels.cuh), the
// CUDA cores' float32 rate and, at small batches, one row's chain; the
// policy adds two conversions a multiply-add operand (no tensor cores in
// this version). Built as a source of its own so that nvcc compiles it
// beside csrc/coupling.cu. The entries' arguments are those of
// csrc/coupling.cu's (for *_bf16 the scratch is float32 words).

#include "coupling_kernels.cuh"

extern "C" {

int coupling_fwd_f32_cbf16(
    const void* x, void* y, void* ld, long long n, int d, int n_blocks,
    int depth, const int* widths, const int* idx, const void* const* weights,
    int lanes, int inverse, void* stream) {
  return launch_fwd<float, Bf16Operands>(x, y, ld, n, d, n_blocks, depth,
                                         widths, idx, weights, lanes,
                                         inverse, stream);
}

int coupling_fwd_bf16(
    const void* x, void* y, void* ld, long long n, int d, int n_blocks,
    int depth, const int* widths, const int* idx, const void* const* weights,
    int lanes, int inverse, void* stream) {
  return launch_fwd<float, Bf16Storage>(x, y, ld, n, d, n_blocks, depth, widths,
                                idx, weights, lanes, inverse, stream);
}

int coupling_bwd_f32_cbf16(
    const void* x, const void* gy, const void* gld, void* gx, void* scratch,
    long long n, int d, int n_blocks, int depth, const int* widths,
    const int* idx, const void* const* weights, void* const* grads,
    int n_ctas, int inverse, void* stream) {
  return launch_bwd<float, Bf16Operands>(x, gy, gld, gx, scratch, n, d,
                                n_blocks, depth, widths, idx, weights,
                                grads, n_ctas, inverse, stream);
}

int coupling_bwd_bf16(
    const void* x, const void* gy, const void* gld, void* gx, void* scratch,
    long long n, int d, int n_blocks, int depth, const int* widths,
    const int* idx, const void* const* weights, void* const* grads,
    int n_ctas, int inverse, void* stream) {
  return launch_bwd<float, Bf16Storage>(x, gy, gld, gx, scratch, n, d,
                                n_blocks, depth, widths, idx, weights,
                                grads, n_ctas, inverse, stream);
}

}  // extern "C"
