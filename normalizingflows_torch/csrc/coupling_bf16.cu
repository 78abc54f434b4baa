// K4/K5's C entries in bfloat16: the port of the Pallas coupling kernels'
// `compute_dtype` (experimental/coupling_pallas.py:80-90, `_dot(a, b, cd)`
// in `_tile_flow` and `_mlp_bwd`), and bfloat16 parameters.
//
//   *_f32_cbf16  x and weights float32, the bf16 policy: every conditioner
//                product takes bfloat16 operands (W rounded as it is
//                staged; a layer's input and its cotangent once a layer;
//                the weight gradient's two operands at use) and sums in
//                float32: the exact sum rounded once (mma.sync .f64 on
//                the float64 tensor cores) wherever a bfloat16 rounding
//                follows, the weight gradients by mma.sync m16n8k16 on the
//                bfloat16 tensor cores; one warp a tile of 16 rows
//                (csrc/coupling_mma.cuh: they replace the Pallas
//                `_fwd_kernel` and `_bwd_kernel` under the policy);
//                the selections and everything else exact float32, as
//                `_dot(a, b, cd)` leaves them.
//   *_bf16       x, weights, y, ld, gx and the weight gradients stored in
//                bfloat16; the staged weights are widened to float32 as
//                they are copied in, the arithmetic is float32 and each
//                output is rounded once (the partial weight gradients are
//                float32 until the reduce writes them). The Pallas kernel
//                computes a bfloat16 flow in bfloat16.
//
// What bounds them: bfloat16 storage as the float32 kernels
// (csrc/coupling_kernels.cuh), the CUDA cores' float32 rate and, at small
// batches, one row's chain. The policy: the float32 work around the
// products (bias, activation, the roundings, tanh and exp, the fragments'
// gathers) and, at 16 to 256 rows, one tile's chain (csrc/coupling_mma.cuh). Built as a source of its own so
// that nvcc compiles it beside csrc/coupling.cu. The entries' arguments are
// those of csrc/coupling.cu's (for *_bf16 the scratch is float32 words; the
// policy's entries ignore `lanes`: they have one tile).

#include "coupling_mma.cuh"

extern "C" {

int coupling_fwd_f32_cbf16(
    const void* x, void* y, void* ld, long long n, int d, int n_blocks,
    int depth, const int* widths, const int* idx, const void* const* weights,
    int lanes, int inverse, void* stream) {
  (void)lanes;
  return launch_fwd_mma(x, y, ld, n, d, n_blocks, depth, widths, idx,
                        weights, inverse, stream);
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
  return launch_bwd_mma(x, gy, gld, gx, scratch, n, d, n_blocks, depth,
                        widths, idx, weights, grads, n_ctas, inverse, stream);
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

// The policy's plan (csrc/coupling_mma.cuh's layout, which the launches
// take): out[0] the rows a CTA of K4 and K5, out[1] the shared-memory
// bytes of K4 (backward 0) or K5 (1). Returns 0, or cudaErrorInvalidValue
// outside the kernels' bounds.
int coupling_mma_plan(int d, int n_blocks, int depth, const int* widths,
                      int backward, long long* out) {
  return mma_plan(d, n_blocks, depth, widths, backward, out);
}

}  // extern "C"
