// K6's C entry on bfloat16 parameters: the port of `_train_kernel`
// (normalizingflows/jl_tpu/experimental/train_pallas.py) for a bfloat16
// flow, K6 on coupling_device.cuh's Bf16Storage policy.
//
//   realnvp_train_bf16  xs, the weights, the base's loc and scale, Adam's
//                       m and v and the losses stored in bfloat16 (the JAX
//                       kernel's dtypes), each rounded once a step; the
//                       arithmetic, the gradient buffer (grad: float32
//                       words) and Adam's bias corrections float32; the
//                       same cluster of CTAs as the float32 kernel.
//   realnvp_train_plan_bf16  its plan.
//
// What bounds it: as the float32 kernel (csrc/train_kernel.cuh), the
// longest CTA's chain of tiles and the lane_stage() round trips, plus a
// conversion a word read or written. Built as a source of its own so that
// nvcc compiles it beside csrc/train.cu. The arguments are those of
// csrc/train.cu's entries.

#include "train_kernel.cuh"

extern "C" {

int realnvp_train_bf16(const void* xs, void* w, void* m, void* v, void* grad,
                       long long scratch, void* losses, const void* loc,
                       const void* scale, int steps, long long step0,
                       long long batch, int d, int n_blocks, int depth,
                       const int* widths, const int* idx, int target,
                       const double* hyper, void* stream) {
  return launch_train<float, Bf16Storage>(
      xs, w, m, v, grad, scratch, losses, loc, scale, steps, step0, batch, d,
      n_blocks, depth, widths, idx, target, hyper, stream);
}

int realnvp_train_plan_bf16(int d, int n_blocks, int depth, const int* widths,
                            const int* idx, long long batch, long long* out) {
  return plan_train<float, Bf16Storage>(d, n_blocks, depth, widths, idx,
                                        batch, out);
}

}  // extern "C"
