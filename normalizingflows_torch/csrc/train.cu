// K6's C entries in float32 and float64. The kernel, its design and what
// bounds it are in csrc/train_kernel.cuh; csrc/train_bf16.cu holds the
// bfloat16 entry.

#include "train_kernel.cuh"

// Plain C interface, bound with ctypes (ops/_build.py). xs is contiguous
// (steps, batch, d): this launch's base draws, one batch a step. w, m, v
// and grad are flat buffers of the stack's weight count, in the leaf order
// of the JAX `groups` pytree (even.s, even.t, odd.s, odd.t, per layer W
// (n_blocks, in, out) then b (n_blocks, out)); widths and idx are as for
// coupling_fwd. grad is scratch of `scratch` words of the arithmetic's
// type, at least the plan's (realnvp_train_plan_*); the plan's last word
// gets the size of the cluster the launch ran in. losses gets `steps`
// values. loc and scale are the base's (d,). target is 0 (Banana), 1
// (Funnel) or 2 (WarpedGauss, d = 2); hyper holds lr, b1, b2, eps, then the
// target's four scalars (train_kernel.cuh's Train). step0 is the global
// index of the launch's first step (Adam's bias correction). K6 updates w,
// m and v in place. Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for shapes, a target or a scratch
// outside what the kernel takes, or cudaErrorLaunchOutOfResources where no
// cluster of the plan's CTAs fits on the card.
//
// realnvp_train_plan_<sfx>(d, n_blocks, depth, widths, idx, batch, out):
// K6's plan for that stack and batch (train_kernel.cuh's train_plan):
// out[0] the CTAs of the cluster, out[1] the row tiles a CTA holds at
// most, out[2] the scratch words, out[3] the dynamic shared-memory bytes
// a CTA, out[4] the clusters of that shape the current card holds at once.
extern "C" {

int realnvp_train_f32(const void* xs, void* w, void* m, void* v, void* grad,
                      long long scratch, void* losses, const void* loc,
                      const void* scale, int steps, long long step0,
                      long long batch, int d, int n_blocks, int depth,
                      const int* widths, const int* idx, int target,
                      const double* hyper, void* stream) {
  return launch_train<float>(xs, w, m, v, grad, scratch, losses, loc, scale,
                             steps, step0, batch, d, n_blocks, depth, widths,
                             idx, target, hyper, stream);
}

int realnvp_train_f64(const void* xs, void* w, void* m, void* v, void* grad,
                      long long scratch, void* losses, const void* loc,
                      const void* scale, int steps, long long step0,
                      long long batch, int d, int n_blocks, int depth,
                      const int* widths, const int* idx, int target,
                      const double* hyper, void* stream) {
  return launch_train<double>(xs, w, m, v, grad, scratch, losses, loc, scale,
                              steps, step0, batch, d, n_blocks, depth, widths,
                              idx, target, hyper, stream);
}

int realnvp_train_plan_f32(int d, int n_blocks, int depth, const int* widths,
                           const int* idx, long long batch, long long* out) {
  return plan_train<float>(d, n_blocks, depth, widths, idx, batch, out);
}

int realnvp_train_plan_f64(int d, int n_blocks, int depth, const int* widths,
                           const int* idx, long long batch, long long* out) {
  return plan_train<double>(d, n_blocks, depth, widths, idx, batch, out);
}

}  // extern "C"
