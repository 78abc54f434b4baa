// K6's C entries in float32 and float64. The kernel, its design and what
// bounds it are in csrc/train_kernel.cuh; csrc/train_bf16.cu holds the
// bfloat16 entry.

#include "train_kernel.cuh"

// Plain C interface, bound with ctypes (ops/_build.py). xs is contiguous
// (steps, batch, d): this launch's base draws, one batch a step. w, m, v
// and grad are flat buffers of the stack's weight count, in the leaf order
// of the JAX `groups` pytree (even.s, even.t, odd.s, odd.t, per layer W
// (n_blocks, in, out) then b (n_blocks, out)); widths and idx are as for
// coupling_fwd. losses gets `steps` values. loc and scale are the base's
// (d,). target is 0 (Banana), 1 (Funnel) or 2 (WarpedGauss, d = 2); hyper
// holds lr, b1, b2, eps, then the target's four scalars (train_kernel.cuh's
// Train). step0 is the global index of the launch's first step (Adam's bias
// correction). K6 updates w, m and v in place; grad is scratch. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for shapes or a target outside the instantiated
// bounds.
extern "C" {

int realnvp_train_f32(const void* xs, void* w, void* m, void* v, void* grad,
                      void* losses, const void* loc, const void* scale,
                      int steps, long long step0, long long batch, int d,
                      int n_blocks, int depth, const int* widths,
                      const int* idx, int target, const double* hyper,
                      void* stream) {
  return launch_train<float>(xs, w, m, v, grad, losses, loc, scale, steps,
                             step0, batch, d, n_blocks, depth, widths, idx,
                             target, hyper, stream);
}

int realnvp_train_f64(const void* xs, void* w, void* m, void* v, void* grad,
                      void* losses, const void* loc, const void* scale,
                      int steps, long long step0, long long batch, int d,
                      int n_blocks, int depth, const int* widths,
                      const int* idx, int target, const double* hyper,
                      void* stream) {
  return launch_train<double>(xs, w, m, v, grad, losses, loc, scale, steps,
                              step0, batch, d, n_blocks, depth, widths, idx,
                              target, hyper, stream);
}

}  // extern "C"
