// K4/K5's C entries for float32 and float64 (the kernels, and what each
// replaces, in csrc/coupling_kernels.cuh).

#include "coupling_kernels.cuh"

// Plain C interface, bound with ctypes (ops/_build.py). x, y, gy, gx are
// contiguous (n, d) row-major, ld and gld (n,). widths holds 2 × (depth+1)
// ints: per group (even, then odd) the conditioner widths n_B, hidden...,
// n_A. idx holds 2 × d ints: per group its n_A transformed indices, then
// its n_B conditioner indices. weights (and grads) hold 8 × depth device
// pointers in the order of the JAX `groups` pytree: even.s, even.t, odd.s,
// odd.t, per layer W (n_blocks, in, out) then b (n_blocks, out). scratch
// holds n_ctas × (total weight count) words. The launch goes to the calling
// thread's current device, which the wrapper sets to the tensors' device.
// Each entry returns the last launch's cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for shapes outside the instantiated bounds.
extern "C" {

int coupling_fwd_f32(const void* x, void* y, void* ld, long long n, int d,
                     int n_blocks, int depth, const int* widths,
                     const int* idx, const void* const* weights, int lanes,
                     int inverse, void* stream) {
  return launch_fwd<float>(x, y, ld, n, d, n_blocks, depth, widths, idx,
                           weights, lanes, inverse, stream);
}

int coupling_fwd_f64(const void* x, void* y, void* ld, long long n, int d,
                     int n_blocks, int depth, const int* widths,
                     const int* idx, const void* const* weights, int lanes,
                     int inverse, void* stream) {
  return launch_fwd<double>(x, y, ld, n, d, n_blocks, depth, widths, idx,
                            weights, lanes, inverse, stream);
}

int coupling_bwd_f32(const void* x, const void* gy, const void* gld,
                     void* gx, void* scratch, long long n, int d,
                     int n_blocks, int depth, const int* widths,
                     const int* idx, const void* const* weights,
                     void* const* grads, int n_ctas, int inverse,
                     void* stream) {
  return launch_bwd<float>(x, gy, gld, gx, scratch, n, d, n_blocks, depth,
                           widths, idx, weights, grads, n_ctas, inverse,
                           stream);
}

int coupling_bwd_f64(const void* x, const void* gy, const void* gld,
                     void* gx, void* scratch, long long n, int d,
                     int n_blocks, int depth, const int* widths,
                     const int* idx, const void* const* weights,
                     void* const* grads, int n_ctas, int inverse,
                     void* stream) {
  return launch_bwd<double>(x, gy, gld, gx, scratch, n, d, n_blocks, depth,
                            widths, idx, weights, grads, n_ctas, inverse,
                            stream);
}

}  // extern "C"
