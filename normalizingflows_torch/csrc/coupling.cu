// Fused RealNVP coupling-stack kernels for Hopper (sm_90a).
//
// What each entry replaces (normalizingflows/jl_tpu/experimental/
// coupling_pallas.py):
//   K4  coupling_fwd<T, INVERSE>   `_fwd_kernel` (`_tile_flow`), launched by
//                                  `_call_fwd`: the whole stack of affine
//                                  couplings, forward or inverse, with the
//                                  running log-det, in one launch.
//   K5  coupling_bwd<T, INVERSE>   `_bwd_kernel`, launched by `_call_bwd`:
//       + coupling_bwd_reduce<T>   the hand-written backward. It recomputes
//                                  the forward keeping each coupling's input,
//                                  then per coupling (last first) rebuilds
//                                  that coupling's MLP caches
//                                  (`_coupling_fwd_cache`), runs
//                                  `_coupling_bwd` and `_mlp_bwd`, and sums
//                                  the weight gradients over the batch.
//
// Per row, per coupling: x_A and x_B by the coupling's index sets, the
// log-scale MLP s (leaky-relu hiddens, slope 0.01, tanh head) and the shift
// MLP t on x_B, then y_A = x_A·exp(s) + t and ld += Σ s (inverse: x_A =
// (y_A − t)·exp(−s), ld −= Σ s, blocks last to first and the odd coupling
// before the even one). The partition is an index read: the index sets come
// in the launch parameters, and a row's values are picked by
// compare-and-select so that they stay in registers (the Pallas kernel's
// one-hot selection products exist only for the TPU's matrix unit).
//
// What bounds them on this card: operations. At the demo shape (d=2,
// [16,16]×3) K4 does 3,456 multiply-adds a row against 5 words of traffic
// (x in, y and ld out); K5 about four times that against 2d+1 words in and
// d out, plus the weight gradients. Both are far above the H100's balance
// point of ~20 flop/byte, so the time is the CUDA cores' float32 (float64)
// rate; no tensor cores in this first version.
//
// Design: one thread per batch row, its d values and its layer activations
// in registers. Layer widths are padded to compile-time bounds, so register
// arrays are never indexed at run time: a coupling's n_A and n_B (the MLP's
// input and output) to 4 (so d ≤ 8), hidden widths to H = 16 or 32 (a
// template parameter, the smaller that fits), 2 to 4 Dense layers. The
// weights of ONE coupling (its s and t MLPs for one block) are staged in
// shared memory at a time, zero-padded to those bounds and row-major, and
// read by every thread of the block as 16-byte broadcasts, with
// __syncthreads() between couplings: the reference default in float64 would
// need 369 KB to keep every block's weights resident, over the 227 KB a
// block may use. Padded weights are zeros, so padded units stay 0.
//
// K5 keeps per thread only what is per row: its cotangent and its current
// layer cotangent. The CTA's rows' coupling inputs (rows × couplings × d),
// the current coupling's layer activations and the current layer's
// cotangents live in shared memory, where the weight-gradient product
// gW = Hᵀ·G over the CTA's rows needs them anyway; they are stored unit-major
// with a row stride of 65, so that both a thread's own writes and the
// product's reads fall in distinct banks. The batch sum is fixed in order
// and uses no atomics: CTA c walks row tiles c, c + G, c + 2G, ... and
// accumulates its partial gW/gb in its own slice of a scratch buffer (first
// tile writes, later tiles add), then coupling_bwd_reduce sums the G slices
// in CTA order. Two runs give the same bits.
//
// Unlike csrc/rqs.cu this file is built with a*b+c contracted to FMA: the
// comparison with the plain version is within tolerances anyway, since
// cuBLAS sums its products in another order.
//
// The device code below the kernels (staging, the MLPs, one coupling, the
// per-layer backward, K5's row tile `tile_vjp`) is in
// csrc/coupling_device.cuh, which csrc/train.cu (K6, the whole training
// run) includes too.

#include "coupling_device.cuh"

namespace {

// K4: the whole stack on one row per thread.
template <typename T, bool INVERSE, int H>
__global__ void __launch_bounds__(kFwdRows)
coupling_fwd(const T* __restrict__ x, T* __restrict__ y, T* __restrict__ ld,
             int64_t n, const __grid_constant__ Stack st) {
  T* w = reinterpret_cast<T*>(coupling_smem);
  const int64_t row = (int64_t)blockIdx.x * kFwdRows + threadIdx.x;
  const bool active = row < n;
  const int d = st.d;
  T xr[kMaxD];
#pragma unroll
  for (int j = 0; j < kMaxD; ++j)
    xr[j] = (active && j < d) ? x[row * d + j] : T(0);
  T l = T(0);
  const int n_c = 2 * st.n_blocks;
#pragma unroll 1
  for (int c = 0; c < n_c; ++c) {
    int g, blk;
    coupling_at<INVERSE>(st, c, g, blk);
    stage<T, H>(st, g, blk, w);
    T xa[kHalf], xb[kHalf], s[kHalf], t[kHalf];
    coupling_parts<T, H>(st, g, w, xr, xa, xb, s, t, nullptr, 0);
    const T sum = apply_coupling<T, INVERSE>(st, g, xa, s, t, xr);
    l = INVERSE ? l - sum : l + sum;
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < kMaxD; ++j)
      if (j < d) y[row * d + j] = xr[j];
    ld[row] = l;
  }
}

// K5, first pass: gx per row and each CTA's partial weight gradients,
// one row tile at a time (`tile_vjp`).
template <typename T, bool INVERSE, int H>
__global__ void __launch_bounds__(kBwdRows)
coupling_bwd(const T* __restrict__ x, const T* __restrict__ gy,
             const T* __restrict__ gld, T* __restrict__ gx,
             T* __restrict__ scratch, int64_t n, int64_t n_params,
             const __grid_constant__ Stack st) {
  T* w = reinterpret_cast<T*>(coupling_smem);
  T* part = scratch + (int64_t)blockIdx.x * n_params;
  const int tid = threadIdx.x;
  const int d = st.d;
  const int64_t tiles = (n + kBwdRows - 1) / kBwdRows;

#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row = tile * kBwdRows + tid;
    const bool active = row < n;
    // rows past the end get x = 0 and zero cotangents: they add exactly 0
    T xr[kMaxD], gr[kMaxD];
#pragma unroll
    for (int j = 0; j < kMaxD; ++j) {
      xr[j] = (active && j < d) ? x[row * d + j] : T(0);
      gr[j] = (active && j < d) ? gy[row * d + j] : T(0);
    }
    const T gl = active ? gld[row] : T(0);
    tile_vjp<T, INVERSE, H>(st, w, part, tile == blockIdx.x, xr, gr, gl,
                            [](const T(&)[kMaxD], T, T(&)[kMaxD], T&) {});
    if (active) {
#pragma unroll
      for (int j = 0; j < kMaxD; ++j)
        if (j < d) gx[row * d + j] = gr[j];
    }
  }
}

// K5, second pass: sum the G partial slices in CTA order into the stacked
// gradient buffers.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
coupling_bwd_reduce(const T* __restrict__ scratch, int n_ctas,
                    int64_t n_params, const __grid_constant__ GradTable gt) {
  const int64_t p = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (p >= n_params) return;
  T acc = scratch[p];
  for (int c = 1; c < n_ctas; ++c)
    acc = acc + scratch[(int64_t)c * n_params + p];
  int i = 0;
  while (i + 1 < gt.n_leaves && p >= gt.off[i + 1]) ++i;
  static_cast<T*>(gt.ptr[i])[p - gt.off[i]] = acc;
}

template <typename T, int H>
int launch_fwd_h(const T* x, T* y, T* ld, int64_t n, const Stack& st,
                 int inverse, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 2 * (size_t)st.wnet;
  const auto kern = inverse ? &coupling_fwd<T, true, H>
                            : &coupling_fwd<T, false, H>;
  const int err = allow_smem((const void*)kern, smem);
  if (err) return err;
  const unsigned grid = (unsigned)((n + kFwdRows - 1) / kFwdRows);
  kern<<<grid, kFwdRows, smem, stream>>>(x, y, ld, n, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, void* y, void* ld, int64_t n, int d,
               int n_blocks, int depth, const int* widths, const int* idx,
               const void* const* weights, int inverse, void* stream) {
  Stack st;
  int H = 0;
  const int err = make_stack(st, H, d, n_blocks, depth, widths, idx, weights);
  if (err) return err;
  if (n <= 0) return 0;
  const auto xp = static_cast<const T*>(x);
  const auto yp = static_cast<T*>(y), lp = static_cast<T*>(ld);
  const auto cs = static_cast<cudaStream_t>(stream);
  return H == 16 ? launch_fwd_h<T, 16>(xp, yp, lp, n, st, inverse, cs)
                 : launch_fwd_h<T, 32>(xp, yp, lp, n, st, inverse, cs);
}

template <typename T, int H>
int launch_bwd_h(const T* x, const T* gy, const T* gld, T* gx, T* scratch,
                 int64_t n, int64_t n_params, Stack& st, int n_ctas,
                 int inverse, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)bwd_words<H>(st);
  const auto kern = inverse ? &coupling_bwd<T, true, H>
                            : &coupling_bwd<T, false, H>;
  const int err = allow_smem((const void*)kern, smem);
  if (err) return err;
  kern<<<(unsigned)n_ctas, kBwdRows, smem, stream>>>(x, gy, gld, gx, scratch,
                                                     n, n_params, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* gy, const void* gld, void* gx,
               void* scratch, int64_t n, int d, int n_blocks, int depth,
               const int* widths, const int* idx, const void* const* weights,
               void* const* grads, int n_ctas, int inverse, void* stream) {
  Stack st;
  int H = 0;
  int err = make_stack(st, H, d, n_blocks, depth, widths, idx, weights);
  if (err) return err;
  if (n <= 0) return 0;
  const int64_t tiles = (n + kBwdRows - 1) / kBwdRows;
  if (n_ctas < 1 || n_ctas > tiles) return kInvalid;

  GradTable gt{};
  gt.n_leaves = 8 * depth;
  for (int g = 0; g < 2; ++g)
    for (int net = 0; net < 2; ++net)
      for (int l = 0; l < depth; ++l) {
        const int leaf = ((g * 2 + net) * depth + l) * 2;
        gt.ptr[leaf] = grads[leaf];
        gt.ptr[leaf + 1] = grads[leaf + 1];
        gt.off[leaf] = st.leaf_off[g][net][l][0];
        gt.off[leaf + 1] = st.leaf_off[g][net][l][1];
      }
  const int64_t n_params = n_params_of(st);
  gt.off[gt.n_leaves] = n_params;

  const auto cs = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const T*>(x);
  const auto gyp = static_cast<const T*>(gy);
  const auto glp = static_cast<const T*>(gld);
  const auto gxp = static_cast<T*>(gx);
  const auto sp = static_cast<T*>(scratch);
  err = H == 16 ? launch_bwd_h<T, 16>(xp, gyp, glp, gxp, sp, n, n_params, st,
                                      n_ctas, inverse, cs)
                : launch_bwd_h<T, 32>(xp, gyp, glp, gxp, sp, n, n_params, st,
                                      n_ctas, inverse, cs);
  if (err) return err;
  const unsigned grid =
      (unsigned)((n_params + kReduceThreads - 1) / kReduceThreads);
  coupling_bwd_reduce<T><<<grid, kReduceThreads, 0, cs>>>(sp, n_ctas,
                                                          n_params, gt);
  return (int)cudaGetLastError();
}

}  // namespace

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
                     const int* idx, const void* const* weights, int inverse,
                     void* stream) {
  return launch_fwd<float>(x, y, ld, n, d, n_blocks, depth, widths, idx,
                           weights, inverse, stream);
}

int coupling_fwd_f64(const void* x, void* y, void* ld, long long n, int d,
                     int n_blocks, int depth, const int* widths,
                     const int* idx, const void* const* weights, int inverse,
                     void* stream) {
  return launch_fwd<double>(x, y, ld, n, d, n_blocks, depth, widths, idx,
                            weights, inverse, stream);
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
