// The whole-run RealNVP training kernel for Hopper (sm_90a).
//
// K6 realnvp_train<T, H> replaces `_train_kernel`, launched by
// `adam_train_realnvp_fused` (normalizingflows/jl_tpu/experimental/
// train_pallas.py): one launch runs c consecutive steps of reverse-KL ELBO
// training of a fused RealNVP stack with Adam, as the Pallas grid of c
// steps does. Per step, on that step's base draws x (batch, d):
//   y, ld = the stack forward of x (K4's arithmetic)
//   term  = log p(y) − log q0(x) + ld per row, p the Banana target, q0 the
//           diagonal-Gaussian base; loss = −(1/batch)·Σ term → losses[step]
//   the VJP under the constant cotangents gy = −(1/batch)·∇log p(y) and
//           gld = −1/batch (K5's reverse sweep), summed over the batch
//   Adam, optax.adam's formula: m = b1·m + (1−b1)·g, v = b2·v + (1−b2)·g²,
//           w −= lr·(m/c1)/(√(v/c2) + eps), cₖ = 1 − exp(t·log βₖ) at the
//           global step t = step0 + local step + 1.
// The target is a device function, not a callable: log p and its gradient
// are Banana(d, b, var)'s, written out below, with b, var and log Z from
// the launch (the Python-scalar closure constants of the JAX contract).
//
// Design (right and simple first). One CTA of kBwdRows = 64 threads runs
// every step, walking the batch in row tiles of 64 with K5's own device
// code (`tile_vjp`, csrc/coupling_device.cuh) and K5's shared-memory
// layout, plus 64 words for the tile's ELBO terms. The weight gradients go
// to a global buffer through K5's per-CTA path with one CTA: the first tile
// writes, later tiles add, so the batch sum has a fixed order; thread 0
// sums the terms in row order. Only after the last tile does Adam run, over
// the flat parameter vector with the threads strided, so every tile of a
// step sees the pre-update weights. The flat weights, Adam moments and
// gradient buffer live in device memory (the reference default's 46,120
// weights with their moments would not fit in shared memory); K5's
// `stage()` reads the weights from there at every coupling. Those reads go
// through plain pointers, never the read-only path (no __restrict__ or
// __ldg on the weights), and a __syncthreads() separates the Adam pass from
// the next step's first stage(): K6 writes what it reads next.
//
// What bounds it on this card: at the demo (16 rows, 3,852 weights) the
// step is one thread's serial chain through K5's forward and reverse
// sweeps, latency, far from either bound; Adam's 7 words a weight move in
// a few µs. The launch removes the host from the loop: one launch per
// chunk of steps instead of ~48 kernels a step.
//
// Built with FMA contraction, as csrc/coupling.cu is; forward direction
// only (the JAX kernel trains the forward flow).

#include <math.h>

#include "coupling_device.cuh"

namespace {

__device__ __forceinline__ float sq(float v) { return sqrtf(v); }
__device__ __forceinline__ double sq(double v) { return sqrt(v); }
__device__ __forceinline__ float lg(float v) { return logf(v); }
__device__ __forceinline__ double lg(double v) { return log(v); }

// The launch's scalars, converted to T on the host as the JAX kernel's
// Python floats are to the array dtype.
template <typename T>
struct Train {
  T lr, b1, one_m_b1, b2, one_m_b2, eps, log_b1, log_b2;  // Adam
  T bb, var, log_z;         // Banana: log p = −log_z − ½·quad
  T half_d_log_2pi;         // ½·d·log 2π of log q0
  T neg_inv_b;              // −1/batch, the cotangents' scale
};

template <typename T, int H>
__global__ void __launch_bounds__(kBwdRows)
realnvp_train(const T* __restrict__ xs, T* w, T* m, T* v, T* grad,
              T* __restrict__ losses, const T* __restrict__ loc,
              const T* __restrict__ scale, int steps, int64_t step0,
              int64_t batch, int64_t n_params,
              const __grid_constant__ Train<T> a,
              const __grid_constant__ Stack st) {
  T* sm = reinterpret_cast<T*>(coupling_smem);
  T* terms = sm + st.sm_g + kStride * H;  // after K5's layout
  const int tid = threadIdx.x;
  const int d = st.d;
  const int64_t tiles = (batch + kBwdRows - 1) / kBwdRows;
  T log_scale_sum = T(0);
  for (int j = 0; j < d; ++j) log_scale_sum = log_scale_sum + lg(scale[j]);

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const T* x = xs + (int64_t)s * batch * d;
    T acc = T(0);  // thread 0: Σ term over the rows so far, in row order
#pragma unroll 1
    for (int64_t tile = 0; tile < tiles; ++tile) {
      const int64_t row = tile * kBwdRows + tid;
      const bool active = row < batch;
      // rows past the end get x = 0, a zero term and zero cotangents
      T xr[kMaxD], gr[kMaxD] = {};
      T zz = T(0);
#pragma unroll
      for (int j = 0; j < kMaxD; ++j) {
        xr[j] = (active && j < d) ? x[row * d + j] : T(0);
        if (j < d) {
          const T z = (xr[j] - loc[j]) / scale[j];
          zz = zz + z * z;
        }
      }
      const T log_q0 = T(-0.5) * zz - log_scale_sum - a.half_d_log_2pi;
      tile_vjp<T, false, H>(
          st, sm, grad, tile == 0, xr, gr, T(0),
          [&](const T(&y)[kMaxD], T ld, T(&g)[kMaxD], T& gl) {
            // Banana: z = y₁ + b·y₀² − var·b, quad = y₀²/var + z² + Σ_{j≥2}
            // y_j²; ∂log p/∂y₀ = −(y₀/var + 2b·y₀·z), ∂/∂y₁ = −z,
            // ∂/∂y_j = −y_j
            const T y0 = y[0], y1 = y[1];
            const T z = y1 + a.bb * (y0 * y0) - a.var * a.bb;
            T rest = T(0);
#pragma unroll
            for (int j = 2; j < kMaxD; ++j)
              if (j < d) rest = rest + y[j] * y[j];
            const T log_p =
                -a.log_z - T(0.5) * ((y0 * y0) / a.var + z * z + rest);
            terms[tid] = active ? log_p - log_q0 + ld : T(0);
            const T c = active ? a.neg_inv_b : T(0);
            g[0] = c * -(y0 / a.var + T(2) * a.bb * y0 * z);
            g[1] = c * -z;
#pragma unroll
            for (int j = 2; j < kMaxD; ++j) g[j] = j < d ? c * -y[j] : T(0);
            gl = c;
          });
      // the terms were written before the reverse sweep's first stage()
      if (tid == 0) {
        const int64_t live = batch - tile * kBwdRows;
        const int n = live < kBwdRows ? (int)live : kBwdRows;
        for (int r = 0; r < n; ++r) acc = acc + terms[r];
      }
    }
    if (tid == 0) losses[s] = -acc / T(batch);
    __syncthreads();  // every tile's weight gradients are in grad

    const T t = T(step0 + s + 1);
    const T c1 = T(1) - ex(t * a.log_b1);
    const T c2 = T(1) - ex(t * a.log_b2);
    for (int64_t p = tid; p < n_params; p += blockDim.x) {
      const T gp = grad[p];
      const T mp = a.b1 * m[p] + a.one_m_b1 * gp;
      const T vp = a.b2 * v[p] + a.one_m_b2 * gp * gp;
      m[p] = mp;
      v[p] = vp;
      w[p] = w[p] - a.lr * ((mp / c1) / (sq(vp / c2) + a.eps));
    }
    __syncthreads();  // the next step's stage() reads the new weights
  }
}

template <typename T, int H>
int launch_train_h(const T* xs, T* w, T* m, T* v, T* grad, T* losses,
                   const T* loc, const T* scale, int steps, int64_t step0,
                   int64_t batch, int64_t n_params, const Train<T>& a,
                   Stack& st, cudaStream_t stream) {
  const size_t smem = sizeof(T) * ((size_t)bwd_words<H>(st) + kBwdRows);
  const auto kern = &realnvp_train<T, H>;
  const int err = allow_smem((const void*)kern, smem);
  if (err) return err;
  kern<<<1, kBwdRows, smem, stream>>>(xs, w, m, v, grad, losses, loc, scale,
                                      steps, step0, batch, n_params, a, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_train(const void* xs, void* w, void* m, void* v, void* grad,
                 void* losses, const void* loc, const void* scale, int steps,
                 int64_t step0, int64_t batch, int d, int n_blocks, int depth,
                 const int* widths, const int* idx, const double* hyper,
                 void* stream) {
  Stack st;
  int H = 0;
  const int err = make_stack(st, H, d, n_blocks, depth, widths, idx, nullptr);
  if (err) return err;
  if (steps < 1 || batch < 1 || step0 < 0) return kInvalid;
  // the stack's weights are the leaves of the flat w, at their offsets
  for (int g = 0; g < 2; ++g)
    for (int net = 0; net < 2; ++net)
      for (int l = 0; l < depth; ++l) {
        st.W[g][net][l] = static_cast<const T*>(w) + st.leaf_off[g][net][l][0];
        st.b[g][net][l] = static_cast<const T*>(w) + st.leaf_off[g][net][l][1];
      }
  // hyper: lr, b1, b2, eps, Banana's b, var and log Z
  const double b1 = hyper[1], b2 = hyper[2];
  Train<T> a;
  a.lr = T(hyper[0]);
  a.b1 = T(b1);
  a.one_m_b1 = T(1.0 - b1);
  a.b2 = T(b2);
  a.one_m_b2 = T(1.0 - b2);
  a.eps = T(hyper[3]);
  a.log_b1 = T(log(b1));
  a.log_b2 = T(log(b2));
  a.bb = T(hyper[4]);
  a.var = T(hyper[5]);
  a.log_z = T(hyper[6]);
  a.half_d_log_2pi = T(0.5 * d * 1.8378770664093453);
  a.neg_inv_b = T(-(1.0 / (double)batch));
  const int64_t n_params = n_params_of(st);
  const auto cs = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const T*>(xs);
  const auto wp = static_cast<T*>(w), mp = static_cast<T*>(m);
  const auto vp = static_cast<T*>(v), gp = static_cast<T*>(grad);
  const auto lp = static_cast<T*>(losses);
  const auto locp = static_cast<const T*>(loc);
  const auto scp = static_cast<const T*>(scale);
  return H == 16
             ? launch_train_h<T, 16>(xp, wp, mp, vp, gp, lp, locp, scp, steps,
                                     step0, batch, n_params, a, st, cs)
             : launch_train_h<T, 32>(xp, wp, mp, vp, gp, lp, locp, scp, steps,
                                     step0, batch, n_params, a, st, cs);
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py). xs is contiguous
// (steps, batch, d): this launch's base draws, one batch a step. w, m, v
// and grad are flat buffers of the stack's weight count, in the leaf order
// of the JAX `groups` pytree (even.s, even.t, odd.s, odd.t, per layer W
// (n_blocks, in, out) then b (n_blocks, out)); widths and idx are as for
// coupling_fwd. losses gets `steps` values. loc and scale are the base's
// (d,). hyper holds lr, b1, b2, eps, then Banana's b, var and log Z.
// step0 is the global index of the launch's first step (Adam's bias
// correction). K6 updates w, m and v in place; grad is scratch. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for shapes outside the instantiated bounds.
extern "C" {

int realnvp_train_f32(const void* xs, void* w, void* m, void* v, void* grad,
                      void* losses, const void* loc, const void* scale,
                      int steps, long long step0, long long batch, int d,
                      int n_blocks, int depth, const int* widths,
                      const int* idx, const double* hyper, void* stream) {
  return launch_train<float>(xs, w, m, v, grad, losses, loc, scale, steps,
                             step0, batch, d, n_blocks, depth, widths, idx,
                             hyper, stream);
}

int realnvp_train_f64(const void* xs, void* w, void* m, void* v, void* grad,
                      void* losses, const void* loc, const void* scale,
                      int steps, long long step0, long long batch, int d,
                      int n_blocks, int depth, const int* widths,
                      const int* idx, const double* hyper, void* stream) {
  return launch_train<double>(xs, w, m, v, grad, losses, loc, scale, steps,
                              step0, batch, d, n_blocks, depth, widths, idx,
                              hyper, stream);
}

}  // extern "C"
