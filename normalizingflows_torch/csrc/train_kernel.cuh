// The whole-run RealNVP training kernel for Hopper (sm_90a), shared by its
// float32/float64 entries (csrc/train.cu) and its bfloat16 one
// (csrc/train_bf16.cu).
//
// K6 realnvp_train<T, H, P> replaces `_train_kernel`, launched by
// `adam_train_realnvp_fused` (normalizingflows/jl_tpu/experimental/
// train_pallas.py): one launch runs c consecutive steps of reverse-KL ELBO
// training of a fused RealNVP stack with Adam, as the Pallas grid of c
// steps does. Per step, on that step's base draws x (batch, d):
//   y, ld = the stack forward of x (K5's forward recompute)
//   term  = log p(y) − log q0(x) + ld per row, p the target, q0 the
//           diagonal-Gaussian base; loss = −(1/batch)·Σ term → losses[step]
//   the VJP under the constant cotangents gy = −(1/batch)·∇log p(y) and
//           gld = −1/batch (K5's reverse sweep), summed over the batch
//   Adam, optax.adam's formula: m = b1·m + (1−b1)·g, v = b2·v + (1−b2)·g²,
//           w −= lr·(m/c1)/(√(v/c2) + eps), cₖ = 1 − exp(t·log βₖ) at the
//           global step t = step0 + local step + 1.
// The target is a device function, not a callable: log p and its gradient
// are written out below for the three targets the JAX kernel takes as
// built-ins, Banana(d, b, var), Funnel(d, μ, σ) and WarpedGauss(σ₁, σ₂),
// chosen by a runtime id with the target's scalars from the launch (the
// Python-scalar closure constants of the JAX contract). A template
// parameter a target would triple the instantiations and the build.
//
// Design. One CTA runs every step, walking the batch in row tiles with
// K5's lane tile (`tile_vjp`, csrc/coupling_device.cuh): one row on H
// lanes, one hidden unit a lane, and its shared-memory layout, plus one
// word a row for the tile's ELBO terms. The tile holds the fewest rows that
// cover the batch, a multiple of 32/H rows (whole warps) and at most K5's
// R: the demo's 16 rows are 256 threads, and no warp walks padded rows;
// rows past the batch get x = 0, a zero term and zero cotangents. The
// target hook runs on every lane of a row and takes the y_j it needs by
// shuffles; lane 0 writes the row's term. The weight gradients go to a
// global buffer through K5's per-CTA path with one CTA: the first tile
// writes, later tiles add, so the batch sum has a fixed order; thread 0
// sums the terms in row order. Only after the last tile does Adam run,
// over the flat parameter vector with the threads strided, so every tile
// of a step sees the pre-update weights. The flat weights, Adam moments
// and gradient buffer live in device memory (the reference default's
// 46,120 weights with their moments would not fit in shared memory);
// `lane_stage()` reads the weights from there at every coupling. Those reads
// go through plain pointers, never the read-only path (no __restrict__ or
// __ldg on the weights), and a __syncthreads() separates the Adam pass from
// the next step's first lane_stage(): K6 writes what it reads next.
//
// Storage (P, csrc/coupling_device.cuh): Exact<T> stores in T. Bf16Storage
// (bfloat16 parameters) stores x, the weights, the base's loc and scale,
// Adam's m and v and the losses in bfloat16, the JAX kernel's dtypes; it
// reads them widened, computes in float32 with a float32 gradient buffer,
// and rounds each stored value once a step. Its bias corrections are
// float32 too (optax.adam's, which casts 1 − βᵗ after computing it in
// float32): the Pallas kernel computes them in bfloat16, where 1 − 0.999
// rounds to 0 at t = 1.
//
// What bounds it on this card: at the demo (16 rows, 3,852 weights) one
// row's dependent chain through the forward and reverse sweeps, and the
// 4·n_blocks lane_stage() calls a step, each a round trip to device memory
// (L2), far from either bound; Adam's 7 words a weight move in a few µs,
// two weights a thread in flight. The launch removes the host from the
// loop: one launch per chunk of steps instead of ~48 kernels a step. Past
// R rows the one CTA walks the tiles in turn (a thread-block cluster that
// splits them is the next design).
//
// Built with FMA contraction, as csrc/coupling.cu is; forward direction
// only (the JAX kernel trains the forward flow).

#pragma once
#include <math.h>

#include "coupling_device.cuh"

namespace {

__device__ __forceinline__ float sq(float v) { return sqrtf(v); }
__device__ __forceinline__ double sq(double v) { return sqrt(v); }
__device__ __forceinline__ float lg(float v) { return logf(v); }
__device__ __forceinline__ double lg(double v) { return log(v); }
__device__ __forceinline__ void sin_cos(float v, float* s, float* c) {
  sincosf(v, s, c);
}
__device__ __forceinline__ void sin_cos(double v, double* s, double* c) {
  sincos(v, s, c);
}

// the target ids (train_cuda.py's TARGETS)
constexpr int kBanana = 0, kFunnel = 1, kWarpedGauss = 2;

// The launch's scalars, converted to T on the host as the JAX kernel's
// Python floats are to the array dtype. The target's c[]:
//   Banana:      b, var, log Z                  (log p = −log Z − ½·quad)
//   Funnel:      μ, σ, (d−1)/2, log Z = ½·d·log 2π + log σ
//   WarpedGauss: σ₁, σ₂, log Z = log 2π + log σ₁ + log σ₂, ref_compat (1/0)
template <typename T>
struct Train {
  T lr, b1, one_m_b1, b2, one_m_b2, eps, log_b1, log_b2;  // Adam
  int target;               // kBanana, kFunnel or kWarpedGauss
  T c[4];                   // the target's scalars
  T half_d_log_2pi;         // ½·d·log 2π of log q0
  T neg_inv_b;              // −1/batch, the cotangents' scale
};

// log p(y) of lane u's row, and g = ∂log p/∂y_u on lane u (0 for u ≥ d),
// from lane u's y_u. The id is the launch's, so a warp takes one branch and
// every lane runs every shuffle.
template <typename T, int H>
__device__ __forceinline__ T target_logp(const Train<T>& a, int d, int u,
                                         T y_u, T& g) {
  const T y0 = lane<H>(y_u, 0), y1 = lane<H>(y_u, 1);
  if (a.target == kFunnel) {
    // x_{2:d} | x₁ ~ N(0, e^{x₁} I): with e = e^{−y₀}, S = Σ_{j≥1} y_j²
    // and q = (y₀ − μ)/σ, log p = −q²/2 − e·S/2 − (d−1)/2·y₀ − log Z;
    // ∂₀ = −q/σ − (d−1)/2 + e·S/2 (JAX's Funnel.score), ∂_j = −e·y_j
    T s = y1 * y1;
#pragma unroll
    for (int j = 2; j < kMaxD; ++j) {
      const T yj = lane<H>(y_u, j);
      if (j < d) s = s + yj * yj;
    }
    const T e = ex(-y0), q = (y0 - a.c[0]) / a.c[1];
    g = u == 0 ? -q / a.c[1] - a.c[2] + T(0.5) * e * s
        : u < d ? -e * y_u
                : T(0);
    return T(-0.5) * (q * q) - T(0.5) * (e * s) - a.c[2] * y0 - a.c[3];
  }
  if (a.target == kWarpedGauss) {
    // ϕ⁻¹ rotates y by r/2, r = |y|: zx = y₀·c − y₁·s, zy = y₀·s + y₁·c
    // with (s, c) = sin, cos(r/2); log p = −(p² + q²)/2 − log Z, p = zx/σ₁,
    // q = zy/σ₂, (+ log r with ref_compat). With u = p/σ₁, v = q/σ₂ and
    // w = (v·zx − u·zy)/(2r): ∂₀ = −(u·c + v·s) − y₀·w,
    // ∂₁ = −(v·c − u·s) − y₁·w (+ y/r²). r = 0 has no gradient.
    const T r2 = y0 * y0 + y1 * y1, r = sq(r2);
    T s, c;
    sin_cos(T(0.5) * r, &s, &c);
    const T zx = y0 * c - y1 * s, zy = y0 * s + y1 * c;
    const T p = zx / a.c[0], q = zy / a.c[1];
    const T pu = p / a.c[0], qv = q / a.c[1];
    const T w = (qv * zx - pu * zy) / (T(2) * r);
    const bool ref = a.c[3] != T(0);
    const T gj = u == 0 ? -(pu * c + qv * s) - y0 * w
                        : -(qv * c - pu * s) - y1 * w;
    g = u < 2 ? (ref ? gj + y_u / r2 : gj) : T(0);
    const T log_p = T(-0.5) * (p * p + q * q) - a.c[2];
    return ref ? log_p + lg(r) : log_p;
  }
  // Banana: z = y₁ + b·y₀² − var·b, quad = y₀²/var + z² + Σ_{j≥2} y_j²;
  // ∂log p/∂y₀ = −(y₀/var + 2b·y₀·z), ∂/∂y₁ = −z, ∂/∂y_j = −y_j
  const T z = y1 + a.c[0] * (y0 * y0) - a.c[1] * a.c[0];
  T rest = T(0);
#pragma unroll
  for (int j = 2; j < kMaxD; ++j) {
    const T yj = lane<H>(y_u, j);
    if (j < d) rest = rest + yj * yj;
  }
  g = u == 0   ? -(y0 / a.c[1] + T(2) * a.c[0] * y0 * z)
      : u == 1 ? -z
      : u < d  ? -y_u
               : T(0);
  return -a.c[2] - T(0.5) * ((y0 * y0) / a.c[1] + z * z + rest);
}

template <typename T, int H, typename P>
__global__ void __launch_bounds__(bwd_rows<T, H>() * H, 1)
realnvp_train(const typename P::S* __restrict__ xs, typename P::S* w,
              typename P::S* m, typename P::S* v, T* grad,
              typename P::S* __restrict__ losses,
              const typename P::S* __restrict__ loc,
              const typename P::S* __restrict__ scale, int steps,
              int64_t step0, int64_t batch, int64_t n_params,
              const __grid_constant__ Train<T> a,
              const __grid_constant__ Stack st) {
  using S = typename P::S;
  T* sm = reinterpret_cast<T*>(coupling_smem);
  const int rows = st.rows;
  T* terms = sm + st.sm_g + rows * H;  // after the lane tile's layout
  const int tid = threadIdx.x, row = tid / H, u = tid % H;
  const int d = st.d;
  const int64_t tiles = (batch + rows - 1) / rows;
  T log_scale_sum = T(0);
  for (int j = 0; j < d; ++j)
    log_scale_sum = log_scale_sum + lg(widen<T>(scale[j]));

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const S* x = xs + (int64_t)s * batch * d;
    T acc = T(0);  // thread 0: Σ term over the rows so far, in row order
#pragma unroll 1
    for (int64_t tile = 0; tile < tiles; ++tile) {
      const int64_t r = tile * rows + row;
      const bool active = r < batch;
      // rows past the end get x = 0, a zero term and zero cotangents
      T xv = (active && u < d) ? widen<T>(x[r * d + u]) : T(0), gv = T(0);
      const T zu =
          u < d ? (xv - widen<T>(loc[u])) / widen<T>(scale[u]) : T(0);
      T zz = T(0);
#pragma unroll
      for (int j = 0; j < kMaxD; ++j) {
        const T z = lane<H>(zu, j);
        if (j < d) zz = zz + z * z;
      }
      const T log_q0 = T(-0.5) * zz - log_scale_sum - a.half_d_log_2pi;
      tile_vjp<T, false, H, P>(
          st, sm, grad, tile == 0, xv, gv, T(0),
          [&](T y_u, T ld, T& g_u, T& gl) {
            T dlp;
            const T log_p = target_logp<T, H>(a, d, u, y_u, dlp);
            if (u == 0) terms[row] = active ? log_p - log_q0 + ld : T(0);
            g_u = active ? a.neg_inv_b * dlp : T(0);
            gl = active ? a.neg_inv_b : T(0);
          });
      // the terms were written before the reverse sweep's first lane_stage()
      if (tid == 0) {
        const int64_t live = batch - tile * rows;
        const int n = live < rows ? (int)live : rows;
        for (int i = 0; i < n; ++i) acc = acc + terms[i];
      }
    }
    if (tid == 0) losses[s] = narrow<S>(-acc / T(batch));
    __syncthreads();  // every tile's weight gradients are in grad

    const T t = T(step0 + s + 1);
    const T c1 = T(1) - ex(t * a.log_b1);
    const T c2 = T(1) - ex(t * a.log_b2);
    // kInFlight weights a thread at a time: every load before any store
    constexpr int kInFlight = 2;
    for (int64_t p0 = tid; p0 < n_params; p0 += kInFlight * blockDim.x) {
      T gp[kInFlight], mp[kInFlight], vp[kInFlight], wp[kInFlight];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const int64_t p = p0 + (int64_t)i * blockDim.x;
        if (p < n_params) gp[i] = grad[p], mp[i] = widen<T>(m[p]),
                          vp[i] = widen<T>(v[p]), wp[i] = widen<T>(w[p]);
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const int64_t p = p0 + (int64_t)i * blockDim.x;
        if (p >= n_params) continue;
        const T mi = a.b1 * mp[i] + a.one_m_b1 * gp[i];
        const T vi = a.b2 * vp[i] + a.one_m_b2 * gp[i] * gp[i];
        m[p] = narrow<S>(mi);
        v[p] = narrow<S>(vi);
        w[p] = narrow<S>(wp[i] - a.lr * ((mi / c1) / (sq(vi / c2) + a.eps)));
      }
    }
    __syncthreads();  // the next step's lane_stage() reads the new weights
  }
}

template <typename T, int H, typename P>
int launch_train_h(const typename P::S* xs, typename P::S* w,
                   typename P::S* m, typename P::S* v, T* grad,
                   typename P::S* losses, const typename P::S* loc,
                   const typename P::S* scale, int steps, int64_t step0,
                   int64_t batch, int64_t n_params, const Train<T>& a,
                   Stack& st, cudaStream_t stream) {
  st.rows = lane_rows<T, H>(batch);
  const size_t smem = sizeof(T) * ((size_t)lane_bwd_words<H>(st) + st.rows);
  const auto kern = &realnvp_train<T, H, P>;
  const int err = allow_smem((const void*)kern, smem);
  if (err) return err;
  kern<<<1, st.rows * H, smem, stream>>>(xs, w, m, v, grad, losses, loc,
                                         scale, steps, step0, batch,
                                         n_params, a, st);
  return (int)cudaGetLastError();
}

template <typename T, typename P = Exact<T>>
int launch_train(const void* xs, void* w, void* m, void* v, void* grad,
                 void* losses, const void* loc, const void* scale, int steps,
                 int64_t step0, int64_t batch, int d, int n_blocks, int depth,
                 const int* widths, const int* idx, int target,
                 const double* hyper, void* stream) {
  using S = typename P::S;
  Stack st;
  int H = 0;
  const int err = make_stack(st, H, d, n_blocks, depth, widths, idx, nullptr);
  if (err) return err;
  if (steps < 1 || batch < 1 || step0 < 0) return kInvalid;
  if (target != kBanana && target != kFunnel && target != kWarpedGauss)
    return kInvalid;
  if (target == kWarpedGauss && d != 2) return kInvalid;
  // the stack's weights are the leaves of the flat w, at their offsets
  for (int g = 0; g < 2; ++g)
    for (int net = 0; net < 2; ++net)
      for (int l = 0; l < depth; ++l) {
        st.W[g][net][l] = static_cast<const S*>(w) + st.leaf_off[g][net][l][0];
        st.b[g][net][l] = static_cast<const S*>(w) + st.leaf_off[g][net][l][1];
      }
  // hyper: lr, b1, b2, eps, then the target's four scalars
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
  a.target = target;
  for (int i = 0; i < 4; ++i) a.c[i] = T(hyper[4 + i]);
  a.half_d_log_2pi = T(0.5 * d * 1.8378770664093453);
  a.neg_inv_b = T(-(1.0 / (double)batch));
  const int64_t n_params = n_params_of(st);
  const auto cs = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const S*>(xs);
  const auto wp = static_cast<S*>(w), mp = static_cast<S*>(m);
  const auto vp = static_cast<S*>(v), lp = static_cast<S*>(losses);
  const auto gp = static_cast<T*>(grad);
  const auto locp = static_cast<const S*>(loc);
  const auto scp = static_cast<const S*>(scale);
  return H == 16 ? launch_train_h<T, 16, P>(xp, wp, mp, vp, gp, lp, locp,
                                            scp, steps, step0, batch,
                                            n_params, a, st, cs)
                 : launch_train_h<T, 32, P>(xp, wp, mp, vp, gp, lp, locp,
                                            scp, steps, step0, batch,
                                            n_params, a, st, cs);
}

}  // namespace
