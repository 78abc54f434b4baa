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

#include <cuda_runtime.h>
#include <stdint.h>

// dynamic shared memory of K4 and K5, viewed as T words by each kernel
extern __shared__ __align__(16) unsigned char coupling_smem[];

namespace {

constexpr int kMaxD = 8;   // flow dimension
constexpr int kHalf = 4;   // bound of a coupling's n_A and n_B
constexpr int kMaxL = 4;   // Dense layers a conditioner, at least 2
constexpr int kFwdRows = 128;
constexpr int kBwdRows = 64;  // coupling_cuda.py's BWD_ROWS
constexpr int kStride = kBwdRows + 1;  // K5's unit-major row stride
constexpr int kReduceThreads = 256;
constexpr int kMaxLeaves = 2 * 2 * kMaxL * 2;

// The stack's shapes and weights, passed by value as a kernel parameter.
struct Stack {
  const void* W[2][2][kMaxL];  // [group even/odd][net s/t][layer], stacked
  const void* b[2][2][kMaxL];  // (n_blocks, in, out) and (n_blocks, out)
  int64_t leaf_off[2][2][kMaxL][2];  // flat gradient offsets of W and b
  int d, n_blocks, depth;
  int width[2][kMaxL + 1];  // [group]: n_B (conditioner input), hidden, n_A
  int idx_a[2][kHalf];      // transformed index set, −1 padded
  int idx_b[2][kHalf];      // conditioner index set, −1 padded
  int wnet;                 // words of one net's padded weights
  // K5's shared-memory layout, in words of T
  int sm_saved, sm_acts, sm_acts_net, sm_g;
};

struct GradTable {
  void* ptr[kMaxLeaves];
  int64_t off[kMaxLeaves + 1];
  int n_leaves;
};

__device__ __forceinline__ float ex(float v) { return expf(v); }
__device__ __forceinline__ double ex(double v) { return exp(v); }
__device__ __forceinline__ float th(float v) { return tanhf(v); }
__device__ __forceinline__ double th(double v) { return tanh(v); }

// 16 bytes of shared memory into registers
__device__ __forceinline__ void ld16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void ld16(const double* p, double* o) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  o[0] = v.x, o[1] = v.y;
}

// Padded geometry of one net: layer l is (in_bound, out_bound), W then b.
__host__ __device__ constexpr int in_bound(int H, int l) {
  return l == 0 ? kHalf : H;
}
__host__ __device__ constexpr int out_bound(int H, int l, int depth) {
  return l == depth - 1 ? kHalf : H;
}
__host__ __device__ inline int layer_off(int H, int l) {
  return l == 0 ? 0 : (kHalf * H + H) + (l - 1) * (H * H + H);
}
__host__ __device__ inline int net_words(int H, int depth) {
  return layer_off(H, depth - 1) + H * kHalf + kHalf;
}
// offset of activation level m (0: the input, depth: the output), unit-major
__host__ __device__ inline int level_off(int H, int m) {
  return m == 0 ? 0 : kStride * (kHalf + (m - 1) * H);
}

// Block blk's s and t weights of group g into w, zero-padded.
template <typename T, int H>
__device__ void stage(const Stack& st, int g, int blk, T* w) {
  __syncthreads();  // every thread is done with the previous coupling
  const int depth = st.depth;
  int off = 0;
#pragma unroll 1
  for (int net = 0; net < 2; ++net) {
#pragma unroll 1
    for (int l = 0; l < depth; ++l) {
      const int ib = in_bound(H, l), ob = out_bound(H, l, depth);
      const int in = st.width[g][l], o = st.width[g][l + 1];
      const T* W = static_cast<const T*>(st.W[g][net][l]) +
                   (int64_t)blk * in * o;
      const T* b = static_cast<const T*>(st.b[g][net][l]) + (int64_t)blk * o;
      for (int e = threadIdx.x; e < ib * ob + ob; e += blockDim.x) {
        T v = T(0);
        if (e < ib * ob) {
          const int k = e / ob, j = e - (e / ob) * ob;
          if (k < in && j < o) v = W[k * o + j];
        } else if (e - ib * ob < o) {
          v = b[e - ib * ob];
        }
        w[off + e] = v;
      }
      off += ib * ob + ob;
    }
  }
  __syncthreads();
}

// out[k] = v[idx[k]] (0 where idx[k] is −1).
template <typename T>
__device__ __forceinline__ void gather(const T (&v)[kMaxD],
                                       const int (&idx)[kHalf],
                                       T (&out)[kHalf]) {
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const int i = idx[k];
    T r = T(0);
#pragma unroll
    for (int j = 0; j < kMaxD; ++j) r = (j == i) ? v[j] : r;
    out[k] = r;
  }
}

// v[idx[k]] = src[k] for the valid entries of idx.
template <typename T>
__device__ __forceinline__ void scatter(const T (&src)[kHalf],
                                        const int (&idx)[kHalf],
                                        T (&v)[kMaxD]) {
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const int i = idx[k];
#pragma unroll
    for (int j = 0; j < kMaxD; ++j) v[j] = (j == i) ? src[k] : v[j];
  }
}

// z = h @ W + b on one row; W (IB, OB) row-major then b (OB) in shared
// memory. The product is summed over k in order, then the bias added.
template <typename T, int H, int IB, int OB>
__device__ __forceinline__ void dense(const T* W, const T (&h)[H],
                                      T (&z)[H]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < OB; ++j) z[j] = T(0);
#pragma unroll
  for (int k = 0; k < IB; ++k) {
#pragma unroll
    for (int j = 0; j < OB; j += V) {
      T w[V];
      ld16(W + k * OB + j, w);
#pragma unroll
      for (int v = 0; v < V; ++v) z[j + v] = z[j + v] + h[k] * w[v];
    }
  }
#pragma unroll
  for (int j = 0; j < OB; j += V) {
    T w[V];
    ld16(W + IB * OB + j, w);
#pragma unroll
    for (int v = 0; v < V; ++v) z[j + v] = z[j + v] + w[v];
  }
}

enum Act { kLeaky, kTanh, kLinear };

template <typename T, int H, int OB>
__device__ __forceinline__ void activate(Act a, const T (&z)[H], T (&h)[H]) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const T v = j < OB ? z[j] : T(0);
    h[j] = a == kLeaky ? (v >= T(0) ? v : T(0.01) * v)
                       : (a == kTanh ? th(v) : v);
  }
}

// level m's OB values of this row into the cache (unit-major)
template <typename T, int H, int OB>
__device__ __forceinline__ void keep(T* cache, int m, int row,
                                     const T (&h)[H]) {
  if (!cache) return;
  T* c = cache + level_off(H, m) + row;
#pragma unroll
  for (int j = 0; j < OB; ++j) c[j * kStride] = h[j];
}

// One conditioner MLP (net 0: s, tanh head; net 1: t) on one row. With
// cache != nullptr every level's post-activations go to shared memory.
template <typename T, int H>
__device__ __forceinline__ void mlp_row(const Stack& st, int net, const T* w,
                                        const T (&xb)[kHalf],
                                        T (&out)[kHalf], T* cache, int row) {
  T h[H], z[H];
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = j < kHalf ? xb[j < kHalf ? j : 0] : T(0);
  keep<T, H, kHalf>(cache, 0, row, h);
  const int depth = st.depth;
  dense<T, H, kHalf, H>(w, h, z);
  activate<T, H, H>(kLeaky, z, h);
  keep<T, H, H>(cache, 1, row, h);
#pragma unroll 1
  for (int l = 1; l < depth - 1; ++l) {
    dense<T, H, H, H>(w + layer_off(H, l), h, z);
    activate<T, H, H>(kLeaky, z, h);
    keep<T, H, H>(cache, l + 1, row, h);
  }
  dense<T, H, H, kHalf>(w + layer_off(H, depth - 1), h, z);
  activate<T, H, kHalf>(net == 0 ? kTanh : kLinear, z, h);
  keep<T, H, kHalf>(cache, depth, row, h);
#pragma unroll
  for (int k = 0; k < kHalf; ++k) out[k] = h[k];
}

// x_A, x_B, s and t of coupling g on one row's input x.
template <typename T, int H>
__device__ __forceinline__ void coupling_parts(
    const Stack& st, int g, const T* w, const T (&x)[kMaxD], T (&xa)[kHalf],
    T (&xb)[kHalf], T (&s)[kHalf], T (&t)[kHalf], T* cache, int row) {
  gather(x, st.idx_a[g], xa);
  gather(x, st.idx_b[g], xb);
#pragma unroll 1
  for (int net = 0; net < 2; ++net) {
    T o[kHalf];
    mlp_row<T, H>(st, net, w + net * st.wnet, xb, o,
                  cache ? cache + net * st.sm_acts_net : nullptr, row);
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      if (net == 0) s[k] = o[k];
      else t[k] = o[k];
    }
  }
}

// y_A from the parts, scattered into x; returns Σ s over the n_A entries.
template <typename T, bool INVERSE>
__device__ __forceinline__ T apply_coupling(const Stack& st, int g,
                                            const T (&xa)[kHalf],
                                            const T (&s)[kHalf],
                                            const T (&t)[kHalf],
                                            T (&x)[kMaxD]) {
  const int na = st.width[g][st.depth];
  T ya[kHalf];
  T sum = T(0);
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    ya[k] = INVERSE ? (xa[k] - t[k]) * ex(-s[k]) : xa[k] * ex(s[k]) + t[k];
    if (k < na) sum = (k == 0) ? s[k] : sum + s[k];
  }
  scatter(ya, st.idx_a[g], x);
  return sum;
}

// Coupling c of the application order → (group, block).
template <bool INVERSE>
__device__ __forceinline__ void coupling_at(const Stack& st, int c, int& g,
                                            int& blk) {
  blk = INVERSE ? st.n_blocks - 1 - c / 2 : c / 2;
  g = INVERSE ? 1 - (c & 1) : (c & 1);
}

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

// `_mlp_bwd` of layer l (padded IB → OB) over the CTA's rows: the row's
// cotangent gc goes through the activation slope (from the cached
// post-activation: leaky-relu 1 where h ≥ 0, else 0.01; tanh' = 1 − h²),
// the CTA's partial gW = Hᵀ·G and gb = Σ_rows G go to part (first tile:
// written, later tiles: added), and gc becomes G·Wᵀ.
template <typename T, int H, int IB, int OB>
__device__ __forceinline__ void layer_bwd(const Stack& st, int g, int net,
                                          int blk, int l, Act act,
                                          const T* W, const T* cache,
                                          T* gbuf, T (&gc)[H],
                                          T* __restrict__ part, bool first) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const T* h_in = cache + level_off(H, l);
  const T* h_out = cache + level_off(H, l + 1);
#pragma unroll
  for (int j = 0; j < OB; ++j) {
    const T a = h_out[j * kStride + tid];
    if (act == kLeaky) gc[j] = gc[j] * (a >= T(0) ? T(1) : T(0.01));
    else if (act == kTanh) gc[j] = gc[j] * (T(1) - a * a);
    gbuf[j * kStride + tid] = gc[j];
  }
  __syncthreads();
  // the CTA's partial weight gradient, one entry per thread at a time,
  // summed over rows 0..kBwdRows−1 in order
  const int in = st.width[g][l], o = st.width[g][l + 1];
  const int n_w = in * o;
  const int64_t offW = st.leaf_off[g][net][l][0] + (int64_t)blk * n_w;
  const int64_t offb = st.leaf_off[g][net][l][1] + (int64_t)blk * o;
  for (int e = tid; e < n_w + o; e += blockDim.x) {
    T acc = T(0);
    int64_t dst;
    if (e < n_w) {
      const int k = e / o, j = e - (e / o) * o;
      const T* hk = h_in + k * kStride;
      const T* gj = gbuf + j * kStride;
      for (int r = 0; r < kBwdRows; ++r) acc = acc + hk[r] * gj[r];
      dst = offW + e;
    } else {
      const T* gj = gbuf + (e - n_w) * kStride;
      for (int r = 0; r < kBwdRows; ++r) acc = acc + gj[r];
      dst = offb + (e - n_w);
    }
    part[dst] = first ? acc : part[dst] + acc;
  }
  // the row's input cotangent G·Wᵀ, a row of W in 16-byte loads
  T gn[H];
#pragma unroll
  for (int k = 0; k < H; ++k) gn[k] = T(0);
#pragma unroll
  for (int k = 0; k < IB; ++k) {
#pragma unroll
    for (int j = 0; j < OB; j += V) {
      T w[V];
      ld16(W + k * OB + j, w);
#pragma unroll
      for (int v = 0; v < V; ++v) gn[k] = gn[k] + gc[j + v] * w[v];
    }
  }
#pragma unroll
  for (int k = 0; k < H; ++k) gc[k] = gn[k];
  __syncthreads();  // gbuf is the next layer's
}

// `_mlp_bwd` of one net of coupling (g, blk): gout → gin for this row.
template <typename T, int H>
__device__ __forceinline__ void mlp_bwd(const Stack& st, int g, int net,
                                        int blk, const T* w, const T* cache,
                                        T* gbuf, const T (&gout)[kHalf],
                                        T (&gin)[kHalf], T* __restrict__ part,
                                        bool first) {
  const int depth = st.depth;
  T gc[H];
#pragma unroll
  for (int j = 0; j < H; ++j)
    gc[j] = j < kHalf ? gout[j < kHalf ? j : 0] : T(0);
  layer_bwd<T, H, H, kHalf>(st, g, net, blk, depth - 1,
                            net == 0 ? kTanh : kLinear,
                            w + layer_off(H, depth - 1), cache, gbuf, gc,
                            part, first);
#pragma unroll 1
  for (int l = depth - 2; l >= 1; --l)
    layer_bwd<T, H, H, H>(st, g, net, blk, l, kLeaky, w + layer_off(H, l),
                          cache, gbuf, gc, part, first);
  layer_bwd<T, H, kHalf, H>(st, g, net, blk, 0, kLeaky, w, cache, gbuf, gc,
                            part, first);
#pragma unroll
  for (int k = 0; k < kHalf; ++k) gin[k] = gc[k];
}

// K5, first pass: gx per row and each CTA's partial weight gradients.
// Steps 0..C−1 recompute the forward, saving each coupling's input; steps
// C..2C−1 walk the couplings back, rebuilding one coupling's caches at a
// time (one call site for both, so the MLP code is instantiated once).
template <typename T, bool INVERSE, int H>
__global__ void __launch_bounds__(kBwdRows)
coupling_bwd(const T* __restrict__ x, const T* __restrict__ gy,
             const T* __restrict__ gld, T* __restrict__ gx,
             T* __restrict__ scratch, int64_t n, int64_t n_params,
             const __grid_constant__ Stack st) {
  T* w = reinterpret_cast<T*>(coupling_smem);
  T* saved = w + st.sm_saved;
  T* cache = w + st.sm_acts;
  T* gbuf = w + st.sm_g;
  T* part = scratch + (int64_t)blockIdx.x * n_params;
  const int tid = threadIdx.x;
  const int d = st.d;
  const int n_c = 2 * st.n_blocks;
  const int64_t tiles = (n + kBwdRows - 1) / kBwdRows;

#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
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

#pragma unroll 1
    for (int step = 0; step < 2 * n_c; ++step) {
      const bool rev = step >= n_c;
      const int c = rev ? 2 * n_c - 1 - step : step;
      int g, blk;
      coupling_at<INVERSE>(st, c, g, blk);
      stage<T, H>(st, g, blk, w);
      T* sv = saved + ((int64_t)c * kBwdRows + tid) * d;
      T xin[kMaxD];
#pragma unroll
      for (int j = 0; j < kMaxD; ++j) {
        if (!rev) {
          xin[j] = xr[j];
          if (j < d) sv[j] = xr[j];
        } else {
          xin[j] = (j < d) ? sv[j] : T(0);
        }
      }
      T xa[kHalf], xb[kHalf], s[kHalf], t[kHalf];
      coupling_parts<T, H>(st, g, w, xin, xa, xb, s, t,
                           rev ? cache : nullptr, tid);
      if (!rev) {
        apply_coupling<T, INVERSE>(st, g, xa, s, t, xr);
        continue;
      }
      // `_coupling_bwd`: gld reaches every coupling's s
      const int na = st.width[g][st.depth];
      T g_ya[kHalf], g_xb[kHalf], g_xa[kHalf], g_s[kHalf], g_t[kHalf];
      gather(gr, st.idx_a[g], g_ya);
      gather(gr, st.idx_b[g], g_xb);
#pragma unroll
      for (int k = 0; k < kHalf; ++k) {
        if (INVERSE) {
          const T e = ex(-s[k]);
          g_xa[k] = g_ya[k] * e;
          g_t[k] = -g_xa[k];
          g_s[k] = -g_ya[k] * (xa[k] - t[k]) * e - gl;
        } else {
          const T e = ex(s[k]);
          g_xa[k] = g_ya[k] * e;
          g_t[k] = g_ya[k];
          g_s[k] = g_ya[k] * xa[k] * e + gl;
        }
        // padded outputs of s and t take no cotangent
        if (k >= na) g_s[k] = g_t[k] = T(0);
      }
      // g_xb + (s net's input cotangent) + (t net's), in that order
#pragma unroll 1
      for (int net = 0; net < 2; ++net) {
        T go[kHalf], gi[kHalf];
#pragma unroll
        for (int k = 0; k < kHalf; ++k) go[k] = net == 0 ? g_s[k] : g_t[k];
        mlp_bwd<T, H>(st, g, net, blk, w + net * st.wnet,
                      cache + net * st.sm_acts_net, gbuf, go, gi, part,
                      first);
#pragma unroll
        for (int k = 0; k < kHalf; ++k) g_xb[k] = g_xb[k] + gi[k];
      }
      scatter(g_xa, st.idx_a[g], gr);
      scatter(g_xb, st.idx_b[g], gr);
    }
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

constexpr int kInvalid = (int)cudaErrorInvalidValue;

// Fill st from the C interface's arrays and pick H, the hidden-width bound;
// returns 0 or kInvalid.
int make_stack(Stack& st, int& H, int d, int n_blocks, int depth,
               const int* widths, const int* idx,
               const void* const* weights) {
  if (d < 2 || d > kMaxD || depth < 2 || depth > kMaxL || n_blocks < 1)
    return kInvalid;
  st = Stack{};
  st.d = d;
  st.n_blocks = n_blocks;
  st.depth = depth;
  int hidden = 1;
  int64_t off = 0;
  for (int g = 0; g < 2; ++g) {
    for (int l = 0; l <= depth; ++l) {
      const int wd = widths[g * (depth + 1) + l];
      if (wd < 1) return kInvalid;
      st.width[g][l] = wd;
      if (l > 0 && l < depth) hidden = wd > hidden ? wd : hidden;
    }
    const int nb = st.width[g][0], na = st.width[g][depth];
    if (na + nb != d || na > kHalf || nb > kHalf) return kInvalid;
    for (int k = 0; k < kHalf; ++k) {
      st.idx_a[g][k] = k < na ? idx[g * d + k] : -1;
      st.idx_b[g][k] = k < nb ? idx[g * d + na + k] : -1;
    }
    for (int k = 0; k < d; ++k) {
      const int i = idx[g * d + k];
      if (i < 0 || i >= d) return kInvalid;
    }
    for (int net = 0; net < 2; ++net) {
      for (int l = 0; l < depth; ++l) {
        const int leaf = ((g * 2 + net) * depth + l) * 2;
        st.W[g][net][l] = weights[leaf];
        st.b[g][net][l] = weights[leaf + 1];
        const int in = st.width[g][l], out = st.width[g][l + 1];
        st.leaf_off[g][net][l][0] = off;
        off += (int64_t)n_blocks * in * out;
        st.leaf_off[g][net][l][1] = off;
        off += (int64_t)n_blocks * out;
      }
    }
  }
  if (hidden > 32) return kInvalid;
  H = hidden <= 16 ? 16 : 32;
  st.wnet = net_words(H, depth);
  return 0;
}

int64_t n_params_of(const Stack& st) {
  int64_t n = 0;
  for (int g = 0; g < 2; ++g)
    for (int l = 0; l < st.depth; ++l)
      n += 2 * (int64_t)st.n_blocks *
           (st.width[g][l] * st.width[g][l + 1] + st.width[g][l + 1]);
  return n;
}

// Raise a kernel's dynamic shared-memory cap to `bytes` if it needs more
// than the default 48 KB; kInvalid if the card cannot give it.
int allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)optin) return kInvalid;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
  // shared memory: one coupling's padded weights | saved inputs | the
  // coupling's activations (two nets) | one layer's cotangents
  st.sm_saved = 2 * st.wnet;
  st.sm_acts = st.sm_saved + 2 * st.n_blocks * kBwdRows * st.d;
  st.sm_acts_net = level_off(H, st.depth) + kStride * kHalf;
  st.sm_g = st.sm_acts + 2 * st.sm_acts_net;
  const size_t smem = sizeof(T) * (size_t)(st.sm_g + kStride * H);
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
