// Device code of the fused RealNVP coupling-stack kernels, shared by K4/K5
// (csrc/coupling.cu) and K6 (csrc/train.cu): the stack's description
// (`Stack`), staging one coupling's weights in shared memory, the
// conditioner MLPs on one row, one coupling forward, the per-layer
// backward with the CTA's weight-gradient sums, one row tile of the
// stack's VJP (`tile_vjp`), and the host helpers that fill a `Stack` and
// size K5's shared memory. The design is described at the top of
// csrc/coupling.cu. Everything is in an anonymous namespace: each source
// that includes this file gets its own copy.

#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// dynamic shared memory of K4, K5 and K6, viewed as T words by each kernel
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

// One row tile of the stack's VJP over the CTA's kBwdRows rows, one row a
// thread, as K5 runs it. On entry xr holds the row's input, gr and gl the
// cotangents of the stack's output and of its log-det. Steps 0..C−1
// recompute the forward, saving each coupling's input and summing the
// row's log-det; then cot(y, ld, gr, gl) may set the cotangents from the
// row's output y and log-det ld (K6; K5 passes them in and its cot does
// nothing); steps C..2C−1 walk the couplings back, rebuilding one
// coupling's caches at a time (one call site for both, so the MLP code is
// instantiated once), and add the CTA's weight gradients to part (first
// tile: written). On return gr holds the row's gx.
template <typename T, bool INVERSE, int H, typename Cot>
__device__ __forceinline__ void tile_vjp(const Stack& st, T* w, T* part,
                                         bool first, T (&xr)[kMaxD],
                                         T (&gr)[kMaxD], T gl, Cot cot) {
  T* saved = w + st.sm_saved;
  T* cache = w + st.sm_acts;
  T* gbuf = w + st.sm_g;
  const int tid = threadIdx.x;
  const int d = st.d;
  const int n_c = 2 * st.n_blocks;
  T l = T(0);

#pragma unroll 1
  for (int step = 0; step < 2 * n_c; ++step) {
    const bool rev = step >= n_c;
    if (step == n_c) cot(xr, l, gr, gl);
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
      const T sum = apply_coupling<T, INVERSE>(st, g, xa, s, t, xr);
      l = INVERSE ? l - sum : l + sum;
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
                    cache + net * st.sm_acts_net, gbuf, go, gi, part, first);
#pragma unroll
      for (int k = 0; k < kHalf; ++k) g_xb[k] = g_xb[k] + gi[k];
    }
    scatter(g_xa, st.idx_a[g], gr);
    scatter(g_xb, st.idx_b[g], gr);
  }
}

constexpr int kInvalid = (int)cudaErrorInvalidValue;

// Fill st from the C interface's arrays and pick H, the hidden-width bound;
// returns 0 or kInvalid. With weights null the weight pointers stay null
// (K6 points them into its flat weight buffer).
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
        if (weights) {
          st.W[g][net][l] = weights[leaf];
          st.b[g][net][l] = weights[leaf + 1];
        }
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

// K5's shared-memory layout, set in st; returns its size in words of T:
// one coupling's padded weights | saved inputs | the coupling's activations
// (two nets) | one layer's cotangents.
template <int H>
int bwd_words(Stack& st) {
  st.sm_saved = 2 * st.wnet;
  st.sm_acts = st.sm_saved + 2 * st.n_blocks * kBwdRows * st.d;
  st.sm_acts_net = level_off(H, st.depth) + kStride * kHalf;
  st.sm_g = st.sm_acts + 2 * st.sm_acts_net;
  return st.sm_g + kStride * H;
}

}  // namespace
