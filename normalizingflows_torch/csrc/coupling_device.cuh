// Device code of the fused RealNVP coupling-stack kernels, shared by K4/K5
// (csrc/coupling_kernels.cuh) and K6 (csrc/train_kernel.cuh): the stack's
// description (`Stack`), staging weights in shared memory (K5/K6 a coupling at a time
// with loads and stores between two barriers, K4 by cp.async: the whole
// stack where it fits, else the next coupling into a second slot while
// this one computes), and two mappings of a batch row onto threads. One row a thread: K4 and K5's row tile at large
// batches (`dense`, `mlp_row`, `coupling_parts`, `apply_coupling`,
// `layer_bwd`, `mlp_bwd`, `row_tile_vjp`). One row on H lanes of a warp,
// one hidden unit a lane: K4 and K5's lane tile at small batches, and K6
// (`lane_dense`, `lane_mlp`, `lane_parts`, `lane_apply`, `lane_layer_bwd`,
// `lane_mlp_bwd`, `tile_vjp`). Last, the host helpers that fill a `Stack`
// and size the tiles' shared memory. The designs are described
// at the top of csrc/coupling.cu. Everything is in an anonymous namespace:
// each source that includes this file gets its own copy.

#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

// dynamic shared memory of K4, K5 and K6, viewed as T words by each kernel
extern __shared__ __align__(16) unsigned char coupling_smem[];

namespace {

constexpr int kMaxD = 8;   // flow dimension
constexpr int kHalf = 4;   // bound of a coupling's n_A and n_B
constexpr int kMaxL = 4;   // Dense layers a conditioner, at least 2
// K4: its row tile holds kFwdRows rows, one a thread; below
// kFwdLaneMaxTiles + 1 lane tiles of R rows it takes the lane tile, with
// K5's rows (`k5_lane_rows`). A stack whose couplings' padded weights fit
// in kFwdResidentBytes is staged whole (coupling_cuda.py's FWD_ROWS,
// FWD_LANE_MAX_TILES and FWD_RESIDENT_BYTES).
constexpr int kFwdRows = 128;
constexpr int kFwdLaneMaxTiles = 64;
constexpr int kFwdResidentBytes = 48 * 1024;
// Rows R a K5/K6 lane tile holds at most, R·H threads (coupling_cuda.py's
// BWD_ROWS): 1,024 threads in float32; half that in float64, whose values
// take two registers each.
constexpr int kBwdRowsF32H16 = 64;
constexpr int kBwdRowsF32H32 = 32;
constexpr int kBwdRowsF64H16 = 32;
constexpr int kBwdRowsF64H32 = 16;
// Past kLaneMaxTiles lane tiles (about one wave on the H100's 132 SMs)
// K5 runs the row tile instead: kRowTileRows rows, one a thread, whose
// caches are unit-major with a row stride of kRowStride (coupling_cuda.py's
// LANE_MAX_TILES and ROW_TILE_ROWS).
constexpr int kLaneMaxTiles = 128;
constexpr int kRowTileRows = 64;
constexpr int kRowStride = kRowTileRows + 1;
constexpr int kReduceThreads = 256;
constexpr int kMaxLeaves = 2 * 2 * kMaxL * 2;
constexpr unsigned kWarp = 0xffffffffu;

template <typename T, int H>
__host__ __device__ constexpr int bwd_rows() {
  return sizeof(T) == 4 ? (H == 16 ? kBwdRowsF32H16 : kBwdRowsF32H32)
                        : (H == 16 ? kBwdRowsF64H16 : kBwdRowsF64H32);
}

// Rows of a lane tile holding n rows: n in whole warps (32/H rows), at most
// R (coupling_cuda.py's lane_rows).
template <typename T, int H>
int lane_rows(int64_t n) {
  constexpr int R = bwd_rows<T, H>(), per_warp = 32 / H;
  const int64_t rows = (n + per_warp - 1) / per_warp * per_warp;
  return rows < R ? (int)rows : R;
}

// Rows of K5's lane tile for a batch of n rows: n / kLaneMaxTiles, so that
// the tiles spread over the SMs, but at least 8 warps (256/H rows), whose
// latencies hide each other, and no more than the batch
// (coupling_cuda.py's k5_lane_rows).
template <typename T, int H>
int k5_lane_rows(int64_t n) {
  const int64_t spread = (n + kLaneMaxTiles - 1) / kLaneMaxTiles;
  const int64_t want = spread > 256 / H ? spread : 256 / H;
  return lane_rows<T, H>(n < want ? n : want);
}

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
  // K5/K6: rows of the lane tile, and the tile's shared-memory layout in
  // words of T
  int rows, sm_saved, sm_acts, sm_acts_net, sm_g;
  int resident;  // K4: every coupling staged at once
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

// How a kernel stores, its template parameter P (csrc/coupling.cu and
// csrc/train.cu instantiate Exact<float> and Exact<double>,
// csrc/coupling_bf16.cu and csrc/train_bf16.cu Bf16Storage): P::S stores
// x, the weights and every output in device memory, T (the kernel's type)
// is the arithmetic and what shared memory holds. Bf16Storage (bfloat16
// parameters) widens what it reads and rounds each output once; its
// partial weight gradients stay float32 until the reduce writes them. (The
// bf16 compute_dtype policy has kernels of its own, on the tensor cores:
// csrc/coupling_mma.cuh.)
template <typename T>
struct Exact {
  using S = T;
};
struct Bf16Storage {
  using S = __nv_bfloat16;
};
// a stored word widened to the arithmetic's T, and T rounded (to nearest
// even) to the stored type
template <typename T, typename S>
__device__ __forceinline__ T widen(S v) {
  return T(v);
}
template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename S, typename T>
__device__ __forceinline__ S narrow(T v) {
  return S(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16_rn(v);
}

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
// W's rows are out_bound + pad words apart: pad 0 for one row a thread
// (16-byte row loads), 1 for the lane tile, whose lane k reads row k of W
// in the backward, so that the H lanes' reads of one column fall in
// distinct banks.
__host__ __device__ constexpr int in_bound(int H, int l) {
  return l == 0 ? kHalf : H;
}
__host__ __device__ constexpr int out_bound(int H, int l, int depth) {
  return l == depth - 1 ? kHalf : H;
}
__host__ __device__ inline int layer_off(int H, int l, int pad = 0) {
  return l == 0 ? 0 : (kHalf * (H + pad) + H) + (l - 1) * (H * (H + pad) + H);
}
__host__ __device__ inline int net_words(int H, int depth, int pad = 0) {
  return layer_off(H, depth - 1, pad) + H * (kHalf + pad) + kHalf;
}
// The row tile: offset of activation level m (0: the input, depth: the
// output), unit-major
__host__ __device__ inline int row_level_off(int H, int m) {
  return m == 0 ? 0 : kRowStride * (kHalf + (m - 1) * H);
}
// The lane tile: offset of activation level m (0: the input x_B, depth: the
// output) in one net's cache of the tile's rows; a level is row-major,
// kHalf units a row at levels 0 and depth, H between
__host__ __device__ inline int level_off(int H, int m, int rows) {
  return m == 0 ? 0 : rows * (kHalf + (m - 1) * H);
}

// Block blk's s and t weights of group g into w, zero-padded, W's rows ob
// words apart (K4 and K5's row tile: one thread a row, a few warps).
template <typename T, int H, typename P = Exact<T>>
__device__ void stage(const Stack& st, int g, int blk, T* w) {
  using S = typename P::S;
  __syncthreads();  // every thread is done with the previous coupling
  const int depth = st.depth;
  int off = 0;
#pragma unroll 1
  for (int net = 0; net < 2; ++net) {
#pragma unroll 1
    for (int l = 0; l < depth; ++l) {
      const int ib = in_bound(H, l), ob = out_bound(H, l, depth);
      const int in = st.width[g][l], o = st.width[g][l + 1];
      const S* W = static_cast<const S*>(st.W[g][net][l]) +
                   (int64_t)blk * in * o;
      const S* b = static_cast<const S*>(st.b[g][net][l]) + (int64_t)blk * o;
      for (int e = threadIdx.x; e < ib * ob + ob; e += blockDim.x) {
        T v = T(0);
        if (e < ib * ob) {
          const int k = e / ob, j = e - (e / ob) * ob;
          if (k < in && j < o) v = widen<T>(W[k * o + j]);
        } else if (e - ib * ob < o) {
          v = widen<T>(b[e - ib * ob]);
        }
        w[off + e] = v;
      }
      off += ib * ob + ob;
    }
  }
  __syncthreads();
}

// Word e of one coupling's weights in the lane tile's layout (block blk of
// group g: both nets, each layer's W zero-padded with its rows ob + 1 words
// apart, then b), read from the stacked weights.
template <typename T, int H, typename P = Exact<T>>
__device__ __forceinline__ T lane_staged_word(const Stack& st, int g,
                                              int blk, int e) {
  using S = typename P::S;
  const int depth = st.depth, per_net = net_words(H, depth, 1);
  const int net = e >= per_net ? 1 : 0;
  e -= net * per_net;
  int l = 0;
#pragma unroll
  for (int k = 1; k < kMaxL; ++k)
    l += (k < depth && e >= layer_off(H, k, 1)) ? 1 : 0;
  e -= layer_off(H, l, 1);
  const int ib = in_bound(H, l), os = out_bound(H, l, depth) + 1;
  const int in = st.width[g][l], o = st.width[g][l + 1];
  if (e < ib * os) {
    const int k = e / os, j = e - (e / os) * os;
    return (k < in && j < o)
               ? widen<T>(static_cast<const S*>(
                     st.W[g][net][l])[(int64_t)blk * in * o + k * o + j])
               : T(0);
  }
  e -= ib * os;
  return e < o ? widen<T>(static_cast<const S*>(
                     st.b[g][net][l])[(int64_t)blk * o + e])
               : T(0);
}

// Block blk's s and t weights of group g into w in the lane tile's layout.
// One loop over both nets' words, each thread with kInFlight loads from
// device memory outstanding before it stores them: about one round trip a
// coupling, where a loop per layer makes one a layer.
template <typename T, int H, typename P = Exact<T>>
__device__ void lane_stage(const Stack& st, int g, int blk, T* w) {
  constexpr int kInFlight = 4;
  __syncthreads();  // every thread is done with the previous coupling
  const int n = 2 * st.wnet;
  for (int e0 = threadIdx.x; e0 < n; e0 += kInFlight * blockDim.x) {
    T v[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int e = e0 + i * blockDim.x;
      v[i] = e < n ? lane_staged_word<T, H, P>(st, g, blk, e) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int e = e0 + i * blockDim.x;
      if (e < n) w[e] = v[i];
    }
  }
  __syncthreads();
}

// K4: one layer's padded W (ib rows of OS words, in × o of them stored)
// then b (o of OS − PAD words) into w by cp.async, the padding zero-filled.
// Thread t copies words t, t + T, ... walking the padded (row, column) by
// running counters; OS is a constant, so the divisions are cheap. Stored
// bfloat16 words (widened) go by a load and a store instead: cp.async
// copies bytes as they are.
template <typename T, int OS, int PAD, typename P = Exact<T>>
__device__ __forceinline__ void stage_layer(T* w, const typename P::S* W,
                                            const typename P::S* b, int ib,
                                            int in, int o) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int size = ib * OS + OS - PAD;
  const int dk = nt / OS, dj = nt - dk * OS;
  int k = tid / OS, j = tid - k * OS;
  for (int e = tid; e < size; e += nt) {
    const bool valid = j < o && (k < in || k == ib);
    if constexpr (sizeof(typename P::S) == sizeof(T)) {
      cp_word(w + e, valid ? (k < ib ? W + k * o + j : b + j) : W, valid);
    } else {
      T v = T(0);
      if (valid) v = k < ib ? widen<T>(W[k * o + j]) : widen<T>(b[j]);
      w[e] = v;
    }
    j += dj;
    k += dk;
    if (j >= OS) j -= OS, ++k;
  }
}

// K4: block blk's s and t weights of group g into w by cp.async, without
// waiting, W's rows ob + PAD words apart (PAD 0: the row tile's 16-byte
// row loads; 1: the lane tile).
template <typename T, int H, int PAD, typename P = Exact<T>>
__device__ __forceinline__ void stage_async(const Stack& st, int g, int blk,
                                            T* w) {
  using S = typename P::S;
  const int depth = st.depth;
  int off = 0;
  // unrolled, so that the stack's parameter loads of every layer overlap
#pragma unroll
  for (int net = 0; net < 2; ++net) {
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
      if (l >= depth) continue;
      const int ib = l == 0 ? kHalf : H;
      const int in = st.width[g][l], o = st.width[g][l + 1];
      const S* W = static_cast<const S*>(st.W[g][net][l]) +
                   (int64_t)blk * in * o;
      const S* b = static_cast<const S*>(st.b[g][net][l]) + (int64_t)blk * o;
      if (l == depth - 1) {
        stage_layer<T, kHalf + PAD, PAD, P>(w + off, W, b, ib, in, o);
        off += ib * (kHalf + PAD) + kHalf;
      } else {
        stage_layer<T, H + PAD, PAD, P>(w + off, W, b, ib, in, o);
        off += ib * (H + PAD) + H;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// One row a thread (K4; K5's row tile)
// ---------------------------------------------------------------------------

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
template <typename T, int H, int IB, int OB, typename P = Exact<T>>
__device__ __forceinline__ void dense(const T* W, T (&h)[H], T (&z)[H]) {
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

template <typename T>
__device__ __forceinline__ T act(Act a, T v) {
  return a == kLeaky ? (v >= T(0) ? v : T(0.01) * v)
                     : (a == kTanh ? th(v) : v);
}

template <typename T, int H, int OB>
__device__ __forceinline__ void activate(Act a, const T (&z)[H], T (&h)[H]) {
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = act(a, j < OB ? z[j] : T(0));
}

// level m's OB values of this row into the cache (unit-major)
template <typename T, int H, int OB>
__device__ __forceinline__ void keep(T* cache, int m, int row,
                                     const T (&h)[H]) {
  if (!cache) return;
  T* c = cache + row_level_off(H, m) + row;
#pragma unroll
  for (int j = 0; j < OB; ++j) c[j * kRowStride] = h[j];
}

// One conditioner MLP (net 0: s, tanh head; net 1: t) on one row. With
// cache != nullptr every level's post-activations go to shared memory.
template <typename T, int H, typename P = Exact<T>>
__device__ __forceinline__ void mlp_row(const Stack& st, int net, const T* w,
                                        const T (&xb)[kHalf],
                                        T (&out)[kHalf], T* cache, int row) {
  T h[H], z[H];
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = j < kHalf ? xb[j < kHalf ? j : 0] : T(0);
  keep<T, H, kHalf>(cache, 0, row, h);
  const int depth = st.depth;
  dense<T, H, kHalf, H, P>(w, h, z);
  activate<T, H, H>(kLeaky, z, h);
  keep<T, H, H>(cache, 1, row, h);
#pragma unroll 1
  for (int l = 1; l < depth - 1; ++l) {
    dense<T, H, H, H, P>(w + layer_off(H, l), h, z);
    activate<T, H, H>(kLeaky, z, h);
    keep<T, H, H>(cache, l + 1, row, h);
  }
  dense<T, H, H, kHalf, P>(w + layer_off(H, depth - 1), h, z);
  activate<T, H, kHalf>(net == 0 ? kTanh : kLinear, z, h);
  keep<T, H, kHalf>(cache, depth, row, h);
#pragma unroll
  for (int k = 0; k < kHalf; ++k) out[k] = h[k];
}

// x_A, x_B, s and t of coupling g on one row's input x.
template <typename T, int H, typename P = Exact<T>>
__device__ __forceinline__ void coupling_parts(
    const Stack& st, int g, const T* w, const T (&x)[kMaxD], T (&xa)[kHalf],
    T (&xb)[kHalf], T (&s)[kHalf], T (&t)[kHalf], T* cache, int row) {
  gather(x, st.idx_a[g], xa);
  gather(x, st.idx_b[g], xb);
#pragma unroll 1
  for (int net = 0; net < 2; ++net) {
    T o[kHalf];
    mlp_row<T, H, P>(st, net, w + net * st.wnet, xb, o,
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

// K4's staging, in both tiles. Resident (st.resident): every coupling
// into its own slot before the walk, and nothing after. Otherwise two
// slots: the walk's first coupling before it, then during coupling c the
// next one (c + 1, or after a tile's last the CTA's next tile's first,
// `more`) into the other slot by cp.async, waited for after coupling c at
// the CTA's one barrier a coupling, which also frees the slot just read.
// stage_first: what the walk starts from, landed and visible on return.
template <typename T, bool INVERSE, int H, int PAD, typename P = Exact<T>>
__device__ __forceinline__ void stage_first(const Stack& st, T* buf) {
  const int words = 2 * st.wnet;
#pragma unroll 1
  for (int c = 0; c < (st.resident ? 2 * st.n_blocks : 1); ++c) {
    int g, blk;
    coupling_at<INVERSE>(st, c, g, blk);
    stage_async<T, H, PAD, P>(st, g, blk, buf + c * words);
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();
}

// stage_next: coupling c's weights; with two slots (cur the one holding
// c) the next coupling's copies started into the other.
template <typename T, bool INVERSE, int H, int PAD, typename P = Exact<T>>
__device__ __forceinline__ const T* stage_next(const Stack& st, int c,
                                               bool more, T* buf, int cur) {
  const int n_c = 2 * st.n_blocks, words = 2 * st.wnet;
  if (st.resident) return buf + c * words;
  if (c + 1 < n_c || more) {
    int g, blk;
    coupling_at<INVERSE>(st, c + 1 < n_c ? c + 1 : 0, g, blk);
    stage_async<T, H, PAD, P>(st, g, blk, buf + (cur ^ 1) * words);
  }
  cp_commit();
  return buf + cur * words;
}

// after coupling c: its successor's copies landed and visible, this
// coupling's slot free (two slots only)
__device__ __forceinline__ void stage_done(const Stack& st, int& cur) {
  if (st.resident) return;
  cp_wait_all();
  __syncthreads();
  cur ^= 1;
}

// `_mlp_bwd` of layer l (padded IB → OB) over the CTA's rows: the row's
// cotangent gc goes through the activation slope (from the cached
// post-activation: leaky-relu 1 where h ≥ 0, else 0.01; tanh' = 1 − h²),
// the CTA's partial gW = Hᵀ·G and gb = Σ_rows G go to part (first tile:
// written, later tiles: added), and gc becomes G·Wᵀ.
template <typename T, int H, int IB, int OB, typename P = Exact<T>>
__device__ __forceinline__ void layer_bwd(const Stack& st, int g, int net,
                                          int blk, int l, Act act,
                                          const T* W, const T* cache,
                                          T* gbuf, T (&gc)[H],
                                          T* __restrict__ part, bool first) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const T* h_in = cache + row_level_off(H, l);
  const T* h_out = cache + row_level_off(H, l + 1);
#pragma unroll
  for (int j = 0; j < OB; ++j) {
    const T a = h_out[j * kRowStride + tid];
    if (act == kLeaky) gc[j] = gc[j] * (a >= T(0) ? T(1) : T(0.01));
    else if (act == kTanh) gc[j] = gc[j] * (T(1) - a * a);
    gbuf[j * kRowStride + tid] = gc[j];
  }
  __syncthreads();
  // the CTA's partial weight gradient, one entry per thread at a time,
  // summed over rows 0..kRowTileRows−1 in order
  const int in = st.width[g][l], o = st.width[g][l + 1];
  const int n_w = in * o;
  const int64_t offW = st.leaf_off[g][net][l][0] + (int64_t)blk * n_w;
  const int64_t offb = st.leaf_off[g][net][l][1] + (int64_t)blk * o;
  for (int e = tid; e < n_w + o; e += blockDim.x) {
    T acc = T(0);
    int64_t dst;
    if (e < n_w) {
      const int k = e / o, j = e - (e / o) * o;
      const T* hk = h_in + k * kRowStride;
      const T* gj = gbuf + j * kRowStride;
      for (int r = 0; r < kRowTileRows; ++r)
        acc = acc + hk[r] * gj[r];
      dst = offW + e;
    } else {
      const T* gj = gbuf + (e - n_w) * kRowStride;
      for (int r = 0; r < kRowTileRows; ++r) acc = acc + gj[r];
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
template <typename T, int H, typename P = Exact<T>>
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
  layer_bwd<T, H, H, kHalf, P>(st, g, net, blk, depth - 1,
                            net == 0 ? kTanh : kLinear,
                            w + layer_off(H, depth - 1), cache, gbuf, gc,
                            part, first);
#pragma unroll 1
  for (int l = depth - 2; l >= 1; --l)
    layer_bwd<T, H, H, H, P>(st, g, net, blk, l, kLeaky, w + layer_off(H, l),
                          cache, gbuf, gc, part, first);
  layer_bwd<T, H, kHalf, H, P>(st, g, net, blk, 0, kLeaky, w, cache, gbuf, gc,
                            part, first);
#pragma unroll
  for (int k = 0; k < kHalf; ++k) gin[k] = gc[k];
}

// The row tile of the stack's VJP over the CTA's kRowTileRows rows, one row
// a thread, as K5 runs it at large batches. On entry xr holds the row's
// input, gr and gl the cotangents of the stack's output and of its
// log-det. Steps 0..C−1 recompute the forward, saving each coupling's
// input; steps C..2C−1 walk the couplings back, rebuilding one coupling's
// caches at a time (one call site for both, so the MLP code is
// instantiated once), and add the CTA's weight gradients to part (first
// tile: written). On return gr holds the row's gx.
template <typename T, bool INVERSE, int H, typename P = Exact<T>>
__device__ __forceinline__ void row_tile_vjp(const Stack& st, T* w,
                                             T* part, bool first,
                                             T (&xr)[kMaxD], T (&gr)[kMaxD],
                                             T gl) {
  T* saved = w + st.sm_saved;
  T* cache = w + st.sm_acts;
  T* gbuf = w + st.sm_g;
  const int tid = threadIdx.x;
  const int d = st.d;
  const int n_c = 2 * st.n_blocks;

#pragma unroll 1
  for (int step = 0; step < 2 * n_c; ++step) {
    const bool rev = step >= n_c;
    const int c = rev ? 2 * n_c - 1 - step : step;
    int g, blk;
    coupling_at<INVERSE>(st, c, g, blk);
    stage<T, H, P>(st, g, blk, w);
    T* sv = saved + ((int64_t)c * kRowTileRows + tid) * d;
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
    coupling_parts<T, H, P>(st, g, w, xin, xa, xb, s, t,
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
      mlp_bwd<T, H, P>(st, g, net, blk, w + net * st.wnet,
                    cache + net * st.sm_acts_net, gbuf, go, gi, part, first);
#pragma unroll
      for (int k = 0; k < kHalf; ++k) g_xb[k] = g_xb[k] + gi[k];
    }
    scatter(g_xa, st.idx_a[g], gr);
    scatter(g_xb, st.idx_b[g], gr);
  }
}

// ---------------------------------------------------------------------------
// One row on H lanes, one unit a lane (K6; K5's lane tile)
// ---------------------------------------------------------------------------
//
// Lane u of a row holds one value of each vector of the row: x_u and its
// cotangent for u < d; unit u of every layer's activation and cotangent;
// the coupling's x_A[u], s_u, t_u for u < kHalf. The row's H lanes are an
// aligned segment of a warp, so a value of another lane of the row is one
// shuffle of width H away. Every lane runs every shuffle: branches that
// depend on the lane only select values.

// v of lane src of this row
template <int H, typename T>
__device__ __forceinline__ T lane(T v, int src) {
  return __shfl_sync(kWarp, v, src, H);
}
// v of lane src, or 0 where src is −1
template <int H, typename T>
__device__ __forceinline__ T lane_or_0(T v, int src) {
  const T r = __shfl_sync(kWarp, v, src < 0 ? 0 : src, H);
  return src < 0 ? T(0) : r;
}
// idx[u] (−1 for u ≥ kHalf or a padded entry)
__device__ __forceinline__ int entry(const int (&idx)[kHalf], int u) {
  int p = -1;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) p = (u == k) ? idx[k] : p;
  return p;
}
// the k with idx[k] = j, or −1
__device__ __forceinline__ int slot(const int (&idx)[kHalf], int j) {
  int p = -1;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) p = (idx[k] == j) ? k : p;
  return p;
}

// z_u = Σ_k h_k·W[k][u], summed over k in order, then + b_u, on lane u
// (0 on lanes u ≥ OB); h_k is lane k's h. W (IB, OB), rows OB + 1 apart,
// then b, in shared memory: the row order of `dense`.
template <typename T, int H, int IB, int OB, typename P = Exact<T>>
__device__ __forceinline__ T lane_dense(const T* W, T h, int u) {
  constexpr int S = OB + 1;
  const int j = u < OB ? u : 0;
  T z = T(0);
#pragma unroll
  for (int k = 0; k < IB; ++k) z = z + lane<H>(h, k) * W[k * S + j];
  z = z + W[IB * S + j];
  return u < OB ? z : T(0);
}

// One conditioner MLP on one row, lane u's h the input x_B[u] (0 past n_B).
// With cache != nullptr every level's post-activations go to the net's
// cache at this row. Returns lane u's output (u < kHalf; 0 elsewhere).
template <typename T, int H, typename P = Exact<T>>
__device__ __forceinline__ T lane_mlp(const Stack& st, int net, const T* w,
                                      T h, T* cache, int row, int u) {
  const int depth = st.depth, rows = st.rows;
  if (cache && u < kHalf) cache[row * kHalf + u] = h;
  h = act(kLeaky, lane_dense<T, H, kHalf, H, P>(w, h, u));
  if (cache) cache[level_off(H, 1, rows) + row * H + u] = h;
#pragma unroll 1
  for (int l = 1; l < depth - 1; ++l) {
    h = act(kLeaky,
            lane_dense<T, H, H, H, P>(w + layer_off(H, l, 1), h, u));
    if (cache) cache[level_off(H, l + 1, rows) + row * H + u] = h;
  }
  h = act(net == 0 ? kTanh : kLinear,
          lane_dense<T, H, H, kHalf, P>(w + layer_off(H, depth - 1, 1), h,
                                        u));
  if (cache && u < kHalf)
    cache[level_off(H, depth, rows) + row * kHalf + u] = h;
  return h;
}

// x_A, s and t of a coupling on one row whose lane u holds xin = x_u
// (u < d), ia and ib its entry(idx_a, u) and entry(idx_b, u): lane k <
// kHalf gets x_A[k], s_k and t_k; x_B reaches every lane by shuffles and
// goes through both nets (`lane_mlp`; with keep, each net's
// post-activations are kept in cache).
template <typename T, int H, typename P = Exact<T>>
__device__ __forceinline__ void lane_parts(const Stack& st, const T* w,
                                           T xin, int ia, int ib, bool keep,
                                           T* cache, int row, int u, T& xa,
                                           T& s, T& t) {
  xa = lane_or_0<H>(xin, ia);
  const T xb = lane_or_0<H>(xin, ib);
#pragma unroll 1
  for (int net = 0; net < 2; ++net) {
    const T o = lane_mlp<T, H, P>(st, net, w + net * st.wnet, xb,
                               keep ? cache + net * st.sm_acts_net : nullptr,
                               row, u);
    if (net == 0) s = o;
    else t = o;
  }
}

// A coupling's output from its parts (n_A = na, pa = slot(idx_a, u)):
// y_A[k] on lane k goes to lane idx_a[k]'s xv, and l (on every lane) takes
// Σ s over k < n_A in order.
template <typename T, bool INVERSE, int H>
__device__ __forceinline__ void lane_apply(T xa, T s, T t, int na, int pa,
                                           T& xv, T& l) {
  const T ya = INVERSE ? (xa - t) * ex(-s) : xa * ex(s) + t;
  T sum = lane<H>(s, 0);
#pragma unroll
  for (int k = 1; k < kHalf; ++k) {
    const T sk = lane<H>(s, k);
    if (k < na) sum = sum + sk;
  }
  const T y = lane_or_0<H>(ya, pa);
  if (pa >= 0) xv = y;
  l = INVERSE ? l - sum : l + sum;
}

// `_mlp_bwd` of layer l (padded IB → OB) over the tile's rows: lane u's
// cotangent gc goes through the activation slope (from the cached
// post-activation: leaky-relu 1 where h ≥ 0, else 0.01; tanh' = 1 − h²),
// the tile's partial gW = Hᵀ·G and gb = Σ_rows G go to part (first tile:
// written, later tiles: added), one thread an entry summing the rows in
// order, and lane k gets the input cotangent Σ_j gc_j·W[k][j], summed over
// j in order (0 on lanes k ≥ IB).
template <typename T, int H, int IB, int OB, typename P = Exact<T>>
__device__ __forceinline__ T lane_layer_bwd(const Stack& st, int g, int net,
                                            int blk, int l, Act a, const T* W,
                                            const T* cache, T* gbuf, T gc,
                                            T* __restrict__ part, bool first,
                                            int row, int u) {
  constexpr int S = OB + 1;
  const int rows = st.rows;
  if (u < OB) {
    const T h = cache[level_off(H, l + 1, rows) + row * OB + u];
    if (a == kLeaky) gc = gc * (h >= T(0) ? T(1) : T(0.01));
    else if (a == kTanh) gc = gc * (T(1) - h * h);
  }
  gbuf[row * H + u] = gc;
  __syncthreads();
  const T* h_in = cache + level_off(H, l, rows);
  const int in = st.width[g][l], o = st.width[g][l + 1];
  const int n_w = in * o;
  const int64_t offW = st.leaf_off[g][net][l][0] + (int64_t)blk * n_w;
  const int64_t offb = st.leaf_off[g][net][l][1] + (int64_t)blk * o;
  for (int e = threadIdx.x; e < n_w + o; e += blockDim.x) {
    T acc = T(0);
    int64_t dst;
    if (e < n_w) {
      const int k = e / o, j = e - (e / o) * o;
#pragma unroll 8
      for (int r = 0; r < rows; ++r)
        acc = acc + h_in[r * IB + k] * gbuf[r * H + j];
      dst = offW + e;
    } else {
      const int j = e - n_w;
#pragma unroll 8
      for (int r = 0; r < rows; ++r) acc = acc + gbuf[r * H + j];
      dst = offb + j;
    }
    part[dst] = first ? acc : part[dst] + acc;
  }
  const int k = u < IB ? u : 0;
  T gn = T(0);
#pragma unroll
  for (int j = 0; j < OB; ++j) gn = gn + lane<H>(gc, j) * W[k * S + j];
  __syncthreads();  // gbuf is the next layer's
  return u < IB ? gn : T(0);
}

// `_mlp_bwd` of one net of coupling (g, blk): lane u's output cotangent
// (u < kHalf) → its input cotangent (u < kHalf).
template <typename T, int H, typename P = Exact<T>>
__device__ __forceinline__ T lane_mlp_bwd(const Stack& st, int g, int net,
                                          int blk, const T* w, const T* cache,
                                          T* gbuf, T gc, T* __restrict__ part,
                                          bool first, int row, int u) {
  const int depth = st.depth;
  gc = lane_layer_bwd<T, H, H, kHalf, P>(st, g, net, blk, depth - 1,
                                      net == 0 ? kTanh : kLinear,
                                      w + layer_off(H, depth - 1, 1), cache,
                                      gbuf, gc, part, first, row, u);
#pragma unroll 1
  for (int l = depth - 2; l >= 1; --l)
    gc = lane_layer_bwd<T, H, H, H, P>(st, g, net, blk, l, kLeaky,
                                    w + layer_off(H, l, 1), cache, gbuf, gc,
                                    part, first, row, u);
  return lane_layer_bwd<T, H, kHalf, H, P>(st, g, net, blk, 0, kLeaky, w, cache,
                                        gbuf, gc, part, first, row, u);
}

// The lane tile of the stack's VJP over st.rows rows, H lanes a row, as K6
// and K5 at small batches run it. On entry lane u's xv holds x_u of its row and gv the
// cotangent of the stack's output y_u (u < d; 0 on the other lanes), gl the
// cotangent of the row's log-det. Steps 0..C−1 recompute the forward,
// saving each coupling's input and summing the row's log-det; then
// cot(y_u, ld, gv, gl) may set the cotangents from the row's output and
// log-det (K6; K5's cot does nothing), on every lane; steps C..2C−1 walk
// the couplings back, rebuilding one coupling's caches at a time (one call
// site for both, so the MLP code is instantiated once), and add the tile's
// weight gradients to part (first tile: written). On return gv holds gx_u.
template <typename T, bool INVERSE, int H, typename P = Exact<T>,
          typename Cot>
__device__ __forceinline__ void tile_vjp(const Stack& st, T* w, T* part,
                                         bool first, T& xv, T& gv, T gl,
                                         Cot cot) {
  T* saved = w + st.sm_saved;
  T* cache = w + st.sm_acts;
  T* gbuf = w + st.sm_g;
  const int row = threadIdx.x / H, u = threadIdx.x % H;
  const int d = st.d;
  const int n_c = 2 * st.n_blocks;
  T l = T(0);

#pragma unroll 1
  for (int step = 0; step < 2 * n_c; ++step) {
    const bool rev = step >= n_c;
    if (step == n_c) cot(xv, l, gv, gl);
    const int c = rev ? 2 * n_c - 1 - step : step;
    int g, blk;
    coupling_at<INVERSE>(st, c, g, blk);
    lane_stage<T, H, P>(st, g, blk, w);
    T* sv = saved + ((int64_t)c * st.rows + row) * d;
    T xin = T(0);
    if (!rev) {
      xin = xv;
      if (u < d) sv[u] = xv;
    } else if (u < d) {
      xin = sv[u];
    }
    const int ia = entry(st.idx_a[g], u), ib = entry(st.idx_b[g], u);
    T xa, s = T(0), t = T(0);
    lane_parts<T, H, P>(st, w, xin, ia, ib, rev, cache, row, u, xa, s, t);
    const int na = st.width[g][st.depth];
    const int pa = slot(st.idx_a[g], u);
    if (!rev) {
      lane_apply<T, INVERSE, H>(xa, s, t, na, pa, xv, l);
      continue;
    }
    // `_coupling_bwd` on lane k < kHalf: gld reaches every coupling's s
    const T g_ya = lane_or_0<H>(gv, ia);
    T g_xb = lane_or_0<H>(gv, ib);
    T g_xa, g_s, g_t;
    if (INVERSE) {
      const T e = ex(-s);
      g_xa = g_ya * e;
      g_t = -g_xa;
      g_s = -g_ya * (xa - t) * e - gl;
    } else {
      const T e = ex(s);
      g_xa = g_ya * e;
      g_t = g_ya;
      g_s = g_ya * xa * e + gl;
    }
    // padded outputs of s and t take no cotangent
    if (u >= na) g_s = g_t = T(0);
    // g_xb + (s net's input cotangent) + (t net's), in that order
#pragma unroll 1
    for (int net = 0; net < 2; ++net)
      g_xb = g_xb + lane_mlp_bwd<T, H, P>(st, g, net, blk, w + net * st.wnet,
                                       cache + net * st.sm_acts_net, gbuf,
                                       net == 0 ? g_s : g_t, part, first, row,
                                       u);
    const int pb = slot(st.idx_b[g], u);
    const T from_a = lane_or_0<H>(g_xa, pa);
    const T from_b = lane_or_0<H>(g_xb, pb);
    if (pa >= 0) gv = from_a;
    if (pb >= 0) gv = from_b;
  }
}

// ---------------------------------------------------------------------------
// Host helpers
// ---------------------------------------------------------------------------

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

// K4's shared memory, set in st: every coupling's padded weights (both
// nets) where they fit in kFwdResidentBytes, else two couplings', W's rows
// one word apart more in the lane tile's; returns its size in words of T.
template <typename T, int H>
int fwd_words(Stack& st, int lanes) {
  st.wnet = net_words(H, st.depth, lanes ? 1 : 0);
  const int64_t stack = (int64_t)2 * st.n_blocks * 2 * st.wnet;
  st.resident = stack * (int64_t)sizeof(T) <= kFwdResidentBytes;
  return st.resident ? (int)stack : 2 * 2 * st.wnet;
}

// The row tile's shared-memory layout, set in st; returns its size in
// words of T: one coupling's padded weights | saved inputs | the
// coupling's activations (two nets) | one layer's cotangents.
template <int H>
int row_bwd_words(Stack& st) {
  st.sm_saved = 2 * st.wnet;
  st.sm_acts = st.sm_saved + 2 * st.n_blocks * kRowTileRows * st.d;
  st.sm_acts_net = row_level_off(H, st.depth) + kRowStride * kHalf;
  st.sm_g = st.sm_acts + 2 * st.sm_acts_net;
  return st.sm_g + kRowStride * H;
}

// The lane tile's shared-memory layout for st.rows rows, set in st;
// returns its size in words of T: one coupling's padded weights (rows of
// W one word apart more than K4's) | every coupling's saved input (rows ×
// d) | the coupling's activations (two nets) | one layer's cotangents
// (rows × H).
template <int H>
int lane_bwd_words(Stack& st) {
  st.wnet = net_words(H, st.depth, 1);
  st.sm_saved = 2 * st.wnet;
  st.sm_acts = st.sm_saved + 2 * st.n_blocks * st.rows * st.d;
  st.sm_acts_net = level_off(H, st.depth, st.rows) + st.rows * kHalf;
  st.sm_g = st.sm_acts + 2 * st.sm_acts_net;
  return st.sm_g + st.rows * H;
}

}  // namespace
