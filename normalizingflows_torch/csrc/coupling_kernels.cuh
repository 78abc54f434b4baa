// Fused RealNVP coupling-stack kernels for Hopper (sm_90a): the kernels
// and their launchers, templated on the arithmetic T and the storage and
// rounding policy P (csrc/coupling_device.cuh). The C entries are in
// csrc/coupling.cu (float32, float64) and csrc/coupling_bf16.cu (the bf16
// compute_dtype policy and bfloat16 parameters), built side by side.
//
// What each entry replaces (normalizingflows/jl_tpu/experimental/
// coupling_pallas.py):
//   K4  coupling_fwd_lanes         `_fwd_kernel` (`_tile_flow`), launched by
//       or coupling_fwd            `_call_fwd`: the whole stack of affine
//       <T, INVERSE, H>            couplings, forward or inverse, with the
//                                  running log-det, in one launch (the lane
//                                  or the row tile, below).
//   K5  coupling_bwd<T, INVERSE>   `_bwd_kernel`, launched by `_call_bwd`:
//       or coupling_bwd_rows       the hand-written backward (the lane or
//       + coupling_bwd_reduce<T>   the row tile, below). It recomputes
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
// compare-and-select (one row a thread) or shuffles (the lane tile) so that
// they stay in registers (the Pallas kernel's one-hot selection products
// exist only for the TPU's matrix unit).
//
// What bounds them on this card: operations, and at small batches the
// length of each thread's dependent chain. At the demo shape (d=2,
// [16,16]×3) K4 does 3,456 multiply-adds a row against 5 words of traffic
// (x in, y and ld out); K5 about four times that against 2d+1 words in and
// d out, plus the weight gradients. Both are far above the H100's balance
// point of ~20 flop/byte, so the bound is the CUDA cores' float32
// (float64) rate; no tensor cores in this version. The main paths run 16
// to 256 rows, too few to fill the card, so what the time follows there is
// how long one row's chain of dependent operations is.
//
// Shared by both: layer widths are padded to compile-time bounds, so
// register arrays are never indexed at run time: a coupling's n_A and n_B
// (the MLP's input and output) to 4 (so d ≤ 8), hidden widths to H = 16
// or 32 (a template parameter, the smaller that fits), 2 to 4 Dense layers.
// The weights of a coupling (its s and t MLPs for one block) are staged in
// shared memory, zero-padded to those bounds. Padded weights are zeros, so
// padded units stay 0. K5 stages one coupling at a time between two
// barriers: the reference default in float64 would need 369 KB to keep
// every block's weights resident, over the 227 KB a block may use. K4
// copies by cp.async (4- or 8-byte copies, the padding zero-filled by the
// copy; `stage_async`): a stack that fits in kFwdResidentBytes (the demo's
// 6 couplings: 20–22 KB in float32) is staged whole once, with no barrier
// after; a larger one in two slots, coupling c + 1 copied into one while
// coupling c computes from the other, one barrier a coupling and no wait
// on device memory between couplings (`stage_next`).
//
// K4 has two tiles, picked from the batch alone (coupling_cuda.py's
// fwd_plan, passed to the C entry as `lanes`). Up to kFwdLaneMaxTiles = 64
// lane tiles of R rows (where the two tiles' times cross for the demo and
// the reference default on the card, chip_smoke.py phase 12), the lane
// tile: K5's, below, with K5's rows a tile, running `tile_vjp`'s forward
// steps (`lane_parts`, `lane_apply`): a row's chain is one column's IB
// multiply-adds a layer where one thread a row walked IB×OB, and the
// reference default's 256 rows spread over 32 CTAs of 8 rows where one row
// a thread gave 2 CTAs. Past that, the row tile: one
// thread per batch row, its d values and its layer activations in
// registers, every thread reading the weights as 16-byte broadcasts. With
// the stack resident, as many CTAs as fit on the SMs at once walk the row
// tiles c, c + G, ..., so that each stages the stack once. Both tiles sum
// every product in `dense`'s order and contract a*b+c the same way, so
// they give the same bits.
//
// K5 has two tiles and picks one by the batch. Small batches (at most
// kLaneMaxTiles = 128 lane tiles, about one wave on the 132 SMs) take the
// lane tile: one row on H lanes, one hidden unit a lane (`tile_vjp` in
// csrc/coupling_device.cuh), batch/128 rows a tile so that the tiles spread
// over the SMs, but at least 8 warps and at most R rows (R = 64 at H=16 and
// 32 at H=32 in float32, 1,024 threads; half in float64): thread t is row
// t / H, lane u = t % H. Lane u
// owns unit u of every layer, so a Dense layer is, per lane, one column's
// chain of IB shuffles and multiply-adds (h_k from lane k) where one
// thread a row walked IB×OB, and the backward's input cotangent one row of
// W against OB shuffled cotangents; the per-row formulas of the coupling
// run on lanes k < n_A, and x_A, x_B and the scatter back are shuffles.
// The forward and the input cotangent sum in the row design's orders. W's
// rows are staged one word apart more than K4's, so the H lanes reading
// one column of W (the input cotangent) hit distinct banks. Large batches
// take the row tile, one row a thread on 64 rows (`row_tile_vjp`): the
// lane tile spends a shuffle and a load on every multiply-add where a
// thread a row spends a quarter of a 16-byte broadcast load, so once the
// batch fills the card, and the time is the issue rate, not one row's
// chain, the row tile is the faster (2.8× at 262,144 rows of the demo on an
// NVIDIA H100 80GB HBM3 at 700 W, benchmarks/torch_ab.py).
//
// Both keep in shared memory what the weight-gradient product gW = Hᵀ·G
// over the tile's rows needs: the rows' coupling inputs (rows × couplings
// × d), the current coupling's post-activations (the lane tile row-major:
// the lanes of a row write neighbouring words; the row tile unit-major
// with a row stride of 65) and the current layer's cotangents. The
// product runs one thread per weight entry, summing over the tile's rows
// in order. The batch sum is fixed in order and uses no atomics: CTA c
// walks row tiles c, c + G, c + 2G, ... and accumulates its partial gW/gb
// in its own slice of a scratch buffer (first tile writes, later tiles
// add), then coupling_bwd_reduce sums the G slices in CTA order. Two runs
// give the same bits.
//
// Unlike csrc/rqs.cu this file is built with a*b+c contracted to FMA: the
// comparison with the plain version is within tolerances anyway, since
// cuBLAS sums its products in another order.
//
// The device code below the kernels (staging, the row and lane functions,
// K5's two tiles) is in csrc/coupling_device.cuh, which csrc/train.cu (K6,
// the whole training run, on the lane tile) includes too.

#pragma once
#include "coupling_device.cuh"

namespace {

// K4's row tile at large batches: kFwdRows rows a tile, one a thread, its
// d values and its layer activations in registers, the weights read as
// 16-byte broadcasts. CTA c walks row tiles c, c + G, ... (`stage_next`).
// Asking for 4 CTAs an SM at H=16 leaves ptxas 128 registers, 2 at H=32
// 255: without a minimum it kept the float32 kernels to 80 and 128 and
// spilled.
template <typename T, bool INVERSE, int H, typename P>
__global__ void __launch_bounds__(kFwdRows, H == 16 ? 4 : 2)
coupling_fwd(const typename P::S* __restrict__ x,
             typename P::S* __restrict__ y, typename P::S* __restrict__ ld,
             int64_t n, const __grid_constant__ Stack st) {
  using S = typename P::S;
  T* buf = reinterpret_cast<T*>(coupling_smem);
  const int d = st.d, n_c = 2 * st.n_blocks;
  const int64_t tiles = (n + kFwdRows - 1) / kFwdRows;
  stage_first<T, INVERSE, H, 0, P>(st, buf);
  int cur = 0;
#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row = tile * kFwdRows + threadIdx.x;
    const bool active = row < n, more = tile + gridDim.x < tiles;
    T xr[kMaxD];
#pragma unroll
    for (int j = 0; j < kMaxD; ++j)
      xr[j] = (active && j < d) ? widen<T>(x[row * d + j]) : T(0);
    T l = T(0);
#pragma unroll 1
    for (int c = 0; c < n_c; ++c) {
      const T* w = stage_next<T, INVERSE, H, 0, P>(st, c, more, buf, cur);
      int g, blk;
      coupling_at<INVERSE>(st, c, g, blk);
      T xa[kHalf], xb[kHalf], s[kHalf], t[kHalf];
      coupling_parts<T, H, P>(st, g, w, xr, xa, xb, s, t, nullptr, 0);
      const T sum = apply_coupling<T, INVERSE>(st, g, xa, s, t, xr);
      l = INVERSE ? l - sum : l + sum;
      stage_done(st, cur);
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < kMaxD; ++j)
        if (j < d) y[row * d + j] = narrow<S>(xr[j]);
      ld[row] = narrow<S>(l);
    }
  }
}

// K4's lane tile at small batches: st.rows rows a tile on st.rows·H
// threads, one row on H lanes (thread t: row t / H, lane u = t % H), the
// forward steps of `tile_vjp` (`lane_parts` without a cache, `lane_apply`).
template <typename T, bool INVERSE, int H, typename P>
__global__ void __launch_bounds__(bwd_rows<T, H>() * H, 1)
coupling_fwd_lanes(const typename P::S* __restrict__ x,
                   typename P::S* __restrict__ y,
                   typename P::S* __restrict__ ld, int64_t n,
                   const __grid_constant__ Stack st) {
  using S = typename P::S;
  T* buf = reinterpret_cast<T*>(coupling_smem);
  const int d = st.d, n_c = 2 * st.n_blocks;
  const int rows = st.rows, row = threadIdx.x / H, u = threadIdx.x % H;
  const int64_t tiles = (n + rows - 1) / rows;
  stage_first<T, INVERSE, H, 1, P>(st, buf);
  int cur = 0;
#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t r = tile * rows + row;
    const bool active = r < n, more = tile + gridDim.x < tiles;
    // rows past the end get x = 0 and write nothing
    T xv = (active && u < d) ? widen<T>(x[r * d + u]) : T(0);
    T l = T(0);
#pragma unroll 1
    for (int c = 0; c < n_c; ++c) {
      const T* w = stage_next<T, INVERSE, H, 1, P>(st, c, more, buf, cur);
      int g, blk;
      coupling_at<INVERSE>(st, c, g, blk);
      T xa, s, t;
      lane_parts<T, H, P>(st, w, xv, entry(st.idx_a[g], u),
                       entry(st.idx_b[g], u), false, nullptr, row, u, xa, s,
                       t);
      lane_apply<T, INVERSE, H>(xa, s, t, st.width[g][st.depth],
                                slot(st.idx_a[g], u), xv, l);
      stage_done(st, cur);
    }
    if (active && u < d) y[r * d + u] = narrow<S>(xv);
    if (active && u == 0) ld[r] = narrow<S>(l);
  }
}

// K5's lane tile at small batches, first pass: gx per row and each CTA's
// partial weight gradients, one tile of st.rows rows on st.rows·H threads
// at a time (`tile_vjp`).
template <typename T, bool INVERSE, int H, typename P>
__global__ void __launch_bounds__(bwd_rows<T, H>() * H, 1)
coupling_bwd(const typename P::S* __restrict__ x,
             const typename P::S* __restrict__ gy,
             const typename P::S* __restrict__ gld,
             typename P::S* __restrict__ gx, T* __restrict__ scratch,
             int64_t n, int64_t n_params, const __grid_constant__ Stack st) {
  using S = typename P::S;
  const int rows = st.rows;
  T* w = reinterpret_cast<T*>(coupling_smem);
  T* part = scratch + (int64_t)blockIdx.x * n_params;
  const int row = threadIdx.x / H, u = threadIdx.x % H;
  const int d = st.d;
  const int64_t tiles = (n + rows - 1) / rows;

#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t r = tile * rows + row;
    const bool active = r < n;
    // rows past the end get x = 0 and zero cotangents: they add exactly 0
    const bool mine = active && u < d;
    T xv = mine ? widen<T>(x[r * d + u]) : T(0);
    T gv = mine ? widen<T>(gy[r * d + u]) : T(0);
    const T gl = active ? widen<T>(gld[r]) : T(0);
    tile_vjp<T, INVERSE, H, P>(st, w, part, tile == blockIdx.x, xv, gv, gl,
                               [](T, T, T&, T&) {});
    if (mine) gx[r * d + u] = narrow<S>(gv);
  }
}

// K5's row tile at large batches, first pass: gx per row and each CTA's
// partial weight gradients, kRowTileRows rows a tile, one a thread
// (`row_tile_vjp`). Asking for 6 CTAs an SM at H=16 leaves ptxas 168
// registers (12 warps, 3 on one of the SM's four register files), 4 at
// H=32 leaves 255: what the float32 instantiations take without spills.
template <typename T, bool INVERSE, int H, typename P>
__global__ void __launch_bounds__(kRowTileRows, H == 16 ? 6 : 4)
coupling_bwd_rows(const typename P::S* __restrict__ x,
                  const typename P::S* __restrict__ gy,
                  const typename P::S* __restrict__ gld,
                  typename P::S* __restrict__ gx, T* __restrict__ scratch,
                  int64_t n, int64_t n_params,
                  const __grid_constant__ Stack st) {
  using S = typename P::S;
  T* w = reinterpret_cast<T*>(coupling_smem);
  T* part = scratch + (int64_t)blockIdx.x * n_params;
  const int tid = threadIdx.x;
  const int d = st.d;
  const int64_t tiles = (n + kRowTileRows - 1) / kRowTileRows;

#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row = tile * kRowTileRows + tid;
    const bool active = row < n;
    // rows past the end get x = 0 and zero cotangents: they add exactly 0
    T xr[kMaxD], gr[kMaxD];
#pragma unroll
    for (int j = 0; j < kMaxD; ++j) {
      xr[j] = (active && j < d) ? widen<T>(x[row * d + j]) : T(0);
      gr[j] = (active && j < d) ? widen<T>(gy[row * d + j]) : T(0);
    }
    const T gl = active ? widen<T>(gld[row]) : T(0);
    row_tile_vjp<T, INVERSE, H, P>(st, w, part, tile == blockIdx.x, xr, gr,
                                   gl);
    if (active) {
#pragma unroll
      for (int j = 0; j < kMaxD; ++j)
        if (j < d) gx[row * d + j] = narrow<S>(gr[j]);
    }
  }
}

// K5, second pass: sum the G partial slices in CTA order into the stacked
// gradient buffers, each rounded once to S.
template <typename T, typename S>
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
  static_cast<S*>(gt.ptr[i])[p - gt.off[i]] = narrow<S>(acc);
}

// K4 on the lane tile (lanes) or the row tile; the caller picks the tile
// (coupling_cuda.py's fwd_plan: the lane tile while n is at most
// kFwdLaneMaxTiles lane tiles). A CTA's tile rows are K5's (k5_lane_rows)
// or kFwdRows. The grid is a CTA a tile; with the stack resident, at most
// as many CTAs as fit on the SMs at once, each staging the stack once for
// all its tiles. With two slots a CTA a tile: CTAs that walk several tiles
// copy in step with each other and ran slower than the hardware's own
// scheduling of one tile a CTA.
template <typename T, int H, typename P>
int launch_fwd_h(const typename P::S* x, typename P::S* y,
                 typename P::S* ld, int64_t n, Stack& st, int lanes,
                 int inverse, cudaStream_t stream) {
  st.rows = lanes ? k5_lane_rows<T, H>(n) : kFwdRows;
  const size_t smem = sizeof(T) * (size_t)fwd_words<T, H>(st, lanes);
  const auto kern =
      lanes ? (inverse ? &coupling_fwd_lanes<T, true, H, P>
                       : &coupling_fwd_lanes<T, false, H, P>)
            : (inverse ? &coupling_fwd<T, true, H, P>
                       : &coupling_fwd<T, false, H, P>);
  int err = allow_smem((const void*)kern, smem);
  if (err) return err;
  const int threads = lanes ? st.rows * H : kFwdRows;
  const int64_t tiles = (n + st.rows - 1) / st.rows;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (err) return err;
  int64_t grid = tiles;
  if (st.resident && tiles > sms) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, threads, smem);
    if (err) return err;
    const int64_t fit = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
    grid = tiles < fit ? tiles : fit;
  }
  kern<<<(unsigned)grid, threads, smem, stream>>>(x, y, ld, n, st);
  return (int)cudaGetLastError();
}

template <typename T, typename P = Exact<T>>
int launch_fwd(const void* x, void* y, void* ld, int64_t n, int d,
               int n_blocks, int depth, const int* widths, const int* idx,
               const void* const* weights, int lanes, int inverse,
               void* stream) {
  Stack st;
  int H = 0;
  const int err = make_stack(st, H, d, n_blocks, depth, widths, idx, weights);
  if (err) return err;
  if (lanes != 0 && lanes != 1) return kInvalid;
  if (n <= 0) return 0;
  using S = typename P::S;
  const auto xp = static_cast<const S*>(x);
  const auto yp = static_cast<S*>(y), lp = static_cast<S*>(ld);
  const auto cs = static_cast<cudaStream_t>(stream);
  return H == 16
             ? launch_fwd_h<T, 16, P>(xp, yp, lp, n, st, lanes, inverse, cs)
             : launch_fwd_h<T, 32, P>(xp, yp, lp, n, st, lanes, inverse, cs);
}

// K5's first pass: the lane tile while the batch is at most kLaneMaxTiles
// lane tiles (coupling_cuda.py's uses_lane_tile), else the row tile.
template <typename T, int H, typename P>
int launch_bwd_h(const typename P::S* x, const typename P::S* gy,
                 const typename P::S* gld, typename P::S* gx, T* scratch,
                 int64_t n, int64_t n_params, Stack& st, int n_ctas,
                 int inverse, cudaStream_t stream) {
  constexpr int R = bwd_rows<T, H>();
  const bool lanes = (n + R - 1) / R <= kLaneMaxTiles;
  const int rows = lanes ? k5_lane_rows<T, H>(n) : kRowTileRows;
  if (n_ctas < 1 || n_ctas > (n + rows - 1) / rows) return kInvalid;
  st.rows = rows;
  const size_t smem = sizeof(T) * (size_t)(lanes ? lane_bwd_words<H>(st)
                                                 : row_bwd_words<H>(st));
  const auto kern =
      lanes ? (inverse ? &coupling_bwd<T, true, H, P>
                       : &coupling_bwd<T, false, H, P>)
            : (inverse ? &coupling_bwd_rows<T, true, H, P>
                       : &coupling_bwd_rows<T, false, H, P>);
  const int err = allow_smem((const void*)kern, smem);
  if (err) return err;
  kern<<<(unsigned)n_ctas, lanes ? rows * H : kRowTileRows, smem, stream>>>(
      x, gy, gld, gx, scratch, n, n_params, st);
  return (int)cudaGetLastError();
}

template <typename T, typename P = Exact<T>>
int launch_bwd(const void* x, const void* gy, const void* gld, void* gx,
               void* scratch, int64_t n, int d, int n_blocks, int depth,
               const int* widths, const int* idx, const void* const* weights,
               void* const* grads, int n_ctas, int inverse, void* stream) {
  Stack st;
  int H = 0;
  int err = make_stack(st, H, d, n_blocks, depth, widths, idx, weights);
  if (err) return err;
  if (n <= 0) return 0;

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
  using S = typename P::S;
  const auto xp = static_cast<const S*>(x);
  const auto gyp = static_cast<const S*>(gy);
  const auto glp = static_cast<const S*>(gld);
  const auto gxp = static_cast<S*>(gx);
  const auto sp = static_cast<T*>(scratch);
  err = H == 16 ? launch_bwd_h<T, 16, P>(xp, gyp, glp, gxp, sp, n, n_params,
                                         st, n_ctas, inverse, cs)
                : launch_bwd_h<T, 32, P>(xp, gyp, glp, gxp, sp, n, n_params,
                                         st, n_ctas, inverse, cs);
  if (err) return err;
  const unsigned grid =
      (unsigned)((n_params + kReduceThreads - 1) / kReduceThreads);
  coupling_bwd_reduce<T, S><<<grid, kReduceThreads, 0, cs>>>(sp, n_ctas,
                                                             n_params, gt);
  return (int)cudaGetLastError();
}

}  // namespace
