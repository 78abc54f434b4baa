// K4/K5 under the bf16 compute_dtype policy, on Hopper's float64 and
// bfloat16 tensor cores: the C entries coupling_fwd_f32_cbf16 and
// coupling_bwd_f32_cbf16 (csrc/coupling_bf16.cu) launch coupling_fwd_dmma
// and coupling_bwd_dmma (+ coupling_bwd_reduce, csrc/coupling_kernels.cuh).
//
// What they replace (normalizingflows/jl_tpu/experimental/
// coupling_pallas.py), under compute_dtype=bfloat16: K4 the Pallas
// `_fwd_kernel` (`_tile_flow`, `pallas_call` at :371), K5 `_bwd_kernel`
// (`_mlp_bwd` at :202, `pallas_call` at :438). The policy's product is
// `_dot(a, b, cd)` (:80-89): bfloat16 operands summed in float32, "one
// native MXU pass" on the TPU. The selections, the bias adds, the
// activations and the coupling's own arithmetic stay exact float32, as
// `_dot` leaves them.
//
// The sums. Every product whose result is rounded to bfloat16 downstream
// (a layer's pre-activation, through its activation; the heads, through
// y_A and the next coupling's x_B; an input cotangent, through the next G)
// is the exact sum of its bfloat16 products rounded once to float32, the
// float64-summed witness's arithmetic (`chip_smoke._dot_witness`): a
// product one ulp off it flips one such rounding in 2^16, and over the
// demo's 262,144 rows a flipped row, now and then across a leaky ReLU's
// kink, puts a weight gradient far from the plain version where the
// witness stands near it (the bfloat16 tensor core's sum, with the bias as
// its addend: 1,179 times the witness's error on one draw;
// benchmarks/torch_leaf_scan.py on an H100). The bfloat16 mma.sync cannot
// give the exact sum: it aligns its addends to the largest and cuts each
// below 2^(E − 25) (chip_smoke.py phase 59). The float64 one can: a
// product of two bfloat16 is exact in float64, and chip_smoke.py phase 60
// measured mma.sync.m16n8k16 .f64 (and m16n8k4) on the H100 as a chain of
// fused multiply-adds rounded to nearest, so a sum that spans at most 53
// bits is exact in any order. So those products run on the float64
// tensor cores (`prod_k16`, `prod_k4`), from zero, each sum rounded once
// to float32; the weight gradients, which only sum over the rows, run on
// the bfloat16 tensor cores, each k16 product rounded to nearest
// (`mma_rn`).
//
// What bounds them on this card: not the products' count. At the demo's
// 262,144 rows K5 needs about 3.7 GMAC, 0.11 ms at the float64 tensor
// cores' 67 TFLOP/s were they all float64; the padding to the mma's
// shapes (a head of n_A ≤ 4 outputs in an n8 tile, layer 0's n_B ≤ 4
// inputs in a k4), the float64 mma's k taken in sequence (phase 60), the
// float32 work around each product (bias, leaky ReLU, the roundings, tanh
// and exp, the gathers), the bfloat16 weight-gradient passes and at 16 to
// 256 rows the length of one tile's dependent chain (the weights'
// staging, then per coupling its layers) set the pace
// (benchmarks/torch_ab.py --parts times each part by knocking it out).
//
// The design: one warp, one tile of 16 rows (the mma's M). A CTA is
// kMmaWarps warps, 16·kMmaWarps rows, sharing the staged weights. The
// rows' d ≤ 8 values sit in the warp's shared array (16 rows × kXs
// float32) and are picked by index reads.
// * Weights: each coupling's s and t nets, zero-padded to the kernels'
//   bounds (n_A, n_B ≤ 4, H = 16 or 32, 2 to 4 layers), are rounded to
//   bfloat16 once, as they are staged (the float32 kernels' rounding point
//   of W), widened exactly to float64 and stored transposed, Wᵀ (out,
//   in): layer 0's H rows of 4 (the n_B ≤ 4 inputs), each hidden layer's
//   H rows of H + 4, the head's 4 rows (n_A ≤ 4) of H + 4. A row is 4
//   doubles past a multiple of 16, so a quad's 8-byte fragment reads fall
//   in distinct banks both along a row (the forward's B) and down a column
//   (the input cotangent's). Biases stay float32. A stack that fits in
//   shared memory beside the rest is staged whole once a CTA, straight
//   from device memory (kStageLoads loads in flight a thread); a larger
//   one a coupling at a time between barriers: its float32 words land by
//   cp.async in a landing slot (every copy in flight at once, none holding
//   a register), and a pass within shared memory rounds, widens and
//   transposes them into the staged layout.
// * A layer's values between products are bfloat16 pairs in the mma's C
//   layout (lane (g, t): rows g, g + 8, columns 2t, 2t + 1 of each n8
//   tile): the float64 C of a product rounded once to float32, the bias
//   added, the leaky ReLU (slope 0.01) taken in float32 and rounded to
//   bfloat16 (`mma_layer`). The next product's float64 A fragment wants
//   k t, t + 4, t + 8, t + 12 of each k16 (`gather`): 8 quad shuffles a
//   k16, each value widened to float64 by one cvt (`widen`).
//   The activations never leave registers.
// * Layer 0 takes x_B (n_B ≤ 4) as one m16n8k4 an n8 tile; the head's
//   n_A ≤ 4 outputs fill half an n8 tile (lane (g, t) with t < 2 holds s
//   and t of k = 2t, 2t+1 at rows g and g + 8): tanh, exp, y_A =
//   x_A·exp(s) + t, written back by index; ld += Σ s is one shuffle within
//   the quad. The inverse keeps the float32 kernels' order: blocks last to
//   first, the odd coupling before the even one.
// * K5 recomputes the forward keeping each coupling's input in shared
//   memory, then per coupling from the last: rebuilds the conditioners,
//   writing each layer's input (bfloat16, the rounded value the product
//   takes) to shared memory; then per net and layer from the head down,
//   G = gc ⊙ slope (float32; the slope from the kept post-activation, 1
//   where it is ≥ 0), the input cotangent round(G)·Wᵀ on the float64
//   tensor cores (the head's by m16n8k4 over its n_A ≤ 4 outputs), and,
//   after one barrier, the weight gradient gW = Hᵀ·G over the CTA's 16·w
//   rows as the bfloat16 mma's k dimension: round(G) and the kept H are
//   read back as fragments by ldmatrix.trans. gb = Σ_rows G is an exact
//   float32 sum (a butterfly within each warp, then the warps in order).
//   Each CTA sums its tiles' gradients (its first tile writes, later tiles
//   add) in shared memory where they fit, else in its own slice of the
//   scratch buffer, and copies them to its slice; coupling_bwd_reduce sums
//   the slices in CTA order. K5 launches no more CTAs than fit at once. No
//   atomics, so two runs give the same bits.
// * Rounding points are the float32 kernels' policy's: W once at staging,
//   a layer's input and its cotangent once a layer, gW's two operands at
//   use. A row's outputs (y, ld, gx) depend on that row alone.
// Why not wgmma or TMA: a conditioner's k is 4 to 32 and its n 4 to 32. A
// wgmma takes 64-row tiles from a warpgroup with B in shared memory, so at
// the demo's 16 rows it would be three quarters padding, and it has no
// float64 form. A wgmma row tile for K5's weight gradients at 64 rows and
// more is later work.

#pragma once
#include "coupling_kernels.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int kMmaRows = 16;      // a warp's rows: the mma's M
// warps a CTA of K4 and K5: of 1, 2, 4 and 8 (benchmarks/torch_ab.py
// builds a copy of the sources for each), 4 is the fastest of both at the
// demo's 16 rows, the main path's batch, and within 9 % of K4's best and
// 8 % of K5's at 256 and 262,144 rows. The kernels read their warps from
// blockDim; their launch bounds allow up to kMmaMaxWarps.
constexpr int kMmaWarps = 4;
constexpr int kMmaMaxWarps = 8;
static_assert(kMmaWarps >= 1 && kMmaWarps <= kMmaMaxWarps, "warps a CTA");
constexpr int kMmaMaxSmem = 227 * 1024;
constexpr int kXs = kMaxD + 1;    // words a row of a warp's x and cotangent arrays

// ---------------------------------------------------------------------------
// One net's staged layout: layer 0's Wᵀ (H rows of 4 doubles: the n_B ≤ 4
// inputs, zero-padded), each hidden layer's Wᵀ (H rows of H + 4 doubles),
// the head's Wᵀ (4 rows of H + 4: n_A ≤ 4 outputs), then the biases in
// float32 (H a layer, 8 for the head). A coupling is the s net then the t
// net. Columns H .. H + 3 of a row are padding, which nothing reads.
// ---------------------------------------------------------------------------

__host__ __device__ inline int mma_w_off(int H, int l) {  // doubles
  return l == 0 ? 0 : 4 * H + (l - 1) * H * (H + 4);
}
__host__ __device__ inline int mma_bias_off(int H, int depth) {  // bytes
  return 8 * (4 * H + (depth - 2) * H * (H + 4) + 4 * (H + 4));
}
__host__ __device__ inline int mma_net_bytes(int H, int depth) {
  return mma_bias_off(H, depth) + 4 * ((depth - 1) * H + 8);
}

// Shared memory of one launch, in bytes: the weights (every coupling's, or
// one slot), then each warp's x rows; K5 also each warp's cotangent rows,
// every coupling's input for the CTA's rows, the kept layer inputs (x_B,
// and per net each hidden level) and two layers' G and bias-gradient
// partials; then, with one slot, a landing slot, one coupling's float32
// words at the kernels' bounds (`net_words`), which cp.async fills for
// the conversion to the staged layout (a resident stack is
// staged straight from device memory); and for K5, where it fits, the
// CTA's partial weight gradients (`acc`, −1 where they go to device
// memory).
struct MmaLayout {
  int net, slot, resident, ring;
  int xs, gs, saved, hx, hh, gbuf, gb, land, acc, bytes;
};

// Fill lay for a CTA of kMmaWarps warps and set `need` to its bytes
// (where even one slot does not fit, the bytes with one slot, past
// kMmaMaxSmem); kInvalid where they are past kMmaMaxSmem.
inline int mma_layout(MmaLayout& lay, int64_t& need, const Stack& st, int H,
                      bool backward) {
  const int w = kMmaWarps, n_c = 2 * st.n_blocks, rows = kMmaRows * w;
  const int S = H + 8;
  lay.net = mma_net_bytes(H, st.depth);
  lay.slot = 2 * lay.net;
  lay.ring = 4 * 2 * net_words(H, st.depth);
  int64_t rest = 0;
  auto take = [&rest](int64_t bytes) {
    const int64_t at = rest;
    rest += bytes;
    return at;
  };
  const int64_t xs = take((int64_t)rows * kXs * 4);
  int64_t gs = 0, saved = 0, hx = 0, hh = 0, gbuf = 0, gb = 0;
  if (backward) {
    gs = take((int64_t)rows * kXs * 4);
    saved = take((int64_t)n_c * rows * st.d * 4);
    hx = take((int64_t)rows * 8 * 2);
    hh = take((int64_t)2 * (st.depth - 1) * rows * S * 2);
    gbuf = take((int64_t)2 * rows * S * 2);
    gb = take((int64_t)2 * w * H * 4);
  }
  lay.resident = (int64_t)n_c * lay.slot + rest <= kMmaMaxSmem;
  const int64_t land = lay.resident ? -1 : take((int64_t)lay.ring);
  const int64_t weights = lay.resident ? (int64_t)n_c * lay.slot : lay.slot;
  need = weights + rest;
  if (need > kMmaMaxSmem) return kInvalid;
  const int64_t acc = 4 * n_params_of(st);
  lay.acc = backward && weights + rest + acc <= kMmaMaxSmem
                ? (int)(weights + rest) : -1;
  lay.xs = (int)(weights + xs);
  lay.gs = (int)(weights + gs);
  lay.saved = (int)(weights + saved);
  lay.hx = (int)(weights + hx);
  lay.hh = (int)(weights + hh);
  lay.gbuf = (int)(weights + gbuf);
  lay.gb = (int)(weights + gb);
  lay.land = land < 0 ? -1 : (int)(weights + land);
  need = weights + rest + (lay.acc >= 0 ? acc : 0);
  lay.bytes = (int)need;
  return 0;
}

// Coupling c's float32 words into landing slot `to` by cp.async, not
// waited for: per net and layer its W (in × out, row-major) at the start
// of a kHalf-or-H by H-or-kHalf region, then its b, every thread copying
// every blockDim-th word.
template <bool INVERSE, int H>
__device__ __forceinline__ void mma_fetch(const Stack& st, int c, float* to) {
  int g, blk;
  coupling_at<INVERSE>(st, c, g, blk);
  const int depth = st.depth, tid = threadIdx.x, nt = blockDim.x;
  int off = 0;
#pragma unroll 1
  for (int net = 0; net < 2; ++net) {
#pragma unroll 1
    for (int l = 0; l < depth; ++l) {
      const int in = st.width[g][l], ow = st.width[g][l + 1];
      const float* W = static_cast<const float*>(st.W[g][net][l]) +
                       (int64_t)blk * in * ow;
      const float* b = static_cast<const float*>(st.b[g][net][l]) +
                       (int64_t)blk * ow;
      for (int e = tid; e < in * ow; e += nt) cp_word(to + off + e, W + e);
      off += in_bound(H, l) * out_bound(H, l, depth);
      for (int e = tid; e < ow; e += nt) cp_word(to + off + e, b + e);
      off += out_bound(H, l, depth);
    }
  }
  cp_commit();
}

// A weight as the staged layout holds it: rounded to bfloat16 (to nearest
// even), widened to float64
__device__ __forceinline__ double bf16_wide(float v) {
  return (double)__bfloat162float(__float2bfloat16_rn(v));
}

// One layer's Wᵀ (OBP rows of IBP of the staged layout, rows SW doubles
// apart) from its landed W (in × ow), each weight rounded to bfloat16 (to
// nearest even) and widened to float64, the padding zero. A thread takes
// two neighbouring inputs of an output, the outputs fastest across the
// threads: the landed rows are read in order and each pair stored in one
// 16-byte write (reading down W's columns put a warp's reads in one bank)
template <int OBP, int IBP, int SW>
__device__ __forceinline__ void mma_convert_w(const float* W, int in, int ow,
                                              double* wt) {
#pragma unroll 2
  for (int e = threadIdx.x; e < OBP * IBP / 2; e += blockDim.x) {
    const int i = 2 * (e / OBP), o = e - (e / OBP) * OBP;
    const float w0 = o < ow && i < in ? W[i * ow + o] : 0.f;
    const float w1 = o < ow && i + 1 < in ? W[(i + 1) * ow + o] : 0.f;
    *reinterpret_cast<double2*>(wt + o * SW + i) = make_double2(
        bf16_wide(w0), bf16_wide(w1));
  }
}

// Landed coupling (group g) into its staged slot wc
template <int H>
__device__ __forceinline__ void mma_convert(const Stack& st, int g,
                                            const float* from,
                                            unsigned char* wc,
                                            int net_bytes) {
  const int depth = st.depth;
  int off = 0;
#pragma unroll 1
  for (int net = 0; net < 2; ++net) {
    unsigned char* wn = wc + net * net_bytes;
    auto* wt = reinterpret_cast<double*>(wn);
    float* bias = reinterpret_cast<float*>(wn + mma_bias_off(H, depth));
#pragma unroll 1
    for (int l = 0; l < depth; ++l) {
      const int in = st.width[g][l], ow = st.width[g][l + 1];
      if (l == 0)
        mma_convert_w<H, 4, 4>(from + off, in, ow, wt);
      else if (l < depth - 1)
        mma_convert_w<H, H, H + 4>(from + off, in, ow, wt + mma_w_off(H, l));
      else
        mma_convert_w<4, H, H + 4>(from + off, in, ow, wt + mma_w_off(H, l));
      off += in_bound(H, l) * out_bound(H, l, depth);
      const int ob = l < depth - 1 ? H : 8;
      for (int e = threadIdx.x; e < ob; e += blockDim.x)
        bias[l * H + e] = e < ow ? from[off + e] : 0.f;
      off += out_bound(H, l, depth);
    }
  }
}

// Every coupling into its resident slot straight from device memory, each
// weight rounded to bfloat16 and widened as `mma_convert_w` does it (a
// thread a pair of inputs of an output, the outputs fastest): the stack's
// pairs, numbered across couplings, nets and layers, dealt to the threads
// kStageLoads at a time, so that that many loads are in flight at once;
// then the biases
constexpr int kStageLoads = 8;
template <bool INVERSE, int H>
__device__ void mma_stage_all(const Stack& st, const MmaLayout& lay,
                              unsigned char* sm) {
  const int depth = st.depth, n_c = 2 * st.n_blocks, nt = blockDim.x;
  const int hidden = H * H / 2;  // a hidden layer's pairs; layer 0, head 2H
  const int net_pairs = 4 * H + (depth - 2) * hidden;
  const int pairs = n_c * 2 * net_pairs;
#pragma unroll 1
  for (int e0 = threadIdx.x; e0 < pairs; e0 += kStageLoads * nt) {
    float w[kStageLoads][2];
    double* to[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = e0 + u * nt;
      w[u][0] = w[u][1] = 0.f;
      to[u] = nullptr;
      if (e >= pairs) continue;
      const int c = e / (2 * net_pairs), r = e - c * 2 * net_pairs;
      const int net = r >= net_pairs, q = r - net * net_pairs;
      int l, i, o;  // i even: the pair's first input
      if (q < 2 * H) {
        l = 0, i = 2 * (q / H), o = q % H;
      } else if (q < 2 * H + (depth - 2) * hidden) {
        const int h = q - 2 * H;
        l = 1 + h / hidden;
        const int k = h - (l - 1) * hidden;
        i = 2 * (k / H), o = k % H;
      } else {
        const int k = q - 2 * H - (depth - 2) * hidden;
        l = depth - 1, i = 2 * (k / 4), o = k % 4;
      }
      int g, blk;
      coupling_at<INVERSE>(st, c, g, blk);
      const int in = st.width[g][l], ow = st.width[g][l + 1];
      const float* W = static_cast<const float*>(st.W[g][net][l]) +
                       (int64_t)blk * in * ow;
      if (o < ow && i < in) w[u][0] = W[i * ow + o];
      if (o < ow && i + 1 < in) w[u][1] = W[(i + 1) * ow + o];
      to[u] = reinterpret_cast<double*>(sm + (int64_t)c * lay.slot +
                                        net * lay.net) +
              mma_w_off(H, l) + o * (l == 0 ? 4 : H + 4) + i;
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u)
      if (to[u])
        *reinterpret_cast<double2*>(to[u]) =
            make_double2(bf16_wide(w[u][0]), bf16_wide(w[u][1]));
  }
  const int net_bias = (depth - 1) * H + 8;
  for (int e = threadIdx.x; e < n_c * 2 * net_bias; e += nt) {
    const int c = e / (2 * net_bias), r = e - c * 2 * net_bias;
    const int net = r >= net_bias, j = r - net * net_bias;
    const int l = j < (depth - 1) * H ? j / H : depth - 1, o = j - l * H;
    int g, blk;
    coupling_at<INVERSE>(st, c, g, blk);
    const int ow = st.width[g][l + 1];
    reinterpret_cast<float*>(sm + (int64_t)c * lay.slot + net * lay.net +
                             mma_bias_off(H, depth))[j] =
        o < ow ? static_cast<const float*>(st.b[g][net][l])[
                     (int64_t)blk * ow + o]
               : 0.f;
  }
  __syncthreads();
}

// Coupling c's staged weights: its resident slot, or (one slot) c fetched
// and converted into it between barriers.
template <bool INVERSE, int H>
__device__ __forceinline__ const unsigned char* mma_weights(
    const Stack& st, const MmaLayout& lay, int c, unsigned char* sm) {
  if (lay.resident) return sm + (int64_t)c * lay.slot;
  float* ring = reinterpret_cast<float*>(sm + lay.land);
  __syncthreads();  // every warp is done with the previous coupling
  mma_fetch<INVERSE, H>(st, c, ring);
  cp_wait_all();
  __syncthreads();
  int g, blk;
  coupling_at<INVERSE>(st, c, g, blk);
  mma_convert<H>(st, g, ring, sm, lay.net);
  __syncthreads();
  return sm;
}

// The tensor core's sum, as chip_smoke.py phase 59 measured it on the H100
// (csrc/mma_probe.cu, every bit of 402 crafted cases): the 16 products
// exact; c and the products aligned to the largest exponent among them (a
// product's exponent the sum of its operands'), each addend's bits below
// 2^(E − 25) cut toward zero; the aligned addends summed exactly and the
// sum normalised to float32 toward zero. So a result lies up to an ulp
// short of the sum, toward zero. The weight gradients' k16 products are
// rounded to nearest: taken from zero (t, toward zero), then again with c
// = −t, whose aligned sum is the part t left out, exact wherever no
// product falls below the window of the larger of the two alignments; t
// moves one ulp away from zero where that part is past half an ulp, or at
// half an ulp with t odd (`to_nearest`); the k16 products of a CTA's rows
// add in float32, k in order (`mma_rn`).
__device__ __forceinline__ float to_nearest(float t, float rest) {
  const uint32_t u = __float_as_uint(t);
  const float half = __uint_as_float(u & 0x7f800000u) * 0x1p-24f;
  const float r = (__float_as_uint(rest) ^ u) >> 31 ? 0.f : fabsf(rest);
  return r > half || (r == half && (u & 1u)) ? __uint_as_float(u + 1u) : t;
}

// c += A·B, the product from zero rounded to nearest (`to_nearest`), added
// in float32
__device__ __forceinline__ void mma_rn(float (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma16816(t, a0, a1, a2, a3, b0, b1);
  float r[4] = {-t[0], -t[1], -t[2], -t[3]};
  mma16816(r, a0, a1, a2, a3, b0, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = c[i] + to_nearest(t[i], r[i]);
}

// ---------------------------------------------------------------------------
// The float64 products
// ---------------------------------------------------------------------------

// A bfloat16 (f: its float32 bits, the low half zero) as float64, exactly,
// by cvt (one F2F; the sign, exponent and mantissa moved on the integer
// pipes instead took K4 and K5 1.4 to 1.7 times as long, torch_ab.py
// --levers on an H100)
__device__ __forceinline__ double widen(uint32_t f) {
  return (double)__uint_as_float(f);
}

// A product's float64 A fragments from its bfloat16 input in the C layout
// (p[nt][0] rows g, p[nt][1] rows g + 8, each two columns 2t, 2t + 1 of n8
// tile nt): k16 chunk kc wants k t + 4m (m = 0..3) of rows g, g + 8, which
// lane (g, t / 2 + 2(m % 2)) holds in tile 2kc + m / 2, in the half t % 2
template <int NT>
__device__ __forceinline__ void gather(const uint32_t (&p)[NT][2],
                                       double (&x)[NT / 2][8], int lane) {
  const int s0 = (lane & ~3) | ((lane & 3) >> 1), s1 = s0 + 2;
  const bool hi = lane & 1;
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const uint32_t v =
            __shfl_sync(kWarp, p[2 * kc + (m >> 1)][rh], m & 1 ? s1 : s0);
        x[kc][2 * m + rh] = widen(hi ? v & 0xffff0000u : v << 16);
      }
}

// c = A·B from zero over KC k16 chunks, A this lane's fragments (`gather`),
// B(k, n) = w[k·sk + n·sn] in staged doubles for the n8 tile's n < nlive
// (0 past it), by m16n8k16 .f64: each product of two bfloat16 exact, and
// so the sum wherever it spans at most 53 bits (chip_smoke.py phase 60)
template <int KC>
__device__ __forceinline__ void prod_k16(double (&c)[4],
                                         const double (&a)[KC][8],
                                         const double* w, int sk, int sn,
                                         int nlive, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const double* wg = w + (g < nlive ? g : 0) * sn;
  double b[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double v = wg[(16 * kc + t + 4 * j) * sk];
      b[kc][j] = g < nlive ? v : 0.0;
    }
  c[0] = c[1] = c[2] = c[3] = 0.0;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) dmma16816(c, a[kc], b[kc]);
}

// c = A·B from zero over k = 4: a0 (row g) and a1 (row g + 8) this lane's
// k = t, B(k, n) = w[k·sk + n·sn], by m16n8k4 .f64
__device__ __forceinline__ void prod_k4(double (&c)[4], double a0, double a1,
                                        const double* w, int sk, int sn,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  c[0] = c[1] = c[2] = c[3] = 0.0;
  dmma1684(c, a0, a1, w[t * sk + g * sn]);
}

// ---------------------------------------------------------------------------
// The forward on a warp's 16 rows
// ---------------------------------------------------------------------------

// One n8 tile of a layer's outputs: the float64 sum rounded once to
// float32, the bias added in float32 (as the plain version adds it), the
// leaky ReLU (slope 0.01, max(z, 0.01·z)) in float32, and each value
// rounded once to bfloat16 and packed (out[0] rows g, out[1] rows g + 8)
__device__ __forceinline__ void mma_layer(const double (&c)[4],
                                          const float* bias,
                                          uint32_t (&out)[2], int lane) {
  const float2 bb =
      *reinterpret_cast<const float2*>(bias + 2 * (lane & 3));
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float z = __double2float_rn(c[i]) + (i & 1 ? bb.y : bb.x);
    v[i] = fmaxf(z, 0.01f * z);
  }
  out[0] = pack2(v[0], v[1]);
  out[1] = pack2(v[2], v[3]);
}

// Layer 0: x_B·W0 + b0 over H outputs, x0 / x1 this lane's k = t of rows
// g / g + 8 (float64); W0ᵀ's rows 4 doubles apart
template <int H>
__device__ __forceinline__ void mma_first(const double* w0, const float* bias,
                                          double x0, double x1,
                                          uint32_t (&a)[H / 8][2], int lane) {
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    double c[4];
    prod_k4(c, x0, x1, w0 + nt * 8 * 4, 1, 4, lane);
    mma_layer(c, bias + nt * 8, a[nt], lane);
  }
}

// A hidden layer in place: a (its input, then its output) through
// h·W + b and the leaky ReLU; Wᵀ's rows H + 4 doubles apart
template <int H>
__device__ __forceinline__ void mma_dense(const double* wt, const float* bias,
                                          uint32_t (&a)[H / 8][2], int lane) {
  double x[H / 16][8];
  gather<H / 8>(a, x, lane);
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    double c[4];
    prod_k16<H / 16>(c, x, wt + nt * 8 * (H + 4), 1, H + 4, 8, lane);
    mma_layer(c, bias + nt * 8, a[nt], lane);
  }
}

// a level's bfloat16 pairs into a kept buffer at the warp's rows (row
// stride H + 8 bfloat16)
template <int H>
__device__ __forceinline__ void mma_keep(unsigned char* at,
                                         const uint32_t (&a)[H / 8][2],
                                         int lane) {
  constexpr int S = 2 * (H + 8);
  const int g = lane >> 2, t4 = 4 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    unsigned char* p = at + nt * 16 + t4;
    *reinterpret_cast<uint32_t*>(p + g * S) = a[nt][0];
    *reinterpret_cast<uint32_t*>(p + (g + 8) * S) = a[nt][1];
  }
}

// Where K5 keeps a tile's layer inputs: x_B (rows of 8 bfloat16) and each
// net's hidden levels 1 .. depth − 1 (rows of H + 8), for the CTA's rows;
// `x` and `mine` are this warp's 16 of them
struct MmaKeep {
  unsigned char* hx;   // null: keep nothing (K4, K5's first forward)
  unsigned char* hh;
  int level_bytes;     // one level of the CTA's rows
  int warp_bytes;      // a warp's 16 rows of one level
  int warp;
  int depth;
  __device__ unsigned char* level(int net, int l) const {
    return hh + (net * (depth - 1) + l - 1) * level_bytes;
  }
  __device__ unsigned char* mine(int net, int l) const {
    return level(net, l) + warp * warp_bytes;
  }
  __device__ unsigned char* x() const { return hx + warp * kMmaRows * 16; }
};

// A lane's index reads for group grp: for k = 2q and 2q + 1 (lane (g, q))
// the transformed (x_A) and the conditioner (x_B) index, −1 past n_A or n_B
// (every k of a lane q ≥ 2), the conditioner's for k = q (layer 0's A
// fragment), and n_A; read from the kernel's parameters at each coupling,
// so that the other group's keep no registers
struct MmaIdx {
  int a[2], b[2], bq, na;
};

__device__ __forceinline__ MmaIdx mma_ix(const Stack& st, int grp,
                                         int lane) {
  const int q = lane & 3;
  MmaIdx r;
  r.na = st.width[grp][st.depth];
  r.bq = entry(st.idx_b[grp], q);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    r.a[e] = entry(st.idx_a[grp], 2 * q + e);
    r.b[e] = entry(st.idx_b[grp], 2 * q + e);
  }
  return r;
}

// The conditioners of a coupling (staged at wc; ix its group's indices) on
// a warp's 16 rows, x its rows' values: the s net's head (after tanh) in s
// and the t net's in t, C layout (lane (g, q): rows g, g + 8, k = 2q,
// 2q + 1; s and t are 0 at k ≥ n_A). Both nets layer by layer, so that
// their chains interleave. With keep.hx, every layer's input is kept.
template <int H>
__device__ __forceinline__ void mma_conditioners(
    const Stack& st, const MmaIdx& ix, const unsigned char* wc,
    int net_bytes, const float* xs, const MmaKeep& keep, float (&s)[4],
    float (&t)[4], int lane) {
  const int depth = st.depth, g = lane >> 2, q = lane & 3;
  // x_B rounded to bfloat16: float64 at k = q for layer 0's product
  auto bf = [&](int row, int i) {
    return i >= 0 ? pack2(xs[row * kXs + i], 0.f) << 16 : 0u;
  };
  const double x0 = widen(bf(g, ix.bq)), x1 = widen(bf(g + 8, ix.bq));
  if (keep.hx) {  // and packed at k = 2q, 2q + 1 for the weight gradients
    const int ib0 = ix.b[0], ib1 = ix.b[1];
    *reinterpret_cast<uint32_t*>(keep.x() + g * 16 + 4 * q) =
        (bf(g, ib0) >> 16) | bf(g, ib1);
    *reinterpret_cast<uint32_t*>(keep.x() + (g + 8) * 16 + 4 * q) =
        (bf(g + 8, ib0) >> 16) | bf(g + 8, ib1);
  }
  const int bias0 = mma_bias_off(H, depth);
  auto wt = [&](int net, int l) {
    return reinterpret_cast<const double*>(wc + net * net_bytes) +
           mma_w_off(H, l);
  };
  auto bias = [&](int net, int l) {
    return reinterpret_cast<const float*>(wc + net * net_bytes + bias0) +
           l * H;
  };
  uint32_t a[2][H / 8][2];
#pragma unroll
  for (int net = 0; net < 2; ++net) {
    mma_first<H>(wt(net, 0), bias(net, 0), x0, x1, a[net], lane);
    if (keep.hx) mma_keep<H>(keep.mine(net, 1), a[net], lane);
  }
#pragma unroll 1
  for (int l = 1; l < depth - 1; ++l) {
#pragma unroll
    for (int net = 0; net < 2; ++net) {
      mma_dense<H>(wt(net, l), bias(net, l), a[net], lane);
      if (keep.hx) mma_keep<H>(keep.mine(net, l + 1), a[net], lane);
    }
  }
#pragma unroll
  for (int net = 0; net < 2; ++net) {
    double x[H / 16][8], c[4];
    gather<H / 8>(a[net], x, lane);
    prod_k16<H / 16>(c, x, wt(net, depth - 1), 1, H + 4, 4, lane);
    const float2 bb = *reinterpret_cast<const float2*>(
        bias(net, depth - 1) + 2 * q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool live = 2 * q + (i & 1) < ix.na;
      const float z = __double2float_rn(c[i]) + (i & 1 ? bb.y : bb.x);
      if (net == 0) s[i] = live ? th(z) : 0.f;
      else t[i] = live ? z : 0.f;
    }
  }
}

// y_A from the heads, written into the warp's rows by index: lane (g, q)
// with q < 2 takes k = 2q, 2q + 1 at rows g and g + 8 (every other lane's
// x_A index is −1). Element i of s and t is row g + 8·(i / 2), k = 2q + i % 2.
template <bool INVERSE>
__device__ __forceinline__ void mma_apply(const MmaIdx& ix,
                                          const float (&s)[4],
                                          const float (&t)[4], float* xs,
                                          int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = ix.a[i & 1];
    if (j < 0) continue;
    float* p = xs + (g + 8 * (i >> 1)) * kXs + j;
    const float xa = *p;
    *p = INVERSE ? (xa - t[i]) * ex(-s[i])
                 : __fadd_rn(__fmul_rn(xa, ex(s[i])), t[i]);
  }
}

// Σ s over the n_A outputs of rows g (l0) and g + 8 (l1), on lanes q = 0:
// k 0, 1 from this lane, 2, 3 from lane q = 1, summed in order
__device__ __forceinline__ void mma_logdet(int na, const float (&s)[4],
                                           float& l0, float& l1) {
  const float u0 = __shfl_down_sync(kWarp, s[0], 1);
  const float u1 = __shfl_down_sync(kWarp, s[1], 1);
  const float u2 = __shfl_down_sync(kWarp, s[2], 1);
  const float u3 = __shfl_down_sync(kWarp, s[3], 1);
  float r0 = s[0], r1 = s[2];
  if (na > 1) r0 = r0 + s[1], r1 = r1 + s[3];
  if (na > 2) r0 = r0 + u0, r1 = r1 + u2;
  if (na > 3) r0 = r0 + u1, r1 = r1 + u3;
  l0 = r0, l1 = r1;
}

// the warp's 16 rows of a row-major (n, d) array into a warp array (rows
// past n: 0), and back (rows past n: not written)
__device__ __forceinline__ void mma_rows_in(const float* src, int64_t r0,
                                            int64_t n, int d, float* dst,
                                            int lane) {
  for (int e = lane; e < kMmaRows * d; e += 32) {
    const int r = e / d, j = e - r * d;
    dst[r * kXs + j] = r0 + r < n ? src[(r0 + r) * d + j] : 0.f;
  }
}
// the same by cp.async, not waited for (rows past n: zero-filled)
__device__ __forceinline__ void mma_rows_fetch(const float* src, int64_t r0,
                                               int64_t n, int d, float* dst,
                                               int lane) {
  for (int e = lane; e < kMmaRows * d; e += 32) {
    const int r = e / d, j = e - r * d;
    const bool valid = r0 + r < n;
    cp_word(dst + r * kXs + j, valid ? src + (r0 + r) * d + j : src, valid);
  }
  cp_commit();
}
__device__ __forceinline__ void mma_rows_out(const float* src, int64_t r0,
                                             int64_t n, int d, float* dst,
                                             int lane) {
  for (int e = lane; e < kMmaRows * d; e += 32) {
    const int r = e / d, j = e - r * d;
    if (r0 + r < n) dst[(r0 + r) * d + j] = src[r * kXs + j];
  }
}

// K4: the stack forward or inverse with the running log-det. CTA c walks
// tiles of 16·w rows c, c + G, ...; warp k of the CTA takes rows 16k..16k+15
// of a tile. One CTA of the most warps an SM asked for leaves ptxas 255
// registers (K4 takes 150 at H = 32, more than the 128 that two would
// leave); with no minimum it once kept K4 to 64 and spilled.
template <bool INVERSE, int H>
__global__ void __launch_bounds__(32 * kMmaMaxWarps, 1)
coupling_fwd_dmma(const float* __restrict__ x, float* __restrict__ y,
                 float* __restrict__ ld, int64_t n,
                 const __grid_constant__ Stack st,
                 const __grid_constant__ MmaLayout lay) {
  unsigned char* sm = coupling_smem;
  const int w = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, d = st.d, n_c = 2 * st.n_blocks;
  const int rows = kMmaRows * w;
  float* xs = reinterpret_cast<float*>(sm + lay.xs) + warp * kMmaRows * kXs;
  const int64_t tiles = (n + rows - 1) / rows;
  // the first tile's rows come in by cp.async while the weights are staged
  // (whose waits take them too), the later tiles' by loads
  mma_rows_fetch(x, (int64_t)blockIdx.x * rows + warp * kMmaRows, n, d, xs,
                 lane);
  if (lay.resident) mma_stage_all<INVERSE, H>(st, lay, sm);
  const MmaKeep none{nullptr, nullptr, 0, 0, warp, st.depth};
#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t r0 = tile * rows + warp * kMmaRows;
    if (tile == blockIdx.x) cp_wait_all();
    else mma_rows_in(x, r0, n, d, xs, lane);
    __syncwarp();
    float l0 = 0.f, l1 = 0.f;
#pragma unroll 1
    for (int c = 0; c < n_c; ++c) {
      const unsigned char* wc = mma_weights<INVERSE, H>(st, lay, c, sm);
      int grp, blk;
      coupling_at<INVERSE>(st, c, grp, blk);
      const MmaIdx ix = mma_ix(st, grp, lane);
      float s[4], t[4];
      mma_conditioners<H>(st, ix, wc, lay.net, xs, none, s, t, lane);
      __syncwarp();  // every lane has read x_B
      mma_apply<INVERSE>(ix, s, t, xs, lane);
      float s0, s1;
      mma_logdet(ix.na, s, s0, s1);
      l0 = INVERSE ? l0 - s0 : l0 + s0;
      l1 = INVERSE ? l1 - s1 : l1 + s1;
      __syncwarp();
    }
    mma_rows_out(xs, r0, n, d, y, lane);
    if ((lane & 3) == 0) {
      if (r0 + g < n) ld[r0 + g] = l0;
      if (r0 + g + 8 < n) ld[r0 + g + 8] = l1;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K5: the reverse sweep
// ---------------------------------------------------------------------------

// A layer's G in the C layout (NT n8 tiles of its outputs) rounded to
// bfloat16 and packed into p (p[nt][0] rows g, p[nt][1] rows g + 8), and
// into the warp's rows of the G buffer (row stride H + 8); its column sums
// over the warp's 16 rows (rows g and g + 8, then a butterfly over g) into
// the warp's bias-gradient partials.
template <int H, int NT>
__device__ __forceinline__ void mma_g_out(const float (&G)[NT][4],
                                          uint32_t (&p)[NT][2],
                                          unsigned char* gbuf, float* gbp,
                                          int lane) {
  constexpr int S = 2 * (H + 8);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    p[nt][0] = pack2(G[nt][0], G[nt][1]);
    p[nt][1] = pack2(G[nt][2], G[nt][3]);
    *reinterpret_cast<uint32_t*>(gbuf + g * S + (nt * 8 + t2) * 2) = p[nt][0];
    *reinterpret_cast<uint32_t*>(gbuf + (g + 8) * S + (nt * 8 + t2) * 2) =
        p[nt][1];
    float c0 = G[nt][0] + G[nt][2], c1 = G[nt][1] + G[nt][3];
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      c0 = c0 + __shfl_xor_sync(kWarp, c0, m);
      c1 = c1 + __shfl_xor_sync(kWarp, c1, m);
    }
    if (g == 0) gbp[nt * 8 + t2] = c0, gbp[nt * 8 + t2 + 1] = c1;
  }
}

// A hidden level's slope at this lane's (row, column) pairs, from the kept
// bfloat16 post-activation: 1 where it is ≥ 0, else 0.01 (`_mlp_bwd`)
template <int H>
__device__ __forceinline__ void mma_slope(const unsigned char* level,
                                          float (&G)[H / 8][4], int lane) {
  constexpr int S = 2 * (H + 8);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    const uint32_t h0 = *reinterpret_cast<const uint32_t*>(
        level + g * S + (nt * 8 + t2) * 2);
    const uint32_t h1 = *reinterpret_cast<const uint32_t*>(
        level + (g + 8) * S + (nt * 8 + t2) * 2);
    G[nt][0] = G[nt][0] * (lo_of(h0) >= 0.f ? 1.f : 0.01f);
    G[nt][1] = G[nt][1] * (hi_of(h0) >= 0.f ? 1.f : 0.01f);
    G[nt][2] = G[nt][2] * (lo_of(h1) >= 0.f ? 1.f : 0.01f);
    G[nt][3] = G[nt][3] * (hi_of(h1) >= 0.f ? 1.f : 0.01f);
  }
}

// gc = round(G)·Wᵀ over a hidden layer's H inputs (NTI = H/8 n8 tiles,
// Wᵀ's rows SW doubles apart, nlive its columns) on the float64 tensor
// cores: K = the layer's H outputs, G packed in the C layout (p)
template <int NTO, int NTI>
__device__ __forceinline__ void mma_input_cot(const double* wt, int sw,
                                              int nlive,
                                              const uint32_t (&p)[NTO][2],
                                              float (&gc)[NTI][4],
                                              int lane) {
  double x[NTO / 2][8];
  gather<NTO>(p, x, lane);
#pragma unroll
  for (int nt = 0; nt < NTI; ++nt) {
    double c[4];
    prod_k16<NTO / 2>(c, x, wt + nt * 8, sw, 1, nlive, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) gc[nt][i] = __double2float_rn(c[i]);
  }
}

// After the barrier: a layer's gW = Hᵀ·G over the CTA's 16·w rows (the
// mma's k), M = its inputs (MT m16 tiles; layer 0's 8 inputs half of one,
// `half`), N = its outputs (NT n8 tiles), the tiles dealt to the warps in
// turn; then its gb, the warps' partials summed in warp order, by the last
// warp. Each entry of the layer (in × out, then out) is written to the
// CTA's slice (first tile) or added to it.
template <int MT, int NT, bool HALF>
__device__ __forceinline__ void mma_grads(const unsigned char* hsrc, int SH,
                                          const unsigned char* gsrc, int SG,
                                          const float* gbp, int hwidth,
                                          int in, int ow, int64_t offW,
                                          int64_t offb, float* part,
                                          bool first, int w, int warp,
                                          int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3), j = lane >> 3, r = lane & 7;
  const unsigned hs = smem_at(hsrc), gs = smem_at(gsrc);
#pragma unroll 1
  for (int tile = warp; tile < MT * NT; tile += w) {
    const int mt = tile / NT, nt = tile - mt * NT;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int kk = 0; kk < w; ++kk) {
      uint32_t a0, a1 = 0, a2, a3 = 0, b0, b1;
      if constexpr (HALF)
        ldsm_x2_t(hs + (kk * 16 + (lane & 15)) * SH, a0, a2);
      else
        ldsm_x4_t(hs + (kk * 16 + (j >> 1) * 8 + r) * SH +
                      (mt * 16 + (j & 1) * 8) * 2,
                  a0, a1, a2, a3);
      ldsm_x2_t(gs + (kk * 16 + (lane & 15)) * SG + nt * 16, b0, b1);
      mma_rn(acc, a0, a1, a2, a3, b0, b1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = mt * 16 + g + 8 * (i >> 1), o = nt * 8 + t2 + (i & 1);
      if (m < in && o < ow) {
        float* at = part + offW + m * ow + o;
        *at = first ? acc[i] : *at + acc[i];
      }
    }
  }
  if (warp == w - 1 && lane < ow) {
    float acc = gbp[lane];
    for (int k = 1; k < w; ++k) acc = acc + gbp[k * hwidth + lane];
    float* at = part + offb + lane;
    *at = first ? acc : *at + acc;
  }
}

// `_mlp_bwd` of one net of coupling (grp, blk) over the CTA's rows: gout
// the head's output cotangent in the C layout (zero past n_A), head its
// tanh output for the s net (null for the t net); on return gin holds the
// input cotangent of x_B in the same layout. One barrier a layer; G and the
// bias partials alternate between two buffers (buf), so that a layer's
// writes never meet the reads of the one before.
template <int H>
__device__ __forceinline__ void mma_net_bwd(
    const Stack& st, const MmaLayout& lay, int grp, int blk, int net,
    const unsigned char* wc, const MmaKeep& keep, unsigned char* sm,
    const float (&gout)[4], const float* head, float (&gin)[4], int& buf,
    float* __restrict__ part, bool first, int w, int warp, int lane) {
  constexpr int S = 2 * (H + 8);
  const int depth = st.depth, rows = kMmaRows * w;
  const unsigned char* wn = wc + net * lay.net;
  auto gbuf_at = [&](int b) { return sm + lay.gbuf + b * rows * S; };
  auto gbp_at = [&](int b) {
    return reinterpret_cast<float*>(sm + lay.gb) + b * w * H;
  };
  auto off = [&](int l, int k) { return st.leaf_off[grp][net][l][k]; };
  auto wt = [&](int l) {
    return reinterpret_cast<const double*>(wn) + mma_w_off(H, l);
  };
  // the head: G = gout·(1 − s²) (s net) or gout
  {
    float G[1][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      G[0][i] = head ? __fmul_rn(gout[i],
                                 __fsub_rn(1.f, __fmul_rn(head[i], head[i])))
                     : gout[i];
    uint32_t p[1][2];
    mma_g_out<H, 1>(G, p, gbuf_at(buf) + warp * kMmaRows * S,
                    gbp_at(buf) + warp * H, lane);
    // the head's input cotangent over its n_A ≤ 4 outputs by m16n8k4: this
    // lane's k = t of rows g and g + 8, from lane (g, t / 2), half t % 2
    float gc[H / 8][4];
    {
      const int src = (lane & ~3) | ((lane & 3) >> 1);
      const uint32_t v0 = __shfl_sync(kWarp, p[0][0], src);
      const uint32_t v1 = __shfl_sync(kWarp, p[0][1], src);
      const double h0 = widen(lane & 1 ? v0 & 0xffff0000u : v0 << 16);
      const double h1 = widen(lane & 1 ? v1 & 0xffff0000u : v1 << 16);
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt) {
        double c[4];
        prod_k4(c, h0, h1, wt(depth - 1) + nt * 8, H + 4, 1, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) gc[nt][i] = __double2float_rn(c[i]);
      }
    }
    __syncthreads();  // every warp's G and kept inputs are in place
    const int l = depth - 1, in = st.width[grp][l], ow = st.width[grp][l + 1];
    mma_grads<H / 16, 1, false>(keep.level(net, l), S, gbuf_at(buf), S,
                                gbp_at(buf), H, in, ow,
                                off(l, 0) + (int64_t)blk * in * ow,
                                off(l, 1) + (int64_t)blk * ow, part, first, w,
                                warp, lane);
    buf ^= 1;
    // the hidden layers, last first
#pragma unroll 1
    for (int l = depth - 2; l >= 0; --l) {
      float Gh[H / 8][4];
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) Gh[nt][i] = gc[nt][i];
      mma_slope<H>(keep.mine(net, l + 1), Gh, lane);
      uint32_t ph[H / 8][2];
      mma_g_out<H, H / 8>(Gh, ph, gbuf_at(buf) + warp * kMmaRows * S,
                          gbp_at(buf) + warp * H, lane);
      const int in = st.width[grp][l], ow = st.width[grp][l + 1];
      if (l > 0) {
        mma_input_cot<H / 8, H / 8>(wt(l), H + 4, 8, ph, gc, lane);
        __syncthreads();
        mma_grads<H / 16, H / 8, false>(
            keep.level(net, l), S, gbuf_at(buf), S, gbp_at(buf), H, in, ow,
            off(l, 0) + (int64_t)blk * in * ow, off(l, 1) + (int64_t)blk * ow,
            part, first, w, warp, lane);
      } else {
        float g0[1][4];
        mma_input_cot<H / 8, 1>(wt(0), 4, 4, ph, g0, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) gin[i] = g0[0][i];
        __syncthreads();
        mma_grads<1, H / 8, true>(keep.hx, 16,
                                  gbuf_at(buf), S, gbp_at(buf), H, in, ow,
                                  off(0, 0) + (int64_t)blk * in * ow,
                                  off(0, 1) + (int64_t)blk * ow, part, first,
                                  w, warp, lane);
      }
      buf ^= 1;
    }
  }
}

// K5's first pass: gx per row and each CTA's partial weight gradients, CTA
// c walking tiles of 16·w rows c, c + G, ... 255 registers at most (the
// float64 fragments of the forward and the cotangents beside the bfloat16
// ones take 188 at H = 32).
template <bool INVERSE, int H>
__global__ void __launch_bounds__(32 * kMmaMaxWarps, 1)
coupling_bwd_dmma(const float* __restrict__ x, const float* __restrict__ gy,
                 const float* __restrict__ gld, float* __restrict__ gx,
                 float* __restrict__ scratch, int64_t n, int64_t n_params,
                 const __grid_constant__ Stack st,
                 const __grid_constant__ MmaLayout lay) {
  constexpr int S = 2 * (H + 8);
  unsigned char* sm = coupling_smem;
  const int w = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, d = st.d, n_c = 2 * st.n_blocks;
  const int rows = kMmaRows * w;
  float* xs = reinterpret_cast<float*>(sm + lay.xs) + warp * kMmaRows * kXs;
  float* gs = reinterpret_cast<float*>(sm + lay.gs) + warp * kMmaRows * kXs;
  float* saved = reinterpret_cast<float*>(sm + lay.saved);
  // the CTA's partial weight gradients: in shared memory where they fit,
  // copied to its slice after its last tile; else in the slice itself
  float* slice = scratch + (int64_t)blockIdx.x * n_params;
  float* part = lay.acc >= 0 ? reinterpret_cast<float*>(sm + lay.acc) : slice;
  const MmaKeep none{nullptr, nullptr, 0, 0, warp, st.depth};
  const MmaKeep keep{sm + lay.hx, sm + lay.hh, rows * S, kMmaRows * S, warp,
                     st.depth};
  const int64_t tiles = (n + rows - 1) / rows;
  if (lay.resident) mma_stage_all<INVERSE, H>(st, lay, sm);
#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
    const int64_t r0 = tile * rows + warp * kMmaRows;
    // rows past the end get x = 0 and zero cotangents: they add exactly 0
    mma_rows_in(x, r0, n, d, xs, lane);
    mma_rows_in(gy, r0, n, d, gs, lane);
    const float gl[2] = {r0 + g < n ? gld[r0 + g] : 0.f,
                         r0 + g + 8 < n ? gld[r0 + g + 8] : 0.f};
    __syncwarp();
    // the forward, keeping each coupling's input
#pragma unroll 1
    for (int c = 0; c < n_c; ++c) {
      const unsigned char* wc = mma_weights<INVERSE, H>(st, lay, c, sm);
      float* sv = saved + ((int64_t)c * rows + warp * kMmaRows) * d;
      for (int e = lane; e < kMmaRows * d; e += 32)
        sv[e] = xs[(e / d) * kXs + e % d];
      int grp, blk;
      coupling_at<INVERSE>(st, c, grp, blk);
      const MmaIdx ix = mma_ix(st, grp, lane);
      float s[4], t[4];
      mma_conditioners<H>(st, ix, wc, lay.net, xs, none, s, t, lane);
      __syncwarp();
      mma_apply<INVERSE>(ix, s, t, xs, lane);
      __syncwarp();
    }
    // the couplings back, last first
    int buf = 0;
#pragma unroll 1
    for (int c = n_c - 1; c >= 0; --c) {
      __syncthreads();  // every warp is done with the kept inputs
      const unsigned char* wc = mma_weights<INVERSE, H>(st, lay, c, sm);
      const float* sv = saved + ((int64_t)c * rows + warp * kMmaRows) * d;
      for (int e = lane; e < kMmaRows * d; e += 32)
        xs[(e / d) * kXs + e % d] = sv[e];
      __syncwarp();
      int grp, blk;
      coupling_at<INVERSE>(st, c, grp, blk);
      const MmaIdx ix = mma_ix(st, grp, lane);
      float s[4], t[4];
      mma_conditioners<H>(st, ix, wc, lay.net, xs, keep, s, t, lane);
      // `_coupling_bwd` on the heads' layout: gld reaches every s
      const int* ia = ix.a;
      const int* ib = ix.b;
      // g_xa goes to the cotangent rows at once: each (row, x_A index) is
      // this lane's alone, and nothing below reads it
      float g_xb[4], g_s[4], g_t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = (g + 8 * (i >> 1)) * kXs, a = ia[i & 1],
                  b = ib[i & 1];
        const float xa = a >= 0 ? xs[row + a] : 0.f;
        const float g_ya = a >= 0 ? gs[row + a] : 0.f;
        g_xb[i] = b >= 0 ? gs[row + b] : 0.f;
        float g_xa;
        if (INVERSE) {
          const float e = ex(-s[i]);
          g_xa = g_ya * e;
          g_t[i] = -g_xa;
          g_s[i] = __fsub_rn(__fmul_rn(-g_ya * (xa - t[i]), e), gl[i >> 1]);
        } else {
          const float e = ex(s[i]);
          g_xa = g_ya * e;
          g_t[i] = g_ya;
          g_s[i] = __fadd_rn(__fmul_rn(g_ya * xa, e), gl[i >> 1]);
        }
        if (a >= 0) gs[row + a] = g_xa;
        // padded outputs of s and t take no cotangent
        if (a < 0) g_s[i] = g_t[i] = 0.f;
      }
      // g_xb + (s net's input cotangent) + (t net's), in that order
#pragma unroll 1
      for (int net = 0; net < 2; ++net) {
        float gin[4];
        mma_net_bwd<H>(st, lay, grp, blk, net, wc, keep, sm,
                       net == 0 ? g_s : g_t, net == 0 ? s : nullptr, gin,
                       buf, part, first, w, warp, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) g_xb[i] = g_xb[i] + gin[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = (g + 8 * (i >> 1)) * kXs;
        if (ib[i & 1] >= 0) gs[row + ib[i & 1]] = g_xb[i];
      }
      __syncwarp();
    }
    mma_rows_out(gs, r0, n, d, gx, lane);
    __syncwarp();
  }
  if (lay.acc >= 0) {
    __syncthreads();  // every warp's last sums are in place
    for (int64_t p = threadIdx.x; p < n_params; p += blockDim.x)
      slice[p] = part[p];
  }
}

// ---------------------------------------------------------------------------
// Launchers (the C entries in csrc/coupling_bf16.cu)
// ---------------------------------------------------------------------------

// K4 under the policy. With the stack resident, as many CTAs as fit on the
// SMs at once walk the tiles, each staging the stack once; else a CTA a
// tile, staging each coupling.
template <int H>
int launch_fwd_mma_h(const float* x, float* y, float* ld, int64_t n,
                     const Stack& st, int inverse, cudaStream_t stream) {
  const int w = kMmaWarps, threads = 32 * w;
  MmaLayout lay;
  int64_t need = 0;
  int err = mma_layout(lay, need, st, H, false);
  if (err) return err;
  const auto kern = inverse ? &coupling_fwd_dmma<true, H>
                            : &coupling_fwd_dmma<false, H>;
  err = allow_smem((const void*)kern, lay.bytes);
  if (err) return err;
  const int64_t tiles = (n + kMmaRows * w - 1) / (kMmaRows * w);
  int64_t grid = tiles;
  if (lay.resident) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (err) return err;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, threads, lay.bytes);
    if (err) return err;
    const int64_t fit = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
    grid = tiles < fit ? tiles : fit;
  }
  kern<<<(unsigned)grid, threads, lay.bytes, stream>>>(x, y, ld, n, st, lay);
  return (int)cudaGetLastError();
}

int launch_fwd_mma(const void* x, void* y, void* ld, int64_t n, int d,
                   int n_blocks, int depth, const int* widths, const int* idx,
                   const void* const* weights, int inverse, void* stream) {
  Stack st;
  int H = 0;
  const int err = make_stack(st, H, d, n_blocks, depth, widths, idx, weights);
  if (err) return err;
  if (n <= 0) return 0;
  const auto xp = static_cast<const float*>(x);
  const auto yp = static_cast<float*>(y), lp = static_cast<float*>(ld);
  const auto cs = static_cast<cudaStream_t>(stream);
  return H == 16 ? launch_fwd_mma_h<16>(xp, yp, lp, n, st, inverse, cs)
                 : launch_fwd_mma_h<32>(xp, yp, lp, n, st, inverse, cs);
}

// K5 under the policy: at most n_ctas CTAs of w warps (at most one a tile
// of 16·w rows, and as many as fit on the SMs at once), then
// coupling_bwd_reduce over the slices they wrote.
template <int H>
int launch_bwd_mma_h(const float* x, const float* gy, const float* gld,
                     float* gx, float* scratch, int64_t n, int64_t n_params,
                     const Stack& st, int& n_ctas, int inverse,
                     cudaStream_t stream) {
  const int w = kMmaWarps, rows = kMmaRows * w;
  if (n_ctas < 1 || n_ctas > (n + rows - 1) / rows) return kInvalid;
  MmaLayout lay;
  int64_t need = 0;
  int err = mma_layout(lay, need, st, H, true);
  if (err) return err;
  const auto kern = inverse ? &coupling_bwd_dmma<true, H>
                            : &coupling_bwd_dmma<false, H>;
  err = allow_smem((const void*)kern, lay.bytes);
  if (err) return err;
  // no more CTAs than fit on the SMs at once: each walks its tiles with
  // its partial sums in shared memory, and the fewer slices the reduce sums
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, 32 * w, lay.bytes);
  if (err) return err;
  const int fit = (per_sm > 0 ? per_sm : 1) * sms;
  n_ctas = n_ctas < fit ? n_ctas : fit;
  kern<<<(unsigned)n_ctas, 32 * w, lay.bytes, stream>>>(
      x, gy, gld, gx, scratch, n, n_params, st, lay);
  return (int)cudaGetLastError();
}

int launch_bwd_mma(const void* x, const void* gy, const void* gld, void* gx,
                   void* scratch, int64_t n, int d, int n_blocks, int depth,
                   const int* widths, const int* idx,
                   const void* const* weights, void* const* grads, int n_ctas,
                   int inverse, void* stream) {
  Stack st;
  int H = 0;
  int err = make_stack(st, H, d, n_blocks, depth, widths, idx, weights);
  if (err) return err;
  if (n <= 0) return 0;
  GradTable gt;
  const int64_t n_params = grad_table(st, grads, gt);
  const auto cs = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const float*>(x);
  const auto gyp = static_cast<const float*>(gy);
  const auto glp = static_cast<const float*>(gld);
  const auto gxp = static_cast<float*>(gx);
  const auto sp = static_cast<float*>(scratch);
  err = H == 16 ? launch_bwd_mma_h<16>(xp, gyp, glp, gxp, sp, n, n_params, st,
                                       n_ctas, inverse, cs)
                : launch_bwd_mma_h<32>(xp, gyp, glp, gxp, sp, n, n_params, st,
                                       n_ctas, inverse, cs);
  if (err) return err;
  return launch_reduce<float, float>(sp, n_ctas, n_params, gt, cs);
}

// The plan of K4 (or with `backward` K5) for a stack of the C interface's
// shape: out[0] its rows a CTA, out[1] its dynamic shared memory (past
// kMmaMaxSmem where K5's saved inputs do not fit, and then the launch
// refuses). kInvalid outside the kernels' bounds.
int mma_plan(int d, int n_blocks, int depth, const int* widths, int backward,
             long long* out) {
  if (d < 2 || d > kMaxD) return kInvalid;
  int idx[2 * kMaxD] = {};  // the selections do not move the layout
  Stack st;
  int H = 0;
  const int err = make_stack(st, H, d, n_blocks, depth, widths, idx, nullptr);
  if (err) return err;
  MmaLayout lay;
  int64_t need = 0;
  mma_layout(lay, need, st, H, backward != 0);
  out[0] = kMmaRows * kMmaWarps;
  out[1] = need;
  return 0;
}

}  // namespace
