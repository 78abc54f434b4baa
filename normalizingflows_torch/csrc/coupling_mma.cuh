// K4/K5 under the bf16 compute_dtype policy on Hopper's tensor cores: the
// C entries coupling_fwd_f32_cbf16 and coupling_bwd_f32_cbf16
// (csrc/coupling_bf16.cu) launch coupling_fwd_mma and coupling_bwd_mma
// (+ coupling_bwd_reduce, csrc/coupling_kernels.cuh).
//
// What they replace (normalizingflows/jl_tpu/experimental/
// coupling_pallas.py), under compute_dtype=bfloat16: K4 the Pallas
// `_fwd_kernel` (`_tile_flow`, `pallas_call` at :371), K5 `_bwd_kernel`
// (`_mlp_bwd` at :202, `pallas_call` at :438). The policy's product is
// `_dot(a, b, cd)` (:80-89): bfloat16 operands summed in float32, "one
// native MXU pass" on the TPU, and on Hopper what one
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 computes. The selections, the
// bias adds, the activations and the coupling's own arithmetic stay exact
// float32, as `_dot` leaves them.
//
// What bounds them on this card: not the products. At the demo's 262,144
// rows K5 needs about 16 GMAC, some 30 µs at a quarter of the tensor cores'
// rate; what sets the pace is the float32 work around each product (bias,
// leaky ReLU, the conversions to bfloat16, tanh and exp, the gathers) on
// the CUDA cores, and at 16 to 256 rows the length of one tile's dependent
// chain (the weights' staging, then per coupling a few mma and their
// epilogues). The float32 kernels run every multiply-add on the CUDA cores
// as one scalar chain a row or a lane; here a Dense layer of 16 rows is 1
// to 8 mma.
//
// The design: one warp, one tile of 16 rows (the mma's M). A CTA is
// kMmaWarps warps, 16·kMmaWarps rows, sharing the staged weights. The
// rows' d ≤ 8 values sit in the warp's shared array (16 rows × kXs
// float32) and are picked by index reads.
// * Weights: each coupling's s and t nets, zero-padded to the kernels'
//   bounds (n_A, n_B ≤ 4, H = 16 or 32, 2 to 4 layers), are rounded to
//   bfloat16 once, as they are staged (the float32 kernels' rounding point
//   of W), and stored transposed, Wᵀ (out, in), so that the forward reads
//   its B fragments by ldmatrix and the backward's input cotangent G·Wᵀ
//   reads the same words by ldmatrix.trans. A row of Wᵀ is H + 8 bfloat16
//   (48 or 80 bytes), so the 8 rows one ldmatrix phase reads fall in 8
//   distinct 16-byte bank groups; the first layer's, 8 wide, 16 bytes.
//   Biases stay float32. A stack that fits in shared memory beside the
//   rest is staged whole once a CTA; a larger one a coupling at a time
//   between barriers. A coupling's float32 words come in by cp.async into
//   one of two landing slots (every copy in flight at once, none holding a
//   register), and a pass within shared memory rounds and transposes them
//   into the staged layout while the next coupling's copies land.
// * First layer: x_B goes into k-columns 0..3 of a 16×16 A fragment, the
//   rest zero; both nets multiply the same fragment.
// * Hidden layers: the float32 C fragments of two neighbouring n8 tiles
//   hold the same (row, column) pairs a thread holds of one k16 A
//   fragment, so each thread adds the bias, takes the leaky ReLU (slope
//   0.01) in float32, rounds to bfloat16 and packs, and that is the next
//   layer's A operand: the activations never leave registers.
// * Head: n_A ≤ 4 fills one n8 tile (columns 4..7 of Wᵀ zero). Lane (g, t)
//   with t < 2 holds s and t of k = 2t, 2t+1 at rows g and g + 8: tanh,
//   exp, y_A = x_A·exp(s) + t, written back by index; ld += Σ s is one
//   shuffle within the quad. The inverse keeps the float32 kernels' order:
//   blocks last to first, the odd coupling before the even one.
// * K5 recomputes the forward keeping each coupling's input in shared
//   memory, then per coupling from the last: rebuilds the conditioners,
//   writing each layer's input (bfloat16, the rounded value the product
//   takes) to shared memory; then per net and layer from the head down,
//   G = gc ⊙ slope (float32; the slope from the kept post-activation, 1
//   where it is ≥ 0), the input cotangent round(G)·Wᵀ by mma from its own
//   registers, and, after one barrier, the weight gradient gW = Hᵀ·G over
//   the CTA's 16·w rows as the product's k dimension: round(G) and the
//   kept H are read back as fragments by ldmatrix.trans. gb = Σ_rows G is
//   an exact float32 sum (a butterfly within each warp, then the warps in
//   order). Each CTA sums its tiles' gradients (its first tile writes,
//   later tiles add) in shared memory where they fit, else in its own
//   slice of the scratch buffer, and copies them to its slice;
//   coupling_bwd_reduce sums the slices in CTA order. K5 launches no more
//   CTAs than fit at once. No atomics, so two runs give the same bits.
// * Rounding points are the float32 kernels' policy's: W once at staging,
//   a layer's input and its cotangent once a layer, gW's two operands at
//   use. Only the float32 summation inside the tensor core differs: it
//   truncates, and the backward's products are unbiased (`unbias`). A
//   row's outputs (y, ld, gx) depend on that row alone: the mma computes
//   each row of its tile from that row.
// Why not wgmma or TMA: a conditioner's k is 4 to 32 and its n 4 to 32. A
// wgmma takes 64-row tiles from a warpgroup with B in shared memory, so at
// the demo's 16 rows it would be three quarters padding, and it would break
// the register-resident chain from one layer to the next. A wgmma row tile
// for batches of 64 rows and more is later work.

#pragma once
#include "coupling_kernels.cuh"

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
// One net's staged layout (bytes from its start): layer 0's Wᵀ (H rows of 8
// bfloat16: the n_B ≤ 4 inputs, zero-padded), each hidden layer's Wᵀ (H rows
// of H + 8), the head's Wᵀ (8 rows of H + 8: n_A ≤ 4 outputs), then the
// biases in float32 (H a layer, 8 for the head). A coupling is the s net
// then the t net.
// ---------------------------------------------------------------------------

__host__ __device__ inline int mma_w_off(int H, int l) {  // bfloat16 words
  return l == 0 ? 0 : 8 * H + (l - 1) * H * (H + 8);
}
__host__ __device__ inline int mma_bias_off(int H, int depth) {  // bytes
  return 2 * (8 * H + (depth - 2) * H * (H + 8) + 8 * (H + 8));
}
__host__ __device__ inline int mma_net_bytes(int H, int depth) {
  return mma_bias_off(H, depth) + 4 * ((depth - 1) * H + 8);
}
// the staged words of one net, padding included (not the rows' 8 spare
// words of hidden and head Wᵀ, which nothing reads)
__host__ __device__ inline int mma_net_words(int H, int depth) {
  return 8 * H + (depth - 2) * H * H + 8 * H + (depth - 1) * H + 8;
}

// Shared memory of one launch, in bytes: the weights (every coupling's, or
// one slot), then each warp's x rows; K5 also each warp's cotangent rows,
// every coupling's input for the CTA's rows, the kept layer inputs (x_B,
// and per net each hidden level) and two layers' G and bias-gradient
// partials; then the landing slots, each one coupling's float32 words at
// the kernels' bounds (`net_words`), which cp.async fills for the
// conversion to the staged layout: K4 one a coupling where they fit beside
// the resident stack (`lands`), else two; and for K5, where it fits, the
// CTA's partial weight gradients (`acc`, −1 where they go to device
// memory).
struct MmaLayout {
  int net, slot, resident, ring, lands;
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
  const int64_t land = take(2 * (int64_t)lay.ring);
  const int64_t all = (int64_t)n_c * lay.slot + rest;
  lay.resident = all <= kMmaMaxSmem;
  const int64_t weights = lay.resident ? (int64_t)n_c * lay.slot : lay.slot;
  need = weights + rest;
  if (need > kMmaMaxSmem) return kInvalid;
  lay.lands = 2;
  if (!backward && lay.resident && n_c > 2 &&
      all + (int64_t)(n_c - 2) * lay.ring <= kMmaMaxSmem) {
    lay.lands = n_c;
    rest += (int64_t)(n_c - 2) * lay.ring;
  }
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
  lay.land = (int)(weights + land);
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

// One layer's Wᵀ (OBP rows of IBP of the staged layout, rows S bfloat16
// apart) from its landed W (in × ow), each weight rounded to bfloat16 (to
// nearest even), the padding zero
template <int OBP, int IBP, int S>
__device__ __forceinline__ void mma_convert_w(const float* W, int in, int ow,
                                              __nv_bfloat16* wt) {
  for (int e = threadIdx.x; e < OBP * IBP; e += blockDim.x) {
    const int o = e / IBP, i = e - (e / IBP) * IBP;
    wt[o * S + i] =
        __float2bfloat16_rn(o < ow && i < in ? W[i * ow + o] : 0.f);
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
    auto* wt = reinterpret_cast<__nv_bfloat16*>(wn);
    float* bias = reinterpret_cast<float*>(wn + mma_bias_off(H, depth));
#pragma unroll 1
    for (int l = 0; l < depth; ++l) {
      const int in = st.width[g][l], ow = st.width[g][l + 1];
      if (l == 0)
        mma_convert_w<H, 8, 8>(from + off, in, ow, wt);
      else if (l < depth - 1)
        mma_convert_w<H, H, H + 8>(from + off, in, ow, wt + mma_w_off(H, l));
      else
        mma_convert_w<8, H, H + 8>(from + off, in, ow, wt + mma_w_off(H, l));
      off += in_bound(H, l) * out_bound(H, l, depth);
      const int ob = l < depth - 1 ? H : 8;
      for (int e = threadIdx.x; e < ob; e += blockDim.x)
        bias[l * H + e] = e < ow ? from[off + e] : 0.f;
      off += out_bound(H, l, depth);
    }
  }
}

// Every coupling into its resident slot: with a landing slot a coupling,
// all copied at once, then converted; else coupling c + 1 copied into one
// landing slot while coupling c is converted from the other.
template <bool INVERSE, int H>
__device__ void mma_stage_all(const Stack& st, const MmaLayout& lay,
                              unsigned char* sm) {
  const int n_c = 2 * st.n_blocks, words = lay.ring / 4;
  float* ring = reinterpret_cast<float*>(sm + lay.land);
  if (lay.lands >= n_c) {
#pragma unroll 1
    for (int c = 0; c < n_c; ++c)
      mma_fetch<INVERSE, H>(st, c, ring + c * words);
    cp_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < n_c; ++c) {
      int g, blk;
      coupling_at<INVERSE>(st, c, g, blk);
      mma_convert<H>(st, g, ring + c * words, sm + (int64_t)c * lay.slot,
                     lay.net);
    }
    __syncthreads();
    return;
  }
  mma_fetch<INVERSE, H>(st, 0, ring);
#pragma unroll 1
  for (int c = 0; c < n_c; ++c) {
    if (c + 1 < n_c) {
      mma_fetch<INVERSE, H>(st, c + 1, ring + ((c + 1) & 1) * words);
      cp_wait_one();
    } else {
      cp_wait_all();
    }
    __syncthreads();  // coupling c landed, every thread's words
    int g, blk;
    coupling_at<INVERSE>(st, c, g, blk);
    mma_convert<H>(st, g, ring + (c & 1) * words,
                   sm + (int64_t)c * lay.slot, lay.net);
    __syncthreads();  // its landing slot free for coupling c + 2
  }
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

// ---------------------------------------------------------------------------
// Fragments. Lane (g, t) = (lane / 4, lane % 4) holds of a 16×16 A fragment
// a[0] = (row g, k 2t..2t+1), a[1] = (row g + 8, the same k), a[2], a[3] the
// same at k + 8; of a 16×8 C fragment c[0..1] = (row g, n 2t..2t+1) and
// c[2..3] = (row g + 8, the same n); of a B fragment b0 = (k 2t..2t+1, n g),
// b1 = (k + 8, n g). A register holds two bfloat16, the lower k (or n) in
// its low half.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_at(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// lo and hi rounded to bfloat16 (to nearest even), packed
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float lo_of(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_of(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// ldmatrix: 8×8 matrices of bfloat16, each row 16 bytes at the address one
// lane gives (lanes 8j..8j+7 matrix j); .trans hands each lane the
// transpose's pair.
__device__ __forceinline__ void ldsm_x2(unsigned a, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4(unsigned a, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned a, uint32_t& r0,
                                          uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned a, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(a));
}

// c += A·B on the tensor cores: bfloat16 operands, float32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int NT>
__device__ __forceinline__ void mma_zero(float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
}

// The tensor core sums a product's terms exactly and truncates the sum
// toward zero to float32, so each result lies up to an ulp short of the
// exact sum, always toward zero. In the backward, where a cotangent is
// rounded to bfloat16 and summed over the batch, such biased values flip
// roundings in one direction and the flips add up coherently (on the card:
// a bias gradient at 262,144 rows 416 times the float32 K5's error from
// the plain version). So each backward product starts from zero and its
// result moves half an ulp away from zero, rounded to even (`unbias`: by
// an ulp where its last bit is odd, which leaves the error's mean at zero),
// and the k16 products of a wider sum add in float32, k in order
// (`mma_acc`). The forward's biased sums flip roundings too, but nothing
// sums them over the batch (through the host emulation, unbiasing the
// forward as well changes no gradient's error), so its products take the
// bias as the tensor core's addend and are used as they come.
__device__ __forceinline__ float unbias(float v) {
  const uint32_t u = __float_as_uint(v);
  return __uint_as_float(u + (u & 1u));
}

// c += A·B, the product from zero, unbiased (`unbias`), added in float32
__device__ __forceinline__ void mma_acc(float (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma16816(t, a0, a1, a2, a3, b0, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = c[i] + unbias(t[i]);
}

// ---------------------------------------------------------------------------
// The forward on a warp's 16 rows
// ---------------------------------------------------------------------------

// NT n8 tiles of C fragments holding a layer's bias (columns nt·8 + 2t, +1)
template <int NT>
__device__ __forceinline__ void mma_bias(const float* bias,
                                         float (&z)[NT][4], int lane) {
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + nt * 8 + t2);
    z[nt][0] = bb.x, z[nt][1] = bb.y, z[nt][2] = bb.x, z[nt][3] = bb.y;
  }
}

// z = x_B·W0 + b0 over H outputs; a0 the x_B fragment's k < 8 half (a0[0]
// rows g, a0[1] rows g + 8), the k ≥ 8 half zero, as W0's rows 8..15 would
// be.
template <int H>
__device__ __forceinline__ void mma_first(unsigned w0, const float* bias,
                                          const uint32_t (&a0)[2],
                                          float (&z)[H / 8][4], int lane) {
  uint32_t b[H / 8];
  if constexpr (H == 16) ldsm_x2(w0 + (lane & 15) * 16, b[0], b[1]);
  else ldsm_x4(w0 + lane * 16, b[0], b[1], b[2], b[3]);
  mma_bias(bias, z, lane);
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt)
    mma16816(z[nt], a0[0], a0[1], 0, 0, b[nt], 0);
}

// z = h·W + b over NT n8 tiles of outputs (H/8 for a hidden layer, 1 for
// the head), h the H inputs' A fragments; Wᵀ's rows H + 8 bfloat16 apart.
template <int H, int NT>
__device__ __forceinline__ void mma_dense(unsigned wt, const float* bias,
                                          const uint32_t (&a)[H / 16][4],
                                          float (&z)[NT][4], int lane) {
  constexpr int S = 2 * (H + 8);
  const int j = lane >> 3, r = lane & 7;
  mma_bias(bias, z, lane);
#pragma unroll
  for (int kc = 0; kc < H / 16; ++kc) {
    if constexpr (NT == 1) {
      uint32_t b0, b1;
      ldsm_x2(wt + r * S + (kc * 16 + (j & 1) * 8) * 2, b0, b1);
      mma16816(z[0], a[kc][0], a[kc][1], a[kc][2], a[kc][3], b0, b1);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(wt + ((nt + (j >> 1)) * 8 + r) * S + (kc * 16 + (j & 1) * 8) * 2,
                b0, b1, b2, b3);
        mma16816(z[nt], a[kc][0], a[kc][1], a[kc][2], a[kc][3], b0, b1);
        mma16816(z[nt + 1], a[kc][0], a[kc][1], a[kc][2], a[kc][3], b2, b3);
      }
    }
  }
}

// the next layer's A fragments from z through the leaky ReLU (slope 0.01,
// max(z, 0.01·z)) in float32, each value rounded once to bfloat16
template <int H>
__device__ __forceinline__ void mma_leaky(const float (&z)[H / 8][4],
                                          uint32_t (&a)[H / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = fmaxf(z[nt][i], 0.01f * z[nt][i]);
    a[nt / 2][(nt & 1) * 2] = pack2(v[0], v[1]);
    a[nt / 2][(nt & 1) * 2 + 1] = pack2(v[2], v[3]);
  }
}

// a level's A fragments into a kept buffer at the warp's rows (row stride
// H + 8 bfloat16)
template <int H>
__device__ __forceinline__ void mma_keep(unsigned char* at,
                                         const uint32_t (&a)[H / 16][4],
                                         int lane) {
  constexpr int S = 2 * (H + 8);
  const int g = lane >> 2, t4 = 4 * (lane & 3);
#pragma unroll
  for (int kc = 0; kc < H / 16; ++kc) {
    unsigned char* p = at + kc * 32 + t4;
    *reinterpret_cast<uint32_t*>(p + g * S) = a[kc][0];
    *reinterpret_cast<uint32_t*>(p + (g + 8) * S) = a[kc][1];
    *reinterpret_cast<uint32_t*>(p + g * S + 16) = a[kc][2];
    *reinterpret_cast<uint32_t*>(p + (g + 8) * S + 16) = a[kc][3];
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

// A lane's index reads for one group, set once a launch: for k = 2q and
// 2q + 1 (lane (g, q)) the transformed (x_A) and the conditioner (x_B)
// index, −1 past n_A or n_B (every k of a lane q ≥ 2), and n_A
struct MmaIdx {
  int a[2], b[2], na;
};

__device__ __forceinline__ void mma_idx(const Stack& st, int lane,
                                        MmaIdx (&idx)[2]) {
  const int q = lane & 3;
#pragma unroll
  for (int grp = 0; grp < 2; ++grp) {
    idx[grp].na = st.width[grp][st.depth];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      idx[grp].a[e] = entry(st.idx_a[grp], 2 * q + e);
      idx[grp].b[e] = entry(st.idx_b[grp], 2 * q + e);
    }
  }
}

// group grp's indices by selects (an index into idx would put it in local
// memory)
__device__ __forceinline__ MmaIdx mma_pick(const MmaIdx (&idx)[2], int grp) {
  MmaIdx r;
  r.na = grp ? idx[1].na : idx[0].na;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    r.a[e] = grp ? idx[1].a[e] : idx[0].a[e];
    r.b[e] = grp ? idx[1].b[e] : idx[0].b[e];
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
  const int ib0 = ix.b[0], ib1 = ix.b[1];
  uint32_t a0[2];
  a0[0] = pack2(ib0 >= 0 ? xs[g * kXs + ib0] : 0.f,
                ib1 >= 0 ? xs[g * kXs + ib1] : 0.f);
  a0[1] = pack2(ib0 >= 0 ? xs[(g + 8) * kXs + ib0] : 0.f,
                ib1 >= 0 ? xs[(g + 8) * kXs + ib1] : 0.f);
  if (keep.hx) {
    *reinterpret_cast<uint32_t*>(keep.x() + g * 16 + 4 * q) = a0[0];
    *reinterpret_cast<uint32_t*>(keep.x() + (g + 8) * 16 + 4 * q) = a0[1];
  }
  const unsigned w = smem_at(wc);
  const int bias0 = mma_bias_off(H, depth);
  auto bias = [&](int net, int l) {
    return reinterpret_cast<const float*>(wc + net * net_bytes + bias0) +
           l * H;
  };
  float z[2][H / 8][4];
  uint32_t a[2][H / 16][4];
#pragma unroll
  for (int net = 0; net < 2; ++net) {
    mma_first<H>(w + net * net_bytes, bias(net, 0), a0, z[net], lane);
    mma_leaky<H>(z[net], a[net]);
    if (keep.hx) mma_keep<H>(keep.mine(net, 1), a[net], lane);
  }
#pragma unroll 1
  for (int l = 1; l < depth - 1; ++l) {
#pragma unroll
    for (int net = 0; net < 2; ++net) {
      mma_dense<H, H / 8>(w + net * net_bytes + 2 * mma_w_off(H, l),
                          bias(net, l), a[net], z[net], lane);
      mma_leaky<H>(z[net], a[net]);
      if (keep.hx) mma_keep<H>(keep.mine(net, l + 1), a[net], lane);
    }
  }
#pragma unroll
  for (int net = 0; net < 2; ++net) {
    float zh[1][4];
    mma_dense<H, 1>(w + net * net_bytes + 2 * mma_w_off(H, depth - 1),
                    bias(net, depth - 1), a[net], zh, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool live = 2 * q + (i & 1) < ix.na;
      if (net == 0) s[i] = live ? th(zh[0][i]) : 0.f;
      else t[i] = live ? zh[0][i] : 0.f;
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
    *p = INVERSE ? (xa - t[i]) * ex(-s[i]) : xa * ex(s[i]) + t[i];
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
// of a tile. Asking for 2 CTAs of the most warps an SM leaves ptxas 128
// registers: with no minimum it kept K4 at H=32 to 64 and spilled.
template <bool INVERSE, int H>
__global__ void __launch_bounds__(32 * kMmaMaxWarps, 2)
coupling_fwd_mma(const float* __restrict__ x, float* __restrict__ y,
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
  MmaIdx idx[2];
  mma_idx(st, lane, idx);
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
      const MmaIdx ix = mma_pick(idx, grp);
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

// gc = round(G)·Wᵀ over a layer's inputs: K = the layer's outputs (NTO n8
// tiles of p; the head's one is K's first half), N = its inputs (NTI n8
// tiles). Wᵀ's rows (the outputs) are SW bytes apart; ldmatrix.trans hands
// each lane (k = output, n = input) pairs.
template <int NTO, int NTI, int SW>
__device__ __forceinline__ void mma_input_cot(unsigned wt,
                                              const uint32_t (&p)[NTO][2],
                                              float (&gc)[NTI][4], int lane) {
  const int j = lane >> 3, r = lane & 7;
  mma_zero(gc);
  if constexpr (NTO == 1) {  // the head: K = 8 outputs, the rest zero
#pragma unroll
    for (int nt = 0; nt < NTI; nt += 2) {
      uint32_t b0, b1;
      ldsm_x2_t(wt + r * SW + (nt + (j & 1)) * 16, b0, b1);
      mma_acc(gc[nt], p[0][0], p[0][1], 0, 0, b0, 0);
      mma_acc(gc[nt + 1], p[0][0], p[0][1], 0, 0, b1, 0);
    }
  } else {
#pragma unroll
    for (int kc = 0; kc < NTO / 2; ++kc) {
      const uint32_t a0 = p[2 * kc][0], a1 = p[2 * kc][1],
                     a2 = p[2 * kc + 1][0], a3 = p[2 * kc + 1][1];
      if constexpr (NTI == 1) {  // layer 0: its 8 inputs
        uint32_t b0, b1;
        ldsm_x2_t(wt + (kc * 16 + (lane & 15)) * SW, b0, b1);
        mma_acc(gc[0], a0, a1, a2, a3, b0, b1);
      } else {
#pragma unroll
        for (int nt = 0; nt < NTI; nt += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(wt + (kc * 16 + (j & 1) * 8 + r) * SW + (nt + (j >> 1)) * 16,
                    b0, b1, b2, b3);
          mma_acc(gc[nt], a0, a1, a2, a3, b0, b1);
          mma_acc(gc[nt + 1], a0, a1, a2, a3, b2, b3);
        }
      }
    }
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
      mma_acc(acc, a0, a1, a2, a3, b0, b1);
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
  const unsigned wn = smem_at(wc + net * lay.net);
  auto gbuf_at = [&](int b) { return sm + lay.gbuf + b * rows * S; };
  auto gbp_at = [&](int b) {
    return reinterpret_cast<float*>(sm + lay.gb) + b * w * H;
  };
  auto off = [&](int l, int k) { return st.leaf_off[grp][net][l][k]; };
  // the head: G = gout·(1 − s²) (s net) or gout
  {
    float G[1][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      G[0][i] = head ? gout[i] * (1.f - head[i] * head[i]) : gout[i];
    uint32_t p[1][2];
    mma_g_out<H, 1>(G, p, gbuf_at(buf) + warp * kMmaRows * S,
                    gbp_at(buf) + warp * H, lane);
    float gc[H / 8][4];
    mma_input_cot<1, H / 8, S>(wn + 2 * mma_w_off(H, depth - 1), p, gc,
                               lane);
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
        mma_input_cot<H / 8, H / 8, S>(wn + 2 * mma_w_off(H, l), ph, gc,
                                       lane);
        __syncthreads();
        mma_grads<H / 16, H / 8, false>(
            keep.level(net, l), S, gbuf_at(buf), S, gbp_at(buf), H, in, ow,
            off(l, 0) + (int64_t)blk * in * ow, off(l, 1) + (int64_t)blk * ow,
            part, first, w, warp, lane);
      } else {
        float g0[1][4];
        mma_input_cot<H / 8, 1, 16>(wn, ph, g0, lane);
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
// c walking tiles of 16·w rows c, c + G, ... 128 registers at most at
// H=16, as K4; 255 at H=32, where 128 spilled.
template <bool INVERSE, int H>
__global__ void __launch_bounds__(32 * kMmaMaxWarps, H == 16 ? 2 : 1)
coupling_bwd_mma(const float* __restrict__ x, const float* __restrict__ gy,
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
  MmaIdx idx[2];
  mma_idx(st, lane, idx);
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
      const MmaIdx ix = mma_pick(idx, grp);
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
      const MmaIdx ix = mma_pick(idx, grp);
      float s[4], t[4];
      mma_conditioners<H>(st, ix, wc, lay.net, xs, keep, s, t, lane);
      // `_coupling_bwd` on the heads' layout: gld reaches every s
      const int* ia = ix.a;
      const int* ib = ix.b;
      float g_xa[4], g_xb[4], g_s[4], g_t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = (g + 8 * (i >> 1)) * kXs, a = ia[i & 1],
                  b = ib[i & 1];
        const float xa = a >= 0 ? xs[row + a] : 0.f;
        const float g_ya = a >= 0 ? gs[row + a] : 0.f;
        g_xb[i] = b >= 0 ? gs[row + b] : 0.f;
        if (INVERSE) {
          const float e = ex(-s[i]);
          g_xa[i] = g_ya * e;
          g_t[i] = -g_xa[i];
          g_s[i] = -g_ya * (xa - t[i]) * e - gl[i >> 1];
        } else {
          const float e = ex(s[i]);
          g_xa[i] = g_ya * e;
          g_t[i] = g_ya;
          g_s[i] = g_ya * xa * e + gl[i >> 1];
        }
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
        if (ia[i & 1] >= 0) gs[row + ia[i & 1]] = g_xa[i];
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
  const auto kern = inverse ? &coupling_fwd_mma<true, H>
                            : &coupling_fwd_mma<false, H>;
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
  const auto kern = inverse ? &coupling_bwd_mma<true, H>
                            : &coupling_bwd_mma<false, H>;
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
