// Fused rational-quadratic-spline (RQS) kernels for Hopper (sm_90a).
//
// What each entry replaces (normalizingflows/jl_tpu/ops/rqs_pallas.py):
//   K1  rqs_fwd<INVERSE>   `_fwd_kernel` (`_tile_tables` + `_tile_transform`),
//                          launched by `_call_fwd` for `rqs_fused_t` /
//                          `rqs_fused`; INVERSE=true is the same call site
//                          with inverse=True (the quadratic-root solve).
//                          Through raw's strides it also computes
//                          `_fwd_kernel_e` (`_call_fwd_e`, elem-major raw
//                          with padded columns) and `_fwd_kernel_rows`
//                          (`_call_fwd_rows`, an (R, N/R) element view).
//   K2  rqs_bwd_fwddir     `_bwd_kernel` with ANALYTIC_BWD=True, i.e.
//                          `_tile_bwd_analytic`, launched by `_call_bwd`: the
//                          closed-form VJP of the forward direction; with
//                          graw's strides and zeroed pad columns, the forward
//                          direction of `_bwd_kernel_e` (`_call_bwd_e`).
//   K3  rqs_bwd_invdir     `_bwd_kernel` for inverse=True, i.e.
//                          `_tile_bwd_analytic_inverse`: the VJP of the
//                          inverse direction by the implicit function theorem
//                          (the density path: log_prob gradients); likewise
//                          the inverse direction of `_bwd_kernel_e`.
//
// Per element: softmax widths and heights with the min-bin floor, an exact
// left-to-right running sum into knots pinned at ±B, softplus interior
// derivatives (boundary derivatives 1), the bin found by compare-and-count,
// a compare-and-select "gather" of the bin's endpoints, then the spline
// value and log-derivative (spans clamped at 1e-6·2B); the identity with
// log-det 0 outside [−B, B]. Same operation order as the Pallas tile and as
// the plain torch transcription in ops/rqs_cuda.py; built with --fmad=false
// (no a*b+c contraction) the kernel rounds as that transcription does, and
// never with --use_fast_math (approximate exp/log/division move log-dets).
//
// What bounds it on this card: memory, then instruction issue. K1 reads
// 3K words per element (x and the 3K−1 raw parameters) and writes 2 (y,
// ld); K2 and K3 read 3K+2 (x, raw, gy, gld) and write 3K (gx, graw). The
// IEEE divisions, exp, log1p and log without contraction take several
// instructions each; chip_smoke.py phase 2 counts K1's SASS statically
// (cuobjdump) and the time that count would take to issue (PERF.md §6).
//
// Design: one thread per element. K is a template parameter (8 and 10,
// the values the repo's configs use) and every loop over K is unrolled, so
// the K-length tables live in registers: indexing a local array by the
// runtime bin index would spill it to local memory, hence the
// compare-and-select. raw is read through (stride_elem, stride_param), so
// the conditioner's native elem-major (N, 3K−1) view, a padded
// (N, P > 3K−1) layout and the param-major (3K−1, N) layout go through one
// kernel and no transpose is materialised. K2/K3 write gx and graw through
// graw's own (stride_elem, stride_param) into an (N, P ≥ 3K−1) buffer, the
// P − (3K−1) pad columns set to exact zeros; each thread owns its
// element's row, so no atomics.
//
// K1's staged tile (STAGED, every elem-major raw): in the elem-major
// layout neighbouring threads' rows are 3K−1 words apart, so a thread that
// reads its own row touches a different 32-byte sector at every load. Each
// CTA of kThreads instead copies its tile of kThreads rows × 3K−1 columns
// into shared memory by cp.async, neighbouring threads on neighbouring
// 16-byte chunks where the tile is dense and aligned (the conditioner's
// (N, 3K−1) output: one contiguous run) and on neighbouring words
// otherwise (padded raw, any stride); nothing in flight holds a register,
// and x is read while the copy is in flight. After cp.async.wait_group 0
// and a barrier each thread computes from its row there and writes y and
// ld directly (coalesced); a thread past n reaches the barrier and stores
// nothing. Shared row stride S = 3K−1 (odd: thread t's word j sits in bank
// (t·S + j) mod 32). One tile a CTA, as K2/K3: a ring of two stages in a
// grid of resident CTAs, each walking several tiles with the next one's
// copy in flight, was slower warm than this tile on the H100 (PERF.md §6),
// since at N = 131,072 the grid is little more than one wave.
// Param-major raw is coalesced as it is and keeps the direct read
// (STAGED=false). The arithmetic is that of fwd_elem on both paths, so the
// bits are the same; the registers each is planned for are FwdMinBlocks'.
//
// K2/K3's staged tile (STAGED, every elem-major raw): in the elem-major
// layout neighbouring threads' rows are 3K−1 words apart, so a thread that
// reads or writes its own row touches a different 32-byte sector at every
// load and store. Each CTA instead copies its (rows × (3K−1)) raw tile into
// shared memory with neighbouring threads on neighbouring words (16-byte
// vectors where the tile is dense and aligned, as in the conditioner's
// (N, 3K−1) output), computes from its row there, writes its graw row
// (gcols words, pad zeros included) over the same row, and after a barrier
// the CTA copies the (rows × gcols) graw tile out the same way. The shared
// row stride S is odd and ≥ gcols, so thread t's word j sits in bank
// (t·S + j) mod 32: no conflicts in f32, none in either 16-thread phase
// of an f64 access. A thread past n skips the math but reaches both
// barriers. Param-major raw is coalesced as it is and keeps the direct
// read (STAGED=false); which path and S the wrapper decides
// (ops/rqs_cuda.py `bwd_plan`). The arithmetic is the same on both paths,
// so the bits are; the registers each is planned for are BwdMinBlocks'.
//
// K3 recomputes the forward quantities at the root ξ* exactly as K1's
// inverse finds it, then: the explicit partials of ld = −(log P − 2 log D)
// at fixed ξ, the total cotangent reaching ξ, the implicit-function factor
// −g_ξ/(∂Y/∂ξ) with ∂Y/∂ξ = w·P/D², the forward map's partials ∂Y/∂θ at
// fixed ξ, and the same softmax/cumsum/softplus reverse as K2. Where a
// spline's slope nears the 1e-3 floor ∂Y/∂ξ is tiny and the factor large,
// in the Pallas tile as here.
//
// Left for a later PR: K1–K3 compute all K−1 softplus derivatives and read
// two (d_k, d_k1); K1 at the demo's N = 64 is one thread's dependent
// chain; K2/K3's copy-in, math and copy-out run in turn within a CTA,
// overlapped only across the CTAs an SM holds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr double kMinBinWidth = 1e-3;   // nflows defaults (ops/rqs.py)
constexpr double kMinBinHeight = 1e-3;
constexpr double kMinDerivative = 1e-3;
constexpr int kThreads = 256;

__device__ __forceinline__ float ex(float v) { return expf(v); }
__device__ __forceinline__ double ex(double v) { return exp(v); }
__device__ __forceinline__ float lg(float v) { return logf(v); }
__device__ __forceinline__ double lg(double v) { return log(v); }
__device__ __forceinline__ float lg1p(float v) { return log1pf(v); }
__device__ __forceinline__ double lg1p(double v) { return log1p(v); }
__device__ __forceinline__ float sqroot(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqroot(double v) { return sqrt(v); }
template <typename T>
__device__ __forceinline__ T maxv(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T minv(T a, T b) { return a < b ? a : b; }

// softmax over K values: max subtraction, sequential sum, division by it
template <typename T, int K>
__device__ __forceinline__ void softmax(const T (&r)[K], T (&p)[K]) {
  T m = r[0];
#pragma unroll
  for (int j = 1; j < K; ++j) m = maxv(m, r[j]);
  T s = T(0);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    p[j] = ex(r[j] - m);
    s += p[j];
  }
#pragma unroll
  for (int j = 0; j < K; ++j) p[j] = p[j] / s;
}

template <typename T>
__device__ __forceinline__ T softplus(T z) {
  return maxv(z, T(0)) + lg1p(ex(-(z < T(0) ? -z : z)));
}

// knot lo/hi tables of one grid from softmax probabilities: row 0 of lo is
// −B, row K−1 of hi is +B, and hi[j] = lo[j+1] = −B + 2B·Σ_{i≤j} bins[i]
template <typename T, int K>
__device__ __forceinline__ void knots(const T (&p)[K], double min_bin,
                                      double B, T (&lo)[K], T (&hi)[K]) {
  const T mb = T(min_bin), c = T(1.0 - min_bin * K);
  const T two_B = T(2.0 * B), negB = T(-B);
  T cum = T(0);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    T bin = mb + c * p[j];
    cum = (j == 0) ? bin : cum + bin;
    hi[j] = negB + two_B * cum;
  }
#pragma unroll
  for (int j = K - 1; j > 0; --j) lo[j] = hi[j - 1];
  lo[0] = negB;
  hi[K - 1] = T(B);
}

// Everything the forward and backward need about one element's bin.
template <typename T, int K>
struct Bin {
  T p_w[K], p_h[K], d_raw[K - 1];
  int k;
  T x_k, x_k1, y_k, y_k1, d_k, d_k1;
};

template <typename T, int K, bool INVERSE>
__device__ __forceinline__ void load_bin(const T* __restrict__ raw,
                                         int64_t se, int64_t sp, int64_t i,
                                         double B, T v, Bin<T, K>& bn) {
  T w_raw[K], h_raw[K];
  const T* row = raw + i * se;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    w_raw[j] = row[j * sp];
    h_raw[j] = row[(K + j) * sp];
  }
#pragma unroll
  for (int j = 0; j < K - 1; ++j) bn.d_raw[j] = row[(2 * K + j) * sp];

  softmax<T, K>(w_raw, bn.p_w);
  softmax<T, K>(h_raw, bn.p_h);
  T xs_lo[K], xs_hi[K], ys_lo[K], ys_hi[K], d_lo[K], d_hi[K];
  knots<T, K>(bn.p_w, kMinBinWidth, B, xs_lo, xs_hi);
  knots<T, K>(bn.p_h, kMinBinHeight, B, ys_lo, ys_hi);
  d_lo[0] = T(1);
  d_hi[K - 1] = T(1);
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    T interior = T(kMinDerivative) + softplus(bn.d_raw[j]);
    d_lo[j + 1] = interior;
    d_hi[j] = interior;
  }

  // bin: #{j : v >= lo_j} − 1, clipped; then compare-and-select the row
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) cnt += (v >= (INVERSE ? ys_lo[j] : xs_lo[j]));
  const int k = minv(maxv(cnt - 1, 0), K - 1);
  bn.k = k;
  bn.x_k = bn.x_k1 = bn.y_k = bn.y_k1 = bn.d_k = bn.d_k1 = T(0);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool on = (j == k);
    bn.x_k = on ? xs_lo[j] : bn.x_k;
    bn.x_k1 = on ? xs_hi[j] : bn.x_k1;
    bn.y_k = on ? ys_lo[j] : bn.y_k;
    bn.y_k1 = on ? ys_hi[j] : bn.y_k1;
    bn.d_k = on ? d_lo[j] : bn.d_k;
    bn.d_k1 = on ? d_hi[j] : bn.d_k1;
  }
}

// K1's element: the forward (INVERSE=false) or inverse (INVERSE=true) spline
// of xv by raw row r, read through (se, sp); the value into yv, the
// log-derivative into lv.
template <typename T, int K, bool INVERSE>
__device__ __forceinline__ void fwd_elem(const T* raw, int64_t se, int64_t sp,
                                         int64_t r, T xv, double B, T& yv,
                                         T& lv) {
  const T Bc = T(B);
  const bool inside = (xv >= -Bc) && (xv <= Bc);
  const T v = minv(maxv(xv, -Bc), Bc);

  Bin<T, K> bn;
  load_bin<T, K, INVERSE>(raw, se, sp, r, B, v, bn);

  const T tiny = T(1e-6 * 2.0 * B);
  const T w = maxv(bn.x_k1 - bn.x_k, tiny);
  const T h = maxv(bn.y_k1 - bn.y_k, tiny);
  const T s = h / w;
  const T dsum = bn.d_k1 + bn.d_k - T(2) * s;

  T xi;
  if (!INVERSE) {
    xi = (v - bn.x_k) / w;
  } else {
    const T dy = v - bn.y_k;
    const T a = h * (s - bn.d_k) + dy * dsum;
    const T b = h * bn.d_k - dy * dsum;
    const T c = -s * dy;
    const T disc = maxv(b * b - T(4) * a * c, T(0));
    xi = minv(maxv(T(2) * c / (-b - sqroot(disc)), T(0)), T(1));
  }
  const T xi1m = T(1) - xi;
  const T xi_prod = xi * xi1m;
  const T denom = s + dsum * xi_prod;
  const T deriv_num = (s * s) * (bn.d_k1 * xi * xi + T(2) * s * xi_prod +
                                 bn.d_k * xi1m * xi1m);
  T l = lg(deriv_num) - T(2) * lg(denom);
  T out;
  if (!INVERSE) {
    out = bn.y_k + h * (s * xi * xi + bn.d_k * xi_prod) / denom;
  } else {
    out = bn.x_k + xi * w;
    l = -l;
  }
  yv = inside ? out : xv;
  lv = inside ? l : T(0);
}

// softmax/cumsum reverse of one knot grid (`table_to_raw` in the Pallas
// tile): only row k of the lo/hi gradient tables is non-zero.
template <typename T, int K>
__device__ __forceinline__ void table_to_raw(int k, T g_lo_k, T g_hi_k,
                                             const T (&p)[K], double min_bin,
                                             double B, T* __restrict__ out,
                                             int64_t gsp) {
  const T two_B = T(2.0 * B);
  const T c = T(1.0 - min_bin * K);
  // g_c[j] = 2B·(g_hi[j] + g_lo[j+1]) for j < K−1: hi's pinned +B row and
  // lo's pinned −B row carry no gradient; then a reverse running sum
  T g_soft[K];
  T acc = T(0);
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    T g_c = T(0);
    if (j < K - 1) {
      const T oh = (j == k) ? T(1) : T(0);
      const T oh1 = (j + 1 == k) ? T(1) : T(0);
      g_c = two_B * (oh * g_hi_k + oh1 * g_lo_k);
    }
    acc = (j == K - 1) ? g_c : acc + g_c;
    g_soft[j] = c * acc;
  }
  // softmax VJP: p ⊙ (g − Σ p·g)
  T dot = T(0);
#pragma unroll
  for (int j = 0; j < K; ++j) dot += p[j] * g_soft[j];
#pragma unroll
  for (int j = 0; j < K; ++j) out[j * gsp] = p[j] * (g_soft[j] - dot);
}

// The endpoint gradients of one element's bin back to its raw row: widths
// and heights through table_to_raw, the interior derivatives through the
// softplus; pad columns [3K−1, gcols) get exact zeros.
template <typename T, int K>
__device__ __forceinline__ void bin_grads_to_raw(
    const Bin<T, K>& bn, T g_xk, T g_xk1, T g_yk, T g_yk1, T g_dk, T g_dk1,
    double B, T* __restrict__ out, int64_t gsp, int64_t gcols) {
  table_to_raw<T, K>(bn.k, g_xk, g_xk1, bn.p_w, kMinBinWidth, B, out, gsp);
  table_to_raw<T, K>(bn.k, g_yk, g_yk1, bn.p_h, kMinBinHeight, B,
                     out + K * gsp, gsp);
  // d_lo = [1, interior], d_hi = [interior, 1]: interior j is d_lo row j+1
  // and d_hi row j; softplus' VJP is the sigmoid
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const T oh_lo = (j + 1 == bn.k) ? T(1) : T(0);
    const T oh_hi = (j == bn.k) ? T(1) : T(0);
    const T g_interior = oh_lo * g_dk + oh_hi * g_dk1;
    const T sig = T(1) / (T(1) + ex(-bn.d_raw[j]));
    out[(2 * K + j) * gsp] = sig * g_interior;
  }
  for (int64_t j = 3 * K - 1; j < gcols; ++j) out[j * gsp] = T(0);
}

// K2's element: closed-form VJP of the forward direction with respect to x
// and raw. Reads raw row r through (se, sp), writes its graw row at `out`
// through gsp (pad columns up to gcols zeroed); returns gx. raw and out may
// be the same row of the staged tile: every word read is read before the
// first store, whose value depends on all of them.
template <typename T, int K>
__device__ __forceinline__ T fwddir_grads(const T* raw, int64_t se,
                                          int64_t sp, int64_t r, T xv,
                                          T gyv, T gldv, double B, T* out,
                                          int64_t gsp, int64_t gcols) {
  const T Bc = T(B);
  const bool inside = (xv >= -Bc) && (xv <= Bc);
  const T v = minv(maxv(xv, -Bc), Bc);

  Bin<T, K> bn;
  load_bin<T, K, false>(raw, se, sp, r, B, v, bn);
  const T d_k = bn.d_k, d_k1 = bn.d_k1;

  const T tiny = T(1e-6 * 2.0 * B);
  const T w_span = bn.x_k1 - bn.x_k, h_span = bn.y_k1 - bn.y_k;
  const T w = maxv(w_span, tiny);
  const T h = maxv(h_span, tiny);
  const T w_gate = (w_span > tiny) ? T(1) : T(0);  // maximum() gates
  const T h_gate = (h_span > tiny) ? T(1) : T(0);
  const T s = h / w;
  const T dsum = d_k1 + d_k - T(2) * s;

  const T xi = (v - bn.x_k) / w;
  const T xi1m = T(1) - xi;
  const T q = xi * xi1m;
  const T D = s + dsum * q;
  const T Ny = s * xi * xi + d_k * q;
  const T R = d_k1 * xi * xi + T(2) * s * q + d_k * xi1m * xi1m;
  const T Pd = (s * s) * R;

  // outside the box the forward is y = x, ld = 0: zero the cotangents
  const T gy_in = inside ? gyv : T(0);
  const T gld_in = inside ? gldv : T(0);

  const T gD = gy_in * (-h * Ny / (D * D)) + gld_in * (T(-2) / D);
  const T gP = gld_in / Pd;
  const T gNy = gy_in * h / D;
  const T g_h_direct = gy_in * Ny / D;
  const T g_yk_direct = gy_in;

  const T g_xi =
      (gD * dsum * (T(1) - T(2) * xi) +
       gNy * (T(2) * s * xi + d_k * (T(1) - T(2) * xi)) +
       gP * (s * s) *
           (T(2) * d_k1 * xi + T(2) * s * (T(1) - T(2) * xi) -
            T(2) * d_k * xi1m));
  const T g_s = (gD * (T(1) - T(2) * q) + gNy * xi * xi +
                 gP * (T(2) * s * R + T(2) * (s * s) * q));
  const T g_dk = gD * q + gNy * q + gP * (s * s) * xi1m * xi1m;
  const T g_dk1 = gD * q + gP * (s * s) * xi * xi;

  // s = h/w, ξ = (v − x_k)/w
  T g_h = g_h_direct + g_s / w;
  T g_w = -g_s * h / (w * w) - g_xi * xi / w;
  const T g_v = g_xi / w;

  g_w = g_w * w_gate;
  g_h = g_h * h_gate;
  const T g_xk1 = g_w;
  const T g_xk = -g_w - g_xi / w;
  const T g_yk1 = g_h;
  const T g_yk = g_yk_direct - g_h;

  bin_grads_to_raw<T, K>(bn, g_xk, g_xk1, g_yk, g_yk1, g_dk, g_dk1, B, out,
                         gsp, gcols);
  return inside ? g_v : gyv;
}

// K3's element: closed-form VJP of the inverse direction with respect to x
// and raw, by implicit differentiation of Y(ξ*; θ) = v (Pallas
// `_tile_bwd_analytic_inverse`). Here the incoming cotangents are those of
// the inverse's outputs: g_out of x = x_k + ξ*·w, gld of its log-det. Rows
// and return value as fwddir_grads.
template <typename T, int K>
__device__ __forceinline__ T invdir_grads(const T* raw, int64_t se,
                                          int64_t sp, int64_t r, T xv,
                                          T g_outv, T gldv, double B, T* out,
                                          int64_t gsp, int64_t gcols) {
  const T Bc = T(B);
  const bool inside = (xv >= -Bc) && (xv <= Bc);
  const T v = minv(maxv(xv, -Bc), Bc);

  Bin<T, K> bn;
  load_bin<T, K, true>(raw, se, sp, r, B, v, bn);
  const T d_k = bn.d_k, d_k1 = bn.d_k1;

  const T tiny = T(1e-6 * 2.0 * B);
  const T w_span = bn.x_k1 - bn.x_k, h_span = bn.y_k1 - bn.y_k;
  const T w = maxv(w_span, tiny);
  const T h = maxv(h_span, tiny);
  const T w_gate = (w_span > tiny) ? T(1) : T(0);  // maximum() gates
  const T h_gate = (h_span > tiny) ? T(1) : T(0);
  const T s = h / w;
  const T dsum = d_k1 + d_k - T(2) * s;

  // ξ* exactly as K1's inverse solves it
  const T dy = v - bn.y_k;
  const T a = h * (s - d_k) + dy * dsum;
  const T b = h * d_k - dy * dsum;
  const T c = -s * dy;
  const T disc = maxv(b * b - T(4) * a * c, T(0));
  const T xi = minv(maxv(T(2) * c / (-b - sqroot(disc)), T(0)), T(1));

  const T xi1m = T(1) - xi;
  const T q = xi * xi1m;
  const T D = s + dsum * q;
  const T Ny = s * xi * xi + d_k * q;
  const T R = d_k1 * xi * xi + T(2) * s * q + d_k * xi1m * xi1m;
  const T Pd = (s * s) * R;

  // outside the box the inverse is x = y, ld = 0: zero the cotangents
  const T go_in = inside ? g_outv : T(0);
  const T gld_in = inside ? gldv : T(0);

  // ld = −(log P − 2 log D): explicit partials at fixed ξ
  const T gP_e = -gld_in / Pd;
  const T gD_e = T(2) * gld_in / D;
  const T g_s_e = gD_e * (T(1) - T(2) * q) +
                  gP_e * (T(2) * s * R + T(2) * (s * s) * q);
  const T g_dk_e = gD_e * q + gP_e * (s * s) * xi1m * xi1m;
  const T g_dk1_e = gD_e * q + gP_e * (s * s) * xi * xi;

  // total cotangent reaching ξ: out = x_k + ξ·w, plus ld's ξ-derivative
  const T Dp = dsum * (T(1) - T(2) * xi);
  const T Pp = (s * s) * (T(2) * d_k1 * xi + T(2) * s * (T(1) - T(2) * xi) -
                          T(2) * d_k * xi1m);
  const T g_xi_tot = go_in * w - gld_in * (Pp / Pd - T(2) * Dp / D);

  // implicit function: Y(ξ) = y_k + h·Ny/D = v; ∂Y/∂ξ = w·P/D²
  const T dYdxi = w * Pd / (D * D);
  const T coef = -g_xi_tot / dYdxi;

  // ∂Y/∂θ at fixed ξ (the forward map's partials); ∂Y/∂y_k = 1
  const T Y_s = h * (xi * xi * D - Ny * (T(1) - T(2) * q)) / (D * D);
  const T Y_dk = h * q * (D - Ny) / (D * D);
  const T Y_dk1 = -h * Ny * q / (D * D);
  const T Y_h_dir = Ny / D;

  const T g_s_tot = g_s_e + coef * Y_s;
  const T g_dk = g_dk_e + coef * Y_dk;
  const T g_dk1 = g_dk1_e + coef * Y_dk1;
  const T g_h_dir = coef * Y_h_dir;
  // v reaches ξ through Y(ξ*) = v: ∂ξ/∂v = 1/(∂Y/∂ξ)
  const T g_v = g_xi_tot / dYdxi;

  // s = h/w; spans → knot endpoints through the max() clamps
  T g_w = go_in * xi - g_s_tot * h / (w * w);
  T g_h = g_h_dir + g_s_tot / w;
  g_w = g_w * w_gate;
  g_h = g_h * h_gate;
  const T g_xk1 = g_w;
  const T g_xk = go_in - g_w;
  const T g_yk1 = g_h;
  const T g_yk = coef - g_h;

  bin_grads_to_raw<T, K>(bn, g_xk, g_xk1, g_yk, g_yk1, g_dk, g_dk1, B, out,
                         gsp, gcols);
  return inside ? g_v : g_outv;
}

// Rows [0, nr) × columns [0, cols) from src (row stride s_row, column
// stride s_col) to dst (d_row, d_col), over the tile's linear index
// e = r·cols + c, kThreads apart: neighbouring threads take neighbouring
// columns, so an elem-major row is one coalesced run.
template <typename T>
__device__ __forceinline__ void copy_tile(const T* src, int64_t s_row,
                                          int64_t s_col, T* dst,
                                          int64_t d_row, int64_t d_col,
                                          int nr, int cols) {
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  const int dr = kThreads / cols, dc = kThreads % cols;
  while (r < nr) {
    dst[r * d_row + c * d_col] = src[r * s_row + c * s_col];
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// `count` contiguous words from src to dst, both 16-byte aligned: 16-byte
// vectors, kBatch of them in flight a thread, then the last words one by
// one. A bit copy: the tile keeps every value exactly.
template <typename T>
__device__ __forceinline__ void copy_dense(const T* src, T* dst, int count) {
  constexpr int kWords = 16 / sizeof(T), kBatch = 8;
  const int nv = count / kWords;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int base = threadIdx.x; base < nv; base += kBatch * kThreads) {
    uint4 buf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (base + u * kThreads < nv) buf[u] = s[base + u * kThreads];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (base + u * kThreads < nv) d[base + u * kThreads] = buf[u];
  }
  for (int e = nv * kWords + threadIdx.x; e < count; e += kThreads)
    dst[e] = src[e];
}

// The staged tiles (K1's, K2/K3's), viewed as T words
extern __shared__ __align__(16) unsigned char rqs_smem[];

template <typename T>
struct BwdArgs {
  const T* x;
  const T* raw;
  const T* gy;   // K3: the cotangent of the inverse's output
  const T* gld;
  T* gx;
  T* graw;
  int64_t n, se, sp, gse, gsp, gcols;
  double B;
  int stride;    // the staged tile's shared row stride S: odd, ≥ gcols
  bool vec_in;   // raw's tile dense (sp = 1, se = S) and 16-byte aligned
  bool vec_out;  // graw's tile dense (gsp = 1, gse = gcols = S), aligned
};

// One CTA of K2 (INVERSE=false) or K3: STAGED copies raw's tile in and
// graw's out through shared memory (elem-major raw); otherwise each thread
// reads and writes its own row in device memory (param-major raw).
template <typename T, int K, bool INVERSE, bool STAGED>
__device__ __forceinline__ void bwd_tile(const BwdArgs<T>& a) {
  constexpr int P = 3 * K - 1;
  T* tile = reinterpret_cast<T*>(rqs_smem);
  const int t = threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.x * kThreads, i = i0 + t;
  const int nr = (int)minv<int64_t>(kThreads, a.n - i0);
  if (STAGED) {
    const T* src = a.raw + i0 * a.se;
    if (a.vec_in) copy_dense(src, tile, (nr - 1) * a.stride + P);
    else copy_tile(src, a.se, a.sp, tile, a.stride, 1, nr, P);
    __syncthreads();
  }
  if (t < nr) {
    const T* raw = STAGED ? tile : a.raw;
    const int64_t se = STAGED ? a.stride : a.se, sp = STAGED ? 1 : a.sp;
    const int64_t r = STAGED ? t : i;
    T* out = STAGED ? tile + t * a.stride : a.graw + i * a.gse;
    const int64_t gsp = STAGED ? 1 : a.gsp;
    if constexpr (INVERSE)
      a.gx[i] = invdir_grads<T, K>(raw, se, sp, r, a.x[i], a.gy[i], a.gld[i],
                                   a.B, out, gsp, a.gcols);
    else
      a.gx[i] = fwddir_grads<T, K>(raw, se, sp, r, a.x[i], a.gy[i], a.gld[i],
                                   a.B, out, gsp, a.gcols);
  }
  if (STAGED) {
    __syncthreads();
    T* dst = a.graw + i0 * a.gse;
    const int cols = (int)a.gcols;
    if (a.vec_out) copy_dense(tile, dst, (nr - 1) * a.stride + cols);
    else copy_tile(tile, a.stride, 1, dst, a.gse, a.gsp, nr, cols);
  }
}

// The CTAs an SM that ptxas plans K2/K3's registers for: f32 direct 3 (at
// most 80 registers), f32 staged 2 (at most 128: at 80 it spilled 120–196
// bytes), f64 1. With the thread count alone ptxas took 64 at K=8 and
// spilled.
template <typename T, bool STAGED>
struct BwdMinBlocks {
  static constexpr int value = sizeof(T) == 4 ? (STAGED ? 2 : 3) : 1;
};

// K2: the forward direction's VJP.
template <typename T, int K, bool STAGED>
__global__ void __launch_bounds__(kThreads, BwdMinBlocks<T, STAGED>::value)
rqs_bwd_fwddir(const BwdArgs<T> a) {
  bwd_tile<T, K, false, STAGED>(a);
}

// K3: the inverse direction's VJP.
template <typename T, int K, bool STAGED>
__global__ void __launch_bounds__(kThreads, BwdMinBlocks<T, STAGED>::value)
rqs_bwd_invdir(const BwdArgs<T> a) {
  bwd_tile<T, K, true, STAGED>(a);
}

template <typename T>
struct FwdArgs {
  const T* x;
  const T* raw;
  T* y;
  T* ld;
  int64_t n, se, sp;
  double B;
  int stride;  // the staged tile's shared row stride S: odd, ≥ 3K−1
  bool vec;    // raw's tile dense (sp = 1, se = S = 3K−1), 16-byte aligned
};

// K1's staged tile (the CTA's kThreads rows × 3K−1 columns of raw) into
// `tile` by cp.async, committed as one group and not waited for. Where the
// tile is dense and aligned it is one contiguous run, copied as 16-byte
// chunks (the last words of a ragged tile one by one); otherwise word by
// word over the tile's linear index, as copy_tile walks it. Neighbouring
// threads take neighbouring chunks or words, so the loads coalesce, and
// nothing in flight holds a register.
template <typename T, int P>
__device__ __forceinline__ void stage_fwd_tile(const FwdArgs<T>& a,
                                               T* tile) {
  const int64_t i0 = (int64_t)blockIdx.x * kThreads;
  const int nr = (int)minv<int64_t>(kThreads, a.n - i0);
  const T* src = a.raw + i0 * a.se;
  if (a.vec) {
    constexpr int kWords = 16 / sizeof(T);
    const int count = nr * P, nv = count / kWords;
    for (int c = threadIdx.x; c < nv; c += kThreads)
      cp_chunk(tile + c * kWords, src + c * kWords);
    for (int e = nv * kWords + threadIdx.x; e < count; e += kThreads)
      cp_word(tile + e, src + e);
  } else {
    int r = threadIdx.x / P, c = threadIdx.x % P;
    constexpr int dr = kThreads / P, dc = kThreads % P;
    while (r < nr) {
      cp_word(tile + r * a.stride + c, src + r * a.se + c * a.sp);
      r += dr;
      c += dc;
      if (c >= P) {
        c -= P;
        ++r;
      }
    }
  }
  cp_commit();
}

// The CTAs of 256 threads an SM that ptxas plans K1's registers for: f32 3
// (at most 80 registers a thread; the staged K=10 takes 71, more than the
// 64 of 4), f64 1 (planned for 2, at most 128, the staged K=10 spilled).
template <typename T>
struct FwdMinBlocks {
  static constexpr int value = sizeof(T) == 4 ? 3 : 1;
};

// K1: forward (INVERSE=false) or inverse spline, one CTA of kThreads a
// tile. STAGED (elem-major raw): the tile's raw is copied into shared
// memory by cp.async while x is read, then each thread computes from its
// row there; a thread past n reaches the barrier and stores nothing.
// Otherwise (param-major raw, coalesced as it is) each thread reads its
// row directly. y and ld are written directly (coalesced).
template <typename T, int K, bool INVERSE, bool STAGED>
__global__ void __launch_bounds__(kThreads, FwdMinBlocks<T>::value)
rqs_fwd(const FwdArgs<T> a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < a.n;
  T yv, lv;
  if constexpr (STAGED) {
    T* tile = reinterpret_cast<T*>(rqs_smem);
    stage_fwd_tile<T, 3 * K - 1>(a, tile);
    const T xv = live ? a.x[i] : T(0);  // in flight during the copy
    cp_wait_all();
    __syncthreads();  // every thread's words of the tile
    if (!live) return;
    fwd_elem<T, K, INVERSE>(tile, a.stride, 1, threadIdx.x, xv, a.B, yv, lv);
  } else {
    if (!live) return;
    fwd_elem<T, K, INVERSE>(a.raw, a.se, a.sp, i, a.x[i], a.B, yv, lv);
  }
  a.y[i] = yv;
  a.ld[i] = lv;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// Raise a kernel's dynamic shared-memory cap to `bytes` past the default
// 48 KB; an error if the card cannot give it.
int allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int K, bool INVERSE, bool STAGED>
int launch_fwd_tile(const FwdArgs<T>& a, cudaStream_t st) {
  const auto kernel = &rqs_fwd<T, K, INVERSE, STAGED>;
  const size_t smem = STAGED ? (size_t)kThreads * a.stride * sizeof(T) : 0;
  const int err = allow_smem((const void*)kernel, smem);
  if (err) return err;
  kernel<<<blocks_for(a.n), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* raw, void* y, void* ld, int64_t n,
               int64_t se, int64_t sp, int staged, int stride, int K,
               double B, int inverse, void* stream) {
  if (staged && (stride < 3 * K - 1 || stride % 2 == 0))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  FwdArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.raw = static_cast<const T*>(raw);
  a.y = static_cast<T*>(y);
  a.ld = static_cast<T*>(ld);
  a.n = n;
  a.se = se;
  a.sp = sp;
  a.B = B;
  a.stride = stride;
  a.vec = staged && sp == 1 && se == 3 * K - 1 && stride == se &&
          aligned16(raw);
  const auto st = static_cast<cudaStream_t>(stream);
#define RQS_FWD(KK, INV)                                          \
  return staged ? launch_fwd_tile<T, KK, INV, true>(a, st)        \
                : launch_fwd_tile<T, KK, INV, false>(a, st)
  if (K == 8 && !inverse) RQS_FWD(8, false);
  if (K == 8) RQS_FWD(8, true);
  if (K == 10 && !inverse) RQS_FWD(10, false);
  if (K == 10) RQS_FWD(10, true);
#undef RQS_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename T, int K, bool INVERSE, bool STAGED>
int launch_bwd_tile(const BwdArgs<T>& a, cudaStream_t st) {
  void (*kernel)(BwdArgs<T>) = INVERSE ? &rqs_bwd_invdir<T, K, STAGED>
                                       : &rqs_bwd_fwddir<T, K, STAGED>;
  const size_t smem = STAGED ? (size_t)kThreads * a.stride * sizeof(T) : 0;
  const int err = allow_smem((const void*)kernel, smem);
  if (err) return err;
  kernel<<<blocks_for(a.n), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool INVERSE>
int launch_bwd(const void* x, const void* raw, const void* gy,
               const void* gld, void* gx, void* graw, int64_t n, int64_t se,
               int64_t sp, int64_t gse, int64_t gsp, int64_t gcols,
               int staged, int rows, int stride, int K, double B,
               void* stream) {
  if (n <= 0) return 0;
  if (gcols < 3 * K - 1 || rows != kThreads)
    return (int)cudaErrorInvalidValue;
  if (staged && (stride < gcols || stride % 2 == 0))
    return (int)cudaErrorInvalidValue;
  BwdArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.raw = static_cast<const T*>(raw);
  a.gy = static_cast<const T*>(gy);
  a.gld = static_cast<const T*>(gld);
  a.gx = static_cast<T*>(gx);
  a.graw = static_cast<T*>(graw);
  a.n = n;
  a.se = se;
  a.sp = sp;
  a.gse = gse;
  a.gsp = gsp;
  a.gcols = gcols;
  a.B = B;
  a.stride = stride;
  a.vec_in = staged && sp == 1 && se == stride && aligned16(raw);
  a.vec_out = staged && gsp == 1 && gse == gcols && gcols == stride &&
              aligned16(graw);
  const auto st = static_cast<cudaStream_t>(stream);
#define RQS_BWD(KK, ST) return launch_bwd_tile<T, KK, INVERSE, ST>(a, st)
  if (K == 8 && staged) RQS_BWD(8, true);
  if (K == 8) RQS_BWD(8, false);
  if (K == 10 && staged) RQS_BWD(10, true);
  if (K == 10) RQS_BWD(10, false);
#undef RQS_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers of contiguous x/y/ld/gy/gld/gx; raw element (i, p) is
// raw[i*stride_elem + p*stride_param], and graw element (i, p) for p <
// graw_cols is graw[i*graw_stride_elem + p*graw_stride_param] (columns
// 3K−1 and up are written as zeros). Each kernel takes the wrapper's plan
// (ops/rqs_cuda.py `fwd_plan`, `bwd_plan`): staged (1) or direct (0) and
// the staged tile's shared row stride (odd, ≥ 3K−1 for K1, ≥ graw_cols
// for K2/K3); K2/K3 also tile_rows, the CTA's threads (256). A plan the
// kernels do not take is an error before any launch. The launch goes to
// the calling thread's current device, which the wrapper sets to the
// tensors' device. Each entry returns the launch's cudaGetLastError() (0
// on success).
extern "C" {

int rqs_fwd_f32(const void* x, const void* raw, void* y, void* ld,
                long long n, long long stride_elem, long long stride_param,
                int staged, int smem_stride, int K, double B, int inverse,
                void* stream) {
  return launch_fwd<float>(x, raw, y, ld, n, stride_elem, stride_param,
                           staged, smem_stride, K, B, inverse, stream);
}

int rqs_fwd_f64(const void* x, const void* raw, void* y, void* ld,
                long long n, long long stride_elem, long long stride_param,
                int staged, int smem_stride, int K, double B, int inverse,
                void* stream) {
  return launch_fwd<double>(x, raw, y, ld, n, stride_elem, stride_param,
                            staged, smem_stride, K, B, inverse, stream);
}

int rqs_bwd_fwddir_f32(const void* x, const void* raw, const void* gy,
                       const void* gld, void* gx, void* graw, long long n,
                       long long stride_elem, long long stride_param,
                       long long graw_stride_elem,
                       long long graw_stride_param, long long graw_cols,
                       int staged, int tile_rows, int smem_stride, int K,
                       double B, void* stream) {
  return launch_bwd<float, false>(x, raw, gy, gld, gx, graw, n, stride_elem,
                                  stride_param, graw_stride_elem,
                                  graw_stride_param, graw_cols, staged,
                                  tile_rows, smem_stride, K, B, stream);
}

int rqs_bwd_fwddir_f64(const void* x, const void* raw, const void* gy,
                       const void* gld, void* gx, void* graw, long long n,
                       long long stride_elem, long long stride_param,
                       long long graw_stride_elem,
                       long long graw_stride_param, long long graw_cols,
                       int staged, int tile_rows, int smem_stride, int K,
                       double B, void* stream) {
  return launch_bwd<double, false>(x, raw, gy, gld, gx, graw, n, stride_elem,
                                   stride_param, graw_stride_elem,
                                   graw_stride_param, graw_cols, staged,
                                   tile_rows, smem_stride, K, B, stream);
}

int rqs_bwd_invdir_f32(const void* x, const void* raw, const void* g_out,
                       const void* gld, void* gx, void* graw, long long n,
                       long long stride_elem, long long stride_param,
                       long long graw_stride_elem,
                       long long graw_stride_param, long long graw_cols,
                       int staged, int tile_rows, int smem_stride, int K,
                       double B, void* stream) {
  return launch_bwd<float, true>(x, raw, g_out, gld, gx, graw, n, stride_elem,
                                 stride_param, graw_stride_elem,
                                 graw_stride_param, graw_cols, staged,
                                 tile_rows, smem_stride, K, B, stream);
}

int rqs_bwd_invdir_f64(const void* x, const void* raw, const void* g_out,
                       const void* gld, void* gx, void* graw, long long n,
                       long long stride_elem, long long stride_param,
                       long long graw_stride_elem,
                       long long graw_stride_param, long long graw_cols,
                       int staged, int tile_rows, int smem_stride, int K,
                       double B, void* stream) {
  return launch_bwd<double, true>(x, raw, g_out, gld, gx, graw, n, stride_elem,
                                  stride_param, graw_stride_elem,
                                  graw_stride_param, graw_cols, staged,
                                  tile_rows, smem_stride, K, B, stream);
}

}  // extern "C"
