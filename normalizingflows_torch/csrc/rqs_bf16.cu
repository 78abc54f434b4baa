// K1–K3's C entries for bfloat16: (x float32, raw bfloat16), the
// conditioner's raw under the bf16 compute_dtype policy (the counterpart
// of the JAX package's bf16 raw feed, models/spline.py:124-131, read and
// widened by `_tile_transform`, rqs_pallas.py:88-91, graw written in
// raw's dtype, :321, :457), and (x bfloat16, raw bfloat16), bfloat16
// parameters. The arithmetic is float32 in both, each output rounded once
// (the JAX kernels compute a bfloat16 x in bfloat16); built beside
// csrc/rqs.cu from the same device code (csrc/rqs_device.cuh), also with
// --fmad=false, so K1–K3 keep their plain versions' bits.
//
// What bounds them: memory, as in float32, with raw's 3K−1 words two
// bytes each: K1 reads 4 + 2(3K−1) bytes and writes 8 an element with a
// float32 x (2 + 2(3K−1) and 4 with a bfloat16 x).

#include "rqs_device.cuh"

// The entries' arguments are those of csrc/rqs.cu's.
extern "C" {

int rqs_fwd_f32_rbf16(
    const void* x, const void* raw, void* y, void* ld, long long n,
    long long stride_elem, long long stride_param, int staged, int smem_stride,
    int K, double B, int inverse, void* stream) {
  return launch_fwd<float, bf16>(
      x, raw, y, ld, n, stride_elem, stride_param, staged, smem_stride, K, B,
      inverse, stream);
}

int rqs_bwd_fwddir_f32_rbf16(
    const void* x, const void* raw, const void* gy, const void* gld, void* gx,
    void* graw, long long n, long long stride_elem, long long stride_param,
    long long graw_stride_elem, long long graw_stride_param,
    long long graw_cols, int staged, int tile_rows, int smem_stride, int K,
    double B, void* stream) {
  return launch_bwd<float, bf16, false>(
      x, raw, gy, gld, gx, graw, n, stride_elem, stride_param,
      graw_stride_elem, graw_stride_param, graw_cols, staged, tile_rows,
      smem_stride, K, B, stream);
}

int rqs_bwd_invdir_f32_rbf16(
    const void* x, const void* raw, const void* g_out, const void* gld,
    void* gx, void* graw, long long n, long long stride_elem,
    long long stride_param, long long graw_stride_elem,
    long long graw_stride_param, long long graw_cols, int staged,
    int tile_rows, int smem_stride, int K, double B, void* stream) {
  return launch_bwd<float, bf16, true>(
      x, raw, g_out, gld, gx, graw, n, stride_elem, stride_param,
      graw_stride_elem, graw_stride_param, graw_cols, staged, tile_rows,
      smem_stride, K, B, stream);
}

int rqs_fwd_bf16(
    const void* x, const void* raw, void* y, void* ld, long long n,
    long long stride_elem, long long stride_param, int staged, int smem_stride,
    int K, double B, int inverse, void* stream) {
  return launch_fwd<bf16, bf16>(
      x, raw, y, ld, n, stride_elem, stride_param, staged, smem_stride, K, B,
      inverse, stream);
}

int rqs_bwd_fwddir_bf16(
    const void* x, const void* raw, const void* gy, const void* gld, void* gx,
    void* graw, long long n, long long stride_elem, long long stride_param,
    long long graw_stride_elem, long long graw_stride_param,
    long long graw_cols, int staged, int tile_rows, int smem_stride, int K,
    double B, void* stream) {
  return launch_bwd<bf16, bf16, false>(
      x, raw, gy, gld, gx, graw, n, stride_elem, stride_param,
      graw_stride_elem, graw_stride_param, graw_cols, staged, tile_rows,
      smem_stride, K, B, stream);
}

int rqs_bwd_invdir_bf16(
    const void* x, const void* raw, const void* g_out, const void* gld,
    void* gx, void* graw, long long n, long long stride_elem,
    long long stride_param, long long graw_stride_elem,
    long long graw_stride_param, long long graw_cols, int staged,
    int tile_rows, int smem_stride, int K, double B, void* stream) {
  return launch_bwd<bf16, bf16, true>(
      x, raw, g_out, gld, gx, graw, n, stride_elem, stride_param,
      graw_stride_elem, graw_stride_param, graw_cols, staged, tile_rows,
      smem_stride, K, B, stream);
}

}  // extern "C"
