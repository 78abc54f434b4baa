// K1–K3's C entries for float32 and float64 x and raw (the device code,
// and what each kernel replaces, in csrc/rqs_device.cuh).

#include "rqs_device.cuh"

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

int rqs_fwd_f32(
    const void* x, const void* raw, void* y, void* ld, long long n,
    long long stride_elem, long long stride_param, int staged, int smem_stride,
    int K, double B, int inverse, void* stream) {
  return launch_fwd<float, float>(
      x, raw, y, ld, n, stride_elem, stride_param, staged, smem_stride, K, B,
      inverse, stream);
}

int rqs_bwd_fwddir_f32(
    const void* x, const void* raw, const void* gy, const void* gld, void* gx,
    void* graw, long long n, long long stride_elem, long long stride_param,
    long long graw_stride_elem, long long graw_stride_param,
    long long graw_cols, int staged, int tile_rows, int smem_stride, int K,
    double B, void* stream) {
  return launch_bwd<float, float, false>(
      x, raw, gy, gld, gx, graw, n, stride_elem, stride_param,
      graw_stride_elem, graw_stride_param, graw_cols, staged, tile_rows,
      smem_stride, K, B, stream);
}

int rqs_bwd_invdir_f32(
    const void* x, const void* raw, const void* g_out, const void* gld,
    void* gx, void* graw, long long n, long long stride_elem,
    long long stride_param, long long graw_stride_elem,
    long long graw_stride_param, long long graw_cols, int staged,
    int tile_rows, int smem_stride, int K, double B, void* stream) {
  return launch_bwd<float, float, true>(
      x, raw, g_out, gld, gx, graw, n, stride_elem, stride_param,
      graw_stride_elem, graw_stride_param, graw_cols, staged, tile_rows,
      smem_stride, K, B, stream);
}

int rqs_fwd_f64(
    const void* x, const void* raw, void* y, void* ld, long long n,
    long long stride_elem, long long stride_param, int staged, int smem_stride,
    int K, double B, int inverse, void* stream) {
  return launch_fwd<double, double>(
      x, raw, y, ld, n, stride_elem, stride_param, staged, smem_stride, K, B,
      inverse, stream);
}

int rqs_bwd_fwddir_f64(
    const void* x, const void* raw, const void* gy, const void* gld, void* gx,
    void* graw, long long n, long long stride_elem, long long stride_param,
    long long graw_stride_elem, long long graw_stride_param,
    long long graw_cols, int staged, int tile_rows, int smem_stride, int K,
    double B, void* stream) {
  return launch_bwd<double, double, false>(
      x, raw, gy, gld, gx, graw, n, stride_elem, stride_param,
      graw_stride_elem, graw_stride_param, graw_cols, staged, tile_rows,
      smem_stride, K, B, stream);
}

int rqs_bwd_invdir_f64(
    const void* x, const void* raw, const void* g_out, const void* gld,
    void* gx, void* graw, long long n, long long stride_elem,
    long long stride_param, long long graw_stride_elem,
    long long graw_stride_param, long long graw_cols, int staged,
    int tile_rows, int smem_stride, int K, double B, void* stream) {
  return launch_bwd<double, double, true>(
      x, raw, g_out, gld, gx, graw, n, stride_elem, stride_param,
      graw_stride_elem, graw_stride_param, graw_cols, staged, tile_rows,
      smem_stride, K, B, stream);
}

}  // extern "C"
