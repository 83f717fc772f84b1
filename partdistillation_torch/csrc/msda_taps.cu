// Deformable-attention sampling per tap: for every (slice bm, tap n)
//   out[bm, n, :] = attw[bm, n] * bilinear(v_whd[bm], x[bm, n], y[bm, n])
// with v_whd (BM, W, H * D) bf16, the level's value map x-major (pixel
// (x, y), channel c at [bm, x, y * D + c]), pixel coordinates x, y and
// weights attw (BM, N) f32; out (BM, N, D) bf16.
//
// Replaces: the JAX package's ops/msda_pallas.py `_kernel_expand` and
// `_kernel` (the "expand" and "sel" variants launched by `_forward`). The two
// compute the same function and differ only in how the TPU assembles the
// y-hat, so one kernel serves both. Numerics follow the port's plain
// version: f32 corner weights w_y * w_x * attw, corners outside the map read
// zero, f32 accumulation, one rounding to bf16.
// Bound on the H100: bytes (the map, x, y, attw read once, the output
// written once); about 8 * D flops per tap.
// Design: one warp per tap, lane = channel; each corner is one coalesced
// 2 * D-byte read of the x-major map, the accumulator stays in registers.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 4;  // channels up to 4 x 32

__global__ void __launch_bounds__(kThreads)
msda_taps_kernel(const bf16* __restrict__ v, const float* __restrict__ xs,
                 const float* __restrict__ ys, const float* __restrict__ attw,
                 bf16* __restrict__ out, int bm, int n, int h, int w, int d) {
  const long long tap =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (tap >= static_cast<long long>(bm) * n) return;
  const int slice = static_cast<int>(tap / n);
  const int chunks = (d + 31) / 32;
  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;

  const float x = xs[tap], y = ys[tap];
  const float x0f = floorf(x), y0f = floorf(y);
  if (x0f >= -1.f && x0f < w && y0f >= -1.f && y0f < h) {
    const float a = attw[tap];
    const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
    const float wx[2] = {__fsub_rn(1.f, fx), fx};
    const float wy[2] = {__fsub_rn(1.f, fy), fy};
    const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
    const bf16* vs = v + static_cast<size_t>(slice) * w * h * d;
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
      const int yi = y0 + cy;
      if (yi < 0 || yi >= h) continue;
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const int xi = x0 + cx;
        if (xi < 0 || xi >= w) continue;
        const float wgt = __fmul_rn(__fmul_rn(wy[cy], wx[cx]), a);
        const bf16* vp = vs + (static_cast<size_t>(xi) * h + yi) * d;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int dd = c * 32 + lane;
          if (c < chunks && dd < d) acc[c] = fmaf(wgt, to_f32(vp[dd]), acc[c]);
        }
      }
    }
  }
  bf16* op = out + tap * d;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int dd = c * 32 + lane;
    if (c < chunks && dd < d) op[dd] = __float2bfloat16(acc[c]);
  }
}

}  // namespace

PD_API int pd_msda_taps(const void* v, const void* x, const void* y, const void* attw,
                        void* out, int bm, int n, int h, int w, int d, void* stream) {
  if (d < 1 || d > 32 * kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(bm) * n * 32;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  msda_taps_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(v), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(attw),
      static_cast<bf16*>(out), bm, n, h, w, d);
  return static_cast<int>(cudaGetLastError());
}
