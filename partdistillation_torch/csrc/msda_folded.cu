// Multi-scale deformable attention sampling, P-folded, every level of one
// MSDeformAttn call in one launch:
//   out[b, q, m, :] = sum over levels l and points p of
//       attw[b, q, m, l, p] * bilinear(V_l[b, :, :, m, :], loc[b, q, m, l, p])
// with value (B, S, M, D) bf16 as the value projection emits it (level l is
// the rows start_l .. start_l + H_l * W_l, y-major), locations
// (B, Lq, M, L, P, 2) f32 normalised to [0, 1] as (x, y), weights
// (B, Lq, M, L, P) f32 or bf16; out (B, Lq, M * D) bf16.
//
// Replaces: the JAX package's ops/msda_pallas.py `_kernel_folded` (launched
// by `_forward_folded`, one launch per level). Numerics follow the port's
// plain version: pixel = loc * size - 0.5 (align_corners=False, no fused
// multiply-add), f32 corner weights w_y * w_x * attw, corners outside the
// map read zero, f32 accumulation over corners, points and levels, one
// rounding to bf16 at the end. With `pixel` set the locations are already
// pixel coordinates (the one-level `sample_level_folded`).
// Bound on the H100: bytes. One encoder layer at B = 2, 640^2 reads V
// (8.6 MB), the f32 locations (12.9 MB) and the weights, and writes 8.6 MB;
// it does about 8 * D flops per (query, head, level, point), far under the
// ridge.
// Design: the reference's im2col (ms_deform_im2col_cuda.cuh:243) with one
// warp per (image, query, head) and lane = channel: each corner tap is one
// coalesced 64-byte row of V (D = 32); the f32 accumulator lives in
// registers and the output row is one 64-byte store. The TPU kernel's hat
// matrices exist only because a TPU has no fast gather; here the gather is
// the cheap part.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;
constexpr int kMaxChunks = 4;  // channels per head up to 4 x 32

struct Levels {
  int count;
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

template <typename WT>
__global__ void __launch_bounds__(kThreads)
msda_folded_kernel(const bf16* __restrict__ value, const float* __restrict__ loc,
                   const WT* __restrict__ attw, bf16* __restrict__ out, int batch,
                   int s, int lq, int heads, int d, int points, Levels lv,
                   int pixel) {
  const long long warp_id =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp_id >= static_cast<long long>(batch) * lq * heads) return;
  const int m = static_cast<int>(warp_id % heads);
  const int b = static_cast<int>(warp_id / heads / lq);
  const int taps = lv.count * points;
  const float* lp = loc + warp_id * taps * 2;  // (L, P, 2) of this (b, q, m)
  const WT* ap = attw + warp_id * taps;
  const int chunks = (d + 31) / 32;

  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;

  for (int l = 0; l < lv.count; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    const size_t row = static_cast<size_t>(heads) * d;  // one pixel's stride
    const bf16* vl = value + (static_cast<size_t>(b) * s + lv.start[l]) * row +
                     static_cast<size_t>(m) * d;
    for (int p = 0; p < points; ++p) {
      const int t = l * points + p;
      float x = lp[2 * t], y = lp[2 * t + 1];
      if (!pixel) {
        x = __fsub_rn(__fmul_rn(x, static_cast<float>(w)), 0.5f);
        y = __fsub_rn(__fmul_rn(y, static_cast<float>(h)), 0.5f);
      }
      const float x0f = floorf(x), y0f = floorf(y);
      // both columns (rows) outside the map, or NaN: the tap reads zero
      if (!(x0f >= -1.f && x0f < w && y0f >= -1.f && y0f < h)) continue;
      const float a = to_f32(ap[t]);
      const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
      const float wx[2] = {__fsub_rn(1.f, fx), fx};
      const float wy[2] = {__fsub_rn(1.f, fy), fy};
      const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const int yi = y0 + cy;
        if (yi < 0 || yi >= h) continue;
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const int xi = x0 + cx;
          if (xi < 0 || xi >= w) continue;
          const float wgt = __fmul_rn(__fmul_rn(wy[cy], wx[cx]), a);
          const bf16* vp = vl + (static_cast<size_t>(yi) * w + xi) * row;
#pragma unroll
          for (int c = 0; c < kMaxChunks; ++c) {
            const int dd = c * 32 + lane;
            if (c < chunks && dd < d) acc[c] = fmaf(wgt, to_f32(vp[dd]), acc[c]);
          }
        }
      }
    }
  }
  bf16* op = out + warp_id * d;  // (B, Lq, M, D) == (B, Lq, M * D)
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int dd = c * 32 + lane;
    if (c < chunks && dd < d) op[dd] = __float2bfloat16(acc[c]);
  }
}

}  // namespace

// shapes: host array of `levels` (h, w) pairs; the levels' rows follow each
// other in value's S axis. attw_f32: weights are f32 (else bf16).
PD_API int pd_msda_folded(const void* value, const void* loc, const void* attw,
                          void* out, int batch, int s, int lq, int heads, int d,
                          int levels, int points, const int* shapes, int attw_f32,
                          int pixel, void* stream) {
  if (levels < 1 || levels > kMaxLevels || d < 1 || d > 32 * kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.count = levels;
  int start = 0;
  for (int l = 0; l < levels; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != s) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(batch) * lq * heads * 32;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* v = static_cast<const bf16*>(value);
  const float* l = static_cast<const float*>(loc);
  bf16* o = static_cast<bf16*>(out);
  if (attw_f32) {
    msda_folded_kernel<float><<<grid, kThreads, 0, st>>>(
        v, l, static_cast<const float*>(attw), o, batch, s, lq, heads, d, points, lv,
        pixel);
  } else {
    msda_folded_kernel<bf16><<<grid, kThreads, 0, st>>>(
        v, l, static_cast<const bf16*>(attw), o, batch, s, lq, heads, d, points, lv,
        pixel);
  }
  return static_cast<int>(cudaGetLastError());
}
