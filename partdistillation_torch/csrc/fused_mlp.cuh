// The LayerNorm row pass of the Swin MLP half-block, shared by its forward
// (csrc/fused_mlp.cu) and its backward (csrc/fused_mlp_bwd.cu), which also
// keeps each row's statistics.
#pragma once

#include "common.cuh"

namespace {

constexpr int kLnWarps = 8;  // rows a block: one a warp

// xn = bf16(LN(x) * g + beta): one warp per row, one-pass f32 statistics;
// with kStats also stats = (mean (n), 1 / std (n)) in f32.
template <bool kStats>
__global__ void __launch_bounds__(kLnWarps * 32)
ln_mlp_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const bf16* __restrict__ beta, bf16* __restrict__ xn,
                   float* __restrict__ stats, int n, int c, float eps) {
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n) return;
  const int c2 = c / 2;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + static_cast<size_t>(row) * c);
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(g);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(beta);
  __nv_bfloat162* yr = reinterpret_cast<__nv_bfloat162*>(xn + static_cast<size_t>(row) * c);
  float s = 0.f, ss = 0.f;
  for (int j = lane; j < c2; j += 32) {
    const float2 v = __bfloat1622float2(xr[j]);
    s += v.x + v.y;
    ss += v.x * v.x + v.y * v.y;
  }
  const float mean = warp_sum(s) / c;
  const float var = warp_sum(ss) / c - mean * mean;
  const float inv = rsqrtf(var + eps);
  for (int j = lane; j < c2; j += 32) {
    const float2 v = __bfloat1622float2(xr[j]);
    const float2 gg = __bfloat1622float2(g2[j]);
    const float2 bb = __bfloat1622float2(b2[j]);
    yr[j] = __floats2bfloat162_rn((v.x - mean) * inv * gg.x + bb.x,
                                  (v.y - mean) * inv * gg.y + bb.y);
  }
  if constexpr (kStats) {
    if (lane == 0) {
      stats[row] = mean;
      stats[n + row] = inv;
    }
  }
}

}  // namespace
