// Row LayerNorm over the last axis: two-pass f32 statistics, f32 affine,
// output in the input dtype (bf16 or f32).
//
// Replaces: the JAX package's ops/layer_norm.py `_ln_kernel` (launched by
// `_ln_forward` / `fused_layer_norm`).
// Bound on the H100: bytes. Each element is read once and written once with a
// handful of flops, far below the ~295 flop/byte ridge of the card.
// Design: one warp per row, eight rows per block. The row (at most 3072
// elements, 6 KB in bf16) is read three times by the same warp; the second and
// third reads hit L1, so device memory sees one read and one write. No shared
// memory and no block-wide synchronisation.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, int rows,
               int cols, float eps) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * cols;
  T* yr = out + static_cast<size_t>(row) * cols;

  float s = 0.f;
  for (int c = lane; c < cols; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / cols;
  float ss = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    ss += d * d;
  }
  const float inv = rsqrtf(warp_sum(ss) / cols + eps);
  for (int c = lane; c < cols; c += 32) {
    const float y = (to_f32(xr[c]) - mean) * inv;
    yr[c] = from_f32<T>(y * scale[c] + bias[c]);
  }
}

PD_API int pd_layer_norm(const void* x, const void* scale, const void* bias,
                         void* out, int rows, int cols, float eps, int is_bf16,
                         void* stream) {
  const int warps = 8;
  const dim3 grid((rows + warps - 1) / warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    ln_rows_kernel<bf16><<<grid, warps * 32, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<bf16*>(out), rows, cols, eps);
  } else {
    ln_rows_kernel<float><<<grid, warps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(out), rows, cols, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
