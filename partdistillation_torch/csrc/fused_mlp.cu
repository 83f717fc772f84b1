// Swin MLP half-block: y = fc2(GELU_erf(fc1(LN(x)))) (+ x), as three launches:
// a LayerNorm pass (csrc/fused_mlp.cuh) that writes the bf16 normalised rows,
// then one hand-written Hopper GEMM kernel twice, with the fc1 epilogue (+ b1,
// GELU, bf16 hidden) and the fc2 epilogue (+ b2, cast, + x in bf16).
//
// Replaces: the JAX package's ops/fused_mlp.py `_kernel` (launched by
// `_fwd_pallas` / `fused_ln_mlp`). Numerics follow that kernel: one-pass f32
// LayerNorm statistics (E[x^2] - mean^2), the normalised row cast to bf16,
// bf16 products with f32 accumulation, exact-erf GELU in f32, the hidden cast
// to bf16 before fc2, b2 added in f32, then the residual added in bf16. Only
// the order of the f32 sums differs.
// Bound on the H100: operations. The two products do 16*C^2 flops per token
// against 4*C bytes of activations in and out, far above the ridge at every
// Swin-L stage (C = 192 .. 1536); all four main-path shapes do the same
// n*C^2 work, 30.2 GFLOP.
// Design. The TPU kernel keeps both weight matrices and the hidden in VMEM;
// on an SM the hidden of a 128-row tile at C = 1536 alone is 1.5 MB, and a
// 64 x C f32 output accumulator at C = 1536 exceeds the register file. So the
// hidden goes through device memory in bf16 (19.7 MB at res4, mostly held by
// the 50 MB L2) and each product is one launch of the warp-specialised TMA +
// wgmma GEMM of csrc/gemm.cuh. Its column tile BN (128, 96 or 64) is chosen
// by the wrapper (ops/fused_mlp.py `mlp_plan`) for the fewest rounds of
// resident CTAs; every main-path GEMM has at least 132 output tiles.
#include "fused_mlp.cuh"
#include "gemm.cuh"

// x (n, c) -> out (n, c); xn (n, c) and hidden (n, f) are the caller's bf16
// scratch. bn1 / bn2: the column tiles of fc1 and fc2 (128, 96 or 64). Pointers
// to TMA-read tensors (xn, hidden, w1, w2) must be 16-byte aligned.
PD_API int pd_fused_ln_mlp(const void* x, const void* scale, const void* bias, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out, void* xn,
                           void* hidden, int n, int c, int f, float eps, int add_residual,
                           int bn1, int bn2, void* stream) {
  const auto tile_ok = [](int bn) { return bn == 64 || bn == 96 || bn == 128; };
  if (c % 16 != 0 || f % 16 != 0 || n <= 0 || !tile_ok(bn1) || !tile_ok(bn2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ln_mlp_norm_kernel<false><<<(n + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(bias), static_cast<bf16*>(xn), nullptr, n, c, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = gemm<kGeluHidden>(bn1, xn, w1, b1, nullptr, hidden, n, f, c, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = gemm<kBiasResidual>(bn2, hidden, w2, b2, add_residual ? x : nullptr, out, n, c, f, st);
  return static_cast<int>(err);
}
