// Swin MLP half-block in one kernel: y = fc2(GELU_erf(fc1(LN(x)))) (+ x).
//
// Replaces: the JAX package's ops/fused_mlp.py `_kernel` (launched by
// `_fwd_pallas` / `fused_ln_mlp`). Numerics follow that kernel: one-pass f32
// LayerNorm statistics (E[x^2] - mean^2), the normalised row cast to bf16,
// bf16 products with f32 accumulation, exact-erf GELU in f32, the hidden cast
// to bf16 before fc2, the residual added in bf16.
// Bound on the H100: operations. The two products do 16*C flops per token
// and byte for the weights is reused by every token, so the work sits far
// above the ridge at every Swin-L stage (C = 192 .. 1536).
// Design: one CTA of 8 warps per token tile of T rows. The normalised tile
// lives in shared memory as bf16. The 4C hidden axis does not fit on chip at
// C >= 768 (T x 4C x 2 bytes), so it is streamed in chunks of FC columns: fc1
// for one chunk goes to an f32 staging tile, bias + GELU turn it into a bf16
// chunk, and fc2 folds that chunk into output accumulators that stay in WMMA
// register fragments for the whole kernel. T is the largest power of two with
// T*C <= 24576, which keeps at most 96 output fragments (12 per warp) in
// registers; FC = 8192/T keeps the fc1 chunk at 32 fragments (4 per warp).
// Weights are read in nn.Linear layout (out, in) straight from global memory
// (L2) as column-major WMMA operands. No TMA or wgmma yet.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxOutFrags = 12;
constexpr int kMaxHidFrags = 4;
constexpr int kMaxTileElems = 24576;
constexpr int kHidTileElems = 8192;

int token_tile(int c) {
  int t = 128;
  while (t > 16 && t * c > kMaxTileElems) t >>= 1;
  return t;
}

size_t mlp_smem_bytes(int t, int c, int fc) {
  return align128(static_cast<size_t>(t) * (c + 8) * 2) +
         align128(static_cast<size_t>(t) * (fc + 4) * 4) +
         static_cast<size_t>(t) * (fc + 8) * 2;
}

__global__ void __launch_bounds__(kThreads)
ln_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
              const bf16* __restrict__ beta, const bf16* __restrict__ w1,
              const bf16* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ b2, bf16* __restrict__ out, int n, int c,
              int f, int tile_t, int fc, float eps, int add_residual) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int xs_ld = c + 8, st_ld = fc + 4, hs_ld = fc + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* st = reinterpret_cast<float*>(
      smem + align128(static_cast<size_t>(tile_t) * xs_ld * 2));
  bf16* hs = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(st) +
      align128(static_cast<size_t>(tile_t) * st_ld * 4));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = blockIdx.x * tile_t;

  // 1. LayerNorm prologue: one warp per row, one-pass f32 statistics.
  for (int r = warp; r < tile_t; r += kWarps) {
    const int row = t0 + r;
    bf16* xrs = xs + r * xs_ld;
    if (row < n) {
      const bf16* xr = x + static_cast<size_t>(row) * c;
      float s = 0.f, ss = 0.f;
      for (int j = lane; j < c; j += 32) {
        const float v = __bfloat162float(xr[j]);
        s += v;
        ss += v * v;
      }
      const float mean = warp_sum(s) / c;
      const float var = warp_sum(ss) / c - mean * mean;
      const float inv = rsqrtf(var + eps);
      for (int j = lane; j < c; j += 32) {
        const float v = (__bfloat162float(xr[j]) - mean) * inv;
        xrs[j] = __float2bfloat16(v * __bfloat162float(g[j]) +
                                  __bfloat162float(beta[j]));
      }
    } else {
      for (int j = lane; j < c; j += 32) xrs[j] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  const int rt_n = tile_t / 16;
  const int ct_n = c / 16;
  const int out_tiles = rt_n * ct_n;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxOutFrags];
#pragma unroll
  for (int i = 0; i < kMaxOutFrags; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int f0 = 0; f0 < f; f0 += fc) {
    const int fcv = min(fc, f - f0);
    const int hct_n = fcv / 16;
    const int hid_tiles = rt_n * hct_n;

    // 2. fc1 for this hidden chunk -> f32 staging tile.
#pragma unroll
    for (int i = 0; i < kMaxHidFrags; ++i) {
      const int tile = warp + i * kWarps;
      if (tile < hid_tiles) {
        const int rt = tile / hct_n, ct = tile % hct_n;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
        wmma::fill_fragment(hacc, 0.f);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        const bf16* wcol = w1 + static_cast<size_t>(f0 + ct * 16) * c;
        for (int k = 0; k < c; k += 16) {
          wmma::load_matrix_sync(a, xs + rt * 16 * xs_ld + k, xs_ld);
          wmma::load_matrix_sync(b, wcol + k, c);
          wmma::mma_sync(hacc, a, b, hacc);
        }
        wmma::store_matrix_sync(st + rt * 16 * st_ld + ct * 16, hacc, st_ld,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // 3. + b1, exact GELU in f32, cast to bf16.
    for (int e = threadIdx.x; e < tile_t * fcv; e += kThreads) {
      const int r = e / fcv, j = e % fcv;
      float h = st[r * st_ld + j] + __bfloat162float(b1[f0 + j]);
      h = 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
      hs[r * hs_ld + j] = __float2bfloat16(h);
    }
    __syncthreads();

    // 4. fc2: fold the chunk into the register accumulators.
#pragma unroll
    for (int i = 0; i < kMaxOutFrags; ++i) {
      const int tile = warp + i * kWarps;
      if (tile < out_tiles) {
        const int rt = tile / ct_n, ct = tile % ct_n;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        const bf16* wcol = w2 + static_cast<size_t>(ct * 16) * f + f0;
        for (int k = 0; k < fcv; k += 16) {
          wmma::load_matrix_sync(a, hs + rt * 16 * hs_ld + k, hs_ld);
          wmma::load_matrix_sync(b, wcol + k, f);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
    __syncthreads();
  }

  // 5. Epilogue: + b2 in f32, cast, residual added in bf16.
  float* wst = st + warp * 256;
#pragma unroll
  for (int i = 0; i < kMaxOutFrags; ++i) {
    const int tile = warp + i * kWarps;
    if (tile < out_tiles) {
      const int rt = tile / ct_n, ct = tile % ct_n;
      wmma::store_matrix_sync(wst, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = t0 + rt * 16 + e / 16;
        const int col = ct * 16 + e % 16;
        if (row < n) {
          const size_t o = static_cast<size_t>(row) * c + col;
          const bf16 y = __float2bfloat16(wst[e] + __bfloat162float(b2[col]));
          out[o] = add_residual
                       ? __float2bfloat16(__bfloat162float(x[o]) + __bfloat162float(y))
                       : y;
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

PD_API int pd_fused_ln_mlp(const void* x, const void* scale, const void* bias,
                           const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, int n, int c, int f,
                           float eps, int add_residual, void* stream) {
  if (c % 16 != 0 || f % 16 != 0 || c * 16 > kMaxTileElems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int t = token_tile(c);
  const int fc = kHidTileElems / t;
  const size_t smem = mlp_smem_bytes(t, c, fc);
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + t - 1) / t);
  ln_mlp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), n, c, f, t, fc, eps,
      add_residual);
  return static_cast<int>(cudaGetLastError());
}
