// Swin window attention fused with the output projection:
//   out[w, n, c] = sum_h sum_d attn_h[w](d, n) * W[c, h * D + d] + b[c]
// with q/k/v feature-major (Bw, H, D, N) bf16, a grouped additive f32 bias
// (P, H, N, N) (window w uses bias[w / (Bw / P)]), the projection weight W
// (C, H * D) bf16 in nn.Linear layout and its bias b (C,) bf16;
// out (Bw, N, C) bf16, token-major. Two launches per call.
//
// Replaces: the JAX package's ops/fused_attention.py `_fwd_kernel_attn_proj`
// (launched by `_attn_proj_fwd_pallas` / `fused_window_attention_proj`).
// Numerics follow it: the attention of csrc/window_attention.cuh (q scaled
// in bf16, f32 scores + bias, f32 row softmax, bf16 probabilities, f32 P.V),
// each head's attention output rounded to bf16 before the projection, the
// projection accumulated in f32 over all heads, b added in f32, one rounding
// to bf16. Only the order of the f32 sums differs: the TPU kernel starts its
// sum from b and adds head by head; here the GEMM sums over H * D in its K
// order and b comes last.
// Bound on the H100: bytes at Swin-L shapes (q/k/v, the bias blocks, W and
// the output; about 4 N^2 D + 2 N H D C flops per window, under the ridge).
// Design. The TPU kernel keeps every head of a window resident with an
// (N, C) f32 accumulator, 884 KB at C = 1536, beyond an SM. Here:
//  (a) the attention launch: the persistent register-resident attention of
//      csrc/window_attention.cuh (132 CTAs at every stage, each bias block
//      staged once per run of items), each warp writing its O (16 rows x D)
//      as bf16 pairs straight from the accumulator registers into
//      A = (Bw * N, H * D) at columns h * D .. h * D + D - 1: the rows the
//      projection reads, with no transpose;
//  (b) the projection launch: out = A . W^T + b on the TMA + wgmma GEMM of
//      csrc/gemm.cuh, so each tile of W is read once per output tile
//      through TMA, not once per 16 rows.
// A (7.1 MB at res4, 21.7 MB at res2) goes through device memory and mostly
// stays in the 50 MB L2.
#include "gemm.cuh"
#include "window_attention.cuh"

namespace {

// A[w * n + row][h * d + col]: a lane holds rows r0 + g and r0 + g + 8 and
// the column pair dn * 8 + c2 of each 8 columns of this head's D
struct TokenMajorStore {
  bf16* a;
  int hd, d, n, pairs;  // pairs: D even, so every pair is 4-byte aligned

  template <int NT>
  __device__ __forceinline__ void operator()(const float (&o)[NT][4], int w, int h, int r0,
                                             int lane) const {
    const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
    for (int dn = 0; dn < NT; ++dn) {
      const int col = dn * 8 + c2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (col < d && row < n) {
          bf16* dst = a + (static_cast<size_t>(w) * n + row) * hd + h * d + col;
          const uint32_t t = pack_bf16(o[dn][2 * r], o[dn][2 * r + 1]);
          if (pairs) {
            *reinterpret_cast<uint32_t*>(dst) = t;
          } else {
            const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&t);
            dst[0] = pair.x;
            if (col + 1 < d) dst[1] = pair.y;
          }
        }
      }
    }
  }
};

template <int DP>
__global__ void __launch_bounds__(32 * kMaxBlocks, 1)
window_attn_proj_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        bf16* __restrict__ a, int bw, int heads, int d, int n, int groups,
                        float scale, int vec) {
  window_attn_items<DP>(q, k, v, bias, bw, heads, d, n, groups, scale, vec,
                        TokenMajorStore{a, heads * d, d, n, d % 2 == 0});
}

template <int DP>
cudaError_t launch_attention(const void* q, const void* k, const void* v, const void* bias,
                             void* a, int bw, int heads, int d, int n, int groups, int ctas,
                             int vec, float scale, cudaStream_t stream) {
  const size_t smem = window_attn_smem(DP, n);
  cudaError_t err = cudaFuncSetAttribute(window_attn_proj_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  window_attn_proj_kernel<DP><<<ctas, 32 * ((n + 15) / 16), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(a), bw, heads, d, n, groups, scale,
      vec);
  return cudaGetLastError();
}

}  // namespace

// The attention launch: q, k, v (Bw, H, D, N) bf16; bias (P, H, N, N) f32
// with Bw % P == 0; a (Bw * N, H * D) bf16; `ctas` persistent CTAs; `vec` =
// N % 8 == 0 and q, k, v, bias 16-byte aligned (16-byte copies, paired bias
// loads). N <= 144, D <= 64.
PD_API int pd_window_proj_attention(const void* q, const void* k, const void* v,
                                    const void* bias, void* a, int bw, int heads, int d, int n,
                                    int groups, int ctas, int vec, float scale, void* stream) {
  if (groups <= 0 || bw % groups != 0 || ctas <= 0 || n <= 0 || n > 16 * kMaxBlocks ||
      d <= 0 || d > 64 || (vec && n % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1:
      return static_cast<int>(launch_attention<16>(q, k, v, bias, a, bw, heads, d, n, groups,
                                                   ctas, vec, scale, st));
    case 2:
      return static_cast<int>(launch_attention<32>(q, k, v, bias, a, bw, heads, d, n, groups,
                                                   ctas, vec, scale, st));
    case 3:
      return static_cast<int>(launch_attention<48>(q, k, v, bias, a, bw, heads, d, n, groups,
                                                   ctas, vec, scale, st));
    default:
      return static_cast<int>(launch_attention<64>(q, k, v, bias, a, bw, heads, d, n, groups,
                                                   ctas, vec, scale, st));
  }
}

// The projection launch: out (M, C) = a (M, KD) . w (C, KD)^T + b (C,), all
// bf16 and 16-byte aligned, KD and C multiples of 16; bn: the GEMM's column
// tile (128, 96 or 64).
PD_API int pd_window_proj_gemm(const void* a, const void* w, const void* b, void* out, int m,
                               int c, int kd, int bn, void* stream) {
  if (m <= 0 || c % 16 != 0 || kd % 16 != 0 || c <= 0 || kd <= 0 ||
      (bn != 64 && bn != 96 && bn != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      gemm<kBias>(bn, a, w, b, nullptr, out, m, c, kd, static_cast<cudaStream_t>(stream)));
}
