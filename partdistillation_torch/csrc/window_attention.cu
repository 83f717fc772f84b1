// Swin window attention on feature-major q/k/v (Bw, H, D, N) with a grouped
// additive f32 bias (P, H, N, N): window w uses bias[w / (Bw / P)]; the
// output is feature-major (Bw, H, D, N) bf16.
//
// Replaces: the JAX package's ops/fused_attention.py
// `_fwd_kernel_allheads_t` (launched by `_fused_periodic_fwd_pallas` /
// `fused_window_attention`). Numerics follow it (csrc/window_attention.cuh).
// Bound on the H100: bytes at Swin-L shapes. Per (window, head) the kernel
// reads 3 x D x N bf16 values and writes D x N, and each (group, head) bias
// block (N x N f32, 83 KB at N = 144) once; 4 x N^2 x D flops sit under the
// ridge. On the shifted blocks the bias outweighs q, k, v and out.
// Design: the persistent register-resident attention of
// csrc/window_attention.cuh; O is transposed to feature-major in registers
// (movmatrix) and written as 4-byte pairs, with no score or probability
// buffer in shared memory.
#include "window_attention.cuh"

namespace {

// out[w][h][d][i]: each 8 x 8 (rows, features) block transposed in
// registers, a lane then holds feature dn * 8 + g at rows c2, c2 + 1
struct FeatureMajorStore {
  bf16* out;
  int heads, d, n, vec;

  template <int NT>
  __device__ __forceinline__ void operator()(const float (&o)[NT][4], int w, int h, int r0,
                                             int lane) const {
    const int g = lane / 4, c2 = 2 * (lane % 4);
    bf16* ob = out + (static_cast<size_t>(w) * heads + h) * d * n;
#pragma unroll
    for (int dn = 0; dn < NT; ++dn) {
      const int feat = dn * 8 + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t t = movmatrix_trans(pack_bf16(o[dn][2 * r], o[dn][2 * r + 1]));
        const int row = r0 + 8 * r + c2;
        if (feat < d && row < n) {
          bf16* dst = ob + static_cast<size_t>(feat) * n + row;
          if (vec) {
            *reinterpret_cast<uint32_t*>(dst) = t;
          } else {
            const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&t);
            dst[0] = pair.x;
            if (row + 1 < n) dst[1] = pair.y;
          }
        }
      }
    }
  }
};

template <int DP>
__global__ void __launch_bounds__(32 * kMaxBlocks, 1)
window_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   bf16* __restrict__ out, int bw, int heads, int d, int n, int groups,
                   float scale, int vec) {
  window_attn_items<DP>(q, k, v, bias, bw, heads, d, n, groups, scale, vec,
                        FeatureMajorStore{out, heads, d, n, vec});
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   int bw, int heads, int d, int n, int groups, int ctas, int vec, float scale,
                   cudaStream_t stream) {
  const size_t smem = window_attn_smem(DP, n);
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  window_attn_kernel<DP><<<ctas, 32 * ((n + 15) / 16), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), bw, heads, d, n, groups, scale,
      vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (Bw, H, D, N) bf16; bias (P, H, N, N) f32 with Bw % P == 0;
// `ctas` persistent CTAs; `vec` = N % 8 == 0 and every pointer 16-byte
// aligned (16-byte copies, paired loads and stores). N <= 144, D <= 64.
PD_API int pd_window_attention(const void* q, const void* k, const void* v, const void* bias,
                               void* out, int bw, int heads, int d, int n, int groups, int ctas,
                               int vec, float scale, void* stream) {
  if (groups <= 0 || bw % groups != 0 || ctas <= 0 || n <= 0 || n > 16 * kMaxBlocks ||
      d <= 0 || d > 64 || (vec && n % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1:
      return static_cast<int>(launch<16>(q, k, v, bias, out, bw, heads, d, n, groups, ctas, vec,
                                         scale, st));
    case 2:
      return static_cast<int>(launch<32>(q, k, v, bias, out, bw, heads, d, n, groups, ctas, vec,
                                         scale, st));
    case 3:
      return static_cast<int>(launch<48>(q, k, v, bias, out, bw, heads, d, n, groups, ctas, vec,
                                         scale, st));
    default:
      return static_cast<int>(launch<64>(q, k, v, bias, out, bw, heads, d, n, groups, ctas, vec,
                                         scale, st));
  }
}
