// Swin window attention fused with the output projection:
//   out[w, n, c] = b[c] + sum_h sum_d attn_h[w](d, n) * W[c, h * D + d]
// with q/k/v feature-major (Bw, H, D, N) bf16, a grouped additive f32 bias
// (P, H, N, N) (window w uses bias[w / (Bw / P)]), the projection weight W
// (C, H * D) bf16 in nn.Linear layout and its bias b (C,) bf16;
// out (Bw, N, C) bf16, token-major.
//
// Replaces: the JAX package's ops/fused_attention.py `_fwd_kernel_attn_proj`
// (launched by `_attn_proj_fwd_pallas` / `fused_window_attention_proj`).
// Numerics follow it: q scaled by 1/sqrt(d) in bf16, f32 scores + bias, f32
// row softmax, probabilities in bf16 for P.V with f32 accumulation, the
// attention output rounded to bf16 before the projection, the projection
// accumulated in f32 over all heads, b added, one rounding to bf16.
// Bound on the H100: bytes at Swin-L shapes (q/k/v, the bias blocks, W and
// the output; about 4 N^2 D + 2 N H D C flops per window, under the ridge).
// Design: one CTA (8 warps) per (window, block of 16 query rows). Each head's
// attention for those rows runs as in csrc/window_attention.cu (k, v of the
// head staged in shared memory, WMMA bf16 products, the 16 x N f32 score
// tile and bf16 probabilities in shared memory) and its bf16 output is
// written into a 16 x (H * D) tile in shared memory. After the last head
// the CTA multiplies that tile by W^T (WMMA, W read straight from L2) into
// 16 x C. No attention output goes to device memory, and no head's attention
// is computed twice. The TPU kernel keeps every head of a whole window
// resident in VMEM with a (N, C) f32 accumulator; at C = 1536 that is 884 KB,
// beyond an SM's shared memory, hence the blocks of 16 rows.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // query rows per CTA

struct Layout {
  int np_, dp, kd;                 // N and D padded to 16; H * D
  int ld_s, ld_p, ld_o, ld_a;      // leading dimensions in shared memory
  size_t k_off, v_off, q_off, s_off, p_off, a_off, bytes;
};

__host__ __device__ inline Layout make_layout(int n, int d, int kd) {
  Layout L;
  L.np_ = (n + 15) / 16 * 16;
  L.dp = (d + 15) / 16 * 16;
  L.kd = kd;
  L.ld_s = L.np_ + 4;
  L.ld_p = L.np_ + 8;
  L.ld_o = L.dp + 4;
  L.ld_a = kd + 8;
  const size_t kv = static_cast<size_t>(L.dp) * L.np_ * 2;
  size_t sc = static_cast<size_t>(kRows) * (L.ld_s > L.ld_o ? L.ld_s : L.ld_o);
  if (sc < static_cast<size_t>(kWarps) * 256) sc = static_cast<size_t>(kWarps) * 256;
  L.k_off = 0;
  L.v_off = align128(kv);
  L.q_off = L.v_off + align128(kv);
  L.s_off = L.q_off + align128(static_cast<size_t>(L.dp) * kRows * 2);
  L.p_off = L.s_off + align128(sc * 4);
  L.a_off = L.p_off + align128(static_cast<size_t>(kRows) * L.ld_p * 2);
  L.bytes = L.a_off + align128(static_cast<size_t>(kRows) * L.ld_a * 2);
  return L;
}

__global__ void __launch_bounds__(kThreads)
window_attn_proj_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const bf16* __restrict__ wproj, const bf16* __restrict__ bproj,
                        bf16* __restrict__ out, int bw, int heads, int d, int n, int c,
                        int groups, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(n, d, heads * d);
  const int np_ = L.np_, dp = L.dp;
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k_off);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v_off);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q_off);
  float* sc = reinterpret_cast<float*>(smem + L.s_off);
  bf16* pr = reinterpret_cast<bf16*>(smem + L.p_off);
  bf16* as = reinterpret_cast<bf16*>(smem + L.a_off);
  const int r0 = blockIdx.x * kRows, w = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16 qscale = __float2bfloat16(scale);
  const bf16 zero = __float2bfloat16(0.f);
  const int per_group = bw / groups;
  const int nt = np_ / 16, dtn = dp / 16;

  for (int hh = 0; hh < heads; ++hh) {
    const size_t base = (static_cast<size_t>(w) * heads + hh) * d * n;
    for (int e = threadIdx.x; e < dp * np_; e += kThreads) {
      const int dd = e / np_, j = e % np_;
      const bool in = dd < d && j < n;
      const size_t o = base + static_cast<size_t>(dd) * n + j;
      ks[e] = in ? k[o] : zero;
      vs[e] = in ? v[o] : zero;
    }
    for (int e = threadIdx.x; e < dp * kRows; e += kThreads) {
      const int dd = e / kRows, i = e % kRows, row = r0 + i;
      qs[e] = (dd < d && row < n)
                  ? __hmul(q[base + static_cast<size_t>(dd) * n + row], qscale)
                  : zero;
    }
    __syncthreads();

    // S = (scaled q)^T k for the 16 rows: (16 x dp) x (dp x np), f32.
    for (int jt = warp; jt < nt; jt += kWarps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < dtn; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, qs + kk * 16 * kRows, kRows);
        wmma::load_matrix_sync(b, ks + kk * 16 * np_ + jt * 16, np_);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sc + jt * 16, acc, L.ld_s, wmma::mem_row_major);
    }
    __syncthreads();

    // + grouped bias, f32 row softmax, probabilities to bf16 (padding = 0).
    const float* bblk =
        bias + (static_cast<size_t>(w / per_group) * heads + hh) * n * n;
    for (int i = warp; i < kRows; i += kWarps) {
      float* srow = sc + i * L.ld_s;
      bf16* prow = pr + i * L.ld_p;
      const int row = r0 + i;
      if (row < n) {
        const float* brow = bblk + static_cast<size_t>(row) * n;
        float mx = -INFINITY;
        for (int j = lane; j < n; j += 32) {
          const float s = srow[j] + brow[j];
          srow[j] = s;
          mx = fmaxf(mx, s);
        }
        mx = warp_max(mx);
        float sum = 0.f;
        for (int j = lane; j < n; j += 32) {
          const float e = expf(srow[j] - mx);
          srow[j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int j = lane; j < np_; j += 32)
          prow[j] = __float2bfloat16(j < n ? srow[j] / sum : 0.f);
      } else {
        for (int j = lane; j < np_; j += 32) prow[j] = zero;
      }
    }
    __syncthreads();

    // O = P v^T : (16 x np) x (np x dp), into the score buffer.
    float* ot = sc;
    for (int dt = warp; dt < dtn; dt += kWarps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < nt; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, pr + kk * 16, L.ld_p);
        wmma::load_matrix_sync(b, vs + dt * 16 * np_ + kk * 16, np_);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ot + dt * 16, acc, L.ld_o, wmma::mem_row_major);
    }
    __syncthreads();

    // this head's attention output, rounded to bf16, into columns h*D.. of A
    for (int e = threadIdx.x; e < kRows * d; e += kThreads) {
      const int i = e / d, dd = e % d;
      as[i * L.ld_a + hh * d + dd] = __float2bfloat16(ot[i * L.ld_o + dd]);
    }
    // the next head's loads touch neither the score buffer nor A; its score
    // product starts after the barrier that follows them
  }
  __syncthreads();

  // out rows = A (16 x HD) x W^T (HD x C) + b, f32, one 16 x 16 tile per step.
  float* stage = sc + warp * 256;
  for (int ct = warp; ct < c / 16; ct += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    const bf16* wcol = wproj + static_cast<size_t>(ct) * 16 * L.kd;
    for (int kk = 0; kk < L.kd / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, as + kk * 16, L.ld_a);
      wmma::load_matrix_sync(b, wcol + kk * 16, L.kd);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int i = e / 16, col = ct * 16 + e % 16, row = r0 + i;
      if (row < n)
        out[(static_cast<size_t>(w) * n + row) * c + col] =
            __float2bfloat16(stage[e] + __bfloat162float(bproj[col]));
    }
    __syncwarp();
  }
}

}  // namespace

PD_API int pd_window_attention_proj(const void* q, const void* k, const void* v,
                                    const void* bias, const void* wproj,
                                    const void* bproj, void* out, int bw, int heads,
                                    int d, int n, int c, int groups, float scale,
                                    void* stream) {
  if (groups <= 0 || bw % groups != 0 || (heads * d) % 16 != 0 || c % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(n, d, heads * d);
  cudaError_t err = cudaFuncSetAttribute(window_attn_proj_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, bw);
  window_attn_proj_kernel<<<grid, kThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(wproj), static_cast<const bf16*>(bproj),
      static_cast<bf16*>(out), bw, heads, d, n, c, groups, scale);
  return static_cast<int>(cudaGetLastError());
}
