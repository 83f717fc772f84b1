// Swin window attention on feature-major q/k/v (Bw, H, D, N) with a grouped
// additive f32 bias (P, H, N, N): window w uses bias[w / (Bw / P)].
//
// Replaces: the JAX package's ops/fused_attention.py
// `_fwd_kernel_allheads_t` (launched by `_fused_periodic_fwd_pallas` /
// `fused_window_attention`). Numerics follow it: q is scaled by 1/sqrt(d) in
// q's dtype (bf16 x bf16, rounded) before the dot, scores accumulate in f32,
// bias added in f32, f32 row softmax, probabilities cast to bf16 for P.V with
// f32 accumulation, output rounded to bf16.
// Bound on the H100: bytes at Swin-L shapes. Per (window, head) the kernel
// moves 4 x D x N bf16 values plus the bias block and does 4 x N^2 x D flops
// (N = 144, D = 32): about 140 flop/byte of q/k/v/out, under the ridge.
// Design: one CTA (8 warps) per (window, head). q, k, v are staged in shared
// memory zero-padded to multiples of 16 (ragged N and D are masked, not
// padded in device memory). The f32 score matrix (144 x 144 = 83 KB) and the
// bf16 probabilities stay in shared memory; S = q^T k and O^T = P v^T run on
// bf16 WMMA fragments. The bias block is read from global memory (L2 holds
// it: all windows of a group share it).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   bf16* __restrict__ out, int bw, int heads, int d, int n,
                   int groups, float scale, int np_, int dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, w = blockIdx.y;
  const int ld_s = np_ + 4, ld_p = np_ + 8, ld_o = dp + 4;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + dp * np_;
  bf16* vs = ks + dp * np_;
  float* sc = reinterpret_cast<float*>(
      smem + align128(static_cast<size_t>(3) * dp * np_ * 2));
  const size_t sc_elems = static_cast<size_t>(np_) * max(ld_s, ld_o);
  bf16* pr = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sc) +
                                     align128(sc_elems * 4));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = kThreads / 32;

  const size_t base = (static_cast<size_t>(w) * heads + h) * d * n;
  const bf16 qscale = __float2bfloat16(scale);
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < dp * np_; e += kThreads) {
    const int dd = e / np_, i = e % np_;
    bf16 qv = zero, kv = zero, vv = zero;
    if (dd < d && i < n) {
      const size_t o = base + static_cast<size_t>(dd) * n + i;
      qv = __hmul(q[o], qscale);
      kv = k[o];
      vv = v[o];
    }
    qs[e] = qv;
    ks[e] = kv;
    vs[e] = vv;
  }
  __syncthreads();

  // S = (scaled q)^T k : (np x dp) x (dp x np), f32 accumulation.
  const int nt = np_ / 16, dtn = dp / 16;
  for (int tile = warp; tile < nt * nt; tile += nwarps) {
    const int it = tile / nt, jt = tile % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < dtn; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, qs + kk * 16 * np_ + it * 16, np_);
      wmma::load_matrix_sync(b, ks + kk * 16 * np_ + jt * 16, np_);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sc + it * 16 * ld_s + jt * 16, acc, ld_s,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // + grouped bias, f32 row softmax, probabilities to bf16 (padding = 0).
  const int per_group = bw / groups;
  const float* bblk = bias + (static_cast<size_t>(w / per_group) * heads + h) * n * n;
  for (int i = warp; i < np_; i += nwarps) {
    float* srow = sc + i * ld_s;
    bf16* prow = pr + i * ld_p;
    if (i < n) {
      const float* brow = bblk + static_cast<size_t>(i) * n;
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
      for (int j = lane; j < np_; j += 32) {
        prow[j] = __float2bfloat16(j < n ? srow[j] / sum : 0.f);
      }
    } else {
      for (int j = lane; j < np_; j += 32) prow[j] = zero;
    }
  }
  __syncthreads();

  // O^T = P v^T : (np x np) x (np x dp); reuses the score buffer.
  float* ot = sc;
  for (int tile = warp; tile < nt * dtn; tile += nwarps) {
    const int it = tile / dtn, dt = tile % dtn;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < nt; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, pr + it * 16 * ld_p + kk * 16, ld_p);
      wmma::load_matrix_sync(b, vs + dt * 16 * np_ + kk * 16, np_);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(ot + it * 16 * ld_o + dt * 16, acc, ld_o,
                            wmma::mem_row_major);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < d * n; e += kThreads) {
    const int dd = e / n, i = e % n;
    out[base + e] = __float2bfloat16(ot[i * ld_o + dd]);
  }
}

}  // namespace

PD_API int pd_window_attention(const void* q, const void* k, const void* v,
                               const void* bias, void* out, int bw, int heads,
                               int d, int n, int groups, float scale,
                               void* stream) {
  if (groups <= 0 || bw % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int np_ = (n + 15) / 16 * 16;
  const int dp = (d + 15) / 16 * 16;
  const size_t sc_elems = static_cast<size_t>(np_) * (np_ > dp ? np_ + 4 : dp + 4);
  const size_t smem = align128(static_cast<size_t>(3) * dp * np_ * 2) +
                      align128(sc_elems * 4) +
                      static_cast<size_t>(np_) * (np_ + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, bw);
  window_attn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), bw, heads, d, n, groups, scale, np_, dp);
  return static_cast<int>(cudaGetLastError());
}
