// Mask2Former masked cross-attention forward: softmax(q k^T + m) v with q
// pre-scaled and m a boolean block mask (B, 1|H, Q, K) shared across heads
// when its head axis is 1. The wrapper has already unblocked rows whose keys
// are all blocked, so every real query row attends at least one key.
//
// Replaces: the JAX package's ops/fused_attention.py `_fwd_kernel`
// (launched by `_fused_fwd_pallas` / `fused_masked_attention`). A blocked pair
// gets probability exactly 0 here, as the -1e9 additive mask gives there.
// Bound on the H100: bytes. With Q = 200 queries of D = 32 against up to
// K = 6400 keys, the (Q x K) uint8 mask alone outweighs q, k and v, and the
// flops (4 x Q x K x D per head) sit below the ridge.
// Design: flash-style. One CTA of 4 warps per (query tile of 64, head, image);
// each warp owns 16 query rows. K and V stream through shared memory in tiles
// of 64 keys (K/V of one head at K = 6400 is 800 KB and cannot stay on chip).
// Scores come from bf16 WMMA with f32 accumulation; the online softmax keeps
// a running f32 max and sum per row, rescales the f32 output accumulator in
// shared memory, and feeds bf16 exp(s - max) to the P.V product. The output is
// divided by the row sum at the end. When the caller passes an `lse` buffer
// (training), each real row's f32 log-sum-exp m + log(l) is written there for
// the backward kernels (`masked_attention_bwd.cu`); inference passes null.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;
constexpr int kBlockK = 64;
constexpr int kLdS = kBlockK + 4;
constexpr int kLdP = kBlockK + 8;

struct Layout {
  size_t qkv, s, p, o, ml, warp_bytes, total;
};

__host__ __device__ inline Layout layout(int d) {
  Layout L;
  const int ld = d + 8;
  L.qkv = align128(static_cast<size_t>(kBlockQ) * ld * 2);  // q, k, v tiles
  L.s = align128(static_cast<size_t>(16) * kLdS * 4);
  L.p = align128(static_cast<size_t>(16) * kLdP * 2);
  L.o = align128(static_cast<size_t>(16) * (d + 4) * 4);
  L.ml = align128(static_cast<size_t>(2) * 16 * 4);
  L.warp_bytes = L.s + L.p + L.o + L.ml;
  L.total = 3 * L.qkv + kWarps * L.warp_bytes;
  return L;
}

__global__ void __launch_bounds__(kThreads)
masked_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                   bf16* __restrict__ out, float* __restrict__ lse, int heads,
                   int nq, int nk, int d, int mask_heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(d);
  const int ld = d + 8, ld_o = d + 4;
  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.qkv);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * L.qkv);
  unsigned char* wbase = smem + 3 * L.qkv + warp * L.warp_bytes;
  float* sw = reinterpret_cast<float*>(wbase);
  bf16* pw = reinterpret_cast<bf16*>(wbase + L.s);
  float* ow = reinterpret_cast<float*>(wbase + L.s + L.p);
  float* mrun = reinterpret_cast<float*>(wbase + L.s + L.p + L.o);
  float* lrun = mrun + 16;

  const size_t bh = static_cast<size_t>(b) * heads + h;
  const bf16* qb = q + bh * nq * d;
  const bf16* kb = k + bh * nk * d;
  const bf16* vb = v + bh * nk * d;
  const bf16 zero = __float2bfloat16(0.f);

  for (int e = threadIdx.x; e < kBlockQ * d; e += kThreads) {
    const int r = e / d, dd = e % d;
    qs[r * ld + dd] = (q0 + r < nq) ? qb[static_cast<size_t>(q0 + r) * d + dd] : zero;
  }
  for (int e = lane; e < 16 * d; e += 32) ow[(e / d) * ld_o + e % d] = 0.f;
  if (lane < 16) {
    mrun[lane] = -INFINITY;
    lrun[lane] = 0.f;
  }

  // Lane pair (2r, 2r+1) owns query row r of this warp, 32 key columns each.
  const int r = lane >> 1, half = lane & 1, c0 = half * 32;
  const int qrow = q0 + warp * 16 + r;
  const uint8_t* mrow =
      mask + ((static_cast<size_t>(b) * mask_heads + (mask_heads == 1 ? 0 : h)) * nq +
              min(qrow, nq - 1)) * static_cast<size_t>(nk);
  const int dt_n = d / 16;

  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed (and q tile staged)
    for (int e = threadIdx.x; e < kBlockK * d; e += kThreads) {
      const int j = e / d, dd = e % d;
      const bool ok = k0 + j < nk;
      const size_t o = static_cast<size_t>(k0 + j) * d + dd;
      ks[j * ld + dd] = ok ? kb[o] : zero;
      vs[j * ld + dd] = ok ? vb[o] : zero;
    }
    __syncthreads();

    // S_w = q_w k^T : (16 x d) x (d x 64)
    for (int jt = 0; jt < kBlockK / 16; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < dt_n; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(a, qs + warp * 16 * ld + kk * 16, ld);
        wmma::load_matrix_sync(bfr, ks + jt * 16 * ld + kk * 16, ld);
        wmma::mma_sync(acc, a, bfr, acc);
      }
      wmma::store_matrix_sync(sw + jt * 16, acc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax update for row r (two lanes per row).
    float mx = -INFINITY;
    for (int j = c0; j < c0 + 32; ++j) {
      const int key = k0 + j;
      const bool ok = key < nk && qrow < nq && mrow[key] == 0;
      const float s = ok ? sw[r * kLdS + j] : -INFINITY;
      sw[r * kLdS + j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = mrun[r];
    const float m_new = fmaxf(m_old, mx);
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = expf(m_old - m_use);
    float sum = 0.f;
    for (int j = c0; j < c0 + 32; ++j) {
      const float e = expf(sw[r * kLdS + j] - m_use);
      pw[r * kLdP + j] = __float2bfloat16(e);
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    for (int dd = half * (d / 2); dd < (half + 1) * (d / 2); ++dd) ow[r * ld_o + dd] *= alpha;
    __syncwarp();
    if (half == 0) {
      mrun[r] = m_new;
      lrun[r] = lrun[r] * alpha + sum;
    }

    // O_w += P_w v : (16 x 64) x (64 x d), accumulator round-trips shared memory.
    for (int dt = 0; dt < dt_n; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, ow + dt * 16, ld_o, wmma::mem_row_major);
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(a, pw + kk * 16, kLdP);
        wmma::load_matrix_sync(bfr, vs + kk * 16 * ld + dt * 16, ld);
        wmma::mma_sync(acc, a, bfr, acc);
      }
      wmma::store_matrix_sync(ow + dt * 16, acc, ld_o, wmma::mem_row_major);
    }
    __syncwarp();
  }

  bf16* ob = out + bh * nq * d;
  for (int e = lane; e < 16 * d; e += 32) {
    const int rr = e / d, dd = e % d;
    const int row = q0 + warp * 16 + rr;
    if (row < nq) ob[static_cast<size_t>(row) * d + dd] = __float2bfloat16(ow[rr * ld_o + dd] / lrun[rr]);
  }
  if (lse != nullptr && half == 0 && qrow < nq) lse[bh * nq + qrow] = mrun[r] + logf(lrun[r]);
}

}  // namespace

PD_API int pd_masked_attention(const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* lse, int batch,
                               int heads, int nq, int nk, int d, int mask_heads,
                               void* stream) {
  if (d % 16 != 0 || d > 128 || nq <= 0 || nk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = layout(d).total;
  cudaError_t err = cudaFuncSetAttribute(
      masked_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, heads, batch);
  masked_attn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(out), static_cast<float*>(lse), heads, nq, nk, d, mask_heads);
  return static_cast<int>(cudaGetLastError());
}
