// The core of the hand-written window-attention kernels: Swin window
// attention on feature-major q/k/v (Bw, H, D, N) with a grouped additive f32
// bias (P, H, N, N), window w using bias[w / (Bw / P)], written out by the
// caller's store. csrc/window_attention.cu stores O feature-major (Bw, H, D,
// N); csrc/window_attention_proj.cu token-major, as the rows of the
// projection's input.
//
// Numerics follow the JAX package's ops/fused_attention.py Pallas kernels:
// q is scaled by 1/sqrt(d) in q's dtype (bf16 x bf16, rounded) before the
// dot, scores accumulate in f32, bias added in f32, exact f32 row softmax,
// probabilities rounded to bf16 for P.V with f32 accumulation; the store
// rounds O to bf16.
// Design: one warp per 16 query rows of a (window, head) (N = 144: 9 warps).
//  * q, k, v of a (window, head) arrive in shared memory by cp.async (16-byte
//    copies, rows padded to N + 8 so that ldmatrix is conflict-free; ragged
//    N or D are zero-padded there, never in device memory);
//  * S (16 x N) stays in registers: mma.sync m16n8k16 with q^T's A fragments
//    and k's B fragments both by ldmatrix.trans from the feature-major rows;
//  * the bias rows are added from paired f32 loads, the row softmax runs in
//    registers with quad shuffles (the whole row is there: exact, not
//    online), and P is repacked from the score registers as the A operand of
//    O = P v^T, v's B fragments by ldmatrix;
//  * the CTAs are persistent, one per SM (about 224 KB of shared memory and
//    up to 224 registers a thread: S never spills), each taking a contiguous
//    run of (window, head) items in (head, window) order, so consecutive
//    items share their bias block (ops/fused_attention.py
//    `window_attention_plan`). The bias block is staged in shared memory by
//    cp.async once per run, double-buffered, and the next item's q, k, v (and
//    its bias block when that changes) are in flight while this item's
//    products run: each (group, head) bias block comes from device memory
//    once per CTA that needs it.
#pragma once

#include "mma.cuh"

namespace {

constexpr int kMaxBlocks = 9;       // row blocks of 16: N <= 144
constexpr size_t kSmemMax = 232448;  // dynamic shared memory a CTA may use

// Shared memory: two bias blocks (N x N f32) and one or two stages of q, k, v
// ([D padded to 16][N padded to 16, + 8] bf16 each).
__host__ __device__ inline size_t bias_bytes(int n) {
  return align128(static_cast<size_t>(n) * n * 4);
}
__host__ __device__ inline size_t qkv_bytes(int dp, int n) {
  return static_cast<size_t>(3) * dp * ((n + 15) / 16 * 16 + 8) * 2;
}
__host__ __device__ inline int qkv_stages(int dp, int n) {
  return 2 * bias_bytes(n) + 2 * qkv_bytes(dp, n) <= kSmemMax ? 2 : 1;
}

// Dynamic shared memory of a launch.
__host__ __device__ inline size_t window_attn_smem(int dp, int n) {
  return 2 * bias_bytes(n) + qkv_stages(dp, n) * qkv_bytes(dp, n);
}

// Persistent: CTA c takes items [c U / G, (c + 1) U / G) of the U = H x Bw
// (window, head) items in (head, window) order, so consecutive items share a
// bias block until the group or head changes; item u is head u / Bw, window
// u % Bw, bias block (head, window / (Bw / P)). The caller's `store` writes
// each warp's O (16 rows x DP, f32 in the mma C layout) of item u.
template <int DP, typename Store>
__device__ __forceinline__ void window_attn_items(const bf16* __restrict__ q,
                                                  const bf16* __restrict__ k,
                                                  const bf16* __restrict__ v,
                                                  const float* __restrict__ bias, int bw,
                                                  int heads, int d, int n, int groups,
                                                  float scale, int vec, const Store& store) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nb = (n + 15) / 16, np_ = 16 * nb, ld = np_ + 8;
  const int nthreads = 32 * nb;
  const int per_group = bw / groups;
  const long long items = static_cast<long long>(heads) * bw;
  const int u0 = static_cast<int>(items * blockIdx.x / gridDim.x);
  const int u1 = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x);
  const int stages = qkv_stages(DP, n);
  const size_t tile = static_cast<size_t>(DP) * ld;  // elements of one of q, k, v
  float* bias_s[2] = {reinterpret_cast<float*>(smem),
                      reinterpret_cast<float*>(smem + bias_bytes(n))};
  bf16* stage0 = reinterpret_cast<bf16*>(smem + 2 * bias_bytes(n));

  // zero the q, k, v stages once: the copies below never touch the padding
  {
    uint4* z = reinterpret_cast<uint4*>(stage0);
    const int n16 = static_cast<int>(stages * 3 * tile * 2 / 16);
    for (int i = threadIdx.x; i < n16; i += nthreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // the bias block (group, head) of item u: bias[group][head]
  auto bias_key = [&](int u) { return ((u % bw) / per_group) * heads + u / bw; };
  auto load_bias = [&](int key, int buf) {
    const float* src = bias + static_cast<size_t>(key) * n * n;
    float* dst = bias_s[buf];
    if (vec) {
      for (int idx = threadIdx.x; idx < n * n / 4; idx += nthreads) {
        cp_async16(dst + 4 * idx, src + 4 * idx, true);
      }
    } else {
      for (int idx = threadIdx.x; idx < n * n; idx += nthreads) dst[idx] = src[idx];
    }
  };
  auto load_qkv = [&](int u, int st) {
    bf16* dst = stage0 + st * 3 * tile;
    const size_t base = (static_cast<size_t>(u % bw) * heads + u / bw) * d * n;
    const bf16* src[3] = {q + base, k + base, v + base};
    if (vec) {
      const int cpr = n / 8;  // 16-byte chunks per row
      for (int idx = threadIdx.x; idx < 3 * d * cpr; idx += nthreads) {
        const int t = idx / (d * cpr), rem = idx % (d * cpr);
        const int row = rem / cpr, ch = rem % cpr;
        cp_async16(dst + t * tile + row * ld + ch * 8, src[t] + row * n + ch * 8, true);
      }
    } else {
      for (int idx = threadIdx.x; idx < 3 * d * n; idx += nthreads) {
        const int t = idx / (d * n), rem = idx % (d * n);
        dst[t * tile + (rem / n) * ld + rem % n] = src[t][rem];
      }
    }
  };
  // the next item's q, k, v, and its bias block when that changes
  auto prefetch = [&](int u, int st, int bbuf) {
    if (bias_key(u) != bias_key(u - 1)) load_bias(bias_key(u), bbuf ^ 1);
    load_qkv(u, st);
    cp_async_commit();
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int r0 = warp * 16;
  const int row_a = r0 + g, row_b = r0 + g + 8;
  const __nv_bfloat162 qscale = __float2bfloat162_rn(scale);

  int bbuf = 0;
  if (u0 < u1) {
    load_bias(bias_key(u0), 0);
    load_qkv(u0, 0);
    cp_async_commit();
  }
  for (int u = u0; u < u1; ++u) {
    const int st = stages == 2 ? (u - u0) & 1 : 0;
    if (stages == 2 && u + 1 < u1) {
      prefetch(u + 1, st ^ 1, bbuf);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = stage0 + st * 3 * tile;
    const bf16* ks = qs + tile;
    const bf16* vs = ks + tile;
    const float* bblk = bias_s[bbuf];

    // q^T's A fragments for rows r0..r0+15, scaled in bf16
    uint32_t qf[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      ldmatrix_x4_trans(qf[kk], qs + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * ld + r0 +
                                    ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&qf[kk][e]);
        x = __hmul2(x, qscale);
        qf[kk][e] = *reinterpret_cast<uint32_t*>(&x);
      }
    }

    // S = (scaled q)^T k, two n-tiles of 8 keys per 16-key block
    float s[2 * kMaxBlocks][4];
#pragma unroll
    for (int j = 0; j < kMaxBlocks; ++j) {
      if (j < nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * j][e] = s[2 * j + 1][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                   16 * j + ((lane >> 4) & 1) * 8);
          mma_bf16(s[2 * j], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * j + 1], qf[kk], b[2], b[3]);
        }
      }
    }

    // + bias (f32), keys past N to -inf; row maxima over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2 * kMaxBlocks; ++nt) {
      if (nt < 2 * nb) {
        const int col = nt * 8 + c2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r == 0 ? row_a : row_b;
          float b0 = 0.f, b1 = 0.f;
          if (row < n && col < n) {
            const float* brow = bblk + row * n + col;
            if (vec) {
              const float2 bb = *reinterpret_cast<const float2*>(brow);
              b0 = bb.x;
              b1 = bb.y;
            } else {
              b0 = brow[0];
              b1 = col + 1 < n ? brow[1] : 0.f;
            }
          }
          float& s0 = s[nt][2 * r];
          float& s1 = s[nt][2 * r + 1];
          s0 = col < n ? s0 + b0 : -INFINITY;
          s1 = col + 1 < n ? s1 + b1 : -INFINITY;
          mx[r] = fmaxf(mx[r], fmaxf(s0, s1));
        }
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 2 * kMaxBlocks; ++nt) {
      if (nt < 2 * nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - mx[e / 2]);
          s[nt][e] = p;
          sum[e / 2] += p;
        }
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      inv[r] = 1.f / sum[r];
    }

    // O (16 x DP) = P (bf16, from the score registers) . v^T
    float o[DP / 8][4];
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxBlocks; ++j) {
      if (j < nb) {
        const uint32_t a[4] = {pack_bf16(s[2 * j][0] * inv[0], s[2 * j][1] * inv[0]),
                               pack_bf16(s[2 * j][2] * inv[1], s[2 * j][3] * inv[1]),
                               pack_bf16(s[2 * j + 1][0] * inv[0], s[2 * j + 1][1] * inv[0]),
                               pack_bf16(s[2 * j + 1][2] * inv[1], s[2 * j + 1][3] * inv[1])};
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t b[4];
          ldmatrix_x4(b, vs + (dn * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * ld + 16 * j +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(o[2 * dn], a, b[0], b[1]);
          mma_bf16(o[2 * dn + 1], a, b[2], b[3]);
        }
      }
    }

    store(o, u % bw, u / bw, r0, lane);
    __syncthreads();  // this stage and bias block are free for later loads
    if (u + 1 < u1) {
      if (stages == 1) prefetch(u + 1, 0, bbuf);
      if (bias_key(u + 1) != bias_key(u)) bbuf ^= 1;
    }
  }
}

}  // namespace
