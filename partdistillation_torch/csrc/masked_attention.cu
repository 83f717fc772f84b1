// Mask2Former masked cross-attention forward: softmax(q k^T + m) v with q
// pre-scaled and m a boolean block mask (B, 1|H, Q, K), shared across heads
// when its head axis is 1. The wrapper has already unblocked rows whose keys
// are all blocked, so every real query row attends at least one key.
//
// Replaces: the JAX package's ops/fused_attention.py `_fwd_kernel`
// (launched by `_fused_fwd_pallas` / `fused_masked_attention`). A blocked pair
// gets probability exactly 0 here, as the -1e9 additive mask gives there.
// Numerics: f32 scores and softmax statistics, exp(s - running max) rounded
// to bf16 for the P.V product, f32 accumulation, one bf16 rounding of the
// output; with a `lse` buffer (training) each real row's f32 log-sum-exp
// m + log(l), which the backward kernels (`masked_attention_bwd.cu`) read.
// Bound on the H100: bytes. With Q = 200 queries of D = 32 against up to
// K = 6400 keys, the (Q x K) uint8 mask and the keys and values outweigh the
// flops (4 x Q x K x D per head), which sit far below the ridge.
// Design: flash-decoding. The TPU kernel runs one (image, head, query tile)
// per grid step over the whole key axis; on the H100 that is 64 CTAs, half
// the SMs. Here the key axis is split over CTAs as well:
//  * one CTA per (key split, 16 query rows, image, head group), one warp per
//    head of the group (all 8 heads on the main path), so that the shared
//    mask tile is read once per (image, query, key), not once per head;
//  * K, V and mask tiles of 32 keys arrive by cp.async, double-buffered;
//  * scores and the output accumulator stay in registers: mma.sync m16n8k16
//    (bf16, f32 accumulation), P re-used from the score registers as the
//    A operand of P.V, V's B fragments by ldmatrix.trans;
//  * each split writes f32 partials (unnormalised o, running max m, sum l)
//    and a second launch merges them by log-sum-exp into the bf16 output and
//    the f32 lse (a split that saw no unblocked key has m = -inf, l = 0 and
//    weight 0). With one split the first launch writes the output itself.
// The wrapper (ops/fused_attention.py `masked_attention_plan`) chooses the
// head group and the split so that every main-path key count puts at least
// 264 CTAs (two per SM) on the card.
#include "mma.cuh"

namespace {

constexpr int kRows = 16;     // query rows per CTA: one m16 tile per warp
constexpr int kKeyTile = 32;  // keys per pipeline stage

__host__ __device__ inline size_t kv_tile_bytes(int group, int d) {
  return static_cast<size_t>(group) * kKeyTile * (d + 8) * 2;
}

__host__ __device__ inline size_t stage_bytes(int group, int d, int mask_blocks) {
  return 2 * kv_tile_bytes(group, d) +
         align128(static_cast<size_t>(mask_blocks) * kRows * kKeyTile);
}

// Grid (split, query tile, image x head group); block 32 x group threads,
// warp w = head (group index) * group + w. Partials: o_part (split, B*H, Q, D)
// and ml_part (split, B*H, Q, 2) f32, unused with one split.
template <int D>
__global__ void __launch_bounds__(256)
masked_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                   bf16* __restrict__ out, float* __restrict__ lse, float* __restrict__ o_part,
                   float* __restrict__ ml_part, int batch, int heads, int nq, int nk,
                   int mask_heads, int group, int tiles_per_split, int n_split, int mask_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kLd = D + 8;  // padded K/V rows: conflict-free fragment loads
  const int n_groups = heads / group;
  const int split = blockIdx.x, q0 = blockIdx.y * kRows;
  const int b = blockIdx.z / n_groups, h0 = (blockIdx.z % n_groups) * group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthreads = blockDim.x;
  const int mask_blocks = mask_heads == 1 ? 1 : group;
  const size_t kv_bytes = kv_tile_bytes(group, D);
  const size_t st_bytes = stage_bytes(group, D, mask_blocks);
  const int key_tiles = (nk + kKeyTile - 1) / kKeyTile;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, key_tiles);

  // Stage `buf` holds K [group][32][kLd], V [group][32][kLd], mask
  // [mask_blocks][16][32] (1 = blocked; 0 past the query edge).
  auto load_tile = [&](int tile, int buf) {
    unsigned char* st = smem + buf * st_bytes;
    bf16* ks = reinterpret_cast<bf16*>(st);
    bf16* vs = reinterpret_cast<bf16*>(st + kv_bytes);
    uint8_t* ms = st + 2 * kv_bytes;
    const int key0 = tile * kKeyTile;
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < group * kKeyTile * kChunks; idx += nthreads) {
      const int hh = idx / (kKeyTile * kChunks), rem = idx % (kKeyTile * kChunks);
      const int key = rem / kChunks, ch = rem % kChunks;
      const bool ok = key0 + key < nk;
      const size_t src = ((static_cast<size_t>(b) * heads + h0 + hh) * nk + (ok ? key0 + key : 0)) * D +
                         ch * 8;
      const int dst = (hh * kKeyTile + key) * kLd + ch * 8;
      cp_async16(ks + dst, k + src, ok);
      cp_async16(vs + dst, v + src, ok);
    }
    if (mask_vec) {  // K % 16 == 0: two aligned 16-byte chunks per row
      for (int idx = threadIdx.x; idx < mask_blocks * kRows * 2; idx += nthreads) {
        const int blk = idx / (kRows * 2), r = (idx / 2) % kRows, ch = idx % 2;
        const int row = q0 + r, key = key0 + ch * 16;
        const bool ok = row < nq && key < nk;
        const int mh = mask_heads == 1 ? 0 : h0 + blk;
        const uint8_t* src = ok ? mask + ((static_cast<size_t>(b) * mask_heads + mh) * nq + row) *
                                             static_cast<size_t>(nk) + key
                                : mask;
        cp_async16(ms + (blk * kRows + r) * kKeyTile + ch * 16, src, ok);
      }
    } else {  // ragged K: byte loads (rows of the mask are not 16-byte aligned)
      for (int idx = threadIdx.x; idx < mask_blocks * kRows * kKeyTile; idx += nthreads) {
        const int blk = idx / (kRows * kKeyTile), r = (idx / kKeyTile) % kRows,
                  j = idx % kKeyTile;
        const int row = q0 + r, key = key0 + j;
        const int mh = mask_heads == 1 ? 0 : h0 + blk;
        ms[idx] = (row < nq && key < nk)
                      ? mask[((static_cast<size_t>(b) * mask_heads + mh) * nq + row) *
                                 static_cast<size_t>(nk) + key]
                      : 0;
      }
    }
    cp_async_commit();
  };

  load_tile(t_begin, 0);

  // this warp's head; its query rows g = lane / 4 and g + 8 of the tile
  const int h = h0 + warp;
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int row_a = q0 + g, row_b = q0 + g + 8;
  uint32_t qf[D / 16][4];
  {
    const uint32_t* qa = reinterpret_cast<const uint32_t*>(q + (bh * nq + min(row_a, nq - 1)) * D);
    const uint32_t* qb = reinterpret_cast<const uint32_t*>(q + (bh * nq + min(row_b, nq - 1)) * D);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qf[ks][0] = row_a < nq ? qa[(ks * 16 + c2) / 2] : 0u;
      qf[ks][1] = row_b < nq ? qb[(ks * 16 + c2) / 2] : 0u;
      qf[ks][2] = row_a < nq ? qa[(ks * 16 + 8 + c2) / 2] : 0u;
      qf[ks][3] = row_b < nq ? qb[(ks * 16 + 8 + c2) / 2] : 0u;
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's columns; summed over the quad at the end
  const int mblk = mask_heads == 1 ? 0 : warp;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* st = smem + buf * st_bytes;
    const bf16* ks = reinterpret_cast<const bf16*>(st) + warp * kKeyTile * kLd;
    const bf16* vs = reinterpret_cast<const bf16*>(st + kv_bytes) + warp * kKeyTile * kLd;
    const uint8_t* ms = st + 2 * kv_bytes + mblk * kRows * kKeyTile;
    const int key0 = t * kKeyTile;

    // S (16 x 32) = q k^T, four n-tiles of 8 keys
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = ks + (nt * 8 + g) * kLd + c2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[nt], qf[kk], b0, b1);
      }
    }
    // blocked pairs and keys past the edge get -inf; row maxima over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = nt * 8 + c2;
        const uint16_t mm = *reinterpret_cast<const uint16_t*>(ms + (g + 8 * r) * kKeyTile + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool blocked = key0 + col + e >= nk || ((mm >> (8 * e)) & 0xff) != 0;
          float& sv = s[nt][2 * r + e];
          sv = blocked ? -INFINITY : sv;
          mx[r] = fmaxf(mx[r], sv);
        }
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m_use[e / 2]);
        s[nt][e] = p;
        l_run[e / 2] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
    // O += P V: P (bf16) from the score registers, V by ldmatrix.trans
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      const uint32_t a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                             pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                             pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                             pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kt * 16 + (lane & 15)) * kLd + dn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dn], a, vb[0], vb[1]);
        mma_bf16(o[2 * dn + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= nq) continue;
    const size_t ro = bh * nq + row;
    if (n_split == 1) {
      const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(out + ro * D + i * 8 + c2) =
            __floats2bfloat162_rn(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
      }
      if (lse != nullptr && lane % 4 == 0) lse[ro] = m_run[r] + logf(l_run[r]);
    } else {
      const size_t po = static_cast<size_t>(split) * batch * heads * nq + ro;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<float2*>(o_part + po * D + i * 8 + c2) =
            make_float2(o[i][2 * r], o[i][2 * r + 1]);
      }
      if (lane % 4 == 0) {
        *reinterpret_cast<float2*>(ml_part + po * 2) = make_float2(m_run[r], l_run[r]);
      }
    }
  }
}

// out[row] = sum_s w_s o_s / sum_s w_s l_s with w_s = exp(m_s - max_s m_s)
// (0 for a split whose m_s is -inf); lse[row] = max m + log(sum w l).
__global__ void __launch_bounds__(256)
masked_attn_merge_kernel(const float* __restrict__ o_part,
                         const float* __restrict__ ml_part, bf16* __restrict__ out,
                         float* __restrict__ lse, int rows, int d, int n_split) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * d) return;
  const int row = idx / d, dd = idx % d;
  float m_max = -INFINITY;
  for (int s = 0; s < n_split; ++s) {
    m_max = fmaxf(m_max, ml_part[(static_cast<size_t>(s) * rows + row) * 2]);
  }
  float l_sum = 0.f, acc = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t pr = static_cast<size_t>(s) * rows + row;
    const float m = ml_part[pr * 2];
    const float w = m == -INFINITY ? 0.f : expf(m - m_max);
    l_sum += w * ml_part[pr * 2 + 1];
    acc += w * o_part[pr * d + dd];
  }
  out[idx] = __float2bfloat16(l_sum > 0.f ? acc / l_sum : 0.f);
  if (lse != nullptr && dd == 0) lse[row] = l_sum > 0.f ? m_max + logf(l_sum) : -INFINITY;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                       void* lse, void* o_part, void* ml_part, int batch, int heads, int nq,
                       int nk, int mask_heads, int group, int tiles_per_split, int n_split,
                       cudaStream_t stream) {
  const int mask_blocks = mask_heads == 1 ? 1 : group;
  const size_t smem = 2 * stage_bytes(group, D, mask_blocks);
  cudaError_t err = cudaFuncSetAttribute(
      masked_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, (nq + kRows - 1) / kRows, batch * (heads / group));
  masked_attn_kernel<D><<<grid, 32 * group, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<float*>(o_part), static_cast<float*>(ml_part), batch, heads, nq, nk,
      mask_heads, group, tiles_per_split, n_split, nk % 16 == 0 ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, Q, D), k / v (B, H, K, D) bf16, 16-byte aligned; mask (B, 1|H,
// Q, K) uint8; out (B, H, Q, D) bf16; lse (B, H, Q) f32 or null. `group`
// heads per CTA (dividing H, group * D <= 256), `n_split` splits of
// `tiles_per_split` tiles of 32 keys; with n_split > 1, o_part (n_split, B*H,
// Q, D) and ml_part (n_split, B*H, Q, 2) f32 scratch.
PD_API int pd_masked_attention(const void* q, const void* k, const void* v, const void* mask,
                               void* out, void* lse, void* o_part, void* ml_part, int batch,
                               int heads, int nq, int nk, int d, int mask_heads, int group,
                               int tiles_per_split, int n_split, void* stream) {
  const int key_tiles = (nk + kKeyTile - 1) / kKeyTile;
  if (d % 16 != 0 || d > 128 || nq <= 0 || nk <= 0 || group <= 0 || group > 8 ||
      heads % group != 0 || group * d > 256 || tiles_per_split <= 0 || n_split <= 0 ||
      (n_split - 1) * tiles_per_split >= key_tiles || n_split * tiles_per_split < key_tiles ||
      (n_split > 1 && (o_part == nullptr || ml_part == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
#define PD_CASE(DD)                                                                           \
  case DD:                                                                                    \
    err = launch_fwd<DD>(q, k, v, mask, out, lse, o_part, ml_part, batch, heads, nq, nk,      \
                         mask_heads, group, tiles_per_split, n_split, st);                    \
    break;
    PD_CASE(16)
    PD_CASE(32)
    PD_CASE(48)
    PD_CASE(64)
    PD_CASE(80)
    PD_CASE(96)
    PD_CASE(112)
    PD_CASE(128)
#undef PD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const int rows = batch * heads * nq;
  masked_attn_merge_kernel<<<(rows * d + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
      static_cast<bf16*>(out), static_cast<float*>(lse), rows, d, n_split);
  return static_cast<int>(cudaGetLastError());
}
