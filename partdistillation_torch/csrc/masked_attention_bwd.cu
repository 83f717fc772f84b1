// Mask2Former masked cross-attention backward: given q (pre-scaled), k, v, the
// uint8 effective block mask (B, 1|H, Q, K) that the forward used, the forward
// output o, its f32 log-sum-exp lse (B, H, Q) and the output gradient g,
//   P  = exp(q k^T - lse) over the unblocked pairs (0 where blocked)
//   dV = P^T g          dP = g v^T
//   dS = P o (dP - D)   with D = rowsum(g o o) (= rowsum(P o dP)), in f32
//   dQ = dS k           dK = dS^T q
// P and dS are rounded to bf16 before their products, f32 accumulation, one
// rounding of each gradient at the end.
//
// Replaces: the JAX package's ops/fused_attention.py `_bwd_kernel` (launched
// by `_fused_bwd_pallas` through the `custom_vjp` of `fused_masked_attention`).
// Bound on the H100: bytes at the main path's shapes (Q = 200, D = 32, K up to
// 6400): the uint8 mask outweighs q, k, v, g and the three gradients; the
// flops (10 x Q x K x D per head) sit below the ridge.
// Design: the TPU kernel keeps all of K/V in VMEM and carries dK/dV across the
// sequential q-tile steps of its grid. Here one pass forms S, P, dP and dS
// once per (query tile, key) pair, in registers:
//  * a CTA takes one block of 16 x key_sub keys for all heads of a group
//    (all 8 on the main path, one warp each), so a mask tile shared across
//    heads is read once; its K and V stay in shared memory, and it walks the
//    query tiles of 16 rows of its split, whose q, g, mask, lse and D tiles
//    arrive by cp.async, double-buffered;
//  * per 16 x 16 (key, query) sub-tile a warp forms S^T = K q^T and dP^T =
//    V g^T with mma.sync m16n8k16 (bf16, f32 accumulation), P^T and dS^T in
//    registers; their bf16 repacks are the A operands of dV += P^T g and
//    dK += dS^T q (g and q by ldmatrix.trans), and dS^T transposed in
//    registers (movmatrix) is the A operand of dQ += dS K;
//  * dK and dV stay in registers across the query tiles; dQ of each query
//    tile is written as an f32 partial per key block, and with a query split
//    dK and dV as f32 partials per split; a last launch sums the partials in
//    a fixed order and rounds once (no atomics: runs reproduce bitwise);
//  * D = rowsum(g o o) is computed once per (image, head, query) by a first
//    launch.
// The wrapper (ops/fused_attention.py `masked_attention_bwd_plan`) picks
// key_sub and the query split: at least 264 CTAs (two per SM) with the
// fewest partial bytes.
#include "mma.cuh"

namespace {

constexpr int kRows = 16;  // query rows per tile, keys per sub-tile

// 4 bytes global -> shared; zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

struct Args {
  const bf16 *q, *k, *v, *g;
  const uint8_t* mask;
  const float *lse, *delta;
  bf16 *dk, *dv;
  float *dq_part, *dkv_part;
  int batch, heads, nq, nk, mask_heads, group, tiles_per_split, q_split, mask_vec;
};

struct Layout {
  size_t kv, rows, mask, stats, stage, total;
};

// Shared memory: K and V of the key block ([group][keys][D + 8] bf16 each),
// then two stages of q and g ([group][16][D + 8]), the mask tile
// ([mask blocks][16][keys] bytes) and lse and D ([group][16] f32 each).
template <int D>
__host__ __device__ inline Layout layout(int group, int keys, int mask_blocks) {
  Layout L;
  L.kv = align128(static_cast<size_t>(group) * keys * (D + 8) * 2);
  L.rows = align128(static_cast<size_t>(group) * kRows * (D + 8) * 2);
  L.mask = align128(static_cast<size_t>(mask_blocks) * kRows * keys);
  L.stats = align128(static_cast<size_t>(group) * kRows * 4);
  L.stage = 2 * L.rows + L.mask + 2 * L.stats;
  L.total = 2 * L.kv + 2 * L.stage;
  return L;
}

// D[row] = sum_d g[row, d] o[row, d] in f32, one thread per (image, head, query).
template <int D>
__global__ void __launch_bounds__(256)
masked_attn_bwd_delta_kernel(const bf16* __restrict__ g, const bf16* __restrict__ o,
                             float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const uint4* gr = reinterpret_cast<const uint4*>(g + static_cast<size_t>(row) * D);
  const uint4* orow = reinterpret_cast<const uint4*>(o + static_cast<size_t>(row) * D);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 a = gr[c], b = orow[c];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(b2[e]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
  delta[row] = acc;
}

// Grid (key block, query split, image x head group); block 32 x group
// threads, warp w = head h0 + w.
template <int D, int KSUB>
__global__ void __launch_bounds__(256, KSUB * D <= 64 ? 2 : 1)
masked_attn_bwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kKeys = 16 * KSUB;
  constexpr int kLd = D + 8;
  const int n_groups = a.heads / a.group;
  const int kb = blockIdx.x, qsi = blockIdx.y;
  const int b = blockIdx.z / n_groups, h0 = (blockIdx.z % n_groups) * a.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthreads = blockDim.x;
  const int mask_blocks = a.mask_heads == 1 ? 1 : a.group;
  const Layout L = layout<D>(a.group, kKeys, mask_blocks);
  const int key0 = kb * kKeys;
  const int q_tiles = (a.nq + kRows - 1) / kRows;
  const int t_begin = qsi * a.tiles_per_split;
  const int t_end = min(t_begin + a.tiles_per_split, q_tiles);
  const size_t bh0 = static_cast<size_t>(b) * a.heads + h0;

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.kv);
  unsigned char* stages = smem + 2 * L.kv;

  // K and V of the key block, all heads of the group (zero past the edge)
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < a.group * kKeys * kChunks; idx += nthreads) {
    const int hh = idx / (kKeys * kChunks), rem = idx % (kKeys * kChunks);
    const int key = rem / kChunks, ch = rem % kChunks;
    const bool ok = key0 + key < a.nk;
    const size_t src = ((bh0 + hh) * a.nk + (ok ? key0 + key : 0)) * D + ch * 8;
    const int dst = (hh * kKeys + key) * kLd + ch * 8;
    cp_async16(ks + dst, a.k + src, ok);
    cp_async16(vs + dst, a.v + src, ok);
  }

  // Stage `buf`: q and g rows of query tile t for every head, the mask tile
  // (zero past the edges: validity is checked separately), lse and D.
  auto load_tile = [&](int t, int buf) {
    unsigned char* st = stages + buf * L.stage;
    bf16* qs = reinterpret_cast<bf16*>(st);
    bf16* gs = reinterpret_cast<bf16*>(st + L.rows);
    uint8_t* ms = st + 2 * L.rows;
    float* ls = reinterpret_cast<float*>(st + 2 * L.rows + L.mask);
    float* ds = reinterpret_cast<float*>(st + 2 * L.rows + L.mask + L.stats);
    const int q0 = t * kRows;
    for (int idx = threadIdx.x; idx < a.group * kRows * kChunks; idx += nthreads) {
      const int hh = idx / (kRows * kChunks), rem = idx % (kRows * kChunks);
      const int r = rem / kChunks, ch = rem % kChunks;
      const bool ok = q0 + r < a.nq;
      const size_t src = ((bh0 + hh) * a.nq + (ok ? q0 + r : 0)) * D + ch * 8;
      const int dst = (hh * kRows + r) * kLd + ch * 8;
      cp_async16(qs + dst, a.q + src, ok);
      cp_async16(gs + dst, a.g + src, ok);
    }
    for (int idx = threadIdx.x; idx < a.group * kRows; idx += nthreads) {
      const int hh = idx / kRows, r = idx % kRows;
      const bool ok = q0 + r < a.nq;
      const size_t src = (bh0 + hh) * a.nq + (ok ? q0 + r : 0);
      cp_async4(ls + idx, a.lse + src, ok);
      cp_async4(ds + idx, a.delta + src, ok);
    }
    const size_t mrow = static_cast<size_t>(a.nk);
    if (a.mask_vec) {  // K % 16 == 0: aligned 16-byte chunks
      constexpr int kMc = kKeys / 16;
      for (int idx = threadIdx.x; idx < mask_blocks * kRows * kMc; idx += nthreads) {
        const int blk = idx / (kRows * kMc), r = (idx / kMc) % kRows, ch = idx % kMc;
        const int row = q0 + r, key = key0 + ch * 16;
        const bool ok = row < a.nq && key < a.nk;
        const int mh = a.mask_heads == 1 ? 0 : h0 + blk;
        const uint8_t* src =
            ok ? a.mask + ((static_cast<size_t>(b) * a.mask_heads + mh) * a.nq + row) * mrow + key
               : a.mask;
        cp_async16(ms + (blk * kRows + r) * kKeys + ch * 16, src, ok);
      }
    } else {  // ragged K: byte loads
      for (int idx = threadIdx.x; idx < mask_blocks * kRows * kKeys; idx += nthreads) {
        const int blk = idx / (kRows * kKeys), r = (idx / kKeys) % kRows, j = idx % kKeys;
        const int row = q0 + r, key = key0 + j;
        const int mh = a.mask_heads == 1 ? 0 : h0 + blk;
        ms[idx] = (row < a.nq && key < a.nk)
                      ? a.mask[((static_cast<size_t>(b) * a.mask_heads + mh) * a.nq + row) * mrow +
                               key]
                      : uint8_t(0);
      }
    }
    cp_async_commit();
  };

  if (t_begin < t_end) load_tile(t_begin, 0);

  const int g = lane / 4, c2 = 2 * (lane % 4);
  const size_t bh = bh0 + warp;
  const bf16* ks_w = ks + warp * kKeys * kLd;
  const bf16* vs_w = vs + warp * kKeys * kLd;
  const int mblk = a.mask_heads == 1 ? 0 : warp;

  float dk[KSUB][D / 8][4], dv[KSUB][D / 8][4];
#pragma unroll
  for (int j = 0; j < KSUB; ++j) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[j][i][e] = dv[j][i][e] = 0.f;
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* st = stages + buf * L.stage;
    const bf16* qs_w = reinterpret_cast<const bf16*>(st) + warp * kRows * kLd;
    const bf16* gs_w = reinterpret_cast<const bf16*>(st + L.rows) + warp * kRows * kLd;
    const uint8_t* ms = st + 2 * L.rows + mblk * kRows * kKeys;
    const float* ls = reinterpret_cast<const float*>(st + 2 * L.rows + L.mask) + warp * kRows;
    const float* dls =
        reinterpret_cast<const float*>(st + 2 * L.rows + L.mask + L.stats) + warp * kRows;
    const int q0 = t * kRows;

    // this lane's four query columns: nt * 8 + c2 + e
    float lse_c[2][2], dl_c[2][2];
    bool qok[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + c2 + e;
        lse_c[nt][e] = ls[col];
        dl_c[nt][e] = dls[col];
        qok[nt][e] = q0 + col < a.nq;
      }
    }

    float dq[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

#pragma unroll
    for (int j = 0; j < KSUB; ++j) {
      // S^T = K_j q^T and dP^T = V_j g^T (16 keys x 16 queries)
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4], qb[4], gb[4];
        const int arow = 16 * j + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int acol = kk * 16 + ((lane >> 4) & 1) * 8;
        ldmatrix_x4(ka, ks_w + arow * kLd + acol);
        ldmatrix_x4(va, vs_w + arow * kLd + acol);
        const int brow = (lane & 7) + ((lane >> 4) & 1) * 8;
        const int bcol = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qb, qs_w + brow * kLd + bcol);
        ldmatrix_x4(gb, gs_w + brow * kLd + bcol);
        mma_bf16(s[0], ka, qb[0], qb[1]);
        mma_bf16(s[1], ka, qb[2], qb[3]);
        mma_bf16(dp[0], va, gb[0], gb[1]);
        mma_bf16(dp[1], va, gb[2], gb[3]);
      }
      // P^T and dS^T; element (nt, e): key 16 j + g + 8 (e / 2), query
      // nt * 8 + c2 + e % 2
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * j + g + 8 * (e / 2), col = nt * 8 + c2 + (e & 1);
          const bool ok = qok[nt][e & 1] && key0 + key < a.nk && ms[col * kKeys + key] == 0;
          const float p = ok ? expf(s[nt][e] - lse_c[nt][e & 1]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dl_c[nt][e & 1]);
        }
      }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const uint32_t sa[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
      // dS (queries x keys) = the transpose of dS^T, block by block
      const uint32_t sq[4] = {movmatrix_trans(sa[0]), movmatrix_trans(sa[2]),
                              movmatrix_trans(sa[1]), movmatrix_trans(sa[3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        // dV_j += P^T g, dK_j += dS^T q: g, q (queries x features) as B
        uint32_t gb[4], qb[4], kb4[4];
        const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = dn * 16 + ((lane >> 4) & 1) * 8;
        ldmatrix_x4_trans(gb, gs_w + row * kLd + col);
        ldmatrix_x4_trans(qb, qs_w + row * kLd + col);
        mma_bf16(dv[j][2 * dn], pa, gb[0], gb[1]);
        mma_bf16(dv[j][2 * dn + 1], pa, gb[2], gb[3]);
        mma_bf16(dk[j][2 * dn], sa, qb[0], qb[1]);
        mma_bf16(dk[j][2 * dn + 1], sa, qb[2], qb[3]);
        // dQ += dS K_j: K_j (keys x features) as B
        ldmatrix_x4_trans(kb4, ks_w + (16 * j + row) * kLd + col);
        mma_bf16(dq[2 * dn], sq, kb4[0], kb4[1]);
        mma_bf16(dq[2 * dn + 1], sq, kb4[2], kb4[3]);
      }
    }

    // this key block's share of dQ for the tile
    float* part = a.dq_part + ((static_cast<size_t>(kb) * a.batch * a.heads + bh) * a.nq) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + g + 8 * r;
      if (row >= a.nq) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<float2*>(part + static_cast<size_t>(row) * D + i * 8 + c2) =
            make_float2(dq[i][2 * r], dq[i][2 * r + 1]);
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }

  // dK and dV of the key block: bf16 with one query split, else f32 partials
  const size_t bhk = static_cast<size_t>(a.batch) * a.heads * a.nk * D;
#pragma unroll
  for (int j = 0; j < KSUB; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 16 * j + g + 8 * r;
      if (key >= a.nk) continue;
      const size_t ro = (bh * a.nk + key) * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int c = i * 8 + c2;
        if (a.q_split == 1) {
          *reinterpret_cast<__nv_bfloat162*>(a.dk + ro + c) =
              __floats2bfloat162_rn(dk[j][i][2 * r], dk[j][i][2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(a.dv + ro + c) =
              __floats2bfloat162_rn(dv[j][i][2 * r], dv[j][i][2 * r + 1]);
        } else {
          float* pk = a.dkv_part + static_cast<size_t>(qsi) * 2 * bhk;
          *reinterpret_cast<float2*>(pk + ro + c) = make_float2(dk[j][i][2 * r], dk[j][i][2 * r + 1]);
          *reinterpret_cast<float2*>(pk + bhk + ro + c) =
              make_float2(dv[j][i][2 * r], dv[j][i][2 * r + 1]);
        }
      }
    }
  }
}

// dQ = the key blocks' partials summed in block order; with a query split,
// dK and dV = the splits' partials in split order. One element a thread, so
// that enough warps keep loads in flight.
__global__ void __launch_bounds__(256)
masked_attn_bwd_reduce_kernel(const float* __restrict__ dq_part,
                              const float* __restrict__ dkv_part, bf16* __restrict__ dq,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, size_t n_q,
                              size_t n_kv, int key_blocks, int q_split) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float* src;
  size_t stride, off;
  int n;
  bf16* dst;
  if (i < n_q) {
    src = dq_part;
    stride = n_q;
    n = key_blocks;
    dst = dq;
    off = i;
  } else if (q_split > 1 && i < n_q + 2 * n_kv) {
    const size_t j = i - n_q;
    const bool is_v = j >= n_kv;
    off = is_v ? j - n_kv : j;
    src = dkv_part + (is_v ? n_kv : 0);
    stride = 2 * n_kv;
    n = q_split;
    dst = is_v ? dv : dk;
  } else {
    return;
  }
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < n; ++s) acc += __ldcs(src + s * stride + off);
  dst[off] = __float2bfloat16(acc);
}

template <int D, int KSUB>
cudaError_t launch_main(const Args& a, cudaStream_t stream) {
  const int mask_blocks = a.mask_heads == 1 ? 1 : a.group;
  const size_t smem = layout<D>(a.group, 16 * KSUB, mask_blocks).total;
  cudaError_t err = cudaFuncSetAttribute(masked_attn_bwd_kernel<D, KSUB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nk + 16 * KSUB - 1) / (16 * KSUB), a.q_split,
                  a.batch * (a.heads / a.group));
  masked_attn_bwd_kernel<D, KSUB><<<grid, 32 * a.group, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_all(const Args& a, const bf16* o, float* delta, int key_sub,
                       cudaStream_t stream) {
  const int rows = a.batch * a.heads * a.nq;
  masked_attn_bwd_delta_kernel<D><<<(rows + 255) / 256, 256, 0, stream>>>(a.g, o, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // key_sub x D <= 64 (or key_sub = 1): dK and dV in a thread's registers
  if constexpr (D <= 16) {
    if (key_sub == 4) return launch_main<D, 4>(a, stream);
  }
  if constexpr (D <= 32) {
    if (key_sub == 2) return launch_main<D, 2>(a, stream);
  }
  if (key_sub == 1) return launch_main<D, 1>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out, g (B, H, Q, D), k, v (B, H, K, D) bf16, 16-byte aligned; mask (B,
// 1|H, Q, K) uint8; lse (B, H, Q) f32; dq, dk, dv like q, k, v. Scratch: delta
// (B, H, Q) f32, dq_part (key blocks, B, H, Q, D) f32 and, with q_split > 1,
// dkv_part (q_split, 2, B, H, K, D) f32. `group` heads per CTA (dividing H,
// group * D <= 256), key blocks of 16 x key_sub keys (key_sub 1, 2 or 4),
// query splits of `tiles_per_split` tiles of 16 rows.
PD_API int pd_masked_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* mask, const void* out, const void* lse,
                                   const void* g, void* dq, void* dk, void* dv, void* delta,
                                   void* dq_part, void* dkv_part, int batch, int heads, int nq,
                                   int nk, int d, int mask_heads, int group, int key_sub,
                                   int tiles_per_split, int q_split, void* stream) {
  const int q_tiles = (nq + kRows - 1) / kRows;
  if (d % 16 != 0 || d > 128 || nq <= 0 || nk <= 0 || group <= 0 || group > 8 ||
      heads % group != 0 || group * d > 256 || (key_sub != 1 && key_sub != 2 && key_sub != 4) ||
      key_sub * d > (d > 64 ? d : 64) || tiles_per_split <= 0 || q_split <= 0 ||
      (q_split - 1) * tiles_per_split >= q_tiles || q_split * tiles_per_split < q_tiles ||
      (q_split > 1 && dkv_part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.g = static_cast<const bf16*>(g);
  a.mask = static_cast<const uint8_t*>(mask);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dq_part = static_cast<float*>(dq_part);
  a.dkv_part = static_cast<float*>(dkv_part);
  a.batch = batch;
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.mask_heads = mask_heads;
  a.group = group;
  a.tiles_per_split = tiles_per_split;
  a.q_split = q_split;
  a.mask_vec = nk % 16 == 0 ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* o = static_cast<const bf16*>(out);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
  switch (d) {
#define PD_CASE(DD)                                  \
  case DD:                                           \
    err = launch_all<DD>(a, o, dl, key_sub, st);     \
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
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_q = static_cast<size_t>(batch) * heads * nq * d;
  const size_t n_kv = static_cast<size_t>(batch) * heads * nk * d;
  const size_t total = n_q + (q_split > 1 ? 2 * n_kv : 0);
  const int key_blocks = (nk + 16 * key_sub - 1) / (16 * key_sub);
  masked_attn_bwd_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dq_part), static_cast<const float*>(dkv_part),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_q, n_kv,
      key_blocks, q_split);
  return static_cast<int>(cudaGetLastError());
}
