// Mask2Former masked cross-attention backward: given q (pre-scaled), k, v, the
// uint8 effective block mask (B, 1|H, Q, K) that the forward used, the forward
// output o, its f32 log-sum-exp lse (B, H, Q) and the output gradient g,
//   P  = exp(q k^T - lse) over the unblocked pairs (0 where blocked)
//   dV = P^T g          dP = g v^T
//   dS = P o (dP - D)   with D = rowsum(g o o) (= rowsum(P o dP)), in f32
//   dQ = dS k           dK = dS^T q
// P and dS are rounded to bf16 before their products, f32 accumulation.
//
// Replaces: the JAX package's ops/fused_attention.py `_bwd_kernel` (launched
// by `_fused_bwd_pallas` through the `custom_vjp` of `fused_masked_attention`).
// Bound on the H100: bytes at the main path's shapes (Q = 200, D = 32, K up to
// 6400): the uint8 mask is read once per key tile and once per query tile and
// outweighs q, k, v, g and the three gradients; the flops (10 x Q x K x D per
// head) sit below the ridge.
// Design: the TPU kernel keeps all of K/V in VMEM and carries dK/dV across the
// sequential q-tile steps of its grid. A CUDA grid has no order and K/V at
// K = 6400 do not fit in shared memory, so the work is split into three kernels
// with no atomics, each deterministic:
//   * dkv_kernel, one CTA per (key tile of 64, head, image): keeps its key
//     tile's K and V in shared memory, loops over every query tile (Q = 200 is
//     four tiles), recomputes S^T = K Q^T, and accumulates dK and dV in f32;
//   * dq_kernel, one CTA per (query tile of 64, key chunk, head, image):
//     streams the key tiles of its chunk as the forward does and accumulates
//     its share of dQ in f32 into a partial buffer (B, H, chunks, Q, d);
//     dq_reduce_kernel sums the chunks in order and writes dQ in bf16. With
//     Q = 200, one CTA per query tile would leave most of the card idle (64
//     CTAs at B = 2, H = 8), so the caller splits the keys into chunks (the
//     wrapper takes chunks of 8 key tiles: 13 at K = 6400).
// Each CTA has 4 warps; a warp owns 16 rows (keys in dkv_kernel, queries in
// dq_kernel) and runs its products with bf16 WMMA (16x16x16, f32 accumulate),
// its accumulators round-tripping shared memory. D = rowsum(g o o) is
// recomputed per query tile from g and o (D values per row, cheap).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16 * kWarps;  // rows of a query tile and of a key tile
constexpr int kLdS = kTile + 4;     // f32 scratch (16 x 64 per warp)
constexpr int kLdP = kTile + 8;     // bf16 scratch (16 x 64 per warp)

struct Layout {
  size_t tile, acc, mask, rowv, s, p, warp_bytes, total;
};

// Shared memory: four bf16 (64 x d) tiles (the CTA's own rows of two operands
// and the streamed tile of two others), the (64 x 64) mask tile, lse and D of
// the current query tile, f32 accumulators (two (64 x d) in dkv_kernel, one in
// dq_kernel) and per-warp score scratch.
__host__ __device__ inline Layout layout(int d, int n_acc) {
  Layout L;
  L.tile = align128(static_cast<size_t>(kTile) * (d + 8) * 2);
  L.acc = align128(static_cast<size_t>(kTile) * (d + 4) * 4);
  L.mask = align128(static_cast<size_t>(kTile) * kTile);
  L.rowv = align128(static_cast<size_t>(2) * kTile * 4);
  L.s = align128(static_cast<size_t>(16) * kLdS * 4);
  L.p = align128(static_cast<size_t>(16) * kLdP * 2);
  L.warp_bytes = 2 * L.s + 2 * L.p;
  L.total = 4 * L.tile + n_acc * L.acc + L.mask + L.rowv + kWarps * L.warp_bytes;
  return L;
}

// Stage rows [r0, r0 + 64) of a (n x d) bf16 matrix into shared memory with
// leading dimension d + 8; rows past n are zero.
__device__ inline void load_tile(bf16* dst, const bf16* src, int r0, int n, int d) {
  const int ld = d + 8;
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
    const int r = e / d, c = e % d;
    dst[r * ld + c] = (r0 + r < n) ? src[static_cast<size_t>(r0 + r) * d + c] : zero;
  }
}

// mask tile: ms[i * 64 + j] = blocked(query q0 + i, key k0 + j); pairs outside
// the matrix count as blocked.
__device__ inline void load_mask(uint8_t* ms, const uint8_t* mrow0, int q0, int k0,
                                 int nq, int nk) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile, j = e % kTile;
    const bool in = q0 + i < nq && k0 + j < nk;
    ms[e] = in ? mrow0[static_cast<size_t>(q0 + i) * nk + k0 + j] : uint8_t(1);
  }
}

// lse and D = rowsum(g o o) of query rows [q0, q0 + 64): two threads per row.
__device__ inline void load_rows(float* lse_s, float* dlt_s, const bf16* gs,
                                 const bf16* ob, const float* lseb, int q0, int nq,
                                 int d) {
  const int i = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int ld = d + 8;
  float acc = 0.f;
  if (q0 + i < nq) {
    const bf16* orow = ob + static_cast<size_t>(q0 + i) * d;
    for (int c = half * (d / 2); c < (half + 1) * (d / 2); ++c) {
      acc += __bfloat162float(gs[i * ld + c]) * __bfloat162float(orow[c]);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) {
    dlt_s[i] = acc;
    lse_s[i] = (q0 + i < nq) ? lseb[q0 + i] : 0.f;
  }
}

// C (16 x 64, f32, ld kLdS) = A (16 x d rows, ld) . B^T where B is 64 rows of
// d (ld): both operands row-major in shared memory.
__device__ inline void mm_abt(float* c, const bf16* a, const bf16* b, int d) {
  const int ld = d + 8;
  for (int jt = 0; jt < kTile / 16; ++jt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < d / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, ld);
      wmma::load_matrix_sync(fb, b + jt * 16 * ld + kk * 16, ld);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + jt * 16, acc, kLdS, wmma::mem_row_major);
  }
}

// acc (16 x d, f32, ld d + 4) += A (16 x 64, bf16, ld kLdP) . B (64 x d, ld d + 8).
__device__ inline void mm_acc(float* acc_s, const bf16* a, const bf16* b, int d) {
  const int ld = d + 8, ld_a = d + 4;
  for (int dt = 0; dt < d / 16; ++dt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, acc_s + dt * 16, ld_a, wmma::mem_row_major);
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, kLdP);
      wmma::load_matrix_sync(fb, b + kk * 16 * ld + dt * 16, ld);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(acc_s + dt * 16, acc, ld_a, wmma::mem_row_major);
  }
}

__device__ inline void zero_acc(float* acc_s, int d) {
  for (int e = threadIdx.x; e < kTile * (d + 4); e += kThreads) acc_s[e] = 0.f;
}

// Write a warp's 16 accumulator rows [row0, row0 + 16) as bf16 (rows < n).
__device__ inline void store_rows(bf16* dst, const float* acc_w, int row0, int n, int d) {
  const int lane = threadIdx.x % 32;
  for (int e = lane; e < 16 * d; e += 32) {
    const int r = e / d, c = e % d;
    if (row0 + r < n) {
      dst[static_cast<size_t>(row0 + r) * d + c] = __float2bfloat16(acc_w[r * (d + 4) + c]);
    }
  }
}

struct Args {
  const bf16 *q, *k, *v, *o, *g;
  const uint8_t* mask;
  const float* lse;
  bf16 *dk, *dv;
  float* dq_part;  // (B, H, chunks, Q, d) f32 partial dQ of each key chunk
  int heads, nq, nk, d, mask_heads, chunks, chunk_tiles;
};

struct Ptrs {
  const bf16 *q, *k, *v, *o, *g;
  const uint8_t* mrow0;  // mask rows of this (image, head)
  const float* lse;
  size_t bh;
};

__device__ inline Ptrs head_ptrs(const Args& a) {
  const int h = blockIdx.y, b = blockIdx.z;
  Ptrs p;
  p.bh = static_cast<size_t>(b) * a.heads + h;
  p.q = a.q + p.bh * a.nq * a.d;
  p.o = a.o + p.bh * a.nq * a.d;
  p.g = a.g + p.bh * a.nq * a.d;
  p.k = a.k + p.bh * a.nk * a.d;
  p.v = a.v + p.bh * a.nk * a.d;
  p.lse = a.lse + p.bh * a.nq;
  const size_t mh = static_cast<size_t>(b) * a.mask_heads + (a.mask_heads == 1 ? 0 : h);
  p.mrow0 = a.mask + mh * a.nq * static_cast<size_t>(a.nk);
  return p;
}

__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = a.d;
  const Layout L = layout(d, 2);
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Ptrs p = head_ptrs(a);
  const int ld = d + 8;

  unsigned char* at = smem;
  bf16* ks = reinterpret_cast<bf16*>(at); at += L.tile;
  bf16* vs = reinterpret_cast<bf16*>(at); at += L.tile;
  bf16* qs = reinterpret_cast<bf16*>(at); at += L.tile;
  bf16* gs = reinterpret_cast<bf16*>(at); at += L.tile;
  float* dk_s = reinterpret_cast<float*>(at); at += L.acc;
  float* dv_s = reinterpret_cast<float*>(at); at += L.acc;
  uint8_t* ms = reinterpret_cast<uint8_t*>(at); at += L.mask;
  float* lse_s = reinterpret_cast<float*>(at);
  float* dlt_s = lse_s + kTile; at += L.rowv;
  at += warp * L.warp_bytes;
  float* st = reinterpret_cast<float*>(at);           // S^T, then P^T (f32)
  float* dpt = reinterpret_cast<float*>(at + L.s);    // dP^T
  bf16* pt = reinterpret_cast<bf16*>(at + 2 * L.s);   // P^T (bf16)
  bf16* dst = reinterpret_cast<bf16*>(at + 2 * L.s + L.p);  // dS^T (bf16)

  load_tile(ks, p.k, k0, a.nk, d);
  load_tile(vs, p.v, k0, a.nk, d);
  zero_acc(dk_s, d);
  zero_acc(dv_s, d);
  float* dk_w = dk_s + warp * 16 * (d + 4);
  float* dv_w = dv_s + warp * 16 * (d + 4);

  // Lane pair (2r, 2r+1) owns key row r of this warp, 32 query columns each.
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int kcol = warp * 16 + r;

  for (int q0 = 0; q0 < a.nq; q0 += kTile) {
    __syncthreads();  // previous query tile fully consumed
    load_tile(qs, p.q, q0, a.nq, d);
    load_tile(gs, p.g, q0, a.nq, d);
    load_mask(ms, p.mrow0, q0, k0, a.nq, a.nk);
    __syncthreads();
    load_rows(lse_s, dlt_s, gs, p.o, p.lse, q0, a.nq, d);
    __syncthreads();

    mm_abt(st, ks + warp * 16 * ld, qs, d);   // S^T_w  = K_w Q^T
    mm_abt(dpt, vs + warp * 16 * ld, gs, d);  // dP^T_w = V_w G^T
    __syncwarp();
    for (int j = c0; j < c0 + 32; ++j) {
      const bool ok = ms[j * kTile + kcol] == 0;
      const float pv = ok ? expf(st[r * kLdS + j] - lse_s[j]) : 0.f;
      const float ds = pv * (dpt[r * kLdS + j] - dlt_s[j]);
      pt[r * kLdP + j] = __float2bfloat16(pv);
      dst[r * kLdP + j] = __float2bfloat16(ds);
    }
    __syncwarp();
    mm_acc(dv_w, pt, gs, d);   // dV_w += P^T_w G
    mm_acc(dk_w, dst, qs, d);  // dK_w += dS^T_w Q
    __syncwarp();
  }
  store_rows(a.dk + p.bh * a.nk * d, dk_w, k0 + warp * 16, a.nk, d);
  store_rows(a.dv + p.bh * a.nk * d, dv_w, k0 + warp * 16, a.nk, d);
}

__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = a.d;
  const Layout L = layout(d, 1);
  const int q0 = (blockIdx.x / a.chunks) * kTile, chunk = blockIdx.x % a.chunks;
  const int k_begin = chunk * a.chunk_tiles * kTile;
  const int k_end = min(a.nk, k_begin + a.chunk_tiles * kTile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Ptrs p = head_ptrs(a);
  const int ld = d + 8;

  unsigned char* at = smem;
  bf16* qs = reinterpret_cast<bf16*>(at); at += L.tile;
  bf16* gs = reinterpret_cast<bf16*>(at); at += L.tile;
  bf16* ks = reinterpret_cast<bf16*>(at); at += L.tile;
  bf16* vs = reinterpret_cast<bf16*>(at); at += L.tile;
  float* dq_s = reinterpret_cast<float*>(at); at += L.acc;
  uint8_t* ms = reinterpret_cast<uint8_t*>(at); at += L.mask;
  float* lse_s = reinterpret_cast<float*>(at);
  float* dlt_s = lse_s + kTile; at += L.rowv;
  at += warp * L.warp_bytes;
  float* s = reinterpret_cast<float*>(at);
  float* dp = reinterpret_cast<float*>(at + L.s);
  bf16* dsb = reinterpret_cast<bf16*>(at + 2 * L.s);

  load_tile(qs, p.q, q0, a.nq, d);
  load_tile(gs, p.g, q0, a.nq, d);
  zero_acc(dq_s, d);
  __syncthreads();
  load_rows(lse_s, dlt_s, gs, p.o, p.lse, q0, a.nq, d);
  float* dq_w = dq_s + warp * 16 * (d + 4);

  // Lane pair (2r, 2r+1) owns query row r of this warp, 32 key columns each.
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int qrow = warp * 16 + r;

  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    __syncthreads();  // previous key tile fully consumed (and rows staged)
    load_tile(ks, p.k, k0, a.nk, d);
    load_tile(vs, p.v, k0, a.nk, d);
    load_mask(ms, p.mrow0, q0, k0, a.nq, a.nk);
    __syncthreads();

    mm_abt(s, qs + warp * 16 * ld, ks, d);   // S_w  = Q_w K^T
    mm_abt(dp, gs + warp * 16 * ld, vs, d);  // dP_w = G_w V^T
    __syncwarp();
    const float lse_r = lse_s[qrow], dlt_r = dlt_s[qrow];
    for (int j = c0; j < c0 + 32; ++j) {
      const bool ok = ms[qrow * kTile + j] == 0;
      const float pv = ok ? expf(s[r * kLdS + j] - lse_r) : 0.f;
      dsb[r * kLdP + j] = __float2bfloat16(pv * (dp[r * kLdS + j] - dlt_r));
    }
    __syncwarp();
    mm_acc(dq_w, dsb, ks, d);  // dQ_w += dS_w K
    __syncwarp();
  }
  float* part = a.dq_part + (p.bh * a.chunks + chunk) * a.nq * d;
  for (int e = lane; e < 16 * d; e += 32) {
    const int row = q0 + warp * 16 + e / d, c = e % d;
    if (row < a.nq) part[static_cast<size_t>(row) * d + c] = dq_w[(e / d) * (d + 4) + c];
  }
}

// dQ = the sum of the chunks' partials in chunk order, one thread per element.
__global__ void dq_reduce_kernel(const float* part, bf16* dq, size_t bh_count, int chunks,
                                 int nqd) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= bh_count * nqd) return;
  const size_t bh = i / nqd, e = i % nqd;
  const float* src = part + bh * chunks * nqd + e;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += src[static_cast<size_t>(c) * nqd];
  dq[i] = __float2bfloat16(acc);
}

}  // namespace

PD_API int pd_masked_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* mask, const void* out, const void* lse,
                                   const void* g, void* dq, void* dk, void* dv,
                                   void* dq_part, int batch, int heads, int nq, int nk,
                                   int d, int mask_heads, int chunks, void* stream) {
  const int tiles = (nk + kTile - 1) / kTile;
  if (d % 16 != 0 || d > 128 || nq <= 0 || nk <= 0 || chunks < 1 || chunks > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(out);
  a.g = static_cast<const bf16*>(g);
  a.mask = static_cast<const uint8_t*>(mask);
  a.lse = static_cast<const float*>(lse);
  a.dq_part = static_cast<float*>(dq_part);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.d = d;
  a.mask_heads = mask_heads;
  a.chunk_tiles = (tiles + chunks - 1) / chunks;
  a.chunks = (tiles + a.chunk_tiles - 1) / a.chunk_tiles;  // none left empty
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const size_t smem_kv = layout(d, 2).total, smem_q = layout(d, 1).total;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<dim3((nk + kTile - 1) / kTile, heads, batch), kThreads, smem_kv, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3((nq + kTile - 1) / kTile * a.chunks, heads, batch), kThreads, smem_q,
              s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bh_count = static_cast<size_t>(batch) * heads;
  const size_t n = bh_count * nq * d;
  dq_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      a.dq_part, static_cast<bf16*>(dq), bh_count, a.chunks, nq * d);
  return static_cast<int>(cudaGetLastError());
}
