// Backward of the Swin MLP half-block of csrc/fused_mlp.cu,
//   xn = LN(x) * scale + bias, pre = xn W1^T + b1, h = GELU(pre),
//   out = h W2^T + b2 (+ x),
// given g = d out: dx, dscale, dbias, dW1, db1, dW2, db2, each only when the
// caller asks for it (`flags`).
//
// Replaces: the VJP of the plain version `ln_mlp_kernel_numerics`
// (ops/fused_mlp.py), recomputed under autograd from the saved inputs with
// f32 products. The JAX package has no backward kernel here: its custom_vjp
// differentiates the same function, whose f32 dot_generals run at the TPU's
// default precision (one bf16 pass). Numerics here: every product takes bf16
// operands (xn, h, g, dpre and the weights) with f32 accumulation; the
// LayerNorm statistics, GELU, GELU', every column sum and the LayerNorm
// backward stay in f32; each gradient is rounded to bf16 once.
// Bound on the H100: operations. Five products of 2 N C F flops (fc1
// recomputed, dH, dW2, dW1, dxn) against about 14 N F bytes of hidden-size
// tensors (h and dpre in bf16, pre in f32, each written once and read once
// or twice), far above the ridge at every Swin-L stage.
// Design (up to 11 launches a call, on the caller's stream):
//  1. the forward's LayerNorm pass (csrc/fused_mlp.cuh, bf16 xn), keeping
//     the f32 mean and 1 / std of each row;
//  2. fc1 on the main loop of csrc/gemm.cuh (`mlp_bwd_gemm_kernel`), its
//     epilogue writing pre in f32 and h = GELU(pre) in bf16;
//  3. dW2 = g^T h, both operands MN-major, split over the tokens, and the
//     fixed-order sum of the splits (mlp_bwd_colsum_kernel) where there are
//     more than one;
//  4. dH = g W2 (W2 MN-major), its epilogue multiplying by GELU'(pre) and
//     writing dpre in bf16 and the f32 column sums of each 128-row tile,
//     which give db1;
//  5. dW1 = dpre^T xn as in 3 (with one split, rounded in the epilogue);
//  6. dxn = dpre W1 (W1 MN-major) in f32, its epilogue also summing the
//     columns of dxn * xh, dxn and g per 128-row tile (dscale, dbias, db2),
//     added up by one more mlp_bwd_colsum_kernel;
//  7. mlp_bwd_rows_kernel: the LayerNorm backward of each row (+ g with the
//     residual).
// No atomics: every sum has a fixed order, so the gradients repeat bit for
// bit. The split-K factors and column tiles are the wrapper's
// (ops/fused_mlp.py `mlp_bwd_plan`).
#include "fused_mlp.cuh"
#include "gemm.cuh"

namespace {

// the gradients asked for (bits 0-6, in the wrapper's argument order) and the residual
enum BwdFlags {
  kNeedX = 1, kNeedScale = 2, kNeedBias = 4, kNeedW1 = 8, kNeedB1 = 16, kNeedW2 = 32,
  kNeedB2 = 64, kResidual = 128
};

// The GEMM epilogues. kBwdGeluPre, fc1 recomputed: + b1, the f32
// pre-activation and bf16 GELU(pre) stored. kBwdGeluGrad, dH: the product
// times GELU'(pre) in f32, stored in bf16 (dpre), with the column sums of the
// f32 values per 128-row tile. kBwdF32, a weight gradient: the f32 product,
// one slice per split, or with one split its bf16 rounding. kBwdLnGrad, dxn:
// the f32 product stored (when out_f32 is set), with the column sums of
// dxn * xh, dxn and g per 128-row tile, xh = (x - mean) / std from the row's
// statistics: the partial dscale, dbias, db2.
enum BwdEpilogue { kBwdGeluPre = 0, kBwdGeluGrad = 1, kBwdF32 = 2, kBwdLnGrad = 3 };

struct BwdOut {
  const bf16* bias;    // kBwdGeluPre: b1 (N,)
  const float* pre;    // kBwdGeluGrad: the f32 pre-activation (M, N)
  bf16* out;           // kBwdGeluPre: GELU(pre); kBwdGeluGrad: dpre; kBwdF32: (M, N) or null
  float* out_f32;      // kBwdGeluPre: pre; kBwdF32: (splits, M, N); kBwdLnGrad: dxn or null
  float* colsum;       // (ceil(M / kBM), parts, N): kBwdGeluGrad 1 part, kBwdLnGrad 3
  const bf16* x;       // kBwdLnGrad: the block's input (M, N)
  const bf16* g;       // kBwdLnGrad: d out (M, N)
  const float* stats;  // kBwdLnGrad: each row's mean (M), then 1 / std (M)
};

// column sums an epilogue gives per 128-row tile
__host__ __device__ constexpr int bwd_sum_parts(int epi) {
  return epi == kBwdGeluGrad ? 1 : epi == kBwdLnGrad ? 3 : 0;
}

constexpr int kMaxDevices = 16;  // devices of one process whose launch settings are kept

__host__ __device__ constexpr size_t bwd_gemm_smem_bytes(int bn, int epi) {
  // gemm_smem_bytes, and the column-sum exchange of the eight consumer warps
  return gemm_smem_bytes(bn) + static_cast<size_t>(bwd_sum_parts(epi)) * 8 * bn * 4;
}

// d/dx of the exact GELU 0.5 x (1 + erf(x / sqrt 2)), in f32.
__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * 0.39894228040143268f * expf(-0.5f * x * x);
}

// out (M, N) = epilogue(A . B^T) with A (M, K) and B (N, K) as they lie:
// K-major, or MN-major where TA / TB is set; split-K over `splits` for kBwdF32.
template <int BN, int TA, int TB, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 2)
mlp_bwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, const BwdOut o, int m, int n,
                    int k, int splits) {
  constexpr int kParts = bwd_sum_parts(EPI);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = gemm_smem_base(smem_raw);
  float* red = reinterpret_cast<float*>(smem + gemm_ring_bytes(BN));  // kParts x 8 warps x BN
  gemm_mainloop<BN, TA, TB, EPI == kBwdF32>(
      map_a, map_b, smem, m, n, k, splits,
      [&](float (&acc)[BN / 2], int m0, int n0, int split, int row0, int lane) {
        const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
        float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
        if constexpr (EPI == kBwdLnGrad) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (row0 + 8 * h < m) {
              mean[h] = o.stats[row0 + 8 * h];
              rstd[h] = o.stats[m + row0 + 8 * h];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
          float2 bb = make_float2(0.f, 0.f);
          if constexpr (EPI == kBwdGeluPre) {
            if (col < n) {
              bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o.bias + col));
            }
          }
          // this thread's two rows summed: part p of columns col, col + 1 in sums[2p], sums[2p + 1]
          float sums[2 * (kParts > 0 ? kParts : 1)] = {};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            if (row >= m || col >= n) continue;  // n is even: the pair is in or out together
            const size_t off = static_cast<size_t>(row) * n + col;
            if constexpr (EPI == kBwdGeluPre) {
              v0 += bb.x;
              v1 += bb.y;
              *reinterpret_cast<float2*>(o.out_f32 + off) = make_float2(v0, v1);
              *reinterpret_cast<__nv_bfloat162*>(o.out + off) = __floats2bfloat162_rn(
                  0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f)),
                  0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f)));
            } else if constexpr (EPI == kBwdGeluGrad) {
              const float2 p = *reinterpret_cast<const float2*>(o.pre + off);
              v0 *= gelu_grad(p.x);
              v1 *= gelu_grad(p.y);
              *reinterpret_cast<__nv_bfloat162*>(o.out + off) = __floats2bfloat162_rn(v0, v1);
              sums[0] += v0;
              sums[1] += v1;
            } else if constexpr (EPI == kBwdLnGrad) {
              if (o.out_f32 != nullptr) {
                *reinterpret_cast<float2*>(o.out_f32 + off) = make_float2(v0, v1);
              }
              const float2 xv =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o.x + off));
              const float2 gv =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o.g + off));
              sums[0] += v0 * ((xv.x - mean[h]) * rstd[h]);
              sums[1] += v1 * ((xv.y - mean[h]) * rstd[h]);
              sums[2] += v0;
              sums[3] += v1;
              sums[4] += gv.x;
              sums[5] += gv.y;
            } else if (o.out != nullptr) {
              *reinterpret_cast<__nv_bfloat162*>(o.out + off) = __floats2bfloat162_rn(v0, v1);
            } else {
              *reinterpret_cast<float2*>(o.out_f32 + static_cast<size_t>(split) * m * n + off) =
                  make_float2(v0, v1);
            }
          }
          if constexpr (kParts > 0) {
            // over the 8 lanes of a column within the warp, in a fixed order
#pragma unroll
            for (int e = 0; e < 2 * kParts; ++e) {
              float v = sums[e];
              v += __shfl_xor_sync(0xffffffffu, v, 4);
              v += __shfl_xor_sync(0xffffffffu, v, 8);
              v += __shfl_xor_sync(0xffffffffu, v, 16);
              if (lane < 4) red[((e / 2) * 8 + wg * 4 + warp) * BN + 8 * j + 2 * lane + e % 2] = v;
            }
          }
        }
        if constexpr (kParts > 0) {
          // then over the 8 warps, in order: the tile's 128 rows
          consumers_sync();
          for (int q = threadIdx.x; q < kParts * BN; q += 256) {
            const int part = q / BN, t = q % BN;
            if (n0 + t < n) {
              float v = 0.f;
              for (int w = 0; w < 8; ++w) v += red[(part * 8 + w) * BN + t];
              o.colsum[(static_cast<size_t>(m0 / kBM) * kParts + part) * n + n0 + t] = v;
            }
          }
          consumers_sync();  // red is free for the next tile
        }
      });
}

template <int BN, int TA, int TB, int EPI>
cudaError_t launch_bwd_gemm(const void* a, const void* b, const BwdOut& o, int m, int n, int k,
                            int splits, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  // a K-major operand lies (MN, K), an MN-major one (K, MN)
  const bool mapped = (TA ? make_map(&map_a, a, k, m, 64) : make_map(&map_a, a, m, k, kBM)) &&
                      (TB ? make_map(&map_b, b, k, n, 64) : make_map(&map_b, b, n, k, BN));
  if (!mapped) return cudaErrorInvalidValue;
  const size_t smem = bwd_gemm_smem_bytes(BN, EPI);
  // the shared-memory attribute and the persistent grid's size, once per
  // instance and device: the backward makes up to five GEMM launches a call,
  // 24 calls a step, and the host's time is the step's
  static int ctas[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ctas[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(mlp_bwd_gemm_kernel<BN, TA, TB, EPI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mlp_bwd_gemm_kernel<BN, TA, TB, EPI>, kGemmThreads, smem);
    }
    if (err != cudaSuccess) return err;
    ctas[device] = std::max(per_sm, 1) * sms;
  }
  const int items = ((m + kBM - 1) / kBM) * ((n + BN - 1) / BN) * splits;
  const int grid = std::min(items, ctas[device]);
  mlp_bwd_gemm_kernel<BN, TA, TB, EPI><<<grid, kGemmThreads, smem, stream>>>(map_a, map_b, o, m,
                                                                            n, k, splits);
  return cudaGetLastError();
}

// BN is 128 or 64.
template <int TA, int TB, int EPI>
cudaError_t bwd_gemm(int bn, const void* a, const void* b, const BwdOut& o, int m, int n, int k,
                     int splits, cudaStream_t stream) {
  return bn == 128 ? launch_bwd_gemm<128, TA, TB, EPI>(a, b, o, m, n, k, splits, stream)
                   : launch_bwd_gemm<64, TA, TB, EPI>(a, b, o, m, n, k, splits, stream);
}

// dx = (dxh - mean(dxh) - xh * mean(dxh * xh)) / std (+ g with the residual),
// xh = (x - mean) / std and dxh = dxn * scale: one warp per row, in bf16.
__global__ void __launch_bounds__(kLnWarps * 32)
mlp_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                    const float* __restrict__ stats, const float* __restrict__ dxn,
                    const bf16* __restrict__ g, bf16* __restrict__ dx, int n, int c,
                    int residual) {
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n) return;
  const int c2 = c / 2;
  const size_t o = static_cast<size_t>(row) * c;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + o);
  const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(scale);
  const float2* dr = reinterpret_cast<const float2*>(dxn + o);
  const float mu = stats[row], rs = stats[n + row];
  float s1 = 0.f, sx = 0.f;
  for (int j = lane; j < c2; j += 32) {
    const float2 v = __bfloat1622float2(xr[j]), sc = __bfloat1622float2(s2[j]), d = dr[j];
    const float d0 = d.x * sc.x, d1 = d.y * sc.y;
    s1 += d0 + d1;
    sx += d0 * ((v.x - mu) * rs) + d1 * ((v.y - mu) * rs);
  }
  const float a = warp_sum(s1) / c, b = warp_sum(sx) / c;
  const __nv_bfloat162* gr = reinterpret_cast<const __nv_bfloat162*>(g + o);
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dx + o);
  for (int j = lane; j < c2; j += 32) {
    const float2 v = __bfloat1622float2(xr[j]), sc = __bfloat1622float2(s2[j]), d = dr[j];
    float y0 = rs * (d.x * sc.x - a - (v.x - mu) * rs * b);
    float y1 = rs * (d.y * sc.y - a - (v.y - mu) * rs * b);
    if (residual) {
      const float2 gg = __bfloat1622float2(gr[j]);
      y0 += gg.x;
      y1 += gg.y;
    }
    out[j] = __floats2bfloat162_rn(y0, y1);
  }
}

// out[j] = bf16(sum over r < rows of in[r * cols + j]): thread (tx, ty) of a
// (256 / ry, ry) block sums rows ty, ty + ry, ... in order, then thread ty = 0
// adds the ry sums in order.
__global__ void __launch_bounds__(256)
mlp_bwd_colsum_kernel(const float* __restrict__ in, int rows, size_t cols,
                      bf16* __restrict__ out) {
  __shared__ float sums[256];
  const int bx = blockDim.x, ry = blockDim.y;
  const size_t j = static_cast<size_t>(blockIdx.x) * bx + threadIdx.x;
  float s = 0.f;
  if (j < cols) {
    for (int r = threadIdx.y; r < rows; r += ry) s += in[static_cast<size_t>(r) * cols + j];
  }
  sums[threadIdx.y * bx + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < cols) {
    for (int i = 1; i < ry; ++i) s += sums[i * bx + threadIdx.x];
    out[j] = __float2bfloat16(s);
  }
}

cudaError_t colsum(const float* in, int rows, size_t cols, void* out, cudaStream_t st) {
  // tall inputs (the per-tile sums) spread their rows over 32 or 8 threads;
  // the split-K slices, a few rows over millions of columns, take one each
  const int ry = rows >= 256 ? 32 : rows >= 16 ? 8 : 1;
  const dim3 block(256 / ry, ry);
  const size_t blocks = (cols + block.x - 1) / block.x;
  mlp_bwd_colsum_kernel<<<static_cast<unsigned>(blocks), block, 0, st>>>(
      in, rows, cols, static_cast<bf16*>(out));
  return cudaGetLastError();
}

}  // namespace

// g (n, c) = d out -> dx (n, c), dw1 (f, c), db1 (f), dw2 (c, f) and
// daff (3, c) = (dscale, dbias, db2), all bf16, for the gradients `flags`
// asks for (the others' pointers may be null). Scratch, the caller's, each
// needed only by the steps that use it: xn (n, c) bf16, stats (2n) f32,
// h (n, f) bf16, pre (n, f) f32, dpre (n, f) bf16, dxn (n, c) f32 (for dx),
// ws (max(splits) x c x f) f32 (a split factor above 1), part_b1
// (ceil(n / 128), f) f32, part_rows (ceil(n / 128), 3c) f32. bn_*: the GEMMs'
// column tiles (64 or 128); splits_*: the split-K factors (1 .. ceil(n / 64)).
// Pointers to TMA-read tensors (xn, h, dpre, g, w1, w2) must be 16-byte
// aligned.
PD_API int pd_fused_ln_mlp_bwd(const void* x, const void* scale, const void* bias,
                               const void* w1, const void* b1, const void* w2, const void* g,
                               void* dx, void* dw1, void* db1, void* dw2, void* daff, void* xn,
                               void* stats, void* h, void* pre, void* dpre, void* dxn, void* ws,
                               void* part_b1, void* part_rows, int n, int c, int f, float eps,
                               int flags, int bn_h, int bn_dh, int bn_dx, int bn_dw2,
                               int splits_dw2, int bn_dw1, int splits_dw1, void* stream) {
  const auto tile_ok = [](int bn) { return bn == 64 || bn == 128; };
  const int ktiles = (n + kBK - 1) / kBK;
  const auto split_ok = [ktiles](int s) { return s >= 1 && s <= ktiles; };
  if (c % 16 != 0 || f % 16 != 0 || n <= 0 || !tile_ok(bn_h) || !tile_ok(bn_dh) ||
      !tile_ok(bn_dx) || !tile_ok(bn_dw2) || !tile_ok(bn_dw1) || !split_ok(splits_dw2) ||
      !split_ok(splits_dw1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_m = (n + kBM - 1) / kBM;
  // db2 comes from the dxn product's epilogue with dscale and dbias
  const bool need_dxn = flags & (kNeedX | kNeedScale | kNeedBias | kNeedB2);
  const bool need_dpre = need_dxn || (flags & (kNeedW1 | kNeedB1));
  const bool need_h = need_dpre || (flags & kNeedW2);
  cudaError_t err = cudaSuccess;

  if (need_h) {
    ln_mlp_norm_kernel<true><<<(n + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
        static_cast<const bf16*>(bias), static_cast<bf16*>(xn), static_cast<float*>(stats), n, c,
        eps);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && need_h) {  // pre = xn W1^T + b1, h = GELU(pre)
    BwdOut o{};
    o.bias = static_cast<const bf16*>(b1);
    o.out = static_cast<bf16*>(h);
    o.out_f32 = static_cast<float*>(pre);
    err = bwd_gemm<0, 0, kBwdGeluPre>(bn_h, xn, w1, o, n, f, c, 1, st);
  }
  // a weight gradient: one split rounds to bf16 in the epilogue, more sum their slices
  const auto weight_grad = [&](const void* a, const void* b, void* out, int m, int nn, int bn,
                               int splits) {
    BwdOut o{};
    if (splits == 1) {
      o.out = static_cast<bf16*>(out);
    } else {
      o.out_f32 = static_cast<float*>(ws);
    }
    cudaError_t e = bwd_gemm<1, 1, kBwdF32>(bn, a, b, o, m, nn, n, splits, st);
    if (e == cudaSuccess && splits > 1) {
      e = colsum(static_cast<float*>(ws), splits, static_cast<size_t>(m) * nn, out, st);
    }
    return e;
  };
  if (err == cudaSuccess && (flags & kNeedW2)) {  // dW2 (c, f) = g^T h
    err = weight_grad(g, h, dw2, c, f, bn_dw2, splits_dw2);
  }
  if (err == cudaSuccess && need_dpre) {  // dpre (n, f) = (g W2) * GELU'(pre)
    BwdOut o{};
    o.pre = static_cast<const float*>(pre);
    o.out = static_cast<bf16*>(dpre);
    o.colsum = static_cast<float*>(part_b1);
    err = bwd_gemm<0, 1, kBwdGeluGrad>(bn_dh, g, w2, o, n, f, c, 1, st);
    if (err == cudaSuccess && (flags & kNeedB1)) {
      err = colsum(static_cast<float*>(part_b1), tiles_m, f, db1, st);
    }
  }
  if (err == cudaSuccess && (flags & kNeedW1)) {  // dW1 (f, c) = dpre^T xn
    err = weight_grad(dpre, xn, dw1, f, c, bn_dw1, splits_dw1);
  }
  if (err == cudaSuccess && need_dxn) {  // dxn (n, c) = dpre W1, and the LayerNorm's sums
    BwdOut o{};
    o.out_f32 = static_cast<float*>(dxn);
    o.colsum = static_cast<float*>(part_rows);
    o.x = static_cast<const bf16*>(x);
    o.g = static_cast<const bf16*>(g);
    o.stats = static_cast<const float*>(stats);
    err = bwd_gemm<0, 1, kBwdLnGrad>(bn_dx, dpre, w1, o, n, c, f, 1, st);
    if (err == cudaSuccess && (flags & (kNeedScale | kNeedBias | kNeedB2))) {
      err = colsum(static_cast<float*>(part_rows), tiles_m, static_cast<size_t>(3) * c, daff,
                   st);
    }
  }
  if (err == cudaSuccess && (flags & kNeedX)) {
    mlp_bwd_rows_kernel<<<(n + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
        static_cast<const float*>(stats), static_cast<const float*>(dxn),
        static_cast<const bf16*>(g), static_cast<bf16*>(dx), n, c, (flags & kResidual) != 0);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
