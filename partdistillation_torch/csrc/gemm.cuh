// The warp-specialised TMA + wgmma GEMM of the hand-written Hopper kernels:
//   out (M, N) = epilogue(A (M, K) . B (N, K)^T + bias)
// with A and B bf16, K-major as they lie (activation rows and nn.Linear
// weights), f32 accumulation and one rounding to bf16 in the epilogue.
// csrc/fused_mlp.cu runs it for fc1 and fc2 of the Swin MLP, and
// csrc/window_attention_proj.cu for the output projection of the window
// attention (`ln_mlp_gemm_kernel`). csrc/fused_mlp_bwd.cu runs the same main
// loop (`gemm_mainloop`) with epilogues of its own for the MLP's backward,
// where operands may also lie MN-major (the weight gradients reduce over the
// tokens, so they read activations down their columns) and the K range may
// be split.
// Design:
//  * 2D TMA loads with 128-byte swizzle of 128 x 64 (A) and BN x 64 (B)
//    tiles into a ring of 3-4 shared-memory stages (about 96 KB), filled by
//    one producer thread of a ninth warp and released through mbarriers;
//  * two consumer warpgroups, 64 rows each, run wgmma m64nBNk16 on the
//    stages that have arrived, keep one wgmma group in flight, and hold the
//    128 x BN f32 tile in registers;
//  * persistent CTAs, two per SM, walk the output tiles, the ring running on
//    from tile to tile: the producer loads the next tile's stages while the
//    consumers run the last one's epilogue, and the other CTA on the SM runs
//    its products meanwhile;
//  * TMA zero-fills the ragged row and column edges; the epilogue masks its
//    stores (bf16 pairs straight from the accumulator registers).
// BN (128, 96 or 64) is the caller's (ops/fused_mlp.py `_column_tile`).
// Operands must be 16-byte aligned, K and N multiples of 8 and N even.
#pragma once

#include <cuda.h>

#include <algorithm>

#include "mma.cuh"

namespace {

constexpr int kBM = 128;           // rows per CTA: two consumer warpgroups of 64
constexpr int kBK = 64;            // 64 bf16 = one 128-byte swizzled row
constexpr int kGemmThreads = 288;  // warpgroups 0-1 consume, warp 8 produces

// fc1: + b, exact GELU, bf16 hidden; fc2: + b, bf16, + the residual in bf16
// when one is given; a projection: + b, bf16 (the fc2 arithmetic with no
// residual, its own instance so that traces can tell the callers apart)
enum Epilogue { kGeluHidden = 0, kBiasResidual = 1, kBias = 2 };

// Ring depth: at most 96 KB of stages, so that two CTAs share an SM and one's
// epilogue overlaps the other's products.
__host__ __device__ constexpr int gemm_stages(int bn) { return bn == 64 ? 4 : 3; }


__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); LBO is unused.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}

// ... and of an MN-major tile (TMA boxes of 64 MN-contiguous elements by 64 K
// rows, 128-byte swizzle, 8 KB apart): 8 K rows of 128 bytes are one swizzle
// atom (SBO 1024 bytes to the next 8 K rows), the next 64 MN elements lie one
// box on (LBO 8 KB).
__device__ __forceinline__ uint64_t smem_desc_mn(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((8192ull >> 4) << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from touching accumulator registers that an
// asynchronous wgmma may still be writing.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32, registers) += A (64 x 16, smem) * B (N x 16, smem)^T, A and
// B K-major, or MN-major where their transpose bit TA / TB is set.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47},"
      " %48, %49, p, 1, 1, %51, %52;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t desc_a,
                                           uint64_t desc_b) {
  if constexpr (BN == 128) {
    wgmma_m64n128k16<TA, TB>(d, desc_a, desc_b);
  } else if constexpr (BN == 96) {
    wgmma_m64n96k16<TA, TB>(d, desc_a, desc_b);
  } else {
    wgmma_m64n64k16<TA, TB>(d, desc_a, desc_b);
  }
}

// Bytes of the ring's stages and mbarriers, from the aligned base on.
__host__ __device__ constexpr size_t gemm_ring_bytes(int bn) {
  return static_cast<size_t>(gemm_stages(bn)) * (kBM + bn) * kBK * 2 + 2 * gemm_stages(bn) * 8;
}

// ... and the dynamic shared memory a GEMM kernel asks for: the ring, and
// slack to align the base to 1024.
__host__ __device__ constexpr size_t gemm_smem_bytes(int bn) { return gemm_ring_bytes(bn) + 1024; }

// The dynamic shared memory's base, aligned to 1024 bytes for the swizzle.
__device__ __forceinline__ unsigned char* gemm_smem_base(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// A barrier of the eight consumer warps alone (not the producer's).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// The persistent main loop of the GEMM kernels (ln_mlp_gemm_kernel below and
// csrc/fused_mlp_bwd.cu's mlp_bwd_gemm_kernel), on the ring at `smem`
// (gemm_smem_base): out tile (M, N) = A (M, K) . B (N, K)^T, A and B through
// their tensor maps, then `epilogue(acc, m0, n0, split, row0, lane)` on each
// consumer thread with its warpgroup's part of the 128 x BN tile at (m0, n0):
// thread (warp w, lane l) holds rows row0 = m0 + 64 wg + 16w + l/4 (and
// row0 + 8) and column pairs n0 + 8j + 2(l%4).
//  * A K-major operand lies (MN, K) and comes in boxes of 64 x kBM (A) or
//    64 x BN (B); an MN-major one (TA, TB) lies (K, MN) and comes in 64 x 64
//    boxes, kBM / 64 or BN / 64 a stage, none that starts past the M or N
//    edge (those rows and columns are never stored).
//  * Work item i is output tile i (row tile major); with kSplit it is output
//    tile i % tiles over the K tiles [s * kt / S, (s + 1) * kt / S) of split
//    s = i / tiles (S = `splits` <= kt, so that no split is empty).
//  * CTA i takes items i, i + gridDim.x, ..., and the ring runs on across
//    them, so the producer loads the next item while the consumers run the
//    last one's epilogue.
template <int BN, int TA, int TB, bool kSplit, class EpilogueFn>
__device__ __forceinline__ void gemm_mainloop(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                              unsigned char* smem, int m, int n, int k,
                                              int splits, EpilogueFn&& epilogue) {
  constexpr int kStages = gemm_stages(BN);
  constexpr int kBox = 64 * kBK;  // elements of one MN-major box
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = reinterpret_cast<bf16*>(smem + kStages * kBM * kBK * 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * (kBM + BN) * kBK * 2);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = ((m + kBM - 1) / kBM) * tiles_n;
  const int ktiles = (k + kBK - 1) / kBK;
  const int items = kSplit ? tiles * splits : tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full, across items
    if (tid == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int tile = item, kt0 = 0, kt1 = ktiles;
        if constexpr (kSplit) {
          tile = item % tiles;
          kt0 = (item / tiles) * ktiles / splits;
          kt1 = (item / tiles + 1) * ktiles / splits;
        }
        const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
        const int boxes_a = TA ? min(kBM / 64, (m - m0 + 63) / 64) : 0;
        const int boxes_b = TB ? min(BN / 64, (n - n0 + 63) / 64) : 0;
        const uint32_t bytes = (TA ? boxes_a * kBox : kBM * kBK) * 2 +
                               (TB ? boxes_b * kBox : BN * kBK) * 2;
        for (int kt = kt0; kt < kt1; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], bytes);
          if constexpr (TA != 0) {
            for (int i = 0; i < boxes_a; ++i)
              tma_load_2d(sa + s * kBM * kBK + i * kBox, &map_a, &full[s], m0 + 64 * i, kt * kBK);
          } else {
            tma_load_2d(sa + s * kBM * kBK, &map_a, &full[s], kt * kBK, m0);
          }
          if constexpr (TB != 0) {
            for (int j = 0; j < boxes_b; ++j)
              tma_load_2d(sb + s * BN * kBK + j * kBox, &map_b, &full[s], n0 + 64 * j, kt * kBK);
          } else {
            tma_load_2d(sb + s * BN * kBK, &map_b, &full[s], kt * kBK, n0);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows wg*64 .. +63 of each tile, which are
    // its 64 K-major rows or its MN-major box alike
    const int arow = wg * 64;
    const int warp = tid / 32, lane = tid % 32;
    float acc[BN / 2];
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int tile = item, split = 0, kt0 = 0, kt1 = ktiles;
      if constexpr (kSplit) {
        tile = item % tiles;
        split = item / tiles;
        kt0 = split * ktiles / splits;
        kt1 = (split + 1) * ktiles / splits;
      }
      const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      fence_acc(acc);
      for (int kt = kt0; kt < kt1; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const bf16* a = sa + (s * kBM + arow) * kBK;
        const bf16* b = sb + s * BN * kBK;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // a K step of 16 is 32 bytes along a K-major row, 16 rows of an MN-major box
          wgmma_tile<BN, TA, TB>(acc, TA ? smem_desc_mn(a + kk * 16 * 64) : smem_desc(a + kk * 16),
                                 TB ? smem_desc_mn(b + kk * 16 * 64) : smem_desc(b + kk * 16));
        }
        wgmma_commit();
        // one group stays in flight: the previous stage is read and free
        wgmma_wait<1>();
        fence_acc(acc);
        if (kt > kt0 && tid == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (tid == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      epilogue(acc, m0, n0, split, m0 + arow + 16 * warp + lane / 4, lane);
    }
  }
}

// out (M, N) = epilogue(A (M, K) . B (N, K)^T): A and B K-major, bias (N,)
// bf16; the residual (M, N) or null.
template <int BN, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 2)
ln_mlp_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const bf16* __restrict__ bias,
                   const bf16* __restrict__ resid, bf16* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  gemm_mainloop<BN, 0, 0, false>(
      map_a, map_b, gemm_smem_base(smem_raw), m, n, k, 1,
      [&](float (&acc)[BN / 2], int, int n0, int, int row0, int lane) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
          if (col >= n) continue;  // n is even: the pair is in or out together
          const float2 bb =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            if (row >= m) continue;
            float v0 = acc[4 * j + 2 * h] + bb.x;
            float v1 = acc[4 * j + 2 * h + 1] + bb.y;
            const size_t o = static_cast<size_t>(row) * n + col;
            __nv_bfloat162 y;
            if constexpr (EPI == kGeluHidden) {
              v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
              v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
              y = __floats2bfloat162_rn(v0, v1);
            } else {
              y = __floats2bfloat162_rn(v0, v1);
              if (resid != nullptr) {
                const float2 r =
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + o));
                const float2 yf = __bfloat1622float2(y);
                y = __floats2bfloat162_rn(r.x + yf.x, r.y + yf.y);
              }
            }
            *reinterpret_cast<__nv_bfloat162*>(out + o) = y;
          }
        }
      });
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), looked up through the
// runtime: the library links against cudart only.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// Row-major bf16 (rows, cols) read in boxes of 64 columns x box_rows rows,
// 128-byte swizzle, zero fill past the edges.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int EPI>
cudaError_t launch_gemm(const void* a, const void* b, const void* bias, const void* resid,
                        void* out, int m, int n, int k, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, m, k, kBM) || !make_map(&map_b, b, n, k, BN)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = gemm_smem_bytes(BN);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_gemm_kernel<BN, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // persistent grid: as many CTAs as the card holds at once, at most one per tile
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_mlp_gemm_kernel<BN, EPI>,
                                                        kGemmThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const int tiles = ((m + kBM - 1) / kBM) * ((n + BN - 1) / BN);
  const int grid = std::min(tiles, std::max(per_sm, 1) * sms);
  ln_mlp_gemm_kernel<BN, EPI><<<grid, kGemmThreads, smem, stream>>>(
      map_a, map_b, static_cast<const bf16*>(bias), static_cast<const bf16*>(resid),
      static_cast<bf16*>(out), m, n, k);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t gemm(int bn, const void* a, const void* b, const void* bias, const void* resid,
                 void* out, int m, int n, int k, cudaStream_t stream) {
  switch (bn) {
    case 128:
      return launch_gemm<128, EPI>(a, b, bias, resid, out, m, n, k, stream);
    case 96:
      return launch_gemm<96, EPI>(a, b, bias, resid, out, m, n, k, stream);
    default:
      return launch_gemm<64, EPI>(a, b, bias, resid, out, m, n, k, stream);
  }
}

}  // namespace
