// Gradient of the P-folded deformable sampling (msda_folded.cu), every level
// of one MSDeformAttn call, from one pass over its taps:
//   dot_c    = <g[b, q, m, :], V_l[b, row_c, m, :]>      (f32)
//   dattw    = sum over corners c of w_c * dot_c
//   dloc_x   = W_l * attw * sum over c of (d w_c / dx) * dot_c, dloc_y likewise
//   dvalue[b, row_c, m, :] += attw * w_c * g[b, q, m, :]
// for every tap (query q, head m, level l, point p), with the forward's
// corners (msda.cuh): pixel = loc * size - 0.5, w_c = w_y * w_x, a corner off
// the map or (BANDED) outside its query's band reads zero and has no
// gradient; floor's derivative is 0, as autograd takes it. value (B, S, M, D)
// bf16, loc (B, Lq, M, L, P, 2) f32, attw (B, Lq, M, L, P) f32 or bf16, g
// (B, Lq, M * D) bf16; dloc f32, dattw in attw's type, dvalue bf16.
//
// Replaces: the VJP of the plain version recomputed under autograd (f32
// gathers of every corner, their scatter-add). No TPU kernel: the JAX
// package's custom_vjp differentiates an XLA composition of `_kernel_folded`'s
// function, so this backward is the port's own.
// Bound on the H100: bytes. One encoder layer of ViTDet-L at 1024^2, B = 4,
// reads value and g (44 MB each in bf16), the f32 locations (66 MB), the
// weights and the band table, and writes dvalue, dloc and dattw: 298 MB,
// 0.089 ms at 3.35 TB/s. Its operations (a dot product and an axpy of D
// channels per corner) are far under the ridge.
// Design: one warp per (image, query, head), as the forward. The query's g
// row is loaded once, each lane holding its channels of the lane layout
// (msda.cuh). Lane t owns tap t: its corner rows, weights and their
// derivatives, computed once. The groups of GL lanes take the taps round by
// round, as the forward's: each corner row is loaded, its dot product with g
// summed by xor shuffles within the group, and handed back by one shuffle to
// the lane that owns the tap, which forms dattw and dloc alone, so they are
// written once each, without atomics. dvalue is a sum over queries: each
// group adds attw * w_c * g to an f32 scratch of value's layout by vector
// reductions (red.global.add.v4.f32 at VEC = 4), skipping corners of weight
// 0; neighbouring queries hit neighbouring rows, so the adds meet in L2.
// msda_folded_bwd_zero_kernel clears the scratch first and
// msda_folded_bwd_round_kernel rounds it once to bf16 last, so dvalue is
// accumulated in f32 as the plain VJP's scatter-add is; the order of those
// adds varies from run to run, as the scatter-add's does on the card.
#include "msda.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 3;  // rounds whose corner loads are in flight together
constexpr int kPassBlocks = 132 * 8;  // grid of the clearing and rounding passes
using msda::Levels;

// p[i] += wgt * g[i] for VEC consecutive f32 channels, without reading back.
template <int VEC>
__device__ __forceinline__ void red_add(float* p, float wgt, const float* g) {
  if constexpr (VEC == 4) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "f"(__fmul_rn(wgt, g[0])), "f"(__fmul_rn(wgt, g[1])),
                 "f"(__fmul_rn(wgt, g[2])), "f"(__fmul_rn(wgt, g[3]))
                 : "memory");
  } else {
    atomicAdd(p, __fmul_rn(wgt, g[0]));
  }
}

__global__ void __launch_bounds__(kThreads)
msda_folded_bwd_zero_kernel(float4* __restrict__ acc, size_t n4, float* __restrict__ tail,
                            int n_tail) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n4; i += stride)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < n_tail) tail[threadIdx.x] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
msda_folded_bwd_round_kernel(const float4* __restrict__ acc, uint2* __restrict__ out, size_t n4,
                             const float* __restrict__ tail, bf16* __restrict__ out_tail,
                             int n_tail) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 v = acc[i];
    const float f[4] = {v.x, v.y, v.z, v.w};
    uint2 u;
    msda::store_bf16<4>(reinterpret_cast<bf16*>(&u), f);
    out[i] = u;
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < n_tail)
    out_tail[threadIdx.x] = __float2bfloat16(tail[threadIdx.x]);
}

template <typename WT, int VEC, int C, bool BANDED>
__global__ void __launch_bounds__(kThreads)
msda_folded_bwd_kernel(const bf16* __restrict__ value, const float2* __restrict__ loc,
                       const WT* __restrict__ attw, const bf16* __restrict__ grad,
                       float* __restrict__ dacc, float2* __restrict__ dloc,
                       WT* __restrict__ dattw, unsigned items, int s, int lq, int heads, int d,
                       int points, Levels lv, int group_lanes, const int4* __restrict__ band) {
  const unsigned item = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (item >= items) return;  // whole warps only
  const int lane = threadIdx.x % 32;
  const int m = static_cast<int>(item % static_cast<unsigned>(heads));
  const int b = static_cast<int>(item / (static_cast<unsigned>(heads) * lq));
  const int taps = lv.count * points;
  const int groups = 32 / group_lanes;
  const int g = lane / group_lanes, j = lane % group_lanes;
  const size_t row = static_cast<size_t>(heads) * d;  // one pixel's stride
  const size_t head0 = static_cast<size_t>(b) * s * row + static_cast<size_t>(m) * d;
  const bf16* vb = value + head0;
  const float2* lp = loc + static_cast<size_t>(item) * taps;  // (L, P) of this (b, q, m)
  const WT* ap = attw + static_cast<size_t>(item) * taps;
  const bool want_tap = dloc != nullptr || dattw != nullptr;

  const int4* qband = band;
  if constexpr (BANDED) {
    const unsigned q = item / static_cast<unsigned>(heads) - static_cast<unsigned>(b) * lq;
    qband += static_cast<size_t>(q) * lv.count;
  }

  // this lane's channels of the query's output gradient, in f32
  float gv[VEC * C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int ch = (c * group_lanes + j) * VEC;
    msda::Raw<VEC> raw;
    if (ch < d) {
      raw.load(grad + static_cast<size_t>(item) * d + ch);
    } else {
      raw.zero();
    }
    raw.widen(gv + c * VEC);
  }

  for (int t0 = 0; t0 < taps; t0 += 32) {
    // lane t owns tap t0 + t: its corners and their derivatives
    int crow[4] = {0, 0, 0, 0};
    float cw[4] = {0.f, 0.f, 0.f, 0.f};  // w_c * attw, what dvalue takes
    float wyx[4] = {0.f, 0.f, 0.f, 0.f}, dwdx[4] = {0.f, 0.f, 0.f, 0.f};
    float dwdy[4] = {0.f, 0.f, 0.f, 0.f}, dot[4] = {0.f, 0.f, 0.f, 0.f};
    float a = 0.f, scale_x = 0.f, scale_y = 0.f;
    const int t = t0 + lane;
    if (t < taps) {
      const float2 xy = lp[t];
      a = to_f32(ap[t]);
      const int l = t / points;
      int h = 1, w = 1, start = 0;
#pragma unroll
      for (int i = 0; i < msda::kMaxLevels; ++i) {
        if (i == l) {
          h = lv.h[i];
          w = lv.w[i];
          start = lv.start[i];
        }
      }
      scale_x = static_cast<float>(w);
      scale_y = static_cast<float>(h);
      const float x = __fsub_rn(__fmul_rn(xy.x, scale_x), 0.5f);
      const float y = __fsub_rn(__fmul_rn(xy.y, scale_y), 0.5f);
      int4 bd = make_int4(0, h, 0, w);
      if constexpr (BANDED) bd = __ldg(qband + l);
      msda::tap_corner_terms(x, y, h, w, bd.x, bd.y, bd.z, bd.w, false, start, crow, wyx, dwdx,
                             dwdy);
#pragma unroll
      for (int k = 0; k < 4; ++k) cw[k] = __fmul_rn(wyx[k], a);
    }
    const int n = min(32, taps - t0);
    const int rounds = (n + groups - 1) / groups;
    for (int r0 = 0; r0 < rounds; r0 += kUnroll) {
      msda::Raw<VEC> raw[kUnroll][4][C];
      int rr[kUnroll][4];
      float wr[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int src = (r0 + u) * groups + g;  // the lane that owns this group's tap
        const bool live = src < n;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (r0 + u >= rounds) {  // warp-uniform: no shuffles for rounds past the end
            rr[u][k] = 0;
            wr[u][k] = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) raw[u][k][c].zero();
            continue;
          }
          rr[u][k] = __shfl_sync(msda::kFull, crow[k], src & 31);
          const float wk = __shfl_sync(msda::kFull, cw[k], src & 31);
          wr[u][k] = live ? wk : 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int ch = (c * group_lanes + j) * VEC;
            if (live && ch < d) {
              raw[u][k][c].load(vb + static_cast<size_t>(rr[u][k]) * row + ch);
            } else {
              raw[u][k][c].zero();
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u >= rounds) break;  // warp-uniform
        const int base = (r0 + u) * groups;  // the first lane whose tap this round takes
        const bool mine = lane >= base && lane < base + groups;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (want_tap) {
            float p = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) p = raw[u][k][c].dot(gv + c * VEC, p);
            for (int o = group_lanes >> 1; o > 0; o >>= 1) p += __shfl_xor_sync(msda::kFull, p, o);
            // the owner of tap base + i reads group i's sum
            const float got =
                __shfl_sync(msda::kFull, p, ((lane - base) & (groups - 1)) * group_lanes);
            if (mine) dot[k] = got;
          }
          if (dacc != nullptr && wr[u][k] != 0.f) {
            float* dp = dacc + head0 + static_cast<size_t>(rr[u][k]) * row;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const int ch = (c * group_lanes + j) * VEC;
              if (ch < d) red_add<VEC>(dp + ch, wr[u][k], gv + c * VEC);
            }
          }
        }
      }
    }
    if (t < taps && want_tap) {
      float dw = 0.f, dx = 0.f, dy = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dw = fmaf(wyx[k], dot[k], dw);
        dx = fmaf(dwdx[k], dot[k], dx);
        dy = fmaf(dwdy[k], dot[k], dy);
      }
      const size_t at = static_cast<size_t>(item) * taps + t;
      if (dattw != nullptr) dattw[at] = from_f32<WT>(dw);
      if (dloc != nullptr)
        dloc[at] = make_float2(__fmul_rn(scale_x, __fmul_rn(a, dx)),
                               __fmul_rn(scale_y, __fmul_rn(a, dy)));
    }
  }
}

template <typename WT, int VEC, int C>
void launch(const void* value, const void* loc, const void* attw, const void* grad, void* dacc,
            void* dloc, void* dattw, unsigned items, int s, int lq, int heads, int d, int points,
            const Levels& lv, int group_lanes, const void* band, cudaStream_t st) {
  const unsigned grid = items / (kThreads / 32) + (items % (kThreads / 32) != 0);
  const auto kernel = band != nullptr ? msda_folded_bwd_kernel<WT, VEC, C, true>
                                      : msda_folded_bwd_kernel<WT, VEC, C, false>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(value), static_cast<const float2*>(loc),
      static_cast<const WT*>(attw), static_cast<const bf16*>(grad), static_cast<float*>(dacc),
      static_cast<float2*>(dloc), static_cast<WT*>(dattw), items, s, lq, heads, d, points, lv,
      group_lanes, static_cast<const int4*>(band));
}

template <int VEC, int C>
void launch_weights(int attw_f32, const void* value, const void* loc, const void* attw,
                    const void* grad, void* dacc, void* dloc, void* dattw, unsigned items,
                    int s, int lq, int heads, int d, int points, const Levels& lv,
                    int group_lanes, const void* band, cudaStream_t st) {
  if (attw_f32) {
    launch<float, VEC, C>(value, loc, attw, grad, dacc, dloc, dattw, items, s, lq, heads, d,
                          points, lv, group_lanes, band, st);
  } else {
    launch<bf16, VEC, C>(value, loc, attw, grad, dacc, dloc, dattw, items, s, lq, heads, d,
                         points, lv, group_lanes, band, st);
  }
}

unsigned pass_grid(size_t n4) {
  const size_t blocks = (n4 + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kPassBlocks ? (blocks > 0 ? blocks : 1) : kPassBlocks);
}

}  // namespace

// The gradients of pd_msda_folded (pixel 0) at grad, (B, Lq, M * D) bf16 and
// laid out as its output. Each of dvalue (bf16, value's shape, with dacc: an
// f32 scratch of as many elements, 16-byte aligned), dloc (f32, loc's shape)
// and dattw (attw's type and shape) may be null, and is then not computed.
// Layout and band as pd_msda_folded's; vec 4 also needs grad 8-byte aligned.
// Up to three launches: the scratch cleared, the taps, the scratch rounded
// into dvalue.
PD_API int pd_msda_folded_bwd(const void* value, const void* loc, const void* attw,
                              const void* grad, void* dvalue, void* dacc, void* dloc,
                              void* dattw, int batch, int s, int lq, int heads, int d,
                              int levels, int points, const int* shapes, int attw_f32, int vec,
                              int group_lanes, const void* band, void* stream) {
  const auto misaligned = [](const void* p, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(p) % to != 0;
  };
  if (points < 1 || d < 1 || d > 128 || !msda::layout_ok(d, vec, group_lanes) ||
      misaligned(loc, 8) || misaligned(dloc, 8) || misaligned(dacc, 16) ||
      misaligned(dvalue, 8) || (dvalue == nullptr) != (dacc == nullptr) ||
      (vec == 4 && (misaligned(value, 8) || misaligned(grad, 8))) ||
      (band != nullptr && (lq != s || misaligned(band, 16))))
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  const long long items = static_cast<long long>(batch) * lq * heads;
  if (msda::make_levels(shapes, levels, lv) != s || items > 0xffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(batch) * s * heads * d;
  const size_t n4 = n / 4;
  const int n_tail = static_cast<int>(n % 4);
  if (dacc != nullptr) {
    float* acc = static_cast<float*>(dacc);
    msda_folded_bwd_zero_kernel<<<pass_grid(n4), kThreads, 0, st>>>(
        reinterpret_cast<float4*>(acc), n4, acc + 4 * n4, n_tail);
  }
  const unsigned n_items = static_cast<unsigned>(items);
  if (vec == 4) {
    launch_weights<4, 1>(attw_f32, value, loc, attw, grad, dacc, dloc, dattw, n_items, s, lq,
                         heads, d, points, lv, group_lanes, band, st);
  } else {
    launch_weights<1, 4>(attw_f32, value, loc, attw, grad, dacc, dloc, dattw, n_items, s, lq,
                         heads, d, points, lv, group_lanes, band, st);
  }
  if (dvalue != nullptr) {
    const float* acc = static_cast<const float*>(dacc);
    msda_folded_bwd_round_kernel<<<pass_grid(n4), kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(acc), static_cast<uint2*>(dvalue), n4, acc + 4 * n4,
        static_cast<bf16*>(dvalue) + 4 * n4, n_tail);
  }
  return static_cast<int>(cudaGetLastError());
}
