// Multi-scale deformable attention sampling, P-folded, every level of one
// MSDeformAttn call in one launch:
//   out[b, q, m, :] = sum over levels l and points p of
//       attw[b, q, m, l, p] * bilinear(V_l[b, :, :, m, :], loc[b, q, m, l, p])
// with value (B, S, M, D) bf16 as the value projection emits it (level l is
// the rows start_l .. start_l + H_l * W_l, y-major), locations
// (B, Lq, M, L, P, 2) f32 normalised to [0, 1] as (x, y), weights
// (B, Lq, M, L, P) f32 or bf16; out (B, Lq, M * D) bf16.
//
// Replaces: the JAX package's ops/msda_pallas.py `_kernel_folded` (launched
// by `_forward_folded`, one launch per level). Numerics follow the port's
// plain version: pixel = loc * size - 0.5 (align_corners=False, no fused
// multiply-add), f32 corner weights w_y * w_x * attw, corners outside the
// map read zero, f32 accumulation over corners, points and levels, one
// rounding to bf16 at the end; the summation order is that of
// ops/msda_sampling.msda_folded_grouped_plain. With `pixel` set the
// locations are already pixel coordinates (the one-level
// `sample_level_folded`).
// Banded variant (BANDED, the JAX package's ops/ms_deform_attn.py
// `_ms_deform_attn_banded`; queries = pixels, Lq == S): a corner outside its
// query's band reads zero. `band` is int4 (row lo, row hi, column lo,
// column hi) per (query, level) (ops/ms_deform_attn.msda_band_table): each
// lane reads its tap's bounds with one 16-byte load, issued beside its
// location's. The dense instantiation reads no table.
// Bound on the H100: bytes. One encoder layer at B = 2, 640^2 reads V
// (8.6 MB), the f32 locations (12.9 MB) and the weights, and writes 8.6 MB;
// it does about 8 * D flops per (query, head, level, point), far under the
// ridge. V fits the 50 MB L2, so what costs is the gather: four corner rows
// of 2 * D bytes per tap through L1/L2, and the latency of each.
// Design: one warp per (image, query, head). Lane t loads tap t's (x, y) as
// one float2 and its weight and computes the tap's four corner rows and f32
// weights in registers (msda.cuh), 32 taps at a time: one memory latency for
// all L * P locations instead of one per tap. The warp then splits into
// 32 / GL groups of GL lanes (msda.cuh's lane layout; four groups of eight
// lanes with 4 channels, 8-byte loads, at D = 32), so one load instruction
// fetches a corner row for each group. Group g takes taps g, g + G, ...:
// each round hands every group its tap's corners by shuffles from the lane
// that owns it, and kUnroll rounds' loads (three taps x four corners per
// group at L * P = 12) are issued before the first multiply-add. An off-map
// corner weighs 0 at a clamped row, so nothing branches between the loads.
// The groups' f32 partials are summed by xor shuffles in a fixed tree
// (groups 2i + 2i+1, then pairs of pairs), and group 0 writes the row: no
// atomics, so two calls are bitwise equal.
#include "msda.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 3;  // rounds whose corner loads are in flight together
using msda::kMaxLevels;
using msda::Levels;

template <typename WT, int VEC, int C, bool BANDED>
__global__ void __launch_bounds__(kThreads)
msda_folded_kernel(const bf16* __restrict__ value, const float2* __restrict__ loc,
                   const WT* __restrict__ attw, bf16* __restrict__ out, unsigned items,
                   int s, int lq, int heads, int d, int points, Levels lv, int pixel,
                   int group_lanes, const int4* __restrict__ band) {
  // 32-bit index arithmetic (the host checks items < 2^32): a 64-bit
  // division costs more instructions than a warp's whole gather setup
  const unsigned item = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (item >= items) return;  // whole warps only
  const int lane = threadIdx.x % 32;
  const int m = static_cast<int>(item % static_cast<unsigned>(heads));
  const int b = static_cast<int>(item / (static_cast<unsigned>(heads) * lq));
  const int taps = lv.count * points;
  const int groups = 32 / group_lanes;
  const int g = lane / group_lanes, j = lane % group_lanes;
  const size_t row = static_cast<size_t>(heads) * d;  // one pixel's stride
  const bf16* vb = value + static_cast<size_t>(b) * s * row + static_cast<size_t>(m) * d;
  const float2* lp = loc + static_cast<size_t>(item) * taps;  // (L, P) of this (b, q, m)
  const WT* ap = attw + static_cast<size_t>(item) * taps;

  // BANDED: this query's (L) entries of the band table
  const int4* qband = band;
  if constexpr (BANDED) {
    const unsigned q = item / static_cast<unsigned>(heads) - static_cast<unsigned>(b) * lq;
    qband += static_cast<size_t>(q) * lv.count;
  }

  float acc[VEC * C];
#pragma unroll
  for (int i = 0; i < VEC * C; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < taps; t0 += 32) {
    // lane t owns tap t0 + t: its corners, computed once
    int crow[4] = {0, 0, 0, 0};
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    const int t = t0 + lane;
    if (t < taps) {
      const float2 xy = lp[t];
      const float a = to_f32(ap[t]);
      const int l = t / points;
      int h = 1, w = 1, start = 0;
#pragma unroll
      for (int i = 0; i < kMaxLevels; ++i) {
        if (i == l) {
          h = lv.h[i];
          w = lv.w[i];
          start = lv.start[i];
        }
      }
      float x = xy.x, y = xy.y;
      if (!pixel) {
        x = __fsub_rn(__fmul_rn(x, static_cast<float>(w)), 0.5f);
        y = __fsub_rn(__fmul_rn(y, static_cast<float>(h)), 0.5f);
      }
      if constexpr (BANDED) {
        const int4 bd = __ldg(qband + l);
        msda::tap_corners_in(x, y, h, w, bd.x, bd.y, bd.z, bd.w, a, false, start, crow, cw);
      } else {
        msda::tap_corners(x, y, h, w, a, false, start, crow, cw);
      }
    }
    const int n = min(32, taps - t0);
    const int rounds = (n + groups - 1) / groups;
    for (int r0 = 0; r0 < rounds; r0 += kUnroll) {
      msda::Raw<VEC> raw[kUnroll][4][C];
      float wr[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int src = (r0 + u) * groups + g;  // the lane that owns this group's tap
        const bool live = src < n;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (r0 + u >= rounds) {  // warp-uniform: no shuffles for rounds past the end
            wr[u][k] = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) raw[u][k][c].zero();
            continue;
          }
          const int r = __shfl_sync(msda::kFull, crow[k], src & 31);
          const float wk = __shfl_sync(msda::kFull, cw[k], src & 31);
          wr[u][k] = live ? wk : 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int ch = (c * group_lanes + j) * VEC;
            if (live && ch < d) {
              raw[u][k][c].load(vb + static_cast<size_t>(r) * row + ch);
            } else {
              raw[u][k][c].zero();
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int c = 0; c < C; ++c) raw[u][k][c].fma(wr[u][k], acc + c * VEC);
        }
      }
    }
  }
  // the groups' partials, pairwise in a fixed order
  for (int o = group_lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < VEC * C; ++i) acc[i] += __shfl_xor_sync(msda::kFull, acc[i], o);
  }
  if (g == 0) {
    bf16* op = out + static_cast<size_t>(item) * d;  // (B, Lq, M, D) == (B, Lq, M * D)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int ch = (c * group_lanes + j) * VEC;
      if (ch < d) msda::store_bf16<VEC>(op + ch, acc + c * VEC);
    }
  }
}

template <typename WT, int VEC, int C>
void launch(const void* value, const void* loc, const void* attw, void* out, unsigned items,
            int s, int lq, int heads, int d, int points, const Levels& lv, int pixel,
            int group_lanes, const void* band, cudaStream_t st) {
  const unsigned grid = items / (kThreads / 32) + (items % (kThreads / 32) != 0);
  const auto kernel = band != nullptr ? msda_folded_kernel<WT, VEC, C, true>
                                      : msda_folded_kernel<WT, VEC, C, false>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(value), static_cast<const float2*>(loc),
      static_cast<const WT*>(attw), static_cast<bf16*>(out), items, s, lq, heads, d, points,
      lv, pixel, group_lanes, static_cast<const int4*>(band));
}

template <int VEC, int C>
void launch_weights(int attw_f32, const void* value, const void* loc, const void* attw,
                    void* out, unsigned items, int s, int lq, int heads, int d, int points,
                    const Levels& lv, int pixel, int group_lanes, const void* band,
                    cudaStream_t st) {
  if (attw_f32) {
    launch<float, VEC, C>(value, loc, attw, out, items, s, lq, heads, d, points, lv, pixel,
                          group_lanes, band, st);
  } else {
    launch<bf16, VEC, C>(value, loc, attw, out, items, s, lq, heads, d, points, lv, pixel,
                         group_lanes, band, st);
  }
}

}  // namespace

// shapes: host array of `levels` (h, w) pairs; the levels' rows follow each
// other in value's S axis. attw_f32: weights are f32 (else bf16). vec and
// group_lanes: the lane layout of ops/msda_sampling.msda_lane_plan (vec 4
// needs D % 4 == 0 and an 8-byte-aligned value; loc must be 8-byte aligned).
// band: null (dense) or the 16-byte-aligned int32 (s, levels, 4) bounds
// table of ops/ms_deform_attn.msda_band_table (needs lq == s, pixel 0).
PD_API int pd_msda_folded(const void* value, const void* loc, const void* attw,
                          void* out, int batch, int s, int lq, int heads, int d,
                          int levels, int points, const int* shapes, int attw_f32,
                          int pixel, int vec, int group_lanes, const void* band,
                          void* stream) {
  if (points < 1 || d < 1 || d > 128 ||
      !msda::layout_ok(d, vec, group_lanes) ||
      reinterpret_cast<uintptr_t>(loc) % 8 != 0 ||
      (vec == 4 && reinterpret_cast<uintptr_t>(value) % 8 != 0) ||
      (band != nullptr && (lq != s || pixel || reinterpret_cast<uintptr_t>(band) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  const long long items = static_cast<long long>(batch) * lq * heads;
  if (msda::make_levels(shapes, levels, lv) != s || items > 0xffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned n_items = static_cast<unsigned>(items);
  if (vec == 4) {
    launch_weights<4, 1>(attw_f32, value, loc, attw, out, n_items, s, lq, heads, d, points,
                         lv, pixel, group_lanes, band, st);
  } else {
    launch_weights<1, 4>(attw_f32, value, loc, attw, out, n_items, s, lq, heads, d, points,
                         lv, pixel, group_lanes, band, st);
  }
  return static_cast<int>(cudaGetLastError());
}
