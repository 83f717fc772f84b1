// Shared pieces of the deformable-sampling kernels (msda_folded.cu, its
// backward msda_folded_bwd.cu, msda_taps.cu): a tap's four bilinear corners,
// computed once by the lane that owns the tap, the lane layout that reads a
// corner row, and the level table of the P-folded launches.
//
// Lane layout (ops/msda_sampling.msda_lane_plan picks it per head width D):
// a warp is 32 / GL groups of GL lanes; within a group, lane j holds the
// channels (c * GL + j) * VEC .. + VEC - 1 for c < C. VEC = 4 (8-byte loads)
// where D % 4 == 0 and the map is 8-byte aligned, else VEC = 1 (2-byte
// loads); GL is the least power of two with GL * VEC * C >= D, C > 1 only
// when VEC = 1 and D > 32. One load instruction of the warp thus fetches one
// corner row for each group, i.e. 32 / GL taps at once.
#pragma once

#include "common.cuh"

namespace msda {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLevels = 8;

// The levels of one P-folded launch: each level's map size and first row
// in value's S axis.
struct Levels {
  int count;
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

// Fills lv from the host array of `levels` (h, w) pairs; returns the rows
// of all levels (S), or -1 for a count outside 1..kMaxLevels.
inline int make_levels(const int* shapes, int levels, Levels& lv) {
  if (levels < 1 || levels > kMaxLevels) return -1;
  lv.count = levels;
  int start = 0;
  for (int l = 0; l < levels; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  return start;
}

// Whether (vec, group_lanes) is a layout above that covers D channels: VEC 4
// or 1 (C = 1 or 4 chunks), GL a power of two up to 32.
inline bool layout_ok(int d, int vec, int group_lanes) {
  return group_lanes >= 1 && group_lanes <= 32 && (group_lanes & (group_lanes - 1)) == 0 &&
         d <= 4 * group_lanes && ((vec == 4 && d % 4 == 0) || vec == 1);
}

// The four corners of the tap at pixel (x, y) (align_corners=False) on an
// h x w map, in the order (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1):
// the corner's pixel row (base + y * w + x, or base + x * h + y when x_major),
// its weight w_y * w_x and that weight's derivatives by x and by y. A corner
// outside rows [ylo, yhi) and columns [xlo, xhi) (a band within the map; the
// whole map in tap_corners), or a NaN coordinate, takes weight and
// derivatives 0 and the row of the corner clamped into the map, as the plain
// version gathers it. floor's derivative is taken as 0, so that d(w_x)/dx is
// -1 for the corner at x0 and +1 for the one at x0 + 1.
__device__ __forceinline__ void tap_corner_terms(float x, float y, int h, int w, int ylo,
                                                 int yhi, int xlo, int xhi, bool x_major,
                                                 int base, int (&row)[4], float (&wgt)[4],
                                                 float (&dwdx)[4], float (&dwdy)[4]) {
  // clamped before the conversion to int, so that far or NaN taps stay defined
  const float x0f = fminf(fmaxf(floorf(x), -2.f), static_cast<float>(w));
  const float y0f = fminf(fmaxf(floorf(y), -2.f), static_cast<float>(h));
  const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
  const float wx[2] = {__fsub_rn(1.f, fx), fx};
  const float wy[2] = {__fsub_rn(1.f, fy), fy};
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
#pragma unroll
  for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const int yi = y0 + cy, xi = x0 + cx, k = 2 * cy + cx;
      const bool on = yi >= ylo && yi < yhi && xi >= xlo && xi < xhi;
      const int yc = min(max(yi, 0), h - 1), xc = min(max(xi, 0), w - 1);
      row[k] = base + (x_major ? xc * h + yc : yc * w + xc);
      wgt[k] = on ? __fmul_rn(wy[cy], wx[cx]) : 0.f;
      dwdx[k] = on ? (cx ? wy[cy] : -wy[cy]) : 0.f;
      dwdy[k] = on ? (cy ? wx[cx] : -wx[cx]) : 0.f;
    }
  }
}

// The forward's corners: rows as above, weights w_y * w_x * a in f32.
__device__ __forceinline__ void tap_corners_in(float x, float y, int h, int w, int ylo,
                                               int yhi, int xlo, int xhi, float a,
                                               bool x_major, int base, int (&row)[4],
                                               float (&wgt)[4]) {
  float dwdx[4], dwdy[4];  // unused: the compiler drops them
  tap_corner_terms(x, y, h, w, ylo, yhi, xlo, xhi, x_major, base, row, wgt, dwdx, dwdy);
#pragma unroll
  for (int k = 0; k < 4; ++k) wgt[k] = __fmul_rn(wgt[k], a);
}

__device__ __forceinline__ void tap_corners(float x, float y, int h, int w, float a,
                                            bool x_major, int base, int (&row)[4],
                                            float (&wgt)[4]) {
  tap_corners_in(x, y, h, w, 0, h, 0, w, a, x_major, base, row, wgt);
}

// VEC consecutive bf16 channels of one corner row, kept raw while the load
// is in flight and widened to f32 at the multiply-add.
template <int VEC>
struct Raw;

template <>
struct Raw<4> {
  uint2 u;
  __device__ __forceinline__ void load(const bf16* p) {
    u = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void zero() { u = make_uint2(0u, 0u); }
  __device__ __forceinline__ void fma(float wgt, float* acc) const {
    acc[0] = fmaf(wgt, __uint_as_float(u.x << 16), acc[0]);
    acc[1] = fmaf(wgt, __uint_as_float(u.x & 0xffff0000u), acc[1]);
    acc[2] = fmaf(wgt, __uint_as_float(u.y << 16), acc[2]);
    acc[3] = fmaf(wgt, __uint_as_float(u.y & 0xffff0000u), acc[3]);
  }
  __device__ __forceinline__ void widen(float* out) const {
    out[0] = __uint_as_float(u.x << 16);
    out[1] = __uint_as_float(u.x & 0xffff0000u);
    out[2] = __uint_as_float(u.y << 16);
    out[3] = __uint_as_float(u.y & 0xffff0000u);
  }
  // acc + sum of g[i] * channel i, by fused multiply-adds in channel order
  __device__ __forceinline__ float dot(const float* g, float acc) const {
    acc = fmaf(g[0], __uint_as_float(u.x << 16), acc);
    acc = fmaf(g[1], __uint_as_float(u.x & 0xffff0000u), acc);
    acc = fmaf(g[2], __uint_as_float(u.y << 16), acc);
    return fmaf(g[3], __uint_as_float(u.y & 0xffff0000u), acc);
  }
};

template <>
struct Raw<1> {
  unsigned short u;
  __device__ __forceinline__ void load(const bf16* p) {
    u = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ void zero() { u = 0; }
  __device__ __forceinline__ void fma(float wgt, float* acc) const {
    acc[0] = fmaf(wgt, __uint_as_float(static_cast<unsigned>(u) << 16), acc[0]);
  }
  __device__ __forceinline__ void widen(float* out) const {
    out[0] = __uint_as_float(static_cast<unsigned>(u) << 16);
  }
  __device__ __forceinline__ float dot(const float* g, float acc) const {
    return fmaf(g[0], __uint_as_float(static_cast<unsigned>(u) << 16), acc);
  }
};

// Rounds VEC f32 channels to bf16 and stores them at p.
template <int VEC>
__device__ __forceinline__ void store_bf16(bf16* p, const float* acc) {
  if constexpr (VEC == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&lo);
    u.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    *p = __float2bfloat16(acc[0]);
  }
}

}  // namespace msda
