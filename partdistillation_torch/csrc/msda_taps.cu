// Deformable-attention sampling per tap: for every (slice bm, tap n)
//   out[bm, n, :] = attw[bm, n] * bilinear(v_whd[bm], x[bm, n], y[bm, n])
// with v_whd (BM, W, H * D) bf16, the level's value map x-major (pixel
// (x, y), channel c at [bm, x, y * D + c]), pixel coordinates x, y and
// weights attw (BM, N) f32; out (BM, N, D) bf16.
//
// Replaces: the JAX package's ops/msda_pallas.py `_kernel_expand` and
// `_kernel` (the "expand" and "sel" variants launched by `_forward`). The two
// compute the same function and differ only in how the TPU assembles the
// y-hat, so one kernel serves both. Numerics follow the port's plain
// version: f32 corner weights w_y * w_x * attw, corners outside the map read
// zero, f32 accumulation, one rounding to bf16.
// Bound on the H100: bytes (the map, x, y, attw read once, the output
// written once: at 80^2, BM = 16, N = 33600, mostly the 34 MB output); about
// 8 * D flops per tap.
// Design: one warp per 32 consecutive taps of a slice. Lane t loads tap t's
// x, y and weight (three coalesced 128-byte reads) and computes its four
// corner rows and f32 weights (msda.cuh). The warp then works as 32 / GL
// groups of GL lanes (msda.cuh's lane layout: four groups of eight lanes
// with 4 channels, 8-byte loads, at D = 32); each round hands every group
// one tap's corners by shuffles, kUnroll rounds' corner loads are in flight
// together, and each group stores its tap's row, so the rows of a round
// (adjacent taps) make one contiguous write. Ragged N and the last slice's
// taps are masked per lane.
#include "msda.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // rounds whose corner loads are in flight together

template <int VEC, int C>
__global__ void __launch_bounds__(kThreads)
msda_taps_kernel(const bf16* __restrict__ v, const float* __restrict__ xs,
                 const float* __restrict__ ys, const float* __restrict__ attw,
                 bf16* __restrict__ out, int bm, int n, int h, int w, int d, int group_lanes) {
  // 32-bit index arithmetic: the host checks BM x tiles < 2^32
  const unsigned tiles = (n + 31) / 32;  // warps per slice
  const unsigned warp = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (warp >= bm * tiles) return;  // whole warps only
  const int lane = threadIdx.x % 32;
  const int slice = static_cast<int>(warp / tiles);
  const int n0 = static_cast<int>(warp % tiles) * 32;
  const int count = min(32, n - n0);
  const size_t tap0 = static_cast<size_t>(slice) * n + n0;
  const int groups = 32 / group_lanes;
  const int g = lane / group_lanes, j = lane % group_lanes;

  int crow[4] = {0, 0, 0, 0};
  float cw[4] = {0.f, 0.f, 0.f, 0.f};
  if (lane < count) {
    msda::tap_corners(xs[tap0 + lane], ys[tap0 + lane], h, w, attw[tap0 + lane], true, 0,
                      crow, cw);
  }
  const bf16* vs = v + static_cast<size_t>(slice) * w * h * d;
  const int rounds = (count + groups - 1) / groups;
  for (int r0 = 0; r0 < rounds; r0 += kUnroll) {
    msda::Raw<VEC> raw[kUnroll][4][C];
    float wr[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int src = (r0 + u) * groups + g;  // this group's tap in the round
      const bool live = src < count;
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
            raw[u][k][c].load(vs + static_cast<size_t>(r) * d + ch);
          } else {
            raw[u][k][c].zero();
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int src = (r0 + u) * groups + g;
      float acc[VEC * C];
#pragma unroll
      for (int i = 0; i < VEC * C; ++i) acc[i] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int c = 0; c < C; ++c) raw[u][k][c].fma(wr[u][k], acc + c * VEC);
      }
      if (src < count) {
        bf16* op = out + (tap0 + src) * d;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int ch = (c * group_lanes + j) * VEC;
          if (ch < d) msda::store_bf16<VEC>(op + ch, acc + c * VEC);
        }
      }
    }
  }
}

}  // namespace

// vec and group_lanes: the lane layout of ops/msda_sampling.msda_lane_plan
// (vec 4 needs D % 4 == 0 and an 8-byte-aligned map).
PD_API int pd_msda_taps(const void* v, const void* x, const void* y, const void* attw,
                        void* out, int bm, int n, int h, int w, int d, int vec,
                        int group_lanes, void* stream) {
  if (d < 1 || d > 128 || !msda::layout_ok(d, vec, group_lanes) ||
      (vec == 4 && reinterpret_cast<uintptr_t>(v) % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = static_cast<long long>(bm) * ((n + 31) / 32);
  if (warps > 0xffffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((warps + kThreads / 32 - 1) / (kThreads / 32));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* vp = static_cast<const bf16*>(v);
  const float* xp = static_cast<const float*>(x);
  const float* yp = static_cast<const float*>(y);
  const float* ap = static_cast<const float*>(attw);
  bf16* op = static_cast<bf16*>(out);
  if (vec == 4) {
    msda_taps_kernel<4, 1><<<grid, kThreads, 0, st>>>(vp, xp, yp, ap, op, bm, n, h, w, d,
                                                      group_lanes);
  } else {
    msda_taps_kernel<1, 4><<<grid, kThreads, 0, st>>>(vp, xp, yp, ap, op, bm, n, h, w, d,
                                                      group_lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
