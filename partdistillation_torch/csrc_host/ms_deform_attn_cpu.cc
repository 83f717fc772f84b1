// Multi-scale deformable attention forward on the host CPU, plain C ABI.
//
// The port's own copy of the repository's C++ CPU MSDeformAttn
// (native/ms_deform_attn_cpu.cc), with a C entry point bound by ctypes
// (partdistillation_torch/ops/native.py) in place of an XLA custom call.
// It is an implementation independent of the port's PyTorch sampling
// (ops/msda_sampling.py), used to cross-check it and for host-side
// inference; OpenMP spreads the (batch, query) pairs over the cores.
//
// Semantics (as ops/ms_deform_attn.ms_deform_attn):
//   value   (B, S, M, D) f32, S = sum_l H_l*W_l, level-major flattening
//   shapes  (L, 2) int32 — (H_l, W_l)
//   loc     (B, Q, M, L, P, 2) f32 normalised [0,1], (x, y)
//   weight  (B, Q, M, L, P) f32
//   out     (B, Q, M*D) f32
// Pixel mapping: x_pix = x*W - 0.5 (align_corners=False); out-of-range
// bilinear corners contribute zero. All arrays C-contiguous.
//
// Build (native_lib.build_host_library, with rle_codec.cc):
//   g++ -O3 -fopenmp -shared -fPIC -std=c++17 *.cc -o libpd_host_<hash>.so

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Returns 0, or -1 when the levels' sizes do not sum to S.
int pd_ms_deform_attn_cpu(const float* v, const int32_t* sh, const float* lp,
                          const float* wp, int64_t B, int64_t S, int64_t M,
                          int64_t D, int64_t Q, int64_t L, int64_t P, float* op) {
  std::vector<int64_t> level_start(L + 1, 0);
  for (int64_t l = 0; l < L; ++l) {
    level_start[l + 1] = level_start[l] + (int64_t)sh[2 * l] * sh[2 * l + 1];
  }
  if (level_start[L] != S) return -1;

#pragma omp parallel for collapse(2)
  for (int64_t b = 0; b < B; ++b) {
    for (int64_t q = 0; q < Q; ++q) {
      for (int64_t m = 0; m < M; ++m) {
        float* acc = op + ((b * Q + q) * M + m) * D;
        for (int64_t d = 0; d < D; ++d) acc[d] = 0.f;
        for (int64_t l = 0; l < L; ++l) {
          const int64_t H = sh[2 * l], W = sh[2 * l + 1];
          const float* vbase = v + ((b * S + level_start[l]) * M + m) * D;
          const int64_t row_stride = W * M * D;  // value is (B,S,M,D); S is level-major
          for (int64_t p = 0; p < P; ++p) {
            const int64_t li = ((((b * Q + q) * M + m) * L + l) * P + p);
            const float x = lp[li * 2 + 0] * (float)W - 0.5f;
            const float y = lp[li * 2 + 1] * (float)H - 0.5f;
            const float wgt = wp[li];
            if (wgt == 0.f) continue;
            const int64_t x0 = (int64_t)std::floor(x), y0 = (int64_t)std::floor(y);
            const float fx = x - (float)x0, fy = y - (float)y0;
            const float cw[4] = {(1 - fy) * (1 - fx), (1 - fy) * fx,
                                 fy * (1 - fx), fy * fx};
            const int64_t ys[4] = {y0, y0, y0 + 1, y0 + 1};
            const int64_t xs[4] = {x0, x0 + 1, x0, x0 + 1};
            for (int t = 0; t < 4; ++t) {
              if (ys[t] < 0 || ys[t] >= H || xs[t] < 0 || xs[t] >= W) continue;
              const float* src = vbase + ys[t] * row_stride + xs[t] * M * D;
              const float c = wgt * cw[t];
              for (int64_t d = 0; d < D; ++d) acc[d] += c * src[d];
            }
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
