// Row LayerNorm over the last axis: two-pass f32 statistics (the mean, then
// the mean of centred squares), f32 affine, output in the input dtype (bf16
// or f32).
//
// Replaces: the JAX package's ops/layer_norm.py `_ln_kernel` (launched by
// `_ln_forward` / `fused_layer_norm`).
// Bound on the H100: bytes. Each element is read once and written once with a
// handful of flops, far below the ~295 flop/byte ridge of the card.
// Design: each row is read once, into registers, with 16-byte loads (8 bf16
// or 4 f32 a lane), and written once with 16-byte stores; scale and bias
// come as 16-byte vectors. A row gets L lanes (a power of two up to 32) that
// each hold K 16-byte chunks, lane j chunks j, j + L, ..., so a warp load
// covers 32 consecutive chunks; both statistics come from the registers,
// summed over the row's L lanes by xor shuffles. Several rows share a warp
// where a row is narrow (L = 8 at C = 192, 16 at C = 384), and L and K are
// chosen so that each lane keeps about three loads in flight
// (ops/layer_norm.py `layer_norm_plan`, which the launch takes). Blocks are
// 128 threads: at (3200, 1536), 72 registers a thread, 256-thread blocks
// left four of 400 blocks for a second wave, 128-thread ones fit in one
// (8.5 -> 6.5 us on an H100, tools/torch_kernel_breakdown.py). Rows whose
// width is not a multiple of 8 (bf16) or 4 (f32), or whose base is not
// 16-byte aligned, take the scalar variant: one warp per row, strided 2- or
// 4-byte loads, the row read three times (the second and third reads hit
// L1).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// 16 bytes as f32: 8 bf16 or 4 f32
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// sum over the `lanes` lanes (a power of two) that share a row
__device__ __forceinline__ float row_sum(float v, int lanes) {
  for (int o = lanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The vector variant: `lanes` lanes per row, K 16-byte chunks per lane.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
ln_rows_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out, int rows, int cols,
                   int lanes, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = cols / V;
  const int li = threadIdx.x & (lanes - 1);
  const int row = (blockIdx.x * kThreads + threadIdx.x) / lanes;
  const bool live = row < rows;  // dead lanes still take part in the shuffles
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(live ? row : 0) * cols);

  float v[K][V];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int ch = li + j * lanes;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (live && ch < chunks) u = xr[ch];
    unpack16(u, v[j]);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int e = 0; e < V; ++e) s += v[j][e];
  }
  const float mean = row_sum(s, lanes) / cols;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (li + j * lanes < chunks) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v[j][e] - mean;
        ss += d * d;
      }
    }
  }
  const float inv = rsqrtf(row_sum(ss, lanes) / cols + eps);
  if (!live) return;

  uint4* yr = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * cols);
  const float4* sc4 = reinterpret_cast<const float4*>(scale);
  const float4* bi4 = reinterpret_cast<const float4*>(bias);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int ch = li + j * lanes;
    if (ch < chunks) {
      float y[V];
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 g = sc4[ch * (V / 4) + q];
        const float4 b = bi4[ch * (V / 4) + q];
        y[4 * q] = (v[j][4 * q] - mean) * inv * g.x + b.x;
        y[4 * q + 1] = (v[j][4 * q + 1] - mean) * inv * g.y + b.y;
        y[4 * q + 2] = (v[j][4 * q + 2] - mean) * inv * g.z + b.z;
        y[4 * q + 3] = (v[j][4 * q + 3] - mean) * inv * g.w + b.w;
      }
      yr[ch] = pack16(y);
    }
  }
}

// The scalar variant: one warp per row, four rows per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, int rows,
               int cols, float eps) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * cols;
  T* yr = out + static_cast<size_t>(row) * cols;

  float s = 0.f;
  for (int c = lane; c < cols; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / cols;
  float ss = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    ss += d * d;
  }
  const float inv = rsqrtf(warp_sum(ss) / cols + eps);
  for (int c = lane; c < cols; c += 32) {
    const float y = (to_f32(xr[c]) - mean) * inv;
    yr[c] = from_f32<T>(y * scale[c] + bias[c]);
  }
}

template <typename T, int K>
cudaError_t launch_vec(const void* x, const void* scale, const void* bias, void* out, int rows,
                       int cols, int lanes, float eps, cudaStream_t s) {
  const int rows_per_block = kThreads / lanes;
  ln_rows_vec_kernel<T, K><<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), rows, cols, lanes, eps);
  return cudaGetLastError();
}

// K is one of the instantiated chunk counts: 1, 2, 3, 4, 6, 8, 12 (bf16 and
// f32) and 16, 24 (f32), at most 96 f32 values of a row in a lane's registers.
template <typename T>
cudaError_t dispatch_vec(const void* x, const void* scale, const void* bias, void* out,
                         int rows, int cols, int lanes, int loads, float eps, cudaStream_t s) {
  switch (loads) {
    case 1: return launch_vec<T, 1>(x, scale, bias, out, rows, cols, lanes, eps, s);
    case 2: return launch_vec<T, 2>(x, scale, bias, out, rows, cols, lanes, eps, s);
    case 3: return launch_vec<T, 3>(x, scale, bias, out, rows, cols, lanes, eps, s);
    case 4: return launch_vec<T, 4>(x, scale, bias, out, rows, cols, lanes, eps, s);
    case 6: return launch_vec<T, 6>(x, scale, bias, out, rows, cols, lanes, eps, s);
    case 8: return launch_vec<T, 8>(x, scale, bias, out, rows, cols, lanes, eps, s);
    case 12: return launch_vec<T, 12>(x, scale, bias, out, rows, cols, lanes, eps, s);
    default: break;
  }
  if constexpr (sizeof(T) == 4) {
    if (loads == 16) return launch_vec<T, 16>(x, scale, bias, out, rows, cols, lanes, eps, s);
    if (loads == 24) return launch_vec<T, 24>(x, scale, bias, out, rows, cols, lanes, eps, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out (rows, cols) bf16 or f32; scale, bias (cols,) f32. `loads` > 0: the
// vector variant with `lanes` lanes per row (a power of two up to 32) and
// `loads` 16-byte chunks per lane, which needs cols a multiple of 8 (bf16) or
// 4 (f32), lanes x loads chunks covering the row and every pointer 16-byte
// aligned; `loads` == 0: the scalar variant.
PD_API int pd_layer_norm(const void* x, const void* scale, const void* bias,
                         void* out, int rows, int cols, float eps, int is_bf16,
                         int lanes, int loads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (loads > 0) {
    const int v = is_bf16 ? 8 : 4;
    if (lanes <= 0 || lanes > 32 || (lanes & (lanes - 1)) != 0 || cols % v != 0 ||
        static_cast<long long>(lanes) * loads * v < cols) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(
        is_bf16 ? dispatch_vec<bf16>(x, scale, bias, out, rows, cols, lanes, loads, eps, s)
                : dispatch_vec<float>(x, scale, bias, out, rows, cols, lanes, loads, eps, s));
  }
  const int warps = kThreads / 32;
  const dim3 grid((rows + warps - 1) / warps);
  if (is_bf16) {
    ln_rows_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<bf16*>(out), rows, cols, eps);
  } else {
    ln_rows_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(out), rows, cols, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
