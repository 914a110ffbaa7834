// Shared device helpers for the port's hand-written kernels: the bf16 pack,
// the block MLPs' GELUs, warp sums and the two-pass LayerNorm statistics of
// a row spread over a warp, the fixed-order column sums of block partials
// (col_sums_kernel), and the dispatch over the model widths. The Hopper
// pieces (TMA, mbarriers, wgmma) are in hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// GELU of the block MLPs: 0 = exact erf, 1 = x * sigmoid(1.702 x) (the
// serving variant).
template <int GELU>
__device__ __forceinline__ float gelu(float v) {
  if (GELU == 0) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v / (1.f + expf(-1.702f * v));
}

// d/dv of the exact erf GELU (the backward kernels; training takes only it).
__device__ __forceinline__ float dgelu_erf(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * 0.3989422804014327f * expf(-0.5f * v * v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row LayerNorm of D = 32 * N f32 values spread as N per lane of one warp
// (lane holds columns 2*lane + 64*i + {0, 1}, i < N / 2; N = 12 at D = 384,
// 6 at D = 192): two-pass f32 statistics, as the JAX kernels compute them
// (mean, then mean of the squared deviations).
template <int N>
__device__ __forceinline__ void warp_ln_stats(const float (&v)[N], float eps,
                                              float& mean, float& inv) {
  constexpr float inv_d = 1.f / (32 * N);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s += v[i];
  mean = warp_sum(s) * inv_d;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float c = v[i] - mean;
    q += c * c;
  }
  inv = rsqrtf(warp_sum(q) * inv_d + eps);
}

namespace {

// Column sums of block partials, up to four (part [parts][width] -> out
// [width]; a null out is skipped), blockIdx.y the one: 32 columns a block,
// its eight warps take every eighth part in order and their sums are added
// in warp order (deterministic). parts = 0 writes zeros.
struct ColSums {
  const float* part[4];
  float* out[4];
  int width[4];
  int parts[4];
};

__global__ void __launch_bounds__(256) col_sums_kernel(ColSums a) {
  __shared__ float s[8][32];
  const int y = blockIdx.y, lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int width = a.width[y], c = blockIdx.x * 32 + lane;
  if (a.out[y] == nullptr || blockIdx.x * 32 >= width) return;  // the whole block
  float v = 0.f;
  if (c < width)
    for (int p = w; p < a.parts[y]; p += 8) v += a.part[y][(size_t)p * width + c];
  s[w][lane] = v;
  __syncthreads();
  if (w == 0 && c < width) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += s[i][lane];
    a.out[y][c] = t;
  }
}

}  // namespace

// Model widths the row kernels are instantiated for (ViT-S 384, ViT-Ti 192):
// calls launch(std::integral_constant<int, D>{}) for d == D, and refuses any
// other width.
template <typename F>
static inline int by_width(int d, F&& launch) {
  if (d == 384) return launch(std::integral_constant<int, 384>{});
  if (d == 192) return launch(std::integral_constant<int, 192>{});
  return (int)cudaErrorInvalidValue;
}
