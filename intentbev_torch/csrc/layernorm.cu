// Row LayerNorm for inference: bf16 in, f32 statistics, bf16 out.
//
// Replaces: intentbev/ops/layernorm.py::_fwd_infer_kernel (the standalone
// LN of block 0's norm1 and of the two adapters on the serving path).
// Bound on the H100: device memory. Each row is read once and written once
// (768 + 768 bytes at D = 384), so the floor is bytes / 3.35 TB/s.
// Design: one warp per row, 12 values per lane held in registers, 32-bit
// (bf16x2) loads and stores; the row never touches shared memory. Eight
// rows per 256-thread block keep enough warps in flight to cover the load
// latency.
#include "common.cuh"

namespace {

constexpr int D = 384;
constexpr int ROWS_PER_BLOCK = 8;

__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
    layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, bf16* __restrict__ y,
                     int n_rows, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const bf16* xr = x + (size_t)row * D;
  float v[12];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const __nv_bfloat162 p =
        *reinterpret_cast<const __nv_bfloat162*>(xr + 2 * lane + 64 * i);
    v[2 * i] = __bfloat162float(p.x);
    v[2 * i + 1] = __bfloat162float(p.y);
  }
  float mean, inv;
  warp_ln_stats(v, eps, mean, inv);
  bf16* yr = y + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int c = 2 * lane + 64 * i;
    const float a = (v[2 * i] - mean) * inv * gamma[c] + beta[c];
    const float b = (v[2 * i + 1] - mean) * inv * gamma[c + 1] + beta[c + 1];
    *reinterpret_cast<uint32_t*>(yr + c) = pack_bf16x2(a, b);
  }
}

}  // namespace

extern "C" const char* ibk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int ibk_layernorm(const void* x, const void* gamma, const void* beta,
                             void* y, int n_rows, float eps, void* stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    layernorm_kernel<<<blocks, 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)gamma, (const float*)beta, (bf16*)y,
        n_rows, eps);
  }
  return (int)cudaGetLastError();
}
