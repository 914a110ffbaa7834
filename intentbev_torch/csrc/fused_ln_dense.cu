// Fused LayerNorm + dense: y = [GELU](LN(x) * gamma + beta) W^T + b).
// Replaces intentbev/ops/fused_ln_dense.py::_fwd_kernel: the qkv projection
// with norm1 folded in (x [36008, 384] -> [36008, 1152]) and the stream
// adapters LN -> Linear -> GELU ([36000, 384] -> [36000, 192]).
//
// Bound on the H100: device memory. The qkv call moves 111.5 MB (x in, qkv
// out, W) for 31.9 GFLOP: 0.0333 ms at 3.35 TB/s against 0.032 ms of bf16
// tensor-core time; the adapter call moves 41.5 MB for 5.3 GFLOP.
// Design: one 256-thread block owns 64 whole rows. It normalises them into
// shared memory (f32 statistics, two passes as the JAX kernel, xn rounded
// to bf16 as the JAX kernel feeds the MXU), then walks the output columns in
// 64-wide tiles: stage the W tile ([64, 384] of PyTorch's [out, in]
// layout, already K-contiguous) in shared memory, y = xn W^T (mma.sync
// m16n8k16 bf16, f32 accumulate; each warp a 16 x 32 piece), add the f32
// bias, apply the optional GELU in f32 and round once to bf16. x is read
// once and y written once; W (0.9 MB for qkv) comes from L2 once a block.
#include "common.cuh"

namespace {

constexpr int D = 384;
constexpr int ROWS = 64;
constexpr int NT = 64;      // output columns per tile
constexpr int LDX = D + 8;  // padded row stride (conflict-free fragments)
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES = (size_t)(ROWS + NT) * LDX * 2;

// ACT: -1 none, 0 exact erf GELU, 1 x * sigmoid(1.702 x)
template <int ACT>
__global__ void __launch_bounds__(THREADS)
    fused_ln_dense_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const bf16* __restrict__ w,
                          const float* __restrict__ bias, bf16* __restrict__ y,
                          int n_rows, int dout, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [ROWS][LDX]
  bf16* ws = xs + ROWS * LDX;                // [NT][LDX]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * ROWS;

  // 1. xn = LN(x) -> shared memory (bf16); warp w owns rows 8w..8w+7
  for (int rr = 0; rr < ROWS / 8; ++rr) {
    const int r = warp * (ROWS / 8) + rr;
    const int grow = row0 + r;
    float v[12];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float a = 0.f, b = 0.f;
      if (grow < n_rows) {
        const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(
            x + (size_t)grow * D + 2 * lane + 64 * i);
        a = __bfloat162float(p.x);
        b = __bfloat162float(p.y);
      }
      v[2 * i] = a;
      v[2 * i + 1] = b;
    }
    float mean, inv;
    warp_ln_stats(v, eps, mean, inv);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int c = 2 * lane + 64 * i;
      *reinterpret_cast<uint32_t*>(xs + r * LDX + c) =
          pack_bf16x2((v[2 * i] - mean) * inv * gamma[c] + beta[c],
                      (v[2 * i + 1] - mean) * inv * gamma[c + 1] + beta[c + 1]);
    }
  }

  // 2. per 64-column tile: y = xn W^T + b [GELU]; warp: rows wr..wr+15,
  //    tile columns wc..wc+31
  const int wr = (warp & 3) * 16;
  const int wc = (warp >> 2) * 32;
  for (int n0 = 0; n0 < dout; n0 += NT) {
    __syncthreads();  // xs written (first tile) / previous W tile consumed
    for (int i = tid; i < NT * D / 8; i += THREADS) {
      const int n = i / (D / 8), c8 = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + n * LDX + c8) =
          *reinterpret_cast<const uint4*>(w + (size_t)(n0 + n) * D + c8);
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4];
      load_a(a, xs, LDX, wr, k0, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t b[2];
        load_b(b, ws, LDX, wc + n * 8, k0, lane);
        mma_16816(acc[n], a, b);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n0 + wc + n * 8 + 2 * t4;
      const float bb0 = bias[c], bb1 = bias[c + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int grow = row0 + wr + g + 8 * half;
        if (grow >= n_rows) continue;
        float v0 = acc[n][2 * half] + bb0, v1 = acc[n][2 * half + 1] + bb1;
        if constexpr (ACT >= 0) {
          v0 = gelu<ACT>(v0);
          v1 = gelu<ACT>(v1);
        }
        *reinterpret_cast<uint32_t*>(y + (size_t)grow * dout + c) = pack_bf16x2(v0, v1);
      }
    }
  }
}

template <int ACT>
int launch(const void* x, const void* gamma, const void* beta, const void* w,
           const void* bias, void* y, int n_rows, int dout, float eps, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(fused_ln_dense_kernel<ACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  fused_ln_dense_kernel<ACT><<<(n_rows + ROWS - 1) / ROWS, THREADS, SMEM_BYTES, s>>>(
      (const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)w,
      (const float*)bias, (bf16*)y, n_rows, dout, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [n_rows, 384]; gamma, beta f32 [384]; w bf16 [dout, 384]; bias f32
// [dout]; y bf16 [n_rows, dout]; dout a multiple of 64. gelu_mode: -1 none,
// 0 exact erf GELU, 1 x * sigmoid(1.702 x).
extern "C" int ibk_fused_ln_dense(const void* x, const void* gamma, const void* beta,
                                  const void* w, const void* bias, void* y, int n_rows,
                                  int dout, float eps, int gelu_mode, void* stream) {
  if (dout <= 0 || dout % NT != 0) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (gelu_mode < 0) return launch<-1>(x, gamma, beta, w, bias, y, n_rows, dout, eps, s);
  if (gelu_mode == 0) return launch<0>(x, gamma, beta, w, bias, y, n_rows, dout, eps, s);
  return launch<1>(x, gamma, beta, w, bias, y, n_rows, dout, eps, s);
}
