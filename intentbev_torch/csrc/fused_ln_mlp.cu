// Fused transformer block tail with the serving LN epilogue:
//   xn = LN2(x);  y = x + (GELU(xn W1 + b1) W2 + b2);  yn = LN_next(y)
//
// Replaces: intentbev/ops/fused_ln_mlp.py::_fwd_ln_out_kernel (+ _mlp_body),
// the one kernel per encoder block of the serving LN chain.
// Bound on the H100: tensor-core throughput. At 36008 x 384 rows and a
// 1536-wide hidden layer a call is 4*N*384*1536 = 85 GFLOP against 83 MB of
// activations in and out; W1 + W2 (2.36 MB bf16) sit in L2.
// Design: one 256-thread block owns 64 whole rows, so both LayerNorms are
// block-local and the [64, 1536] hidden activation never leaves the SM. The
// block normalises its rows into shared memory (bf16, as the JAX kernel
// feeds the MXU), then walks the hidden dimension in 64-wide tiles: stage
// the W1 and W2 tiles in shared memory, g = xn W1[:, tile] (mma.sync),
// bias + GELU in f32, h as bf16 in shared memory, acc += h W2[tile, :].
// The f32 accumulator [64, 384] lives in registers (96 per thread). The
// epilogue adds b2 and the residual in f32, writes y as bf16 and takes the
// next LayerNorm from the f32 y (not the bf16-rounded y), like the JAX
// kernel. The drop-path gate of the training kernel is 1 at inference and
// is left out.
#include "common.cuh"

namespace {

constexpr int D = 384;      // model width
constexpr int ROWS = 64;    // rows per block
constexpr int HT = 64;      // hidden tile
constexpr int LDX = D + 8;  // padded row strides (bank-conflict-free
constexpr int LDH = HT + 8; // 32-bit fragment loads)
constexpr int LDY = D + 8;
constexpr int THREADS = 256;

constexpr size_t XN_ELEMS = (size_t)ROWS * LDX;
constexpr size_t W1_ELEMS = (size_t)HT * LDX;
constexpr size_t W2_ELEMS = (size_t)D * LDH;
constexpr size_t H_ELEMS = (size_t)ROWS * LDH;
constexpr size_t SMEM_BYTES = (XN_ELEMS + W1_ELEMS + W2_ELEMS + H_ELEMS) * 2;
static_assert((size_t)ROWS * LDY * 4 <= (W1_ELEMS + W2_ELEMS) * 2,
              "f32 epilogue tile must fit in the weight staging area");

template <int GELU>
__device__ __forceinline__ float gelu(float v) {
  if (GELU == 0) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v / (1.f + expf(-1.702f * v));
}

template <int GELU>
__global__ void __launch_bounds__(THREADS)
    fused_ln_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ g2,
                        const float* __restrict__ be2, const bf16* __restrict__ w1,
                        const float* __restrict__ b1, const bf16* __restrict__ w2,
                        const float* __restrict__ b2, const float* __restrict__ gn,
                        const float* __restrict__ bn, bf16* __restrict__ y,
                        bf16* __restrict__ yn, int n_rows, int hidden, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1s = xs + XN_ELEMS;
  bf16* w2s = w1s + W1_ELEMS;
  bf16* hs = w2s + W2_ELEMS;
  float* ys = reinterpret_cast<float*>(w1s);  // epilogue alias

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * ROWS;

  // 1. xn = LN2(x) -> shared memory (bf16); warp w owns rows 8w..8w+7
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
          pack_bf16x2((v[2 * i] - mean) * inv * g2[c] + be2[c],
                      (v[2 * i + 1] - mean) * inv * g2[c + 1] + be2[c + 1]);
    }
  }

  // warp tiling: rows wr..wr+15; GEMM1 columns wc..wc+31 of the hidden
  // tile, GEMM2 output columns oc..oc+191
  const int wr = (warp & 3) * 16;
  const int wc = (warp >> 2) * 32;
  const int oc = (warp >> 2) * 192;
  float acc[24][4];
#pragma unroll
  for (int n = 0; n < 24; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int h0 = 0; h0 < hidden; h0 += HT) {
    __syncthreads();  // xs written (first pass) / previous tile consumed
    // W1 rows h0..h0+63 of [hidden][D]  -> w1s [n][k]
    for (int i = tid; i < HT * D / 8; i += THREADS) {
      const int n = i / (D / 8), c8 = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + n * LDX + c8) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)(h0 + n) * D + c8);
    }
    // W2 columns h0..h0+63 of [D][hidden] -> w2s [n][k]
    for (int i = tid; i < D * HT / 8; i += THREADS) {
      const int n = i / (HT / 8), c8 = (i % (HT / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + n * LDH + c8) =
          *reinterpret_cast<const uint4*>(w2 + (size_t)n * hidden + h0 + c8);
    }
    __syncthreads();

    float gacc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[n][e] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4];
      load_a(a, xs, LDX, wr, k0, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t b[2];
        load_b(b, w1s, LDX, wc + n * 8, k0, lane);
        mma_16816(gacc[n], a, b);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = wc + n * 8 + 2 * t4;
      const float bb0 = b1[h0 + c], bb1 = b1[h0 + c + 1];
      *reinterpret_cast<uint32_t*>(hs + (wr + g) * LDH + c) =
          pack_bf16x2(gelu<GELU>(gacc[n][0] + bb0), gelu<GELU>(gacc[n][1] + bb1));
      *reinterpret_cast<uint32_t*>(hs + (wr + g + 8) * LDH + c) =
          pack_bf16x2(gelu<GELU>(gacc[n][2] + bb0), gelu<GELU>(gacc[n][3] + bb1));
    }
    __syncthreads();

#pragma unroll
    for (int k0 = 0; k0 < HT; k0 += 16) {
      uint32_t a[4];
      load_a(a, hs, LDH, wr, k0, lane);
#pragma unroll
      for (int n = 0; n < 24; ++n) {
        uint32_t b[2];
        load_b(b, w2s, LDH, oc + n * 8, k0, lane);
        mma_16816(acc[n], a, b);
      }
    }
  }

  // 3. epilogue: f32 (acc + b2) -> shared, then per row y = . + x, LN_next
  __syncthreads();  // every warp is done reading w2s before ys aliases it
#pragma unroll
  for (int n = 0; n < 24; ++n) {
    const int c = oc + n * 8 + 2 * t4;
    const float bb0 = b2[c], bb1 = b2[c + 1];
    ys[(wr + g) * LDY + c] = acc[n][0] + bb0;
    ys[(wr + g) * LDY + c + 1] = acc[n][1] + bb1;
    ys[(wr + g + 8) * LDY + c] = acc[n][2] + bb0;
    ys[(wr + g + 8) * LDY + c + 1] = acc[n][3] + bb1;
  }
  __syncthreads();
  for (int rr = 0; rr < ROWS / 8; ++rr) {
    const int r = warp * (ROWS / 8) + rr;
    const int grow = row0 + r;
    if (grow >= n_rows) break;  // warp-uniform
    float v[12];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int c = 2 * lane + 64 * i;
      const __nv_bfloat162 p =
          *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)grow * D + c);
      v[2 * i] = ys[r * LDY + c] + __bfloat162float(p.x);
      v[2 * i + 1] = ys[r * LDY + c + 1] + __bfloat162float(p.y);
      *reinterpret_cast<uint32_t*>(y + (size_t)grow * D + c) =
          pack_bf16x2(v[2 * i], v[2 * i + 1]);
    }
    float mean, inv;
    warp_ln_stats(v, eps, mean, inv);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int c = 2 * lane + 64 * i;
      *reinterpret_cast<uint32_t*>(yn + (size_t)grow * D + c) =
          pack_bf16x2((v[2 * i] - mean) * inv * gn[c] + bn[c],
                      (v[2 * i + 1] - mean) * inv * gn[c + 1] + bn[c + 1]);
    }
  }
}

template <int GELU>
int launch(const void* x, const void* g2, const void* be2, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* gn,
           const void* bn, void* y, void* yn, int n_rows, int hidden, float eps,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_ln_mlp_kernel<GELU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  fused_ln_mlp_kernel<GELU><<<blocks, THREADS, SMEM_BYTES, stream>>>(
      (const bf16*)x, (const float*)g2, (const float*)be2, (const bf16*)w1,
      (const float*)b1, (const bf16*)w2, (const float*)b2, (const float*)gn,
      (const float*)bn, (bf16*)y, (bf16*)yn, n_rows, hidden, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// gelu_mode: 0 = exact erf GELU, 1 = x * sigmoid(1.702 x).
// hidden must be a multiple of 64.
extern "C" int ibk_fused_ln_mlp(const void* x, const void* g2, const void* be2,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* gn, const void* bn,
                                void* y, void* yn, int n_rows, int hidden,
                                float eps, int gelu_mode, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if (gelu_mode == 0)
    return launch<0>(x, g2, be2, w1, b1, w2, b2, gn, bn, y, yn, n_rows, hidden,
                     eps, (cudaStream_t)stream);
  return launch<1>(x, g2, be2, w1, b1, w2, b2, gn, bn, y, yn, n_rows, hidden,
                   eps, (cudaStream_t)stream);
}
