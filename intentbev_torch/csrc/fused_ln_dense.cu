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
//
// The training backward (below) replaces ::_bwd_kernel.
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

// ---------------------------------------------------------------------------
// Training backward. Replaces intentbev/ops/fused_ln_dense.py::_bwd_kernel:
//      recompute xhat, inv, xn = LN(x);  with GELU g = xn W^T + b and
//      dg = dy * GELU'(g), else dg = dy
//      dW = dg^T xn;  db = sum dg;  dxn = dg W
//      dgamma = sum dxn * xhat;  dbeta = sum dxn
//      dx = inv * (dxn*gamma - mean(dxn*gamma) - xhat * mean(dxn*gamma*xhat))
// with the JAX kernel's rounding points: xn and dg are rounded to bf16
// before they enter a product; products and column sums are f32.
// Bound on the H100 (batch 8): the qkv call (x [36008, 384], dy [36008,
// 1152], no GELU) does 2 products, 63.7 GFLOP, 0.064 ms at 989 TFLOP/s,
// against 141 MB of x, dy, dx and dW (0.042 ms); the adapter call (dy
// [36000, 192], erf GELU) does 3 products, 15.9 GFLOP (0.016 ms) against
// 69 MB (0.021 ms): bytes.
// Design: as the LN+MLP backward (fused_ln_mlp.cu), since 132 SMs cannot
// carry dW across a sequential row grid as the TPU kernel does:
//  (a) a row kernel, one 256-thread block per 64 rows: LN recompute into
//      shared memory (xn also written out as bf16 for dW), then per 64-wide
//      tile of the Dout columns: stage the W tile ([64, 384] of PyTorch's
//      [out, in] layout) and the dy tile, with GELU recompute g (mma.sync)
//      and dg in f32 (dg written out as bf16 for dW), per-block column sums
//      of dg, and dxn += dg W_tile in registers ([64, 384] f32, 96 a
//      thread). The epilogue finishes dx row by row and writes per-block
//      column partials of dgamma and dbeta. 111 KB of shared memory: two
//      blocks an SM;
//  (b) the split-K GEMM of common.cuh, dW = dg^T xn (dg is dy itself
//      without GELU), every sum in a fixed order (deterministic).
// ---------------------------------------------------------------------------
namespace {

constexpr int LDT = NT + 8;  // dy / dg tile row stride
constexpr size_t BX_ELEMS = (size_t)ROWS * LDX;  // xn
constexpr size_t BW_ELEMS = (size_t)NT * LDX;    // W tile
constexpr size_t BDG_ELEMS = (size_t)ROWS * LDT; // dy, then dg, tile
constexpr size_t BWD_SMEM_BYTES =
    (BX_ELEMS + BW_ELEMS + BDG_ELEMS) * 2 + (4 * NT + 2 * ROWS) * 4;
static_assert((size_t)ROWS * LDX * 4 <= (BX_ELEMS + BW_ELEMS) * 2,
              "f32 dxn tile must fit in the xn and W areas");
static_assert((size_t)2 * 8 * D * 4 <= (BX_ELEMS + BW_ELEMS) * 2,
              "column partials must fit in the xn and W areas");

template <bool GELU>
__global__ void __launch_bounds__(THREADS)
    ln_dense_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                             const float* __restrict__ beta, const bf16* __restrict__ w,
                             const float* __restrict__ bias, const bf16* __restrict__ dy,
                             bf16* __restrict__ dx, bf16* __restrict__ xn_out,
                             bf16* __restrict__ dg_out, float* __restrict__ part_db,
                             float* __restrict__ part_cols, int n_rows, int dout,
                             float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [ROWS][LDX]
  bf16* ws = xs + BX_ELEMS;                  // [NT][LDX]
  bf16* dgs = ws + BW_ELEMS;                 // [ROWS][LDT]
  float* red = reinterpret_cast<float*>(dgs + BDG_ELEMS);  // [4][NT]
  float* rmean = red + 4 * NT;
  float* rinv = rmean + ROWS;
  float* ys = reinterpret_cast<float*>(smem);    // epilogue: f32 dxn [ROWS][LDX]
  float* cols = reinterpret_cast<float*>(smem);  // then [2][8][D]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * ROWS;

  // 1. xn = LN(x) -> shared memory and device memory (bf16), row stats
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
    if (lane == 0) {
      rmean[r] = mean;
      rinv[r] = inv;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int c = 2 * lane + 64 * i;
      const uint32_t xn2 = pack_bf16x2((v[2 * i] - mean) * inv * gamma[c] + beta[c],
                                       (v[2 * i + 1] - mean) * inv * gamma[c + 1] + beta[c + 1]);
      *reinterpret_cast<uint32_t*>(xs + r * LDX + c) = xn2;
      if (grow < n_rows) *reinterpret_cast<uint32_t*>(xn_out + (size_t)grow * D + c) = xn2;
    }
  }

  // warp tiling: rows wr..wr+15; tile columns wc..wc+31 for g; dxn output
  // columns oc..oc+191
  const int wr = (warp & 3) * 16;
  const int wc = (warp >> 2) * 32;
  const int oc = (warp >> 2) * 192;
  float acc[24][4];
#pragma unroll
  for (int n = 0; n < 24; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int n0 = 0; n0 < dout; n0 += NT) {
    __syncthreads();  // xs written (first tile) / previous W and dg tiles consumed
    // W rows n0..n0+63 of [dout][D] -> ws [n][d]
    for (int i = tid; i < NT * D / 8; i += THREADS) {
      const int n = i / (D / 8), c8 = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + n * LDX + c8) =
          *reinterpret_cast<const uint4*>(w + (size_t)(n0 + n) * D + c8);
    }
    // dy rows row0.., columns n0..n0+63 -> dgs [r][n] (0 past the last row)
    for (int i = tid; i < ROWS * NT / 8; i += THREADS) {
      const int r = i / (NT / 8), c8 = (i % (NT / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < n_rows)
        val = *reinterpret_cast<const uint4*>(dy + (size_t)(row0 + r) * dout + n0 + c8);
      *reinterpret_cast<uint4*>(dgs + r * LDT + c8) = val;
    }
    __syncthreads();

    if constexpr (GELU) {
      // g = xn W_tile^T + b; dg = dy * GELU'(g) over this thread's fragment,
      // in place of its dy in dgs; db column sums
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
          load_b(b, ws, LDX, wc + n * 8, k0, lane);
          mma_16816(gacc[n], a, b);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = wc + n * 8 + 2 * t4;
        const float bb0 = bias[n0 + c], bb1 = bias[n0 + c + 1];
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wr + g + 8 * half;
          const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(dgs + r * LDT + c);
          const float da = __bfloat162float(q.x) * dgelu_erf(gacc[n][2 * half] + bb0);
          const float db = __bfloat162float(q.y) * dgelu_erf(gacc[n][2 * half + 1] + bb1);
          s0 += da;
          s1 += db;
          const uint32_t dg2 = pack_bf16x2(da, db);
          *reinterpret_cast<uint32_t*>(dgs + r * LDT + c) = dg2;
          if (row0 + r < n_rows)
            *reinterpret_cast<uint32_t*>(dg_out + (size_t)(row0 + r) * dout + n0 + c) = dg2;
        }
#pragma unroll
        for (int o_ = 4; o_ <= 16; o_ <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o_);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o_);
        }
        if (g == 0) {
          red[(warp & 3) * NT + c] = s0;
          red[(warp & 3) * NT + c + 1] = s1;
        }
      }
      __syncthreads();  // dg tile and red complete
      if (tid < NT)
        part_db[(size_t)blockIdx.x * dout + n0 + tid] =
            red[tid] + red[NT + tid] + red[2 * NT + tid] + red[3 * NT + tid];
    } else {
      // dg = dy: db column sums straight from the staged tile
      if (tid < NT) {
        float s = 0.f;
        for (int r = 0; r < ROWS; ++r) s += __bfloat162float(dgs[r * LDT + tid]);
        part_db[(size_t)blockIdx.x * dout + n0 + tid] = s;
      }
    }

    // dxn += dg W_tile (W tile read as [k=out][n=d])
#pragma unroll
    for (int k0 = 0; k0 < NT; k0 += 16) {
      uint32_t a[4];
      load_a(a, dgs, LDT, wr, k0, lane);
#pragma unroll
      for (int n = 0; n < 24; ++n) {
        uint32_t b[2];
        load_b_kn(b, ws, LDX, oc + n * 8, k0, lane);
        mma_16816(acc[n], a, b);
      }
    }
  }

  // 2. epilogue: dxn -> shared (f32), then per row the LN backward
  __syncthreads();  // every warp is done with xs and ws before the alias
#pragma unroll
  for (int n = 0; n < 24; ++n) {
    const int c = oc + n * 8 + 2 * t4;
    ys[(wr + g) * LDX + c] = acc[n][0];
    ys[(wr + g) * LDX + c + 1] = acc[n][1];
    ys[(wr + g + 8) * LDX + c] = acc[n][2];
    ys[(wr + g + 8) * LDX + c + 1] = acc[n][3];
  }
  __syncthreads();
  float cg[12], cb[12];  // column sums: dgamma, dbeta
#pragma unroll
  for (int i = 0; i < 12; ++i) cg[i] = cb[i] = 0.f;
  for (int rr = 0; rr < ROWS / 8; ++rr) {
    const int r = warp * (ROWS / 8) + rr;
    const int grow = row0 + r;
    if (grow >= n_rows) break;  // warp-uniform
    const float mean = rmean[r], inv = rinv[r];
    float xh[12], dxn[12];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int c = 2 * lane + 64 * i;
      const __nv_bfloat162 p =
          *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)grow * D + c);
      xh[2 * i] = (__bfloat162float(p.x) - mean) * inv;
      xh[2 * i + 1] = (__bfloat162float(p.y) - mean) * inv;
      dxn[2 * i] = ys[r * LDX + c];
      dxn[2 * i + 1] = ys[r * LDX + c + 1];
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const int c = 2 * lane + 64 * (i >> 1) + (i & 1);
      cg[i] += dxn[i] * xh[i];
      cb[i] += dxn[i];
      dxn[i] *= gamma[c];  // dyg
      s1 += dxn[i];
      s2 += dxn[i] * xh[i];
    }
    const float m1 = warp_sum(s1) * (1.f / D), m2 = warp_sum(s2) * (1.f / D);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int c = 2 * lane + 64 * i;
      *reinterpret_cast<uint32_t*>(dx + (size_t)grow * D + c) =
          pack_bf16x2(inv * (dxn[2 * i] - m1 - xh[2 * i] * m2),
                      inv * (dxn[2 * i + 1] - m1 - xh[2 * i + 1] * m2));
    }
  }
  __syncthreads();  // every warp is done reading ys before cols alias it
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int c = 2 * lane + 64 * (i >> 1) + (i & 1);
    cols[(0 * 8 + warp) * D + c] = cg[i];
    cols[(1 * 8 + warp) * D + c] = cb[i];
  }
  __syncthreads();
  const int nb = gridDim.x;
  for (int i = tid; i < 2 * D; i += THREADS) {
    const int which = i / D, c = i % D;
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < 8; ++w8) s += cols[(which * 8 + w8) * D + c];
    part_cols[((size_t)which * nb + blockIdx.x) * D + c] = s;
  }
}

template <bool GELU>
int ln_dense_bwd(const void* x, const void* gamma, const void* beta, const void* w,
                 const void* bias, const void* dy, void* dx, void* dgamma, void* dbeta,
                 void* dw, void* dbias, void* xn_ws, void* dg_ws, void* part, int n_rows,
                 int dout, float eps, int splits, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(ln_dense_bwd_rows_kernel<GELU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)BWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int nb = (n_rows + ROWS - 1) / ROWS;
  float* p_db = (float*)part;
  float* p_cols = p_db + (size_t)nb * dout;  // [2][nb][D]
  ln_dense_bwd_rows_kernel<GELU><<<nb, THREADS, BWD_SMEM_BYTES, s>>>(
      (const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)w,
      (const float*)bias, (const bf16*)dy, (bf16*)dx, (bf16*)xn_ws, (bf16*)dg_ws, p_db,
      p_cols, n_rows, dout, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials(p_db, nb, dout, (float*)dbias, s);
  sum_partials(p_cols, nb, D, (float*)dgamma, s);
  sum_partials(p_cols + (size_t)nb * D, nb, D, (float*)dbeta, s);
  return gemm_at_b((const bf16*)(GELU ? dg_ws : dy), (const bf16*)xn_ws, (float*)part,
                   (float*)dw, n_rows, dout, D, splits, s);
}

}  // namespace

// Backward of ibk_fused_ln_dense (gelu_mode -1 none, 0 exact erf GELU).
// Outputs: dx bf16 [n_rows, 384]; dgamma, dbeta f32 [384]; dw f32 [dout,
// 384]; dbias f32 [dout]. Workspaces: xn_ws bf16 [n_rows, 384]; dg_ws bf16
// [n_rows, dout] (GELU only); part f32 of max(splits * dout * 384,
// ceil(n_rows / 64) * (dout + 2 * 384)).
extern "C" int ibk_fused_ln_dense_bwd(const void* x, const void* gamma, const void* beta,
                                      const void* w, const void* bias, const void* dy,
                                      void* dx, void* dgamma, void* dbeta, void* dw,
                                      void* dbias, void* xn_ws, void* dg_ws, void* part,
                                      int n_rows, int dout, float eps, int gelu_mode,
                                      int splits, void* stream) {
  if (dout <= 0 || dout % NT != 0 || gelu_mode > 0) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (gelu_mode < 0)
    return ln_dense_bwd<false>(x, gamma, beta, w, bias, dy, dx, dgamma, dbeta, dw, dbias,
                               xn_ws, dg_ws, part, n_rows, dout, eps, splits, s);
  return ln_dense_bwd<true>(x, gamma, beta, w, bias, dy, dx, dgamma, dbeta, dw, dbias, xn_ws,
                            dg_ws, part, n_rows, dout, eps, splits, s);
}
