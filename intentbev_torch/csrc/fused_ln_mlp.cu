// Fused transformer block tail, four kernels:
//
// 1. Serving, with the LN epilogue of the serving LN chain:
//      xn = LN2(x);  y = x + (GELU(xn W1 + b1) W2 + b2);  yn = LN_next(y)
//    Replaces intentbev/ops/fused_ln_mlp.py::_fwd_ln_out_kernel (+ _mlp_body).
// 2. Training forward, and the serving tail without the chain, with the
//    per-row drop-path gate (null: 1) and no epilogue:
//      y = x + gate * (GELU(xn W1 + b1) W2 + b2)
//    Replaces intentbev/ops/fused_ln_mlp.py::_fwd_kernel.
// 3. The MLP without LN, on an already normed input h, with a separate
//    residual (the use_fused_layernorm=False tail), serving (gate 1) and
//    training (the per-row drop-path gate):
//      y = res + gate * (GELU(h W1 + b1) W2 + b2)
//    Replaces intentbev/ops/fused_mlp.py::_fwd_kernel.
// 4. Training backward of 2 and of 3 (below), replacing
//    intentbev/ops/fused_ln_mlp.py::_bwd_kernel and
//    intentbev/ops/fused_mlp.py::_bwd_kernel.
//
// The model width D is a template parameter, instantiated at 384 (ViT-S)
// and 192 (ViT-Ti) for the LN kernels (1, 2, 4 with LN) and at 384 for the
// MLP without LN; the hidden width is any multiple of 64.
// Forward bound on the H100: tensor-core throughput. At 36008 x 384 rows and
// a 1536-wide hidden layer a call is 4*N*384*1536 = 85 GFLOP against 83 MB
// of activations in and out; W1 + W2 (2.36 MB bf16) sit in L2. At 192 and
// 768 it is a quarter of the operations (21 GFLOP) and half the bytes.
// Forward design: one 256-thread block owns 64 whole rows, so both
// LayerNorms are block-local and the [64, 1536] hidden activation never
// leaves the SM. The block normalises its rows into shared memory (bf16, as
// the JAX kernel feeds the MXU; kernel 3 copies h there as it is), then
// walks the hidden dimension in 64-wide tiles: stage the W1 and W2 tiles in
// shared memory, g = xn W1[:, tile] (mma.sync), bias + GELU in f32, h as
// bf16 in shared memory, acc += h W2[tile, :]. The f32 accumulator
// [64, D] lives in registers (96 per thread at D = 384, 48 at 192). The
// epilogue adds b2, scales by the gate and adds the residual in f32, writes
// y as bf16 and, serving with the chain, takes the next LayerNorm from the
// f32 y (not the bf16-rounded y), like the JAX kernel.
#include "common.cuh"

namespace {

constexpr int ROWS = 64;    // rows per block
constexpr int HT = 64;      // hidden tile
constexpr int LDH = HT + 8; // padded row strides (bank-conflict-free
constexpr int THREADS = 256; // 32-bit fragment loads)

// Forward shared memory at width D: 164,864 bytes at 384, 88,064 at 192.
template <int D>
struct FwdSmem {
  static constexpr int LDX = D + 8;
  static constexpr int LDY = D + 8;
  static constexpr size_t XN_ELEMS = (size_t)ROWS * LDX;
  static constexpr size_t W1_ELEMS = (size_t)HT * LDX;
  static constexpr size_t W2_ELEMS = (size_t)D * LDH;
  static constexpr size_t H_ELEMS = (size_t)ROWS * LDH;
  static constexpr size_t BYTES = (XN_ELEMS + W1_ELEMS + W2_ELEMS + H_ELEMS) * 2;
  static_assert((size_t)ROWS * LDY * 4 <= (W1_ELEMS + W2_ELEMS) * 2,
                "f32 epilogue tile must fit in the weight staging area");
  static_assert(D % 64 == 0 && BYTES <= 232448, "width outside the kernel's tiling");
};

// LN_IN: the MLP reads LN2(x) (res is x); else it reads x as it is.
// LN_OUT: the LN_next epilogue writes yn (gate is null); else y = res +
// gate * mlp with gate null for 1.
template <int D, int GELU, bool LN_IN, bool LN_OUT>
__global__ void __launch_bounds__(THREADS)
    fused_ln_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ g2,
                        const float* __restrict__ be2, const bf16* __restrict__ w1,
                        const float* __restrict__ b1, const bf16* __restrict__ w2,
                        const float* __restrict__ b2, const float* __restrict__ gn,
                        const float* __restrict__ bn, const float* __restrict__ gate,
                        const bf16* __restrict__ res, bf16* __restrict__ y,
                        bf16* __restrict__ yn, int n_rows, int hidden, float eps) {
  using S = FwdSmem<D>;
  constexpr int LDX = S::LDX, LDY = S::LDY;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1s = xs + S::XN_ELEMS;
  bf16* w2s = w1s + S::W1_ELEMS;
  bf16* hs = w2s + S::W2_ELEMS;
  float* ys = reinterpret_cast<float*>(w1s);  // epilogue alias

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * ROWS;

  // 1. xn = LN2(x), or x itself, -> shared memory (bf16); warp w owns rows
  //    8w..8w+7
  for (int rr = 0; rr < ROWS / 8; ++rr) {
    const int r = warp * (ROWS / 8) + rr;
    const int grow = row0 + r;
    if constexpr (!LN_IN) {
#pragma unroll
      for (int i = 0; i < D / 64; ++i) {
        const int c = 2 * lane + 64 * i;
        *reinterpret_cast<uint32_t*>(xs + r * LDX + c) =
            grow < n_rows ? *reinterpret_cast<const uint32_t*>(x + (size_t)grow * D + c) : 0u;
      }
      continue;
    }
    float v[D / 32];
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
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
    for (int i = 0; i < D / 64; ++i) {
      const int c = 2 * lane + 64 * i;
      *reinterpret_cast<uint32_t*>(xs + r * LDX + c) =
          pack_bf16x2((v[2 * i] - mean) * inv * g2[c] + be2[c],
                      (v[2 * i + 1] - mean) * inv * g2[c + 1] + be2[c + 1]);
    }
  }

  // warp tiling: rows wr..wr+15; GEMM1 columns wc..wc+31 of the hidden
  // tile, GEMM2 output columns oc..oc+D/2-1
  const int wr = (warp & 3) * 16;
  const int wc = (warp >> 2) * 32;
  const int oc = (warp >> 2) * (D / 2);
  float acc[D / 16][4];
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
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
      for (int n = 0; n < D / 16; ++n) {
        uint32_t b[2];
        load_b(b, w2s, LDH, oc + n * 8, k0, lane);
        mma_16816(acc[n], a, b);
      }
    }
  }

  // 3. epilogue: f32 (acc + b2) -> shared, then per row y = . (* gate) + res,
  //    LN_next (serving chain)
  __syncthreads();  // every warp is done reading w2s before ys aliases it
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
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
    float v[D / 32];
    if constexpr (!LN_OUT) {
      const float gt = gate ? gate[grow] : 1.f;
#pragma unroll
      for (int i = 0; i < D / 64; ++i) {
        const int c = 2 * lane + 64 * i;
        const __nv_bfloat162 p =
            *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)grow * D + c);
        *reinterpret_cast<uint32_t*>(y + (size_t)grow * D + c) =
            pack_bf16x2(ys[r * LDY + c] * gt + __bfloat162float(p.x),
                        ys[r * LDY + c + 1] * gt + __bfloat162float(p.y));
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const int c = 2 * lane + 64 * i;
      const __nv_bfloat162 p =
          *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)grow * D + c);
      v[2 * i] = ys[r * LDY + c] + __bfloat162float(p.x);
      v[2 * i + 1] = ys[r * LDY + c + 1] + __bfloat162float(p.y);
      *reinterpret_cast<uint32_t*>(y + (size_t)grow * D + c) =
          pack_bf16x2(v[2 * i], v[2 * i + 1]);
    }
    float mean, inv;
    warp_ln_stats(v, eps, mean, inv);
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const int c = 2 * lane + 64 * i;
      *reinterpret_cast<uint32_t*>(yn + (size_t)grow * D + c) =
          pack_bf16x2((v[2 * i] - mean) * inv * gn[c] + bn[c],
                      (v[2 * i + 1] - mean) * inv * gn[c + 1] + bn[c + 1]);
    }
  }
}

template <int D, int GELU, bool LN_IN, bool LN_OUT>
int launch(const void* x, const void* g2, const void* be2, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* gn,
           const void* bn, const void* gate, const void* res, void* y, void* yn,
           int n_rows, int hidden, float eps, cudaStream_t stream) {
  auto kernel = fused_ln_mlp_kernel<D, GELU, LN_IN, LN_OUT>;
  constexpr size_t smem_bytes = FwdSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  kernel<<<blocks, THREADS, smem_bytes, stream>>>(
      (const bf16*)x, (const float*)g2, (const float*)be2, (const bf16*)w1,
      (const float*)b1, (const bf16*)w2, (const float*)b2, (const float*)gn,
      (const float*)bn, (const float*)gate, (const bf16*)res, (bf16*)y, (bf16*)yn,
      n_rows, hidden, eps);
  return (int)cudaGetLastError();
}

// One entry per (D, LN_IN, LN_OUT) variant: gelu_mode 0 = exact erf GELU,
// 1 = x * sigmoid(1.702 x).
template <int D, bool LN_IN, bool LN_OUT>
int dispatch(int gelu_mode, const void* x, const void* g2, const void* be2,
             const void* w1, const void* b1, const void* w2, const void* b2,
             const void* gn, const void* bn, const void* gate, const void* res, void* y,
             void* yn, int n_rows, int hidden, float eps, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if (gelu_mode == 0)
    return launch<D, 0, LN_IN, LN_OUT>(x, g2, be2, w1, b1, w2, b2, gn, bn, gate, res, y, yn,
                                    n_rows, hidden, eps, (cudaStream_t)stream);
  return launch<D, 1, LN_IN, LN_OUT>(x, g2, be2, w1, b1, w2, b2, gn, bn, gate, res, y, yn,
                                  n_rows, hidden, eps, (cudaStream_t)stream);
}

}  // namespace

// hidden must be a multiple of 64 in every entry; d (the width of x) is
// 384 or 192 in the LN entries, 384 in those without LN.
extern "C" int ibk_fused_ln_mlp(const void* x, const void* g2, const void* be2,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* gn, const void* bn,
                                void* y, void* yn, int n_rows, int d, int hidden,
                                float eps, int gelu_mode, void* stream) {
  return by_width(d, [&](auto w) {
    return dispatch<decltype(w)::value, true, true>(gelu_mode, x, g2, be2, w1, b1, w2, b2, gn,
                                                    bn, nullptr, x, y, yn, n_rows, hidden, eps,
                                                    stream);
  });
}

// Training forward and the unchained serving tail: gate is f32 [n_rows] or
// null (1).
extern "C" int ibk_fused_ln_mlp_train(const void* x, const void* g2, const void* be2,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* gate, void* y,
                                      int n_rows, int d, int hidden, float eps,
                                      int gelu_mode, void* stream) {
  return by_width(d, [&](auto w) {
    return dispatch<decltype(w)::value, true, false>(gelu_mode, x, g2, be2, w1, b1, w2, b2,
                                                     nullptr, nullptr, gate, x, y, nullptr,
                                                     n_rows, hidden, eps, stream);
  });
}

// The MLP without LN: y = res + gate * mlp(h); gate is f32 [n_rows] or null
// (1, serving).
extern "C" int ibk_fused_mlp(const void* h, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* res, const void* gate, void* y,
                             int n_rows, int hidden, int gelu_mode, void* stream) {
  return dispatch<384, false, false>(gelu_mode, h, nullptr, nullptr, w1, b1, w2, b2, nullptr,
                                nullptr, gate, res, y, nullptr, n_rows, hidden, 0.f, stream);
}

// ---------------------------------------------------------------------------
// 4. Training backward. Replaces intentbev/ops/fused_ln_mlp.py::_bwd_kernel:
//      recompute xhat, inv, xn = LN2(x), g = xn W1 + b1, h = GELU(g)
//      dy_eff = dy * gate;  dh = dy_eff W2^T;  dg = dh * GELU'(g)
//      dxn = dg W1;  dgamma = sum dxn * xhat;  dbeta = sum dxn
//      dx = inv * (dxn*gamma - mean(dxn*gamma) - xhat * mean(dxn*gamma*xhat)) + dy
//      dW1 = dg^T xn;  db1 = sum dg;  dW2 = dy_eff^T h;  db2 = sum dy_eff
// with the JAX kernel's rounding points: xn, dy_eff, h and dg are rounded to
// bf16 before they enter a product; the products accumulate in f32.
// Without LN (LN_IN false) it replaces intentbev/ops/fused_mlp.py::_bwd_kernel:
// the row kernel reads the normed input as it is (xn = x), and dx is dxn
// itself; the residual's gradient, dy, is added by autograd.
// Bound on the H100: tensor-core throughput, 5 products of 2*N*384*1536 =
// 212 GFLOP at N = 36008 (the row kernel recomputes g: 6 products here); a
// quarter of that at D = 192, hidden 768.
// Design: the TPU kernel accumulates dW1/dW2 (2.36 MB f32 each) in VMEM
// across a sequential row grid, which has no counterpart on 132 SMs running
// in parallel. So the work is split in two kernels:
//  (a) a row kernel, one 256-thread block per 64 rows: LN recompute into
//      shared memory, then per 64-wide hidden tile g (xn W1^T), dh
//      (dy_eff W2), h and dg; h and dg go to device memory as bf16, and
//      dxn += dg W1 accumulates in registers ([64, D] f32, 96 a thread at
//      D = 384, 48 at 192).
//      The epilogue finishes dx row by row and writes per-block column
//      partials of dgamma, dbeta, db1 and db2;
//  (b) the split-K GEMM C = A^T B of common.cuh over the rows for
//      dW1 = dg^T xn and dW2 = dy_eff^T h, summed in a fixed order.
// ---------------------------------------------------------------------------
namespace {

constexpr int BWD_THREADS = 256;

// Backward shared memory at width D: 216,576 bytes at 384, 115,200 at 192.
template <int D>
struct BwdSmem {
  static constexpr int LDX = D + 8;
  static constexpr int LDY = D + 8;
  static constexpr size_t BX_ELEMS = (size_t)ROWS * LDX;   // xn, dy_eff, W1 tile
  static constexpr size_t BW2_ELEMS = (size_t)D * LDH;     // W2 tile as [d][h]
  static constexpr size_t BDG_ELEMS = (size_t)ROWS * LDH;  // dg tile
  static constexpr size_t BYTES = (3 * BX_ELEMS + BW2_ELEMS + BDG_ELEMS) * 2 +
                                  (4 * HT + 2 * ROWS) * 4;
  static_assert((size_t)ROWS * LDY * 4 <= (BX_ELEMS + BW2_ELEMS) * 2,
                "f32 dxn tile must fit in the W1/W2 staging area");
  static_assert((size_t)3 * 8 * D * 4 <= BX_ELEMS * 2,
                "column partials must fit in the xn area");
  static_assert(D % 64 == 0 && BYTES <= 232448, "width outside the kernel's tiling");
};

// LN_IN: x is LN2's input (xn is recomputed and written to xn_out, dx is
// the LN backward + dy); else x is the MLP's input itself (xn_out unused,
// dx = dxn, and only db2 of the column partials is written).
template <int D, bool LN_IN>
__global__ void __launch_bounds__(BWD_THREADS)
    ln_mlp_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ g2,
                           const float* __restrict__ be2, const bf16* __restrict__ w1,
                           const float* __restrict__ b1, const bf16* __restrict__ w2,
                           const float* __restrict__ gate, const bf16* __restrict__ dy,
                           bf16* __restrict__ dx, bf16* __restrict__ xn_out,
                           bf16* __restrict__ dye_out, bf16* __restrict__ h_out,
                           bf16* __restrict__ dg_out, float* __restrict__ part_db1,
                           float* __restrict__ part_cols, int n_rows, int hidden,
                           float eps) {
  using S = BwdSmem<D>;
  constexpr int LDX = S::LDX, LDY = S::LDY;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* dys = xs + S::BX_ELEMS;
  bf16* w1s = dys + S::BX_ELEMS;
  bf16* w2s = w1s + S::BX_ELEMS;
  bf16* dgs = w2s + S::BW2_ELEMS;
  float* red = reinterpret_cast<float*>(dgs + S::BDG_ELEMS);  // [4][HT]
  float* rmean = red + 4 * HT;
  float* rinv = rmean + ROWS;
  float* ys = reinterpret_cast<float*>(w1s);  // epilogue: f32 dxn [ROWS][LDY]
  float* cols = reinterpret_cast<float*>(xs);  // epilogue: [3][8][D]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * ROWS;

  // 1. xn = LN2(x) (or x) and dy_eff = dy * gate -> shared (bf16) and
  //    device memory
  for (int rr = 0; rr < ROWS / 8; ++rr) {
    const int r = warp * (ROWS / 8) + rr;
    const int grow = row0 + r;
    const bool ok = grow < n_rows;
    float v[D / 32], d[D / 32];
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      float a = 0.f, b = 0.f, da = 0.f, db = 0.f;
      if (ok) {
        const size_t off = (size_t)grow * D + 2 * lane + 64 * i;
        const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(x + off);
        const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(dy + off);
        a = __bfloat162float(p.x);
        b = __bfloat162float(p.y);
        da = __bfloat162float(q.x);
        db = __bfloat162float(q.y);
      }
      v[2 * i] = a;
      v[2 * i + 1] = b;
      d[2 * i] = da;
      d[2 * i + 1] = db;
    }
    const float gt = ok ? (gate ? gate[grow] : 1.f) : 0.f;
    float mean = 0.f, inv = 1.f;
    if constexpr (LN_IN) {
      warp_ln_stats(v, eps, mean, inv);
      if (lane == 0) {
        rmean[r] = mean;
        rinv[r] = inv;
      }
    }
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const int c = 2 * lane + 64 * i;
      // without LN the bf16 input itself (exact: v came from bf16)
      const uint32_t xn2 =
          LN_IN ? pack_bf16x2((v[2 * i] - mean) * inv * g2[c] + be2[c],
                              (v[2 * i + 1] - mean) * inv * g2[c + 1] + be2[c + 1])
                : pack_bf16x2(v[2 * i], v[2 * i + 1]);
      const uint32_t dy2 = pack_bf16x2(d[2 * i] * gt, d[2 * i + 1] * gt);
      *reinterpret_cast<uint32_t*>(xs + r * LDX + c) = xn2;
      *reinterpret_cast<uint32_t*>(dys + r * LDX + c) = dy2;
      if (ok) {
        if constexpr (LN_IN) *reinterpret_cast<uint32_t*>(xn_out + (size_t)grow * D + c) = xn2;
        *reinterpret_cast<uint32_t*>(dye_out + (size_t)grow * D + c) = dy2;
      }
    }
  }

  // warp tiling: rows wr..wr+15; hidden columns wc..wc+31 of the tile for
  // g and dh; dxn output columns oc..oc+D/2-1
  const int wr = (warp & 3) * 16;
  const int wc = (warp >> 2) * 32;
  const int oc = (warp >> 2) * (D / 2);
  float acc[D / 16][4];
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int h0 = 0; h0 < hidden; h0 += HT) {
    __syncthreads();  // xs/dys written (first pass) / previous tile consumed
    // W1 rows h0..h0+63 of [hidden][D] -> w1s [h][d]
    for (int i = tid; i < HT * D / 8; i += BWD_THREADS) {
      const int n = i / (D / 8), c8 = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + n * LDX + c8) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)(h0 + n) * D + c8);
    }
    // W2 columns h0..h0+63 of [D][hidden] -> w2s [d][h]
    for (int i = tid; i < D * HT / 8; i += BWD_THREADS) {
      const int n = i / (HT / 8), c8 = (i % (HT / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + n * LDH + c8) =
          *reinterpret_cast<const uint4*>(w2 + (size_t)n * hidden + h0 + c8);
    }
    __syncthreads();

    float gacc[4][4], hacc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[n][e] = hacc[n][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4], ad[4];
      load_a(a, xs, LDX, wr, k0, lane);
      load_a(ad, dys, LDX, wr, k0, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t b[2], bd[2];
        load_b(b, w1s, LDX, wc + n * 8, k0, lane);      // W1 tile as [n=h][k=d]
        mma_16816(gacc[n], a, b);
        load_b_kn(bd, w2s, LDH, wc + n * 8, k0, lane);  // W2 tile as [k=d][n=h]
        mma_16816(hacc[n], ad, bd);
      }
    }
    // h, dg (f32 -> bf16), db1 column sums over this block's rows
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = wc + n * 8 + 2 * t4;
      const float bb0 = b1[h0 + c], bb1 = b1[h0 + c + 1];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr + g + 8 * half;
        const float ga = gacc[n][2 * half] + bb0, gb = gacc[n][2 * half + 1] + bb1;
        const float da = hacc[n][2 * half] * dgelu_erf(ga);
        const float db = hacc[n][2 * half + 1] * dgelu_erf(gb);
        s0 += da;
        s1 += db;
        const uint32_t dg2 = pack_bf16x2(da, db);
        *reinterpret_cast<uint32_t*>(dgs + r * LDH + c) = dg2;
        if (row0 + r < n_rows) {
          const size_t off = (size_t)(row0 + r) * hidden + h0 + c;
          *reinterpret_cast<uint32_t*>(dg_out + off) = dg2;
          *reinterpret_cast<uint32_t*>(h_out + off) =
              pack_bf16x2(gelu<0>(ga), gelu<0>(gb));
        }
      }
#pragma unroll
      for (int o_ = 4; o_ <= 16; o_ <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o_);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o_);
      }
      if (g == 0) {
        red[(warp & 3) * HT + c] = s0;
        red[(warp & 3) * HT + c + 1] = s1;
      }
    }
    __syncthreads();
    if (tid < HT)
      part_db1[(size_t)blockIdx.x * hidden + h0 + tid] =
          red[tid] + red[HT + tid] + red[2 * HT + tid] + red[3 * HT + tid];
    // dxn += dg W1[tile, :]
#pragma unroll
    for (int k0 = 0; k0 < HT; k0 += 16) {
      uint32_t a[4];
      load_a(a, dgs, LDH, wr, k0, lane);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t b[2];
        load_b_kn(b, w1s, LDX, oc + n * 8, k0, lane);  // W1 tile as [k=h][n=d]
        mma_16816(acc[n], a, b);
      }
    }
  }

  // 2. epilogue: dxn -> shared (f32), then per row the LN backward (or dx =
  //    dxn without LN)
  __syncthreads();  // every warp is done with w1s/w2s/xs before the aliases
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    const int c = oc + n * 8 + 2 * t4;
    ys[(wr + g) * LDY + c] = acc[n][0];
    ys[(wr + g) * LDY + c + 1] = acc[n][1];
    ys[(wr + g + 8) * LDY + c] = acc[n][2];
    ys[(wr + g + 8) * LDY + c + 1] = acc[n][3];
  }
  __syncthreads();
  float cg[D / 32], cb[D / 32], cd[D / 32];  // column sums: dgamma, dbeta, db2
#pragma unroll
  for (int i = 0; i < D / 32; ++i) cg[i] = cb[i] = cd[i] = 0.f;
  for (int rr = 0; rr < ROWS / 8; ++rr) {
    const int r = warp * (ROWS / 8) + rr;
    const int grow = row0 + r;
    if (grow >= n_rows) break;  // warp-uniform
    const float gt = gate ? gate[grow] : 1.f;
    if constexpr (!LN_IN) {
#pragma unroll
      for (int i = 0; i < D / 64; ++i) {
        const int c = 2 * lane + 64 * i;
        const size_t off = (size_t)grow * D + c;
        const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(dy + off);
        cd[2 * i] += __bfloat162float(q.x) * gt;
        cd[2 * i + 1] += __bfloat162float(q.y) * gt;
        *reinterpret_cast<uint32_t*>(dx + off) =
            pack_bf16x2(ys[r * LDY + c], ys[r * LDY + c + 1]);
      }
      continue;
    }
    const float mean = rmean[r], inv = rinv[r];
    float xh[D / 32], dxn[D / 32], d[D / 32];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const int c = 2 * lane + 64 * i;
      const size_t off = (size_t)grow * D + c;
      const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(x + off);
      const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(dy + off);
      xh[2 * i] = (__bfloat162float(p.x) - mean) * inv;
      xh[2 * i + 1] = (__bfloat162float(p.y) - mean) * inv;
      d[2 * i] = __bfloat162float(q.x);
      d[2 * i + 1] = __bfloat162float(q.y);
      dxn[2 * i] = ys[r * LDY + c];
      dxn[2 * i + 1] = ys[r * LDY + c + 1];
    }
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int c = 2 * lane + 64 * (i >> 1) + (i & 1);
      cg[i] += dxn[i] * xh[i];
      cb[i] += dxn[i];
      cd[i] += d[i] * gt;
      dxn[i] *= g2[c];  // dyg
      s1 += dxn[i];
      s2 += dxn[i] * xh[i];
    }
    const float m1 = warp_sum(s1) * (1.f / D), m2 = warp_sum(s2) * (1.f / D);
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const int c = 2 * lane + 64 * i;
      *reinterpret_cast<uint32_t*>(dx + (size_t)grow * D + c) = pack_bf16x2(
          inv * (dxn[2 * i] - m1 - xh[2 * i] * m2) + d[2 * i],
          inv * (dxn[2 * i + 1] - m1 - xh[2 * i + 1] * m2) + d[2 * i + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const int c = 2 * lane + 64 * (i >> 1) + (i & 1);
    cols[(0 * 8 + warp) * D + c] = cg[i];
    cols[(1 * 8 + warp) * D + c] = cb[i];
    cols[(2 * 8 + warp) * D + c] = cd[i];
  }
  __syncthreads();
  const int nb = gridDim.x;
  for (int i = (LN_IN ? 0 : 2 * D) + tid; i < 3 * D; i += BWD_THREADS) {
    const int which = i / D, c = i % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += cols[(which * 8 + w) * D + c];
    part_cols[((size_t)which * nb + blockIdx.x) * D + c] = s;
  }
}

// Both backwards: the row kernel, the column sums, then dW1 = dg^T xn (xn is
// x itself without LN) and dW2 = dy_eff^T h.
template <int D, bool LN_IN>
int mlp_bwd(const void* x, const void* g2, const void* be2, const void* w1, const void* b1,
            const void* w2, const void* gate, const void* dy, void* dx, void* dgamma,
            void* dbeta, void* dw1, void* db1, void* dw2, void* db2, void* xn_ws,
            void* dye_ws, void* h_ws, void* dg_ws, void* part, int n_rows, int hidden,
            float eps, int splits, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  constexpr size_t smem_bytes = BwdSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_bwd_rows_kernel<D, LN_IN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int nb = (n_rows + ROWS - 1) / ROWS;
  float* p_db1 = (float*)part;
  float* p_cols = p_db1 + (size_t)nb * hidden;  // [3][nb][D]
  ln_mlp_bwd_rows_kernel<D, LN_IN><<<nb, BWD_THREADS, smem_bytes, s>>>(
      (const bf16*)x, (const float*)g2, (const float*)be2, (const bf16*)w1,
      (const float*)b1, (const bf16*)w2, (const float*)gate, (const bf16*)dy, (bf16*)dx,
      (bf16*)xn_ws, (bf16*)dye_ws, (bf16*)h_ws, (bf16*)dg_ws, p_db1, p_cols, n_rows,
      hidden, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials(p_db1, nb, hidden, (float*)db1, s);
  if (LN_IN) {
    sum_partials(p_cols, nb, D, (float*)dgamma, s);
    sum_partials(p_cols + (size_t)nb * D, nb, D, (float*)dbeta, s);
  }
  sum_partials(p_cols + (size_t)2 * nb * D, nb, D, (float*)db2, s);
  int e = gemm_at_b((const bf16*)dg_ws, (const bf16*)(LN_IN ? xn_ws : x), (float*)part,
                    (float*)dw1, n_rows, hidden, D, splits, s);
  if (e) return e;
  return gemm_at_b((const bf16*)dye_ws, (const bf16*)h_ws, (float*)part, (float*)dw2,
                   n_rows, D, hidden, splits, s);
}

}  // namespace

// Training backward (exact erf GELU), d = 384 or 192. Outputs: dx bf16
// [n_rows, d]; dgamma, dbeta, db2 f32 [d]; db1 f32 [hidden]; dw1 f32
// [hidden, d]; dw2 f32 [d, hidden]. Workspaces: xn_ws, dye_ws bf16
// [n_rows, d]; h_ws, dg_ws bf16 [n_rows, hidden]; part f32 of
// max(splits * hidden * d, ceil(n_rows / 64) * (hidden + 3 * d)).
extern "C" int ibk_fused_ln_mlp_bwd(const void* x, const void* g2, const void* be2,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* gate, const void* dy, void* dx,
                                    void* dgamma, void* dbeta, void* dw1, void* db1,
                                    void* dw2, void* db2, void* xn_ws, void* dye_ws,
                                    void* h_ws, void* dg_ws, void* part, int n_rows,
                                    int d, int hidden, float eps, int splits, void* stream) {
  return by_width(d, [&](auto w) {
    return mlp_bwd<decltype(w)::value, true>(x, g2, be2, w1, b1, w2, gate, dy, dx, dgamma,
                                             dbeta, dw1, db1, dw2, db2, xn_ws, dye_ws, h_ws,
                                             dg_ws, part, n_rows, hidden, eps, splits, stream);
  });
}

// Backward of the MLP without LN: dh = dg W1 (bf16 [n_rows, 384]; the
// residual's gradient is dy, added by the caller), dw1, db1, dw2, db2 as
// above. Workspaces as above without xn_ws.
extern "C" int ibk_fused_mlp_bwd(const void* h, const void* w1, const void* b1,
                                 const void* w2, const void* gate, const void* dy, void* dh,
                                 void* dw1, void* db1, void* dw2, void* db2, void* dye_ws,
                                 void* a_ws, void* dg_ws, void* part, int n_rows, int hidden,
                                 int splits, void* stream) {
  return mlp_bwd<384, false>(h, nullptr, nullptr, w1, b1, w2, gate, dy, dh, nullptr, nullptr, dw1,
                        db1, dw2, db2, nullptr, dye_ws, a_ws, dg_ws, part, n_rows, hidden,
                        0.f, splits, stream);
}
