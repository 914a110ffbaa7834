// The residual projection y = gate * (x W + b) + residual (x [N, d_in], W
// [d_in, d_out] as in JAX, gate f32 per row):
//   y = (f32(x W) + b) * gate + f32(residual), rounded once to bf16
// Replaces intentbev/ops/experimental/fused_proj.py::_fwd_kernel.
//
// Bound on the H100: device memory. At the attention out-projection's shape
// (x and residual [36864, 384] bf16, W [384, 384]) a call moves 85.4 MB
// (x and residual in, y out) for 10.9 GFLOP: 0.0255 ms at 3.35 TB/s against
// 0.011 ms of bf16 tensor-core time.
// Design: a GEMM tiled 128 rows x 192 columns per 512-thread block (d_out
// 192 or 384: one or two column tiles, so x is read from device memory once
// and from L2 at most twice), walking d_in in chunks of 64 through a
// 3-stage cp.async pipeline (the x chunk [128, 64] and the W chunk [64,
// 192] in its [k][n] layout, rows padded by 16 bytes: conflict-free
// ldmatrix). Each warp computes a 32 x 48 piece with mma.sync m16n8k16
// (bf16, f32 accumulate), A fragments through ldmatrix, B through
// ldmatrix.trans. The residual tile is copied to shared memory with the last
// chunk, so its read overlaps the products instead of stalling the
// epilogue. The epilogue adds the bias, multiplies by the row's gate and
// adds the residual in f32, each step rounded on its own (no contracted
// FMA), and rounds once to bf16.
//
// The backward (below) replaces ::_bwd_kernel.
#include "common.cuh"

namespace {

constexpr int ROWS = 64;
constexpr int NT = 64;  // columns a tile (backward)
constexpr int THREADS = 256;

constexpr int FM = 128;  // forward: rows a block
constexpr int FN = 192;  // columns a block
constexpr int FK = 64;   // d_in a stage
constexpr int STAGES = 3;
constexpr int FTHREADS = 512;
constexpr int LDA = FK + 8;
constexpr int LDB = FN + 8;  // also the residual tile's row stride
constexpr size_t FWD_SMEM_BYTES = ((size_t)STAGES * (FM * LDA + FK * LDB) + FM * LDB) * 2;

template <int DIN>
__global__ void __launch_bounds__(FTHREADS)
    fused_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ bias, const bf16* __restrict__ res,
                      const float* __restrict__ gate, bf16* __restrict__ y, int n_rows,
                      int dout) {
  constexpr int KT = DIN / FK;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);  // [STAGES][FM][LDA]
  bf16* bs = as + STAGES * FM * LDA;         // [STAGES][FK][LDB]
  bf16* rs = bs + STAGES * FK * LDB;         // [FM][LDB]: the residual tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * FN, row0 = blockIdx.y * FM;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 48;

  auto load_stage = [&](int st, int k0) {
    bf16* a_s = as + st * FM * LDA;
    bf16* b_s = bs + st * FK * LDB;
    for (int i = tid; i < FM * FK / 8; i += FTHREADS) {
      const int r = i / (FK / 8), c8 = (i % (FK / 8)) * 8;
      const bool ok = row0 + r < n_rows;
      cp_async16(a_s + r * LDA + c8, x + (size_t)(ok ? row0 + r : 0) * DIN + k0 + c8, ok);
    }
    for (int i = tid; i < FK * FN / 8; i += FTHREADS) {
      const int r = i / (FN / 8), c8 = (i % (FN / 8)) * 8;
      cp_async16(b_s + r * LDB + c8, w + (size_t)(k0 + r) * dout + col0 + c8);
    }
    if (k0 + FK < DIN) return;
    // with the last chunk, the residual tile: it lands while the products
    // run, so the epilogue reads it from shared memory
    for (int i = tid; i < FM * FN / 8; i += FTHREADS) {
      const int r = i / (FN / 8), c8 = (i % (FN / 8)) * 8;
      const bool ok = row0 + r < n_rows;
      cp_async16(rs + r * LDB + c8, res + (size_t)(ok ? row0 + r : 0) * dout + col0 + c8, ok);
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load_stage(st, st * FK);
    cp_async_commit();
  }
  float acc[2][6][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 6; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 consumed by every warp
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * FK);
    cp_async_commit();
    const bf16* a_s = as + (kt % STAGES) * FM * LDA;
    const bf16* b_s = bs + (kt % STAGES) * FK * LDB;
#pragma unroll
    for (int k0 = 0; k0 < FK; k0 += 16) {
      uint32_t a[2][4];
      load_a_x4(a[0], a_s, LDA, wm, k0, lane);
      load_a_x4(a[1], a_s, LDA, wm + 16, k0, lane);
#pragma unroll
      for (int np = 0; np < 3; ++np) {
        uint32_t b[4];
        load_b_trans_x4(b, b_s, LDB, wn + 16 * np, k0, lane);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_16816(acc[m][2 * np], a[m], b0);
          mma_16816(acc[m][2 * np + 1], a[m], b1);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < 6; ++n) {
    const int c = col0 + wn + 8 * n + 2 * t4;
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + wm + 16 * m + g + 8 * half;
        if (r >= n_rows) continue;
        const float gt = gate[r];
        const size_t off = (size_t)r * dout + c;
        const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(
            rs + (r - row0) * LDB + c - col0);
        *reinterpret_cast<uint32_t*>(y + off) = pack_bf16x2(
            __fadd_rn(__fmul_rn(__fadd_rn(acc[m][n][2 * half], b0), gt),
                      __bfloat162float(p.x)),
            __fadd_rn(__fmul_rn(__fadd_rn(acc[m][n][2 * half + 1], b1), gt),
                      __bfloat162float(p.y)));
      }
  }
}

template <int DIN>
int launch_fwd(const void* x, const void* w, const void* bias, const void* res,
               const void* gate, void* y, int n_rows, int dout, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(fused_proj_kernel<DIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(dout / FN, (n_rows + FM - 1) / FM);
  fused_proj_kernel<DIN><<<grid, FTHREADS, FWD_SMEM_BYTES, s>>>(
      (const bf16*)x, (const bf16*)w, (const float*)bias, (const bf16*)res,
      (const float*)gate, (bf16*)y, n_rows, dout);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward. Replaces intentbev/ops/experimental/fused_proj.py::_bwd_kernel:
//      dyg = f32(dy) * gate;  dyg_c = bf16(dyg)
//      dx = dyg_c W^T (f32 sums, bf16);  dW = x^T dyg_c (f32);  db = sum dyg
// db sums the unrounded dyg, as the JAX kernel does; dW and dx take dyg_c.
// Bound on the H100 (the shape above): 86.0 MB of x, dy, dx and dW (0.0257
// ms) against 2 products, 21.7 GFLOP (0.022 ms): bytes.
// Design: since 132 SMs cannot carry dW and db across a sequential row grid
// as the TPU kernel does, (a) a row kernel, one 256-thread block per 64
// rows: stage dy and the gate, write the block's column sums of dyg (f32,
// row order), round dyg to dyg_c in place (also written out for dW), then
// per 64-wide tile of the d_in columns stage W's rows (K-contiguous along
// d_out) and dx = dyg_c W^T (mma.sync); (b) the split-K GEMM of common.cuh
// for dW and its fixed-order sum of db's partials: deterministic, no
// atomics.
// ---------------------------------------------------------------------------
template <int DIN, int DOUT>
__global__ void __launch_bounds__(THREADS)
    fused_proj_bwd_rows_kernel(const bf16* __restrict__ w, const bf16* __restrict__ dy,
                               const float* __restrict__ gate, bf16* __restrict__ dx,
                               bf16* __restrict__ dg_out, float* __restrict__ part_db,
                               int n_rows) {
  constexpr int LDG = DOUT + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* dgs = reinterpret_cast<bf16*>(smem);          // [ROWS][LDG]: dy, then dyg_c
  bf16* ws = dgs + ROWS * LDG;                        // [NT][LDG]: W rows n0..n0+63
  float* gs = reinterpret_cast<float*>(ws + NT * LDG);  // [ROWS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * ROWS;

  for (int i = tid; i < ROWS * DOUT / 8; i += THREADS) {
    const int r = i / (DOUT / 8), c8 = (i % (DOUT / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(dy + (size_t)(row0 + r) * DOUT + c8);
    *reinterpret_cast<uint4*>(dgs + r * LDG + c8) = val;
  }
  if (tid < ROWS) gs[tid] = row0 + tid < n_rows ? gate[row0 + tid] : 0.f;
  __syncthreads();

  // db: the block's column sums of the unrounded dyg, rows in order
  for (int c = tid; c < DOUT; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < ROWS; ++r)
      s = __fadd_rn(s, __fmul_rn(__bfloat162float(dgs[r * LDG + c]), gs[r]));
    part_db[(size_t)blockIdx.x * DOUT + c] = s;
  }
  __syncthreads();
  // dyg_c = bf16(f32(dy) * gate), in place and out for dW
  for (int i = tid; i < ROWS * DOUT / 2; i += THREADS) {
    const int r = i / (DOUT / 2), c = (i % (DOUT / 2)) * 2;
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(dgs + r * LDG + c);
    const uint32_t v2 = pack_bf16x2(__fmul_rn(__bfloat162float(p.x), gs[r]),
                                    __fmul_rn(__bfloat162float(p.y), gs[r]));
    *reinterpret_cast<uint32_t*>(dgs + r * LDG + c) = v2;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint32_t*>(dg_out + (size_t)(row0 + r) * DOUT + c) = v2;
  }

  // dx = dyg_c W^T per 64-wide tile of d_in (W rows as [n = d_in][k = d_out])
  const int wr = (warp & 3) * 16;
  const int wc = (warp >> 2) * 32;
  for (int n0 = 0; n0 < DIN; n0 += NT) {
    __syncthreads();  // dyg_c written (first tile) / previous W tile consumed
    for (int i = tid; i < NT * DOUT / 8; i += THREADS) {
      const int n = i / (DOUT / 8), c8 = (i % (DOUT / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + n * LDG + c8) =
          *reinterpret_cast<const uint4*>(w + (size_t)(n0 + n) * DOUT + c8);
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < DOUT; k0 += 16) {
      uint32_t a[4];
      load_a(a, dgs, LDG, wr, k0, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t b[2];
        load_b(b, ws, LDG, wc + n * 8, k0, lane);
        mma_16816(acc[n], a, b);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n0 + wc + n * 8 + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + wr + g + 8 * half;
        if (r < n_rows)
          *reinterpret_cast<uint32_t*>(dx + (size_t)r * DIN + c) =
              pack_bf16x2(acc[n][2 * half], acc[n][2 * half + 1]);
      }
    }
  }
}

template <int DIN, int DOUT>
int launch_bwd(const void* x, const void* w, const void* dy, const void* gate, void* dx,
               void* dw, void* db, void* dg_ws, void* part, int n_rows, int splits,
               cudaStream_t s) {
  const size_t smem = (size_t)(ROWS + NT) * (DOUT + 8) * 2 + ROWS * 4;
  cudaError_t err = cudaFuncSetAttribute(fused_proj_bwd_rows_kernel<DIN, DOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = (n_rows + ROWS - 1) / ROWS;
  float* p_db = (float*)part;
  float* p_w = p_db + (size_t)nb * DOUT;
  fused_proj_bwd_rows_kernel<DIN, DOUT><<<nb, THREADS, smem, s>>>(
      (const bf16*)w, (const bf16*)dy, (const float*)gate, (bf16*)dx, (bf16*)dg_ws, p_db,
      n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials(p_db, nb, DOUT, (float*)db, s);
  return gemm_at_b((const bf16*)x, (const bf16*)dg_ws, p_w, (float*)dw, n_rows, DIN, DOUT,
                   splits, s);
}

}  // namespace

// x bf16 [n_rows, d_in], w bf16 [d_in, d_out], bias f32 [d_out], res and y
// bf16 [n_rows, d_out], gate f32 [n_rows]; d_in and d_out 192 or 384.
extern "C" int ibk_fused_proj(const void* x, const void* w, const void* bias, const void* res,
                              const void* gate, void* y, int n_rows, int din, int dout,
                              void* stream) {
  if (dout != 192 && dout != 384) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return by_width(din, [&](auto di) {
    return launch_fwd<decltype(di)::value>(x, w, bias, res, gate, y, n_rows, dout, s);
  });
}

// Backward of ibk_fused_proj. Outputs: dx bf16 [n_rows, d_in]; dw f32 [d_in,
// d_out]; db f32 [d_out]. Workspaces: dg_ws bf16 [n_rows, d_out]; part f32
// of ceil(n_rows / 64) * d_out + splits * d_in * d_out.
extern "C" int ibk_fused_proj_bwd(const void* x, const void* w, const void* dy,
                                  const void* gate, void* dx, void* dw, void* db, void* dg_ws,
                                  void* part, int n_rows, int din, int dout, int splits,
                                  void* stream) {
  if (n_rows <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return by_width(din, [&](auto di) {
    return by_width(dout, [&](auto dn) {
      return launch_bwd<decltype(di)::value, decltype(dn)::value>(
          x, w, dy, gate, dx, dw, db, dg_ws, part, n_rows, splits, s);
    });
  });
}
