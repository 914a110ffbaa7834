// Fused LayerNorm + dense [+ GELU] on Hopper, forward and training backward:
// the qkv projection with norm1 folded in (x [36008, D] -> [36008, 3D]) and
// the stream adapters LN -> Linear -> GELU ([36000, D] -> [36000, 192]), at
// the model widths D = 384 (ViT-S) and 192 (ViT-Ti).
//
// Forward. Replaces intentbev/ops/fused_ln_dense.py::_fwd_kernel:
//      xn = LN(x) * gamma + beta;  y = [GELU](xn W^T + b)
// with f32 two-pass statistics, xn rounded to bf16 before the product, an f32
// product, the f32 bias and GELU, and one rounding. Bound on the H100: device
// memory. The qkv call at D = 384 moves 111.5 MB (x in, qkv out, W) for 31.9
// GFLOP: 0.0333 ms at 3.35 TB/s against 0.032 ms of bf16 tensor-core time;
// the adapter call moves 41.5 MB for 5.3 GFLOP.
// Design (warp-specialised as csrc/fused_ln_mlp.cu's forward): a block of 384
// threads owns 128 rows. A producer warpgroup (registers lowered) loads the
// rows once by TMA, then walks the output columns in 192-wide tiles and each
// tile's K = D in 64-column boxes, keeping TMA loads of the W boxes ([192,
// 64] of PyTorch's [Dout, D] layout: K-major for y = xn W^T) in an mbarrier
// ring. Two consumer warpgroups of 64 rows normalise their rows in place (the
// A operand), run y = xn W_tile^T on wgmma m64n192k16 (A and B from shared
// memory, both K-major; a box's slot is released once the next box's
// products are issued and its own have landed), then add the bias, apply the
// GELU, round, and TMA-store the [64, 192] tile through shared memory. x is
// read once and y written once; W (0.9 MB for qkv) comes from L2 once a block.
//
// Backward (below). Replaces intentbev/ops/fused_ln_dense.py::_bwd_kernel.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "ln_kernels.cuh"

namespace {

constexpr int THREADS = 384;      // two consumer warpgroups and the producer
constexpr int ROWS = 128;         // rows of a block, 64 per consumer
constexpr int XBLK = ROWS * 128;  // one 64-column block of the block's rows
constexpr int FN = 192;           // output columns of a forward tile: the N of its products

// The forward's shared memory at width D, from a 1024-byte boundary: the
// block's rows (D / 64 column blocks of [128][64]), S W boxes ([192][64]),
// each consumer's y tile (three [64][64] blocks), the barriers.
template <int D>
struct FwdTiles {
  static constexpr int KB = D / 64;           // W boxes of a tile
  static constexpr int S = D == 384 ? 3 : 4;  // slots of the W ring
  static constexpr int WBOX = FN * 128;
  static constexpr int YBLK = 64 * 128;
  static constexpr int W = D / 64 * XBLK, Y = W + S * WBOX, BARS = Y + 2 * (FN / 64) * YBLK;
  static constexpr int N_BARS = 2 + 2 * S;
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "width outside the kernel's tiling");
};

// ACT: -1 none, 0 exact erf GELU, 1 x * sigmoid(1.702 x). Maps: mx x [n_rows,
// D] and my y [n_rows, dout] in 64 x 64 boxes, mw W [dout, D] in 192 x 64
// boxes; dout a multiple of 64. Rows past n_rows, and in a last partial
// tile W's rows past dout, land as TMA's zeros; neither is stored. bias
// holds the tiles' whole width (dout rounded up to 192; the caller pads it).
template <int D, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
    ln_dense_fwd_kernel(const __grid_constant__ CUtensorMap mx,
                        const __grid_constant__ CUtensorMap mw,
                        const __grid_constant__ CUtensorMap my, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const float* __restrict__ bias,
                        int dout, float eps) {
  using L = FwdTiles<D>;
  constexpr int KB = L::KB, S = L::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* xfull = bar;  // [2] each consumer's rows
  uint64_t* full = bar + 2;
  uint64_t* empty = full + S;

  // the warpgroup through a shuffle: warp-uniform to the compiler, which
  // otherwise takes the consumers' branches for divergent paths and
  // serialises their wgmma
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0), lane = tid % 32;
  const int row0 = blockIdx.x * ROWS;
  const int tiles = (dout + FN - 1) / FN;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) hopper::mbar_init(&xfull[i], 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every load
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 256) {
      for (int h = 0; h < 2; ++h) {
        hopper::mbar_arrive_expect_tx(&xfull[h], 64 * D * 2);
        for (int b = 0; b < D / 64; ++b)
          hopper::tma_load_2d(sm + b * XBLK + h * 64 * 128, &mx, &xfull[h], 64 * b,
                              row0 + 64 * h);
      }
      for (int i = 0; i < tiles * KB; ++i) {
        const int s = i % S;
        hopper::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], L::WBOX);
        hopper::tma_load_2d(sm + L::W + s * L::WBOX, &mw, &full[s], 64 * (i % KB), FN * (i / KB));
      }
    }
    return;
  }

  // consumers: 64 rows each
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wt = tid % 128, warp = wt / 32;
  const int g = lane >> 2, t4 = lane & 3;
  hopper::mbar_wait(&xfull[wg], 0);
  ln_in_place<D, XBLK>(sm + wg * 64 * 128, warp, lane, gamma, beta, eps);
  hopper::fence_proxy_async();  // the wgmma reads below are async-proxy reads
  hopper::named_sync(1 + wg, 128);

  float acc[FN / 2];  // row 16 warp + g (+8), column 8n + 2t4 (+1) of the tile
  uint8_t* ys = sm + L::Y + wg * (FN / 64) * L::YBLK;
  const int la = 16 * warp + g, lb = la + 8;  // rows within this consumer's 64
  const uint32_t sbase = hopper::smem_u32(sm);
  auto release = [&](int i) {
    if (lane == 0) hopper::mbar_arrive(&empty[i % S]);
  };
  for (int j = 0; j < tiles; ++j) {
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const int i = j * KB + b, s = i % S;
      hopper::mbar_wait(&full[s], (i / S) & 1);
      // descriptor bases opaque to the compiler: else it keeps every
      // k-step's descriptor live across the loop
      uint32_t a0 = sbase + wg * 64 * 128 + b * XBLK, b0 = sbase + L::W + s * L::WBOX;
      asm volatile("" : "+r"(a0), "+r"(b0));
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss_n192(acc, hopper::desc_kmajor_at<128>(a0 + kk * 32),
                              hopper::desc_kmajor_at<128>(b0 + kk * 32), b > 0 || kk > 0);
      hopper::wgmma_commit();
      if (b > 0) {  // the previous box's products have landed: its slot is free
        hopper::wgmma_wait<1>();
        release(i - 1);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    release((j + 1) * KB - 1);

    // epilogue: bias, GELU, one rounding into this consumer's y tile, which
    // the previous tile's TMA stores have read
    if (wt == 0) hopper::bulk_wait_read();
    hopper::named_sync(1 + wg, 128);
    const float* bj = bias + j * FN + 2 * t4;
    static_for<FN / 8>([&](auto n_) {
      constexpr int n = decltype(n_)::value;
      const float2 bb = *reinterpret_cast<const float2*>(bj + 8 * n);
      float v[4] = {acc[4 * n] + bb.x, acc[4 * n + 1] + bb.y, acc[4 * n + 2] + bb.x,
                    acc[4 * n + 3] + bb.y};
      if constexpr (ACT >= 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = gelu<ACT>(v[e]);
      }
      const int c = 8 * n + 2 * t4;
      *reinterpret_cast<uint32_t*>(ys + swz<64>(la, c)) = pack_bf16x2(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(ys + swz<64>(lb, c)) = pack_bf16x2(v[2], v[3]);
    });
    hopper::fence_proxy_async();
    hopper::named_sync(1 + wg, 128);
    if (wt == 0) {
      for (int c = 0; c < FN / 64; ++c)  // a last partial tile's columns up to Dout
        if (j * FN + 64 * c < dout)
          hopper::tma_store_2d(&my, ys + c * L::YBLK, j * FN + 64 * c, row0 + 64 * wg);
      hopper::bulk_commit();
    }
  }
  if (wt == 0) hopper::bulk_wait_read();  // the stores have read the tile
}

template <typename K>
int raise_once(K kernel, int bytes, bool& ok) {
  if (ok) return 0;
  const int err = raise_smem(kernel, bytes);
  ok = err == 0;
  return err;
}

template <int D, int ACT>
int launch_fwd(const void* x, const void* gamma, const void* beta, const void* w,
               const void* bias, void* y, int n_rows, int dout, float eps, cudaStream_t stream) {
  using L = FwdTiles<D>;
  CUtensorMap mx, mw, my;
  int err;
  if ((err = hopper::encode_2d(&mx, x, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&mw, w, dout, D, FN, 64)) ||
      (err = hopper::encode_2d(&my, y, n_rows, dout, 64, 64)))
    return err;
  static bool ok = false;  // the shared-memory limit is raised once
  if ((err = raise_once(ln_dense_fwd_kernel<D, ACT>, L::BYTES, ok))) return err;
  ln_dense_fwd_kernel<D, ACT><<<(n_rows + ROWS - 1) / ROWS, THREADS, L::BYTES, stream>>>(
      mx, mw, my, (const float*)gamma, (const float*)beta, (const float*)bias, dout, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [n_rows, d], d 384 or 192; gamma, beta f32 [d]; w bf16 [dout, d];
// bias f32 [dout rounded up to a multiple of 192: the forward's column tile],
// its values past dout unused; y bf16 [n_rows, dout]; dout a multiple of 64.
// gelu_mode: -1 none, 0 exact erf GELU, 1 x * sigmoid(1.702 x).
extern "C" int ibk_fused_ln_dense(const void* x, const void* gamma, const void* beta,
                                  const void* w, const void* bias, void* y, int n_rows, int d,
                                  int dout, float eps, int gelu_mode, void* stream) {
  if (dout <= 0 || dout % 64 != 0) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return by_width(d, [&](auto wd) {
    constexpr int D = decltype(wd)::value;
    if (gelu_mode < 0) return launch_fwd<D, -1>(x, gamma, beta, w, bias, y, n_rows, dout, eps, s);
    if (gelu_mode == 0) return launch_fwd<D, 0>(x, gamma, beta, w, bias, y, n_rows, dout, eps, s);
    return launch_fwd<D, 1>(x, gamma, beta, w, bias, y, n_rows, dout, eps, s);
  });
}

// ---------------------------------------------------------------------------
// Training backward. Replaces intentbev/ops/fused_ln_dense.py::_bwd_kernel:
//      recompute xhat, inv, xn = LN(x);  with GELU g = xn W^T + b and
//      dg = dy * GELU'(g), else dg = dy
//      dW = dg^T xn;  db = sum dg;  dxn = dg W
//      dgamma = sum dxn * xhat;  dbeta = sum dxn
//      dx = inv * (dxn*gamma - mean(dxn*gamma) - xhat * mean(dxn*gamma*xhat))
// with the JAX kernel's rounding points: xn and dg are rounded to bf16
// before they enter a product; products and column sums are f32, and db sums
// the f32 dg (not the bf16 copy that the dW product reads).
// Bound on the H100 (batch 8, D = 384): the qkv call (x [36008, 384], dy
// [36008, 1152], no GELU) does 2 products, 63.7 GFLOP, 0.064 ms at 989
// TFLOP/s, against 141 MB of x, dy, dx and dW (0.042 ms); the adapter call
// (dy [36000, 192], erf GELU) does 3 products, 15.9 GFLOP (0.016 ms) against
// 69 MB (0.021 ms): bytes.
// Design. The TPU kernel carries dW across a sequential row grid, which 132
// SMs running in parallel cannot; so, as the LN+MLP backward:
//  (a) ln_dense_bwd_kernel: a block of 384 threads owns 128 rows. A producer
//      warpgroup loads x once by TMA, then walks Dout in 32-wide tiles,
//      keeping TMA loads of the W tile [32, D] (boxes [32, 64]) and the dy
//      tile [128, 32] in an mbarrier ring. Two consumer warpgroups of 64 rows
//      take LN in place (xn, TMA-stored to xn_ws for (b)) and each holds its
//      rows' whole [64, D] f32 dxn accumulator (192 registers at D = 384), so
//      the LN backward's row sums need no exchange. Per tile: without GELU,
//      dxn += dy_tile W_tile on wgmma m64n192k16 (A the dy tile as TMA lands
//      it, K-major; B the W tile read MN-major across its column boxes), the
//      slot released once the next tile's products are issued and its own
//      have landed; two warps of the producer warpgroup sum db from the
//      landed dy tiles (dg = dy). With GELU, g = xn W_tile^T first (m64n32,
//      both K-major), dg = dy GELU'(g + b) in f32 with db's column sums,
//      dg rounded into a bf16 tile (TMA-stored to dg_ws for (b)), then dxn +=
//      dg W_tile. Once the ring drains the producer loads x again into it;
//      the epilogue takes the LN backward per row (quad sums), writes dx in
//      place of x and TMA-stores it, and leaves per-block column partials
//      of dgamma and dbeta.
//  (b) dw_gemm_kernel (ln_kernels.cuh), one product: dW = dg^T xn over the
//      rows (P = dg_ws, or dy itself without GELU; M = Dout, N = D), rows split
//      to fill whole waves of the card's SMs, f32 partials per split.
// Block partials (db, dgamma, dbeta) and split partials (dW) are summed in a
// fixed order (col_sums_kernel, split_sums_kernel): deterministic, no
// atomics. Rows past n_rows land as TMA's zeros (dy = 0, so dg and dxn are 0)
// and are not stored.
// ---------------------------------------------------------------------------
namespace {

constexpr int BN = 32;  // Dout columns of a backward tile: the K of its dxn product

// The backward row kernel's shared memory at width D, from a 1024-byte
// boundary: the block's rows (x, then xn; D / 64 column blocks of
// [128][64]), S ring slots (the W tile: D / 64 boxes [32][64]; the dy tile
// [128][32], 64-byte rows), with GELU the dg tile ([128][32] bf16, 64-byte
// rows swizzled as TMA stores them) and db's warp partials, the rows' LN
// statistics, the barriers. Once the ring drains it takes x again (laid out
// as the block's rows), and the rows' area the column partials.
template <int D, bool GELU>
struct BwdTiles {
  static constexpr int S = D == 384 ? 3 : 4;
  static constexpr int WBOX = BN * 128;
  static constexpr int W_TILE = D / 64 * WBOX, DY_TILE = ROWS * BN * 2;
  static constexpr int SLOT = W_TILE + DY_TILE;
  static constexpr int RING = D / 64 * XBLK, DG = RING + S * SLOT;
  static constexpr int RED = DG + (GELU ? DY_TILE : 0);  // [2 consumers][4 warps][BN]
  static constexpr int STATS = RED + (GELU ? 2 * 4 * BN * 4 : 0);  // mean [128], inv [128]
  static constexpr int BARS = STATS + 2 * ROWS * 4;
  static constexpr int N_BARS = 4 + 2 * S;
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "width outside the kernel's tiling");
  static_assert(D / 64 * XBLK <= S * SLOT, "x reloads into the drained ring");
  static_assert(8 * D * 2 * 4 <= RING, "the column partials fit over the rows");
};

// Maps: mx, mxn, mdx [n_rows, D] in 64 x 64 boxes; mw W [dout, D] in 32 x 64
// boxes; mdy dy [n_rows, dout] in 128 x 32 boxes; mdg dg_ws [n_rows, dout]
// in 64 x 32 boxes (GELU). part_db [2 * blocks][dout] (each consumer's
// rows) and part_cols [2][blocks][D] (dgamma, dbeta) take the partials.
template <int D, bool GELU>
__global__ void __launch_bounds__(THREADS, 1)
    ln_dense_bwd_kernel(const __grid_constant__ CUtensorMap mx,
                        const __grid_constant__ CUtensorMap mw,
                        const __grid_constant__ CUtensorMap mdy,
                        const __grid_constant__ CUtensorMap mxn,
                        const __grid_constant__ CUtensorMap mdg,
                        const __grid_constant__ CUtensorMap mdx, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const float* __restrict__ bias,
                        float* __restrict__ part_db, float* __restrict__ part_cols, int dout,
                        float eps) {
  using L = BwdTiles<D, GELU>;
  constexpr int S = L::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* xfull = bar;      // [2] each consumer's rows
  uint64_t* again = bar + 2;  // [2] them again, for the LN epilogue
  uint64_t* full = bar + 4;
  uint64_t* empty = full + S;
  float* stats = reinterpret_cast<float*>(sm + L::STATS);

  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0), lane = tid % 32;
  const int row0 = blockIdx.x * ROWS, nb = gridDim.x;
  const int tiles = dout / BN;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) hopper::mbar_init(&xfull[i], 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      // each consumer warp after its products; without GELU also the two
      // warps that sum db
      hopper::mbar_init(&empty[s], GELU ? 8 : 10);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    const int pw = (tid - 256) / 32;
    if (tid == 256) {  // one thread issues every load
      for (int h = 0; h < 2; ++h) {
        hopper::mbar_arrive_expect_tx(&xfull[h], 64 * D * 2);
        for (int b = 0; b < D / 64; ++b)
          hopper::tma_load_2d(sm + b * XBLK + h * 64 * 128, &mx, &xfull[h], 64 * b,
                              row0 + 64 * h);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % S;
        hopper::mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], L::SLOT);
        uint8_t* slot = sm + L::RING + s * L::SLOT;
        for (int b = 0; b < D / 64; ++b)
          hopper::tma_load_2d(slot + b * L::WBOX, &mw, &full[s], 64 * b, BN * j);
        hopper::tma_load_2d(slot + L::W_TILE, &mdy, &full[s], BN * j, row0);
      }
      // every slot's last tile released: x again into the ring
      for (int j = max(tiles - S, 0); j < tiles; ++j)
        hopper::mbar_wait(&empty[j % S], (j / S) & 1);
      for (int h = 0; h < 2; ++h) {
        hopper::mbar_arrive_expect_tx(&again[h], 64 * D * 2);
        for (int b = 0; b < D / 64; ++b)
          hopper::tma_load_2d(sm + L::RING + b * XBLK + h * 64 * 128, &mx, &again[h], 64 * b,
                              row0 + 64 * h);
      }
    } else if (!GELU && (pw == 1 || pw == 2)) {
      // db = the column sums of dy (dg = dy) over consumer pw - 1's 64 rows:
      // lane l sums columns c = 2 (l % 16), + 1 over rows 32 (l / 16) .. + 31
      // (row r's pair at r * 64 + (c / 8 ^ r / 2 % 4) * 16 + c % 8 * 2 of the
      // tile), and the two half-warps' sums are added
      const int h = pw - 1, c = 2 * (lane % 16), r0 = 64 * h + 32 * (lane / 16);
      const uint32_t t0 = hopper::smem_u32(sm + L::RING + L::W_TILE) + r0 * 64 + (c % 8) * 2;
      float* out = part_db + (size_t)(2 * blockIdx.x + h) * dout + c;
      for (int j = 0; j < tiles; ++j) {
        const int s = j % S;
        hopper::mbar_wait(&full[s], (j / S) & 1);
        const uint32_t t = t0 + s * L::SLOT;
        float2 sum = make_float2(0.f, 0.f);
#pragma unroll 4
        for (int r = 0; r < 32; ++r) {
          const float2 v = lds_bf16x2(t + r * 64 + (((c >> 3) ^ ((r >> 1) & 3)) << 4));
          sum.x += v.x;
          sum.y += v.y;
        }
        sum.x += __shfl_xor_sync(0xffffffffu, sum.x, 16);
        sum.y += __shfl_xor_sync(0xffffffffu, sum.y, 16);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
        if (lane < 16) *reinterpret_cast<float2*>(out + BN * j) = sum;
      }
    }
    return;
  }

  // consumers: 64 rows each
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wt = tid % 128, warp = wt / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t sbase = hopper::smem_u32(sm);
  uint8_t* xs = sm + wg * 64 * 128;  // this consumer's rows in each column block

  // 1. xn = LN(x) in place, TMA-stored to xn_ws for the dW product
  hopper::mbar_wait(&xfull[wg], 0);
  ln_in_place<D, XBLK>(xs, warp, lane, gamma, beta, eps, stats + 64 * wg, ROWS);
  hopper::fence_proxy_async();  // the wgmma reads and TMA stores are async-proxy reads
  hopper::named_sync(1 + wg, 128);
  if (wt == 0) {
    for (int b = 0; b < D / 64; ++b)
      hopper::tma_store_2d(&mxn, xs + b * XBLK, 64 * b, row0 + 64 * wg);
    hopper::bulk_commit();
  }

  // 2. the Dout tiles
  constexpr int Q = D / FN;  // dxn products of a k-step (N = 192 each)
  float acc[Q][FN / 2];      // dxn: row 16 warp + g (+8), column 192 q + 8n + 2t4 (+1)
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int i = 0; i < FN / 2; ++i) acc[q][i] = 0.f;
  const int la = 16 * warp + g, lb = la + 8;  // rows within this consumer's 64
  auto release = [&](int j) {
    if (lane == 0) hopper::mbar_arrive(&empty[j % S]);
  };
  // acc += dg W_tile: A the dg tile (GELU) or the slot's dy tile, K-major
  // (64-byte rows); B the W tile MN-major, N = 192 across three column boxes.
  // Descriptor bases opaque to the compiler: else it keeps every k-step's
  // descriptor live across the loop, in registers the accumulator needs.
  auto dxn = [&](int s) {
    uint32_t a0 = sbase + (GELU ? L::DG : L::RING + s * L::SLOT + L::W_TILE) + wg * 64 * 64;
    uint32_t b0 = sbase + L::RING + s * L::SLOT;
    asm volatile("" : "+r"(a0), "+r"(b0));
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int q = 0; q < Q; ++q)
        hopper::wgmma_sst<FN, 0, 1>(
            acc[q], hopper::desc_kmajor_at<64>(a0 + kk * 32),
            hopper::desc_mnmajor_at<128>(b0 + 3 * q * L::WBOX + kk * 16 * 128, L::WBOX), 1);
  };

  if constexpr (!GELU) {
    for (int j = 0; j < tiles; ++j) {
      hopper::mbar_wait(&full[j % S], (j / S) & 1);
      hopper::wgmma_fence();
      dxn(j % S);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // tile j - 1's products have landed: its slot is free
      if (j > 0) release(j - 1);
    }
  } else {
    float gacc[BN / 2];  // g of one tile: row 16 warp + g (+8), column 8n + 2t4 (+1)
    float* red = reinterpret_cast<float*>(sm + L::RED) + wg * 4 * BN;
    for (int j = 0; j < tiles; ++j) {
      const int s = j % S;
      hopper::mbar_wait(&full[s], (j / S) & 1);
      {  // g = xn W_tile^T: A the rows, B the W tile, both K-major
        uint32_t a0 = sbase + wg * 64 * 128, b0 = sbase + L::RING + s * L::SLOT;
        asm volatile("" : "+r"(a0), "+r"(b0));
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss_n32(
              gacc, hopper::desc_kmajor_at<128>(a0 + (kk >> 2) * XBLK + (kk & 3) * 32),
              hopper::desc_kmajor_at<128>(b0 + (kk >> 2) * L::WBOX + (kk & 3) * 32), kk > 0);
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();  // and tile j - 1's dxn: its slot and the dg tile are free
      hopper::fence_regs(gacc);
      if (j > 0) release(j - 1);
      if (wt == 0) hopper::bulk_wait_read();  // tile j - 1's dg store has read the tile
      hopper::named_sync(1 + wg, 128);
      // dg = dy GELU'(g + b) in f32: its column sums over the warp's 16
      // rows (db), rounded to bf16 into the dg tile. The group's bias and dy
      // loads at the group (the pointer opaque): else the compiler loads
      // them all ahead, into registers the accumulator needs.
      // Element (r, c) of a [64][32] tile of 64-byte rows lies at r * 64 + (c
      // / 8 ^ r / 2 % 4) * 16 + c % 8 * 2: for column 8n + 2 t4 of rows la
      // and lb = la + 8, a row offset + ((n ^ key) * 16), the same key.
      const uint32_t dys = sbase + L::RING + s * L::SLOT + L::W_TILE + wg * 64 * 64;
      const uint32_t dgs = sbase + L::DG + wg * 64 * 64;
      const int row_a = la * 64 + 4 * t4, key = (la >> 1) & 3;
      const float* bj = bias + BN * j + 2 * t4;
      static_for<BN / 8>([&](auto n_) {
        constexpr int n = decltype(n_)::value;
        asm volatile("" : "+l"(bj));
        const int c = 8 * n + 2 * t4, off = row_a + ((n ^ key) << 4);
        const float2 bb = *reinterpret_cast<const float2*>(bj + 8 * n);
        const float2 da = lds_bf16x2(dys + off), db = lds_bf16x2(dys + off + 512);
        const float g0 = da.x * dgelu_erf(gacc[4 * n] + bb.x);
        const float g1 = da.y * dgelu_erf(gacc[4 * n + 1] + bb.y);
        const float g2 = db.x * dgelu_erf(gacc[4 * n + 2] + bb.x);
        const float g3 = db.y * dgelu_erf(gacc[4 * n + 3] + bb.y);
        sts_b32(dgs + off, pack_bf16x2(g0, g1));
        sts_b32(dgs + off + 512, pack_bf16x2(g2, g3));
        float s0 = g0 + g2, s1 = g1 + g3;
#pragma unroll
        for (int o = 4; o <= 16; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (g == 0) *reinterpret_cast<float2*>(red + warp * BN + c) = make_float2(s0, s1);
      });
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);  // the dg tile and db's warp sums are whole
      if (wt == 0) {
        hopper::tma_store_2d(&mdg, sm + L::DG + wg * 64 * 64, BN * j, row0 + 64 * wg);
        hopper::bulk_commit();
      }
      if (wt < BN)
        part_db[(size_t)(2 * blockIdx.x + wg) * dout + BN * j + wt] =
            ((red[wt] + red[BN + wt]) + red[2 * BN + wt]) + red[3 * BN + wt];
      hopper::wgmma_fence();
      dxn(s);
      hopper::wgmma_commit();
    }
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < Q; ++q) hopper::fence_regs(acc[q]);
  release(tiles - 1);

  // 3. epilogue: rows la, lb of this thread's values, block rows ra, rb; x
  //    again in the ring, dx in its place; the column partials over the rows
  //    (whose xn and dg stores have read their tiles). Element (r, c) of the
  //    rows lies at r * 128 + (c / 64) * XBLK + ((c % 64 / 8 ^ r % 8) * 16 +
  //    c % 8 * 2; for this thread's columns c = 8i + 2 t4 that is a row base
  //    + (i / 8) * XBLK + ((i % 8 ^ g) * 16), since ra % 8 = rb % 8 = g.
  const int ra = 64 * wg + la, rb = ra + 8;
  hopper::mbar_wait(&again[wg], 0);
  if (wt == 0) hopper::bulk_wait_read();
  hopper::named_sync(3, 256);
  const float ma = stats[ra], ia = stats[ROWS + ra];
  const float mb = stats[rb], ib = stats[ROWS + rb];
  // The row base, the swizzle key and the gamma pointer are made opaque to
  // the compiler at each pass (the pointer every four column groups): else
  // it keeps the passes' addresses or loads ahead in registers the
  // accumulator needs.
  const float* gp = gamma;
  uint32_t xa0 = sbase + L::RING + ra * 128 + 4 * t4;  // row ra; rb is 1024 bytes on
  int key = g;
  auto at = [&](auto i) {
    constexpr int I = decltype(i)::value;
    if constexpr (I % 4 == 0) asm volatile("" : "+l"(gp), "+r"(key));
    return xa0 + (I / 8) * XBLK + (((I % 8) ^ key) << 4);
  };
  asm volatile("" : "+r"(xa0));
  float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;  // row sums of dyg and dyg xhat
  static_for<D / 8>([&](auto i) {
    constexpr int q = decltype(i)::value / (FN / 8), n = decltype(i)::value % (FN / 8);
    const int c = 8 * decltype(i)::value + 2 * t4;
    const uint32_t pa = at(i);
    const float2 gg = make_float2(gp[c], gp[c + 1]);
    const float2 xa = lds_bf16x2(pa), xb = lds_bf16x2(pa + 1024);
    const float ya0 = acc[q][4 * n] * gg.x, ya1 = acc[q][4 * n + 1] * gg.y;
    const float yb0 = acc[q][4 * n + 2] * gg.x, yb1 = acc[q][4 * n + 3] * gg.y;
    s1a += ya0 + ya1;
    s1b += yb0 + yb1;
    s2a += ya0 * ((xa.x - ma) * ia) + ya1 * ((xa.y - ma) * ia);
    s2b += yb0 * ((xb.x - mb) * ib) + yb1 * ((xb.y - mb) * ib);
  });
  const float m1a = quad_sum(s1a) * (1.f / D), m2a = quad_sum(s2a) * (1.f / D);
  const float m1b = quad_sum(s1b) * (1.f / D), m2b = quad_sum(s2b) * (1.f / D);
  asm volatile("" : "+r"(xa0));
  // this warp's column partials [D][2] (dgamma, dbeta) over the rows' area
  uint32_t cs = sbase + (wg * 4 + warp) * D * 2 * 4 + 8 * 2 * t4;
  static_for<D / 8>([&](auto i) {
    constexpr int q = decltype(i)::value / (FN / 8), n = decltype(i)::value % (FN / 8);
    const int c = 8 * decltype(i)::value + 2 * t4;
    const uint32_t pa = at(i);
    const float2 gg = make_float2(gp[c], gp[c + 1]);
    const float2 xa = lds_bf16x2(pa), xb = lds_bf16x2(pa + 1024);
    const float ha0 = (xa.x - ma) * ia, ha1 = (xa.y - ma) * ia;
    const float hb0 = (xb.x - mb) * ib, hb1 = (xb.y - mb) * ib;
    sts_b32(pa, pack_bf16x2(ia * (acc[q][4 * n] * gg.x - m1a - ha0 * m2a),
                            ia * (acc[q][4 * n + 1] * gg.y - m1a - ha1 * m2a)));
    sts_b32(pa + 1024, pack_bf16x2(ib * (acc[q][4 * n + 2] * gg.x - m1b - hb0 * m2b),
                                   ib * (acc[q][4 * n + 3] * gg.y - m1b - hb1 * m2b)));
    float cg0 = acc[q][4 * n] * ha0 + acc[q][4 * n + 2] * hb0;
    float cg1 = acc[q][4 * n + 1] * ha1 + acc[q][4 * n + 3] * hb1;
    float cb0 = acc[q][4 * n] + acc[q][4 * n + 2], cb1 = acc[q][4 * n + 1] + acc[q][4 * n + 3];
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1) {  // the warp's 16 rows
      cg0 += __shfl_xor_sync(0xffffffffu, cg0, o);
      cg1 += __shfl_xor_sync(0xffffffffu, cg1, o);
      cb0 += __shfl_xor_sync(0xffffffffu, cb0, o);
      cb1 += __shfl_xor_sync(0xffffffffu, cb1, o);
    }
    if (g == 0) sts_f4(cs + 8 * 8 * decltype(i)::value, make_float4(cg0, cb0, cg1, cb1));
  });
  hopper::fence_proxy_async();
  hopper::named_sync(1 + wg, 128);
  if (wt == 0) {
    for (int b = 0; b < D / 64; ++b)
      hopper::tma_store_2d(&mdx, sm + L::RING + b * XBLK + wg * 64 * 128, 64 * b,
                           row0 + 64 * wg);
    hopper::bulk_commit();
  }
  hopper::named_sync(3, 256);  // every warp's column partials are in
  const float* cw = reinterpret_cast<const float*>(sm);
  for (int c = tid; c < D; c += 256) {  // the warps' sums, in warp order
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      sg += cw[(w * D + c) * 2];
      sb += cw[(w * D + c) * 2 + 1];
    }
    part_cols[(size_t)blockIdx.x * D + c] = sg;
    part_cols[((size_t)nb + blockIdx.x) * D + c] = sb;
  }
  if (wt == 0) hopper::bulk_wait_read();  // the dx stores have read the tile
}

// The row kernel, the block partials' sums, then dW = dg^T xn and its split
// sums.
template <int D, bool GELU>
int ln_dense_bwd(const void* x, const void* gamma, const void* beta, const void* w,
                 const void* bias, const void* dy, void* dx, void* dgamma, void* dbeta,
                 void* dw, void* dbias, void* xn_ws, void* dg_ws, void* part, int n_rows,
                 int dout, float eps, int splits, cudaStream_t s) {
  using L = BwdTiles<D, GELU>;
  const void* dg = GELU ? dg_ws : dy;  // the dW product's P
  CUtensorMap mx, mw, mdy, mxn, mdg, mdx;
  int err;
  if ((err = hopper::encode_2d(&mx, x, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&mw, w, dout, D, BN, 64)) ||
      (err = hopper::encode_2d(&mdy, dy, n_rows, dout, ROWS, BN)) ||
      (err = hopper::encode_2d(&mxn, xn_ws, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&mdg, dg, n_rows, dout, 64, BN)) ||
      (err = hopper::encode_2d(&mdx, dx, n_rows, D, 64, 64)))
    return err;
  static bool ok = false, ok_dw = false;  // the shared-memory limits are raised once
  if ((err = raise_once(ln_dense_bwd_kernel<D, GELU>, L::BYTES, ok)) ||
      (err = raise_once(dw_gemm_kernel, DW_BYTES, ok_dw)))
    return err;
  const int nb = (n_rows + ROWS - 1) / ROWS;
  float* p_db = (float*)part;
  float* p_cols = p_db + (size_t)2 * nb * dout;  // [2][nb][D]
  ln_dense_bwd_kernel<D, GELU><<<nb, THREADS, L::BYTES, s>>>(
      mx, mw, mdy, mxn, mdg, mdx, (const float*)gamma, (const float*)beta, (const float*)bias,
      p_db, p_cols, dout, eps);
  if ((err = (int)cudaGetLastError())) return err;
  ColSums cs = {{p_db, p_cols, p_cols + (size_t)nb * D, nullptr},
                {(float*)dbias, (float*)dgamma, (float*)dbeta, nullptr},
                {dout, D, D, 0},
                {2 * nb, nb, nb, 0}};
  col_sums_kernel<<<dim3((std::max(dout, D) + 31) / 32, 3), 256, 0, s>>>(cs);
  if ((err = (int)cudaGetLastError())) return err;

  // one product (M2 = 0: the grid holds product 1's tiles only, so the
  // second pair of maps, product 1's again, is never read)
  CUtensorMap mp, mq;
  if ((err = hopper::encode_2d(&mp, dg, n_rows, dout, 64, 64)) ||
      (err = hopper::encode_2d(&mq, xn_ws, n_rows, D, 64, 64)))
    return err;
  const int tiles = (dout + DW_M - 1) / DW_M * ((D + DW_N - 1) / DW_N);
  const int per = ((n_rows + DW_K - 1) / DW_K + splits - 1) / splits * DW_K;
  dw_gemm_kernel<<<tiles * splits, DW_THREADS, DW_BYTES, s>>>(mp, mq, mp, mq, (float*)part, dout,
                                                              D, 0, 0, n_rows, per, splits);
  if ((err = (int)cudaGetLastError())) return err;
  const int n4 = dout * D / 4;
  split_sums_kernel<<<(n4 + 255) / 256, 256, 0, s>>>((const float4*)part, splits, n4, n4,
                                                     (float4*)dw, (float4*)dw);
  return (int)cudaGetLastError();
}

}  // namespace

// Backward of ibk_fused_ln_dense (gelu_mode -1 none, 0 exact erf GELU), d 384
// or 192, dout a multiple of 64. Outputs: dx bf16 [n_rows, d]; dgamma, dbeta
// f32 [d]; dw f32 [dout, d]; dbias f32 [dout]. Workspaces: xn_ws bf16
// [n_rows, d]; dg_ws bf16 [n_rows, dout] (GELU only); part f32 of
// max(splits * dout * d, 2 * ceil(n_rows / 128) * (dout + d)). splits: the
// row splits of the dW product (ops/fused_ln_dense.py).
extern "C" int ibk_fused_ln_dense_bwd(const void* x, const void* gamma, const void* beta,
                                      const void* w, const void* bias, const void* dy,
                                      void* dx, void* dgamma, void* dbeta, void* dw,
                                      void* dbias, void* xn_ws, void* dg_ws, void* part,
                                      int n_rows, int d, int dout, float eps, int gelu_mode,
                                      int splits, void* stream) {
  if (dout <= 0 || dout % 64 != 0 || gelu_mode > 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return by_width(d, [&](auto wd) {
    constexpr int D = decltype(wd)::value;
    if (gelu_mode < 0)
      return ln_dense_bwd<D, false>(x, gamma, beta, w, bias, dy, dx, dgamma, dbeta, dw, dbias,
                                    xn_ws, dg_ws, part, n_rows, dout, eps, splits, s);
    return ln_dense_bwd<D, true>(x, gamma, beta, w, bias, dy, dx, dgamma, dbeta, dw, dbias,
                                 xn_ws, dg_ws, part, n_rows, dout, eps, splits, s);
  });
}
