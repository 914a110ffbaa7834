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
//
// Forward (1-3: ln_mlp_fwd_kernel). Bound on the H100: tensor-core
// throughput. At 36008 x 384 rows and a 1536-wide hidden layer a call is
// 4*N*384*1536 = 85 GFLOP (0.086 ms at 989 TFLOP/s) against 83 MB of
// activations in and out (0.025 ms at 3.35 TB/s); at D = 192 a quarter of
// the operations and half the bytes. W1 + W2 (2.36 MB bf16) sit in L2, and
// a block reads all of them once for its rows: 128 rows a block keep that to
// 0.66 GB of L2 reads a call at D = 384.
// Design (Hopper, warp-specialised as csrc/flash_packed.cu): a block of 384
// threads owns 128 rows. A producer warpgroup (registers lowered) loads the
// rows once by TMA, then walks the hidden dimension in HT-wide tiles (32 at
// D = 384, 64 at 192), keeping TMA loads of the W1 tile [HT, D] and the W2
// tile [D, HT] in two mbarrier rings. Two consumer warpgroups of 64 rows
// (registers raised to 240) hold their rows' [64, D] f32 fc2 accumulator in
// registers (192 a thread at D = 384) and per tile run g = xn W1^T on wgmma
// (A the rows in shared memory, B the W1 tile, both K-major; N = HT), add
// b1 and take the GELU in f32, round h to bf16, and run acc += h W2^T on
// wgmma (B the W2 tile, K-major; N = 192; A h from shared memory at D =
// 384, where the accumulator leaves no registers for it, else h's A
// fragments in registers). fc1 of tile j + 1 is issued beside fc2 of tile
// j, so the GELU of tile j + 1 runs under fc2 (and under the other
// warpgroup's products). LN2 runs in place on the rows as TMA landed them
// (f32 statistics, xn rounded to bf16); without LN the rows are fc1's input
// as they are. Once the rings drain, the producer loads the residual rows
// into them; the epilogue adds b2, scales by the gate and adds the residual
// in f32, writes y (rounded once) over the residual and, for the serving
// chain, LN_next of the f32 y (a row's sums over the quad of threads that
// holds it) over the warpgroup's rows, and TMA stores both. Rows past n_rows
// land as TMA's zeros and are not stored. The PERF.md findings of this
// kernel record what its registers forced (opaque values below that keep
// the compiler from holding addresses or loads across the loop).
#include <utility>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int FWD_THREADS = 384;  // two consumer warpgroups and the producer
constexpr int FWD_ROWS = 128;     // rows of a block, 64 per consumer
// setmaxnreg: 128 * 24 + 256 * 240 = 384 * 168, the 168 a thread of the
// block gets at launch
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int N2 = 192;  // the N of an fc2 product, and the rows of a W2 box

// The forward's tiles at width D in shared memory, from a 1024-byte
// boundary: the block's rows (D / 64 column blocks of [128][64], 128-byte
// rows as TMA swizzles them), S1 W1 tiles (D / 64 column blocks of
// [HT][64]), S2 W2 tiles ([D][HT], 2 * HT-byte rows), at D = 384 each
// consumer's h tile ([64][HT] bf16, fc2's A; 2 * HT-byte rows swizzled as
// TMA would land them), the barriers. Once the last products are done, the
// rings take the residual rows (laid out as the block's rows).
template <int D>
struct FwdTiles {
  static constexpr int HT = D == 384 ? 32 : 64;  // hidden tile: the N of fc1
  static constexpr int S1 = 3, S2 = D == 384 ? 2 : 3;  // slots of the W1, W2 rings
  static constexpr int RB2 = 2 * HT;           // bytes of a W2 or h tile row
  // At D = 384 the accumulator leaves few registers: fc2 reads h from
  // shared memory (not as A fragments beside the accumulator) and the GELU
  // takes one group of columns at a time; at 192 h stays in registers.
  static constexpr bool TIGHT = D == 384;
  static constexpr int XBLK = FWD_ROWS * 128;  // one 64-column block of the rows
  static constexpr int W1_TILE = HT * D * 2, W2_TILE = D * HT * 2;
  static constexpr int H_TILE = TIGHT ? 64 * HT * 2 : 0;
  static constexpr int W1 = D / 64 * XBLK, W2 = W1 + S1 * W1_TILE;
  static constexpr int H = W2 + S2 * W2_TILE, BARS = H + 2 * H_TILE;
  static constexpr int N_BARS = 4 + 2 * S1 + 2 * S2;
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;  // + alignment slack
  static_assert(D % N2 == 0 && BYTES <= 232448, "width outside the kernel's tiling");
  static_assert(D / 64 * XBLK <= H - W1, "the residual rows must fit in the rings");
};

__device__ __forceinline__ float2 bf16x2_at(const void* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The GELU of the forward: erf (the exact form, erff) or JAX's sigmoid form
// x / (1 + exp(-1.702 x)) with ex2.approx and the approximate divide (a few
// f32 ulp from the IEEE form; h is rounded to bf16 after it).
template <int GELU>
__device__ __forceinline__ float fwd_gelu(float v) {
  if constexpr (GELU == 0) return gelu<0>(v);
  return __fdividef(v, 1.f + __expf(-1.702f * v));
}

// Byte offset of column c (bf16) of row r in a tile of 64-column blocks of
// ROWS_ 128-byte rows, 16-byte chunks swizzled as TMA lands them (chunk ^ r
// % 8).
template <int ROWS_>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * ROWS_ * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// The same in a tile of RB-byte rows (64 or 128): chunk ^ (r / 2) % 4 or ^ r % 8.
template <int RB>
__device__ __forceinline__ int swz_row(int r, int c) {
  const int sw = RB == 128 ? (r & 7) : ((r >> 1) & 3);
  return r * RB + ((((c * 2) >> 4) ^ sw) << 4) + ((c * 2) & 15);
}

// g = GELU(g + b1) in place, b1 at the columns of this thread's
// accumulator values (8n + 2 t4 (+1)); with GROUPS, one group of four at a
// time, its bias loads where the group starts (else the compiler loads them
// all ahead, into registers the accumulator needs).
template <int GELU, bool GROUPS, int N>
__device__ __forceinline__ void bias_gelu(float (&g)[N], const float* __restrict__ bj) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    if constexpr (GROUPS) asm volatile("" : "+l"(bj));  // this group's loads here
    const float u = bj[8 * n], v = bj[8 * n + 1];
    g[4 * n + 0] = fwd_gelu<GELU>(g[4 * n + 0] + u);
    g[4 * n + 1] = fwd_gelu<GELU>(g[4 * n + 1] + v);
    g[4 * n + 2] = fwd_gelu<GELU>(g[4 * n + 2] + u);
    g[4 * n + 3] = fwd_gelu<GELU>(g[4 * n + 3] + v);
    if constexpr (GROUPS) hopper::fence_regs(g);
  }
}

// f(std::integral_constant<int, I>{}) for I = 0 .. N - 1, expanded by the
// compiler's front end. The epilogue's passes over the accumulator use it:
// as nested #pragma unroll loops the same passes spilled ~330 bytes at D =
// 384 with the LN_next epilogue (ptxas, CUDA 12.9); expanded, none.
template <typename F, int... I>
__device__ __forceinline__ void static_for_(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_(f, std::make_integer_sequence<int, N>{});
}

// The sum over the quad of threads that holds a row of an accumulator.
__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// A warpgroup's 64 rows of a D-wide tile (column blocks XBLK bytes apart)
// to map at row0, by TMA from one thread, after the warpgroup's writes.
template <int D, int XBLK>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, const uint8_t* tile, int row0,
                                           int wg, int wt) {
  hopper::fence_proxy_async();
  hopper::named_sync(1 + wg, 128);
  if (wt == 0) {
    for (int b = 0; b < D / 64; ++b) hopper::tma_store_2d(map, tile + b * XBLK, 64 * b, row0);
    hopper::bulk_commit();
  }
}

// LN_IN: fc1 reads LN2(x) (res is x); else x as it is. LN_OUT: the LN_next
// epilogue writes yn (gate is null); else y = res + gate * mlp, gate null
// for 1. mx reads x, mw1 W1 [hidden, D], mw2 W2 [D, hidden], mres the
// residual (x itself with LN), my and myn write y and yn.
template <int D, int GELU, bool LN_IN, bool LN_OUT>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    ln_mlp_fwd_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mw1,
                      const __grid_constant__ CUtensorMap mw2,
                      const __grid_constant__ CUtensorMap mres,
                      const __grid_constant__ CUtensorMap my,
                      const __grid_constant__ CUtensorMap myn, const float* __restrict__ g2,
                      const float* __restrict__ be2, const float* __restrict__ b1,
                      const float* __restrict__ b2, const float* __restrict__ gn,
                      const float* __restrict__ bn, const float* __restrict__ gate,
                      int n_rows, int hidden, float eps) {
  using L = FwdTiles<D>;
  constexpr int HT = L::HT, S1 = L::S1, S2 = L::S2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* xfull = bar;      // [2] the block's rows, one per consumer
  uint64_t* rfull = bar + 2;  // [2] the residual rows
  uint64_t* w1full = bar + 4;
  uint64_t* w1empty = w1full + S1;
  uint64_t* w2full = w1empty + S1;
  uint64_t* w2empty = w2full + S2;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int row0 = blockIdx.x * FWD_ROWS;
  const int tiles = hidden / HT;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&xfull[i], 1);
      hopper::mbar_init(&rfull[i], 1);
    }
    for (int s = 0; s < S1; ++s) {
      hopper::mbar_init(&w1full[s], 1);
      hopper::mbar_init(&w1empty[s], 8);  // one per consumer warp
    }
    for (int s = 0; s < S2; ++s) {
      hopper::mbar_init(&w2full[s], 1);
      hopper::mbar_init(&w2empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every load
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 256) {
      for (int h = 0; h < 2; ++h) {  // each consumer's 64 rows
        hopper::mbar_arrive_expect_tx(&xfull[h], 64 * D * 2);
        for (int b = 0; b < D / 64; ++b)
          hopper::tma_load_2d(sm + b * L::XBLK + h * 64 * 128, &mx, &xfull[h], 64 * b,
                              row0 + 64 * h);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s1 = j % S1, s2 = j % S2;
        hopper::mbar_wait(&w1empty[s1], ((j / S1) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&w1full[s1], L::W1_TILE);
        uint8_t* w1t = sm + L::W1 + s1 * L::W1_TILE;
        for (int b = 0; b < D / 64; ++b)
          hopper::tma_load_2d(w1t + b * HT * 128, &mw1, &w1full[s1], 64 * b, j * HT);
        hopper::mbar_wait(&w2empty[s2], ((j / S2) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&w2full[s2], L::W2_TILE);
        uint8_t* w2t = sm + L::W2 + s2 * L::W2_TILE;
        for (int q = 0; q < D / N2; ++q)
          hopper::tma_load_2d(w2t + q * N2 * L::RB2, &mw2, &w2full[s2], j * HT, N2 * q);
      }
      // every slot's last tile released: the residual rows into the rings
      for (int j = max(tiles - S1, 0); j < tiles; ++j)
        hopper::mbar_wait(&w1empty[j % S1], (j / S1) & 1);
      for (int j = max(tiles - S2, 0); j < tiles; ++j)
        hopper::mbar_wait(&w2empty[j % S2], (j / S2) & 1);
      for (int h = 0; h < 2; ++h) {
        hopper::mbar_arrive_expect_tx(&rfull[h], 64 * D * 2);
        for (int b = 0; b < D / 64; ++b)
          hopper::tma_load_2d(sm + L::W1 + b * L::XBLK + h * 64 * 128, &mres, &rfull[h], 64 * b,
                              row0 + 64 * h);
      }
    }
    return;
  }

  // consumers: 64 rows each
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wt = tid % 128, warp = wt / 32;
  const int g = lane >> 2, t4 = lane & 3;
  uint8_t* xs = sm + wg * 64 * 128;  // this consumer's rows in each column block
  hopper::mbar_wait(&xfull[wg], 0);
  if constexpr (LN_IN) {
    // xn = LN2(x) in place, a warp a row: lane l holds columns 2l, 2l + 1
    // of each 64-column block (16-byte chunk l / 4 of the row, swizzled)
    for (int rr = 0; rr < 16; ++rr) {
      const int r = 16 * warp + rr;
      uint8_t* row = xs + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + (lane & 3) * 4;
      float v[D / 32];
#pragma unroll
      for (int i = 0; i < D / 64; ++i) {
        const float2 p = bf16x2_at(row + i * L::XBLK);
        v[2 * i] = p.x;
        v[2 * i + 1] = p.y;
      }
      float mean, inv;
      warp_ln_stats(v, eps, mean, inv);
#pragma unroll
      for (int i = 0; i < D / 64; ++i) {
        const int c = 64 * i + 2 * lane;
        *reinterpret_cast<uint32_t*>(row + i * L::XBLK) =
            pack_bf16x2((v[2 * i] - mean) * inv * g2[c] + be2[c],
                        (v[2 * i + 1] - mean) * inv * g2[c + 1] + be2[c + 1]);
      }
    }
    hopper::fence_proxy_async();  // the wgmma reads below are async-proxy reads
    hopper::named_sync(1 + wg, 128);
  }

  float acc[D / N2][N2 / 2];  // fc2: row 16 warp + g (+8), columns N2 q + 8n + 2t4 (+1)
#pragma unroll
  for (int q = 0; q < D / N2; ++q)
#pragma unroll
    for (int i = 0; i < N2 / 2; ++i) acc[q][i] = 0.f;
  float gacc[HT / 2];                          // fc1 of one hidden tile
  uint32_t pa[L::TIGHT ? 1 : HT / 16][4];     // or h's A fragments (D = 192)
  uint8_t* hs = sm + L::H + wg * L::H_TILE;  // or its tile (D = 384)

  // Descriptors come from the shared address of the tiles, made opaque to
  // the compiler in each tile: else it keeps every k-step's descriptor live
  // across the loop, which the accumulator leaves no registers for.
  const uint32_t sbase = hopper::smem_u32(sm);
  auto fc1 = [&](int j) {  // gacc = xn W1[tile j]^T
    uint32_t a0 = sbase + wg * 64 * 128, b0 = sbase + L::W1 + (j % S1) * L::W1_TILE;
    asm volatile("" : "+r"(a0), "+r"(b0));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da =
          hopper::desc_kmajor_at<128>(a0 + (kk >> 2) * L::XBLK + (kk & 3) * 32);
      const uint64_t db = hopper::desc_kmajor_at<128>(b0 + (kk >> 2) * HT * 128 + (kk & 3) * 32);
      if constexpr (HT == 32)
        hopper::wgmma_ss_n32(gacc, da, db, kk > 0);
      else
        hopper::wgmma_ss_n64(gacc, da, db, kk > 0);
    }
  };
  auto fc2 = [&](int j) {  // acc += h W2[:, tile j]^T
    uint32_t a0 = sbase + L::H + wg * L::H_TILE, b0 = sbase + L::W2 + (j % S2) * L::W2_TILE;
    asm volatile("" : "+r"(a0), "+r"(b0));
#pragma unroll
    for (int kk = 0; kk < HT / 16; ++kk)
#pragma unroll
      for (int q = 0; q < D / N2; ++q) {
        const uint64_t db = hopper::desc_kmajor_at<L::RB2>(b0 + q * N2 * L::RB2 + kk * 32);
        if constexpr (L::TIGHT)
          hopper::wgmma_ss_n192(acc[q], hopper::desc_kmajor_at<L::RB2>(a0 + kk * 32), db, 1);
        else
          hopper::wgmma_rs_n192(acc[q], pa[kk], db, 1);
      }
  };
  auto store_h = [&]() {  // h as bf16 for fc2: its tile, or A fragments
    if constexpr (L::TIGHT) {
      // the row opaque to the compiler: else it keeps the tile's addresses
      // (the same in every tile) in registers across the loop
      int r = 16 * warp + g;
      asm volatile("" : "+r"(r));
#pragma unroll
      for (int n = 0; n < HT / 8; ++n) {
        const int c = 8 * n + 2 * t4;
        *reinterpret_cast<uint32_t*>(hs + swz_row<L::RB2>(r, c)) =
            pack_bf16x2(gacc[4 * n], gacc[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(hs + swz_row<L::RB2>(r + 8, c)) =
            pack_bf16x2(gacc[4 * n + 2], gacc[4 * n + 3]);
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
    } else {
      hopper::pack_a(pa, gacc);
    }
  };
  auto release = [&](uint64_t* b) {
    if (lane == 0) hopper::mbar_arrive(b);
  };
  auto landed = [&](uint64_t* full, int j, int stages) {
    hopper::mbar_wait(&full[j % stages], (j / stages) & 1);
  };
  auto settle = [&]() {  // every product issued so far has landed
    hopper::wgmma_wait<0>();
    hopper::fence_regs(gacc);
#pragma unroll
    for (int q = 0; q < D / N2; ++q) hopper::fence_regs(acc[q]);
  };

  landed(w1full, 0, S1);
  hopper::wgmma_fence();
  fc1(0);
  hopper::wgmma_commit();
  settle();
  release(&w1empty[0]);
  bias_gelu<GELU, L::TIGHT>(gacc, b1 + 2 * t4);
  store_h();
  for (int j = 0; j + 1 < tiles; ++j) {
    // fc1 of tile j + 1, then fc2 of tile j: the GELU of tile j + 1 runs
    // under fc2 (and the other consumer's products), and h takes the h
    // tile's place once fc2 has read it
    landed(w1full, j + 1, S1);
    landed(w2full, j, S2);
    hopper::wgmma_fence();
    fc1(j + 1);
    hopper::wgmma_commit();
    fc2(j);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(gacc);
    release(&w1empty[(j + 1) % S1]);
    bias_gelu<GELU, L::TIGHT>(gacc, b1 + (j + 1) * HT + 2 * t4);
    settle();
    release(&w2empty[j % S2]);
    store_h();
  }
  landed(w2full, tiles - 1, S2);
  hopper::wgmma_fence();
  fc2(tiles - 1);
  hopper::wgmma_commit();
  settle();
  release(&w2empty[(tiles - 1) % S2]);

  // epilogue: rows ra (this thread's e < 2 values) and rb = ra + 8
  const int ra = row0 + 64 * wg + 16 * warp + g, rb = ra + 8;
  float gta = 1.f, gtb = 1.f;
  if (!LN_OUT && gate != nullptr) {
    gta = ra < n_rows ? gate[ra] : 0.f;
    gtb = rb < n_rows ? gate[rb] : 0.f;
  }
  // the residual rows as the producer landed them in the rings; y takes
  // their place, yn this consumer's rows of the block's rows (free after its
  // last fc1), each stored by TMA (rows past n_rows are not written)
  uint8_t* rs = sm + L::W1 + wg * 64 * 128;
  const int la = 16 * warp + g, lb = la + 8;  // rows within this consumer's 64
  hopper::mbar_wait(&rfull[wg], 0);
  // column group i (columns 8i + 2 t4, + 1) of rows la, lb: acc[q][4n + e],
  // 8i = N2 q + 8n
  constexpr int NG = N2 / 8;
  // The parameter vectors are read through pointers made opaque every four
  // column groups: else the compiler loads every group's values at once,
  // ahead of the passes, into registers the accumulator holds.
  const float *b2p = b2, *gnp = gn, *bnp = bn;
  auto opaque = [&](auto i) {
    if constexpr (decltype(i)::value % 4 == 0) asm volatile("" : "+l"(b2p), "+l"(gnp), "+l"(bnp));
  };
  float sa = 0.f, sb = 0.f;
  static_for<D / 8>([&](auto i) {
    constexpr int q = decltype(i)::value / NG, n = decltype(i)::value % NG;
    const int c = 8 * decltype(i)::value + 2 * t4;
    opaque(i);
    const float2 bb = make_float2(b2p[c], b2p[c + 1]);
    const float2 xa = bf16x2_at(rs + swz<FWD_ROWS>(la, c));
    const float2 xb = bf16x2_at(rs + swz<FWD_ROWS>(lb, c));
    acc[q][4 * n] = (acc[q][4 * n] + bb.x) * gta + xa.x;
    acc[q][4 * n + 1] = (acc[q][4 * n + 1] + bb.y) * gta + xa.y;
    acc[q][4 * n + 2] = (acc[q][4 * n + 2] + bb.x) * gtb + xb.x;
    acc[q][4 * n + 3] = (acc[q][4 * n + 3] + bb.y) * gtb + xb.y;
    *reinterpret_cast<uint32_t*>(rs + swz<FWD_ROWS>(la, c)) =
        pack_bf16x2(acc[q][4 * n], acc[q][4 * n + 1]);
    *reinterpret_cast<uint32_t*>(rs + swz<FWD_ROWS>(lb, c)) =
        pack_bf16x2(acc[q][4 * n + 2], acc[q][4 * n + 3]);
    sa += acc[q][4 * n] + acc[q][4 * n + 1];
    sb += acc[q][4 * n + 2] + acc[q][4 * n + 3];
  });
  store_rows<D, L::XBLK>(&my, rs, row0 + 64 * wg, wg, wt);
  if constexpr (LN_OUT) {  // yn = LN_next(y) from the f32 y, centred in place
    const float ma = quad_sum(sa) * (1.f / D), mb = quad_sum(sb) * (1.f / D);
    float qa = 0.f, qb = 0.f;
    static_for<D / 8>([&](auto i) {
      constexpr int q = decltype(i)::value / NG, n = decltype(i)::value % NG;
      acc[q][4 * n] -= ma;
      acc[q][4 * n + 1] -= ma;
      acc[q][4 * n + 2] -= mb;
      acc[q][4 * n + 3] -= mb;
      qa += acc[q][4 * n] * acc[q][4 * n] + acc[q][4 * n + 1] * acc[q][4 * n + 1];
      qb += acc[q][4 * n + 2] * acc[q][4 * n + 2] + acc[q][4 * n + 3] * acc[q][4 * n + 3];
    });
    const float ia = rsqrtf(quad_sum(qa) * (1.f / D) + eps);
    const float ib = rsqrtf(quad_sum(qb) * (1.f / D) + eps);
    // the rows opaque again: else the compiler keeps y's addresses (the
    // same offsets) in registers from the first pass to this one
    int na = la, nb = lb;
    asm volatile("" : "+r"(na), "+r"(nb));
    static_for<D / 8>([&](auto i) {
      constexpr int q = decltype(i)::value / NG, n = decltype(i)::value % NG;
      const int c = 8 * decltype(i)::value + 2 * t4;
      opaque(i);
      const float2 gg = make_float2(gnp[c], gnp[c + 1]), bb = make_float2(bnp[c], bnp[c + 1]);
      *reinterpret_cast<uint32_t*>(xs + swz<FWD_ROWS>(na, c)) = pack_bf16x2(
          acc[q][4 * n] * ia * gg.x + bb.x, acc[q][4 * n + 1] * ia * gg.y + bb.y);
      *reinterpret_cast<uint32_t*>(xs + swz<FWD_ROWS>(nb, c)) = pack_bf16x2(
          acc[q][4 * n + 2] * ib * gg.x + bb.x, acc[q][4 * n + 3] * ib * gg.y + bb.y);
    });
    store_rows<D, L::XBLK>(&myn, xs, row0 + 64 * wg, wg, wt);
  }
  if (wt == 0) hopper::bulk_wait_read();  // the stores have read the tiles
}

// x and res are read through maps of [n_rows, D] in 64 x 64 boxes, W1 [hidden, D]
// in 64 x HT boxes and W2 [D, hidden] in HT x 192 boxes.
template <int D, int GELU, bool LN_IN, bool LN_OUT>
int launch(const void* x, const void* g2, const void* be2, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* gn, const void* bn, const void* gate,
           const void* res, void* y, void* yn, int n_rows, int hidden, float eps,
           cudaStream_t stream) {
  using L = FwdTiles<D>;
  if (hidden % L::HT != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw1, mw2, mres, my, myn;
  int err;
  if ((err = hopper::encode_2d(&mx, x, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&mres, res, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&my, y, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&myn, LN_OUT ? yn : y, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&mw1, w1, hidden, D, L::HT, 64)) ||
      (err = hopper::encode_2d(&mw2, w2, D, hidden, N2, L::HT)))
    return err;
  auto kernel = ln_mlp_fwd_kernel<D, GELU, LN_IN, LN_OUT>;
  static bool ok = false;  // the shared-memory limit is raised once
  if (!ok) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return (int)e;
    ok = true;
  }
  kernel<<<(n_rows + FWD_ROWS - 1) / FWD_ROWS, FWD_THREADS, L::BYTES, stream>>>(
      mx, mw1, mw2, mres, my, myn, (const float*)g2, (const float*)be2, (const float*)b1, (const float*)b2,
      (const float*)gn, (const float*)bn, (const float*)gate, n_rows, hidden, eps);
  return (int)cudaGetLastError();
}

// One entry per (D, LN_IN, LN_OUT) variant: gelu_mode 0 = exact erf GELU,
// 1 = x / (1 + exp(-1.702 x)).
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

// The backward's tiling (below): 64 rows a block, 64-wide hidden tiles,
// padded row strides (bank-conflict-free 32-bit fragment loads).
constexpr int ROWS = 64;
constexpr int HT = 64;
constexpr int LDH = HT + 8;

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
