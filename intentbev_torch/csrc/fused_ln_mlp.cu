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
#include <algorithm>
#include <utility>

#include "common.cuh"
#include "hopper.cuh"
#include "ln_kernels.cuh"

namespace {

constexpr int FWD_THREADS = 384;  // two consumer warpgroups and the producer
constexpr int FWD_ROWS = 128;     // rows of a block, 64 per consumer
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

// The GELU of the forward: erf (the exact form, erff) or JAX's sigmoid form
// x / (1 + exp(-1.702 x)) with ex2.approx and the approximate divide (a few
// f32 ulp from the IEEE form; h is rounded to bf16 after it).
template <int GELU>
__device__ __forceinline__ float fwd_gelu(float v) {
  if constexpr (GELU == 0) return gelu<0>(v);
  return __fdividef(v, 1.f + __expf(-1.702f * v));
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
    ln_in_place<D, L::XBLK>(xs, warp, lane, g2, be2, eps);  // xn = LN2(x)
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

}  // namespace

// hidden must be a multiple of 64 in every entry; d (the width of x) is
// 384 or 192.
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
                             int n_rows, int d, int hidden, int gelu_mode, void* stream) {
  return by_width(d, [&](auto w) {
    return dispatch<decltype(w)::value, false, false>(gelu_mode, h, nullptr, nullptr, w1, b1,
                                                      w2, b2, nullptr, nullptr, gate, res, y,
                                                      nullptr, n_rows, hidden, 0.f, stream);
  });
}


// ---------------------------------------------------------------------------
// 4. Training backward. Replaces intentbev/ops/fused_ln_mlp.py::_bwd_kernel:
//      recompute xhat, inv, xn = LN2(x), g = xn W1^T + b1, h = GELU(g)
//      dy_eff = dy * gate;  dh = dy_eff W2;  dg = dh * GELU'(g)
//      dxn = dg W1;  dgamma = sum dxn * xhat;  dbeta = sum dxn
//      dx = inv * (dxn*gamma - mean(dxn*gamma) - xhat * mean(dxn*gamma*xhat)) + dy
//      dW1 = dg^T xn;  db1 = sum dg;  dW2 = dy_eff^T h;  db2 = sum dy_eff
// with the JAX kernel's rounding points: xn, dy_eff, h and dg are rounded to
// bf16 before they enter a product, the products accumulate in f32, and db1
// and db2 sum the f32 dg and dy_eff (not the bf16 copies that the dW
// products read: summing those would move db1's rounding point).
// Without LN (LN_IN false) it replaces intentbev/ops/fused_mlp.py::_bwd_kernel:
// xn is x as it is, and dx is dxn rounded once (the residual's gradient, dy,
// is added by autograd).
// Bound on the H100: tensor-core throughput. At 36008 rows, D = 384 and a
// 1536-wide hidden layer the five products are 5 * 2*N*D*H = 212 GFLOP
// (0.215 ms at 989 TFLOP/s; the row kernel recomputes g, a sixth); a quarter
// of that at D = 192, hidden 768.
// Design. The TPU kernel accumulates dW1 and dW2 (2.36 MB f32 each) in VMEM
// across a sequential row grid, which 132 SMs running in parallel cannot; so
// two kernels, both warp-specialised on wgmma fed by TMA:
//  (a) ln_mlp_bwd_kernel: a block of 384 threads owns 64 rows (128 rows of xn
//      and dy_eff would fill 192 KB of shared memory at D = 384 and leave no
//      room for a weight tile). A producer warpgroup loads x and dy once by
//      TMA, then walks the hidden dimension in 32-wide tiles, keeping TMA
//      loads of the W1 tile [32, D] and the W2 tile [D, 32] in two 2-slot
//      mbarrier rings. The two consumer warpgroups share the block's rows and
//      split each tile's work: consumer 0 runs g = xn W1_tile^T (m64n32, B
//      K-major), consumer 1 dh = dy_eff W2_tile (m64n32, B MN-major); they
//      exchange g + b1 and dh in f32 through shared memory, each takes the
//      GELU, GELU' and dg of 16 of the tile's columns, and both round h and
//      dg into bf16 tiles that TMA stores to h_ws / dg_ws. Then each runs
//      dxn[:, its half] += dg W1_tile[:, its half] (m64n(D/2): A the dg tile,
//      B the same W1 tile read MN-major across three column boxes), so its
//      f32 accumulator is [64, D/2] (96 registers at D = 384, 192 at 768,
//      where 64 rows of xn and dy_eff alone would fill 192 KB of shared
//      memory). The next tile's g / dh is issued beside this
//      tile's dxn, after its GELU. LN2 and dy_eff are taken in place as
//      the rows land and TMA-stored to xn_ws / dye_ws for (b). Once the rings
//      drain the producer loads x and dy again into them for the epilogue: the
//      LN backward per row (its row sums added across the two consumers
//      through shared memory), dx stored by TMA.
//  (b) dw_gemm_kernel: C = P^T Q over the rows for dW1 = dg^T xn and dW2 =
//      dy_eff^T h, both in one launch: 128 x 192 output tiles on two consumer
//      warpgroups (m64n192, A and B both MN-major: TMA boxes of the row-major
//      P and Q as they land), a producer warpgroup keeping TMA loads of
//      64-row chunks in a 4-slot ring, and the rows split so that the grid
//      fills whole waves of the card's SMs; f32 partials per split.
// Block partials (db1, dgamma, dbeta, db2) and split partials (dW1, dW2) are
// summed in a fixed order (col_sums_kernel, split_sums_kernel): the result is
// deterministic, with no atomics. Rows past n_rows land as TMA's zeros (dy =
// 0, so dg and dxn are 0) and are not stored.
// ---------------------------------------------------------------------------
namespace {

constexpr int BWD_THREADS = 384;
constexpr int BWD_ROWS = 64;  // rows of a block, shared by both consumers
constexpr int BHT = 32;       // hidden tile
constexpr int W2_BOX = 192;   // rows of a W2 box (TMA boxes take at most 256)

// The row kernel's shared memory at width D, from a 1024-byte boundary: xn
// and dy_eff (D / 64 column blocks of [64][64], 128-byte rows as TMA swizzles
// them), the W1 ring (slots of D / W1C boxes [32][W1C]), the W2 ring (slots
// [D][32], 64-byte rows), the f32 exchange tiles (g + b1, dh), the bf16 dg
// and h tiles ([64][32], 64-byte rows swizzled as TMA stores them), db1's
// warp partials, the rows' LN statistics and row sums, the barriers. Once
// the rings drain they take x and dy again (laid out as xn).
template <int D>
struct BwdTiles {
  static constexpr int S = 2;                  // slots of each weight ring
  static constexpr int NH = D / 2;             // dxn columns of a consumer
  static constexpr int W1C = D / 6;            // columns of a W1 box: NH spans 3
  static constexpr int W1RB = 2 * W1C;         // bytes of a W1 box row (128 or 64)
  static constexpr int W1BOX = BHT * W1RB;
  static constexpr int XBLK = BWD_ROWS * 128;  // one 64-column block of the rows
  static constexpr int ROWS_B = D / 64 * XBLK;
  static constexpr int W1_TILE = BHT * D * 2, W2_TILE = D * BHT * 2;
  static constexpr int EX_LD = BHT + 4;        // floats a row of an exchange tile
  static constexpr int EX_B = BWD_ROWS * EX_LD * 4;
  static constexpr int XN = 0, DYE = ROWS_B, W1 = 2 * ROWS_B, W2 = W1 + S * W1_TILE;
  static constexpr int EX = W2 + S * W2_TILE;
  static constexpr int DG = EX + 2 * EX_B, H = DG + BWD_ROWS * BHT * 2;
  static constexpr int RED = H + BWD_ROWS * BHT * 2;     // [2 consumers][4 warps][16]
  static constexpr int STATS = RED + 2 * 4 * 16 * 4;     // mean [64], inv [64]
  static constexpr int RSUM = STATS + 2 * BWD_ROWS * 4;  // [2 consumers][64][2]
  static constexpr int BARS = RSUM + 2 * BWD_ROWS * 2 * 4;
  static constexpr int N_BARS = 2 + 4 * S;
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;  // + alignment slack
  static_assert(D % W2_BOX == 0 && W1C % 32 == 0 && W1RB <= 128 && BYTES <= 232448,
                "width outside the kernel's tiling");
  static_assert(S * W1_TILE == ROWS_B && S * W2_TILE == ROWS_B,
                "x and dy reload into the drained rings");
  static_assert(8 * D * 4 <= 2 * EX_B, "the column partials fit in the exchange tiles");
};

// LN_IN: x is LN2's input (xn = LN2(x) is stored to xn_ws, dx is the LN
// backward + dy, dgamma's and dbeta's partials are written); else x is the
// MLP's input itself and dx = dxn. Maps: mx / mdy / mxn / mdye / mdx [n_rows,
// D] in 64 x 64 boxes, mw1 W1 [hidden, D] in 32 x W1C boxes, mw2 W2 [D,
// hidden] in 192 x 32 boxes, mh / mdg [n_rows, hidden] in 64 x 32 boxes.
// part_db1 [blocks][hidden] and part_cols [3][blocks][D] (dgamma, dbeta,
// db2) take the block partials.
template <int D, bool LN_IN>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    ln_mlp_bwd_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mdy,
                      const __grid_constant__ CUtensorMap mw1,
                      const __grid_constant__ CUtensorMap mw2,
                      const __grid_constant__ CUtensorMap mxn,
                      const __grid_constant__ CUtensorMap mdye,
                      const __grid_constant__ CUtensorMap mh,
                      const __grid_constant__ CUtensorMap mdg,
                      const __grid_constant__ CUtensorMap mdx, const float* __restrict__ g2,
                      const float* __restrict__ be2, const float* __restrict__ b1,
                      const float* __restrict__ gate, float* __restrict__ part_db1,
                      float* __restrict__ part_cols, int n_rows, int hidden, float eps) {
  using L = BwdTiles<D>;
  constexpr int S = L::S, KB = L::W1C / 16;  // k-steps of 16 in a W1 box row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* rows_full = bar;   // x and dy
  uint64_t* again_full = bar + 1;  // x and dy again, for the LN epilogue
  uint64_t* w1full = bar + 2;
  uint64_t* w1empty = w1full + S;
  uint64_t* w2full = w1empty + S;
  uint64_t* w2empty = w2full + S;
  float* ex = reinterpret_cast<float*>(sm + L::EX);
  float* red = reinterpret_cast<float*>(sm + L::RED);
  float* stats = reinterpret_cast<float*>(sm + L::STATS);
  float* rsum = reinterpret_cast<float*>(sm + L::RSUM);

  // the warpgroup through a shuffle: warp-uniform to the compiler, which
  // otherwise takes the consumers' branches for divergent paths and
  // serialises their wgmma
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0), lane = tid % 32;
  const int row0 = blockIdx.x * BWD_ROWS, nb = gridDim.x;
  const int tiles = hidden / BHT;
  if (tid == 0) {
    hopper::mbar_init(rows_full, 1);
    hopper::mbar_init(again_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&w1full[s], 1);
      hopper::mbar_init(&w1empty[s], 8);  // each consumer warp, after its dxn product
      hopper::mbar_init(&w2full[s], 1);
      hopper::mbar_init(&w2empty[s], 4);  // consumer 1's warps, after dh
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every load
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 256) {
      hopper::mbar_arrive_expect_tx(rows_full, 2 * L::ROWS_B);
      for (int b = 0; b < D / 64; ++b) {
        hopper::tma_load_2d(sm + L::XN + b * L::XBLK, &mx, rows_full, 64 * b, row0);
        hopper::tma_load_2d(sm + L::DYE + b * L::XBLK, &mdy, rows_full, 64 * b, row0);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % S;
        const uint32_t ph = ((j / S) & 1) ^ 1;
        hopper::mbar_wait(&w1empty[s], ph);
        hopper::mbar_arrive_expect_tx(&w1full[s], L::W1_TILE);
        uint8_t* w1t = sm + L::W1 + s * L::W1_TILE;
        for (int b = 0; b < D / L::W1C; ++b)
          hopper::tma_load_2d(w1t + b * L::W1BOX, &mw1, &w1full[s], b * L::W1C, j * BHT);
        hopper::mbar_wait(&w2empty[s], ph);
        hopper::mbar_arrive_expect_tx(&w2full[s], L::W2_TILE);
        uint8_t* w2t = sm + L::W2 + s * L::W2_TILE;
        for (int q = 0; q < D / W2_BOX; ++q)
          hopper::tma_load_2d(w2t + q * W2_BOX * 64, &mw2, &w2full[s], j * BHT, q * W2_BOX);
      }
      if constexpr (LN_IN) {  // every slot's last tile released: x and dy again
        for (int j = max(tiles - S, 0); j < tiles; ++j) {
          hopper::mbar_wait(&w1empty[j % S], (j / S) & 1);
          hopper::mbar_wait(&w2empty[j % S], (j / S) & 1);
        }
        hopper::mbar_arrive_expect_tx(again_full, 2 * L::ROWS_B);
        for (int b = 0; b < D / 64; ++b) {
          hopper::tma_load_2d(sm + L::W1 + b * L::XBLK, &mx, again_full, 64 * b, row0);
          hopper::tma_load_2d(sm + L::W2 + b * L::XBLK, &mdy, again_full, 64 * b, row0);
        }
      }
    }
    return;
  }

  // consumers: both on the block's 64 rows
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wt = tid % 128, warp = wt / 32, cw = tid / 32;  // cw: warp of both, 0..7
  const int g = lane >> 2, t4 = lane & 3;
  const bool issuer = tid == 0;  // issues the TMA stores
  const uint32_t sbase = hopper::smem_u32(sm);

  // 1. xn = LN2(x) (or x) and dy_eff = dy * gate in place, a warp a row: lane
  //    l holds columns 2l, 2l + 1 of each 64-column block; db2's partials
  //    from the f32 dy_eff
  hopper::mbar_wait(rows_full, 0);
  float cd[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) cd[i] = 0.f;
  for (int rr = 0; rr < BWD_ROWS / 8; ++rr) {
    const int r = (BWD_ROWS / 8) * cw + rr, grow = row0 + r;
    const int off = r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + (lane & 3) * 4;
    if constexpr (LN_IN) {
      uint8_t* xr = sm + L::XN + off;
      float v[D / 32];
#pragma unroll
      for (int i = 0; i < D / 64; ++i) {
        const float2 p = bf16x2_at(xr + i * L::XBLK);
        v[2 * i] = p.x;
        v[2 * i + 1] = p.y;
      }
      float mean, inv;
      warp_ln_stats(v, eps, mean, inv);
#pragma unroll
      for (int i = 0; i < D / 64; ++i) {
        const int c = 64 * i + 2 * lane;
        *reinterpret_cast<uint32_t*>(xr + i * L::XBLK) =
            pack_bf16x2((v[2 * i] - mean) * inv * g2[c] + be2[c],
                        (v[2 * i + 1] - mean) * inv * g2[c + 1] + be2[c + 1]);
      }
      if (lane == 0) {
        stats[r] = mean;
        stats[BWD_ROWS + r] = inv;
      }
    }
    const float gt = grow < n_rows ? (gate != nullptr ? gate[grow] : 1.f) : 0.f;
    uint8_t* dr = sm + L::DYE + off;
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const float2 p = bf16x2_at(dr + i * L::XBLK);
      const float a = p.x * gt, b = p.y * gt;
      cd[2 * i] += a;
      cd[2 * i + 1] += b;
      *reinterpret_cast<uint32_t*>(dr + i * L::XBLK) = pack_bf16x2(a, b);
    }
  }
  hopper::fence_proxy_async();  // the wgmma reads and TMA stores are async-proxy reads
  hopper::named_sync(3, 256);
  if (issuer) {  // xn and dy_eff for the dW products
    for (int b = 0; b < D / 64; ++b) {
      if constexpr (LN_IN) hopper::tma_store_2d(&mxn, sm + L::XN + b * L::XBLK, 64 * b, row0);
      hopper::tma_store_2d(&mdye, sm + L::DYE + b * L::XBLK, 64 * b, row0);
    }
    hopper::bulk_commit();
  }
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {  // db2: the warps' sums, added in warp order
    ex[cw * D + 64 * i + 2 * lane] = cd[2 * i];
    ex[cw * D + 64 * i + 2 * lane + 1] = cd[2 * i + 1];
  }
  hopper::named_sync(3, 256);
  for (int c = tid; c < D; c += 256) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += ex[w * D + c];
    part_cols[((size_t)2 * nb + blockIdx.x) * D + c] = s;
  }
  hopper::named_sync(3, 256);  // the exchange tiles are free again

  // 2. the hidden tiles
  float acc[L::NH / 2];  // dxn: row 16 warp + g (+8), column NH wg + 8n + 2t4 (+1)
#pragma unroll
  for (int i = 0; i < L::NH / 2; ++i) acc[i] = 0.f;
  float pacc[BHT / 2];  // g (consumer 0) or dh (consumer 1) of one tile

  // Descriptors come from the tiles' shared addresses made opaque in each
  // tile: else the compiler keeps every k-step's descriptor live across the
  // loop.
  auto product = [&](int j) {
    const int s = j % S;
    if (wg == 0) {  // g = xn W1[tile]^T
      uint32_t a0 = sbase + L::XN, b0 = sbase + L::W1 + s * L::W1_TILE;
      asm volatile("" : "+r"(a0), "+r"(b0));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da =
            hopper::desc_kmajor_at<128>(a0 + (kk >> 2) * L::XBLK + (kk & 3) * 32);
        const uint64_t db =
            hopper::desc_kmajor_at<L::W1RB>(b0 + (kk / KB) * L::W1BOX + (kk % KB) * 32);
        hopper::wgmma_sst<BHT, 0, 0>(pacc, da, db, kk > 0);
      }
    } else {  // dh = dy_eff W2[:, tile]
      uint32_t a0 = sbase + L::DYE, b0 = sbase + L::W2 + s * L::W2_TILE;
      asm volatile("" : "+r"(a0), "+r"(b0));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da =
            hopper::desc_kmajor_at<128>(a0 + (kk >> 2) * L::XBLK + (kk & 3) * 32);
        const uint64_t db = hopper::desc_mnmajor_at<64>(b0 + kk * 16 * 64, 8 * 64);
        hopper::wgmma_sst<BHT, 0, 1>(pacc, da, db, kk > 0);
      }
    }
  };
  auto dxn = [&](int j) {  // acc += dg W1[tile, this consumer's half]
    uint32_t a0 = sbase + L::DG, b0 = sbase + L::W1 + (j % S) * L::W1_TILE + 3 * wg * L::W1BOX;
    asm volatile("" : "+r"(a0), "+r"(b0));
#pragma unroll
    for (int kk = 0; kk < BHT / 16; ++kk) {
      const uint64_t da = hopper::desc_kmajor_at<64>(a0 + kk * 32);
      const uint64_t db = hopper::desc_mnmajor_at<L::W1RB>(b0 + kk * 16 * L::W1RB, L::W1BOX);
      hopper::wgmma_sst<L::NH, 0, 1>(acc, da, db, 1);
    }
  };
  // b1 at this thread's columns of tile j (consumer 0; consumer 1's dh
  // takes no bias), loaded ahead of the product that needs it
  float2 bias[BHT / 8];
  auto load_bias = [&](int j) {
#pragma unroll
    for (int n = 0; n < BHT / 8; ++n)
      bias[n] = wg == 0 ? *reinterpret_cast<const float2*>(b1 + j * BHT + 8 * n + 2 * t4)
                        : make_float2(0.f, 0.f);
  };
  auto exchange = [&]() {  // g + b1 or dh, f32, to this consumer's exchange tile
    float* e = ex + wg * (L::EX_B / 4);
    const int ra = 16 * warp + g;
#pragma unroll
    for (int n = 0; n < BHT / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(e + ra * L::EX_LD + c) =
          make_float2(pacc[4 * n] + bias[n].x, pacc[4 * n + 1] + bias[n].y);
      *reinterpret_cast<float2*>(e + (ra + 8) * L::EX_LD + c) =
          make_float2(pacc[4 * n + 2] + bias[n].x, pacc[4 * n + 3] + bias[n].y);
    }
  };
  // h = GELU(t), dg = dh * GELU'(t) of 8 columns of one row (t = g + b1),
  // rounded into the h and dg tiles; db1's partials from the f32 dg
  auto elementwise = [&](int j) {
    const int r = wt >> 1, c0 = 16 * wg + 8 * (wt & 1);
    const float* te = ex + r * L::EX_LD + c0;
    const float* de = te + L::EX_B / 4;
    const float4 t0 = *reinterpret_cast<const float4*>(te);
    const float4 t1 = *reinterpret_cast<const float4*>(te + 4);
    const float4 d0 = *reinterpret_cast<const float4*>(de);
    const float4 d1 = *reinterpret_cast<const float4*>(de + 4);
    const float t[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
    float dg[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    uint32_t hp[4], gp[4];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      float hv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = t[i + e], cdf = 0.5f * (1.f + erff(v * 0.70710678118654752f));
        hv[e] = v * cdf;
        dg[i + e] *= cdf + v * 0.3989422804014327f * expf(-0.5f * v * v);
      }
      hp[i / 2] = pack_bf16x2(hv[0], hv[1]);
      gp[i / 2] = pack_bf16x2(dg[i], dg[i + 1]);
    }
    *reinterpret_cast<uint4*>(sm + L::H + swz_row<64>(r, c0)) =
        make_uint4(hp[0], hp[1], hp[2], hp[3]);
    *reinterpret_cast<uint4*>(sm + L::DG + swz_row<64>(r, c0)) =
        make_uint4(gp[0], gp[1], gp[2], gp[3]);
#pragma unroll
    for (int i = 0; i < 8; ++i)  // the warp's 16 rows (lanes of one parity)
#pragma unroll
      for (int o = 2; o <= 16; o <<= 1) dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], o);
    if (lane < 2) {
#pragma unroll
      for (int i = 0; i < 8; ++i) red[(wg * 4 + warp) * 16 + 8 * lane + i] = dg[i];
    }
    hopper::named_sync(1 + wg, 128);
    if (wt < 16) {
      const float* rw = red + wg * 4 * 16 + wt;
      part_db1[(size_t)blockIdx.x * hidden + j * BHT + 16 * wg + wt] =
          ((rw[0] + rw[16]) + rw[32]) + rw[48];
    }
  };
  auto release = [&](uint64_t* b) {
    if (lane == 0) hopper::mbar_arrive(b);
  };
  auto landed = [&](uint64_t* full, int j) { hopper::mbar_wait(&full[j % S], (j / S) & 1); };

  // tile j: its GELU, then its dxn product and (with `more`) the next tile's
  // g / dh product back to back. The next tile's W1 slot is freed only by
  // dxn of tile j - 1, so the GELU's time is the slack its TMA load needs
  // (issued before the GELU, g waited out every load; dh alone before the
  // GELU was 12 % slower). The last tile is peeled: ptxas serialises wgmma
  // whose waits sit under a condition.
  auto step = [&](int j, auto more) {
    constexpr bool MORE = decltype(more)::value;
    // the exchange tiles hold tile j; both consumers' dxn of tile j - 1 and
    // the TMA stores of its dg and h tiles are done with those tiles
    hopper::named_sync(3, 256);
    if constexpr (MORE) load_bias(j + 1);
    elementwise(j);
    hopper::fence_proxy_async();
    hopper::named_sync(4, 256);  // the dg and h tiles are whole
    if (issuer) {
      hopper::tma_store_2d(&mh, sm + L::H, j * BHT, row0);
      hopper::tma_store_2d(&mdg, sm + L::DG, j * BHT, row0);
      hopper::bulk_commit();
    }
    if (wg == 1) landed(w1full, j);
    hopper::wgmma_fence();
    dxn(j);
    hopper::wgmma_commit();
    if constexpr (MORE) {
      landed(wg == 0 ? w1full : w2full, j + 1);
      product(j + 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // dxn of tile j: its W1 slot is free
      release(&w1empty[j % S]);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(pacc);
      if (wg == 1) release(&w2empty[(j + 1) % S]);
      exchange();
    } else {
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(&w1empty[j % S]);
    }
    if (issuer) hopper::bulk_wait_read();
  };

  load_bias(0);
  landed(wg == 0 ? w1full : w2full, 0);
  hopper::wgmma_fence();
  product(0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(pacc);
  if (wg == 1) release(&w2empty[0]);
  exchange();
  for (int j = 0; j + 1 < tiles; ++j) step(j, std::true_type{});
  step(tiles - 1, std::false_type{});

  // 3. epilogue: rows la, lb = la + 8 of this thread's values; dx over xn
  //    (the issuer's stores have read it), stored by TMA
  const int la = 16 * warp + g, lb = la + 8;
  const int cbase = wg * L::NH;
  uint8_t* dxs = sm + L::XN;
  if constexpr (LN_IN) {
    hopper::mbar_wait(again_full, 0);
    const uint8_t* xs = sm + L::W1;
    const uint8_t* dys = sm + L::W2;
    const float ma = stats[la], ia = stats[BWD_ROWS + la];
    const float mb = stats[lb], ib = stats[BWD_ROWS + lb];
    // this consumer's half of the row sums of dyg = dxn gamma and dyg xhat
    // The rows and the gamma pointer are made opaque to the compiler at each
    // pass (the pointer every four column groups): else it keeps the
    // passes' shared addresses or loads ahead in registers the accumulator
    // needs (a 300-byte spill at D = 384).
    const float* gp = g2;
    auto opaque = [&](auto i) {
      if constexpr (decltype(i)::value % 4 == 0) asm volatile("" : "+l"(gp));
    };
    int ra_ = la, rb_ = lb;
    asm volatile("" : "+r"(ra_), "+r"(rb_));
    float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
    static_for<L::NH / 8>([&](auto i) {
      constexpr int n = decltype(i)::value;
      const int c = cbase + 8 * n + 2 * t4;
      opaque(i);
      const float2 gg = make_float2(gp[c], gp[c + 1]);
      const float2 xa = bf16x2_at(xs + swz<BWD_ROWS>(ra_, c));
      const float2 xb = bf16x2_at(xs + swz<BWD_ROWS>(rb_, c));
      const float ya0 = acc[4 * n] * gg.x, ya1 = acc[4 * n + 1] * gg.y;
      const float yb0 = acc[4 * n + 2] * gg.x, yb1 = acc[4 * n + 3] * gg.y;
      s1a += ya0 + ya1;
      s1b += yb0 + yb1;
      s2a += ya0 * ((xa.x - ma) * ia) + ya1 * ((xa.y - ma) * ia);
      s2b += yb0 * ((xb.x - mb) * ib) + yb1 * ((xb.y - mb) * ib);
    });
    s1a = quad_sum(s1a);
    s2a = quad_sum(s2a);
    s1b = quad_sum(s1b);
    s2b = quad_sum(s2b);
    if (t4 == 0) {
      rsum[(wg * BWD_ROWS + la) * 2] = s1a;
      rsum[(wg * BWD_ROWS + la) * 2 + 1] = s2a;
      rsum[(wg * BWD_ROWS + lb) * 2] = s1b;
      rsum[(wg * BWD_ROWS + lb) * 2 + 1] = s2b;
    }
    hopper::named_sync(3, 256);
    const float m1a = (rsum[la * 2] + rsum[(BWD_ROWS + la) * 2]) * (1.f / D);
    const float m2a = (rsum[la * 2 + 1] + rsum[(BWD_ROWS + la) * 2 + 1]) * (1.f / D);
    const float m1b = (rsum[lb * 2] + rsum[(BWD_ROWS + lb) * 2]) * (1.f / D);
    const float m2b = (rsum[lb * 2 + 1] + rsum[(BWD_ROWS + lb) * 2 + 1]) * (1.f / D);
    float* cs = ex + (wg * 4 + warp) * L::NH * 2;  // [NH][2]: dgamma, dbeta of the warp
    asm volatile("" : "+r"(ra_), "+r"(rb_));
    static_for<L::NH / 8>([&](auto i) {
      constexpr int n = decltype(i)::value;
      const int c = cbase + 8 * n + 2 * t4;
      opaque(i);
      const float2 gg = make_float2(gp[c], gp[c + 1]);
      const float2 xa = bf16x2_at(xs + swz<BWD_ROWS>(ra_, c));
      const float2 xb = bf16x2_at(xs + swz<BWD_ROWS>(rb_, c));
      const float2 da = bf16x2_at(dys + swz<BWD_ROWS>(ra_, c));
      const float2 db = bf16x2_at(dys + swz<BWD_ROWS>(rb_, c));
      const float ha0 = (xa.x - ma) * ia, ha1 = (xa.y - ma) * ia;
      const float hb0 = (xb.x - mb) * ib, hb1 = (xb.y - mb) * ib;
      *reinterpret_cast<uint32_t*>(dxs + swz<BWD_ROWS>(ra_, c)) =
          pack_bf16x2(ia * (acc[4 * n] * gg.x - m1a - ha0 * m2a) + da.x,
                      ia * (acc[4 * n + 1] * gg.y - m1a - ha1 * m2a) + da.y);
      *reinterpret_cast<uint32_t*>(dxs + swz<BWD_ROWS>(rb_, c)) =
          pack_bf16x2(ib * (acc[4 * n + 2] * gg.x - m1b - hb0 * m2b) + db.x,
                      ib * (acc[4 * n + 3] * gg.y - m1b - hb1 * m2b) + db.y);
      float cg0 = acc[4 * n] * ha0 + acc[4 * n + 2] * hb0;
      float cg1 = acc[4 * n + 1] * ha1 + acc[4 * n + 3] * hb1;
      float cb0 = acc[4 * n] + acc[4 * n + 2], cb1 = acc[4 * n + 1] + acc[4 * n + 3];
#pragma unroll
      for (int o = 4; o <= 16; o <<= 1) {  // the warp's 16 rows
        cg0 += __shfl_xor_sync(0xffffffffu, cg0, o);
        cg1 += __shfl_xor_sync(0xffffffffu, cg1, o);
        cb0 += __shfl_xor_sync(0xffffffffu, cb0, o);
        cb1 += __shfl_xor_sync(0xffffffffu, cb1, o);
      }
      if (g == 0)
        *reinterpret_cast<float4*>(cs + (8 * n + 2 * t4) * 2) = make_float4(cg0, cb0, cg1, cb1);
    });
    hopper::fence_proxy_async();
    hopper::named_sync(3, 256);
    if (issuer) {
      for (int b = 0; b < D / 64; ++b) hopper::tma_store_2d(&mdx, dxs + b * L::XBLK, 64 * b, row0);
      hopper::bulk_commit();
    }
    for (int c = tid; c < D; c += 256) {  // the warps' column sums, in warp order
      const float* w0 = ex + (c / L::NH) * 4 * L::NH * 2 + (c % L::NH) * 2;
      float sg = 0.f, sb = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        sg += w0[w * L::NH * 2];
        sb += w0[w * L::NH * 2 + 1];
      }
      part_cols[(size_t)blockIdx.x * D + c] = sg;
      part_cols[((size_t)nb + blockIdx.x) * D + c] = sb;
    }
  } else {
    static_for<L::NH / 8>([&](auto i) {
      constexpr int n = decltype(i)::value;
      const int c = cbase + 8 * n + 2 * t4;
      *reinterpret_cast<uint32_t*>(dxs + swz<BWD_ROWS>(la, c)) =
          pack_bf16x2(acc[4 * n], acc[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(dxs + swz<BWD_ROWS>(lb, c)) =
          pack_bf16x2(acc[4 * n + 2], acc[4 * n + 3]);
    });
    hopper::fence_proxy_async();
    hopper::named_sync(3, 256);
    if (issuer) {
      for (int b = 0; b < D / 64; ++b) hopper::tma_store_2d(&mdx, dxs + b * L::XBLK, 64 * b, row0);
      hopper::bulk_commit();
    }
  }
  if (issuer) hopper::bulk_wait_read();
}

// Both backwards: the row kernel, the block partials' sums, then dW1 = dg^T
// xn (xn is x itself without LN) and dW2 = dy_eff^T h, and their sums.
template <int D, bool LN_IN>
int mlp_bwd(const void* x, const void* g2, const void* be2, const void* w1, const void* b1,
            const void* w2, const void* gate, const void* dy, void* dx, void* dgamma,
            void* dbeta, void* dw1, void* db1, void* dw2, void* db2, void* xn_ws,
            void* dye_ws, void* h_ws, void* dg_ws, void* part, int n_rows, int hidden,
            float eps, int splits, void* stream) {
  using L = BwdTiles<D>;
  if (n_rows <= 0) return (int)cudaGetLastError();
  if (hidden % BHT != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* xn = LN_IN ? xn_ws : x;
  CUtensorMap mx, mdy, mw1, mw2, mxn, mdye, mh, mdg, mdx;
  int err;
  if ((err = hopper::encode_2d(&mx, x, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&mdy, dy, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&mw1, w1, hidden, D, BHT, L::W1C)) ||
      (err = hopper::encode_2d(&mw2, w2, D, hidden, W2_BOX, BHT)) ||
      (err = hopper::encode_2d(&mxn, xn, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&mdye, dye_ws, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&mh, h_ws, n_rows, hidden, 64, BHT)) ||
      (err = hopper::encode_2d(&mdg, dg_ws, n_rows, hidden, 64, BHT)) ||
      (err = hopper::encode_2d(&mdx, dx, n_rows, D, 64, 64)))
    return err;
  static bool ok = false;  // the shared-memory limits are raised once
  if (!ok) {
    if ((err = raise_smem(ln_mlp_bwd_kernel<D, LN_IN>, L::BYTES)) ||
        (err = raise_smem(dw_gemm_kernel, DW_BYTES)))
      return err;
    ok = true;
  }
  const int nb = (n_rows + BWD_ROWS - 1) / BWD_ROWS;
  float* p_db1 = (float*)part;
  float* p_cols = p_db1 + (size_t)nb * hidden;  // [3][nb][D]
  ln_mlp_bwd_kernel<D, LN_IN><<<nb, BWD_THREADS, L::BYTES, s>>>(
      mx, mdy, mw1, mw2, mxn, mdye, mh, mdg, mdx, (const float*)g2, (const float*)be2,
      (const float*)b1, (const float*)gate, p_db1, p_cols, n_rows, hidden, eps);
  if ((err = (int)cudaGetLastError())) return err;
  ColSums cs = {{p_db1, p_cols, p_cols + (size_t)nb * D, p_cols + (size_t)2 * nb * D},
                {(float*)db1, LN_IN ? (float*)dgamma : nullptr, LN_IN ? (float*)dbeta : nullptr,
                 (float*)db2},
                {hidden, D, D, D},
                {nb, nb, nb, nb}};
  col_sums_kernel<<<dim3((std::max(hidden, D) + 31) / 32, 4), 256, 0, s>>>(cs);
  if ((err = (int)cudaGetLastError())) return err;

  CUtensorMap mp1, mq1, mp2, mq2;
  if ((err = hopper::encode_2d(&mp1, dg_ws, n_rows, hidden, 64, 64)) ||
      (err = hopper::encode_2d(&mq1, xn, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&mp2, dye_ws, n_rows, D, 64, 64)) ||
      (err = hopper::encode_2d(&mq2, h_ws, n_rows, hidden, 64, 64)))
    return err;
  const int tiles = (hidden + DW_M - 1) / DW_M * ((D + DW_N - 1) / DW_N) +
                    (D + DW_M - 1) / DW_M * ((hidden + DW_N - 1) / DW_N);
  const int per = ((n_rows + DW_K - 1) / DW_K + splits - 1) / splits * DW_K;
  dw_gemm_kernel<<<tiles * splits, DW_THREADS, DW_BYTES, s>>>(
      mp1, mq1, mp2, mq2, (float*)part, hidden, D, D, hidden, n_rows, per, splits);
  if ((err = (int)cudaGetLastError())) return err;
  const int n4 = 2 * hidden * D / 4;
  split_sums_kernel<<<(n4 + 255) / 256, 256, 0, s>>>((const float4*)part, splits,
                                                     hidden * D / 4, n4, (float4*)dw1,
                                                     (float4*)dw2);
  return (int)cudaGetLastError();
}

}  // namespace

// Training backward (exact erf GELU), d = 384 or 192. Outputs: dx bf16
// [n_rows, d]; dgamma, dbeta, db2 f32 [d]; db1 f32 [hidden]; dw1 f32
// [hidden, d]; dw2 f32 [d, hidden]. Workspaces: xn_ws, dye_ws bf16
// [n_rows, d]; h_ws, dg_ws bf16 [n_rows, hidden]; part f32 of
// max(splits * 2 * hidden * d, ceil(n_rows / 64) * (hidden + 3 * d)).
// splits: the row splits of the dW products (ln_mlp_bwd_splits in
// ops/fused_ln_mlp.py).
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

// Backward of the MLP without LN, d = 384 or 192: dh = dg W1 (bf16
// [n_rows, d]; the residual's gradient is dy, added by the caller), dw1,
// db1, dw2, db2 as above. Workspaces as above without xn_ws.
extern "C" int ibk_fused_mlp_bwd(const void* h, const void* w1, const void* b1,
                                 const void* w2, const void* gate, const void* dy, void* dh,
                                 void* dw1, void* db1, void* dw2, void* db2, void* dye_ws,
                                 void* a_ws, void* dg_ws, void* part, int n_rows, int d,
                                 int hidden, int splits, void* stream) {
  return by_width(d, [&](auto w) {
    return mlp_bwd<decltype(w)::value, false>(h, nullptr, nullptr, w1, b1, w2, gate, dy, dh,
                                              nullptr, nullptr, dw1, db1, dw2, db2, nullptr,
                                              dye_ws, a_ws, dg_ws, part, n_rows, hidden, 0.f,
                                              splits, stream);
  });
}
