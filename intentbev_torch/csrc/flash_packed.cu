// Attention with lse, forward and backward, over strided [B, H, T, D] views:
// the packed [B, T, H*D] layout of the ViT's qkv projection (heads that pair
// into 128 lanes: D = 64 or 32) and the BHTD layout (any other head layout).
// Every kernel reads q, k, v (and dO) through four-dimensional TMA tensor
// maps (csrc/hopper.cuh) and runs every product on wgmma; the head dim is a
// template parameter (32 or 64).
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// Element strides of a [B, H, T, D] view whose D stride is 1.
struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ long long at(const Strides& s, int b, int h, int r) {
  return (long long)b * s.b + (long long)h * s.h + (long long)r * s.t;
}

constexpr int RING_ROWS = 128;  // rows of a ring tile: two 64-row TMA boxes
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ONE_PER_SM = 120 * 1024;  // more than half an SM's shared memory
// registers a thread (setmaxnreg): 128 * 24 + 256 * 240 = 384 * 168, the
// 168 a thread of a 384-thread block gets at launch
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ uint4 scale_bf16x8(uint4 raw, float scale) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = pack_bf16x2(__bfloat162float(e[2 * j]) * scale,
                       __bfloat162float(e[2 * j + 1]) * scale);
  return out;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dst = bf16(src * scale) over a 64-row tile of `bytes` bytes, 16 bytes at a
// time (an elementwise pass: the swizzle does not matter), threads i0, i0 +
// stride, ...
__device__ __forceinline__ void scale_tile(const uint8_t* src, uint8_t* dst, int bytes,
                                           float scale, int i0, int stride) {
  for (int i = i0; i < bytes / 16; i += stride)
    reinterpret_cast<uint4*>(dst)[i] =
        scale_bf16x8(reinterpret_cast<const uint4*>(src)[i], scale);
}

// acc[64 x 128] = A B^T over the head dim (the scores S, S^T and dP, dP^T):
// A this warpgroup's 64-row tile, B a 128-row tile of the ring, both K-major.
template <int RB, int HD>
__device__ __forceinline__ void scores(float (&acc)[64], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hopper::wgmma_ss_n128(acc, hopper::desc_kmajor<RB>(a, kk), hopper::desc_kmajor<RB>(b, kk),
                          kk > 0);
}

// The same with A from registers: this warpgroup's rows as A fragments, 16
// columns each.
template <int RB, int HD>
__device__ __forceinline__ void scores(float (&acc)[64], const uint32_t (&a)[HD / 16][4],
                                       const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hopper::wgmma_rs_n128(acc, a[kk], hopper::desc_kmajor<RB>(b, kk), kk > 0);
}

// ---------------------------------------------------------------------------
// Forward. Replaces intentbev/ops/flash_packed.py::_fwd_kernel (the whole
// key row at once; safe = the true row max, or the fixed max m = 0) and
// ::_fwd_kernel_chunked (kv_chunk keys at a time; safe = a running max
// updated once per chunk with the rescale corr = exp(m_old - m_new), or the
// fixed max), and intentbev/ops/flash_attention.py::_fwd_kernel (the BHTD
// kernel: the true row max). Each rounds P = exp(s - m) to bf16 against its
// own m before the PV product, so the three forms differ in their bf16
// values; a template parameter (Form) takes each one's m:
//  - SAFE (_fwd_kernel, safe; the BHTD kernel): m = the row's max over
//    every key. Two passes over the key tiles: pass 1 runs S = Q K^T and
//    the row max only (no exponentials, half the products), pass 2 is the
//    FIXED loop with that m, so no rescale of O.
//  - FIXED (either JAX kernel with safe=False; the serving configuration
//    of bench.py): m = 0, lse = log(d). One pass of pure accumulation: no
//    max and no rescale. Exact while |s| < ~88; the P of every chunking is
//    the same, so one kernel stands for both JAX kernels.
//  - CHUNKED (_fwd_kernel_chunked, safe): the two passes per group of
//    kv_chunk keys (a multiple of the 128-key tile), m the running max up to
//    the group's last key, and JAX's corr on O and d at each group's start.
// lse = m + log(d), d = the f32 sum of P before rounding; o = (P V) / d.
// Bound on the H100: tensor-core throughput and the exponentials. At B=8,
// T=4501, 6 heads of 64 a call is 4*B*T*T*384 = 249 GFLOP (0.25 ms at 989
// TFLOP/s; SAFE and CHUNKED also run pass 1's 124 GFLOP) and 8*6*4501^2 =
// 972 M exponentials (~0.23 ms at 16 a clock per SM on 132 SMs); 12 heads
// of 32 the same products and twice the exponentials, so ex2 bounds that
// shape; 3 heads of 64 (ViT-Ti) half of each.
// Design: one block per (64 query rows per consumer, head, batch), warp-
// specialised as the backward is: 2 or 3 consumer warpgroups (FwdShape,
// registers raised) and a producer warpgroup (registers lowered to 24),
// whose first thread loads the block's q once and keeps TMA loads in a ring
// of FWD_STAGES slots (mbarriers full / empty), in the order the consumers
// take them: pass 1 items of two 128-key k tiles, pass 2 items of the k and
// v tiles of 128 keys. A consumer reads its q rows into registers (ldmatrix
// from the swizzled tile; at head dim 32 scaled in bf16 first, in place: the
// bf16 scale is not a power of two), runs S = Q K^T as wgmma m64n128 (A in
// registers, the k tile K-major), masks keys at or past seq_len in the last
// tile only (a tile wholly past seq_len is never loaded), takes row maxima
// and sums as trees, computes P = ex2(s * c - m * c) with the scale and
// log2(e) folded into c (head dim 64: c = scale * log2(e) on the f32 sum,
// the same bits as scaling q in bf16 by 1/8), rounds P to bf16 A fragments
// in registers and runs O += P V as wgmma m64nDk16 with the v tile read
// MN-major through the descriptor's transpose bit (no transposed copy of
// v). Pass 2 issues the P V of tile i - 1 beside the scores of tile i, so
// tile i's exponentials run under that product. O / d goes to bf16 through
// a staging tile in shared memory and out as 16-byte stores in either
// layout; rows past T are read as TMA's zeros and never written.
// ---------------------------------------------------------------------------

enum Form { SAFE = 0, FIXED = 1, CHUNKED_SAFE = 2 };  // the C entries' form numbers

// The forward's block shape, by head dim and form (PERF.md §6 has the
// A/B runs behind each choice):
//  - FWD_STAGES ring slots (3: pass 2 holds tile i - 1's v while it waits
//    for tile i);
//  - consumer warpgroups of 64 query rows: 3 at head dim 32, whose
//    exponentials (twice as many per product as at 64) want more warps to
//    hide their latency, 2 at 64 (a third slows every form there);
//  - with 2 consumers, pass 1 takes the scores of an item's two tiles at
//    once (with 3, the registers allow one at a time);
//  - FIXED takes turns to issue pass 2's products (pingpong), so that one
//    consumer's exponentials run under another's products; the two-pass
//    forms do not (their passes already stagger the consumers, and turns
//    slow them).
constexpr int FWD_STAGES = 3;
template <int HD, int FORM>
struct FwdShape {
  static constexpr int CONSUMERS = HD == 32 ? 3 : 2;
  static constexpr bool PAIR = CONSUMERS == 2;
  static constexpr bool PINGPONG = FORM == FIXED;
  static constexpr int THREADS = 128 * (CONSUMERS + 1), ROWS = 64 * CONSUMERS;
  // setmaxnreg: 128 * PRODUCER_REGS + THREADS - 128 consumer threads * REGS
  // <= 65536, a multiple of 8
  static constexpr int REGS = CONSUMERS == 2 ? CONSUMER_REGS : 160;
};

// Shared memory of the forward: q (64 rows per consumer), then per ring slot
// k and v of 128 keys, then each consumer's o staging tile, then the
// barriers. The tiles start on 1024-byte boundaries.
template <int HD, int FORM>
struct FwdSmem {
  static constexpr int TILE = 64 * HD * 2;
  static constexpr int OLD = HD + 8;  // o staging row (bf16): conflict-free 4-byte writes
  static constexpr int Q = 0, RING = FwdShape<HD, FORM>::CONSUMERS * TILE, SLOT = 4 * TILE;
  static constexpr int O = RING + FWD_STAGES * SLOT;
  static constexpr int BARS = O + FwdShape<HD, FORM>::CONSUMERS * 64 * OLD * 2;
  static constexpr int BYTES = BARS + (1 + 2 * FWD_STAGES) * 8;
};

// op over the 32 values of one row of this thread's part of a 64 x 128
// accumulator (ROW 0: row g, elements 4n, 4n + 1; ROW 2: row g + 8), as a tree
// of depth 5 rather than a chain of 32.
template <int ROW, typename Op>
__device__ __forceinline__ float tree(const float (&s)[64], Op op) {
  float t[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) t[n] = op(s[4 * n + ROW], s[4 * n + ROW + 1]);
#pragma unroll
  for (int n = 0; n < 8; ++n) t[n] = op(t[n], t[n + 8]);
#pragma unroll
  for (int n = 0; n < 4; ++n) t[n] = op(t[n], t[n + 4]);
  return op(op(t[0], t[2]), op(t[1], t[3]));
}

// Scores of keys at or past seq_len -> -inf (the accumulator layout of
// hopper::wgmma_ss_n128; key0 the tile's first key).
__device__ __forceinline__ void mask_keys(float (&sc)[64], int key0, int seq_len, int t4) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int key = key0 + 8 * n + 2 * t4;
    if (key >= seq_len) sc[4 * n + 0] = sc[4 * n + 2] = -INFINITY;
    if (key + 1 >= seq_len) sc[4 * n + 1] = sc[4 * n + 3] = -INFINITY;
  }
}

// group_tiles: 128-key tiles per CHUNKED_SAFE group (kv_chunk / 128).
template <int HD, int FORM>
__global__ void __launch_bounds__(FwdShape<HD, FORM>::THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, Strides os,
                     float* __restrict__ lse, int T, int seq_len, int H, int group_tiles,
                     float scale) {
  using L = FwdSmem<HD, FORM>;
  using Shape = FwdShape<HD, FORM>;
  constexpr int RB = HD * 2, TILE = L::TILE, CONSUMERS = Shape::CONSUMERS;
  constexpr bool EXACT = HD == 64;  // the bf16 scale is a power of two
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + FWD_STAGES;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * Shape::ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * CONSUMERS);  // one per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  const int n_tiles = (seq_len + RING_ROWS - 1) / RING_ROWS;
  // tiles per softmax group: one group of every tile, but CHUNKED_SAFE's
  const int group = FORM == CHUNKED_SAFE ? group_tiles : n_tiles;
  if (wg == CONSUMERS) {  // producer: one thread issues every load
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 128 * CONSUMERS) {
      hopper::mbar_arrive_expect_tx(qbar, CONSUMERS * TILE);
      for (int i = 0; i < CONSUMERS; ++i)
        hopper::tma_load_4d(sm + L::Q + i * TILE, &mq, qbar, 0, h, q0 + 64 * i, b);
      // an item is the k tiles j and j + 1 (pass 1: a slot holds two) or the
      // k and v tiles j (pass 2)
      auto load = [&](int it, const CUtensorMap* m0, int j0, const CUtensorMap* m1, int j1) {
        const int s = it % FWD_STAGES;
        uint8_t* slot = sm + L::RING + s * L::SLOT;
        hopper::mbar_wait(&empty[s], ((it / FWD_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], (m1 ? 4 : 2) * TILE);
        for (int i = 0; i < 2; ++i) {
          hopper::tma_load_4d(slot + i * TILE, m0, &full[s], 0, h, j0 * RING_ROWS + 64 * i, b);
          if (m1)
            hopper::tma_load_4d(slot + (2 + i) * TILE, m1, &full[s], 0, h,
                                j1 * RING_ROWS + 64 * i, b);
        }
      };
      int item = 0;
      for (int g0 = 0; g0 < n_tiles; g0 += group) {
        const int g1 = min(g0 + group, n_tiles);
        if (FORM != FIXED)
          for (int j = g0; j < g1; j += 2, ++item)
            load(item, &mk, j, j + 1 < g1 ? &mk : nullptr, j + 1);
        for (int j = g0; j < g1; ++j, ++item) load(item, &mk, j, &mv, j);
      }
    }
  } else {  // consumers: 64 queries each
    hopper::setmaxnreg_inc<Shape::REGS>();
    const int wt = tid % 128, warp = wt / 32, lane = tid % 32;
    const int t4 = lane & 3, g = lane >> 2;
    uint8_t* qt = sm + L::Q + wg * TILE;
    hopper::mbar_wait(qbar, 0);
    if constexpr (!EXACT) {  // qh = bf16(q * scale), this warpgroup's rows
      scale_tile(qt, qt, TILE, scale, wt, 128);
      hopper::named_sync(1 + wg, 128);
    }
    uint32_t qa[HD / 16][4];  // this warp's q (qh) rows
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) hopper::ldmatrix_a<RB>(qa[kk], qt, 16 * warp, kk, lane);
    // scores in log2 units: s * c; m in the units of the raw sums
    const float c = EXACT ? scale * LOG2E : LOG2E;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = FORM == FIXED ? 0.f : -INFINITY, m1 = m0;  // rows g, g + 8 of the warp
    float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums

    // Pass 1 takes the scores of an item's two tiles at once (Shape::PAIR):
    // the max of the first runs while the second's product is in flight.
    // Pass 2 keeps P of tile i - 1 as bf16 A fragments and issues its P V
    // beside the scores of tile i, so the exponentials of tile i run under
    // that product. Under Shape::PINGPONG the consumers also take turns to
    // issue pass 2's products (named barriers 8 + wg; 1 + wg are each
    // warpgroup's own).
    float sc[64], sn[64];
    uint32_t pa[8][4];  // P of the tile before, bf16 A fragments
    auto slot_of = [&](int it) { return sm + L::RING + (it % FWD_STAGES) * L::SLOT; };
    auto landed = [&](int it) { hopper::mbar_wait(&full[it % FWD_STAGES], (it / FWD_STAGES) & 1); };
    auto release = [&](int it) {
      if (lane == 0) hopper::mbar_arrive(&empty[it % FWD_STAGES]);
    };
    auto my_turn = [&]() {
      if (Shape::PINGPONG) hopper::named_sync(8 + wg, 256);  // after consumer wg - 1
    };
    auto their_turn = [&]() {
      if (Shape::PINGPONG) hopper::named_arrive(8 + (wg + 1) % CONSUMERS, 256);
    };
    auto masked = [&](float (&s)[64], int j) {  // keys at or past seq_len in tile j
      if ((j + 1) * RING_ROWS > seq_len) mask_keys(s, j * RING_ROWS, seq_len, t4);
    };
    if (Shape::PINGPONG && wg == CONSUMERS - 1) their_turn();  // consumer 0 issues first
    int item = 0;
    for (int g0 = 0; g0 < n_tiles; g0 += group) {
      const int n = min(group, n_tiles - g0);  // tiles of this group
      if constexpr (FORM != FIXED) {  // pass 1: the max up to the group's last key
        float mx0 = m0, mx1 = m1;
        auto row_max = [&](float (&s)[64], int j) {
          masked(s, j);
          mx0 = fmaxf(mx0, tree<0>(s, [](float x, float y) { return fmaxf(x, y); }));
          mx1 = fmaxf(mx1, tree<2>(s, [](float x, float y) { return fmaxf(x, y); }));
        };
        int i = 0;
        for (; i + 1 < n; i += 2, ++item) {  // an item of two k tiles
          landed(item);
          if constexpr (Shape::PAIR) {
            hopper::wgmma_fence();
            scores<RB, HD>(sc, qa, slot_of(item));
            hopper::wgmma_commit();
            scores<RB, HD>(sn, qa, slot_of(item) + 2 * TILE);
            hopper::wgmma_commit();
            hopper::wgmma_wait<1>();
            hopper::fence_regs(sc);
            row_max(sc, g0 + i);
            hopper::wgmma_wait<0>();
            hopper::fence_regs(sn);
            release(item);
            row_max(sn, g0 + i + 1);
          } else {
            for (int t = 0; t < 2; ++t) {
              hopper::wgmma_fence();
              scores<RB, HD>(sc, qa, slot_of(item) + 2 * t * TILE);
              hopper::wgmma_commit();
              hopper::wgmma_wait<0>();
              hopper::fence_regs(sc);
              if (t == 1) release(item);
              row_max(sc, g0 + i + t);
            }
          }
        }
        if (i < n) {  // an item of one
          landed(item);
          hopper::wgmma_fence();
          scores<RB, HD>(sc, qa, slot_of(item));
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(sc);
          release(item);
          row_max(sc, g0 + i);
          ++item;
        }
#pragma unroll
        for (int o_ = 1; o_ <= 2; o_ <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
        }
        // JAX's corr = exp(m_old - m_new) (0 on the first group, where m_old
        // = -inf; the group holds a key < seq_len, so m_new is finite)
        const float c0 = hopper::ex2((m0 - mx0) * c), c1 = hopper::ex2((m1 - mx1) * c);
        m0 = mx0;
        m1 = mx1;
        l0 *= c0;
        l1 *= c1;
#pragma unroll
        for (int e = 0; e < HD / 8; ++e) {
          acc[4 * e + 0] *= c0;
          acc[4 * e + 1] *= c0;
          acc[4 * e + 2] *= c1;
          acc[4 * e + 3] *= c1;
        }
      }
      // pass 2: P = exp(s - m) rounded to bf16, O += P V
      const float mc0 = m0 * c, mc1 = m1 * c;
      auto pv = [&](int it) {  // O += P V of item it (P in pa)
        const uint8_t* vs = slot_of(it) + 2 * TILE;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          hopper::wgmma_rs<HD>(acc, pa[kk], hopper::desc_mnmajor<RB>(vs, kk), 1);
        hopper::wgmma_commit();
      };
      auto softmax = [&](int j) {  // sc -> P = exp(s - m) in place, row sums
        masked(sc, j);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          sc[4 * e + 0] = hopper::ex2(fmaf(sc[4 * e + 0], c, -mc0));
          sc[4 * e + 1] = hopper::ex2(fmaf(sc[4 * e + 1], c, -mc0));
          sc[4 * e + 2] = hopper::ex2(fmaf(sc[4 * e + 2], c, -mc1));
          sc[4 * e + 3] = hopper::ex2(fmaf(sc[4 * e + 3], c, -mc1));
        }
        l0 += tree<0>(sc, [](float x, float y) { return x + y; });
        l1 += tree<2>(sc, [](float x, float y) { return x + y; });
      };

      landed(item);
      my_turn();
      hopper::wgmma_fence();
      scores<RB, HD>(sc, qa, slot_of(item));
      hopper::wgmma_commit();
      their_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      softmax(g0);
      hopper::pack_a(pa, sc);
      for (int i = 1; i < n; ++i) {
        landed(item + i);
        my_turn();
        hopper::wgmma_fence();
        scores<RB, HD>(sc, qa, slot_of(item + i));
        hopper::wgmma_commit();
        pv(item + i - 1);
        their_turn();
        hopper::wgmma_wait<1>();  // the scores of tile i
        hopper::fence_regs(sc);
        softmax(g0 + i);
        hopper::wgmma_wait<0>();  // P V of tile i - 1: its slot and pa are free
        hopper::fence_regs(acc);
        release(item + i - 1);
        hopper::pack_a(pa, sc);
      }
      my_turn();
      hopper::wgmma_fence();
      pv(item + n - 1);
      their_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(item + n - 1);
      item += n;
    }

#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    // o = (P V) / d through this warpgroup's staging tile, 16 bytes a store
    bf16* ost = reinterpret_cast<bf16*>(sm + L::O) + wg * 64 * L::OLD;
    const int w0 = 16 * warp + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(ost + w0 * L::OLD + col) =
          pack_bf16x2(acc[4 * n + 0] / l0, acc[4 * n + 1] / l0);
      *reinterpret_cast<uint32_t*>(ost + (w0 + 8) * L::OLD + col) =
          pack_bf16x2(acc[4 * n + 2] / l1, acc[4 * n + 3] / l1);
    }
    const int r0 = q0 + 64 * wg + w0, r1 = r0 + 8;
    if (t4 == 0) {  // m in natural units: at head dim 64 the sums were unscaled
      const size_t lbase = ((size_t)b * H + h) * T;
      const float mu = EXACT ? scale : 1.f;
      if (r0 < T) lse[lbase + r0] = m0 * mu + logf(l0);
      if (r1 < T) lse[lbase + r1] = m1 * mu + logf(l1);
    }
    hopper::named_sync(1 + wg, 128);
    for (int i = wt; i < 64 * HD / 8; i += 128) {
      const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
      const int row = q0 + 64 * wg + r;
      if (row < T)
        *reinterpret_cast<uint4*>(o + at(os, b, h, row) + c8) =
            *reinterpret_cast<const uint4*>(ost + r * L::OLD + c8);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward. Replaces intentbev/ops/flash_packed.py::_bwd_fused_kernel,
// ::_bwd_dq_kernel and ::_bwd_dkv_kernel (split), ::_bwd_dq_kernel_chunked
// and ::_bwd_dkv_kernel_chunked (chunked), and intentbev/ops/
// flash_attention.py::_bwd_dq_kernel and ::_bwd_dkv_kernel:
//   p = exp(s - lse),  t = p * (dO v^T - delta),  delta = rowsum(dO * O)
//   dv = p^T dO,  dk = scale * t^T q,  dq = scale * t k
// with p recomputed in f32 from lse, and p and t rounded to bf16 before the
// products. The four JAX versions compute this function with the scale
// applied at other points; a template parameter (Mode) takes each one's
// rounding points, with sb = the scale rounded to bf16 and sf = the f32
// scale:
//  - FUSED (_bwd_fused_kernel): s = qh k^T with qh = bf16(q * sb); dk =
//    t^T qh (no epilogue scale); dq = bf16(f32(t k) * sf).
//  - SPLIT (_bwd_dq_kernel, _bwd_dkv_kernel): s as FUSED; dk =
//    bf16(f32(t^T q) * sf), the product over the UNSCALED q; dq as FUSED.
//  - CHUNKED (_bwd_dkv_kernel_chunked): s = kh q^T with kh = bf16(k * sb)
//    against the unscaled q; dk as SPLIT. Its dq pass
//    (_bwd_dq_kernel_chunked) is SPLIT's: the TPU chunk is a tile of the
//    contraction axis, and tiling changes only the order of f32 sums. The
//    port's 64-wide tiles stand for both, and the caller picks this mode
//    where JAX would take the chunked kernels.
//  - BHTD (flash_attention.py): the JAX wrapper scales q by sb outside the
//    kernels, which then see qh; dk as FUSED; dq = bf16(bf16(t k) * sb),
//    the autodiff of that scaling.
// At head dim 64 both scales are 1/8, a power of two: scaling a bf16
// operand and scaling the f32 sum of its products give the same bits, so
// the kernels read every tile as it is and scale the scores (and dk) in
// f32, and every mode is one function. At head dim 32 they differ: the
// kernels scale a copy of the landed tile in shared memory (qh for the
// scores and FUSED's dk, kh for CHUNKED's scores, qh in the dq pass).
// Bound on the H100: tensor-core throughput, 5 products of 2*B*H*T*T*D =
// 622 GFLOP at B=8, T=4501, 6 heads of 64 (12 heads of 32 alike); 311 GFLOP
// at 3 heads of 64; and ~2 G exponentials (this design recomputes the
// scores and dP in both passes: 7 products, two exponentials per score).
// Design: the TPU kernels keep dk/dv resident in VMEM across a sequential
// query-block grid (fused), hold whole [T_pad, 128] panels of q and dO
// beside [256, T_pad] f32 score tiles (split), double-buffer [256, chunk]
// score tiles (chunked), or hold a whole [T_pad, D] panel beside a
// [256, T_pad] score tile (BHTD); blocks on the H100 run in parallel and in
// no order, with 227 KB of shared memory, so every mode is split into two
// deterministic passes, as in FlashAttention-2, with no atomics. Both are
// warp-specialised Hopper kernels of 384 threads: warpgroups 0 and 1
// consume (64 rows each, registers raised to 240), warpgroup 2 produces
// (registers lowered to 24): its first thread keeps TMA loads of 128-row
// tiles (two 64-row boxes) in flight in a ring of BWD_STAGES slots
// (mbarriers full / empty; in dkdv the warpgroup also stages each tile's
// lse and delta, and at head dim 32 makes the qh copy), and every product
// is a wgmma (m64nNk16, f32 accumulation):
//  - dkdv: one block per (128 keys, head, batch); k and v of its keys land
//    once. The ring carries q and dO tiles of 128 queries with their lse
//    and delta (rows past T: lse = +inf, so p = 0). Each consumer computes
//    S^T = K Q^T and dP^T = V dO^T (m64n128: A = its k / v rows, B = the q
//    / dO tile, both K-major in shared memory), p and t in registers, then
//    dV += P^T dO and dK += dS^T Q with A = the accumulators repacked as
//    bf16 in registers and B the same q / dO tile read MN-major (the
//    descriptor's transpose bit): no transposed copy. Keys at or past
//    seq_len get dk = dv = 0 (JAX's split dkv computes them without a key
//    bias and zeroes them afterwards); a block whose keys all lie there
//    writes zeros and exits.
//  - dq: one block per (128 queries, head, batch); q and dO of its rows
//    land once and are read into registers (ldmatrix from the swizzled
//    tiles), k and v tiles of 128 keys run through the ring up to seq_len.
//    S = Q K^T and dP = dO V^T (m64n128, A in registers, B K-major), p and t
//    in registers (keys at or past seq_len: p = 0), dQ += dS K with B the k
//    tile read MN-major.
// Tiles are swizzled at their row width (128 bytes at head dim 64, 64 at
// 32), which is both the TMA map's and the wgmma descriptors' mode. dq,
// dk and dv are written through their strides: into one [B, T, 3*H*D]
// gradient of the qkv projection (packed) or into any [B, H, T, D] views.
// dkdv's scores keep A in shared memory: k and v as register fragments
// beside the 128-wide S^T and dP^T would pass the 240 registers.
// Tried and dropped (PERF.md): issuing the next tile's scores under this
// tile's products, a pingpong of the two consumers, 4-5 ring slots, a
// producer of one warp; each measured slower or no faster.
// ---------------------------------------------------------------------------

enum Mode { FUSED = 0, SPLIT = 1, CHUNKED = 2, BHTD = 3 };

constexpr int BWD_THREADS = 384;  // two consumer warpgroups and a producer
constexpr int BWD_STAGES = 3;     // ring slots

// Shared memory of the dk/dv kernel: k and v of the block's 128 keys (two
// 64-row tiles each), then per ring slot q, dO (and qh) of 128 rows each,
// then lse and delta per slot, then the barriers. Every tile starts on a
// 1024-byte boundary.
template <int HD, int MODE>
struct DkdvSmem {
  static constexpr int TILE = 64 * HD * 2;
  static constexpr bool EXACT = HD == 64;  // the bf16 scale is a power of two
  static constexpr bool QH = !EXACT && MODE != CHUNKED;  // a scaled copy of q
  static constexpr bool KH = !EXACT && MODE == CHUNKED;  // k scaled in place
  static constexpr int SLOT = (QH ? 3 : 2) * 2 * TILE;  // q, dO (, qh): 128 rows each
  static constexpr int K = 0, V = 2 * TILE, RING = 4 * TILE;
  static constexpr int LSE = RING + BWD_STAGES * SLOT;
  static constexpr int DELTA = LSE + BWD_STAGES * RING_ROWS * 4;
  static constexpr int BARS = DELTA + BWD_STAGES * RING_ROWS * 4;
  static constexpr int BYTES = BARS + (1 + 3 * BWD_STAGES) * 8;
};

template <int HD>
struct DqSmem {
  static constexpr int TILE = 64 * HD * 2;
  static constexpr int Q = 0, DO = 2 * TILE, RING = 4 * TILE, SLOT = 4 * TILE;  // k, v
  static constexpr int BARS = RING + BWD_STAGES * SLOT;
  static constexpr int BYTES = BARS + (1 + 2 * BWD_STAGES) * 8;
};

// MODE: FUSED (also BHTD's dk/dv), SPLIT or CHUNKED.
template <int HD, int MODE>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, Strides gs,
                          int T, int seq_len, int H, float scale_b, float scale_f) {
  static_assert(MODE == FUSED || MODE == SPLIT || MODE == CHUNKED, "dkdv mode");
  using L = DkdvSmem<HD, MODE>;
  constexpr int RB = HD * 2, TILE = L::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(sm + L::LSE);
  float* delta_s = reinterpret_cast<float*>(sm + L::DELTA);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* ready = bars + 1 + BWD_STAGES;
  uint64_t* empty = bars + 1 + 2 * BWD_STAGES;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (k0 >= seq_len) {  // every key of the block is masked: dk = dv = 0
    for (int i = tid; i < 128 * HD / 8; i += BWD_THREADS) {
      const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
      if (k0 + r < T) {
        const long long off = at(gs, b, h, k0 + r) + c8;
        *reinterpret_cast<uint4*>(dk_out + off) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv_out + off) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  if (tid == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      hopper::mbar_init(&full[s], 128);   // the producer warpgroup, after lse/delta
      hopper::mbar_init(&ready[s], 128);  // the producer warpgroup, after qh
      hopper::mbar_init(&empty[s], 8);    // one per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  const int n_q = (T + RING_ROWS - 1) / RING_ROWS;
  if (wg == 2) {  // producer
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    const int p = tid - 256;
    if (p == 0) {
      hopper::mbar_arrive_expect_tx(kvbar, 4 * TILE);
      for (int i = 0; i < 2; ++i) {
        hopper::tma_load_4d(sm + L::K + i * TILE, &mk, kvbar, 0, h, k0 + 64 * i, b);
        hopper::tma_load_4d(sm + L::V + i * TILE, &mv, kvbar, 0, h, k0 + 64 * i, b);
      }
    }
    const size_t lbase = ((size_t)b * H + h) * T;
    // the qh copy of tile j - LAG is made after tile j's loads are issued,
    // so that the copies do not hold back the loads in flight. A consumer
    // frees tile i - 1 before it waits for tile i + 1, so LAG may be 1 at
    // most with 3 slots: the loads of tile i + 1 + LAG wait for slot i + LAG
    // - 2 to be freed.
    constexpr int LAG = L::QH ? BWD_STAGES - 2 : 0;
    for (int j = 0; j < n_q + LAG; ++j) {
      const int s = j % BWD_STAGES;
      const uint32_t ph = (j / BWD_STAGES) & 1;
      uint8_t* slot = sm + L::RING + s * L::SLOT;
      if (j < n_q) {
        // the row's lse and delta are read while the slot is still in use
        const int r = j * RING_ROWS + p;
        const float l = r < T ? lse[lbase + r] * LOG2E : INFINITY;  // p = 0 past T
        const float d = r < T ? delta[lbase + r] : 0.f;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        lse_s[s * RING_ROWS + p] = l;
        delta_s[s * RING_ROWS + p] = d;
        if (p == 0) {
          hopper::mbar_arrive_expect_tx(&full[s], 4 * TILE);
          for (int i = 0; i < 2; ++i) {
            const int row = j * RING_ROWS + 64 * i;
            hopper::tma_load_4d(slot + i * TILE, &mq, &full[s], 0, h, row, b);
            hopper::tma_load_4d(slot + (2 + i) * TILE, &mdo, &full[s], 0, h, row, b);
          }
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
      if (L::QH && j >= LAG) {  // qh = bf16(q * sb) beside q
        const int i = j - LAG, si = i % BWD_STAGES;
        uint8_t* qslot = sm + L::RING + si * L::SLOT;
        hopper::mbar_wait(&full[si], (i / BWD_STAGES) & 1);
        scale_tile(qslot, qslot + 4 * TILE, 2 * TILE, scale_b, p, 128);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&ready[si]);
      }
    }
  } else {  // consumers: 64 keys each
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int wt = tid % 128, warp = wt / 32, lane = tid % 32;
    const int t4 = lane & 3, g = lane >> 2;
    uint8_t* kt = sm + L::K + wg * TILE;
    const uint8_t* vt = sm + L::V + wg * TILE;
    hopper::mbar_wait(kvbar, 0);
    if constexpr (L::KH) {  // kh = bf16(k * sb), this warpgroup's rows
      scale_tile(kt, kt, TILE, scale_b, wt, 128);
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
    }
    // scores in log2 units: s * c - lse * log2(e)
    const float c = L::EXACT ? scale_b * LOG2E : LOG2E;
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

    for (int j = 0; j < n_q; ++j) {
      const int s = j % BWD_STAGES;
      const uint32_t ph = (j / BWD_STAGES) & 1;
      const uint8_t* qs = sm + L::RING + s * L::SLOT;
      const uint8_t* dos = qs + 2 * TILE;
      const uint8_t* qh = L::QH ? qs + 4 * TILE : qs;          // the scores' q
      const uint8_t* qk = MODE == FUSED ? qh : qs;              // dk's q
      hopper::mbar_wait(&full[s], ph);
      if constexpr (L::QH) hopper::mbar_wait(&ready[s], ph);

      float sc[64], dp[64];  // S^T and dP^T [key][query]
      hopper::wgmma_fence();
      scores<RB, HD>(sc, kt, qh);
      hopper::wgmma_commit();
      scores<RB, HD>(dp, vt, dos);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      const float* ls = lse_s + s * RING_ROWS;
      const float* ds = delta_s + s * RING_ROWS;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t4);
        sc[4 * n + 0] = hopper::ex2(sc[4 * n + 0] * c - l.x);
        sc[4 * n + 1] = hopper::ex2(sc[4 * n + 1] * c - l.y);
        sc[4 * n + 2] = hopper::ex2(sc[4 * n + 2] * c - l.x);
        sc[4 * n + 3] = hopper::ex2(sc[4 * n + 3] * c - l.y);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float2 d = *reinterpret_cast<const float2*>(ds + 8 * n + 2 * t4);
        dp[4 * n + 0] = sc[4 * n + 0] * (dp[4 * n + 0] - d.x);
        dp[4 * n + 1] = sc[4 * n + 1] * (dp[4 * n + 1] - d.y);
        dp[4 * n + 2] = sc[4 * n + 2] * (dp[4 * n + 2] - d.x);
        dp[4 * n + 3] = sc[4 * n + 3] * (dp[4 * n + 3] - d.y);
      }
      uint32_t pa[8][4], ta[8][4];
      hopper::pack_a(pa, sc);
      hopper::pack_a(ta, dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_rs<HD>(dv, pa[kk], hopper::desc_mnmajor<RB>(dos, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_rs<HD>(dk, ta[kk], hopper::desc_mnmajor<RB>(qk, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // dk's epilogue scale: FUSED's products ran over qh (or, at head dim 64,
    // over q with the exact 1/8 left for here); SPLIT and CHUNKED scale the
    // f32 sum by sf, then round once
    const float sdk = MODE == FUSED ? (L::EXACT ? scale_b : 1.f) : scale_f;
    const int r0 = k0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const float z0 = r0 < seq_len ? 1.f : 0.f, z1 = r1 < seq_len ? 1.f : 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (r0 < T) {
        const long long off = at(gs, b, h, r0) + col;
        *reinterpret_cast<uint32_t*>(dk_out + off) =
            pack_bf16x2(dk[4 * n] * sdk * z0, dk[4 * n + 1] * sdk * z0);
        *reinterpret_cast<uint32_t*>(dv_out + off) =
            pack_bf16x2(dv[4 * n] * z0, dv[4 * n + 1] * z0);
      }
      if (r1 < T) {
        const long long off = at(gs, b, h, r1) + col;
        *reinterpret_cast<uint32_t*>(dk_out + off) =
            pack_bf16x2(dk[4 * n + 2] * sdk * z1, dk[4 * n + 3] * sdk * z1);
        *reinterpret_cast<uint32_t*>(dv_out + off) =
            pack_bf16x2(dv[4 * n + 2] * z1, dv[4 * n + 3] * z1);
      }
    }
  }
}

// MODE: FUSED (also SPLIT's and CHUNKED's dq) or BHTD.
template <int HD, int MODE>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mdo,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq_out, Strides gs, int T, int seq_len, int H,
                        float scale_b, float scale_f) {
  static_assert(MODE == FUSED || MODE == BHTD, "dq mode");
  using L = DqSmem<HD>;
  constexpr int RB = HD * 2, TILE = L::TILE;
  constexpr bool EXACT = HD == 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + BWD_STAGES;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  const int n_k = (seq_len + RING_ROWS - 1) / RING_ROWS;
  if (wg == 2) {  // producer: one thread issues every load
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 256) {
      hopper::mbar_arrive_expect_tx(qbar, 4 * TILE);
      for (int i = 0; i < 2; ++i) {
        hopper::tma_load_4d(sm + L::Q + i * TILE, &mq, qbar, 0, h, q0 + 64 * i, b);
        hopper::tma_load_4d(sm + L::DO + i * TILE, &mdo, qbar, 0, h, q0 + 64 * i, b);
      }
      for (int j = 0; j < n_k; ++j) {
        const int s = j % BWD_STAGES;
        const uint32_t ph = (j / BWD_STAGES) & 1;
        uint8_t* slot = sm + L::RING + s * L::SLOT;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 4 * TILE);
        for (int i = 0; i < 2; ++i) {
          const int row = j * RING_ROWS + 64 * i;
          hopper::tma_load_4d(slot + i * TILE, &mk, &full[s], 0, h, row, b);
          hopper::tma_load_4d(slot + (2 + i) * TILE, &mv, &full[s], 0, h, row, b);
        }
      }
    }
  } else {  // consumers: 64 queries each
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int wt = tid % 128, warp = wt / 32, lane = tid % 32;
    const int t4 = lane & 3, g = lane >> 2;
    uint8_t* qt = sm + L::Q + wg * TILE;
    const uint8_t* ot = sm + L::DO + wg * TILE;
    const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const size_t lbase = ((size_t)b * H + h) * T;
    // rows past T read dO = 0, so t = 0 there; their dq is not written
    const float l0 = r0 < T ? lse[lbase + r0] * LOG2E : 0.f;
    const float l1 = r1 < T ? lse[lbase + r1] * LOG2E : 0.f;
    const float d0 = r0 < T ? delta[lbase + r0] : 0.f;
    const float d1 = r1 < T ? delta[lbase + r1] : 0.f;
    hopper::mbar_wait(qbar, 0);
    if constexpr (!EXACT) {  // qh = bf16(q * sb), this warpgroup's rows
      scale_tile(qt, qt, TILE, scale_b, wt, 128);
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
    }
    uint32_t qa[HD / 16][4], oa[HD / 16][4];  // this warp's q (qh) and dO rows
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      hopper::ldmatrix_a<RB>(qa[kk], qt, 16 * warp, kk, lane);
      hopper::ldmatrix_a<RB>(oa[kk], ot, 16 * warp, kk, lane);
    }
    const float c = EXACT ? scale_b * LOG2E : LOG2E;
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

    for (int j = 0; j < n_k; ++j) {
      const int s = j % BWD_STAGES;
      const uint32_t ph = (j / BWD_STAGES) & 1;
      const uint8_t* ks = sm + L::RING + s * L::SLOT;
      const uint8_t* vs = ks + 2 * TILE;
      hopper::mbar_wait(&full[s], ph);

      float sc[64], dp[64];  // S and dP [query][key]
      hopper::wgmma_fence();
      scores<RB, HD>(sc, qa, ks);
      hopper::wgmma_commit();
      scores<RB, HD>(dp, oa, vs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
#pragma unroll
      for (int n = 0; n < 16; ++n) {  // keys past seq_len: p = 0
        const int key = j * RING_ROWS + 8 * n + 2 * t4;
        const bool m0 = key < seq_len, m1 = key + 1 < seq_len;
        sc[4 * n + 0] = m0 ? hopper::ex2(sc[4 * n + 0] * c - l0) : 0.f;
        sc[4 * n + 1] = m1 ? hopper::ex2(sc[4 * n + 1] * c - l0) : 0.f;
        sc[4 * n + 2] = m0 ? hopper::ex2(sc[4 * n + 2] * c - l1) : 0.f;
        sc[4 * n + 3] = m1 ? hopper::ex2(sc[4 * n + 3] * c - l1) : 0.f;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        dp[4 * n + 0] = sc[4 * n + 0] * (dp[4 * n + 0] - d0);
        dp[4 * n + 1] = sc[4 * n + 1] * (dp[4 * n + 1] - d0);
        dp[4 * n + 2] = sc[4 * n + 2] * (dp[4 * n + 2] - d1);
        dp[4 * n + 3] = sc[4 * n + 3] * (dp[4 * n + 3] - d1);
      }
      uint32_t ta[8][4];
      hopper::pack_a(ta, dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_rs<HD>(dq, ta[kk], hopper::desc_mnmajor<RB>(ks, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e)  // BHTD: rounded to bf16, then the bf16 scale
        dq[4 * n + e] =
            MODE == BHTD ? bf16_round(dq[4 * n + e]) * scale_b : dq[4 * n + e] * scale_f;
      if (r0 < T)
        *reinterpret_cast<uint32_t*>(dq_out + at(gs, b, h, r0) + col) =
            pack_bf16x2(dq[4 * n], dq[4 * n + 1]);
      if (r1 < T)
        *reinterpret_cast<uint32_t*>(dq_out + at(gs, b, h, r1) + col) =
            pack_bf16x2(dq[4 * n + 2], dq[4 * n + 3]);
    }
  }
}

// Raises a kernel's dynamic shared-memory limit to `bytes` (once).
template <typename K>
int allow_smem(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return (int)err;
}

template <int HD, int FORM>
int launch_fwd_form(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o,
                    Strides os, void* lse, int B, int T, int seq_len, int H, int group_tiles,
                    float scale, cudaStream_t s) {
  auto* kern = flash_fwd_kernel<HD, FORM>;
  // + alignment slack; at least ONE_PER_SM, so that no second block shares
  // the SM's registers with the one whose consumers raise theirs
  constexpr int bytes = cmax(FwdSmem<HD, FORM>::BYTES + 1024, ONE_PER_SM);
  static bool ok = false;
  int err;
  if ((err = allow_smem(kern, bytes, ok))) return err;
  using Shape = FwdShape<HD, FORM>;
  dim3 grid((T + Shape::ROWS - 1) / Shape::ROWS, H, B);
  kern<<<grid, Shape::THREADS, bytes, s>>>(mq, mk, mv, (bf16*)o, os, (float*)lse, T, seq_len, H,
                                        group_tiles, scale);
  return (int)cudaGetLastError();
}

// form: SAFE, FIXED or CHUNKED_SAFE (kv_chunk keys a group, a multiple of
// RING_ROWS); scale the bf16-rounded 1/sqrt(D). q, k, v share the strides
// `in` and are read through tensor maps (dims (D, H, T, B), 64-row boxes),
// as the backward reads them.
template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, Strides in, void* o, Strides os,
               void* lse, int B, int T, int seq_len, int H, float scale, int form, int kv_chunk,
               void* stream) {
  if (B <= 0 || T <= 0 || seq_len <= 0) return (int)cudaGetLastError();
  if (form == CHUNKED_SAFE && (kv_chunk <= 0 || kv_chunk % RING_ROWS != 0))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err;
  if ((err = hopper::encode_bhtd(&mq, q, B, H, T, HD, in.b, in.h, in.t, 64)) ||
      (err = hopper::encode_bhtd(&mk, k, B, H, T, HD, in.b, in.h, in.t, 64)) ||
      (err = hopper::encode_bhtd(&mv, v, B, H, T, HD, in.b, in.h, in.t, 64)))
    return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == SAFE)
    return launch_fwd_form<HD, SAFE>(mq, mk, mv, o, os, lse, B, T, seq_len, H, 0, scale, s);
  if (form == FIXED)
    return launch_fwd_form<HD, FIXED>(mq, mk, mv, o, os, lse, B, T, seq_len, H, 0, scale, s);
  if (form == CHUNKED_SAFE)
    return launch_fwd_form<HD, CHUNKED_SAFE>(mq, mk, mv, o, os, lse, B, T, seq_len, H,
                                             kv_chunk / RING_ROWS, scale, s);
  return (int)cudaErrorInvalidValue;
}

// mode: FUSED, SPLIT, CHUNKED or BHTD; scale_b the bf16-rounded scale,
// scale_f the f32 one (BHTD takes scale_b for both). q, k, v share the
// strides `in`; each tensor is read through its own tensor map (dims (D, H,
// T, B), byte strides twice the element strides, 64-row boxes), which
// ops/flash_attention.py::tma_geometry computes alike and checks.
template <int HD, int MODE>
int launch_bwd(const void* q, const void* k, const void* v, Strides in, const void* dout,
               Strides dos_, const void* lse, const void* delta, void* dq, void* dk, void* dv,
               Strides gs, int B, int T, int seq_len, int H, float scale_b, float scale_f,
               void* stream) {
  constexpr int DKDV = MODE == BHTD ? FUSED : MODE;  // BHTD's dk/dv are FUSED's
  constexpr int DQ = MODE == BHTD ? BHTD : FUSED;    // every packed mode's dq is FUSED's
  if (B <= 0 || T <= 0 || seq_len <= 0) return (int)cudaGetLastError();
  CUtensorMap mq, mk, mv, mdo;
  int err;
  if ((err = hopper::encode_bhtd(&mq, q, B, H, T, HD, in.b, in.h, in.t, 64)) ||
      (err = hopper::encode_bhtd(&mk, k, B, H, T, HD, in.b, in.h, in.t, 64)) ||
      (err = hopper::encode_bhtd(&mv, v, B, H, T, HD, in.b, in.h, in.t, 64)) ||
      (err = hopper::encode_bhtd(&mdo, dout, B, H, T, HD, dos_.b, dos_.h, dos_.t, 64)))
    return err;
  auto* kdkdv = flash_bwd_dkdv_kernel<HD, DKDV>;
  auto* kdq = flash_bwd_dq_kernel<HD, DQ>;
  // + alignment slack; at least ONE_PER_SM, so that no second block shares
  // the SM's registers with the one whose consumers raise theirs
  constexpr int dkdv_bytes = cmax(DkdvSmem<HD, DKDV>::BYTES + 1024, ONE_PER_SM);
  constexpr int dq_bytes = cmax(DqSmem<HD>::BYTES + 1024, ONE_PER_SM);
  static bool dkdv_ok = false, dq_ok = false;
  if ((err = allow_smem(kdkdv, dkdv_bytes, dkdv_ok)) || (err = allow_smem(kdq, dq_bytes, dq_ok)))
    return err;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((T + 127) / 128, H, B);
  kdkdv<<<grid, BWD_THREADS, dkdv_bytes, s>>>(mq, mk, mv, mdo, (const float*)lse,
                                              (const float*)delta, (bf16*)dk, (bf16*)dv, gs, T,
                                              seq_len, H, scale_b, scale_f);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdq<<<grid, BWD_THREADS, dq_bytes, s>>>(mq, mk, mv, mdo, (const float*)lse,
                                          (const float*)delta, (bf16*)dq, gs, T, seq_len, H,
                                          scale_b, scale_f);
  return (int)cudaGetLastError();
}

// Packed backward at head dim D in {32, 64}, in mode FUSED, SPLIT or CHUNKED.
template <int HD>
int launch_bwd_packed(int mode, const void* q, const void* k, const void* v, Strides in,
                      const void* dout, Strides dos_, const void* lse, const void* delta,
                      void* dq, void* dk, void* dv, Strides gs, int B, int T, int seq_len,
                      int H, float scale_b, float scale_f, void* stream) {
  if (mode == FUSED)
    return launch_bwd<HD, FUSED>(q, k, v, in, dout, dos_, lse, delta, dq, dk, dv, gs, B, T,
                                 seq_len, H, scale_b, scale_f, stream);
  if (mode == SPLIT)
    return launch_bwd<HD, SPLIT>(q, k, v, in, dout, dos_, lse, delta, dq, dk, dv, gs, B, T,
                                 seq_len, H, scale_b, scale_f, stream);
  if (mode == CHUNKED)
    return launch_bwd<HD, CHUNKED>(q, k, v, in, dout, dos_, lse, delta, dq, dk, dv, gs, B, T,
                                   seq_len, H, scale_b, scale_f, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Packed layout, head dim D in {32, 64} (heads that pair into 128 lanes).
// q/k/v: bf16, element (b, t, h*D + d) at b*batch_stride + t*row_stride +
// h*D + d; o: bf16 [B, T, H*D] contiguous; lse: f32 [B, H, T]. scale: the
// bf16-rounded 1/sqrt(D), by which q is scaled in bf16. form: 0 SAFE, 1
// FIXED, 2 CHUNKED_SAFE (kv_chunk keys a group, a multiple of 128).
extern "C" int ibk_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int B, int T, int seq_len, int H, int D,
                             long long row_stride, long long batch_stride,
                             float scale, int form, int kv_chunk, void* stream) {
  const long long dm = (long long)H * D;
  const Strides in{batch_stride, D, row_stride}, os{T * dm, D, dm};
  if (D == 64)
    return launch_fwd<64>(q, k, v, in, o, os, lse, B, T, seq_len, H, scale, form, kv_chunk,
                          stream);
  if (D == 32)
    return launch_fwd<32>(q, k, v, in, o, os, lse, B, T, seq_len, H, scale, form, kv_chunk,
                          stream);
  return (int)cudaErrorInvalidValue;
}

// Backward: q/k/v as in the forward; dout bf16 [B, T, H*D] contiguous; lse,
// delta f32 [B, H, T]; dqkv bf16 [B, T, 3*H*D] contiguous (dq | dk | dv).
// mode: 0 FUSED, 1 SPLIT, 2 CHUNKED (the rounding points of the JAX
// kernels above); scale_b / scale_f: 1/sqrt(D) rounded to bf16 / in f32.
extern "C" int ibk_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dqkv, int B, int T,
                             int seq_len, int H, int D, long long row_stride,
                             long long batch_stride, float scale_b, float scale_f, int mode,
                             void* stream) {
  const long long dm = (long long)H * D;
  bf16* g = (bf16*)dqkv;
  const Strides in{batch_stride, D, row_stride}, dos_{T * dm, D, dm}, gs{3 * T * dm, D, 3 * dm};
  if (D == 64)
    return launch_bwd_packed<64>(mode, q, k, v, in, dout, dos_, lse, delta, g, g + dm,
                                 g + 2 * dm, gs, B, T, seq_len, H, scale_b, scale_f, stream);
  if (D == 32)
    return launch_bwd_packed<32>(mode, q, k, v, in, dout, dos_, lse, delta, g, g + dm,
                                 g + 2 * dm, gs, B, T, seq_len, H, scale_b, scale_f, stream);
  return (int)cudaErrorInvalidValue;
}

// BHTD layout, head dim D in {32, 64}: q, k, v share the element strides
// (in_b, in_h, in_t) of a [B, H, T, D] view, o has (o_b, o_h, o_t); lse f32
// [B, H, T] contiguous. scale: the bf16-rounded 1/sqrt(D). The JAX BHTD
// kernel takes the true row max: SAFE.
extern "C" int ibk_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int T, int seq_len, int H, int D,
                                  long long in_b, long long in_h, long long in_t,
                                  long long o_b, long long o_h, long long o_t, float scale,
                                  void* stream) {
  const Strides in{in_b, in_h, in_t}, os{o_b, o_h, o_t};
  if (D == 64)
    return launch_fwd<64>(q, k, v, in, o, os, lse, B, T, seq_len, H, scale, SAFE, 0, stream);
  if (D == 32)
    return launch_fwd<32>(q, k, v, in, o, os, lse, B, T, seq_len, H, scale, SAFE, 0, stream);
  return (int)cudaErrorInvalidValue;
}

// Backward: q, k, v as in the forward; dout with strides (do_b, do_h,
// do_t); lse, delta f32 [B, H, T]; dq, dk, dv bf16 views sharing the strides
// (g_b, g_h, g_t).
extern "C" int ibk_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv, int B, int T, int seq_len,
                                  int H, int D, long long in_b, long long in_h, long long in_t,
                                  long long do_b, long long do_h, long long do_t,
                                  long long g_b, long long g_h, long long g_t, float scale,
                                  void* stream) {
  const Strides in{in_b, in_h, in_t}, dos_{do_b, do_h, do_t}, gs{g_b, g_h, g_t};
  if (D == 64)
    return launch_bwd<64, BHTD>(q, k, v, in, dout, dos_, lse, delta, dq, dk, dv, gs, B, T,
                                seq_len, H, scale, scale, stream);
  if (D == 32)
    return launch_bwd<32, BHTD>(q, k, v, in, dout, dos_, lse, delta, dq, dk, dv, gs, B, T,
                                seq_len, H, scale, scale, stream);
  return (int)cudaErrorInvalidValue;
}
