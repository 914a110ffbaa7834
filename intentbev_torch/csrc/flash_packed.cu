// Attention with lse, forward and backward, over strided [B, H, T, D] views:
// the packed [B, T, H*D] layout of the ViT's qkv projection (heads that pair
// into 128 lanes: D divides 128) and the BHTD layout (any other head
// layout). Every kernel reads q, k, v (and dO) through four-dimensional TMA
// tensor maps (csrc/hopper.cuh) and runs every product on wgmma.
//
// Head dims. The kernels are instantiated for three widths HD (32, 64, 128)
// and take any head dim D from 1 to 128 on the smallest instance at least D
// (Inst below); above 128 the chunked kernels (flash_*_wide_kernel) take
// it, each block owning 128 columns of its output (plan_of). The tensor map keeps the
// true D as its innermost dimension with boxes of the instance's width (or
// two boxes of 64 columns at HD = 128), so the columns from D to HD land as
// TMA's zeros, not as the next head's data: every product over them adds
// exactly nothing, and the epilogues write only the first D columns
// (rounded up to 8: a D off a multiple of 8 writes into padded rows). A
// head's row of 2*D bytes is a stride TMA takes only where D is a multiple
// of 8, so the callers copy other heads into rows padded to a multiple of 8
// columns and pass views of their first D. The scale is that of D
// (1/sqrt(D), rounded as each caller's JAX kernel rounds it), never the
// instance's nor the padded row's. EXACT (a template
// parameter) says the bf16 scale is a power of two, so that scaling a bf16
// operand and scaling the f32 sums give the same bits and the kernels skip
// the scaled copy of q or k: the entries set it at D = 64 only (at D = 16,
// the other power of two in range, the copy is exact and gives the same
// bits).
#include <math.h>

#include <type_traits>

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

// The tiles of the instance HD: 64-row TMA boxes of BOXC columns (RB-byte
// rows, swizzled at RB), NB of them side by side for a 64-row tile of HD
// columns (TILE bytes); ring tiles of KT rows (two 64-row tiles up to HD =
// 64; at HD = 128 one, which keeps the score accumulators [64 x KT] at 32
// registers and the rings inside 227 KB). QS: the products read q (and, in
// the dq pass, dO) from shared memory (wgmma A descriptors), not from
// register fragments, which at HD = 128 would take 32 registers each.
template <int HD>
struct Inst {
  static_assert(HD == 32 || HD == 64 || HD == 128, "instance width");
  static constexpr int BOXC = HD < 64 ? HD : 64;
  static constexpr int RB = 2 * BOXC;
  static constexpr int NB = HD / BOXC;
  static constexpr int BOX = 64 * RB;
  static constexpr int TILE = NB * BOX;  // 64 * HD * 2
  static constexpr int KT = HD == 128 ? 64 : 128;
  static constexpr int KTILE = KT / 64 * TILE;
  static constexpr int KB = BOXC / 16;  // 16-wide k-steps in a box
  static constexpr bool QS = HD == 128;
};

// Rows row..row + 63 of head h, batch b (every column box) into the 64-row
// tile at dst, completing on bar.
template <int HD>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* m, uint64_t* bar,
                                          int h, int row, int b) {
  using I = Inst<HD>;
#pragma unroll
  for (int c = 0; c < I::NB; ++c)
    hopper::tma_load_4d(dst + c * I::BOX, m, bar, c * I::BOXC, h, row, b);
}

// A ring tile: KT rows from row0 into consecutive 64-row tiles at dst.
template <int HD>
__device__ __forceinline__ void load_ring_tile(uint8_t* dst, const CUtensorMap* m, uint64_t* bar,
                                               int h, int row0, int b) {
  using I = Inst<HD>;
#pragma unroll
  for (int i = 0; i < I::KT / 64; ++i)
    load_rows<HD>(dst + i * I::TILE, m, bar, h, row0 + 64 * i, b);
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

// acc[64 x N] = A B^T over the head dim (the scores S, S^T and dP, dP^T):
// A this warpgroup's 64-row tile, B an N-row tile of the ring (N = KT), both
// K-major; k-step kk lies in column box kk / KB.
template <int HD, int N>
__device__ __forceinline__ void scores(float (&acc)[N / 2], const uint8_t* a, const uint8_t* b) {
  using I = Inst<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = kk / I::KB * I::BOX;
    hopper::wgmma_ss_k<N>(acc, hopper::desc_kmajor<I::RB>(a + off, kk % I::KB),
                          hopper::desc_kmajor<I::RB>(b + off, kk % I::KB), kk > 0);
  }
}

// The same with A from registers: this warpgroup's rows as A fragments, 16
// columns each (the instances up to HD = 64, whose ring tiles are 128 rows).
template <int HD, int N>
__device__ __forceinline__ void scores(float (&acc)[N / 2], const uint32_t (&a)[HD / 16][4],
                                       const uint8_t* b) {
  static_assert(N == 128 && Inst<HD>::NB == 1, "register A: the 32 and 64 instances");
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hopper::wgmma_rs_n128(acc, a[kk], hopper::desc_kmajor<Inst<HD>::RB>(b, kk), kk > 0);
}

// acc[64 x HD] += A B over k-step kk of a ring tile's rows: A the bf16
// fragments a of this warpgroup's 16 columns of P, P^T, dS or dS^T, B the
// tile's rows 16kk..16kk+15 read MN-major (N = HD; at HD = 128 across its
// two column boxes, BOX bytes apart).
template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 2], const uint32_t (&a)[4],
                                           const uint8_t* tile, int kk) {
  using I = Inst<HD>;
  if constexpr (I::NB == 1)
    hopper::wgmma_rs<HD>(acc, a, hopper::desc_mnmajor<I::RB>(tile, kk), 1);
  else
    hopper::wgmma_rs<HD>(
        acc, a, hopper::desc_mnmajor_at<I::RB>(hopper::smem_u32(tile) + kk * 16 * I::RB, I::BOX),
        1);
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
//    hide their latency, 2 at 64 and 128 (a third slows every form at 64,
//    and at 128 its o accumulator would not leave the registers);
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
// two ring tiles (k and v of KT keys, or pass 1's two k tiles), then each
// consumer's o staging tile, then the barriers. The tiles start on
// 1024-byte boundaries. HD = 128: 32 + 3 x 32 + 34 KB.
template <int HD, int FORM>
struct FwdSmem {
  using I = Inst<HD>;
  static constexpr int TILE = I::TILE;
  static constexpr int OLD = HD + 8;  // o staging row (bf16): conflict-free 4-byte writes
  static constexpr int Q = 0, RING = FwdShape<HD, FORM>::CONSUMERS * TILE, SLOT = 2 * I::KTILE;
  static constexpr int O = RING + FWD_STAGES * SLOT;
  static constexpr int BARS = O + FwdShape<HD, FORM>::CONSUMERS * 64 * OLD * 2;
  static constexpr int BYTES = BARS + (1 + 2 * FWD_STAGES) * 8;
};

// op over the NV / 2 values of one row of this thread's part of a 64 x
// (2 NV) accumulator, NV = 64 or 32 (ROW 0: row g, elements 4n, 4n + 1;
// ROW 2: row g + 8), as a tree of depth 5 or 4 rather than a chain. Every
// step is written out: a loop over the step widths left t in local memory.
template <int ROW, int NV, typename Op>
__device__ __forceinline__ float tree(const float (&s)[NV], Op op) {
  static_assert(NV == 64 || NV == 32, "a 128- or 64-key tile");
  constexpr int M = NV / 4;
  float t[M];
#pragma unroll
  for (int n = 0; n < M; ++n) t[n] = op(s[4 * n + ROW], s[4 * n + ROW + 1]);
  if constexpr (M == 16) {
#pragma unroll
    for (int n = 0; n < 8; ++n) t[n] = op(t[n], t[n + 8]);
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) t[n] = op(t[n], t[n + 4]);
  return op(op(t[0], t[2]), op(t[1], t[3]));
}

struct MaxOp {
  __device__ __forceinline__ float operator()(float x, float y) const { return fmaxf(x, y); }
};
struct AddOp {
  __device__ __forceinline__ float operator()(float x, float y) const { return x + y; }
};

// Scores of keys at or past seq_len -> -inf (the accumulator layout of
// hopper::wgmma_ss_n128; key0 the tile's first key).
template <int NV>
__device__ __forceinline__ void mask_keys(float (&sc)[NV], int key0, int seq_len, int t4) {
#pragma unroll
  for (int n = 0; n < NV / 4; ++n) {
    const int key = key0 + 8 * n + 2 * t4;
    if (key >= seq_len) sc[4 * n + 0] = sc[4 * n + 2] = -INFINITY;
    if (key + 1 >= seq_len) sc[4 * n + 1] = sc[4 * n + 3] = -INFINITY;
  }
}

// Pass 1's running row maxima over tile j's scores s (keys at or past
// seq_len masked first).
template <int NV>
__device__ __forceinline__ void row_max(float (&s)[NV], int j, int seq_len, int t4, float& mx0,
                                        float& mx1) {
  constexpr int KT = NV * 2;
  if ((j + 1) * KT > seq_len) mask_keys(s, j * KT, seq_len, t4);
  mx0 = fmaxf(mx0, tree<0>(s, MaxOp()));
  mx1 = fmaxf(mx1, tree<2>(s, MaxOp()));
}

// group_tiles: KT-key tiles per CHUNKED_SAFE group (kv_chunk / KT); D the
// true head dim (its first D columns of o are written).
template <int HD, int FORM, bool EXACT>
__global__ void __launch_bounds__(FwdShape<HD, FORM>::THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, Strides os,
                     float* __restrict__ lse, int T, int seq_len, int H, int D, int group_tiles,
                     float scale) {
  using I = Inst<HD>;
  using L = FwdSmem<HD, FORM>;
  using Shape = FwdShape<HD, FORM>;
  constexpr int TILE = L::TILE, CONSUMERS = Shape::CONSUMERS, KT = I::KT, SN = KT / 2;
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
  const int n_tiles = (seq_len + KT - 1) / KT;
  // tiles per softmax group: one group of every tile, but CHUNKED_SAFE's
  const int group = FORM == CHUNKED_SAFE ? group_tiles : n_tiles;
  if (wg == CONSUMERS) {  // producer: one thread issues every load
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 128 * CONSUMERS) {
      hopper::mbar_arrive_expect_tx(qbar, CONSUMERS * TILE);
      for (int i = 0; i < CONSUMERS; ++i)
        load_rows<HD>(sm + L::Q + i * TILE, &mq, qbar, h, q0 + 64 * i, b);
      // an item is the k tiles j and j + 1 (pass 1: a slot holds two) or the
      // k and v tiles j (pass 2)
      auto load = [&](int it, const CUtensorMap* m0, int j0, const CUtensorMap* m1, int j1) {
        const int s = it % FWD_STAGES;
        uint8_t* slot = sm + L::RING + s * L::SLOT;
        hopper::mbar_wait(&empty[s], ((it / FWD_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], (m1 ? 2 : 1) * I::KTILE);
        load_ring_tile<HD>(slot, m0, &full[s], h, j0 * KT, b);
        if (m1) load_ring_tile<HD>(slot + I::KTILE, m1, &full[s], h, j1 * KT, b);
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
      if constexpr (I::QS) hopper::fence_proxy_async();  // read by wgmma
      hopper::named_sync(1 + wg, 128);
    }
    uint32_t qa[I::QS ? 1 : HD / 16][4];  // this warp's q (qh) rows, where not QS
    if constexpr (!I::QS) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::ldmatrix_a<I::RB>(qa[kk], qt, 16 * warp, kk, lane);
    }
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
    float sc[SN], sn[SN];
    uint32_t pa[KT / 16][4];  // P of the tile before, bf16 A fragments
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
    // S = Q K^T of the ring tile at kt into sc, or into sn
    auto score = [&](const uint8_t* kt) {
      if constexpr (I::QS) scores<HD, KT>(sc, qt, kt); else scores<HD, KT>(sc, qa, kt);
    };
    auto score_next = [&](const uint8_t* kt) {
      if constexpr (I::QS) scores<HD, KT>(sn, qt, kt); else scores<HD, KT>(sn, qa, kt);
    };
    if (Shape::PINGPONG && wg == CONSUMERS - 1) their_turn();  // consumer 0 issues first
    int item = 0;
    for (int g0 = 0; g0 < n_tiles; g0 += group) {
      const int n = min(group, n_tiles - g0);  // tiles of this group
      if constexpr (FORM != FIXED) {  // pass 1: the max up to the group's last key
        float mx0 = m0, mx1 = m1;
        int i = 0;
        for (; i + 1 < n; i += 2, ++item) {  // an item of two k tiles
          landed(item);
          if constexpr (Shape::PAIR) {
            hopper::wgmma_fence();
            score(slot_of(item));
            hopper::wgmma_commit();
            score_next(slot_of(item) + I::KTILE);
            hopper::wgmma_commit();
            hopper::wgmma_wait<1>();
            hopper::fence_regs(sc);
            row_max(sc, g0 + i, seq_len, t4, mx0, mx1);
            hopper::wgmma_wait<0>();
            hopper::fence_regs(sn);
            release(item);
            row_max(sn, g0 + i + 1, seq_len, t4, mx0, mx1);
          } else {
            for (int t = 0; t < 2; ++t) {
              hopper::wgmma_fence();
              score(slot_of(item) + t * I::KTILE);
              hopper::wgmma_commit();
              hopper::wgmma_wait<0>();
              hopper::fence_regs(sc);
              if (t == 1) release(item);
              row_max(sc, g0 + i + t, seq_len, t4, mx0, mx1);
            }
          }
        }
        if (i < n) {  // an item of one
          landed(item);
          hopper::wgmma_fence();
          score(slot_of(item));
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(sc);
          release(item);
          row_max(sc, g0 + i, seq_len, t4, mx0, mx1);
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
        const uint8_t* vs = slot_of(it) + I::KTILE;
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) accumulate<HD>(acc, pa[kk], vs, kk);
        hopper::wgmma_commit();
      };
      auto softmax = [&](int j) {  // sc -> P = exp(s - m) in place, row sums
        if ((j + 1) * KT > seq_len) mask_keys(sc, j * KT, seq_len, t4);
#pragma unroll
        for (int e = 0; e < SN / 4; ++e) {
          sc[4 * e + 0] = hopper::ex2(fmaf(sc[4 * e + 0], c, -mc0));
          sc[4 * e + 1] = hopper::ex2(fmaf(sc[4 * e + 1], c, -mc0));
          sc[4 * e + 2] = hopper::ex2(fmaf(sc[4 * e + 2], c, -mc1));
          sc[4 * e + 3] = hopper::ex2(fmaf(sc[4 * e + 3], c, -mc1));
        }
        l0 += tree<0>(sc, AddOp());
        l1 += tree<2>(sc, AddOp());
      };

      landed(item);
      my_turn();
      hopper::wgmma_fence();
      score(slot_of(item));
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
        score(slot_of(item + i));
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
    if (t4 == 0) {  // m in natural units: where EXACT the sums were unscaled
      const size_t lbase = ((size_t)b * H + h) * T;
      const float mu = EXACT ? scale : 1.f;
      if (r0 < T) lse[lbase + r0] = m0 * mu + logf(l0);
      if (r1 < T) lse[lbase + r1] = m1 * mu + logf(l1);
    }
    hopper::named_sync(1 + wg, 128);
    for (int i = wt; i < 64 * HD / 8; i += 128) {  // the first D columns only
      const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
      const int row = q0 + 64 * wg + r;
      if (row < T && c8 < D)
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
// Tiles are swizzled at their box's row width (128 bytes at head dims 64
// and 128, 64 at 32), which is both the TMA map's and the wgmma
// descriptors' mode. dq, dk and dv are written through their strides (their
// first D columns): into one [B, T, 3*H*D] gradient of the qkv projection
// (packed) or into any [B, H, T, D] views. dkdv's scores keep A in shared
// memory: k and v as register fragments beside the 128-wide S^T and dP^T
// would pass the 240 registers.
// The instance HD = 128 (any head dim from 72): a 128-query ring tile of
// q, dO and qh would take 3 slots of 96 KB and the [64 x 128] S^T, dP^T
// beside dk, dv [64 x 128] 256 registers. Its ring tiles are 64 rows (3
// slots of 48 KB beside k and v's 64 KB in dkdv; of 32 KB beside q and dO's
// 64 KB in dq), so the scores take m64n64 (S^T, dP^T 32 registers each:
// dk + dv + both 192); a row of 256 bytes lands as two boxes of 64 columns
// (desc_mnmajor_at for the MN-major products); the dq pass reads q and dO
// as wgmma A descriptors from shared memory (no register fragments).
// Tried and dropped (PERF.md): issuing the next tile's scores under this
// tile's products, a pingpong of the two consumers, 4-5 ring slots, a
// producer of one warp; each measured slower or no faster.
// ---------------------------------------------------------------------------

enum Mode { FUSED = 0, SPLIT = 1, CHUNKED = 2, BHTD = 3 };

constexpr int BWD_THREADS = 384;  // two consumer warpgroups and a producer
constexpr int BWD_STAGES = 3;     // ring slots

// Shared memory of the dk/dv kernel: k and v of the block's 128 keys (two
// 64-row tiles each), then per ring slot q, dO (and qh) of KT rows each,
// then lse and delta per slot, then the barriers. Every tile starts on a
// 1024-byte boundary.
template <int HD, int MODE, bool EXACT>
struct DkdvSmem {
  using I = Inst<HD>;
  static constexpr int TILE = I::TILE;
  static constexpr bool QH = !EXACT && MODE != CHUNKED;  // a scaled copy of q
  static constexpr bool KH = !EXACT && MODE == CHUNKED;  // k scaled in place
  static constexpr int SLOT = (QH ? 3 : 2) * I::KTILE;  // q, dO (, qh): KT rows each
  static constexpr int K = 0, V = 2 * TILE, RING = 4 * TILE;
  static constexpr int LSE = RING + BWD_STAGES * SLOT;
  static constexpr int DELTA = LSE + BWD_STAGES * I::KT * 4;
  static constexpr int BARS = DELTA + BWD_STAGES * I::KT * 4;
  static constexpr int BYTES = BARS + (1 + 3 * BWD_STAGES) * 8;
};

template <int HD>
struct DqSmem {
  using I = Inst<HD>;
  static constexpr int TILE = I::TILE;
  static constexpr int Q = 0, DO = 2 * TILE, RING = 4 * TILE, SLOT = 2 * I::KTILE;  // k, v
  static constexpr int BARS = RING + BWD_STAGES * SLOT;
  static constexpr int BYTES = BARS + (1 + 2 * BWD_STAGES) * 8;
};

// MODE: FUSED (also BHTD's dk/dv), SPLIT or CHUNKED; D the true head dim.
template <int HD, int MODE, bool EXACT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, Strides gs,
                          int T, int seq_len, int H, int D, float scale_b, float scale_f) {
  static_assert(MODE == FUSED || MODE == SPLIT || MODE == CHUNKED, "dkdv mode");
  using I = Inst<HD>;
  using L = DkdvSmem<HD, MODE, EXACT>;
  constexpr int TILE = L::TILE, KT = I::KT, SN = KT / 2;
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
      if (k0 + r < T && c8 < D) {
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
  const int n_q = (T + KT - 1) / KT;
  if (wg == 2) {  // producer
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    const int p = tid - 256;
    if (p == 0) {
      hopper::mbar_arrive_expect_tx(kvbar, 4 * TILE);
      for (int i = 0; i < 2; ++i) {
        load_rows<HD>(sm + L::K + i * TILE, &mk, kvbar, h, k0 + 64 * i, b);
        load_rows<HD>(sm + L::V + i * TILE, &mv, kvbar, h, k0 + 64 * i, b);
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
        // (rows of the tile: threads p < KT)
        const int r = j * KT + p;
        const float l = r < T ? lse[lbase + r] * LOG2E : INFINITY;  // p = 0 past T
        const float d = r < T ? delta[lbase + r] : 0.f;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        if (p < KT) {
          lse_s[s * KT + p] = l;
          delta_s[s * KT + p] = d;
        }
        if (p == 0) {
          hopper::mbar_arrive_expect_tx(&full[s], 2 * I::KTILE);
          load_ring_tile<HD>(slot, &mq, &full[s], h, j * KT, b);
          load_ring_tile<HD>(slot + I::KTILE, &mdo, &full[s], h, j * KT, b);
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
      if (L::QH && j >= LAG) {  // qh = bf16(q * sb) beside q
        const int i = j - LAG, si = i % BWD_STAGES;
        uint8_t* qslot = sm + L::RING + si * L::SLOT;
        hopper::mbar_wait(&full[si], (i / BWD_STAGES) & 1);
        scale_tile(qslot, qslot + 2 * I::KTILE, I::KTILE, scale_b, p, 128);
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
    const float c = EXACT ? scale_b * LOG2E : LOG2E;
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

    for (int j = 0; j < n_q; ++j) {
      const int s = j % BWD_STAGES;
      const uint32_t ph = (j / BWD_STAGES) & 1;
      const uint8_t* qs = sm + L::RING + s * L::SLOT;
      const uint8_t* dos = qs + I::KTILE;
      const uint8_t* qh = L::QH ? qs + 2 * I::KTILE : qs;  // the scores' q
      const uint8_t* qk = MODE == FUSED ? qh : qs;         // dk's q
      hopper::mbar_wait(&full[s], ph);
      if constexpr (L::QH) hopper::mbar_wait(&ready[s], ph);

      float sc[SN], dp[SN];  // S^T and dP^T [key][query]
      hopper::wgmma_fence();
      scores<HD, KT>(sc, kt, qh);
      hopper::wgmma_commit();
      scores<HD, KT>(dp, vt, dos);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      const float* ls = lse_s + s * KT;
      const float* ds = delta_s + s * KT;
#pragma unroll
      for (int n = 0; n < SN / 4; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t4);
        sc[4 * n + 0] = hopper::ex2(sc[4 * n + 0] * c - l.x);
        sc[4 * n + 1] = hopper::ex2(sc[4 * n + 1] * c - l.y);
        sc[4 * n + 2] = hopper::ex2(sc[4 * n + 2] * c - l.x);
        sc[4 * n + 3] = hopper::ex2(sc[4 * n + 3] * c - l.y);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int n = 0; n < SN / 4; ++n) {
        const float2 d = *reinterpret_cast<const float2*>(ds + 8 * n + 2 * t4);
        dp[4 * n + 0] = sc[4 * n + 0] * (dp[4 * n + 0] - d.x);
        dp[4 * n + 1] = sc[4 * n + 1] * (dp[4 * n + 1] - d.y);
        dp[4 * n + 2] = sc[4 * n + 2] * (dp[4 * n + 2] - d.x);
        dp[4 * n + 3] = sc[4 * n + 3] * (dp[4 * n + 3] - d.y);
      }
      uint32_t pa[KT / 16][4], ta[KT / 16][4];
      hopper::pack_a(pa, sc);
      hopper::pack_a(ta, dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) accumulate<HD>(dv, pa[kk], dos, kk);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) accumulate<HD>(dk, ta[kk], qk, kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // dk's epilogue scale: FUSED's products ran over qh (or, where EXACT,
    // over q with the exact scale left for here); SPLIT and CHUNKED scale
    // the f32 sum by sf, then round once
    const float sdk = MODE == FUSED ? (EXACT ? scale_b : 1.f) : scale_f;
    const int r0 = k0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const float z0 = r0 < seq_len ? 1.f : 0.f, z1 = r1 < seq_len ? 1.f : 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (n * 8 >= D) break;  // the first D columns only
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

// MODE: FUSED (also SPLIT's and CHUNKED's dq) or BHTD; D the true head dim.
template <int HD, int MODE, bool EXACT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mdo,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq_out, Strides gs, int T, int seq_len, int H, int D,
                        float scale_b, float scale_f) {
  static_assert(MODE == FUSED || MODE == BHTD, "dq mode");
  using I = Inst<HD>;
  using L = DqSmem<HD>;
  constexpr int TILE = L::TILE, KT = I::KT, SN = KT / 2;
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
  const int n_k = (seq_len + KT - 1) / KT;
  if (wg == 2) {  // producer: one thread issues every load
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 256) {
      hopper::mbar_arrive_expect_tx(qbar, 4 * TILE);
      for (int i = 0; i < 2; ++i) {
        load_rows<HD>(sm + L::Q + i * TILE, &mq, qbar, h, q0 + 64 * i, b);
        load_rows<HD>(sm + L::DO + i * TILE, &mdo, qbar, h, q0 + 64 * i, b);
      }
      for (int j = 0; j < n_k; ++j) {
        const int s = j % BWD_STAGES;
        const uint32_t ph = (j / BWD_STAGES) & 1;
        uint8_t* slot = sm + L::RING + s * L::SLOT;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * I::KTILE);
        load_ring_tile<HD>(slot, &mk, &full[s], h, j * KT, b);
        load_ring_tile<HD>(slot + I::KTILE, &mv, &full[s], h, j * KT, b);
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
    // this warp's q (qh) and dO rows as A fragments, where not QS
    uint32_t qa[I::QS ? 1 : HD / 16][4], oa[I::QS ? 1 : HD / 16][4];
    if constexpr (!I::QS) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        hopper::ldmatrix_a<I::RB>(qa[kk], qt, 16 * warp, kk, lane);
        hopper::ldmatrix_a<I::RB>(oa[kk], ot, 16 * warp, kk, lane);
      }
    }
    const float c = EXACT ? scale_b * LOG2E : LOG2E;
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

    for (int j = 0; j < n_k; ++j) {
      const int s = j % BWD_STAGES;
      const uint32_t ph = (j / BWD_STAGES) & 1;
      const uint8_t* ks = sm + L::RING + s * L::SLOT;
      const uint8_t* vs = ks + I::KTILE;
      hopper::mbar_wait(&full[s], ph);

      float sc[SN], dp[SN];  // S and dP [query][key]
      hopper::wgmma_fence();
      if constexpr (I::QS) scores<HD, KT>(sc, qt, ks); else scores<HD, KT>(sc, qa, ks);
      hopper::wgmma_commit();
      if constexpr (I::QS) scores<HD, KT>(dp, ot, vs); else scores<HD, KT>(dp, oa, vs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
#pragma unroll
      for (int n = 0; n < SN / 4; ++n) {  // keys past seq_len: p = 0
        const int key = j * KT + 8 * n + 2 * t4;
        const bool m0 = key < seq_len, m1 = key + 1 < seq_len;
        sc[4 * n + 0] = m0 ? hopper::ex2(sc[4 * n + 0] * c - l0) : 0.f;
        sc[4 * n + 1] = m1 ? hopper::ex2(sc[4 * n + 1] * c - l0) : 0.f;
        sc[4 * n + 2] = m0 ? hopper::ex2(sc[4 * n + 2] * c - l1) : 0.f;
        sc[4 * n + 3] = m1 ? hopper::ex2(sc[4 * n + 3] * c - l1) : 0.f;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int n = 0; n < SN / 4; ++n) {
        dp[4 * n + 0] = sc[4 * n + 0] * (dp[4 * n + 0] - d0);
        dp[4 * n + 1] = sc[4 * n + 1] * (dp[4 * n + 1] - d0);
        dp[4 * n + 2] = sc[4 * n + 2] * (dp[4 * n + 2] - d1);
        dp[4 * n + 3] = sc[4 * n + 3] * (dp[4 * n + 3] - d1);
      }
      uint32_t ta[KT / 16][4];
      hopper::pack_a(ta, dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) accumulate<HD>(dq, ta[kk], ks, kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (n * 8 >= D) break;  // the first D columns only
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

// ---------------------------------------------------------------------------
// Head dims above 128 (row 16: the BHTD kernels; such heads never pair into
// 128 lanes, so the packed route never sees them). The accumulators of a
// whole head do not fit: at D = 256 the forward's o alone would take 128
// registers a consumer thread, dk + dv 256, and a resident q for two 64-row
// consumers 256 * D bytes of shared memory (192 KB at 768). So each block
// owns one chunk of at most WIDE_COLS = 128 columns of its output (o, dq, or
// dk and dv), a grid axis runs over the ceil(D / 128) chunks, and every
// chunk keeps the 128 instance's register layout (64-key tiles, the scores
// m64n64). The score products S = qh k^T and dP = dO v^T reduce over the
// whole head dim in 64-column boxes that stream through the ring beside the
// rows they meet (q stays in no block), so every chunk computes the same S,
// P and dP: the forward does 2c + 1 products of T*T*D against the bound's
// 2, the backward 5c + 3 against 5 (c the chunks; dk and dv take a pass
// each, S^T in both). Only chunk 0 writes lse.
// q arrives scaled, qh = bf16(q * scale), as the JAX wrapper scales it
// before its kernels (intentbev/ops/flash_attention.py:291), so the scores
// need no scale and dq's epilogue is the BHTD one: bf16(bf16(dS k) * sb).
//
// A ring item is either a score box, the 64 columns kb of 128 rows of the
// block's own tensor (A: each consumer's 64 rows, K-major) and of 64 rows of
// the streamed one (B, K-major), 24 KB; or a chunk tile, 64 rows of one or
// two tensors at the chunk's 128 columns (two 64-column boxes, read
// MN-major by the products that accumulate over rows), 16 or 32 KB. Every
// wgmma group is waited for inside its item, so none is in flight across a
// loop's back edge.
// ---------------------------------------------------------------------------

constexpr int WIDE_COLS = 128;  // output columns a block owns (Inst<128>'s layout)
using Wide = Inst<WIDE_COLS>;   // BOX 8 KB (64 rows x 64 columns), TILE 16 KB, KT 64
constexpr int WIDE_SCORE = 3 * Wide::BOX;  // a score item: A 2 boxes (128 rows), B 1

// Loads score box kb: rows a0..a0+127 of ma (A) and b0..b0+63 of mb (B).
__device__ __forceinline__ void load_score_box(uint8_t* dst, const CUtensorMap* ma, int a0,
                                               const CUtensorMap* mb, int b0, uint64_t* bar,
                                               int kb, int h, int b) {
  hopper::tma_load_4d(dst, ma, bar, 64 * kb, h, a0, b);
  hopper::tma_load_4d(dst + Wide::BOX, ma, bar, 64 * kb, h, a0 + 64, b);
  hopper::tma_load_4d(dst + 2 * Wide::BOX, mb, bar, 64 * kb, h, b0, b);
}

// Loads the chunk tile: rows r0..r0+63 of m at columns c0..c0+127.
__device__ __forceinline__ void load_chunk_tile(uint8_t* dst, const CUtensorMap* m, int r0,
                                                int c0, uint64_t* bar, int h, int b) {
  hopper::tma_load_4d(dst, m, bar, c0, h, r0, b);
  hopper::tma_load_4d(dst + Wide::BOX, m, bar, c0 + 64, h, r0, b);
}

// acc[64 x 64] (+)= this consumer's 64 A rows times the item's 64 B rows^T
// over the box's 64 columns (first: the first box of a product).
__device__ __forceinline__ void score_box(float (&acc)[32], const uint8_t* item, int wg,
                                          bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_ss_k<64>(acc, hopper::desc_kmajor<Wide::RB>(item + wg * Wide::BOX, kk),
                           hopper::desc_kmajor<Wide::RB>(item + 2 * Wide::BOX, kk),
                           first && kk == 0 ? 0 : 1);
}

constexpr int WIDE_FWD_STAGES = 6, WIDE_DQ_STAGES = 6, WIDE_DKDV_STAGES = 6;

// A consumer's ring: items in the producer's order, each slot released by
// the consumer's four warps.
template <int STAGES>
struct WideRing {
  uint8_t* base;
  int slot_bytes;
  uint64_t *full, *empty;
  __device__ __forceinline__ uint8_t* slot(int it) const {
    return base + (it % STAGES) * slot_bytes;
  }
  __device__ __forceinline__ void landed(int it) const {
    hopper::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
  }
  __device__ __forceinline__ void release(int it, int lane) const {
    if (lane == 0) hopper::mbar_arrive(&empty[it % STAGES]);
  }
  // the producer's wait for slot it to be free
  __device__ __forceinline__ void free_slot(int it) const {
    hopper::mbar_wait(&empty[it % STAGES], ((it / STAGES) & 1) ^ 1);
  }
};

// acc = the product over the head dim's nkb boxes, items it.. (it advanced).
template <int STAGES>
__device__ __forceinline__ void wide_scores(float (&acc)[32], const WideRing<STAGES>& ring,
                                            int& it, int nkb, int wg, int lane) {
  for (int kb = 0; kb < nkb; ++kb, ++it) {
    ring.landed(it);
    hopper::wgmma_fence();
    score_box(acc, ring.slot(it), wg, kb == 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    ring.release(it, lane);
  }
}

// The forward's shared memory: the ring, then each consumer's o staging tile
// (rows of 136 bf16), then the barriers.
struct WideFwdSmem {
  static constexpr int SLOT = WIDE_SCORE;  // a v chunk tile (16 KB) fits
  static constexpr int OLD = WIDE_COLS + 8;
  static constexpr int RING = 0, O = WIDE_FWD_STAGES * SLOT;
  static constexpr int BARS = O + 2 * 64 * OLD * 2;
  static constexpr int BYTES = BARS + 2 * WIDE_FWD_STAGES * 8;
};

// The forward (SAFE, the BHTD kernel's true row max) over chunk blockIdx.x %
// chunks of o: block (128 queries, chunk), head, batch; two consumers of 64
// queries and a producer warpgroup whose first thread issues every load.
// Pass 1 runs the scores and the row max; pass 2 the scores again, P =
// exp(s - m) rounded to bf16 and O += P V over the chunk's columns of v.
__global__ void __launch_bounds__(384, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                          Strides os, float* __restrict__ lse, int T, int seq_len, int H, int D,
                          int chunks) {
  using L = WideFwdSmem;
  constexpr int STAGES = WIDE_FWD_STAGES, KT = 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  const WideRing<STAGES> ring{sm + L::RING, L::SLOT, bars, bars + STAGES};
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x % chunks, q0 = blockIdx.x / chunks * 128;
  const int c0 = chunk * WIDE_COLS;
  const int h = blockIdx.y, b = blockIdx.z;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], 8);  // one per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  const int n_tiles = (seq_len + KT - 1) / KT, nkb = (D + 63) / 64;
  if (wg == 2) {  // producer
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 256) {
      int it = 0;
      for (int pass = 0; pass < 2; ++pass)
        for (int j = 0; j < n_tiles; ++j) {
          for (int kb = 0; kb < nkb; ++kb, ++it) {
            ring.free_slot(it);
            uint64_t* bar = &ring.full[it % STAGES];
            hopper::mbar_arrive_expect_tx(bar, WIDE_SCORE);
            load_score_box(ring.slot(it), &mq, q0, &mk, j * KT, bar, kb, h, b);
          }
          if (pass == 1) {
            ring.free_slot(it);
            uint64_t* bar = &ring.full[it % STAGES];
            hopper::mbar_arrive_expect_tx(bar, Wide::TILE);
            load_chunk_tile(ring.slot(it), &mv, j * KT, c0, bar, h, b);
            ++it;
          }
        }
    }
  } else {  // consumers: 64 queries each
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int wt = tid % 128, warp = wt / 32, lane = tid % 32;
    const int t4 = lane & 3, g = lane >> 2;
    float acc[64], sc[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int it = 0;
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int j = 0; j < n_tiles; ++j) {  // pass 1: the row max
      wide_scores(sc, ring, it, nkb, wg, lane);
      row_max(sc, j, seq_len, t4, m0, m1);
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o_));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o_));
    }
    const float c = LOG2E, mc0 = m0 * c, mc1 = m1 * c;  // the scores are qh k^T
    float l0 = 0.f, l1 = 0.f;
    for (int j = 0; j < n_tiles; ++j) {  // pass 2: P = exp(s - m), O += P V
      wide_scores(sc, ring, it, nkb, wg, lane);
      if ((j + 1) * KT > seq_len) mask_keys(sc, j * KT, seq_len, t4);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sc[4 * e + 0] = hopper::ex2(fmaf(sc[4 * e + 0], c, -mc0));
        sc[4 * e + 1] = hopper::ex2(fmaf(sc[4 * e + 1], c, -mc0));
        sc[4 * e + 2] = hopper::ex2(fmaf(sc[4 * e + 2], c, -mc1));
        sc[4 * e + 3] = hopper::ex2(fmaf(sc[4 * e + 3], c, -mc1));
      }
      l0 += tree<0>(sc, AddOp());
      l1 += tree<2>(sc, AddOp());
      uint32_t pa[4][4];
      hopper::pack_a(pa, sc);
      ring.landed(it);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) accumulate<WIDE_COLS>(acc, pa[kk], ring.slot(it), kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      ring.release(it, lane);
      ++it;
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
    for (int n = 0; n < WIDE_COLS / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(ost + w0 * L::OLD + col) =
          pack_bf16x2(acc[4 * n + 0] / l0, acc[4 * n + 1] / l0);
      *reinterpret_cast<uint32_t*>(ost + (w0 + 8) * L::OLD + col) =
          pack_bf16x2(acc[4 * n + 2] / l1, acc[4 * n + 3] / l1);
    }
    const int r0 = q0 + 64 * wg + w0, r1 = r0 + 8;
    if (chunk == 0 && t4 == 0) {  // one writer of lse: every chunk has the same m and d
      const size_t lbase = ((size_t)b * H + h) * T;
      if (r0 < T) lse[lbase + r0] = m0 + logf(l0);
      if (r1 < T) lse[lbase + r1] = m1 + logf(l1);
    }
    hopper::named_sync(1 + wg, 128);
    for (int i = wt; i < 64 * WIDE_COLS / 8; i += 128) {  // the chunk's columns below D
      const int r = i / (WIDE_COLS / 8), c8 = (i % (WIDE_COLS / 8)) * 8;
      const int row = q0 + 64 * wg + r;
      if (row < T && c0 + c8 < D)
        *reinterpret_cast<uint4*>(o + at(os, b, h, row) + c0 + c8) =
            *reinterpret_cast<const uint4*>(ost + r * L::OLD + c8);
    }
  }
}

// The dq pass: block (128 queries, chunk), head, batch. Per 64-key tile the
// ring carries S's boxes (qh rows, k tile), dP's (dO rows, v tile), then the
// k tile at the chunk's columns for dQ += dS K.
struct WideDqSmem {
  static constexpr int SLOT = WIDE_SCORE;  // a k chunk tile (16 KB) fits
  static constexpr int BARS = WIDE_DQ_STAGES * SLOT;
  static constexpr int BYTES = BARS + 2 * WIDE_DQ_STAGES * 8;
};

__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq_out, Strides gs, int T, int seq_len, int H, int D,
                         int chunks, float scale_b) {
  using L = WideDqSmem;
  constexpr int STAGES = WIDE_DQ_STAGES, KT = 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  const WideRing<STAGES> ring{sm, L::SLOT, bars, bars + STAGES};
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x % chunks, q0 = blockIdx.x / chunks * 128;
  const int c0 = chunk * WIDE_COLS;
  const int h = blockIdx.y, b = blockIdx.z;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  const int n_k = (seq_len + KT - 1) / KT, nkb = (D + 63) / 64;
  if (wg == 2) {  // producer
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 256) {
      int it = 0;
      for (int j = 0; j < n_k; ++j) {
        for (int pr = 0; pr < 2; ++pr)  // S's boxes, then dP's
          for (int kb = 0; kb < nkb; ++kb, ++it) {
            ring.free_slot(it);
            uint64_t* bar = &ring.full[it % STAGES];
            hopper::mbar_arrive_expect_tx(bar, WIDE_SCORE);
            load_score_box(ring.slot(it), pr ? &mdo : &mq, q0, pr ? &mv : &mk, j * KT, bar, kb,
                           h, b);
          }
        ring.free_slot(it);
        uint64_t* bar = &ring.full[it % STAGES];
        hopper::mbar_arrive_expect_tx(bar, Wide::TILE);
        load_chunk_tile(ring.slot(it), &mk, j * KT, c0, bar, h, b);
        ++it;
      }
    }
  } else {  // consumers: 64 queries each
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int wt = tid % 128, warp = wt / 32, lane = tid % 32;
    const int t4 = lane & 3, g = lane >> 2;
    const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const size_t lbase = ((size_t)b * H + h) * T;
    // rows past T read dO = 0, so t = 0 there; their dq is not written
    const float l0 = r0 < T ? lse[lbase + r0] * LOG2E : 0.f;
    const float l1 = r1 < T ? lse[lbase + r1] * LOG2E : 0.f;
    const float d0 = r0 < T ? delta[lbase + r0] : 0.f;
    const float d1 = r1 < T ? delta[lbase + r1] : 0.f;
    float dq[64], sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    int it = 0;
    for (int j = 0; j < n_k; ++j) {
      wide_scores(sc, ring, it, nkb, wg, lane);
      wide_scores(dp, ring, it, nkb, wg, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n) {  // keys past seq_len: p = 0
        const int key = j * KT + 8 * n + 2 * t4;
        const bool k0 = key < seq_len, k1 = key + 1 < seq_len;
        sc[4 * n + 0] = k0 ? hopper::ex2(sc[4 * n + 0] * LOG2E - l0) : 0.f;
        sc[4 * n + 1] = k1 ? hopper::ex2(sc[4 * n + 1] * LOG2E - l0) : 0.f;
        sc[4 * n + 2] = k0 ? hopper::ex2(sc[4 * n + 2] * LOG2E - l1) : 0.f;
        sc[4 * n + 3] = k1 ? hopper::ex2(sc[4 * n + 3] * LOG2E - l1) : 0.f;
        dp[4 * n + 0] = sc[4 * n + 0] * (dp[4 * n + 0] - d0);
        dp[4 * n + 1] = sc[4 * n + 1] * (dp[4 * n + 1] - d0);
        dp[4 * n + 2] = sc[4 * n + 2] * (dp[4 * n + 2] - d1);
        dp[4 * n + 3] = sc[4 * n + 3] * (dp[4 * n + 3] - d1);
      }
      uint32_t ta[4][4];
      hopper::pack_a(ta, dp);
      ring.landed(it);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) accumulate<WIDE_COLS>(dq, ta[kk], ring.slot(it), kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      ring.release(it, lane);
      ++it;
    }
#pragma unroll
    for (int n = 0; n < WIDE_COLS / 8; ++n) {
      const int col = c0 + n * 8 + 2 * t4;
      if (c0 + n * 8 >= D) break;  // the chunk's columns below D
      // BHTD: rounded to bf16, then the bf16 scale
      if (r0 < T)
        *reinterpret_cast<uint32_t*>(dq_out + at(gs, b, h, r0) + col) = pack_bf16x2(
            bf16_round(dq[4 * n]) * scale_b, bf16_round(dq[4 * n + 1]) * scale_b);
      if (r1 < T)
        *reinterpret_cast<uint32_t*>(dq_out + at(gs, b, h, r1) + col) = pack_bf16x2(
            bf16_round(dq[4 * n + 2]) * scale_b, bf16_round(dq[4 * n + 3]) * scale_b);
    }
  }
}

// The dk and dv passes: block (128 keys, chunk), head, batch; DK picks the
// output. Per 64-query tile the ring carries S^T's boxes (k rows, qh tile),
// for dk also dP^T's (v rows, dO tile), then the tile at the chunk's
// columns (qh for dK += dS^T qh, dO for dV += P^T dO) with the tile's lse
// and delta, which the producer warpgroup stages beside it. dk and dv take
// a pass each: both accumulators (128 registers) beside S^T and dP^T left
// ptxas too few registers for its wgmma (C7512 and a 48-byte spill), and the
// dv pass needs no dP^T.
struct WideDkdvSmem {
  static constexpr int SLOT = WIDE_SCORE;  // a chunk tile (16 KB) fits
  static constexpr int LSE = WIDE_DKDV_STAGES * SLOT;
  static constexpr int DELTA = LSE + WIDE_DKDV_STAGES * 64 * 4;
  static constexpr int BARS = DELTA + WIDE_DKDV_STAGES * 64 * 4;
  static constexpr int BYTES = BARS + 2 * WIDE_DKDV_STAGES * 8;
};

template <bool DK>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkdv_wide_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const __grid_constant__ CUtensorMap mdo,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ out, Strides gs, int T, int seq_len, int H,
                               int D, int chunks) {
  using L = WideDkdvSmem;
  constexpr int STAGES = WIDE_DKDV_STAGES, KT = 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  const WideRing<STAGES> ring{sm, L::SLOT, bars, bars + STAGES};
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x % chunks, k0 = blockIdx.x / chunks * 128;
  const int c0 = chunk * WIDE_COLS;
  const int h = blockIdx.y, b = blockIdx.z;
  if (k0 >= seq_len) {  // every key of the block is masked: dk = dv = 0
    for (int i = tid; i < 128 * WIDE_COLS / 8; i += 384) {
      const int r = i / (WIDE_COLS / 8), c8 = c0 + (i % (WIDE_COLS / 8)) * 8;
      if (k0 + r < T && c8 < D)
        *reinterpret_cast<uint4*>(out + at(gs, b, h, k0 + r) + c8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&ring.full[s], 128);  // the producer warpgroup
      hopper::mbar_init(&ring.empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  const int n_q = (T + KT - 1) / KT, nkb = (D + 63) / 64;
  if (wg == 2) {  // producer: every thread walks the items, the first loads
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    const int p = tid - 256;
    const size_t lbase = ((size_t)b * H + h) * T;
    int it = 0;
    for (int j = 0; j < n_q; ++j) {
      for (int pr = 0; pr < (DK ? 2 : 1); ++pr)  // S^T's boxes, then dP^T's
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          ring.free_slot(it);
          uint64_t* bar = &ring.full[it % STAGES];
          if (p == 0) {
            hopper::mbar_arrive_expect_tx(bar, WIDE_SCORE);
            load_score_box(ring.slot(it), pr ? &mv : &mk, k0, pr ? &mdo : &mq, j * KT, bar, kb,
                           h, b);
          } else {
            hopper::mbar_arrive(bar);
          }
        }
      // the tile's lse and delta (rows past T: lse = +inf, so p = 0), read
      // before the slot is free
      const int r = j * KT + p;
      const float l = r < T ? lse[lbase + r] * LOG2E : INFINITY;
      const float d = DK && r < T ? delta[lbase + r] : 0.f;
      ring.free_slot(it);
      const int s = it % STAGES;
      float* lse_s = reinterpret_cast<float*>(sm + L::LSE) + s * KT;
      float* delta_s = reinterpret_cast<float*>(sm + L::DELTA) + s * KT;
      if (p < KT) {
        lse_s[p] = l;
        delta_s[p] = d;
      }
      uint64_t* bar = &ring.full[s];
      if (p == 0) {
        hopper::mbar_arrive_expect_tx(bar, Wide::TILE);
        load_chunk_tile(ring.slot(it), DK ? &mq : &mdo, j * KT, c0, bar, h, b);
      } else {
        hopper::mbar_arrive(bar);
      }
      ++it;
    }
  } else {  // consumers: 64 keys each
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int wt = tid % 128, warp = wt / 32, lane = tid % 32;
    const int t4 = lane & 3, g = lane >> 2;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int it = 0;
    for (int j = 0; j < n_q; ++j) {
      float sc[32], dp[32];  // S^T and dP^T [key][query]
      wide_scores(sc, ring, it, nkb, wg, lane);
      if constexpr (DK) wide_scores(dp, ring, it, nkb, wg, lane);
      ring.landed(it);
      const int s = it % STAGES;
      const float* ls = reinterpret_cast<const float*>(sm + L::LSE) + s * KT;
      const float* ds = reinterpret_cast<const float*>(sm + L::DELTA) + s * KT;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t4);
        sc[4 * n + 0] = hopper::ex2(sc[4 * n + 0] * LOG2E - l.x);
        sc[4 * n + 1] = hopper::ex2(sc[4 * n + 1] * LOG2E - l.y);
        sc[4 * n + 2] = hopper::ex2(sc[4 * n + 2] * LOG2E - l.x);
        sc[4 * n + 3] = hopper::ex2(sc[4 * n + 3] * LOG2E - l.y);
        if constexpr (DK) {
          const float2 d = *reinterpret_cast<const float2*>(ds + 8 * n + 2 * t4);
          dp[4 * n + 0] = sc[4 * n + 0] * (dp[4 * n + 0] - d.x);
          dp[4 * n + 1] = sc[4 * n + 1] * (dp[4 * n + 1] - d.y);
          dp[4 * n + 2] = sc[4 * n + 2] * (dp[4 * n + 2] - d.x);
          dp[4 * n + 3] = sc[4 * n + 3] * (dp[4 * n + 3] - d.y);
        }
      }
      uint32_t fa[4][4];  // dS^T (dk) or P^T (dv) as bf16 A fragments
      if constexpr (DK) hopper::pack_a(fa, dp); else hopper::pack_a(fa, sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) accumulate<WIDE_COLS>(acc, fa[kk], ring.slot(it), kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      ring.release(it, lane);
      ++it;
    }
    const int r0 = k0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const float z0 = r0 < seq_len ? 1.f : 0.f, z1 = r1 < seq_len ? 1.f : 0.f;
#pragma unroll
    for (int n = 0; n < WIDE_COLS / 8; ++n) {
      if (c0 + n * 8 >= D) break;  // the chunk's columns below D
      const int col = c0 + n * 8 + 2 * t4;
      if (r0 < T)
        *reinterpret_cast<uint32_t*>(out + at(gs, b, h, r0) + col) =
            pack_bf16x2(acc[4 * n] * z0, acc[4 * n + 1] * z0);
      if (r1 < T)
        *reinterpret_cast<uint32_t*>(out + at(gs, b, h, r1) + col) =
            pack_bf16x2(acc[4 * n + 2] * z1, acc[4 * n + 3] * z1);
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

// The maps of q, k, v (and dO) at the instance HD: dims (D, H, T, B) with
// the true D, boxes of 64 rows and Inst<HD>::BOXC columns.
template <int HD>
int encode(CUtensorMap* map, const void* x, Strides st, int B, int H, int T, int D) {
  return hopper::encode_bhtd(map, x, B, H, T, D, st.b, st.h, st.t, 64, Inst<HD>::BOXC);
}

template <int HD, int FORM, bool EXACT>
int launch_fwd_form(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o,
                    Strides os, void* lse, int B, int T, int seq_len, int H, int D,
                    int group_tiles, float scale, cudaStream_t s) {
  auto* kern = flash_fwd_kernel<HD, FORM, EXACT>;
  // + alignment slack; at least ONE_PER_SM, so that no second block shares
  // the SM's registers with the one whose consumers raise theirs
  constexpr int bytes = cmax(FwdSmem<HD, FORM>::BYTES + 1024, ONE_PER_SM);
  static bool ok = false;
  int err;
  if ((err = allow_smem(kern, bytes, ok))) return err;
  using Shape = FwdShape<HD, FORM>;
  dim3 grid((T + Shape::ROWS - 1) / Shape::ROWS, H, B);
  kern<<<grid, Shape::THREADS, bytes, s>>>(mq, mk, mv, (bf16*)o, os, (float*)lse, T, seq_len, H,
                                        D, group_tiles, scale);
  return (int)cudaGetLastError();
}

// form: SAFE, FIXED or CHUNKED_SAFE (kv_chunk keys a group, a multiple of
// the instance's key tile); scale the bf16-rounded 1/sqrt(D). q, k, v share
// the strides `in` and are read through tensor maps (dims (D, H, T, B),
// 64-row boxes), as the backward reads them.
template <int HD, bool EXACT>
int launch_fwd(const void* q, const void* k, const void* v, Strides in, void* o, Strides os,
               void* lse, int B, int T, int seq_len, int H, int D, float scale, int form,
               int kv_chunk, void* stream) {
  constexpr int KT = Inst<HD>::KT;
  if (B <= 0 || T <= 0 || seq_len <= 0) return (int)cudaGetLastError();
  if (form == CHUNKED_SAFE && (kv_chunk <= 0 || kv_chunk % KT != 0))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err;
  if ((err = encode<HD>(&mq, q, in, B, H, T, D)) || (err = encode<HD>(&mk, k, in, B, H, T, D)) ||
      (err = encode<HD>(&mv, v, in, B, H, T, D)))
    return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == SAFE)
    return launch_fwd_form<HD, SAFE, EXACT>(mq, mk, mv, o, os, lse, B, T, seq_len, H, D, 0,
                                            scale, s);
  if (form == FIXED)
    return launch_fwd_form<HD, FIXED, EXACT>(mq, mk, mv, o, os, lse, B, T, seq_len, H, D, 0,
                                             scale, s);
  if (form == CHUNKED_SAFE)
    return launch_fwd_form<HD, CHUNKED_SAFE, EXACT>(mq, mk, mv, o, os, lse, B, T, seq_len, H, D,
                                                    kv_chunk / KT, scale, s);
  return (int)cudaErrorInvalidValue;
}

// mode: FUSED, SPLIT, CHUNKED or BHTD; scale_b the bf16-rounded scale,
// scale_f the f32 one (BHTD takes scale_b for both). q, k, v share the
// strides `in`; each tensor is read through its own tensor map (dims (D, H,
// T, B), byte strides twice the element strides, 64-row boxes of the
// instance's columns), which ops/flash_attention.py::tma_geometry computes
// alike and checks.
template <int HD, int MODE, bool EXACT>
int launch_bwd(const void* q, const void* k, const void* v, Strides in, const void* dout,
               Strides dos_, const void* lse, const void* delta, void* dq, void* dk, void* dv,
               Strides gs, int B, int T, int seq_len, int H, int D, float scale_b, float scale_f,
               void* stream) {
  constexpr int DKDV = MODE == BHTD ? FUSED : MODE;  // BHTD's dk/dv are FUSED's
  constexpr int DQ = MODE == BHTD ? BHTD : FUSED;    // every packed mode's dq is FUSED's
  if (B <= 0 || T <= 0 || seq_len <= 0) return (int)cudaGetLastError();
  CUtensorMap mq, mk, mv, mdo;
  int err;
  if ((err = encode<HD>(&mq, q, in, B, H, T, D)) || (err = encode<HD>(&mk, k, in, B, H, T, D)) ||
      (err = encode<HD>(&mv, v, in, B, H, T, D)) ||
      (err = encode<HD>(&mdo, dout, dos_, B, H, T, D)))
    return err;
  auto* kdkdv = flash_bwd_dkdv_kernel<HD, DKDV, EXACT>;
  auto* kdq = flash_bwd_dq_kernel<HD, DQ, EXACT>;
  // + alignment slack; at least ONE_PER_SM, so that no second block shares
  // the SM's registers with the one whose consumers raise theirs
  constexpr int dkdv_bytes = cmax(DkdvSmem<HD, DKDV, EXACT>::BYTES + 1024, ONE_PER_SM);
  constexpr int dq_bytes = cmax(DqSmem<HD>::BYTES + 1024, ONE_PER_SM);
  static bool dkdv_ok = false, dq_ok = false;
  if ((err = allow_smem(kdkdv, dkdv_bytes, dkdv_ok)) || (err = allow_smem(kdq, dq_bytes, dq_ok)))
    return err;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((T + 127) / 128, H, B);
  kdkdv<<<grid, BWD_THREADS, dkdv_bytes, s>>>(mq, mk, mv, mdo, (const float*)lse,
                                              (const float*)delta, (bf16*)dk, (bf16*)dv, gs, T,
                                              seq_len, H, D, scale_b, scale_f);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdq<<<grid, BWD_THREADS, dq_bytes, s>>>(mq, mk, mv, mdo, (const float*)lse,
                                          (const float*)delta, (bf16*)dq, gs, T, seq_len, H, D,
                                          scale_b, scale_f);
  return (int)cudaGetLastError();
}

// Packed backward at the instance HD, in mode FUSED, SPLIT or CHUNKED.
template <int HD, bool EXACT>
int launch_bwd_packed(int mode, const void* q, const void* k, const void* v, Strides in,
                      const void* dout, Strides dos_, const void* lse, const void* delta,
                      void* dq, void* dk, void* dv, Strides gs, int B, int T, int seq_len,
                      int H, int D, float scale_b, float scale_f, void* stream) {
  if (mode == FUSED)
    return launch_bwd<HD, FUSED, EXACT>(q, k, v, in, dout, dos_, lse, delta, dq, dk, dv, gs, B,
                                        T, seq_len, H, D, scale_b, scale_f, stream);
  if (mode == SPLIT)
    return launch_bwd<HD, SPLIT, EXACT>(q, k, v, in, dout, dos_, lse, delta, dq, dk, dv, gs, B,
                                        T, seq_len, H, D, scale_b, scale_f, stream);
  if (mode == CHUNKED)
    return launch_bwd<HD, CHUNKED, EXACT>(q, k, v, in, dout, dos_, lse, delta, dq, dk, dv, gs,
                                          B, T, seq_len, H, D, scale_b, scale_f, stream);
  return (int)cudaErrorInvalidValue;
}

// The maps of the chunked instance: boxes of 64 rows and 64 columns.
int encode_wide(CUtensorMap* map, const void* x, Strides st, int B, int H, int T, int D) {
  return hopper::encode_bhtd(map, x, B, H, T, D, st.b, st.h, st.t, 64, 64);
}

// Output chunks of head dim D (ceil(D / WIDE_COLS)).
constexpr int wide_chunks(int D) { return (D + WIDE_COLS - 1) / WIDE_COLS; }

int launch_wide_fwd(const void* q, Strides qs, const void* k, const void* v, Strides in, void* o,
                    Strides os, void* lse, int B, int T, int seq_len, int H, int D, void* stream) {
  if (B <= 0 || T <= 0 || seq_len <= 0) return (int)cudaGetLastError();
  CUtensorMap mq, mk, mv;
  int err;
  if ((err = encode_wide(&mq, q, qs, B, H, T, D)) || (err = encode_wide(&mk, k, in, B, H, T, D)) ||
      (err = encode_wide(&mv, v, in, B, H, T, D)))
    return err;
  constexpr int bytes = cmax(WideFwdSmem::BYTES + 1024, ONE_PER_SM);
  static bool ok = false;
  if ((err = allow_smem(flash_fwd_wide_kernel, bytes, ok))) return err;
  const int chunks = wide_chunks(D);
  dim3 grid((T + 127) / 128 * chunks, H, B);
  flash_fwd_wide_kernel<<<grid, 384, bytes, (cudaStream_t)stream>>>(
      mq, mk, mv, (bf16*)o, os, (float*)lse, T, seq_len, H, D, chunks);
  return (int)cudaGetLastError();
}

int launch_wide_bwd(const void* q, Strides qs, const void* k, const void* v, Strides in,
                    const void* dout, Strides dos_, const void* lse, const void* delta, void* dq,
                    void* dk, void* dv, Strides gs, int B, int T, int seq_len, int H, int D,
                    float scale_b, void* stream) {
  if (B <= 0 || T <= 0 || seq_len <= 0) return (int)cudaGetLastError();
  CUtensorMap mq, mk, mv, mdo;
  int err;
  if ((err = encode_wide(&mq, q, qs, B, H, T, D)) || (err = encode_wide(&mk, k, in, B, H, T, D)) ||
      (err = encode_wide(&mv, v, in, B, H, T, D)) ||
      (err = encode_wide(&mdo, dout, dos_, B, H, T, D)))
    return err;
  constexpr int dkdv_bytes = cmax(WideDkdvSmem::BYTES + 1024, ONE_PER_SM);
  constexpr int dq_bytes = cmax(WideDqSmem::BYTES + 1024, ONE_PER_SM);
  static bool dk_ok = false, dv_ok = false, dq_ok = false;
  if ((err = allow_smem(flash_bwd_dkdv_wide_kernel<true>, dkdv_bytes, dk_ok)) ||
      (err = allow_smem(flash_bwd_dkdv_wide_kernel<false>, dkdv_bytes, dv_ok)) ||
      (err = allow_smem(flash_bwd_dq_wide_kernel, dq_bytes, dq_ok)))
    return err;
  const int chunks = wide_chunks(D);
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((T + 127) / 128 * chunks, H, B);
  for (const bool dk_pass : {false, true}) {
    auto* kern = dk_pass ? flash_bwd_dkdv_wide_kernel<true> : flash_bwd_dkdv_wide_kernel<false>;
    kern<<<grid, 384, dkdv_bytes, s>>>(mq, mk, mv, mdo, (const float*)lse, (const float*)delta,
                                       (bf16*)(dk_pass ? dk : dv), gs, T, seq_len, H, D, chunks);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  flash_bwd_dq_wide_kernel<<<grid, 384, dq_bytes, s>>>(mq, mk, mv, mdo, (const float*)lse,
                                                   (const float*)delta, (bf16*)dq, gs, T, seq_len,
                                                   H, D, chunks, scale_b);
  return (int)cudaGetLastError();
}

// The plan of head dim D, which ops/flash_attention.py::instance mirrors:
// the instance (the smallest of 32, 64, 128 at least D; above 128 the
// chunked kernels, each block 128 output columns), the output chunks (1;
// ceil(D / 128) above 128) and the padded row (D rounded up to 8 columns:
// a head's row of 2 * padded bytes is a stride TMA takes; the callers copy
// heads whose D is off a multiple of 8 into rows of that width).
struct Plan {
  int inst, chunks, padded;
};
constexpr Plan plan_of(int D) {
  return {D <= 32 ? 32 : D <= 64 ? 64 : 128, D <= 128 ? 1 : wide_chunks(D), (D + 7) / 8 * 8};
}

// Calls launch(std::integral_constant<int, HD>{}, std::bool_constant<EXACT>{})
// for head dim D's instance (plan_of), EXACT where the bf16 scale 1/sqrt(D)
// is the power of two 1/8 (D = 64). Refuses D < 1 and the chunked head dims
// above 128, which take the ibk_flash_attn_wide_* entries.
template <typename F>
int by_head_dim(int D, F&& launch) {
  if (D < 1 || plan_of(D).chunks != 1) return (int)cudaErrorInvalidValue;
  if (D == 64) return launch(std::integral_constant<int, 64>{}, std::true_type{});
  if (D <= 32) return launch(std::integral_constant<int, 32>{}, std::false_type{});
  if (D <= 64) return launch(std::integral_constant<int, 64>{}, std::false_type{});
  return launch(std::integral_constant<int, 128>{}, std::false_type{});
}

}  // namespace

// out[0..2] = plan_of(D): instance, chunks, padded row. cudaErrorInvalidValue
// for D < 1.
extern "C" int ibk_flash_plan(int D, int* out) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(D);
  out[0] = p.inst;
  out[1] = p.chunks;
  out[2] = p.padded;
  return 0;
}

// Packed layout, head dim D from 1 to 128 (heads that pair into 128 lanes:
// D divides 128). q/k/v: bf16, element (b, t, h, d) at b*batch_stride +
// t*row_stride + h*head_stride + d (head_stride D, or the padded row of a D
// off a multiple of 8); o: bf16 [B, T, H, head_stride] contiguous, its first
// D columns a head written; lse: f32 [B, H, T]. scale: the bf16-rounded
// 1/sqrt(D), by which q is scaled in bf16. form: 0 SAFE, 1 FIXED, 2
// CHUNKED_SAFE (kv_chunk keys a group, a multiple of 128).
extern "C" int ibk_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int B, int T, int seq_len, int H, int D,
                             long long row_stride, long long batch_stride, long long head_stride,
                             float scale, int form, int kv_chunk, void* stream) {
  const long long hs = head_stride, dm = (long long)H * hs;
  const Strides in{batch_stride, hs, row_stride}, os{T * dm, hs, dm};
  return by_head_dim(D, [&](auto hd, auto exact) {
    return launch_fwd<decltype(hd)::value, decltype(exact)::value>(
        q, k, v, in, o, os, lse, B, T, seq_len, H, D, scale, form, kv_chunk, stream);
  });
}

// Backward: q/k/v as in the forward; dout bf16 [B, T, H, head_stride]
// contiguous; lse, delta f32 [B, H, T]; dqkv bf16 [B, T, 3, H, head_stride]
// contiguous (dq | dk | dv; the first D columns a head written). mode: 0
// FUSED, 1 SPLIT, 2 CHUNKED (the rounding points of the JAX kernels above);
// scale_b / scale_f: 1/sqrt(D) rounded to bf16 / in f32.
extern "C" int ibk_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dqkv, int B, int T,
                             int seq_len, int H, int D, long long row_stride,
                             long long batch_stride, long long head_stride, float scale_b,
                             float scale_f, int mode, void* stream) {
  const long long hs = head_stride, dm = (long long)H * hs;
  bf16* g = (bf16*)dqkv;
  const Strides in{batch_stride, hs, row_stride}, dos_{T * dm, hs, dm},
      gs{3 * T * dm, hs, 3 * dm};
  return by_head_dim(D, [&](auto hd, auto exact) {
    return launch_bwd_packed<decltype(hd)::value, decltype(exact)::value>(
        mode, q, k, v, in, dout, dos_, lse, delta, g, g + dm, g + 2 * dm, gs, B, T, seq_len, H,
        D, scale_b, scale_f, stream);
  });
}

// BHTD layout, head dim D from 1 to 128: q, k, v share the element strides
// (in_b, in_h, in_t) of a [B, H, T, D] view, o has (o_b, o_h, o_t); lse f32
// [B, H, T] contiguous. scale: the bf16-rounded 1/sqrt(D). The JAX BHTD
// kernel takes the true row max: SAFE.
extern "C" int ibk_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int T, int seq_len, int H, int D,
                                  long long in_b, long long in_h, long long in_t,
                                  long long o_b, long long o_h, long long o_t, float scale,
                                  void* stream) {
  const Strides in{in_b, in_h, in_t}, os{o_b, o_h, o_t};
  return by_head_dim(D, [&](auto hd, auto exact) {
    return launch_fwd<decltype(hd)::value, decltype(exact)::value>(
        q, k, v, in, o, os, lse, B, T, seq_len, H, D, scale, SAFE, 0, stream);
  });
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
  return by_head_dim(D, [&](auto hd, auto exact) {
    return launch_bwd<decltype(hd)::value, BHTD, decltype(exact)::value>(
        q, k, v, in, dout, dos_, lse, delta, dq, dk, dv, gs, B, T, seq_len, H, D, scale, scale,
        stream);
  });
}

// BHTD layout, head dim D above 128 (plan_of: chunks > 1): qh = bf16(q *
// scale) with its own strides (qh_b, qh_h, qh_t), as the JAX wrapper scales
// q before its kernels; k and v share (in_b, in_h, in_t); o (o_b, o_h,
// o_t); lse f32 [B, H, T] contiguous, written by chunk 0's blocks.
extern "C" int ibk_flash_attn_wide_fwd(const void* qh, const void* k, const void* v, void* o,
                                       void* lse, int B, int T, int seq_len, int H, int D,
                                       long long qh_b, long long qh_h, long long qh_t,
                                       long long in_b, long long in_h, long long in_t,
                                       long long o_b, long long o_h, long long o_t,
                                       void* stream) {
  if (D < 1 || plan_of(D).chunks < 2) return (int)cudaErrorInvalidValue;
  return launch_wide_fwd(qh, Strides{qh_b, qh_h, qh_t}, k, v, Strides{in_b, in_h, in_t}, o,
                         Strides{o_b, o_h, o_t}, lse, B, T, seq_len, H, D, stream);
}

// Backward above 128: qh, k, v as in the forward; dout (do_b, do_h, do_t);
// lse, delta f32 [B, H, T]; dq, dk, dv bf16 views sharing (g_b, g_h, g_t).
// scale: the bf16-rounded 1/sqrt(D), dq's epilogue scale (dq = bf16(bf16(dS
// k) * scale), the autodiff of q's scaling).
extern "C" int ibk_flash_attn_wide_bwd(const void* qh, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, void* dk, void* dv, int B, int T, int seq_len,
                                       int H, int D, long long qh_b, long long qh_h,
                                       long long qh_t, long long in_b, long long in_h,
                                       long long in_t, long long do_b, long long do_h,
                                       long long do_t, long long g_b, long long g_h,
                                       long long g_t, float scale, void* stream) {
  if (D < 1 || plan_of(D).chunks < 2) return (int)cudaErrorInvalidValue;
  return launch_wide_bwd(qh, Strides{qh_b, qh_h, qh_t}, k, v, Strides{in_b, in_h, in_t}, dout,
                         Strides{do_b, do_h, do_t}, lse, delta, dq, dk, dv,
                         Strides{g_b, g_h, g_t}, B, T, seq_len, H, D, scale, stream);
}
