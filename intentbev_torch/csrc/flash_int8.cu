// Int8 attention over packed [B, T, H*D] tensors, forward only. Per batch
// and head:
//   qq, qs = codes of q's rows;  kq, ks = codes of k's rows
//   sv = max(absmax of v over every row, 1e-8) / 127;  vq = codes of v / sv
//   s  = (f32(qq kq^T) * (qs * scale)) * ks, keys at or past seq_len masked
//   p  = exp(s - rowmax(s));  denom = sum(p) in f32;  pq = round(p * 127)
//   o  = (f32(pq vq) * (sv / 127)) / denom  -> q's dtype (bf16 or f32)
// with codes clip(round(x / s), +-127), s = max(row absmax, 1e-8) / 127,
// round half to even and IEEE division (__fdiv_rn), and every product of
// the score and output chains rounded on its own (__fmul_rn), so no
// multiply-add is contracted into an FMA that would move a code.
// Replaces intentbev/ops/experimental/flash_int8.py::_fwd_kernel_int8.
// Head dims 16, 32, 64 and 128 (the heads pair into 128 lanes), bf16 or f32
// inputs: both are template parameters.
//
// Bound on the H100: the softmax's per-score work, not the products. At
// [8, 4608, 384] with 4501 real keys, 6 heads of 64, the two products are
// 4 * B * T^2 * D = 2.49e11 integer operations (0.126 ms at 1979 TOP/s;
// pass 1 adds half of that again) against ~113 MB of q, k, v and o (0.034
// ms), but every one of the 9.7e8 scores takes an exponential (0.25 ms at
// 16 a clock per SM on 132 SMs at 1.98 GHz) and ~21 instructions on the
// CUDA cores over the two passes (~0.6 ms at one a clock per scheduler);
// 12 heads of 32 twice as many scores, 24 of 16 four times, 3 of 128 half.
// The crux: P's codes are rounded against the row's final max, so an
// online softmax that rescales a running accumulator computes another
// function; the kernel keeps two passes over the keys.
// Design. A pre-pass quantizes k and v once per (batch, head):
// quant_k_kernel writes k's codes [B][H][Tk][KB] (KB = max(D, 64) bytes a
// row: at head dims 16 and 32 the rows are zero-padded to 64 bytes, which
// keeps the 64-byte swizzle of row 17's tiles; zeros add nothing to an
// integer sum, and the products read only the first D rounded up to 32
// bytes) with their row scales, and per-tile absmax partials of v;
// quant_v_kernel reduces those partials to the panel scale sv and writes
// v's codes transposed ([B][H][D][Tk], keys contiguous: K-major for O = P
// V, since 8-bit wgmma has no transpose), the keys of each 32-key group
// permuted so that the P codes a thread holds as a score fragment are
// already its A fragment (perm32). The attention kernel is warp-
// specialised as csrc/flash_packed.cu's SAFE forward: a block holds 64
// query rows per consumer warpgroup of one (batch, head), 3 consumers
// (160 registers) up to head dim 64 and 2 (240) at 128, whose [64, 128]
// s32 accumulator leaves no room for a third; the elementwise work is
// latency-bound at two warps a scheduler (three measured faster at 64).
// One producer warpgroup (registers lowered) has its first thread keep a
// ring of 128-key items in flight by TMA on mbarriers: pass 1 items the K
// tile [128][KB] with its 128 row scales (a bulk copy beside it: values
// read from device memory beside a busy shared memory wait on L2), pass 2
// items K, the V tile [D][128] and the scales. Each consumer quantizes its
// q rows straight into s8 A fragments in registers. Pass 1: S = Q K^T on
// wgmma m64n128k32 (A in registers, K K-major), the scores, and the row
// max (two tiles' products in flight at once with two consumers); pass 2:
// the same scores bit for bit, p = expf(s - m), denom, P's codes packed
// into A registers, and O += P V on wgmma m64nDk32 (A in registers, the V
// tile K-major), tile i - 1's P V issued beside tile i's S so that tile
// i's exponentials run under it. Only the last tile tests the mask (a tile
// wholly past seq_len is never loaded). P's round-to-int goes through the
// mantissa of 1.5 * 2^23 (a full-rate add, exact here). o goes
// out through a staging tile in shared memory as 16-byte stores; rows past
// T are never written. The integer sums are exact, so the order of the
// keys changes only denom's f32 sum (fixed: two calls give the same bits).
// PERF.md (row 18) has the variants measured against this design.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BK = 128;           // keys a ring item
constexpr int PRE_THREADS = 256;  // the pre-pass kernels
constexpr int STAGES = 3;         // ring slots
constexpr int PRODUCER_REGS = 24;
constexpr int ONE_PER_SM = 120 * 1024;  // more than half an SM's shared memory

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The attention kernel's block shape by head dim (setmaxnreg: 128 *
// PRODUCER_REGS + 128 * CONSUMERS * REGS <= 65536).
template <int DH>
struct Shape {
  static constexpr int KB = DH < 64 ? 64 : DH;   // bytes a row of k's codes
  static constexpr int KSTEPS = (DH + 31) / 32;  // 32-byte k-steps of S = Q K^T
  static constexpr int CONSUMERS = DH <= 64 ? 3 : 2;
  static constexpr int THREADS = 128 * (CONSUMERS + 1), ROWS = 64 * CONSUMERS;
  static constexpr int REGS = CONSUMERS == 2 ? 240 : 160;
};

// Shared memory: per ring slot the K tile [128][KB] (swizzled at KB bytes),
// the V tile [D][128] (swizzled at 128 bytes) and the K tile's row scales;
// then each consumer's o staging tile [64][D + 8] of q's dtype; then the
// barriers. Tiles start on 1024-byte boundaries.
template <int DH, typename T>
struct Smem {
  static constexpr int K_TILE = BK * Shape<DH>::KB, V_TILE = DH * BK;
  static constexpr int KS = K_TILE + V_TILE;  // in a slot
  static constexpr int SLOT = (KS + BK * 4 + 1023) / 1024 * 1024;
  static constexpr int OLD = DH + 8;  // staging row (elements): conflict-free writes
  static constexpr int O = STAGES * SLOT;
  static constexpr int BARS = O + Shape<DH>::CONSUMERS * 64 * OLD * (int)sizeof(T);
  static constexpr int BYTES = BARS + 2 * STAGES * 8;
  static_assert(BYTES + 1024 <= 232448, "shared memory");
};

__device__ __forceinline__ int8_t quant(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return (int8_t)__float2int_rn(q);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float absmax4(const float4& v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// four consecutive elements as f32 (8- or 16-byte aligned)
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// two consecutive elements, rounded to the element type
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// the low bytes of a, b, c, d, in that order from the lowest
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ uint32_t codes4(const float4& v, float scale) {
  return pack_low_bytes((uint8_t)quant(v.x, scale), (uint8_t)quant(v.y, scale),
                        (uint8_t)quant(v.z, scale), (uint8_t)quant(v.w, scale));
}

// Where key j of a 32-key group sits in v's codes. A score fragment gives
// lane (g, t) keys 8i + 2t and 8i + 2t + 1 of each 8-key group i; the A
// fragment of an s8 k32 product wants bytes 4t..4t+3 (and 16 + 4t..) of
// the group. So byte 4t + e (e < 4) holds key 8 (e / 2) + 2t + e % 2, and
// byte 16 + 4t + e key 16 + 8 (e / 2) + 2t + e % 2: P's codes pack into A
// registers as they come, and v's codes are stored in that order (the
// integer sum does not depend on it).
__device__ __forceinline__ int perm32(int j) {
  const int w = j & 15;
  return (j & 16) | (((w & 7) >> 1) << 2) | ((w >> 3) << 1) | (w & 1);
}

// k's codes and row scales (rows past t: codes 0, scale 0; bytes D..KB-1 of
// each row 0), and the absmax of v over each 128-row tile. Grid (Tk / 128,
// H, B); DH / 4 lanes a row, four values a lane.
template <int DH, typename T>
__global__ void __launch_bounds__(PRE_THREADS)
    quant_k_kernel(const T* __restrict__ k, const T* __restrict__ v, int8_t* __restrict__ kq,
                   float* __restrict__ ks, float* __restrict__ vmax, int t, int heads,
                   long long st, long long sb) {
  constexpr int LPR = DH / 4, RPW = 32 / LPR, KB = Shape<DH>::KB;
  __shared__ float red[PRE_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane % LPR, sub = lane / LPR;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tk = gridDim.x * BK;
  const size_t bh = (size_t)b * heads + h;
  float vm = 0.f;
  for (int r0 = warp * RPW; r0 < BK; r0 += (PRE_THREADS / 32) * RPW) {
    const int r = blockIdx.x * BK + r0 + sub;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < t) {
      const size_t off = (size_t)b * sb + (size_t)r * st + h * DH + 4 * lr;
      kv = load4(k + off);
      vm = fmaxf(vm, absmax4(load4(v + off)));
    }
    float am = absmax4(kv);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
    const float sc = __fdiv_rn(fmaxf(am, 1e-8f), 127.f);
    int8_t* row = kq + (bh * tk + r) * KB;
    *reinterpret_cast<uint32_t*>(row + 4 * lr) = r < t ? codes4(kv, sc) : 0u;
#pragma unroll
    for (int c = DH + 4 * lr; c < KB; c += DH) *reinterpret_cast<uint32_t*>(row + c) = 0u;
    if (lr == 0) ks[bh * tk + r] = r < t ? sc : 0.f;
  }
  vm = warp_max(vm);
  if (lane == 0) red[warp] = vm;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < PRE_THREADS / 32; ++w) m = fmaxf(m, red[w]);
    vmax[bh * gridDim.x + blockIdx.x] = m;
  }
}

// v's panel scale sv (from the tile partials) and its codes, transposed to
// [d][key] with the keys of each 32-key group in perm32 order (keys past t:
// 0). Grid (Tk / 128, H, B). The codes are staged in shared memory as rows
// of D + 1 bytes, one a permuted key position: the stores (4 bytes of one
// row a lane) and the transposing loads (a byte of 32 rows an odd number of
// words apart) each touch 32 banks.
template <int DH, typename T>
__global__ void __launch_bounds__(PRE_THREADS)
    quant_v_kernel(const T* __restrict__ v, const float* __restrict__ vmax,
                   int8_t* __restrict__ vq, float* __restrict__ sv_out, int t, int heads,
                   long long st, long long sb) {
  constexpr int LD = DH + 1;
  __shared__ int8_t tile[BK * LD];  // [key, permuted][d]
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, nkt = gridDim.x;
  const int r0 = blockIdx.x * BK, tk = nkt * BK;
  const size_t bh = (size_t)b * heads + h;
  float m = 0.f;
  for (int i = lane; i < nkt; i += 32) m = fmaxf(m, vmax[bh * nkt + i]);
  const float sv = __fdiv_rn(fmaxf(warp_max(m), 1e-8f), 127.f);
  if (blockIdx.x == 0 && tid == 0) sv_out[bh] = sv;
  for (int i = tid; i < BK * DH / 4; i += PRE_THREADS) {  // four values of a row a thread
    const int j = i / (DH / 4), d = (i % (DH / 4)) * 4;
    const int r = r0 + j;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < t) x = load4(v + (size_t)b * sb + (size_t)r * st + h * DH + d);
    int8_t* dst = tile + ((j & ~31) | perm32(j & 31)) * LD + d;
    dst[0] = quant(x.x, sv);
    dst[1] = quant(x.y, sv);
    dst[2] = quant(x.z, sv);
    dst[3] = quant(x.w, sv);
  }
  __syncthreads();
  for (int i = tid; i < DH * BK / 4; i += PRE_THREADS) {  // four positions of a d row a thread
    const int d = i / (BK / 4), p = (i % (BK / 4)) * 4;
    const int8_t* src = tile + p * LD + d;
    *reinterpret_cast<uint32_t*>(vq + (bh * DH + d) * tk + r0 + p) =
        pack_low_bytes((uint8_t)src[0], (uint8_t)src[LD], (uint8_t)src[2 * LD],
                       (uint8_t)src[3 * LD]);
  }
}

// round half to even of 0 <= x < 2^22, the integer in the low bits of the
// returned bit pattern (the addition rounds; its low byte is a P code)
__device__ __forceinline__ uint32_t rint_bits(float x) {
  return __float_as_uint(__fadd_rn(x, 12582912.f));
}

// The score (f32(acc) * (qs * scale)) * ks, each product rounded. The
// conversion is exact (|acc| <= 128 * 127^2 < 2^24); on sm_90 it is one
// I2FP.F32.S32, which measured faster than two full-rate operations through
// the mantissa of 1.5 * 2^23.
__device__ __forceinline__ float score(int acc, float qsc, float ks) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), qsc), ks);
}

// op over the 32 values of one row of this thread's part of a 64 x 128
// accumulator held as f32 bits (ROW 0: row g, elements 4n, 4n + 1; ROW 2:
// row g + 8), as a tree of depth 5 rather than a chain of 32.
template <int ROW, typename Op>
__device__ __forceinline__ float tree(const int (&s)[64], Op op) {
  float t[16];
#pragma unroll
  for (int n = 0; n < 16; ++n)
    t[n] = op(__int_as_float(s[4 * n + ROW]), __int_as_float(s[4 * n + ROW + 1]));
#pragma unroll
  for (int n = 0; n < 8; ++n) t[n] = op(t[n], t[n + 8]);
#pragma unroll
  for (int n = 0; n < 4; ++n) t[n] = op(t[n], t[n + 4]);
  return op(op(t[0], t[2]), op(t[1], t[3]));
}

// acc (the integer scores of a tile, accumulator layout: acc[4n + e] row g
// (+8 for e >= 2), key 8n + 2t + (e & 1)) -> the f32 scores, in place; ks
// the tile's key scales; keys at or past lim (the tile's first key's
// distance to seq_len) -> -inf.
__device__ __forceinline__ void scores_f32(int (&acc)[64], const float* ks, const float (&qsc)[2],
                                           int t4, int lim) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const float2 kv = reinterpret_cast<const float2*>(ks)[4 * n + t4];
    acc[4 * n + 0] = __float_as_int(score(acc[4 * n + 0], qsc[0], kv.x));
    acc[4 * n + 1] = __float_as_int(score(acc[4 * n + 1], qsc[0], kv.y));
    acc[4 * n + 2] = __float_as_int(score(acc[4 * n + 2], qsc[1], kv.x));
    acc[4 * n + 3] = __float_as_int(score(acc[4 * n + 3], qsc[1], kv.y));
  }
  if (lim < BK) {  // the last tile only
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int key = 8 * n + 2 * t4;
      if (key >= lim) acc[4 * n + 0] = acc[4 * n + 2] = __float_as_int(-INFINITY);
      if (key + 1 >= lim) acc[4 * n + 1] = acc[4 * n + 3] = __float_as_int(-INFINITY);
    }
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(Shape<DH>::THREADS, 1)
    flash_int8_kernel(const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv, const T* __restrict__ q,
                      const float* __restrict__ ks, const float* __restrict__ svs,
                      T* __restrict__ o, int t, int tk, int seq_len, int heads, long long st,
                      long long sb, float scale) {
  using S = Shape<DH>;
  using L = Smem<DH, T>;
  constexpr int KSTEPS = S::KSTEPS, CONSUMERS = S::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  // aligned to 1024 bytes by an offset, not through an integer, so that the
  // compiler keeps the shared address space: the key scales load as LDS
  uint8_t* sm = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + STAGES;

  // the warpgroup index through a shuffle: else ptxas takes the consumers'
  // branches for divergent paths and serialises wgmma (C7520)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q0 = blockIdx.x * S::ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * heads + h;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * CONSUMERS);  // one per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int n_tiles = (seq_len + BK - 1) / BK;

  if (wg == CONSUMERS) {  // producer: one thread issues every load
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 128 * CONSUMERS) {
      // item it < n_tiles: pass 1's K tile it; else pass 2's K and V tiles
      // it - n_tiles; each with the K tile's row scales
      const float* ks_bh = ks + bh * tk;
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int s = it % STAGES, j = it < n_tiles ? it : it - n_tiles;
        uint8_t* slot = sm + s * L::SLOT;
        hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s],
                                      L::K_TILE + BK * 4 + (it >= n_tiles ? L::V_TILE : 0));
        hopper::tma_load_2d(slot, &mk, &full[s], 0, (int)(bh * tk) + j * BK);
        hopper::bulk_load(slot + L::KS, ks_bh + j * BK, BK * 4, &full[s]);
        if (it >= n_tiles)
          hopper::tma_load_2d(slot + L::K_TILE, &mv, &full[s], j * BK, (int)(bh * DH));
      }
    }
    return;
  }

  // consumers: 64 query rows each
  hopper::setmaxnreg_inc<S::REGS>();
  const int wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_g = q0 + 64 * wg + 16 * warp + g;  // rows row_g and row_g + 8

  // 1. q's codes, straight into A fragments: lane (g, t) holds columns
  //    32kk + 4t.. and 32kk + 16 + 4t.. of rows g and g + 8 (those past D:
  //    0), and the four lanes of a row reduce its absmax
  uint32_t qa[KSTEPS][4];
  float qsc[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row_g + 8 * half;
    float4 x[KSTEPS][2];
    float am = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const int col = 32 * kk + 16 * part + 4 * t4;
        x[kk][part] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col < DH && r < t) x[kk][part] = load4(q + (size_t)b * sb + (size_t)r * st + h * DH + col);
        am = fmaxf(am, absmax4(x[kk][part]));
      }
    am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, 1));
    am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, 2));
    const float qs = __fdiv_rn(fmaxf(am, 1e-8f), 127.f);
    qsc[half] = __fmul_rn(qs, scale);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int part = 0; part < 2; ++part) qa[kk][half + 2 * part] = codes4(x[kk][part], qs);
  }

  auto slot_of = [&](int it) { return sm + (it % STAGES) * L::SLOT; };
  auto landed = [&](int it) { hopper::mbar_wait(&full[it % STAGES], (it / STAGES) & 1); };
  auto release = [&](int it) {
    if (lane == 0) hopper::mbar_arrive(&empty[it % STAGES]);
  };
  auto scores = [&](int(&acc)[64], int it) {  // acc = Q K^T of item it's K tile
    const uint32_t kt = hopper::smem_u32(slot_of(it));
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      hopper::wgmma_s8_rs<BK>(acc, qa[kk], hopper::desc_kmajor_at<S::KB>(kt + 32 * kk), kk > 0);
  };
  auto ks_of = [&](int it) { return reinterpret_cast<const float*>(slot_of(it) + L::KS); };

  // 2. pass 1: the row max of the scores over every real key
  float m[2] = {-INFINITY, -INFINITY};
  auto row_max = [&](int(&acc)[64], int it) {  // item it is tile it
    scores_f32(acc, ks_of(it), qsc, t4, seq_len - it * BK);
    m[0] = fmaxf(m[0], tree<0>(acc, [](float x, float y) { return fmaxf(x, y); }));
    m[1] = fmaxf(m[1], tree<2>(acc, [](float x, float y) { return fmaxf(x, y); }));
  };
  int sc[64];
  {
    int it = 0;
    if constexpr (CONSUMERS == 2) {  // two tiles' products in flight at once
      int sn[64];
      for (; it + 1 < n_tiles; it += 2) {
        landed(it);
        hopper::wgmma_fence();
        scores(sc, it);
        hopper::wgmma_commit();
        landed(it + 1);
        scores(sn, it + 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        row_max(sc, it);
        release(it);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sn);
        row_max(sn, it + 1);
        release(it + 1);
      }
    }
    for (; it < n_tiles; ++it) {
      landed(it);
      hopper::wgmma_fence();
      scores(sc, it);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      row_max(sc, it);
      release(it);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], 1));
    m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], 2));
  }

  // 3. pass 2: the same scores, p = exp(s - m), denom, P's codes, O += P V
  int oacc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) oacc[i] = 0;
  float den[2] = {0.f, 0.f};
  uint32_t pa[BK / 32][4];  // P's codes of the tile before, A fragments
  auto probs = [&](int(&acc)[64], int it) {  // acc -> p (f32 bits), into denom
    scores_f32(acc, ks_of(it), qsc, t4, seq_len - (it - n_tiles) * BK);
#pragma unroll
    for (int i = 0; i < 64; ++i)
      acc[i] = __float_as_int(expf(__fsub_rn(__int_as_float(acc[i]), m[(i >> 1) & 1])));
    den[0] = __fadd_rn(den[0], tree<0>(acc, [](float x, float y) { return __fadd_rn(x, y); }));
    den[1] = __fadd_rn(den[1], tree<2>(acc, [](float x, float y) { return __fadd_rn(x, y); }));
  };
  auto pack = [&](const int(&acc)[64]) {  // P's codes round(p * 127) as A fragments
    uint32_t c[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) c[i] = rint_bits(__fmul_rn(__int_as_float(acc[i]), 127.f));
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const int j = 16 * kk;  // element 4n of n = 4kk
      pa[kk][0] = pack_low_bytes(c[j + 0], c[j + 1], c[j + 4], c[j + 5]);
      pa[kk][1] = pack_low_bytes(c[j + 2], c[j + 3], c[j + 6], c[j + 7]);
      pa[kk][2] = pack_low_bytes(c[j + 8], c[j + 9], c[j + 12], c[j + 13]);
      pa[kk][3] = pack_low_bytes(c[j + 10], c[j + 11], c[j + 14], c[j + 15]);
    }
  };
  auto pv = [&](int it) {  // O += P V of item it (P in pa)
    const uint32_t vt = hopper::smem_u32(slot_of(it) + L::K_TILE);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      hopper::wgmma_s8_rs<DH>(oacc, pa[kk], hopper::desc_kmajor_at<128>(vt + 32 * kk), 1);
  };
  const int item = n_tiles;
  landed(item);
  hopper::wgmma_fence();
  scores(sc, item);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  probs(sc, item);
  pack(sc);
  for (int i = 1; i < n_tiles; ++i) {
    landed(item + i);
    hopper::wgmma_fence();
    scores(sc, item + i);
    hopper::wgmma_commit();
    pv(item + i - 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the scores of tile i
    hopper::fence_regs(sc);
    probs(sc, item + i);
    hopper::wgmma_wait<0>();  // P V of tile i - 1: its slot and pa are free
    hopper::fence_regs(oacc);
    release(item + i - 1);
    pack(sc);
  }
  hopper::wgmma_fence();
  pv(item + n_tiles - 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(oacc);
  release(item + n_tiles - 1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    den[half] = __fadd_rn(den[half], __shfl_xor_sync(0xffffffffu, den[half], 1));
    den[half] = __fadd_rn(den[half], __shfl_xor_sync(0xffffffffu, den[half], 2));
  }

  // 4. o = (f32(pq.vq) * (sv / 127)) / denom, through this warpgroup's
  //    staging tile, 16 bytes a store
  const float svc = __fdiv_rn(svs[bh], 127.f);
  T* ost = reinterpret_cast<T*>(sm + L::O) + wg * 64 * L::OLD;
  const int w0 = 16 * warp + g;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = 8 * n + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      store2(ost + (w0 + 8 * half) * L::OLD + col,
             __fdiv_rn(__fmul_rn(__int2float_rn(oacc[4 * n + 2 * half]), svc), den[half]),
             __fdiv_rn(__fmul_rn(__int2float_rn(oacc[4 * n + 2 * half + 1]), svc), den[half]));
  }
  hopper::named_sync(1 + wg, 128);
  constexpr int CHUNKS = DH * (int)sizeof(T) / 16, PER = 16 / (int)sizeof(T);  // a row's
  for (int i = wt; i < 64 * CHUNKS; i += 128) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * PER;
    const int row = q0 + 64 * wg + r;
    if (row < t)
      *reinterpret_cast<uint4*>(o + ((size_t)b * t + row) * ((size_t)heads * DH) + h * DH + c) =
          *reinterpret_cast<const uint4*>(ost + r * L::OLD + c);
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* kq, void* vq, void* ks,
           void* vmax, void* sv, int b, int t, int seq_len, int heads, long long st,
           long long sb, float scale, cudaStream_t s) {
  using L = Smem<DH, T>;
  using Sh = Shape<DH>;
  const int tk = (t + BK - 1) / BK * BK;
  CUtensorMap mk, mv;
  int err;
  // k's codes as one [B*H*Tk, KB] matrix in boxes of [128][KB]; v's as one
  // [B*H*D, Tk] matrix in boxes of [D][128]
  if ((err = hopper::encode_2d_s8(&mk, kq, b * heads * tk, Sh::KB, BK, Sh::KB)) ||
      (err = hopper::encode_2d_s8(&mv, vq, b * heads * DH, tk, DH, BK)))
    return err;
  const dim3 pre(tk / BK, heads, b);
  quant_k_kernel<DH, T><<<pre, PRE_THREADS, 0, s>>>((const T*)k, (const T*)v, (int8_t*)kq,
                                                    (float*)ks, (float*)vmax, t, heads, st, sb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  quant_v_kernel<DH, T><<<pre, PRE_THREADS, 0, s>>>((const T*)v, (const float*)vmax,
                                                    (int8_t*)vq, (float*)sv, t, heads, st, sb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto* kern = flash_int8_kernel<DH, T>;
  // + alignment slack; at least ONE_PER_SM, so that no second block shares
  // the SM's registers with the one whose consumers raise theirs
  constexpr int bytes = cmax(L::BYTES + 1024, ONE_PER_SM);
  static bool ok = false;  // the shared-memory limit is raised once
  if (!ok) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    ok = true;
  }
  const dim3 grid((t + Sh::ROWS - 1) / Sh::ROWS, heads, b);
  kern<<<grid, Sh::THREADS, bytes, s>>>(mk, mv, (const T*)q, (const float*)ks,
                                        (const float*)sv, (T*)o, t, tk, seq_len, heads, st, sb,
                                        scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* o, void* kq, void* vq,
              void* ks, void* vmax, void* sv, int b, int t, int seq_len, int heads,
              long long st, long long sb, float scale, cudaStream_t s) {
  if (dh == 16)
    return launch<16, T>(q, k, v, o, kq, vq, ks, vmax, sv, b, t, seq_len, heads, st, sb, scale, s);
  if (dh == 32)
    return launch<32, T>(q, k, v, o, kq, vq, ks, vmax, sv, b, t, seq_len, heads, st, sb, scale, s);
  if (dh == 64)
    return launch<64, T>(q, k, v, o, kq, vq, ks, vmax, sv, b, t, seq_len, heads, st, sb, scale, s);
  if (dh == 128)
    return launch<128, T>(q, k, v, o, kq, vq, ks, vmax, sv, b, t, seq_len, heads, st, sb, scale,
                          s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v [B, T, H*dh] of one dtype (f32 = 1: float, else bf16) with row
// stride st and batch stride sb (elements; the same for all three, rows
// 16-byte aligned); o [B, T, H*dh] contiguous, of q's dtype. Workspaces,
// with Tk = T rounded up to 128: kq int8 [B, H, Tk, max(dh, 64)], vq int8
// [B, H, dh, Tk], ks f32 [B, H, Tk], vmax f32 [B, H, Tk / 128], sv f32 [B,
// H]. dh 16, 32, 64 or 128; scale the f32 1/sqrt(dh); keys at or past
// seq_len are masked.
extern "C" int ibk_flash_int8(const void* q, const void* k, const void* v, void* o, void* kq,
                              void* vq, void* ks, void* vmax, void* sv, int b, int t,
                              int seq_len, int heads, int dh, int f32, long long st,
                              long long sb, float scale, void* stream) {
  if (b <= 0 || t <= 0 || seq_len <= 0 || seq_len > t) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f32)
    return launch_dh<float>(dh, q, k, v, o, kq, vq, ks, vmax, sv, b, t, seq_len, heads, st, sb,
                            scale, s);
  return launch_dh<bf16>(dh, q, k, v, o, kq, vq, ks, vmax, sv, b, t, seq_len, heads, st, sb,
                         scale, s);
}
