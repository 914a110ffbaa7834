// Int8 attention over packed [B, T, H*D] tensors, forward only. Per batch
// and head:
//   qq, qs = codes of q's rows;  kq, ks = codes of k's rows
//   sv = max(absmax of v over every row, 1e-8) / 127;  vq = codes of v / sv
//   s  = (f32(qq kq^T) * (qs * scale)) * ks, keys at or past seq_len masked
//   p  = exp(s - rowmax(s));  denom = sum(p) in f32;  pq = round(p * 127)
//   o  = (f32(pq vq) * (sv / 127)) / denom  -> bf16
// with codes clip(round(x / s), +-127), s = max(row absmax, 1e-8) / 127,
// round half to even and IEEE division (__fdiv_rn), and every product of
// the score and output chains rounded on its own (__fmul_rn), so no
// multiply-add is contracted into an FMA that would move a code.
// Replaces intentbev/ops/experimental/flash_int8.py::_fwd_kernel_int8.
//
// Bound on the H100: int8 tensor-core throughput. At [8, 4608, 384] with
// 4501 real keys the two products are 4 * B * T^2 * D = 2.49e11 integer
// operations (0.126 ms at 1979 TOPS) against ~113 MB of q, k, v and o
// (0.034 ms); the row also takes 9.7e8 exps, as the bf16 forward does.
// The crux: P's codes are rounded against the row's final max, so an
// online softmax that rescales a running accumulator computes another
// function. Design: a pre-pass quantizes k and v once per (batch, head):
// quant_k_kernel writes k's codes [B][H][Tk][D] with their row scales and
// per-tile absmax partials of v; quant_v_kernel reduces those partials to
// the panel scale sv and writes v's codes transposed ([B][H][D][Tk], keys
// contiguous) for the P.V product, the keys of each 32-key group permuted
// so that the P codes a thread holds as a score fragment are already its
// A fragment (below). The attention kernel gives each warp 16 query rows
// (a block 128 rows of one head), quantizes q into A fragments in
// registers, then walks the key tiles twice: pass 1 takes the row max of
// the scores, pass 2 recomputes the same scores (bit for bit), takes p,
// denom and P's codes and accumulates pq.vq in int32. Both products are
// mma.sync.m16n8k32 s8 from K and V tiles of 64 keys staged in shared
// memory (rows padded by 16 bytes: conflict-free fragments). The integer
// sums are exact, so the order of the keys changes only denom's f32 sum.
// The softmax's elementwise work per score, not the tensor cores, bounds
// the kernel (its time grows with the head count at a fixed width), so the
// int32 -> f32 of a score and P's round-to-int go through the mantissa of
// 1.5 * 2^23 (full-rate adds, exact here) instead of the quarter-rate
// conversion instructions, and only the last key tile tests the mask.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 128;  // query rows a block: 8 warps x 16
constexpr int THREADS = 256;
constexpr int BK = 64;   // keys a tile
constexpr int PAD = 16;  // bytes added to each shared row of codes

__device__ __forceinline__ int8_t quant(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return (int8_t)__float2int_rn(q);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the low bytes of a, b, c, d, in that order from the lowest
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// B fragment of the 32x8 int8 tile at (k0, n0) of an [n][k] array in shared
// memory (rows ld bytes apart).
__device__ __forceinline__ void load_b_s8_shared(uint32_t (&b)[2], const int8_t* s, int ld,
                                                 int n0, int k0, int lane) {
  const int8_t* p = s + (n0 + (lane >> 2)) * ld + k0 + 4 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

// Where key j of a 32-key group sits in v's codes. A score fragment gives
// lane (g, t) keys 8i + 2t and 8i + 2t + 1 of each 8-key tile i; the A
// fragment of m16n8k32 wants bytes 4t..4t+3 (and 16 + 4t..) of the group.
// So byte 4t + e (e < 4) holds key 8 (e / 2) + 2t + e % 2, and byte 16 + 4t
// + e key 16 + 8 (e / 2) + 2t + e % 2: P's codes pack into A registers as
// they come, and v's codes are stored in that order (the integer sum does
// not depend on it).
__device__ __forceinline__ int perm32(int j) {
  const int w = j & 15;
  return (j & 16) | (((w & 7) >> 1) << 2) | ((w >> 3) << 1) | (w & 1);
}

// k's codes and row scales (rows past t: codes 0, scale 0), and the absmax
// of v over each 64-row tile. Grid (Tk / 64, H, B); warp w: rows 8w..8w+7.
template <int DH>
__global__ void __launch_bounds__(THREADS)
    quant_k_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   int8_t* __restrict__ kq, float* __restrict__ ks, float* __restrict__ vmax,
                   int t, int heads, long long st, long long sb) {
  constexpr int E = DH / 32;  // values a lane
  __shared__ float red[THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tk = gridDim.x * BK;
  const size_t bh = (size_t)b * heads + h;
  float vm = 0.f;
  for (int rr = 0; rr < BK / 8; ++rr) {
    const int r = blockIdx.x * BK + warp * (BK / 8) + rr;
    float kv[E], am = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kv[e] = 0.f;
      if (r < t) {
        const size_t off = (size_t)b * sb + (size_t)r * st + h * DH + E * lane + e;
        kv[e] = __bfloat162float(k[off]);
        vm = fmaxf(vm, fabsf(__bfloat162float(v[off])));
      }
      am = fmaxf(am, fabsf(kv[e]));
    }
    const float sc = __fdiv_rn(fmaxf(warp_max(am), 1e-8f), 127.f);
    int8_t* dst = kq + (bh * tk + r) * DH + E * lane;
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = r < t ? quant(kv[e], sc) : (int8_t)0;
    if (lane == 0) ks[bh * tk + r] = r < t ? sc : 0.f;
  }
  vm = warp_max(vm);
  if (lane == 0) red[warp] = vm;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
    vmax[bh * gridDim.x + blockIdx.x] = m;
  }
}

// v's panel scale sv (from the tile partials) and its codes, transposed to
// [d][key] with the keys of each 32-key group in perm32 order (keys past t:
// 0). Grid (Tk / 64, H, B).
template <int DH>
__global__ void __launch_bounds__(THREADS)
    quant_v_kernel(const bf16* __restrict__ v, const float* __restrict__ vmax,
                   int8_t* __restrict__ vq, float* __restrict__ sv_out, int t, int heads,
                   long long st, long long sb) {
  __shared__ __align__(16) int8_t tile[DH * BK];  // [d][key, permuted]
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, nkt = gridDim.x;
  const int r0 = blockIdx.x * BK, tk = nkt * BK;
  const size_t bh = (size_t)b * heads + h;
  float m = 0.f;
  for (int i = lane; i < nkt; i += 32) m = fmaxf(m, vmax[bh * nkt + i]);
  const float sv = __fdiv_rn(fmaxf(warp_max(m), 1e-8f), 127.f);
  if (blockIdx.x == 0 && tid == 0) sv_out[bh] = sv;
  for (int i = tid; i < BK * DH / 2; i += THREADS) {
    const int j = i / (DH / 2), d = (i % (DH / 2)) * 2;
    const int r = r0 + j;
    int8_t c0 = 0, c1 = 0;
    if (r < t) {
      const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(
          v + (size_t)b * sb + (size_t)r * st + h * DH + d);
      c0 = quant(__bfloat162float(p.x), sv);
      c1 = quant(__bfloat162float(p.y), sv);
    }
    const int pj = (j & 32) | perm32(j & 31);
    tile[d * BK + pj] = c0;
    tile[(d + 1) * BK + pj] = c1;
  }
  __syncthreads();
  for (int i = tid; i < DH * BK / 16; i += THREADS) {
    const int d = i / (BK / 16), c = (i % (BK / 16)) * 16;
    *reinterpret_cast<uint4*>(vq + (bh * DH + d) * tk + r0 + c) =
        *reinterpret_cast<const uint4*>(tile + d * BK + c);
  }
}

template <int DH>
struct Tiles {
  static constexpr int LDK = DH + PAD;  // bytes a key row of the K tile
  static constexpr int LDV = BK + PAD;  // bytes a head-dim row of the V tile
  int8_t k[BK * LDK];                   // [key][d]
  int8_t v[DH * LDV];                   // [d][key, permuted]
  float ks[BK];
};

// Integer scores of a warp's 16 rows against the staged 64-key tile.
template <int DH>
__device__ __forceinline__ void tile_scores(int (&acc)[8][4], const uint32_t (&qa)[DH / 32][4],
                                            const Tiles<DH>& sm, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
  for (int kk = 0; kk < DH / 32; ++kk)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bf[2];
      load_b_s8_shared(bf, sm.k, Tiles<DH>::LDK, 8 * j, 32 * kk, lane);
      mma_s8(acc[j], qa[kk], bf);
    }
}

// int32 -> f32, exact for |i| < 2^22 (a score is at most 64 * 127^2):
// through the mantissa of 1.5 * 2^23, two full-rate operations in place of a
// quarter-rate conversion.
__device__ __forceinline__ float i2f_exact(int i) {
  return __fsub_rn(__int_as_float(0x4B400000 + i), 12582912.f);
}

// round half to even of 0 <= x < 2^22, the integer in the low bits of the
// returned bit pattern (the addition rounds; its low byte is a P code)
__device__ __forceinline__ uint32_t rint_bits(float x) {
  return __float_as_uint(__fadd_rn(x, 12582912.f));
}

// The score (f32(acc) * (qs * scale)) * ks, each product rounded.
__device__ __forceinline__ float score(int acc, float qsc, float ks) {
  return __fmul_rn(__fmul_rn(i2f_exact(acc), qsc), ks);
}

// Pass 1 on a tile: the running row max over its keys (MASK: keys at or
// past lim = seq_len - k0 left out; only the last tile needs it).
template <int DH, bool MASK>
__device__ __forceinline__ void tile_max(float (&m)[2], const int (&acc)[8][4],
                                         const float (&qsc)[2], const Tiles<DH>& sm, int t4,
                                         int lim) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = 8 * j + 2 * t4 + (e & 1);
      if (!MASK || kj < lim)
        m[e >> 1] = fmaxf(m[e >> 1], score(acc[j][e], qsc[e >> 1], sm.ks[kj]));
    }
}

// Pass 2 on a tile: p = exp(s - m) into denom, and P's codes round(p * 127)
// packed as the A fragments of the tile's two 32-key slices (perm32).
template <int DH, bool MASK>
__device__ __forceinline__ void tile_p(uint32_t (&pa)[2][4], float (&den)[2],
                                       const int (&acc)[8][4], const float (&qsc)[2],
                                       const float (&m)[2], const Tiles<DH>& sm, int t4,
                                       int lim) {
  uint32_t c[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = 8 * j + 2 * t4 + (e & 1);
      float p = 0.f;
      if (!MASK || kj < lim)
        p = expf(__fsub_rn(score(acc[j][e], qsc[e >> 1], sm.ks[kj]), m[e >> 1]));
      den[e >> 1] = __fadd_rn(den[e >> 1], p);
      c[j][e] = rint_bits(__fmul_rn(p, 127.f));
    }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int j0 = 4 * kk;
    pa[kk][0] = pack_low_bytes(c[j0][0], c[j0][1], c[j0 + 1][0], c[j0 + 1][1]);
    pa[kk][1] = pack_low_bytes(c[j0][2], c[j0][3], c[j0 + 1][2], c[j0 + 1][3]);
    pa[kk][2] = pack_low_bytes(c[j0 + 2][0], c[j0 + 2][1], c[j0 + 3][0], c[j0 + 3][1]);
    pa[kk][3] = pack_low_bytes(c[j0 + 2][2], c[j0 + 2][3], c[j0 + 3][2], c[j0 + 3][3]);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
    flash_int8_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ kq,
                      const int8_t* __restrict__ vq, const float* __restrict__ ks,
                      const float* __restrict__ svs, bf16* __restrict__ o, int t, int seq_len,
                      int heads, long long st, long long sb, float scale) {
  constexpr int KS = DH / 32;  // 32-deep slices of the head dim
  constexpr int NO = DH / 8;   // 8-wide tiles of the output
  __shared__ __align__(16) Tiles<DH> sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tk = (t + BK - 1) / BK * BK;
  const size_t bh = (size_t)b * heads + h;
  const int8_t* kq_bh = kq + bh * tk * DH;
  const int8_t* vq_bh = vq + bh * DH * tk;
  const float* ks_bh = ks + bh * tk;
  const int row_g = blockIdx.x * BQ + warp * 16 + g;  // rows row_g and row_g + 8

  // 1. q's codes, straight into A fragments: lane (g, t) holds columns
  //    32kk + 4t.. and 32kk + 16 + 4t.. of rows g and g + 8, and the four
  //    lanes of a row reduce its absmax
  uint32_t qa[KS][4];
  float qsc[2];
  {
    float x[2][KS][8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row_g + 8 * half;
      float am = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          uint2 u = make_uint2(0, 0);
          if (r < t)
            u = *reinterpret_cast<const uint2*>(q + (size_t)b * sb + (size_t)r * st + h * DH +
                                                32 * kk + 16 * part + 4 * t4);
          const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[half][kk][4 * part + i] = __bfloat162float(e[i]);
            am = fmaxf(am, fabsf(x[half][kk][4 * part + i]));
          }
        }
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, 1));
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, 2));
      const float qs = __fdiv_rn(fmaxf(am, 1e-8f), 127.f);
      qsc[half] = __fmul_rn(qs, scale);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const float* xv = &x[half][kk][4 * part];
          qa[kk][half + 2 * part] = pack_low_bytes(quant(xv[0], qs), quant(xv[1], qs),
                                                   quant(xv[2], qs), quant(xv[3], qs));
        }
    }
  }

  auto load_k = [&](int k0) {  // the K tile's codes and row scales
    for (int i = tid; i < BK * DH / 16; i += THREADS) {
      const int r = i / (DH / 16), c = (i % (DH / 16)) * 16;
      *reinterpret_cast<uint4*>(sm.k + r * Tiles<DH>::LDK + c) =
          *reinterpret_cast<const uint4*>(kq_bh + (size_t)(k0 + r) * DH + c);
    }
    if (tid < BK) sm.ks[tid] = ks_bh[k0 + tid];
  };

  // 2. pass 1: the row max of the scores over every real key
  float m[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < seq_len; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_k(k0);
    __syncthreads();
    int acc[8][4];
    tile_scores<DH>(acc, qa, sm, lane);
    if (seq_len - k0 >= BK)
      tile_max<DH, false>(m, acc, qsc, sm, t4, BK);
    else
      tile_max<DH, true>(m, acc, qsc, sm, t4, seq_len - k0);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], 1));
    m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], 2));
  }

  // 3. pass 2: the same scores, p = exp(s - m), denom, P's codes, pq.vq
  float den[2] = {0.f, 0.f};
  int oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0;
  for (int k0 = 0; k0 < seq_len; k0 += BK) {
    __syncthreads();
    load_k(k0);
    for (int i = tid; i < DH * BK / 16; i += THREADS) {
      const int d = i / (BK / 16), c = (i % (BK / 16)) * 16;
      *reinterpret_cast<uint4*>(sm.v + d * Tiles<DH>::LDV + c) =
          *reinterpret_cast<const uint4*>(vq_bh + (size_t)d * tk + k0 + c);
    }
    __syncthreads();
    int acc[8][4];
    tile_scores<DH>(acc, qa, sm, lane);
    uint32_t pa[2][4];
    if (seq_len - k0 >= BK)
      tile_p<DH, false>(pa, den, acc, qsc, m, sm, t4, BK);
    else
      tile_p<DH, true>(pa, den, acc, qsc, m, sm, t4, seq_len - k0);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bf[2];
        load_b_s8_shared(bf, sm.v, Tiles<DH>::LDV, 8 * n, 32 * kk, lane);
        mma_s8(oacc[n], pa[kk], bf);
      }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    den[half] = __fadd_rn(den[half], __shfl_xor_sync(0xffffffffu, den[half], 1));
    den[half] = __fadd_rn(den[half], __shfl_xor_sync(0xffffffffu, den[half], 2));
  }

  // 4. o = (f32(pq.vq) * (sv / 127)) / denom
  const float svc = __fdiv_rn(svs[bh], 127.f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row_g + 8 * half;
    if (r >= t) continue;
    bf16* op = o + ((size_t)b * t + r) * ((size_t)heads * DH) + h * DH;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(op + 8 * n + 2 * t4) = pack_bf16x2(
          __fdiv_rn(__fmul_rn(__int2float_rn(oacc[n][2 * half]), svc), den[half]),
          __fdiv_rn(__fmul_rn(__int2float_rn(oacc[n][2 * half + 1]), svc), den[half]));
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, void* kq, void* vq, void* ks,
           void* vmax, void* sv, int b, int t, int seq_len, int heads, long long st,
           long long sb, float scale, cudaStream_t s) {
  const dim3 pre((t + BK - 1) / BK, heads, b);
  quant_k_kernel<DH><<<pre, THREADS, 0, s>>>((const bf16*)k, (const bf16*)v, (int8_t*)kq,
                                             (float*)ks, (float*)vmax, t, heads, st, sb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quant_v_kernel<DH><<<pre, THREADS, 0, s>>>((const bf16*)v, (const float*)vmax, (int8_t*)vq,
                                             (float*)sv, t, heads, st, sb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BQ - 1) / BQ, heads, b);
  flash_int8_kernel<DH><<<grid, THREADS, 0, s>>>(
      (const bf16*)q, (const int8_t*)kq, (const int8_t*)vq, (const float*)ks,
      (const float*)sv, (bf16*)o, t, seq_len, heads, st, sb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v bf16 [B, T, H*dh] with row stride st and batch stride sb (elements;
// the same for all three, rows 16-byte aligned); o bf16 [B, T, H*dh]
// contiguous. Workspaces, with Tk = T rounded up to 64: kq int8 [B, H, Tk,
// dh], vq int8 [B, H, dh, Tk], ks f32 [B, H, Tk], vmax f32 [B, H, Tk / 64],
// sv f32 [B, H]. dh 32 or 64; scale the f32 1/sqrt(dh); keys at or past
// seq_len are masked.
extern "C" int ibk_flash_int8(const void* q, const void* k, const void* v, void* o, void* kq,
                              void* vq, void* ks, void* vmax, void* sv, int b, int t,
                              int seq_len, int heads, int dh, long long st, long long sb,
                              float scale, void* stream) {
  if (seq_len <= 0 || seq_len > t) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 64)
    return launch<64>(q, k, v, o, kq, vq, ks, vmax, sv, b, t, seq_len, heads, st, sb, scale, s);
  if (dh == 32)
    return launch<32>(q, k, v, o, kq, vq, ks, vmax, sv, b, t, seq_len, heads, st, sb, scale, s);
  return (int)cudaErrorInvalidValue;
}
