// Attention with lse, forward and backward, over strided [B, H, T, D] views:
// the packed [B, T, H*D] layout of the ViT's qkv projection (heads that pair
// into 128 lanes: D = 64 or 32) and the BHTD layout (any other head layout).
//
// Forward. Replaces: intentbev/ops/flash_packed.py::_fwd_kernel_chunked
// (online softmax over KV tiles, the serving configuration) and ::_fwd_kernel
// (the whole key row at once), and intentbev/ops/flash_attention.py::
// _fwd_kernel (the BHTD kernel, a whole key row per 512-query block). All
// compute the same function; this kernel uses the running-max (safe)
// softmax, which equals the TPU's fixed-max variant wherever that one is
// exact (|s| < 88).
// Bound on the H100: tensor-core throughput and the exp work of the softmax.
// At B=8, T=4501, 6 heads of 64 a call is 4*B*T*T*384 = 249 GFLOP and
// 8*6*4501^2 = 972 M exponentials against ~100 MB of q/k/v/o; at 3 heads of
// 64 (ViT-Ti) half of each.
// Design: one 128-thread block per (64-query tile, head, batch); each warp
// owns 16 query rows. q is read once, scaled in bf16 (as the JAX kernels
// do: the scale itself is the bf16-rounded 1/sqrt(D)) and kept as mma.sync
// A fragments in registers. The block walks 64-key tiles of K and V staged
// in shared memory (V transposed so that the PV product reads it as
// [d][key]); S = q K^T and O += P V run on mma.sync with f32 accumulation,
// the running max and row sums stay in registers, and P is rounded to bf16
// before PV like the JAX kernels. Keys at or past seq_len get a score of
// -inf inside the kernel, so the caller pads nothing. Every tensor is read
// and written through its own batch, head and row strides (unit stride
// along D), so q, k and v can be column slices of the qkv projection's
// output and o can be written in either layout, with no copies. The TPU's
// BHTD kernel keeps a whole [512, T_pad] score panel in VMEM, which has no
// counterpart in a block's 227 KB: here it is the same online softmax as
// the packed kernel. The head dim is a template parameter (32 or 64).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int LDR = 64 + 8;  // [d][row] tiles: 64 rows (keys or queries)

// Element strides of a [B, H, T, D] view whose D stride is 1.
struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ long long at(const Strides& s, int b, int h, int r) {
  return (long long)b * s.b + (long long)h * s.h + (long long)r * s.t;
}

template <int HD>
__global__ void __launch_bounds__(128)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, Strides in, bf16* __restrict__ o, Strides os,
                     float* __restrict__ lse, int T, int seq_len, int H, float scale) {
  constexpr int LDQ = HD + 8;  // [row][d] tiles
  __shared__ __align__(16) bf16 qs[BQ * LDQ];
  __shared__ __align__(16) bf16 ks[BK * LDQ];
  __shared__ __align__(16) bf16 vt[HD * LDR];  // [d][key]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long base = at(in, b, h, 0);

  // q tile, scaled in bf16
  for (int i = tid; i < BQ * HD / 8; i += 128) {
    const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < T)
      raw = *reinterpret_cast<const uint4*>(q + base + (long long)(q0 + r) * in.t + c8);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    uint4 outv;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&outv);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ow[j] = pack_bf16x2(__bfloat162float(e[2 * j]) * scale,
                          __bfloat162float(e[2 * j + 1]) * scale);
    *reinterpret_cast<uint4*>(qs + r * LDQ + c8) = outv;
  }
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) load_a(qa[kk], qs, LDQ, wr, kk * 16, lane);

  float oacc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g+8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  const int n_tiles = (seq_len + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BK;
    __syncthreads();  // previous tile consumed
    for (int i = tid; i < BK * HD / 8; i += 128) {
      const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (kv0 + r < T) {
        const long long off = base + (long long)(kv0 + r) * in.t + c8;
        kr = *reinterpret_cast<const uint4*>(k + off);
        vr = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + r * LDQ + c8) = kr;
      const bf16* ve = reinterpret_cast<const bf16*>(&vr);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c8 + e) * LDR + r] = ve[e];
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t bfr[2];
        load_b(bfr, ks, LDQ, n * 8, kk * 16, lane);
        mma_16816(s[n], qa[kk], bfr);
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const int key = kv0 + n * 8 + 2 * t4;
      if (key >= seq_len) { s[n][0] = -INFINITY; s[n][2] = -INFINITY; }
      if (key + 1 >= seq_len) { s[n][1] = -INFINITY; s[n][3] = -INFINITY; }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    // every tile holds at least one key < seq_len, so the new max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      oacc[n][0] *= c0;
      oacc[n][1] *= c0;
      oacc[n][2] *= c1;
      oacc[n][3] *= c1;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bfr[2];
        load_b(bfr, vt, LDR, n * 8, kk * 16, lane);
        mma_16816(oacc[n], pa, bfr);
      }
    }
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(o + at(os, b, h, r0) + c) =
          pack_bf16x2(oacc[n][0] * i0, oacc[n][1] * i0);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(o + at(os, b, h, r1) + c) =
          pack_bf16x2(oacc[n][2] * i1, oacc[n][3] * i1);
  }
  if (t4 == 0) {
    if (r0 < T) lse[((size_t)b * H + h) * T + r0] = m0 + logf(l0);
    if (r1 < T) lse[((size_t)b * H + h) * T + r1] = m1 + logf(l1);
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
// At head dim 64 both scales are 1/8 and every mode is one function up to
// the order of f32 sums; at head dim 32 they differ.
// Bound on the H100: tensor-core throughput, 5 products of 2*B*H*T*T*D =
// 622 GFLOP at B=8, T=4501, 6 heads of 64 (12 heads of 32 alike); 311 GFLOP
// at 3 heads of 64 (this design recomputes the scores in both passes: 7
// products).
// Design: the TPU kernels keep dk/dv resident in VMEM across a sequential
// query-block grid (fused), hold whole [T_pad, 128] panels of q and dO
// beside [256, T_pad] f32 score tiles (split), double-buffer [256, chunk]
// score tiles (chunked), or hold a whole [T_pad, D] panel beside a
// [256, T_pad] score tile (BHTD); blocks on the H100 run in parallel and in
// no order, with 227 KB of shared memory, so every mode is split into two
// deterministic passes over 64-row tiles, as in FlashAttention-2, with no
// atomics:
//  - dkdv: one 128-thread block per (64-key tile, head, batch); each warp
//    owns 16 keys, holds k (kh for CHUNKED) and v as mma.sync A fragments
//    and walks every 64-query tile (q, scaled or not as the mode wants, and
//    dO staged in shared memory in both layouts), accumulating dk and dv in
//    registers. Keys at or past seq_len get dk = dv = 0 (JAX's split dkv
//    computes them without a key bias and zeroes them afterwards).
//  - dq: one block per (64-query tile, head, batch); each warp holds its
//    qh and dO rows as A fragments and walks the key tiles below seq_len,
//    accumulating dq in registers.
// S^T and P^T stay in registers and feed the next product as A fragments
// (the register reuse of the forward). dq, dk and dv are written through
// their strides: into one [B, T, 3*H*D] gradient of the qkv projection
// (packed) or into any [B, H, T, D] views.
// ---------------------------------------------------------------------------

enum Mode { FUSED = 0, SPLIT = 1, CHUNKED = 2, BHTD = 3 };

template <int N>
__device__ __forceinline__ void pack_a_from_c(uint32_t (&a)[4], const float (&c)[N][4],
                                              int kk) {
  a[0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Stage a 64 x HD tile of rows r0.. (row stride ld, zero past T) into
// s[row][d] and, when st is given, st[d][row]; a scale != 1 multiplies in
// f32 before the bf16 rounding (scale_s for s, scale_st for st).
__device__ __forceinline__ uint4 scale_bf16x8(uint4 raw, float scale) {
  if (scale == 1.f) return raw;
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = pack_bf16x2(__bfloat162float(e[2 * j]) * scale,
                       __bfloat162float(e[2 * j + 1]) * scale);
  return out;
}

template <int HD>
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ src, long long base,
                                           long long ld, int r0, int T, float scale_s,
                                           float scale_st, bf16* s, bf16* st, int tid) {
  constexpr int LDQ = HD + 8;
  for (int i = tid; i < 64 * HD / 8; i += 128) {
    const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) raw = *reinterpret_cast<const uint4*>(src + base + (long long)(r0 + r) * ld + c8);
    *reinterpret_cast<uint4*>(s + r * LDQ + c8) = scale_bf16x8(raw, scale_s);
    if (st) {
      const uint4 t = scale_bf16x8(raw, scale_st);
      const bf16* e = reinterpret_cast<const bf16*>(&t);
#pragma unroll
      for (int j = 0; j < 8; ++j) st[(c8 + j) * LDR + r] = e[j];
    }
  }
}

// MODE: FUSED (also BHTD's dk/dv), SPLIT or CHUNKED.
template <int HD, int MODE>
__global__ void __launch_bounds__(128)
    flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, Strides in,
                          const bf16* __restrict__ dout, Strides dos_,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, Strides gs,
                          int T, int seq_len, int H, float scale_b, float scale_f) {
  static_assert(MODE == FUSED || MODE == SPLIT || MODE == CHUNKED, "dkdv mode");
  constexpr int LDQ = HD + 8;
  // bf16 scales of the staged operands (1 = unscaled): q for the scores,
  // q for the dk product, k. FUSED: qh, qh, k; SPLIT: qh, q, k; CHUNKED:
  // q, q, kh.
  const float sq = MODE == CHUNKED ? 1.f : scale_b;
  const float sqt = MODE == FUSED ? scale_b : 1.f;
  const float sk = MODE == CHUNKED ? scale_b : 1.f;
  const float sdk = MODE == FUSED ? 1.f : scale_f;  // dk's epilogue scale
  __shared__ __align__(16) bf16 qs[BQ * LDQ];   // q [query][d], for the scores
  __shared__ __align__(16) bf16 qtr[HD * LDR];  // q [d][query], for dk
  __shared__ __align__(16) bf16 dos[BQ * LDQ];  // dO [query][d]
  __shared__ __align__(16) bf16 dot[HD * LDR];  // dO [d][query]
  __shared__ float ls[BQ], ds[BQ];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long base = at(in, b, h, 0);
  const long long obase = at(dos_, b, h, 0);
  const size_t lbase = ((size_t)b * H + h) * T;
  const int wr = warp * 16;

  // k (kh for CHUNKED) and v rows of this warp as A fragments
  stage_tile<HD>(k, base, in.t, k0, T, sk, 1.f, qs, nullptr, tid);
  stage_tile<HD>(v, base, in.t, k0, T, 1.f, 1.f, dos, nullptr, tid);
  __syncthreads();
  uint32_t ka[HD / 16][4], va[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    load_a(ka[kk], qs, LDQ, wr, kk * 16, lane);
    load_a(va[kk], dos, LDQ, wr, kk * 16, lane);
  }

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int q0 = 0; q0 < T; q0 += BQ) {
    __syncthreads();  // previous tile (or the k/v staging) consumed
    stage_tile<HD>(q, base, in.t, q0, T, sq, sqt, qs, qtr, tid);
    stage_tile<HD>(dout, obase, dos_.t, q0, T, 1.f, 1.f, dos, dot, tid);
    if (tid < BQ) {
      const bool ok = q0 + tid < T;
      ls[tid] = ok ? lse[lbase + q0 + tid] : INFINITY;  // p = 0 past T
      ds[tid] = ok ? delta[lbase + q0 + tid] : 0.f;
    }
    __syncthreads();

    float p[BQ / 8][4], t[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = t[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t bq[2], bd[2];
        load_b(bq, qs, LDQ, n * 8, kk * 16, lane);
        mma_16816(p[n], ka[kk], bq);   // S^T[key][query]
        load_b(bd, dos, LDQ, n * 8, kk * 16, lane);
        mma_16816(t[n], va[kk], bd);   // (dO v^T)^T[key][query]
      }
      const int c = n * 8 + 2 * t4;
      const float l0 = ls[c], l1 = ls[c + 1], d0 = ds[c], d1 = ds[c + 1];
      p[n][0] = expf(p[n][0] - l0);
      p[n][1] = expf(p[n][1] - l1);
      p[n][2] = expf(p[n][2] - l0);
      p[n][3] = expf(p[n][3] - l1);
      t[n][0] = p[n][0] * (t[n][0] - d0);
      t[n][1] = p[n][1] * (t[n][1] - d1);
      t[n][2] = p[n][2] * (t[n][2] - d0);
      t[n][3] = p[n][3] * (t[n][3] - d1);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], ta[4];
      pack_a_from_c(pa, p, kk);
      pack_a_from_c(ta, t, kk);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bo[2], bq[2];
        load_b(bo, dot, LDR, n * 8, kk * 16, lane);
        mma_16816(dv[n], pa, bo);
        load_b(bq, qtr, LDR, n * 8, kk * 16, lane);
        mma_16816(dk[n], ta, bq);
      }
    }
  }

  const int r0 = k0 + wr + g, r1 = r0 + 8;
  const float z0 = r0 < seq_len ? 1.f : 0.f, z1 = r1 < seq_len ? 1.f : 0.f;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (MODE != FUSED) {  // one f32 product, then the one bf16 rounding
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] *= sdk;
    }
    if (r0 < T) {
      const long long off = at(gs, b, h, r0) + c;
      *reinterpret_cast<uint32_t*>(dk_out + off) = pack_bf16x2(dk[n][0] * z0, dk[n][1] * z0);
      *reinterpret_cast<uint32_t*>(dv_out + off) = pack_bf16x2(dv[n][0] * z0, dv[n][1] * z0);
    }
    if (r1 < T) {
      const long long off = at(gs, b, h, r1) + c;
      *reinterpret_cast<uint32_t*>(dk_out + off) = pack_bf16x2(dk[n][2] * z1, dk[n][3] * z1);
      *reinterpret_cast<uint32_t*>(dv_out + off) = pack_bf16x2(dv[n][2] * z1, dv[n][3] * z1);
    }
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// MODE: FUSED (also SPLIT's and CHUNKED's dq) or BHTD.
template <int HD, int MODE>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, Strides in,
                        const bf16* __restrict__ dout, Strides dos_,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq_out, Strides gs, int T, int seq_len, int H,
                        float scale_b, float scale_f) {
  static_assert(MODE == FUSED || MODE == BHTD, "dq mode");
  constexpr int LDQ = HD + 8;
  __shared__ __align__(16) bf16 ks[BK * LDQ];   // k [key][d]
  __shared__ __align__(16) bf16 ktr[HD * LDR];  // k [d][key]
  __shared__ __align__(16) bf16 vs[BK * LDQ];   // v [key][d]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long base = at(in, b, h, 0);
  const long long obase = at(dos_, b, h, 0);
  const size_t lbase = ((size_t)b * H + h) * T;
  const int wr = warp * 16;
  const int r0 = q0 + wr + g, r1 = r0 + 8;

  stage_tile<HD>(q, base, in.t, q0, T, scale_b, 1.f, ks, nullptr, tid);
  stage_tile<HD>(dout, obase, dos_.t, q0, T, 1.f, 1.f, vs, nullptr, tid);
  __syncthreads();
  uint32_t qa[HD / 16][4], oa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    load_a(qa[kk], ks, LDQ, wr, kk * 16, lane);
    load_a(oa[kk], vs, LDQ, wr, kk * 16, lane);
  }
  const float l0 = r0 < T ? lse[lbase + r0] : 0.f, l1 = r1 < T ? lse[lbase + r1] : 0.f;
  const float d0 = r0 < T ? delta[lbase + r0] : 0.f, d1 = r1 < T ? delta[lbase + r1] : 0.f;

  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const int n_tiles = (seq_len + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BK;
    __syncthreads();  // previous tile (or the q/dO staging) consumed
    stage_tile<HD>(k, base, in.t, kv0, T, 1.f, 1.f, ks, ktr, tid);
    stage_tile<HD>(v, base, in.t, kv0, T, 1.f, 1.f, vs, nullptr, tid);
    __syncthreads();

    float p[BK / 8][4], t[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = t[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t bk_[2], bv[2];
        load_b(bk_, ks, LDQ, n * 8, kk * 16, lane);
        mma_16816(p[n], qa[kk], bk_);   // S[query][key]
        load_b(bv, vs, LDQ, n * 8, kk * 16, lane);
        mma_16816(t[n], oa[kk], bv);    // dO v^T [query][key]
      }
      const int key = kv0 + n * 8 + 2 * t4;  // keys past seq_len: p = 0
      p[n][0] = key < seq_len ? expf(p[n][0] - l0) : 0.f;
      p[n][1] = key + 1 < seq_len ? expf(p[n][1] - l0) : 0.f;
      p[n][2] = key < seq_len ? expf(p[n][2] - l1) : 0.f;
      p[n][3] = key + 1 < seq_len ? expf(p[n][3] - l1) : 0.f;
      t[n][0] = p[n][0] * (t[n][0] - d0);
      t[n][1] = p[n][1] * (t[n][1] - d0);
      t[n][2] = p[n][2] * (t[n][2] - d1);
      t[n][3] = p[n][3] * (t[n][3] - d1);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ta[4];
      pack_a_from_c(ta, t, kk);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bk_[2];
        load_b(bk_, ktr, LDR, n * 8, kk * 16, lane);
        mma_16816(dq[n], ta, bk_);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = n * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e)  // BHTD: rounded to bf16, then the bf16 scale
      dq[n][e] = MODE == BHTD ? bf16_round(dq[n][e]) * scale_b : dq[n][e] * scale_f;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(dq_out + at(gs, b, h, r0) + c) =
          pack_bf16x2(dq[n][0], dq[n][1]);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(dq_out + at(gs, b, h, r1) + c) =
          pack_bf16x2(dq[n][2], dq[n][3]);
  }
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, Strides in, void* o, Strides os,
               void* lse, int B, int T, int seq_len, int H, float scale, void* stream) {
  if (B > 0 && T > 0 && seq_len > 0) {
    dim3 grid((T + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<HD><<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, in, (bf16*)o, os, (float*)lse, T,
        seq_len, H, scale);
  }
  return (int)cudaGetLastError();
}

// mode: FUSED, SPLIT, CHUNKED or BHTD; scale_b the bf16-rounded scale,
// scale_f the f32 one (BHTD takes scale_b for both).
template <int HD, int MODE>
int launch_bwd(const void* q, const void* k, const void* v, Strides in, const void* dout,
               Strides dos_, const void* lse, const void* delta, void* dq, void* dk, void* dv,
               Strides gs, int B, int T, int seq_len, int H, float scale_b, float scale_f,
               void* stream) {
  constexpr int DKDV = MODE == BHTD ? FUSED : MODE;  // BHTD's dk/dv are FUSED's
  constexpr int DQ = MODE == BHTD ? BHTD : FUSED;    // every packed mode's dq is FUSED's
  if (B > 0 && T > 0 && seq_len > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    dim3 grid((T + BQ - 1) / BQ, H, B);
    flash_bwd_dkdv_kernel<HD, DKDV><<<grid, 128, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, in, (const bf16*)dout, dos_,
        (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, gs, T, seq_len, H,
        scale_b, scale_f);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_kernel<HD, DQ><<<grid, 128, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, in, (const bf16*)dout, dos_,
        (const float*)lse, (const float*)delta, (bf16*)dq, gs, T, seq_len, H, scale_b,
        scale_f);
  }
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
// bf16-rounded 1/sqrt(D), by which q is scaled in bf16.
extern "C" int ibk_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int B, int T, int seq_len, int H, int D,
                             long long row_stride, long long batch_stride,
                             float scale, void* stream) {
  const long long dm = (long long)H * D;
  const Strides in{batch_stride, D, row_stride}, os{T * dm, D, dm};
  if (D == 64) return launch_fwd<64>(q, k, v, in, o, os, lse, B, T, seq_len, H, scale, stream);
  if (D == 32) return launch_fwd<32>(q, k, v, in, o, os, lse, B, T, seq_len, H, scale, stream);
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
// [B, H, T] contiguous. scale: the bf16-rounded 1/sqrt(D).
extern "C" int ibk_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int T, int seq_len, int H, int D,
                                  long long in_b, long long in_h, long long in_t,
                                  long long o_b, long long o_h, long long o_t, float scale,
                                  void* stream) {
  const Strides in{in_b, in_h, in_t}, os{o_b, o_h, o_t};
  if (D == 64) return launch_fwd<64>(q, k, v, in, o, os, lse, B, T, seq_len, H, scale, stream);
  if (D == 32) return launch_fwd<32>(q, k, v, in, o, os, lse, B, T, seq_len, H, scale, stream);
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
