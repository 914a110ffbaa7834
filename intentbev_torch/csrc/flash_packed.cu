// Attention forward over the packed [B, T, H*64] layout, with lse.
//
// Replaces: intentbev/ops/flash_packed.py::_fwd_kernel_chunked (online
// softmax over KV tiles, the serving configuration) and ::_fwd_kernel (the
// whole key row at once). Both compute the same function; this kernel uses
// the running-max (safe) softmax, which equals the TPU's fixed-max variant
// wherever that one is exact (|s| < 88).
// Bound on the H100: tensor-core throughput and the exp work of the softmax.
// At B=8, T=4501, 6 heads of 64 a call is 4*B*T*T*384 = 249 GFLOP and
// 8*6*4501^2 = 972 M exponentials against ~100 MB of q/k/v/o.
// Design: one 128-thread block per (64-query tile, head, batch); each warp
// owns 16 query rows. q is read once, scaled in bf16 (as the JAX kernel
// does) and kept as mma.sync A fragments in registers. The block walks
// 64-key tiles of K and V staged in shared memory (V transposed so that
// the PV product reads it as [d][key]); S = q K^T and O += P V run on
// mma.sync with f32 accumulation, the running max and row sums stay in
// registers, and P is rounded to bf16 before PV like the JAX kernel.
// Keys at or past seq_len get a score of -inf inside the kernel, so the
// caller pads nothing. q, k and v are read through strides, so they can be
// column slices of the qkv projection's output with no split copies.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int HD = 64;   // head dim
constexpr int LDS = HD + 8;

__global__ void __launch_bounds__(128)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int T, int seq_len, int H,
                     long long row_stride, long long batch_stride, float scale) {
  __shared__ __align__(16) bf16 qs[BQ * LDS];
  __shared__ __align__(16) bf16 ks[BK * LDS];
  __shared__ __align__(16) bf16 vt[HD * LDS];  // [d][key]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * batch_stride + (size_t)h * HD;

  // q tile, scaled in bf16
  for (int i = tid; i < BQ * HD / 8; i += 128) {
    const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < T)
      raw = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * row_stride + c8);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    uint4 outv;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&outv);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ow[j] = pack_bf16x2(__bfloat162float(e[2 * j]) * scale,
                          __bfloat162float(e[2 * j + 1]) * scale);
    *reinterpret_cast<uint4*>(qs + r * LDS + c8) = outv;
  }
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(qa[kk], qs, LDS, wr, kk * 16, lane);

  float oacc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
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
        const size_t off = base + (size_t)(kv0 + r) * row_stride + c8;
        kr = *reinterpret_cast<const uint4*>(k + off);
        vr = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + r * LDS + c8) = kr;
      const bf16* ve = reinterpret_cast<const bf16*>(&vr);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c8 + e) * LDS + r] = ve[e];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bfr[2];
        load_b(bfr, ks, LDS, n * 8, kk * 16, lane);
        mma_16816(s[n], qa[kk], bfr);
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
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
    for (int n = 0; n < 8; ++n) {
      oacc[n][0] *= c0;
      oacc[n][1] *= c0;
      oacc[n][2] *= c1;
      oacc[n][3] *= c1;
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bfr[2];
        load_b(bfr, vt, LDS, n * 8, kk * 16, lane);
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
  const int dm = H * HD;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = h * HD + n * 8 + 2 * t4;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(o + ((size_t)b * T + r0) * dm + c) =
          pack_bf16x2(oacc[n][0] * i0, oacc[n][1] * i0);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(o + ((size_t)b * T + r1) * dm + c) =
          pack_bf16x2(oacc[n][2] * i1, oacc[n][3] * i1);
  }
  if (t4 == 0) {
    if (r0 < T) lse[((size_t)b * H + h) * T + r0] = m0 + logf(l0);
    if (r1 < T) lse[((size_t)b * H + h) * T + r1] = m1 + logf(l1);
  }
}

}  // namespace

// q/k/v: bf16, element (b, t, h*64 + d) at b*batch_stride + t*row_stride +
// h*64 + d; o: bf16 [B, T, H*64] contiguous; lse: f32 [B, H, T].
extern "C" int ibk_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int B, int T, int seq_len, int H,
                             long long row_stride, long long batch_stride,
                             float scale, void* stream) {
  if (B > 0 && T > 0 && seq_len > 0) {
    dim3 grid((T + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
        T, seq_len, H, row_stride, batch_stride, scale);
  }
  return (int)cudaGetLastError();
}
