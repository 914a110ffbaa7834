// Shared device helpers for the port's hand-written Hopper kernels.
//
// Matrix products use the warp-level tensor-core instruction
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) through inline PTX. Fragment
// layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A 16x16 (row-major): a0 = (g, 2t..2t+1)    a1 = (g+8, 2t..2t+1)
//                        a2 = (g, 2t+8..2t+9)  a3 = (g+8, 2t+8..2t+9)
//   B 16x8  (k x n):     b0 = (k 2t..2t+1, n g) b1 = (k 2t+8..2t+9, n g)
//   C 16x8  (f32):       c0,c1 = (g, 2t..2t+1)  c2,c3 = (g+8, 2t..2t+1)
// Each 32-bit register holds two bf16 values, the lower column in the low
// half. Shared-memory operands are stored so that the two values of one
// register are adjacent: A as [row][k], B as [n][k].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of the 16x16 tile at (r0, k0) of a [row][k] array, stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld,
                                       int r0, int k0, int lane) {
  const bf16* p = s + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// B fragment of the 16x8 tile at (k0, n0) of an [n][k] array, stride ld.
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const bf16* s, int ld,
                                       int n0, int k0, int lane) {
  const bf16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

// GELU of the block MLPs: 0 = exact erf, 1 = x * sigmoid(1.702 x) (the
// serving variant).
template <int GELU>
__device__ __forceinline__ float gelu(float v) {
  if (GELU == 0) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v / (1.f + expf(-1.702f * v));
}

// d/dv of the exact erf GELU (the backward kernels; training takes only it).
__device__ __forceinline__ float dgelu_erf(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * 0.3989422804014327f * expf(-0.5f * v * v);
}

// Integer products: mma.sync.m16n8k32 (s8 x s8 -> s32). In bytes, its
// fragments sit where those of m16n8k16 bf16 do: a 32-bit register holds
// four int8 of one row (A) or one column (B), at byte 4t (and 4t + 16) of
// the 32-byte K slice, rows g and g+8 for A, column g for B; C as above.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of the 16x32 int8 tile at (r0, k0) of a [row][k] array whose
// rows are ld bytes apart.
__device__ __forceinline__ void load_a_s8(uint32_t (&a)[4], const int8_t* s, int ld,
                                          int r0, int k0, int lane) {
  const int8_t* p = s + (size_t)(r0 + (lane >> 2)) * ld + k0 + 4 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 16);
}

// B fragment of the 32x8 int8 tile at (k0, n0) of an [n][k] array in device
// memory (rows ld bytes apart), read through the read-only cache.
__device__ __forceinline__ void load_b_s8(uint32_t (&b)[2], const int8_t* w, int ld,
                                          int n0, int k0, int lane) {
  const int8_t* p = w + (size_t)(n0 + (lane >> 2)) * ld + k0 + 4 * (lane & 3);
  b[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  b[1] = __ldg(reinterpret_cast<const unsigned int*>(p + 16));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Column sums of per-block partials: out[c] = sum_p part[p * width + c],
// p in order (deterministic). One thread per column.
static __global__ void sum_partials_kernel(const float* __restrict__ part, int n_parts,
                                           int width, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[(size_t)p * width + c];
  out[c] = s;
}

static inline void sum_partials(const float* part, int n_parts, int width, float* out,
                                cudaStream_t stream) {
  sum_partials_kernel<<<(width + 255) / 256, 256, 0, stream>>>(part, n_parts, width, out);
}

// Split-K C = A^T B over rows, the weight gradients of the backward kernels:
// A [R][M], B [R][N] (bf16, row-major), C [M][N] f32. Each split
// (blockIdx.z) of the rows writes an f32 partial [M][N] into part, 64 x 64
// output tiles a block (mma.sync), and sum_partials adds the partials in a
// fixed order, so the result is deterministic (no atomics). M and N are
// multiples of 64; part holds splits * M * N floats.
constexpr int ATB_T = 64;              // output tile (M and N)
constexpr int ATB_K = 64;              // rows per staged chunk
constexpr int ATB_LDK = ATB_K + 8;

static __global__ void __launch_bounds__(256)
    gemm_at_b_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     float* __restrict__ part, int R, int M, int N, int rows_per_split) {
  __shared__ __align__(16) bf16 as[ATB_T * ATB_LDK];  // [m][r]
  __shared__ __align__(16) bf16 bs[ATB_T * ATB_LDK];  // [n][r]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * ATB_T, n0 = blockIdx.y * ATB_T;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += ATB_K) {
    __syncthreads();  // previous chunk consumed
    for (int i = tid; i < ATB_K * ATB_T / 8; i += 256) {
      const int r = i / (ATB_T / 8), c8 = (i % (ATB_T / 8)) * 8;
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (r0 + r < r_end) {
        va = *reinterpret_cast<const uint4*>(A + (size_t)(r0 + r) * M + m0 + c8);
        vb = *reinterpret_cast<const uint4*>(B + (size_t)(r0 + r) * N + n0 + c8);
      }
      const bf16* ea = reinterpret_cast<const bf16*>(&va);
      const bf16* eb = reinterpret_cast<const bf16*>(&vb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        as[(c8 + e) * ATB_LDK + r] = ea[e];
        bs[(c8 + e) * ATB_LDK + r] = eb[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < ATB_K; k0 += 16) {
      uint32_t a[4];
      load_a(a, as, ATB_LDK, wr, k0, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t b[2];
        load_b(b, bs, ATB_LDK, wc + n * 8, k0, lane);
        mma_16816(acc[n], a, b);
      }
    }
  }
  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = n0 + wc + n * 8 + 2 * t4;
    const int r = m0 + wr + g;
    out[(size_t)r * N + c] = acc[n][0];
    out[(size_t)r * N + c + 1] = acc[n][1];
    out[(size_t)(r + 8) * N + c] = acc[n][2];
    out[(size_t)(r + 8) * N + c + 1] = acc[n][3];
  }
}

static inline int gemm_at_b(const bf16* A, const bf16* B, float* part, float* out, int R,
                            int M, int N, int splits, cudaStream_t s) {
  const int per = ((R + splits - 1) / splits + ATB_K - 1) / ATB_K * ATB_K;
  dim3 grid(M / ATB_T, N / ATB_T, splits);
  gemm_at_b_kernel<<<grid, 256, 0, s>>>(A, B, part, R, M, N, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials(part, splits, M * N, out, s);
  return (int)cudaGetLastError();
}

// B fragment of the 16x8 tile at (k0, n0) of a [k][n] array (stride ld),
// read as scalars: for operands stored with the contraction axis outermost.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[2], const bf16* s, int ld,
                                          int n0, int k0, int lane) {
  const bf16* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  __nv_bfloat162 v0, v1;
  v0.x = p[0];
  v0.y = p[ld];
  v1.x = p[8 * ld];
  v1.y = p[9 * ld];
  b[0] = *reinterpret_cast<uint32_t*>(&v0);
  b[1] = *reinterpret_cast<uint32_t*>(&v1);
}

// Asynchronous 16-byte copies from device to shared memory (cp.async,
// bypassing L1); with valid false the 16 bytes are zeros (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A fragment of the 16x16 tile at (r0, k0) of a [row][k] array in shared
// memory (stride ld), through ldmatrix: what load_a reads.
__device__ __forceinline__ void load_a_x4(uint32_t (&a)[4], const bf16* s, int ld, int r0,
                                          int k0, int lane) {
  const bf16* p = s + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// B fragments of two 16x8 tiles, at (k0, n0) and (k0, n0 + 8), of a
// [k][n] array (stride ld): b[0..1] for n0, b[2..3] for n0 + 8.
__device__ __forceinline__ void load_b_trans_x4(uint32_t (&b)[4], const bf16* s, int ld,
                                                int n0, int k0, int lane) {
  const int i = lane >> 3, j = lane & 7;
  const bf16* p = s + (k0 + (i & 1) * 8 + j) * ld + n0 + (i >> 1) * 8;
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(a));
}

// Row LayerNorm of D = 32 * N f32 values spread as N per lane of one warp
// (lane holds columns 2*lane + 64*i + {0, 1}, i < N / 2; N = 12 at D = 384,
// 6 at D = 192): two-pass f32 statistics, as the JAX kernels compute them
// (mean, then mean of the squared deviations).
template <int N>
__device__ __forceinline__ void warp_ln_stats(const float (&v)[N], float eps,
                                              float& mean, float& inv) {
  constexpr float inv_d = 1.f / (32 * N);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s += v[i];
  mean = warp_sum(s) * inv_d;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float c = v[i] - mean;
    q += c * c;
  }
  inv = rsqrtf(warp_sum(q) * inv_d + eps);
}

// Model widths the row kernels are instantiated for (ViT-S 384, ViT-Ti 192):
// calls launch(std::integral_constant<int, D>{}) for d == D, and refuses any
// other width.
template <typename F>
static inline int by_width(int d, F&& launch) {
  if (d == 384) return launch(std::integral_constant<int, 384>{});
  if (d == 192) return launch(std::integral_constant<int, 192>{});
  return (int)cudaErrorInvalidValue;
}
