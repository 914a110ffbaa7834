// Pieces shared by the LN row kernels of fused_ln_mlp.cu and
// fused_ln_dense.cu (warp-specialised Hopper kernels, 384 threads: two
// consumer warpgroups and a producer warpgroup): the register split, tile
// offsets as TMA swizzles them, compile-time loops, quad sums, 32-bit
// shared-memory accesses and the in-place LayerNorm of a consumer's rows;
// and the dW product over rows (dw_gemm_kernel) with the fixed-order sums
// of its split partials (split_sums_kernel), which both backwards run after
// their row kernels (the block partials' col_sums_kernel is in common.cuh).
#pragma once

#include <utility>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// setmaxnreg: 128 * 24 + 256 * 240 = 384 * 168, the 168 a thread of the
// block gets at launch
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

__device__ __forceinline__ float2 bf16x2_at(const void* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

// Shared-memory accesses through 32-bit shared addresses (a generic pointer
// takes two registers, which an accumulator of 192 leaves no room for).
__device__ __forceinline__ float2 lds_bf16x2(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ void sts_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void sts_f4(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// The sum over the quad of threads that holds a row of an accumulator.
__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// xn = LN(x) * gamma + beta in place on a consumer's 64 rows of a tile of
// 64-column blocks XBLK bytes apart (128-byte rows as TMA swizzles them;
// xs 1024-byte aligned), a warp a row, RPW rows a warp (16; 8 where the two
// consumers' eight warps share 64 rows): lane l holds columns 2l, 2l + 1 of
// each block (16-byte chunk l / 4 of the row). f32 two-pass statistics
// (warp_ln_stats), xn rounded to bf16 once. With stats, row r's mean goes to
// stats[r] and its 1 / sigma to stats[inv_at + r].
template <int D, int XBLK, int RPW = 16>
__device__ __forceinline__ void ln_in_place(uint8_t* xs, int warp, int lane,
                                            const float* __restrict__ gamma,
                                            const float* __restrict__ beta, float eps,
                                            float* stats = nullptr, int inv_at = 0) {
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = RPW * warp + rr;
    uint8_t* row = xs + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + (lane & 3) * 4;
    float v[D / 32];
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const float2 p = bf16x2_at(row + i * XBLK);
      v[2 * i] = p.x;
      v[2 * i + 1] = p.y;
    }
    float mean, inv;
    warp_ln_stats(v, eps, mean, inv);
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const int c = 64 * i + 2 * lane;
      *reinterpret_cast<uint32_t*>(row + i * XBLK) =
          pack_bf16x2((v[2 * i] - mean) * inv * gamma[c] + beta[c],
                      (v[2 * i + 1] - mean) * inv * gamma[c + 1] + beta[c + 1]);
    }
    if (stats != nullptr && lane == 0) {
      stats[r] = mean;
      stats[inv_at + r] = inv;
    }
  }
}

// The dW products: C = P^T Q over rows, P [R, M] and Q [R, N] row-major bf16
// through maps of 64 x 64 boxes; product 1 (the LN+MLP backward's dW1 = dg^T
// xn: M = hidden, N = D; the LN+dense backward's dW = dg^T xn: M = Dout, N =
// D) takes the first tiles of the grid, product 2 (dW2 = dy_eff^T h: M = D, N
// = hidden; none, M2 = 0, for the LN+dense) the rest, in DW_M x DW_N output
// tiles (edge tiles read TMA's zeros and store only what lies inside). Block b computes output tile b / splits
// over the rows of split b % splits (rows_per_split, a multiple of 64; rows
// past R land as zeros) into part[split] = [M1 * N1 | M2 * N2] f32. One block
// an SM (two would leave ptxas 80 registers a thread, which the products
// cannot take).
constexpr int DW_THREADS = 384, DW_M = 128, DW_N = 192, DW_K = 64, DW_S = 4;
constexpr int DW_A = DW_M * DW_K * 2, DW_B = DW_N * DW_K * 2;  // the P and Q chunks
constexpr int DW_STAGE = DW_A + DW_B;
constexpr int DW_BYTES = DW_S * DW_STAGE + 2 * DW_S * 8 + 1024;
constexpr int BOX = 64 * 64 * 2;  // one 64 x 64 box

__global__ void __launch_bounds__(DW_THREADS, 1)
    dw_gemm_kernel(const __grid_constant__ CUtensorMap mp1, const __grid_constant__ CUtensorMap mq1,
                   const __grid_constant__ CUtensorMap mp2, const __grid_constant__ CUtensorMap mq2,
                   float* __restrict__ part, int m1, int n1, int m2, int n2, int n_rows,
                   int rows_per_split, int splits) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + DW_S * DW_STAGE);
  uint64_t* empty = full + DW_S;
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0), lane = tid % 32;
  const int split = blockIdx.x % splits, tile = blockIdx.x / splits;
  const int tiles1 = (m1 + DW_M - 1) / DW_M * ((n1 + DW_N - 1) / DW_N);
  const bool second = tile >= tiles1;
  const int m = second ? m2 : m1, n = second ? n2 : n1, t = second ? tile - tiles1 : tile;
  const int tn = (n + DW_N - 1) / DW_N;
  const int m0 = t / tn * DW_M, n0 = t % tn * DW_N;
  const int r0 = split * rows_per_split;
  const int chunks = (max(0, min(rows_per_split, n_rows - r0)) + DW_K - 1) / DW_K;
  if (tid == 0) {
    for (int s = 0; s < DW_S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 256) {
      const CUtensorMap* mp = second ? &mp2 : &mp1;
      const CUtensorMap* mq = second ? &mq2 : &mq1;
      for (int c = 0; c < chunks; ++c) {
        const int s = c % DW_S, r = r0 + c * DW_K;
        hopper::mbar_wait(&empty[s], ((c / DW_S) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], DW_STAGE);
        uint8_t* st = sm + s * DW_STAGE;
        for (int b = 0; b < DW_M / 64; ++b)
          hopper::tma_load_2d(st + b * BOX, mp, &full[s], m0 + 64 * b, r);
        for (int b = 0; b < DW_N / 64; ++b)
          hopper::tma_load_2d(st + DW_A + b * BOX, mq, &full[s], n0 + 64 * b, r);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int warp = (tid % 128) / 32, g = lane >> 2, t4 = lane & 3;
  float acc[DW_N / 2];
#pragma unroll
  for (int i = 0; i < DW_N / 2; ++i) acc[i] = 0.f;
  const uint32_t sbase = hopper::smem_u32(sm);
  for (int c = 0; c < chunks; ++c) {
    const int s = c % DW_S;
    hopper::mbar_wait(&full[s], (c / DW_S) & 1);
    // A: this consumer's 64 columns of the P chunk (one box); B: the Q
    // chunk's DW_N columns, boxes BOX bytes apart. Both MN-major: K runs
    // down the chunk's rows.
    uint32_t a0 = sbase + s * DW_STAGE + wg * BOX, b0 = sbase + s * DW_STAGE + DW_A;
    asm volatile("" : "+r"(a0), "+r"(b0));
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_K / 16; ++kk) {
      const uint64_t da = hopper::desc_mnmajor_at<128>(a0 + kk * 16 * 128, BOX);
      const uint64_t db = hopper::desc_mnmajor_at<128>(b0 + kk * 16 * 128, BOX);
      hopper::wgmma_sst<DW_N, 1, 1>(acc, da, db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the previous chunk's products: its slot is free
    if (c > 0 && lane == 0) hopper::mbar_arrive(&empty[(c - 1) % DW_S]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  float* out = part + (size_t)split * ((size_t)m1 * n1 + (size_t)m2 * n2) +
               (second ? (size_t)m1 * n1 : 0);
  const int ra = m0 + 64 * wg + 16 * warp + g, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < DW_N / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    if (col < n) {
      if (ra < m) *reinterpret_cast<float2*>(out + (size_t)ra * n + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      if (rb < m) *reinterpret_cast<float2*>(out + (size_t)rb * n + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// The dw_gemm_kernel's outputs from its split partials, splits in order:
// the first n1 float4s to out1 (dW1, or the LN+dense's dW with n = n1), the
// rest to out2 (dW2).
__global__ void __launch_bounds__(256)
    split_sums_kernel(const float4* __restrict__ part, int splits, int n1, int n,
                      float4* __restrict__ out1, float4* __restrict__ out2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 s = part[i];
  for (int p = 1; p < splits; ++p) {
    const float4 v = part[(size_t)p * n + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  if (i < n1)
    out1[i] = s;
  else
    out2[i - n1] = s;
}

template <typename K>
int raise_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// raise_smem once, the first time it succeeds (ok: the caller's flag for
// this kernel).
template <typename K>
int raise_once(K kernel, int bytes, bool& ok) {
  if (ok) return 0;
  const int err = raise_smem(kernel, bytes);
  ok = err == 0;
  return err;
}

}  // namespace
