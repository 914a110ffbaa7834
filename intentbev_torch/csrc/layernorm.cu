// Row LayerNorm: inference, training forward and backward; bf16 in, f32
// statistics, bf16 out.
//
// Inference replaces intentbev/ops/layernorm.py::_fwd_infer_kernel (the
// standalone LN of block 0's norm1 and of the two adapters on the serving
// path); the training kernels are described where they are defined below.
// Bound on the H100: device memory. Each row is read once and written once
// (768 + 768 bytes at D = 384, twice that at 768, half at 192), so the floor
// is bytes / 3.35 TB/s.
// Design: one warp per row, D / 32 values per lane held in registers (24 at
// D = 768, 12 at 384, 6 at 192; the width is a template parameter), 32-bit
// (bf16x2) loads and stores; the row never touches shared memory. Eight
// rows per 256-thread block keep enough warps in flight to cover the load
// latency.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;

template <int D>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
    layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, bf16* __restrict__ y,
                     int n_rows, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const bf16* xr = x + (size_t)row * D;
  float v[D / 32];
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    const __nv_bfloat162 p =
        *reinterpret_cast<const __nv_bfloat162*>(xr + 2 * lane + 64 * i);
    v[2 * i] = __bfloat162float(p.x);
    v[2 * i + 1] = __bfloat162float(p.y);
  }
  float mean, inv;
  warp_ln_stats(v, eps, mean, inv);
  bf16* yr = y + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    const int c = 2 * lane + 64 * i;
    const float a = (v[2 * i] - mean) * inv * gamma[c] + beta[c];
    const float b = (v[2 * i + 1] - mean) * inv * gamma[c + 1] + beta[c + 1];
    *reinterpret_cast<uint32_t*>(yr + c) = pack_bf16x2(a, b);
  }
}

// Training forward. Replaces intentbev/ops/layernorm.py::_fwd_kernel: also
// writes xhat = (x - mean) * inv (bf16) and inv (f32, one per row) for the
// backward. Same bound and design as the inference kernel (5 bytes more per
// element written).
template <int D>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
    layernorm_train_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                           const float* __restrict__ beta, bf16* __restrict__ y,
                           bf16* __restrict__ xhat, float* __restrict__ inv_out,
                           int n_rows, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const bf16* xr = x + (size_t)row * D;
  float v[D / 32];
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    const __nv_bfloat162 p =
        *reinterpret_cast<const __nv_bfloat162*>(xr + 2 * lane + 64 * i);
    v[2 * i] = __bfloat162float(p.x);
    v[2 * i + 1] = __bfloat162float(p.y);
  }
  float mean, inv;
  warp_ln_stats(v, eps, mean, inv);
  bf16* yr = y + (size_t)row * D;
  bf16* hr = xhat + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    const int c = 2 * lane + 64 * i;
    const float h0 = (v[2 * i] - mean) * inv, h1 = (v[2 * i + 1] - mean) * inv;
    *reinterpret_cast<uint32_t*>(yr + c) =
        pack_bf16x2(h0 * gamma[c] + beta[c], h1 * gamma[c + 1] + beta[c + 1]);
    *reinterpret_cast<uint32_t*>(hr + c) = pack_bf16x2(h0, h1);
  }
  if (lane == 0) inv_out[row] = inv;
}

// Backward. Replaces intentbev/ops/layernorm.py::_bwd_kernel:
//   dx = inv * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat))   (bf16 out)
//   dgamma = sum_rows dy * xhat,  dbeta = sum_rows dy          (f32)
// Bound on the H100: device memory (dy and xhat read, dx written: 2.3 KB a
// row at D = 384; 83.1 MB at 36008 rows, 0.0248 ms at 3.35 TB/s; twice that
// at D = 768).
// Design: a persistent grid, one block an SM, each block a contiguous run of
// rows. A lane holds VPL = 12 values of a row at D = 384 and 192 (three
// 8-byte loads a tensor; a row spread over D / 12 lanes: the warp at 384, a
// half-warp at 192) and 24 at D = 768 (three 16-byte loads; the warp). Each
// warp keeps two row steps in flight (2 rows at D = 384, 4 at 192, 2 at 768):
// 96 bytes a lane at the narrow widths in 512-thread blocks, 192 bytes at 768
// in 256-thread blocks (the registers of its 24-value sums leave no room for
// 16 warps), ~48 KB a block either way, enough to run near the memory rate.
// The row sums take shuffles over the row's lanes. Each lane sums dy * xhat
// and dy for its columns over its rows; the block adds its warps' sums in
// warp order and writes one partial row of dgamma and of dbeta, which
// col_sums_kernel then adds in a fixed order: the result does not depend on
// scheduling.
constexpr int BWD_STEPS = 2;

// The backward's layout at width D.
template <int D>
struct BwdLayout {
  static constexpr int VPL = D == 768 ? 24 : 12;  // values of a row a lane
  static constexpr int VEC = VPL / 3;             // values of one load
  static constexpr int LPR = D / VPL;             // lanes of a row
  static constexpr int THREADS = D == 768 ? 256 : 512;
  static constexpr int WARPS = THREADS / 32;
  static_assert(LPR <= 32 && 32 % LPR == 0 && (VEC == 4 || VEC == 8), "width outside the layout");
};

// VEC bf16 values from one 8- or 16-byte load.
template <int VEC>
using LoadT = std::conditional_t<VEC == 8, uint4, uint2>;

template <int VEC>
__device__ __forceinline__ void unpack_bf16(const LoadT<VEC>& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 a = __bfloat1622float2(p[i]);
    f[2 * i] = a.x;
    f[2 * i + 1] = a.y;
  }
}

template <int VEC>
__device__ __forceinline__ LoadT<VEC> pack_bf16(const float* f) {
  LoadT<VEC> v;
  uint32_t* p = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) p[i] = pack_bf16x2(f[2 * i], f[2 * i + 1]);
  return v;
}

// part: [2][gridDim.x][D] (dgamma's block partials, then dbeta's).
template <int D>
__global__ void __launch_bounds__(BwdLayout<D>::THREADS, 1)
    layernorm_bwd_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ xhat,
                         const float* __restrict__ inv, const float* __restrict__ gamma,
                         bf16* __restrict__ dx, float* __restrict__ part, int n_rows) {
  using L = BwdLayout<D>;
  using T = LoadT<L::VEC>;
  constexpr int VPL = L::VPL, VEC = L::VEC, LPR = L::LPR, WARPS = L::WARPS;
  constexpr int RPW = 32 / LPR;        // rows of a warp step
  constexpr int RI = RPW * BWD_STEPS;  // rows of a warp's iteration
  __shared__ float red[WARPS][D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane % LPR, sub = lane / LPR;  // lane within its row; the row of the step
  const int lo = (int)((long long)n_rows * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)n_rows * (blockIdx.x + 1) / gridDim.x);
  // lane q holds columns VEC q + VEC LPR i .. + VEC - 1, i < 3
  float g[VPL], acc_g[VPL], acc_b[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    g[i] = gamma[VEC * q + VEC * LPR * (i / VEC) + i % VEC];
    acc_g[i] = acc_b[i] = 0.f;
  }

  for (int r0 = lo + warp * RI; r0 < hi; r0 += WARPS * RI) {
    T rd[BWD_STEPS][3], rh[BWD_STEPS][3];
    float iv[BWD_STEPS];
#pragma unroll
    for (int u = 0; u < BWD_STEPS; ++u) {  // every load of the iteration first
      const int row = r0 + u * RPW + sub;
      const bool ok = row < hi;
      const size_t off = (size_t)(ok ? row : lo) * D + VEC * q;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        rd[u][i] = ok ? *reinterpret_cast<const T*>(dy + off + VEC * LPR * i) : T{};
        rh[u][i] = ok ? *reinterpret_cast<const T*>(xhat + off + VEC * LPR * i) : T{};
      }
      iv[u] = ok ? inv[row] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BWD_STEPS; ++u) {
      const int row = r0 + u * RPW + sub;
      float d[VPL], h[VPL];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        unpack_bf16<VEC>(rd[u][i], d + VEC * i);
        unpack_bf16<VEC>(rh[u][i], h + VEC * i);
      }
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const float dyg = d[i] * g[i];
        s1 += dyg;
        s2 += dyg * h[i];
        acc_g[i] += d[i] * h[i];
        acc_b[i] += d[i];
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) {  // the row's lanes
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      const float m1 = s1 * (1.f / D), m2 = s2 * (1.f / D);
      if (row < hi) {
        bf16* out = dx + (size_t)row * D + VEC * q;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float v[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int k = VEC * i + e;
            v[e] = iv[u] * (d[k] * g[k] - m1 - h[k] * m2);
          }
          *reinterpret_cast<T*>(out + VEC * LPR * i) = pack_bf16<VEC>(v);
        }
      }
    }
  }
  // the warp's sums (at D = 192 its two half-warps' added), then the block's
  // in warp order: dgamma's partial row, then dbeta's through the same buffer
  if constexpr (RPW == 2) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      acc_g[i] += __shfl_xor_sync(0xffffffffu, acc_g[i], 16);
      acc_b[i] += __shfl_xor_sync(0xffffffffu, acc_b[i], 16);
    }
  }
  auto block_sums = [&](const float (&acc)[VPL], int k) {
    if (sub == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(&red[warp][VEC * q + VEC * LPR * i + e]) =
              make_float4(acc[VEC * i + e], acc[VEC * i + e + 1], acc[VEC * i + e + 2],
                          acc[VEC * i + e + 3]);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += L::THREADS) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += red[w][c];
      part[((size_t)k * gridDim.x + blockIdx.x) * D + c] = t;
    }
    __syncthreads();
  };
  block_sums(acc_g, 0);
  block_sums(acc_b, 1);
}

}  // namespace

extern "C" int ibk_layernorm_train(const void* x, const void* gamma, const void* beta,
                                   void* y, void* xhat, void* inv, int n_rows, int d,
                                   float eps, void* stream) {
  return by_width<768, 384, 192>(d, [&](auto w) {
    constexpr int D = decltype(w)::value;
    if (n_rows > 0) {
      const int blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
      layernorm_train_kernel<D><<<blocks, 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
          (const bf16*)x, (const float*)gamma, (const float*)beta, (bf16*)y, (bf16*)xhat,
          (float*)inv, n_rows, eps);
    }
    return (int)cudaGetLastError();
  });
}

// part: f32 workspace of 2 * (the card's SM count) * d values. One row
// kernel, then one col_sums_kernel for dgamma and dbeta (which writes them
// whole, zeros for n_rows = 0).
extern "C" int ibk_layernorm_bwd(const void* dy, const void* xhat, const void* inv,
                                 const void* gamma, void* dx, void* part, void* dgamma,
                                 void* dbeta, int n_rows, int d, void* stream) {
  return by_width<768, 384, 192>(d, [&](auto w) {
    constexpr int D = decltype(w)::value;
    cudaStream_t s = (cudaStream_t)stream;
    int dev = 0, sms = 0, err;
    if ((err = (int)cudaGetDevice(&dev)) ||
        (err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
      return err;
    // at least a warp step's rows a block
    const int blocks = std::max(1, std::min(sms, (n_rows + 31) / 32));
    float* pg = (float*)part;
    if (n_rows > 0) {
      layernorm_bwd_kernel<D><<<blocks, BwdLayout<D>::THREADS, 0, s>>>(
          (const bf16*)dy, (const bf16*)xhat, (const float*)inv, (const float*)gamma,
          (bf16*)dx, pg, n_rows);
      if ((err = (int)cudaGetLastError())) return err;
    }
    const int parts = n_rows > 0 ? blocks : 0;
    ColSums cs = {{pg, pg + (size_t)blocks * D, nullptr, nullptr},
                  {(float*)dgamma, (float*)dbeta, nullptr, nullptr},
                  {D, D, 0, 0},
                  {parts, parts, 0, 0}};
    col_sums_kernel<<<dim3(D / 32, 2), 256, 0, s>>>(cs);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* ibk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Inference, like the training kernels above, at d = 768 (ViT-B), 384
// (ViT-S) or 192 (ViT-Ti).
extern "C" int ibk_layernorm(const void* x, const void* gamma, const void* beta,
                             void* y, int n_rows, int d, float eps, void* stream) {
  return by_width<768, 384, 192>(d, [&](auto w) {
    constexpr int D = decltype(w)::value;
    if (n_rows > 0) {
      const int blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
      layernorm_kernel<D><<<blocks, 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
          (const bf16*)x, (const float*)gamma, (const float*)beta, (bf16*)y, n_rows, eps);
    }
    return (int)cudaGetLastError();
  });
}
