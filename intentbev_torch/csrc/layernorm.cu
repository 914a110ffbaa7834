// Row LayerNorm: inference, training forward and backward; bf16 in, f32
// statistics, bf16 out.
//
// Inference replaces intentbev/ops/layernorm.py::_fwd_infer_kernel (the
// standalone LN of block 0's norm1 and of the two adapters on the serving
// path); the training kernels are described where they are defined below.
// Bound on the H100: device memory. Each row is read once and written once
// (768 + 768 bytes at D = 384, half at 192), so the floor is bytes / 3.35
// TB/s.
// Design: one warp per row, D / 32 values per lane held in registers (12 at
// D = 384, 6 at D = 192; the width is a template parameter), 32-bit
// (bf16x2) loads and stores; the row never touches shared memory. Eight
// rows per 256-thread block keep enough warps in flight to cover the load
// latency.
#include <algorithm>

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
// row at D = 384; 83.1 MB at 36008 rows, 0.0248 ms at 3.35 TB/s).
// Design: a persistent grid, one 512-thread block an SM, each block a
// contiguous run of rows. A row is spread over D / 12 lanes (the warp at D =
// 384, a half-warp at 192), 12 values a lane as three 8-byte loads a tensor,
// and each warp keeps two row steps in flight (2 rows at D = 384, 4 at 192):
// 96 bytes a lane, ~48 KB a block, enough to run near the memory rate. The
// row sums take shuffles over the row's lanes. Each lane sums dy * xhat and
// dy for its 12 columns over its rows; the block adds its 16 warps' sums in
// warp order and writes one partial row of dgamma and of dbeta, which
// col_sums_kernel then adds in a fixed order: the result does not depend on
// scheduling.
constexpr int BWD_THREADS = 512, BWD_WARPS = BWD_THREADS / 32, BWD_STEPS = 2;

__device__ __forceinline__ void bf16x4(uint2 v, float* f) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// part: [2][gridDim.x][D] (dgamma's block partials, then dbeta's).
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    layernorm_bwd_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ xhat,
                         const float* __restrict__ inv, const float* __restrict__ gamma,
                         bf16* __restrict__ dx, float* __restrict__ part, int n_rows) {
  constexpr int LPR = D / 12;       // lanes of a row
  constexpr int RPW = 32 / LPR;     // rows of a warp step
  constexpr int RI = RPW * BWD_STEPS;  // rows of a warp's iteration
  __shared__ float red[BWD_WARPS][D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane % LPR, sub = lane / LPR;  // lane within its row; the row of the step
  const int lo = (int)((long long)n_rows * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)n_rows * (blockIdx.x + 1) / gridDim.x);
  // lane q holds columns 4q + 4 LPR i .. + 3, i < 3
  float g[12], acc_g[12], acc_b[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    g[i] = gamma[4 * q + 4 * LPR * (i / 4) + i % 4];
    acc_g[i] = acc_b[i] = 0.f;
  }

  for (int r0 = lo + warp * RI; r0 < hi; r0 += BWD_WARPS * RI) {
    uint2 rd[BWD_STEPS][3], rh[BWD_STEPS][3];
    float iv[BWD_STEPS];
#pragma unroll
    for (int u = 0; u < BWD_STEPS; ++u) {  // every load of the iteration first
      const int row = r0 + u * RPW + sub;
      const bool ok = row < hi;
      const size_t off = (size_t)(ok ? row : lo) * D + 4 * q;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        rd[u][i] = ok ? *reinterpret_cast<const uint2*>(dy + off + 4 * LPR * i) : make_uint2(0, 0);
        rh[u][i] = ok ? *reinterpret_cast<const uint2*>(xhat + off + 4 * LPR * i)
                      : make_uint2(0, 0);
      }
      iv[u] = ok ? inv[row] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BWD_STEPS; ++u) {
      const int row = r0 + u * RPW + sub;
      float d[12], h[12];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        bf16x4(rd[u][i], d + 4 * i);
        bf16x4(rh[u][i], h + 4 * i);
      }
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < 12; ++i) {
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
        bf16* out = dx + (size_t)row * D + 4 * q;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 4 * i + e;
            v[e] = iv[u] * (d[k] * g[k] - m1 - h[k] * m2);
          }
          *reinterpret_cast<uint2*>(out + 4 * LPR * i) =
              make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
        }
      }
    }
  }
  // the warp's sums (at D = 192 its two half-warps' added), then the block's
  // in warp order: dgamma's partial row, then dbeta's through the same buffer
  if constexpr (RPW == 2) {
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      acc_g[i] += __shfl_xor_sync(0xffffffffu, acc_g[i], 16);
      acc_b[i] += __shfl_xor_sync(0xffffffffu, acc_b[i], 16);
    }
  }
  auto block_sums = [&](const float (&acc)[12], int k) {
    if (sub == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        *reinterpret_cast<float4*>(&red[warp][4 * q + 4 * LPR * i]) =
            make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    }
    __syncthreads();
    if (threadIdx.x < D) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < BWD_WARPS; ++w) t += red[w][threadIdx.x];
      part[((size_t)k * gridDim.x + blockIdx.x) * D + threadIdx.x] = t;
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
  return by_width(d, [&](auto w) {
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
  return by_width(d, [&](auto w) {
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
      layernorm_bwd_kernel<D><<<blocks, BWD_THREADS, 0, s>>>(
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

extern "C" int ibk_layernorm(const void* x, const void* gamma, const void* beta,
                             void* y, int n_rows, int d, float eps, void* stream) {
  return by_width(d, [&](auto w) {
    constexpr int D = decltype(w)::value;
    if (n_rows > 0) {
      const int blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
      layernorm_kernel<D><<<blocks, 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
          (const bf16*)x, (const float*)gamma, (const float*)beta, (bf16*)y, n_rows, eps);
    }
    return (int)cudaGetLastError();
  });
}
