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
// row). Design: one warp per row as in the forward; each block takes
// BWD_ROWS rows (8 per warp), keeps its warps' column sums in registers,
// reduces them across warps in shared memory in a fixed order and writes
// one partial row of dgamma and of dbeta. The partials are summed by a
// second small kernel (one thread per column, blocks in order), so the
// result does not depend on scheduling.
constexpr int BWD_ROWS = 64;

template <int D>
__global__ void __launch_bounds__(256)
    layernorm_bwd_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ xhat,
                         const float* __restrict__ inv, const float* __restrict__ gamma,
                         bf16* __restrict__ dx, float* __restrict__ part_dg,
                         float* __restrict__ part_db, int n_rows) {
  __shared__ float red_g[8][D];
  __shared__ float red_b[8][D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float g[D / 32], acc_g[D / 32], acc_b[D / 32];
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    g[2 * i] = gamma[2 * lane + 64 * i];
    g[2 * i + 1] = gamma[2 * lane + 64 * i + 1];
  }
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc_g[i] = acc_b[i] = 0.f;
  for (int rr = 0; rr < BWD_ROWS / 8; ++rr) {
    const int row = blockIdx.x * BWD_ROWS + warp * (BWD_ROWS / 8) + rr;
    if (row >= n_rows) break;  // warp-uniform
    float d[D / 32], h[D / 32];
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const size_t off = (size_t)row * D + 2 * lane + 64 * i;
      const __nv_bfloat162 pd = *reinterpret_cast<const __nv_bfloat162*>(dy + off);
      const __nv_bfloat162 ph = *reinterpret_cast<const __nv_bfloat162*>(xhat + off);
      d[2 * i] = __bfloat162float(pd.x);
      d[2 * i + 1] = __bfloat162float(pd.y);
      h[2 * i] = __bfloat162float(ph.x);
      h[2 * i + 1] = __bfloat162float(ph.y);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const float dyg = d[i] * g[i];
      s1 += dyg;
      s2 += dyg * h[i];
      acc_g[i] += d[i] * h[i];
      acc_b[i] += d[i];
    }
    const float m1 = warp_sum(s1) * (1.f / D), m2 = warp_sum(s2) * (1.f / D);
    const float iv = inv[row];
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const float a = iv * (d[2 * i] * g[2 * i] - m1 - h[2 * i] * m2);
      const float b = iv * (d[2 * i + 1] * g[2 * i + 1] - m1 - h[2 * i + 1] * m2);
      *reinterpret_cast<uint32_t*>(dx + (size_t)row * D + 2 * lane + 64 * i) =
          pack_bf16x2(a, b);
    }
  }
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    const int c = 2 * lane + 64 * i;
    red_g[warp][c] = acc_g[2 * i];
    red_g[warp][c + 1] = acc_g[2 * i + 1];
    red_b[warp][c] = acc_b[2 * i];
    red_b[warp][c + 1] = acc_b[2 * i + 1];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += 256) {
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      sg += red_g[w][c];
      sb += red_b[w][c];
    }
    part_dg[(size_t)blockIdx.x * D + c] = sg;
    part_db[(size_t)blockIdx.x * D + c] = sb;
  }
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

// part: f32 workspace of 2 * ceil(n_rows / 64) * d values.
extern "C" int ibk_layernorm_bwd(const void* dy, const void* xhat, const void* inv,
                                 const void* gamma, void* dx, void* part, void* dgamma,
                                 void* dbeta, int n_rows, int d, void* stream) {
  return by_width(d, [&](auto w) {
    constexpr int D = decltype(w)::value;
    if (n_rows > 0) {
      cudaStream_t s = (cudaStream_t)stream;
      const int blocks = (n_rows + BWD_ROWS - 1) / BWD_ROWS;
      float* pg = (float*)part;
      float* pb = pg + (size_t)blocks * D;
      layernorm_bwd_kernel<D><<<blocks, 256, 0, s>>>(
          (const bf16*)dy, (const bf16*)xhat, (const float*)inv, (const float*)gamma,
          (bf16*)dx, pg, pb, n_rows);
      sum_partials(pg, blocks, D, (float*)dgamma, s);
      sum_partials(pb, blocks, D, (float*)dbeta, s);
    }
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
