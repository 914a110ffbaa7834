// Patch embed of a dense NHWC BEV: tokens = conv_PxP,sP(x) + bias.
// Replaces intentbev/ops/patch_embed.py::_kernel, which slices a VMEM band of
// patch rows into 64 (dy, dx) [M, C] x [C, D] matmuls.
//
// Bound on the H100: bf16 tensor-core throughput. A batch of 8 bench frames
// ([8, 400, 720, 290] -> [8, 4500, 384]) is 2*36000*18560*384 = 513 GFLOP,
// 0.519 ms at 989 TFLOP/s; its 1.38 GB of bytes take 0.411 ms.
// Design: the image row of a patch row's dy-th pixel row is [W, C]
// contiguous, so the P pixels x C channels under one token in that row are
// one contiguous run of P*C values (dx outer, c inner), and so is the
// matching slice W[dy] of the [P, P, C, D] weight, read as [P*C, D]. The
// embed is therefore one GEMM per patch row with K = P*P*C in P runs, and
// no channel padding: K = 290 is not a multiple of 16, but P*C = 2320 is.
// One 256-thread block owns one patch row (gw <= 96 tokens, the M tile,
// rows past gw zero) of one sample and 128 output columns; it walks K in
// chunks of KC (the largest of 80, 64, ..., 16 dividing P*C), double-
// buffered with cp.async: the A chunk [96, KC] from the image rows, the B
// chunk [KC, 128] from the weight. Products are mma.sync m16n8k16 bf16 with
// f32 accumulation (each warp 48 rows x 32 columns); B fragments come from
// the K-major tile through ldmatrix.trans. The epilogue adds the f32 bias
// and rounds once to bf16, as the TPU kernel does.
#include "common.cuh"

namespace {

constexpr int MT = 96;      // tokens per block (one patch row, padded)
constexpr int NTILE = 128;  // output columns per block
constexpr int KC_MAX = 80;
constexpr int LDB = NTILE + 8;
constexpr int THREADS = 256;
constexpr size_t A_ELEMS = (size_t)MT * (KC_MAX + 8);
constexpr size_t B_ELEMS = (size_t)KC_MAX * LDB;
constexpr size_t SMEM_BYTES = 2 * (A_ELEMS + B_ELEMS) * 2;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__global__ void __launch_bounds__(THREADS)
    patch_embed_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ bias, bf16* __restrict__ out, int H,
                       int W, int C, int D, int P, int kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as[2];
  bf16* bs[2];
  as[0] = reinterpret_cast<bf16*>(smem);
  as[1] = as[0] + A_ELEMS;
  bs[0] = as[1] + A_ELEMS;
  bs[1] = bs[0] + B_ELEMS;
  const int lda = kc + 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int py = blockIdx.x, b = blockIdx.y, nt0 = blockIdx.z * NTILE;
  const int gw = W / P, gh = H / P;
  const int kp = P * C;          // K run per pixel row of a token
  const int per_dy = kp / kc;    // chunks per dy
  const int n_chunks = P * per_dy;

  // rows past gw stay zero in both A buffers
  for (int i = tid; i < (MT - gw) * lda; i += THREADS) {
    as[0][gw * lda + i] = __float2bfloat16(0.f);
    as[1][gw * lda + i] = __float2bfloat16(0.f);
  }

  auto load_chunk = [&](int it, int buf) {
    const int dy = it / per_dy, k = (it % per_dy) * kc;
    const bf16* xrow = x + ((size_t)b * H + (size_t)py * P + dy) * W * C + k;
    const int segs = kc / 8;
    for (int i = tid; i < gw * segs; i += THREADS) {
      const int t = i / segs, s8 = (i % segs) * 8;
      cp_async16(as[buf] + t * lda + s8, xrow + (size_t)t * kp + s8);
    }
    const bf16* wk = w + ((size_t)dy * kp + k) * D + nt0;
    for (int i = tid; i < kc * (NTILE / 8); i += THREADS) {
      const int r = i / (NTILE / 8), s8 = (i % (NTILE / 8)) * 8;
      cp_async16(bs[buf] + r * LDB + s8, wk + (size_t)r * D + s8);
    }
    cp_async_commit();
  };

  const int wm = (warp & 1) * 48;   // rows wm..wm+47: three 16-row tiles
  const int wn = (warp >> 1) * 32;  // columns wn..wn+31: four 8-column tiles
  float acc[3][4][4];
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  load_chunk(0, 0);
  for (int it = 0; it < n_chunks; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_chunks) {
      load_chunk(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk `it` landed for every thread
    const bf16* a_s = as[buf];
    const bf16* b_s = bs[buf];
    for (int k0 = 0; k0 < kc; k0 += 16) {
      uint32_t a[3][4], bf[2][4];
#pragma unroll
      for (int m = 0; m < 3; ++m) load_a(a[m], a_s, lda, wm + 16 * m, k0, lane);
      load_b_trans_x4(bf[0], b_s, LDB, wn, k0, lane);
      load_b_trans_x4(bf[1], b_s, LDB, wn + 16, k0, lane);
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t bb[2] = {bf[n >> 1][2 * (n & 1)], bf[n >> 1][2 * (n & 1) + 1]};
          mma_16816(acc[m][n], a[m], bb);
        }
    }
    __syncthreads();  // buffer `buf` is refilled two chunks on
  }

#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = nt0 + wn + 8 * n + 2 * t4;
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = wm + 16 * m + g + 8 * half;
        if (t >= gw) continue;
        const size_t off = (((size_t)b * gh + py) * gw + t) * D + c;
        *reinterpret_cast<uint32_t*>(out + off) =
            pack_bf16x2(acc[m][n][2 * half] + b0, acc[m][n][2 * half + 1] + b1);
      }
  }
}

}  // namespace

// x bf16 [B, H, W, C] (NHWC, 16-byte aligned); w bf16 [P, P, C, D]; bias f32
// [D]; out bf16 [B, (H/P)*(W/P), D]. Needs W/P <= 96, D a multiple of 128,
// P*C a multiple of kc, kc a multiple of 16 and at most 80.
extern "C" int ibk_patch_embed(const void* x, const void* w, const void* bias, void* out,
                               int B, int H, int W, int C, int D, int P, int kc,
                               void* stream) {
  if (P <= 0 || H % P || W % P || W / P > MT || D % NTILE || kc % 16 || kc > KC_MAX ||
      kc <= 0 || (P * C) % kc)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      patch_embed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && H > 0) {
    dim3 grid(H / P, B, D / NTILE);
    patch_embed_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)w, (const float*)bias, (bf16*)out, H, W, C, D, P, kc);
  }
  return (int)cudaGetLastError();
}
