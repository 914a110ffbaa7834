// Fused voxelize + patch-embed: placement chunks -> ViT lidar tokens, at the
// model widths D = 768 (ViT-B), 384 (ViT-S) and 192 (ViT-Ti).
//
// Replaces: intentbev/ops/voxel_embed.py::_kernel with its placement phase
// ::_place_band. The TPU kernel builds each 40-row BEV band densely in VMEM
// (40 x 720 x 290 bf16, 16.7 MB) and contracts it with the 8x8 patch-embed
// kernel as 64 [450, 290] x [290, 384] matmuls: about 64 GFLOP a frame,
// nearly all of it on empty cells (a bench frame occupies < 0.2 % of its
// 83.5 M cells). Here the same function is computed sparsely,
//   token[b, t, :] = bias + sum over the occupied cells of its patch of
//                    bf16(val) * W[dy, dx, ch, :]   (f32 sums, bf16 out),
// skipping cells whose value is 0, whose channel lies outside [0, C) or whose
// pixel lies outside the band, and never reading chunks past count.
// Bound on the H100: each occupied cell adds one D-wide row of W (768 bytes
// at D = 384) into one token. W (8*8*290*384*2 = 14.25 MB, 7.1 MB at D =
// 192, 28.5 MB at 768) stays in the 50 MB L2, so a batch of 8 bench frames
// (~1.3 M occupied cells) reads ~1 GB of W rows from L2 (~2 GB at D = 768):
// ~0.15-0.25 ms at several TB/s. The bytes bound that counts each input byte
// once (0.022 ms) is far below.
// Design: two kernels, one launch each a call.
//  1. voxel_hits_kernel, a block of 32 warps a (batch, band): orders the
//     band's hits by token (a stable counting sort) into a scratch hit list
//     ([wrow, bf16(val)] a hit, in the band's region of nc * 64 entries) and
//     writes each token's start in it (offsets [B, NB, T + 1], T = the band's
//     tokens). Warp w takes a contiguous run of the band's chunks, two chunks
//     (four cells a lane, all loads in flight together) a step: pass 1
//     counts its hits per token (integer shared-memory atomics: exact), a scan
//     turns the [32][T] counts into each (warp, token)'s first position, pass
//     2 reads the warp's chunks again (from L2) and writes each hit at its
//     position, ranked within the warp by __match_any_sync. A token's hits
//     stay in chunk order, then cell order: the order in which the TPU kernel
//     places them and in which the parent kernel summed them. Each band's
//     chunks are read by one block (the parent read each band in each of its
//     five patch rows' blocks), and no [tokens, D] f32 accumulator exists.
//  2. voxel_gather_kernel<D>, a warp a token (36000 warps at the bench, no
//     one-block tail): walks the token's hits in order, 8 at a time, each
//     lane loading its 16 + 8 bytes (D = 384; 8 + 4 at 192) of each hit's W
//     row with all 16 loads in flight before their FMAs (at D = 768, 32 +
//     16 bytes of 4 hits: the same bytes in flight), f32 sums in registers,
//     then the bias and one rounding. No atomics and a fixed sum
//     order: two calls give the same bits. A token with thousands of hits is
//     walked by its one warp (slow but exact; nothing is dropped).
#include "common.cuh"

namespace {

constexpr int WINDOW = 64;  // pixels per placement window
constexpr int CAP = 64;     // cells per chunk
constexpr int SORT_WARPS = 32;
constexpr int GATHER_WARPS = 8;  // tokens a gather block
// hits whose W rows a lane loads before their FMAs: 8, 4 at D = 768 (192
// bytes a lane either way)
template <int D>
constexpr int U = D == 768 ? 4 : 8;

// Cell `cell` of a chunk of window wc: true, with its token within the band,
// its W row ((dy * P + dx) * C + ch) and its value rounded to bf16, if it
// adds into a token.
__device__ __forceinline__ bool read_cell(const int* __restrict__ sl, const int* __restrict__ ch,
                                          const float* __restrict__ val, size_t cell, int wc,
                                          int C, int width, int patch, int gw, int band_px,
                                          int& tok, int& wrow, float& v) {
  v = val[cell];
  const int c = ch[cell];
  const int px = wc * WINDOW + sl[cell];
  if (!(v != 0.f && c >= 0 && c < C && px >= 0 && px < band_px)) return false;
  const int rib = px / width, col = px % width;
  tok = (rib / patch) * gw + col / patch;
  wrow = ((rib % patch) * patch + col % patch) * C + c;
  v = __bfloat162float(__float2bfloat16_rn(v));
  return true;
}

// The four cells of this lane in chunks ci and ci + 1 (cells lane, lane + 32
// of each; none of chunk ci + 1 at or past c_hi), every load issued first.
struct Cells {
  bool hit[4];
  int tok[4], wrow[4];
  float v[4];
};

__device__ __forceinline__ void read_cells(Cells& cs, const int* __restrict__ wid,
                                           const int* __restrict__ sl,
                                           const int* __restrict__ ch,
                                           const float* __restrict__ val, size_t chunk0, int ci,
                                           int c_hi, int lane, int C, int width, int patch,
                                           int gw, int band_px) {
  const bool two = ci + 1 < c_hi;
  const int wc[2] = {wid[chunk0 + ci], two ? wid[chunk0 + ci + 1] : 0};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = ci + k / 2;
    cs.tok[k] = cs.wrow[k] = 0;
    cs.hit[k] = (k < 2 || two) &&
                read_cell(sl, ch, val, (chunk0 + c) * CAP + 32 * (k % 2) + lane, wc[k / 2], C,
                          width, patch, gw, band_px, cs.tok[k], cs.wrow[k], cs.v[k]);
  }
}

// Shared memory: cnt [SORT_WARPS][T] then tot [T + 1] (ints).
__global__ void __launch_bounds__(SORT_WARPS * 32)
    voxel_hits_kernel(const int* __restrict__ wid, const int* __restrict__ sl,
                      const int* __restrict__ ch, const float* __restrict__ val,
                      const int* __restrict__ count, int2* __restrict__ hits,
                      int* __restrict__ offsets, int nb, int nc, int C, int width, int patch,
                      int rows_pp) {
  extern __shared__ int cnt[];
  const int gw = width / patch, T = rows_pp * gw, band_px = rows_pp * patch * width;
  int* tot = cnt + SORT_WARPS * T;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bb = blockIdx.y * nb + blockIdx.x;  // (batch, band)
  const int n = min(max(count[bb], 0), nc);
  const size_t chunk0 = (size_t)bb * nc;
  int2* out = hits + chunk0 * CAP;
  int* mine = cnt + warp * T;
  const int c_lo = n * warp / SORT_WARPS, c_hi = n * (warp + 1) / SORT_WARPS;

  for (int i = tid; i < SORT_WARPS * T; i += SORT_WARPS * 32) cnt[i] = 0;
  __syncthreads();
  // pass 1: this warp's hits per token
  for (int ci = c_lo; ci < c_hi; ci += 2) {
    Cells cells;
    read_cells(cells, wid, sl, ch, val, chunk0, ci, c_hi, lane, C, width, patch, gw, band_px);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (cells.hit[k]) atomicAdd(&mine[cells.tok[k]], 1);
  }
  __syncthreads();
  // positions: tokens in order, within a token the warps in order
  for (int t = tid; t < T; t += SORT_WARPS * 32) {
    int run = 0;
    for (int w = 0; w < SORT_WARPS; ++w) {
      const int c = cnt[w * T + t];
      cnt[w * T + t] = run;
      run += c;
    }
    tot[t] = run;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of tot[0, T) in place; the total to tot[T]
    const int per = (T + 31) / 32, b0 = min(T, lane * per), b1 = min(T, b0 + per);
    int s = 0;
    for (int t = b0; t < b1; ++t) s += tot[t];
    int inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    int run = inc - s;
    for (int t = b0; t < b1; ++t) {
      const int c = tot[t];
      tot[t] = run;
      run += c;
    }
    if (lane == 31) tot[T] = inc;
  }
  __syncthreads();
  int* off = offsets + (size_t)bb * (T + 1);
  for (int t = tid; t <= T; t += SORT_WARPS * 32) off[t] = tot[t];
  for (int i = tid; i < SORT_WARPS * T; i += SORT_WARPS * 32) cnt[i] += tot[i % T];
  __syncthreads();
  // pass 2: each hit to its position; hits of one token in a step of 32
  // cells are ranked by lane (cell order)
  const unsigned below = (1u << lane) - 1u;
  for (int ci = c_lo; ci < c_hi; ci += 2) {
    Cells cells;
    read_cells(cells, wid, sl, ch, val, chunk0, ci, c_hi, lane, C, width, patch, gw, band_px);
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // chunk ci's two halves, then chunk ci + 1's
      const bool hit = cells.hit[k];
      const int tok = cells.tok[k];
      const unsigned peers = __match_any_sync(0xffffffffu, hit ? tok : -1 - lane);
      int base = 0;
      if (hit) {
        base = mine[tok];
        out[base + __popc(peers & below)] = make_int2(cells.wrow[k], __float_as_int(cells.v[k]));
      }
      __syncwarp();
      if (hit && (peers & below) == 0) mine[tok] = base + __popc(peers);
      __syncwarp();
    }
  }
}

// N bf16 values (N / 2 words) loaded at once: 32 (two 16-byte loads), 16, 8
// or 4 bytes.
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&w)[N / 2], const bf16* p) {
  if constexpr (N == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 s = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
    w[4] = s.x, w[5] = s.y, w[6] = s.z, w[7] = s.w;
  } else if constexpr (N == 8) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
  } else if constexpr (N == 4) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = r.x, w[1] = r.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// acc[i] += v * (the i-th bf16 of the words), in order (bf16 -> f32 is exact).
template <int N>
__device__ __forceinline__ void fma_words(float* acc, const uint32_t (&w)[N / 2], float v) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    acc[2 * i] = fmaf(v, __uint_as_float(w[i] << 16), acc[2 * i]);
    acc[2 * i + 1] = fmaf(v, __uint_as_float(w[i] & 0xffff0000u), acc[2 * i + 1]);
  }
}

template <int N>
__device__ __forceinline__ void store_words(bf16* dst, const float* acc, const float* bias) {
  uint32_t w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    w[i] = pack_bf16x2(acc[2 * i] + bias[2 * i], acc[2 * i + 1] + bias[2 * i + 1]);
  if constexpr (N == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    *(reinterpret_cast<uint4*>(dst) + 1) = make_uint4(w[4], w[5], w[6], w[7]);
  } else if constexpr (N == 8)
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (N == 4)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<unsigned int*>(dst) = w[0];
}

// A warp a token: lane l sums columns [A l, A l + A) and [32 A + BC l, + BC).
// Blocks an SM: 2 at D = 384 (124 registers) and 768 (U = 4 hits in flight,
// 24 sums a lane); 4 at D = 192, where ptxas then spills 8 bytes at 64
// registers (so it chose on its own), yet the gather ran 0.084-0.092 ms
// against 0.110 at 2 blocks (92 registers, no spill) on the H100: at this
// width the warps in flight matter more.
template <int D>
__global__ void __launch_bounds__(GATHER_WARPS * 32, D == 192 ? 4 : 2)
    voxel_gather_kernel(const int2* __restrict__ hits, const int* __restrict__ offsets,
                        const bf16* __restrict__ w, const float* __restrict__ bias,
                        bf16* __restrict__ out, int n_tok, int nb, int nc, int T) {
  constexpr int A = D / 48, BC = D / 96, UH = U<D>;
  const int lane = threadIdx.x % 32;
  const int tok = blockIdx.x * GATHER_WARPS + threadIdx.x / 32;
  if (tok >= n_tok) return;
  const int bb = tok / T, t = tok % T;  // (batch, band) and the token within it
  const int start = offsets[(size_t)bb * (T + 1) + t], end = offsets[(size_t)bb * (T + 1) + t + 1];
  const int2* h = hits + (size_t)bb * nc * CAP;
  const bf16* wa = w + A * lane;
  const bf16* wb = w + 32 * A + BC * lane;
  float acc[A + BC];
#pragma unroll
  for (int i = 0; i < A + BC; ++i) acc[i] = 0.f;
  for (int base = start; base < end; base += 32) {
    const int m = min(32, end - base);
    const int2 rec = lane < m ? h[base + lane] : make_int2(0, 0);
    for (int j = 0; j < m; j += UH) {
      uint32_t ra[UH][A / 2], rb[UH][BC / 2];
      float v[UH];
#pragma unroll
      for (int u = 0; u < UH; ++u) {
        const size_t row = (size_t)__shfl_sync(0xffffffffu, rec.x, j + u) * D;
        v[u] = __int_as_float(__shfl_sync(0xffffffffu, rec.y, j + u));
        if (j + u < m) {
          load_words<A>(ra[u], wa + row);
          load_words<BC>(rb[u], wb + row);
        }
      }
#pragma unroll
      for (int u = 0; u < UH; ++u)
        if (j + u < m) {  // in hit order
          fma_words<A>(acc, ra[u], v[u]);
          fma_words<BC>(acc + A, rb[u], v[u]);
        }
    }
  }
  float ba[A], bc[BC];
#pragma unroll
  for (int i = 0; i < A; ++i) ba[i] = bias[A * lane + i];
#pragma unroll
  for (int i = 0; i < BC; ++i) bc[i] = bias[32 * A + BC * lane + i];
  bf16* o = out + (size_t)tok * D;
  store_words<A>(o + A * lane, acc, ba);
  store_words<BC>(o + 32 * A + BC * lane, acc + A, bc);
}

int launch_hits(const void* wid, const void* sl, const void* ch, const void* val,
                const void* count, void* hits, void* offsets, int B, int nb, int nc, int C,
                int width, int patch, int rows_pp, cudaStream_t stream) {
  const int T = rows_pp * (width / patch);
  const int smem = (SORT_WARPS * T + T + 1) * 4;
  if (patch <= 0 || width % patch || T <= 0 || smem > 232448 || nc < 0)
    return (int)cudaErrorInvalidValue;
  static int raised = 48 * 1024;  // the shared-memory limit, raised once a larger size
  if (smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        voxel_hits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    raised = smem;
  }
  if (B > 0 && nb > 0)
    voxel_hits_kernel<<<dim3(nb, B), SORT_WARPS * 32, smem, stream>>>(
        (const int*)wid, (const int*)sl, (const int*)ch, (const float*)val, (const int*)count,
        (int2*)hits, (int*)offsets, nb, nc, C, width, patch, rows_pp);
  return (int)cudaGetLastError();
}

}  // namespace

// Row 1's first kernel alone (the token-ordered hit list): wid i32 [B, NB,
// NC]; sl, ch i32 and val f32 [B, NB, NC, 64]; count i32 [B, NB]; hits i32
// [B, NB, NC * 64, 2] (a hit's W row, its bf16 value's f32 bits; entries past
// a band's total are not written); offsets i32 [B, NB, T + 1], T =
// rows_pp * (width / patch).
extern "C" int ibk_voxel_hits(const void* wid, const void* sl, const void* ch, const void* val,
                              const void* count, void* hits, void* offsets, int B, int nb,
                              int nc, int C, int width, int patch, int rows_pp, void* stream) {
  return launch_hits(wid, sl, ch, val, count, hits, offsets, B, nb, nc, C, width, patch,
                     rows_pp, (cudaStream_t)stream);
}

// The hit list, then the tokens: w bf16 [P, P, C, d]; bias f32 [d]; out bf16
// [B, (NB*rows_pp) * (width/P), d]; d is 768, 384 or 192; hits and offsets
// the scratch of ibk_voxel_hits.
extern "C" int ibk_voxel_embed(const void* wid, const void* sl, const void* ch,
                               const void* val, const void* count, const void* w,
                               const void* bias, void* out, void* hits, void* offsets, int B,
                               int nb, int nc, int C, int width, int patch, int rows_pp, int d,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return by_width<768, 384, 192>(d, [&](auto dw) {
    constexpr int D = decltype(dw)::value;
    const int err = launch_hits(wid, sl, ch, val, count, hits, offsets, B, nb, nc, C, width,
                                patch, rows_pp, s);
    if (err != 0) return err;
    const int T = rows_pp * (width / patch), n_tok = B * nb * T;
    if (n_tok <= 0) return (int)cudaGetLastError();
    voxel_gather_kernel<D><<<(n_tok + GATHER_WARPS - 1) / GATHER_WARPS, GATHER_WARPS * 32, 0,
                             s>>>((const int2*)hits, (const int*)offsets, (const bf16*)w,
                                  (const float*)bias, (bf16*)out, n_tok, nb, nc, T);
    return (int)cudaGetLastError();
  });
}
