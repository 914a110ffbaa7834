// Fused voxelize + patch-embed: placement chunks -> ViT lidar tokens.
//
// Replaces: intentbev/ops/voxel_embed.py::_kernel with its placement phase
// ::_place_band. The TPU kernel builds each 40-row BEV band densely in VMEM
// (40 x 720 x 290 bf16, 16.7 MB) and contracts it with the 8x8 patch-embed
// kernel as 64 [450, 290] x [290, 384] matmuls: about 64 GFLOP a frame,
// nearly all of it on empty cells (a bench frame occupies < 0.2 % of its
// 83.5 M cells). Neither the band nor the dense product suits the H100's
// 227 KB of shared memory.
// Bound on the H100: L2 reads of the embedding rows. Each occupied cell
// adds one 384-wide row of W (768 bytes, bf16) into one token, so a batch
// of 8 bench frames reads ~1 GB of W rows from L2 (W itself, 3.6 MB, stays
// resident) for ~0.5 G multiply-adds; at D = 192 half of each.
// Design: the same function computed sparsely,
//   token[b, t, :] = bias + sum over occupied cells in the patch of
//                    bf16(val) * W[dy, dx, ch, :]  (f32 sums, bf16 out).
// One block per (patch row, batch) with one thread per output column and
// an f32 accumulator [90 tokens, D] in shared memory; the embed width D is a
// template parameter (384 for ViT-S, 192 for ViT-Ti). The block walks its
// band's chunks in order, D / 64 chunks (D cells, one per thread) at a time:
// each thread tests its cell (inside this patch row, channel < C, nonzero),
// a block-wide ballot compacts the hits in chunk order, and every thread
// adds each hit into its own column. No atomics, so the result is
// deterministic. Cell values are rounded to bf16 before the product, as
// the TPU kernel's bf16 band does; a channel >= C is skipped explicitly (on
// the TPU its one-hot compare never matches); zero-padded slots add nothing.
#include "common.cuh"

namespace {

constexpr int WINDOW = 64;  // pixels per placement window
constexpr int CAP = 64;     // cells per chunk

// D: embed width == threads per block == cells tested per phase
template <int D>
__global__ void __launch_bounds__(D)
    voxel_embed_kernel(const int* __restrict__ wid, const int* __restrict__ sl,
                       const int* __restrict__ ch, const float* __restrict__ val,
                       const int* __restrict__ count, const bf16* __restrict__ w,
                       const float* __restrict__ bias, bf16* __restrict__ out,
                       int nb, int nc, int C, int width, int patch, int rows_pp) {
  constexpr int CELLS = D, WARPS = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int gw = width / patch;
  float* acc = reinterpret_cast<float*>(smem);  // [gw][D]
  int* hit_w = reinterpret_cast<int*>(acc + gw * D);
  int* hit_t = hit_w + CELLS;
  float* hit_v = reinterpret_cast<float*>(hit_t + CELLS);
  int* warp_hits = reinterpret_cast<int*>(hit_v + CELLS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int pr = blockIdx.x;  // patch row
  const int b = blockIdx.y;
  const int band = pr / rows_pp;
  const int pr_in_band = pr % rows_pp;
  const int band_px = rows_pp * patch * width;

  for (int i = tid; i < gw * D; i += D) acc[i] = 0.f;

  const int n_chunks = count[b * nb + band];
  const size_t chunk0 = ((size_t)b * nb + band) * nc;
  for (int c0 = 0; c0 < n_chunks; c0 += CELLS / CAP) {
    const int ci = c0 + tid / CAP;
    bool hit = false;
    int w_off = 0, tok = 0;
    float v = 0.f;
    if (ci < n_chunks) {
      const size_t cell = (chunk0 + ci) * CAP + (tid % CAP);
      v = val[cell];
      const int c = ch[cell];
      const int px = wid[chunk0 + ci] * WINDOW + sl[cell];
      const int rib = px / width, col = px % width;
      if (v != 0.f && c >= 0 && c < C && px >= 0 && px < band_px &&
          rib / patch == pr_in_band) {
        hit = true;
        w_off = (((rib % patch) * patch + (col % patch)) * C + c) * D;
        tok = col / patch;
        v = __bfloat162float(__float2bfloat16_rn(v));
      }
    }
    // ordered block-wide compaction of the hits
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      const int n = warp_hits[i];
      before += i < warp ? n : 0;
      total += n;
    }
    if (hit) {
      const int pos = before + __popc(mask & ((1u << lane) - 1u));
      hit_w[pos] = w_off;
      hit_t[pos] = tok;
      hit_v[pos] = v;
    }
    __syncthreads();
    int i = 0;
    for (; i + 4 <= total; i += 4) {
      float wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) wv[u] = __bfloat162float(w[hit_w[i + u] + tid]);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[hit_t[i + u] * D + tid] += hit_v[i + u] * wv[u];
    }
    for (; i < total; ++i)
      acc[hit_t[i] * D + tid] += hit_v[i] * __bfloat162float(w[hit_w[i] + tid]);
    __syncthreads();  // hit lists are rewritten by the next phase
  }

  const float bb = bias[tid];
  const int gh = gridDim.x;
  for (int t = 0; t < gw; ++t)
    out[(((size_t)b * gh + pr) * gw + t) * D + tid] = __float2bfloat16_rn(acc[t * D + tid] + bb);
}

}  // namespace

// wid i32 [B, NB, NC]; sl, ch i32 and val f32 [B, NB, NC, 64]; count i32
// [B, NB]; w bf16 [P, P, C, d]; bias f32 [d]; out bf16
// [B, (NB*rows_pp) * (width/P), d]; d is 384 or 192.
extern "C" int ibk_voxel_embed(const void* wid, const void* sl, const void* ch,
                               const void* val, const void* count, const void* w,
                               const void* bias, void* out, int B, int nb, int nc,
                               int C, int width, int patch, int rows_pp, int d,
                               void* stream) {
  return by_width(d, [&](auto dw) {
    constexpr int D = decltype(dw)::value;
    const int gw = width / patch;
    const size_t smem = (size_t)gw * D * 4 + (size_t)D * 12 + (D / 32) * 4;
    cudaError_t err = cudaFuncSetAttribute(
        voxel_embed_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B > 0 && nb > 0) {
      dim3 grid(nb * rows_pp, B);
      voxel_embed_kernel<D><<<grid, D, smem, (cudaStream_t)stream>>>(
          (const int*)wid, (const int*)sl, (const int*)ch, (const float*)val,
          (const int*)count, (const bf16*)w, (const float*)bias, (bf16*)out, nb,
          nc, C, width, patch, rows_pp);
    }
    return (int)cudaGetLastError();
  });
}
