// Dense BEV fill: placement chunks -> the lidar BEV [B, H, W, C], the CNN
// family's input and the chunk train transport's.
//
// Replaces: intentbev/ops/voxel_embed.py::_fill_kernel with its placement
// phase ::_place_band, reached through voxel_fill_bev. The TPU kernel zeroes
// one 40-row band in VMEM (40 x 720 x 290 bf16, 16.7 MB), adds each chunk
// into its 64-pixel window as a one-hot product E[64, 64] X[64, C] and
// writes the band out; a band is far beyond the H100's 227 KB of shared
// memory.
// Bound on the H100: device memory. The output is dense and every byte of
// it, zeros included, is written once (1.34 GB for a batch of 8 frames on
// the 400 x 720 x 290 grid in bf16: 0.40 ms at 3.35 TB/s); the chunks read
// are about 1 % of that.
// Design: one block per (window, band, sample). Bands are whole grid rows
// and a window is 64 consecutive row-major pixels of its band, so the
// window's [64, C] slice of the output is one contiguous range. The block
// zeroes that tile in shared memory, scans its band's chunk windows
// wid[0:count] a block-width at a time (ballot-compacted matches, in chunk
// order), stores the nonzero cells of each matching chunk whose channel
// lies in [0, C) into the tile, and writes the tile out with 16-byte
// stores: one pass over the output, no atomics, no separate memset.
// Contract: the host chunk build deduplicates cells (per-cell max), so at most
// one cell reaches each (pixel, channel). The kernel STORES dtype(val)
// where the TPU kernel adds into zeros; under the contract the two agree.
// A channel outside [0, C) is dropped (the TPU one-hot compare never
// matches it), zero-valued slots add nothing, chunks past count are never
// read.
#include "common.cuh"

namespace {

constexpr int WINDOW = 64;  // pixels per placement window
constexpr int CAP = 64;     // cells per chunk
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ bf16 to_out<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    voxel_fill_kernel(const int* __restrict__ wid, const int* __restrict__ sl,
                      const int* __restrict__ ch, const float* __restrict__ val,
                      const int* __restrict__ count, T* __restrict__ out, int nb,
                      int nc, int C, int band_px) {
  extern __shared__ __align__(16) unsigned char smem[];  // tile [WINDOW][C] of T
  __shared__ int hits[THREADS];
  __shared__ int warp_hits[WARPS];
  T* tile = reinterpret_cast<T*>(smem);
  uint4* tile4 = reinterpret_cast<uint4*>(smem);
  const int n4 = WINDOW * C * (int)sizeof(T) / 16;  // 128 * C bytes or more: exact

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int win = blockIdx.x, band = blockIdx.y, b = blockIdx.z;

  for (int i = tid; i < n4; i += THREADS) tile4[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const size_t chunk0 = ((size_t)b * nb + band) * nc;
  const int n_chunks = min(count[b * nb + band], nc);
  for (int c0 = 0; c0 < n_chunks; c0 += THREADS) {
    const int ci = c0 + tid;
    const bool hit = ci < n_chunks && wid[chunk0 + ci] == win;
    // ordered block-wide compaction of this round's matching chunks
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
    if (hit) hits[before + __popc(mask & ((1u << lane) - 1u))] = ci;
    __syncthreads();
    // THREADS / CAP matching chunks at a time, one cell per thread
    for (int h = tid / CAP; h < total; h += THREADS / CAP) {
      const size_t cell = (chunk0 + hits[h]) * CAP + (tid % CAP);
      const float v = val[cell];
      const int c = ch[cell], s = sl[cell];
      if (v != 0.f && c >= 0 && c < C && s >= 0 && s < WINDOW) tile[s * C + c] = to_out<T>(v);
    }
    __syncthreads();  // the tile is complete; hits are rewritten next round
  }

  uint4* dst = reinterpret_cast<uint4*>(
      out + (((size_t)b * nb + band) * band_px + (size_t)win * WINDOW) * C);
  for (int i = tid; i < n4; i += THREADS) dst[i] = tile4[i];
}

template <typename T>
int launch_fill(const void* wid, const void* sl, const void* ch, const void* val,
                const void* count, void* out, int B, int nb, int nc, int C, int band_px,
                cudaStream_t stream) {
  const int smem = WINDOW * C * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      voxel_fill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && nb > 0 && band_px > 0) {
    dim3 grid(band_px / WINDOW, nb, B);
    voxel_fill_kernel<T><<<grid, THREADS, smem, stream>>>(
        (const int*)wid, (const int*)sl, (const int*)ch, (const float*)val,
        (const int*)count, (T*)out, nb, nc, C, band_px);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// wid i32 [B, NB, NC]; sl, ch i32 and val f32 [B, NB, NC, 64]; count i32
// [B, NB]; out [B, NB * band_px, C] (= [B, H, W, C]) in bf16, or in f32
// when f32_out != 0. band_px (pixels per band) is a multiple of 64.
extern "C" int ibk_voxel_fill(const void* wid, const void* sl, const void* ch,
                              const void* val, const void* count, void* out, int B,
                              int nb, int nc, int C, int band_px, int f32_out,
                              void* stream) {
  if (f32_out)
    return launch_fill<float>(wid, sl, ch, val, count, out, B, nb, nc, C, band_px,
                              (cudaStream_t)stream);
  return launch_fill<bf16>(wid, sl, ch, val, count, out, B, nb, nc, C, band_px,
                           (cudaStream_t)stream);
}
