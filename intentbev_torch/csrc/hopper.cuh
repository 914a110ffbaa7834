// Hopper building blocks of the port's kernels: tensor maps and TMA loads,
// mbarriers, warpgroup matrix products (wgmma) and their shared-memory
// descriptors. sm_90a only (wgmma and setmaxnreg exist for that target).
//
// Tensor maps. A [B, H, T, D] bf16 view with unit stride along D is read
// through a four-dimensional map (d, head, row, batch) whose byte strides
// are twice the view's element strides; one box is 64 rows of one head
// (D x 1 x 64 x 1). The same map covers a column slice of a packed
// [B, T, 3*H*D] projection output (head stride D), a [B, H, T, D] view of
// it, and a contiguous [B, H, T, D]. Rows past T land as zeros. The rows of
// a box are 2*D bytes, so the tile is swizzled at that width: 128 bytes at
// D = 64, 64 bytes at D = 32, which is also the swizzle mode of the wgmma
// descriptors that read it. The maps are encoded by cuTensorMapEncodeTiled
// of libcuda, looked up at run time through the CUDA runtime, so the
// library does not link libcuda. A row-major [rows, cols] matrix is read
// through a two-dimensional map (encode_2d), in boxes of up to 128 bytes of
// a row, swizzled at the box's row width; rows past the last land as zeros.
//
// wgmma operands (PTX ISA, "Shared Memory Matrix Layout"): a tile of rows of
// 2*D bytes as TMA lands it is
//  - K-major when the contraction runs along D (S = Q K^T: B = K):
//    8-row groups 8 * 2*D bytes apart (SBO); a 16-wide step of K moves the
//    start address by 32 bytes;
//  - MN-major when the contraction runs along the rows (dV = P^T dO: B =
//    dO, K = its rows, N = D): the 8-row groups of K are again 8 * 2*D
//    bytes apart; a 16-row step of K moves the start by 16 * 2*D bytes. N
//    = D fits one swizzle width, so the stride between N blocks is never
//    used; both offsets get the 8-row group stride.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ----------------------------------------------------------------- host --

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's encoder needs a context current on the calling thread. A
// thread on which no CUDA runtime call has run yet may have none (PyTorch's
// autograd worker for device 0, while its allocator serves every tensor
// from its cache: the encode then fails), so the first call on each thread
// binds the device's primary context (cudaFree(nullptr)).
static inline EncodeTiledFn encode_tiled_fn() {
  static thread_local bool bound = false;
  if (!bound) {
    cudaFree(nullptr);
    bound = true;
  }
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiledFn)p;
  }
  return fn;
}

// Map of the bf16 [B, H, T, D] view at ptr with element strides (sb, sh, st)
// (unit stride along D): dims (D, H, T, B), boxes of `rows` rows of one head,
// swizzled at 2*D bytes. Returns 0 or a cudaError_t.
static inline int encode_bhtd(CUtensorMap* map, const void* ptr, int B, int H, int T, int D,
                              long long sb, long long sh, long long st, int rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * 2), (cuuint64_t)(st * 2),
                                 (cuuint64_t)(sb * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      D * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : (D * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (sw == CU_TENSOR_MAP_SWIZZLE_NONE) return (int)cudaErrorInvalidValue;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Map of the row-major bf16 [rows, cols] matrix at ptr (row stride cols):
// boxes of box_cols x box_rows, swizzled at the box's row width (box_cols *
// 2 bytes: 128 or 64). Returns 0 or a cudaError_t.
static inline int encode_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                            int box_cols) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapSwizzle sw =
      box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : (box_cols * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (sw == CU_TENSOR_MAP_SWIZZLE_NONE) return (int)cudaErrorInvalidValue;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Map of the contiguous bf16 [d2, d1, d0] tensor at ptr: boxes of box0 x box1
// x 1, swizzled at the box's row width (box0 * 2 bytes: 128 or 64); elements
// outside the tensor land as zeros and are not stored. Returns 0 or a
// cudaError_t.
static inline int encode_3d(CUtensorMap* map, const void* ptr, long long d0, long long d1,
                            long long d2, int box0, int box1) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(d0 * 2), (cuuint64_t)(d0 * d1 * 2)};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw =
      box0 * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (box0 * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (sw == CU_TENSOR_MAP_SWIZZLE_NONE) return (int)cudaErrorInvalidValue;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Map of the row-major int8 [rows, cols] matrix at ptr (row stride cols
// bytes, a multiple of 16): boxes of box_cols bytes x box_rows, swizzled at
// the box's row width (box_cols: 128 or 64 bytes). Returns 0 or a
// cudaError_t.
static inline int encode_2d_s8(CUtensorMap* map, const void* ptr, int rows, int cols,
                               int box_rows, int box_cols) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapSwizzle sw =
      box_cols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (sw == CU_TENSOR_MAP_SWIZZLE_NONE) return (int)cudaErrorInvalidValue;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// --------------------------------------------------------------- device --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The first 1024-byte boundary at or after p: the swizzle atom of a 128-byte
// swizzled tile, which TMA and the wgmma descriptors assume tiles start on.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a four-dimensional map at (d0, head, row, batch) into dst,
// completing on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a two-dimensional map at (col, row) into dst, completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// One box of a three-dimensional map at (c0, c1, c2) into dst, completing on
// bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar (a bulk copy, no tensor map).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The box of a two-dimensional map at (col, row) from src (rows outside the
// map are not written), in this thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int col,
                                             int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row)
      : "memory");
}

// The box of a three-dimensional map at (c0, c1, c2) from src (elements
// outside the map are not written), in this thread's bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma reads, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over `count` threads (a warpgroup: 128) under id (1..15; 0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrival at barrier `id` without waiting (the other threads of its
// `count` sync on it).
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Shared-memory matrix descriptor: swizzle of ROW_BYTES (128 or 64), the
// tile's base aligned to the swizzle atom, both offsets in bytes.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "swizzle width");
  constexpr uint64_t layout = ROW_BYTES == 128 ? 1 : 2;
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= layout << 62;
  return d;
}

// Descriptor of a K-major tile at shared address addr (k-step 0).
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t desc_kmajor_at(uint32_t addr) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "swizzle width");
  constexpr uint64_t hi = ((uint64_t)(ROW_BYTES == 128 ? 1 : 2) << 62) |
                          ((uint64_t)((8 * ROW_BYTES) >> 4) << 32) | ((uint64_t)1 << 16);
  return hi | ((addr & 0x3FFFF) >> 4);
}

// Descriptor of an MN-major tile at shared address addr (k-step 0) whose M or
// N extent spans several ROW_BYTES-wide column boxes, lbo bytes apart (the
// leading offset of an MN-major layout); 8-row groups of K are 8 * ROW_BYTES
// apart. A 16-row step of K moves addr by 16 * ROW_BYTES.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t desc_mnmajor_at(uint32_t addr, uint32_t lbo) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "swizzle width");
  constexpr uint64_t hi =
      ((uint64_t)(ROW_BYTES == 128 ? 1 : 2) << 62) | ((uint64_t)((8 * ROW_BYTES) >> 4) << 32);
  return hi | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) | ((addr & 0x3FFFF) >> 4);
}

// Descriptor of a K-major tile (contraction along the row), k-step kk of 16.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk) {
  return make_desc<ROW_BYTES>(static_cast<const char*>(tile) + kk * 32, 16, 8 * ROW_BYTES);
}

// Descriptor of an MN-major tile (contraction across rows), k-step kk of 16.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk) {
  return make_desc<ROW_BYTES>(static_cast<const char*>(tile) + kk * 16 * ROW_BYTES,
                              8 * ROW_BYTES, 8 * ROW_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads and writes across a
// wgmma that is in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define IBK_F8(b) "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), \
                  "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory, both
// K-major. The accumulator layout per warp (w = warp % 4): d[4n + e] holds
// row 16w + g (+8 for e >= 2), column 8n + 2t + (e & 1), g = lane / 4, t =
// lane % 4.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : IBK_F8(0), IBK_F8(8), IBK_F8(16), IBK_F8(24), IBK_F8(32), IBK_F8(40), IBK_F8(48),
        IBK_F8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (as above), B
// K-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : IBK_F8(0), IBK_F8(8), IBK_F8(16), IBK_F8(24), IBK_F8(32), IBK_F8(40), IBK_F8(48),
        IBK_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (the layout of an
// mma.sync m16n8k16 A fragment for the warp's 16 rows), B MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : IBK_F8(0), IBK_F8(8), IBK_F8(16), IBK_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A from registers, B MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : IBK_F8(0), IBK_F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B from shared memory, both
// K-major (accumulator layout as wgmma_ss_n128's).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
      IBK_F8(0), IBK_F8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory, both
// K-major (accumulator layout as wgmma_ss_n128's).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      IBK_F8(0), IBK_F8(8), IBK_F8(16), IBK_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 192] (+)= A[64 x 16] B[16 x 192], A and B from shared memory, both
// K-major (accumulator layout as wgmma_ss_n128's).
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      :
      IBK_F8(0), IBK_F8(8), IBK_F8(16), IBK_F8(24), IBK_F8(32), IBK_F8(40), IBK_F8(48),
      IBK_F8(56), IBK_F8(64), IBK_F8(72), IBK_F8(80), IBK_F8(88)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 192] (+)= A[64 x 16] B[16 x 192], A from registers, B K-major.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      :
      IBK_F8(0), IBK_F8(8), IBK_F8(16), IBK_F8(24), IBK_F8(32), IBK_F8(40), IBK_F8(48),
      IBK_F8(56), IBK_F8(64), IBK_F8(72), IBK_F8(80), IBK_F8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B from shared memory; TA / TB
// 1 reads A / B MN-major (the contraction runs across the tile's rows: a
// box of a row-major matrix read transposed), 0 K-major (accumulator layout
// as wgmma_ss_n128's).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32t(float (&d)[16], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : IBK_F8(0), IBK_F8(8)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n96t(float (&d)[48], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : IBK_F8(0), IBK_F8(8), IBK_F8(16), IBK_F8(24), IBK_F8(32), IBK_F8(40)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n192t(float (&d)[96], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : IBK_F8(0), IBK_F8(8), IBK_F8(16), IBK_F8(24), IBK_F8(32), IBK_F8(40), IBK_F8(48), IBK_F8(56), IBK_F8(64), IBK_F8(72), IBK_F8(80), IBK_F8(88)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// The wgmma_ss_n*t of width N.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_sst(float (&d)[N / 2], uint64_t da, uint64_t db,
                                          int accumulate) {
  static_assert(N == 32 || N == 96 || N == 192, "wgmma N");
  if constexpr (N == 32)
    wgmma_ss_n32t<TA, TB>(d, da, db, accumulate);
  else if constexpr (N == 96)
    wgmma_ss_n96t<TA, TB>(d, da, db, accumulate);
  else
    wgmma_ss_n192t<TA, TB>(d, da, db, accumulate);
}

#undef IBK_F8

// Integer products: D[64 x N] (+)= A[64 x 32] B[32 x N], s8 x s8 -> s32, A
// and B from shared memory. 8-bit wgmma reads both operands K-major only (no
// transpose for .s8): A as rows of K bytes, B as rows (N of them) of K bytes,
// the layout of PyTorch's [out, in] int8 weight codes. One instruction takes
// K = 32 bytes. The accumulator layout is that of wgmma_ss_n128's (d[4n + e]:
// row 16w + g (+8 for e >= 2), column 8n + 2t + (e & 1)).
#define IBK_I8(b) "+r"(d[b]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]), \
                  "+r"(d[b + 4]), "+r"(d[b + 5]), "+r"(d[b + 6]), "+r"(d[b + 7])

__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : IBK_I8(0), IBK_I8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8_n96(int (&d)[48], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : IBK_I8(0), IBK_I8(8), IBK_I8(16), IBK_I8(24), IBK_I8(32), IBK_I8(40)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8_n192(int (&d)[96], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : IBK_I8(0), IBK_I8(8), IBK_I8(16), IBK_I8(24), IBK_I8(32), IBK_I8(40), IBK_I8(48),
        IBK_I8(56), IBK_I8(64), IBK_I8(72), IBK_I8(80), IBK_I8(88)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef IBK_I8

// The wgmma_s8_n* of width N.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 32 || N == 96 || N == 192, "wgmma N");
  if constexpr (N == 32)
    wgmma_s8_n32(d, da, db, accumulate);
  else if constexpr (N == 96)
    wgmma_s8_n96(d, da, db, accumulate);
  else
    wgmma_s8_n192(d, da, db, accumulate);
}


// D[64 x N] (+)= A[64 x 16] B[16 x N], A from registers, B MN-major, N in
// {64, 32} (the products that accumulate over rows: dV, dK, dQ).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 32, "wgmma N");
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db, accumulate);
  else
    wgmma_rs_n32(d, a, db, accumulate);
}

// The A fragments of a wgmma_rs product from a [64 x 16 KS] accumulator of
// this warpgroup (rows the product's, columns its contraction), rounded to
// bf16, 16 columns each.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4], const float (&c)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      __nv_bfloat162 v = __floats2bfloat162_rn(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
      a[kk][r] = *reinterpret_cast<uint32_t*>(&v);
    }
}

// The A fragment (mma.sync m16n8k16 layout) of rows row0..row0+15, columns
// 16kk..16kk+15 of a 64-row tile of ROW_BYTES-byte rows as TMA lands it,
// swizzled at the row width: 16-byte chunk c of row r lies at chunk c ^ (r
// % 8) (128-byte rows) or c ^ ((r / 2) % 4) (64-byte rows).
template <int ROW_BYTES>
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const void* tile, int row0, int kk,
                                           int lane) {
  const int r = row0 + (lane & 15), c = 2 * kk + (lane >> 4);
  const int sw = ROW_BYTES == 128 ? (r & 7) : ((r >> 1) & 3);
  const uint32_t addr = smem_u32(tile) + r * ROW_BYTES + ((c ^ sw) << 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace hopper
