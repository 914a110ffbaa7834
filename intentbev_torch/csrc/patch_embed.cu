// Patch embed of a dense NHWC BEV on Hopper: tokens = conv_PxP,sP(x) + bias,
// at the model widths D = 768 (ViT-B), 384 (ViT-S) and 192 (ViT-Ti).
// Replaces intentbev/ops/patch_embed.py::_kernel, which slices a VMEM band of
// patch rows into 64 (dy, dx) [M, C] x [C, D] matmuls.
//
// The function is one GEMM. For a fixed dy the P*C values under token t of
// patch row q (q = b * H/P + py) are one contiguous run: row (q*P + dy)*gw +
// t of x viewed as [B*H*gw, P*C] (row stride P*C*2 = 4640 bytes at C = 290).
// So a patch row's A operand for one dy is gw consecutive rows of that view,
// one TMA box (no im2col), and its B operand is the slab W[dy] of the weight
// viewed as [P, P*C, D] (N contiguous: an MN-major B).
//   tokens[q*gw + t, :] = bias + sum over dy, k < P*C of
//                         X[(q*P + dy)*gw + t, k] * W[dy, k, :]   (f32, bf16 out)
// Bound on the H100: a batch of 8 bench frames ([8, 400, 720, 290] -> [8,
// 4500, D]) is M = 36000, K = 18560: 513 GFLOP at D = 384, 0.519 ms at 989
// TFLOP/s, against 1.378 GB (x 1.336 GB) of bytes, 0.411 ms at 3.35 TB/s; at
// D = 192 the bytes bound (1.357 GB, 0.405 ms) is above the operations' (0.259
// ms), and holds only if x is read from device memory once; at D = 768 the
// operations' (1.026 TFLOP, 1.038 ms).
// Design (warp-specialised, 512 threads: three consumer warpgroups and a
// producer warpgroup whose one thread issues every TMA load):
//  - M: a tile is two patch rows, each a 96-row box (gw <= 96; a 96-row box
//    keeps the 128-byte swizzle's 8-row groups aligned), 192 rows, 64 a
//    consumer. Rows gw..95 of a box are the next image row's tokens, or TMA's
//    zeros past the tensor, and are not stored: 90 of 96 rows are products
//    the output keeps (94 %; a 128-row tile of one patch row keeps 70 %).
//  - N: a block takes 192 output columns, a [64, 192] f32 accumulator a
//    consumer (96 registers); at D = 384 the two column halves are two
//    neighbouring blocks that walk the same patch rows in step, so the
//    second read of each A box comes from L2 and x leaves device memory once
//    (at D = 768 four blocks, three of the four reads from L2).
//  - K: per dy, ceil(P*C / 64) boxes of 64 columns (128-byte rows): P*C =
//    2320 = 36*64 + 16, and TMA fills the 37th box past 2320 with zeros in both
//    operands (a 3-D map over W [P, P*C, D] ends each dy's slab), so nothing
//    is padded in device memory and 2 % of the products add zeros. A ring
//    slot holds one K step: the two A boxes [96][64] K-major and W's three
//    [64 K][64 N] boxes read MN-major, 48 KB; four slots. Each consumer runs
//    wgmma m64n192k16 over its 64 rows, releasing a slot once the next
//    step's products are issued and its own have landed.
//  - Waves: a persistent grid, one block an SM. Each group of D / 192 blocks
//    takes a contiguous run of floor or ceil(R / groups) patch rows in pairs
//    (a last odd row as a single tile whose second box lies past the tensor:
//    zeros, and the consumer whose 64 rows are all outside the output issues
//    no products). At the bench's R = 400: D = 384, 66 groups of 6-7 rows,
//    the longest 3 pairs and a single, ~3.67 tile times against 3.03 on
//    average; D = 192, 132 groups of 3-4 rows, 2 tile times against 1.52;
//    D = 768, 33 groups of 12-13 rows, 7 tile times against 6.06.
//  - Epilogue: the f32 bias, one rounding to bf16, each consumer's [64, 64]
//    column blocks staged swizzled in shared memory and stored by TMA through
//    a 3-D map over the tokens [R, gw, D] in boxes of 32 tokens: rows past gw
//    and patch rows past R lie outside the map and are not written.
// The f32 sums run over the same 16-wide K slices in the same order as the
// parent's mma.sync kernel (the zero slices past P*C add +0), and the card
// gave the same bits. ptxas -v notes one injected warpgroup.wait (C7517) at
// the back edge of the loop over tiles, where no wgmma is in flight.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 512;          // three consumer warpgroups and the producer
constexpr int BOX_ROWS = 96;          // one patch row's tokens (gw <= 96)
constexpr int TN = 192;               // output columns of a block
constexpr int KB = 64;                // K columns of a box: 128-byte rows
constexpr int S = 4;                  // ring slots
constexpr int A_BOX = BOX_ROWS * 128;  // [96][64] bf16
constexpr int B_BOX = KB * 128;        // [64 K][64 N] bf16
constexpr int STAGE = 2 * A_BOX + (TN / 64) * B_BOX;
constexpr int YBLK = 64 * 128;         // a consumer's [64][64] staging block
constexpr int Y = S * STAGE, BARS = Y + 3 * YBLK;
constexpr int BYTES = BARS + 2 * S * 8 + 1024;  // + alignment slack
static_assert(BYTES <= 232448, "shared memory");
// setmaxnreg: 128 * 24 + 384 * 160 <= 65536, the 128 a thread of 512 gets
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 160;

// Byte offset of column c (bf16, < 64) of row r in a [64][64] block of
// 128-byte rows as TMA swizzles them (16-byte chunk ^ r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// Maps: mx x as [B*H*gw, P*C] in [96][64] boxes; mw W as [P, P*C, D] in
// [64][64] boxes; my the tokens as [R, gw, D] in [32][64] boxes. n_rows = R
// patch rows, k_boxes = ceil(P*C / 64).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    patch_embed_kernel(const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mw,
                       const __grid_constant__ CUtensorMap my, const float* __restrict__ bias,
                       int n_rows, int gw, int patch, int k_boxes) {
  constexpr int NH = D / TN;  // blocks of a group: the column halves
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + BARS);
  uint64_t* empty = full + S;
  // the warpgroup through a shuffle: warp-uniform to the compiler, which
  // otherwise takes the consumers' branches for divergent paths and
  // serialises their wgmma
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0), lane = tid % 32;
  const int n0 = (blockIdx.x % NH) * TN, group = blockIdx.x / NH, groups = gridDim.x / NH;
  const int lo = (int)((long long)n_rows * group / groups);
  const int hi = (int)((long long)n_rows * (group + 1) / groups);
  const int steps = patch * k_boxes;  // K steps of a tile
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 12);  // one per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 3) {  // producer
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 384) {
      int i = 0;
      for (int q = lo; q < hi; q += 2) {
        const int qb = q + 1 < hi ? q + 1 : n_rows;  // past the tensor: zeros
        for (int dy = 0; dy < patch; ++dy)
          for (int kb = 0; kb < k_boxes; ++kb, ++i) {
            const int s = i % S;
            hopper::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(&full[s], STAGE);
            uint8_t* st = sm + s * STAGE;
            hopper::tma_load_2d(st, &mx, &full[s], kb * KB, (q * patch + dy) * gw);
            hopper::tma_load_2d(st + A_BOX, &mx, &full[s], kb * KB, (qb * patch + dy) * gw);
            for (int j = 0; j < TN / 64; ++j)
              hopper::tma_load_3d(st + 2 * A_BOX + j * B_BOX, &mw, &full[s], n0 + 64 * j,
                                  kb * KB, dy);
          }
      }
    }
    return;
  }

  // consumers: rows 64 wg .. 64 wg + 63 of each tile
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wt = tid % 128, warp = wt / 32, g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * wg;
  const int la = 16 * warp + g, lb = la + 8;  // rows within this consumer's 64
  uint8_t* ys = sm + Y + wg * YBLK;
  const uint32_t sbase = hopper::smem_u32(sm);
  float acc[TN / 2];  // row 16 warp + g (+8), column 8n + 2t4 (+1) of the block's 192
  auto release = [&](int i) {
    if (lane == 0) hopper::mbar_arrive(&empty[i % S]);
  };
  int i = 0;
  for (int q = lo; q < hi; q += 2) {
    const int qb = q + 1 < hi ? q + 1 : n_rows;
    // a 32-row half of this consumer's rows lies in one patch row: its
    // tokens r % 96 .. + 31 of patch row q (r < 96) or qb
    auto stored = [&](int r) { return r % BOX_ROWS < gw && (r < BOX_ROWS ? q : qb) < n_rows; };
    const bool active = stored(r0) || stored(r0 + 32);
    for (int k = 0; k < steps; ++k, ++i) {
      const int s = i % S;
      hopper::mbar_wait(&full[s], (i / S) & 1);
      if (active) {
        // descriptor bases opaque to the compiler: else it keeps every
        // k-step's descriptor live across the loop
        uint32_t a0 = sbase + s * STAGE + r0 * 128, b0 = sbase + s * STAGE + 2 * A_BOX;
        asm volatile("" : "+r"(a0), "+r"(b0));
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_sst<TN, 0, 1>(acc, hopper::desc_kmajor_at<128>(a0 + kk * 32),
                                      hopper::desc_mnmajor_at<128>(b0 + kk * 16 * 128, B_BOX),
                                      k > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous step's products: its slot is free
        if (k > 0) release(i - 1);
      } else {
        release(i);
      }
    }
    if (!active) continue;
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    release(i - 1);

    // epilogue: bias, one rounding, a [64, 64] column block at a time
    // through the staging block, which the previous block's stores have read
#pragma unroll
    for (int j = 0; j < TN / 64; ++j) {
      if (wt == 0) hopper::bulk_wait_read();
      hopper::named_sync(1 + wg, 128);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * t4, a = 4 * (8 * j + n);
        const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + 64 * j + c);
        *reinterpret_cast<uint32_t*>(ys + swz(la, c)) =
            pack_bf16x2(acc[a] + bb.x, acc[a + 1] + bb.y);
        *reinterpret_cast<uint32_t*>(ys + swz(lb, c)) =
            pack_bf16x2(acc[a + 2] + bb.x, acc[a + 3] + bb.y);
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
      if (wt == 0) {
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 32 * h;
          if (stored(r))
            hopper::tma_store_3d(&my, ys + h * 32 * 128, n0 + 64 * j, r % BOX_ROWS,
                                 r < BOX_ROWS ? q : qb);
        }
        hopper::bulk_commit();
      }
    }
  }
  if (wt == 0) hopper::bulk_wait_read();  // the stores have read the staging block
}

template <int D>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
           int C, int P, cudaStream_t stream) {
  const int gw = W / P, n_rows = B * (H / P), kp = P * C;
  CUtensorMap mx, mw, my;
  int err;
  if ((err = hopper::encode_2d(&mx, x, B * H * gw, kp, BOX_ROWS, KB)) ||
      (err = hopper::encode_3d(&mw, w, D, kp, P, 64, KB)) ||
      (err = hopper::encode_3d(&my, out, D, gw, n_rows, 64, 32)))
    return err;
  static bool raised = false;  // the shared-memory limit is raised once
  if (!raised) {
    if ((err = (int)cudaFuncSetAttribute(patch_embed_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES)))
      return err;
    raised = true;
  }
  int dev = 0, sms = 0;
  if ((err = (int)cudaGetDevice(&dev)) ||
      (err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  constexpr int NH = D / TN;
  const int groups = std::max(1, std::min(sms / NH, (n_rows + 1) / 2));
  patch_embed_kernel<D><<<groups * NH, THREADS, BYTES, stream>>>(
      mx, mw, my, (const float*)bias, n_rows, gw, P, (kp + KB - 1) / KB);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [B, H, W, C] (NHWC, 16-byte aligned); w bf16 [P, P, C, d]; bias f32
// [d]; out bf16 [B, (H/P)*(W/P), d]. d is 768, 384 or 192; needs H and W multiples
// of P, W/P <= 96 and P*C a multiple of 8 (TMA's 16-byte row stride).
extern "C" int ibk_patch_embed(const void* x, const void* w, const void* bias, void* out,
                               int B, int H, int W, int C, int d, int P, void* stream) {
  if (P <= 0 || H % P || W % P || W / P > BOX_ROWS || (P * C) % 8)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  return by_width<768, 384, 192>(d, [&](auto dw) {
    return launch<decltype(dw)::value>(x, w, bias, out, B, H, W, C, P, (cudaStream_t)stream);
  });
}
