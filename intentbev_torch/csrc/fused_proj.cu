// The residual projection y = gate * (x W + b) + residual (x [N, d_in], W
// [d_in, d_out] as in JAX, gate f32 per row), forward and backward, on
// Hopper, at d_in and d_out in {192, 384}.
//
// Forward. Replaces intentbev/ops/experimental/fused_proj.py::_fwd_kernel:
//   y = (f32(x W) + b) * gate + f32(residual), rounded once to bf16
// Bound on the H100: device memory. At the attention out-projection's shape
// (x and residual [36864, 384] bf16, W [384, 384]) a call moves 85.4 MB
// (x and residual in, y out) for 10.9 GFLOP: 0.0255 ms at 3.35 TB/s against
// 0.011 ms of bf16 tensor-core time.
//
// Backward. Replaces ::_bwd_kernel:
//   dyg = f32(dy) * gate;  dyg_c = bf16(dyg)
//   dx = dyg_c W^T (f32 sums, bf16);  dW = x^T dyg_c (f32);  db = sum dyg
// db sums the unrounded dyg, as the JAX kernel does; dW and dx take dyg_c.
// Bound on the H100 (the shape above): 86.0 MB of x, dy, dx and dW (0.0257
// ms) against 2 products, 21.7 GFLOP (0.022 ms): bytes.
//
// Design. Both row kernels are one warp-specialised shape, that of
// ln_dense_fwd_kernel (csrc/fused_ln_dense.cu) without the LayerNorm: a
// block of 384 threads owns 128 rows; a producer warpgroup (registers
// lowered) lands the block's rows of the A operand once by TMA ([128, K] in
// 64-column boxes, K-major), then walks the output columns in 192-wide
// tiles and each tile's K in 64-wide steps, keeping W's boxes in an
// mbarrier ring; two consumer warpgroups of 64 rows run wgmma m64n192k16
// into an f32 [64, 192] accumulator, release a slot once the next step's
// products are issued and its own have landed, and store their [64, 192]
// output tile by TMA through shared memory.
//  - proj_fwd_kernel<K = d_in>: A = x; B = W's [64 K, 192 N] read MN-major
//    from three [64][64] boxes (W is JAX's [d_in, d_out]: no transpose in
//    the wrapper). The residual tile lands by TMA with the tile's last K
//    step into the consumer's output tile; the epilogue computes ((acc + b)
//    * gate + res), each step rounded on its own (__fadd_rn, __fmul_rn: no
//    contracted FMA), rounds once to bf16 in place of the residual, and
//    stores it by TMA.
//  - proj_bwd_kernel<K = d_out>: A = dy, turned in place by the consumers
//    into dyg_c = bf16(f32(dy) * gate) (the swizzled layout that wgmma
//    reads), also TMA-stored to dg_ws for dW, while each warp sums the
//    unrounded dyg over its 16 rows for db (the block's partial row: its 8
//    warps in order); B = W's [192 N, 64 K] box, K-major; the epilogue
//    rounds dx once.
// Then, for the backward: db = col_sums_kernel over the block partials, and
// dW = x^T dg_ws on dw_gemm_kernel (csrc/ln_kernels.cuh; P = x [R, d_in],
// Q = dg_ws [R, d_out]) with split_sums_kernel over its row splits. Every
// sum runs in a fixed order: deterministic, no atomics. Rows past N land as
// TMA's zeros and are not stored.
#include "common.cuh"
#include "hopper.cuh"
#include "ln_kernels.cuh"

namespace {

constexpr int THREADS = 384;      // two consumer warpgroups and the producer
constexpr int ROWS = 128;         // rows of a block, 64 per consumer
constexpr int XBLK = ROWS * 128;  // one 64-column block of the block's rows
constexpr int TN = 192;           // output columns of a tile: the N of its products
constexpr int OBLK = 64 * 128;    // a [64][64] box of 128-byte rows
constexpr int WSLOT = TN * 128;   // a ring slot: W's boxes for one K step of a tile
constexpr int OTILE = (TN / 64) * OBLK;  // a consumer's [64][192] output tile

// Shared memory at contraction width K, from a 1024-byte boundary: the
// block's rows (K / 64 column blocks of [128][64]), S ring slots, each
// consumer's output tile (the forward's residual, then y in its place; the
// backward's dx; before the backward's first tile, db's warp sums), the
// forward's bias (staged: beside ~200 KB of tiles little L1 is left, and
// the epilogue would wait on L2 for each column group), the barriers.
template <int K>
struct Tiles {
  static constexpr int KB = K / 64;           // K steps of a tile
  static constexpr int S = K == 384 ? 3 : 4;  // slots of the W ring
  static constexpr int RING = KB * XBLK, OUT = RING + S * WSLOT, BIAS = OUT + 2 * OTILE;
  static constexpr int BARS = BIAS + 384 * 4;
  static constexpr int N_BARS = 6 + 2 * S;
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "width outside the kernel's tiling");
  static_assert(8 * K * 4 <= 2 * OTILE, "db's warp sums fit in the output tiles");
};

// The row kernel. Maps: ma the A rows ([n_rows, K]: x, or dy) and mo the
// output ([n_rows, tiles * 192]: y, or dx) in 64 x 64 boxes; mw W [d_in,
// d_out] in 64 x 64 boxes (forward) or 192 x 64 boxes (backward); mside the
// residual [n_rows, d_out] (forward) or dg_ws [n_rows, d_out] (backward) in
// 64 x 64 boxes. part_db [blocks][K] takes the backward's block partials of
// db.
template <int K, bool BWD>
__device__ __forceinline__ void proj_rows(const CUtensorMap& ma, const CUtensorMap& mw,
                                          const CUtensorMap& mo, const CUtensorMap& mside,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ gate,
                                          float* __restrict__ part_db, int n_rows, int tiles) {
  using L = Tiles<K>;
  constexpr int KB = L::KB, S = L::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* xfull = bar;         // [2] each consumer's rows
  uint64_t* rfull = bar + 2;     // [2] each consumer's residual tile (forward)
  uint64_t* rempty = bar + 4;    // [2] its y read by the TMA stores (forward)
  uint64_t* full = bar + 6;
  uint64_t* empty = full + S;

  // the warpgroup through a shuffle: warp-uniform to the compiler, which
  // otherwise takes the consumers' branches for divergent paths and
  // serialises their wgmma
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0), lane = tid % 32;
  const int row0 = blockIdx.x * ROWS;
  if (tid == 0) {
    for (int i = 0; i < 6; ++i) hopper::mbar_init(&bar[i], 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every load
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 256) {
      for (int h = 0; h < 2; ++h) {
        hopper::mbar_arrive_expect_tx(&xfull[h], 64 * K * 2);
        for (int b = 0; b < KB; ++b)
          hopper::tma_load_2d(sm + b * XBLK + h * 64 * 128, &ma, &xfull[h], 64 * b,
                              row0 + 64 * h);
      }
      for (int i = 0; i < tiles * KB; ++i) {
        const int s = i % S, j = i / KB, b = i % KB;
        hopper::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], WSLOT);
        uint8_t* slot = sm + L::RING + s * WSLOT;
        if constexpr (BWD) {
          hopper::tma_load_2d(slot, &mw, &full[s], 64 * b, TN * j);
        } else {
          for (int c = 0; c < TN / 64; ++c)
            hopper::tma_load_2d(slot + c * OBLK, &mw, &full[s], TN * j + 64 * c, 64 * b);
          if (b == KB - 1)  // the tile's residual, once its previous y is stored
            for (int h = 0; h < 2; ++h) {
              hopper::mbar_wait(&rempty[h], (j & 1) ^ 1);
              hopper::mbar_arrive_expect_tx(&rfull[h], OTILE);
              for (int c = 0; c < TN / 64; ++c)
                hopper::tma_load_2d(sm + L::OUT + h * OTILE + c * OBLK, &mside, &rfull[h],
                                    TN * j + 64 * c, row0 + 64 * h);
            }
        }
      }
    }
    return;
  }

  // consumers: 64 rows each
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wt = tid % 128, warp = wt / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t sbase = hopper::smem_u32(sm);
  uint8_t* xs = sm + wg * 64 * 128;  // this consumer's rows in each column block
  const float* bsm = reinterpret_cast<const float*>(sm + L::BIAS);
  if constexpr (!BWD) {  // the bias into shared memory while x lands
    for (int c = tid; c < tiles * TN; c += 256) reinterpret_cast<float*>(sm + L::BIAS)[c] = bias[c];
    hopper::named_sync(3, 256);
  }
  hopper::mbar_wait(&xfull[wg], 0);
  if constexpr (BWD) {
    // dyg = f32(dy) * gate, rounded in place to dyg_c (a warp 16 rows, lane
    // l columns 2l, 2l + 1 of each 64-column block: 16-byte chunk l / 4 of
    // the row, swizzled as TMA lands it); each warp's column sums of the
    // unrounded dyg over its rows, in row order
    float cs[KB][2];
#pragma unroll
    for (int b = 0; b < KB; ++b) cs[b][0] = cs[b][1] = 0.f;
    const int gr = row0 + 64 * wg + 16 * warp + lane % 16;  // lane l's row's gate, for all
    const float gl = gr < n_rows ? gate[gr] : 0.f;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = 16 * warp + rr;
      const float gt = __shfl_sync(0xffffffffu, gl, rr);
      uint8_t* row = xs + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + (lane & 3) * 4;
#pragma unroll
      for (int b = 0; b < KB; ++b) {
        const float2 v = bf16x2_at(row + b * XBLK);
        const float a = __fmul_rn(v.x, gt), c = __fmul_rn(v.y, gt);
        cs[b][0] += a;
        cs[b][1] += c;
        *reinterpret_cast<uint32_t*>(row + b * XBLK) = pack_bf16x2(a, c);
      }
    }
    float* red = reinterpret_cast<float*>(sm + L::OUT);  // [8 consumer warps][K]
#pragma unroll
    for (int b = 0; b < KB; ++b)
      *reinterpret_cast<float2*>(red + (4 * wg + warp) * K + 64 * b + 2 * lane) =
          make_float2(cs[b][0], cs[b][1]);
    hopper::fence_proxy_async();  // the wgmma reads and TMA stores are async-proxy reads
    hopper::named_sync(1 + wg, 128);
    if (wt == 0) {
      for (int b = 0; b < KB; ++b)
        hopper::tma_store_2d(&mside, xs + b * XBLK, 64 * b, row0 + 64 * wg);
      hopper::bulk_commit();
    }
    hopper::named_sync(3, 256);  // both consumers' warp sums are in
    for (int c = tid; c < K; c += 256) {  // the block's partial row, warps in order
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) t += red[w * K + c];
      part_db[(size_t)blockIdx.x * K + c] = t;
    }
    hopper::named_sync(3, 256);  // read before the first tile's dx goes over them
  }

  float acc[TN / 2];  // row 16 warp + g (+8), column 8n + 2t4 (+1) of the tile
  uint8_t* os = sm + L::OUT + wg * OTILE;
  const uint32_t ob = hopper::smem_u32(os);
  const int la = 16 * warp + g, lb = la + 8;  // rows within this consumer's 64
  const int ra = row0 + 64 * wg + la, rb = ra + 8;
  const float ga = !BWD && ra < n_rows ? gate[ra] : 0.f;  // the forward's gates
  const float gb = !BWD && rb < n_rows ? gate[rb] : 0.f;
  auto release = [&](int i) {
    if (lane == 0) hopper::mbar_arrive(&empty[i % S]);
  };
  for (int j = 0; j < tiles; ++j) {
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const int i = j * KB + b, s = i % S;
      hopper::mbar_wait(&full[s], (i / S) & 1);
      // descriptor bases opaque to the compiler: else it keeps every
      // k-step's descriptor live across the loop
      uint32_t a0 = sbase + wg * 64 * 128 + b * XBLK, b0 = sbase + L::RING + s * WSLOT;
      asm volatile("" : "+r"(a0), "+r"(b0));
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = hopper::desc_kmajor_at<128>(a0 + kk * 32);
        if constexpr (BWD)
          hopper::wgmma_sst<TN, 0, 0>(acc, da, hopper::desc_kmajor_at<128>(b0 + kk * 32),
                                      b > 0 || kk > 0);
        else
          hopper::wgmma_sst<TN, 0, 1>(acc, da,
                                      hopper::desc_mnmajor_at<128>(b0 + kk * 16 * 128, OBLK),
                                      b > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      if (b > 0) {  // the previous step's products have landed: its slot is free
        hopper::wgmma_wait<1>();
        release(i - 1);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    release((j + 1) * KB - 1);

    // epilogue into this consumer's output tile. Element (r, c) lies at
    // swz<64>(r, c): box c / 64, row r, 16-byte chunk (c % 64 / 8) ^ r % 8.
    if constexpr (BWD) {
      if (wt == 0) hopper::bulk_wait_read();  // the previous tile's stores have read it
      hopper::named_sync(1 + wg, 128);
      static_for<TN / 8>([&](auto n_) {
        constexpr int n = decltype(n_)::value;
        const int c = 8 * n + 2 * t4;
        sts_b32(ob + swz<64>(la, c), pack_bf16x2(acc[4 * n], acc[4 * n + 1]));
        sts_b32(ob + swz<64>(lb, c), pack_bf16x2(acc[4 * n + 2], acc[4 * n + 3]));
      });
    } else {
      const float* bj = bsm + TN * j + 2 * t4;
      hopper::mbar_wait(&rfull[wg], j & 1);
      static_for<TN / 8>([&](auto n_) {
        constexpr int n = decltype(n_)::value;
        const int c = 8 * n + 2 * t4;
        const float2 bb = *reinterpret_cast<const float2*>(bj + 8 * n);
        const uint32_t pa = ob + swz<64>(la, c), pb = ob + swz<64>(lb, c);
        const float2 xa = lds_bf16x2(pa), xb = lds_bf16x2(pb);
        sts_b32(pa, pack_bf16x2(
                        __fadd_rn(__fmul_rn(__fadd_rn(acc[4 * n], bb.x), ga), xa.x),
                        __fadd_rn(__fmul_rn(__fadd_rn(acc[4 * n + 1], bb.y), ga), xa.y)));
        sts_b32(pb, pack_bf16x2(
                        __fadd_rn(__fmul_rn(__fadd_rn(acc[4 * n + 2], bb.x), gb), xb.x),
                        __fadd_rn(__fmul_rn(__fadd_rn(acc[4 * n + 3], bb.y), gb), xb.y)));
      });
    }
    hopper::fence_proxy_async();
    hopper::named_sync(1 + wg, 128);
    if (wt == 0) {
      for (int c = 0; c < TN / 64; ++c)
        hopper::tma_store_2d(&mo, os + c * OBLK, TN * j + 64 * c, row0 + 64 * wg);
      hopper::bulk_commit();
      if constexpr (!BWD) {  // the next residual may land once y is read
        hopper::bulk_wait_read();
        hopper::mbar_arrive(&rempty[wg]);
      }
    }
  }
  if (wt == 0) hopper::bulk_wait_read();  // the stores have read shared memory
}

template <int K>
__global__ void __launch_bounds__(THREADS, 1)
    proj_fwd_kernel(const __grid_constant__ CUtensorMap mx,
                    const __grid_constant__ CUtensorMap mw,
                    const __grid_constant__ CUtensorMap my,
                    const __grid_constant__ CUtensorMap mr,
                    const float* __restrict__ bias, const float* __restrict__ gate, int n_rows,
                    int tiles) {
  proj_rows<K, false>(mx, mw, my, mr, bias, gate, nullptr, n_rows, tiles);
}

template <int K>
__global__ void __launch_bounds__(THREADS, 1)
    proj_bwd_kernel(const __grid_constant__ CUtensorMap mdy,
                    const __grid_constant__ CUtensorMap mw,
                    const __grid_constant__ CUtensorMap mdx,
                    const __grid_constant__ CUtensorMap mdg,
                    const float* __restrict__ gate, float* __restrict__ part_db, int n_rows,
                    int tiles) {
  proj_rows<K, true>(mdy, mw, mdx, mdg, nullptr, gate, part_db, n_rows, tiles);
}

template <int DIN>
int launch_fwd(const void* x, const void* w, const void* bias, const void* res,
               const void* gate, void* y, int n_rows, int dout, cudaStream_t s) {
  using L = Tiles<DIN>;
  CUtensorMap mx, mw, my, mr;
  int err;
  if ((err = hopper::encode_2d(&mx, x, n_rows, DIN, 64, 64)) ||
      (err = hopper::encode_2d(&mw, w, DIN, dout, 64, 64)) ||
      (err = hopper::encode_2d(&my, y, n_rows, dout, 64, 64)) ||
      (err = hopper::encode_2d(&mr, res, n_rows, dout, 64, 64)))
    return err;
  static bool ok = false;  // the shared-memory limit is raised once
  if ((err = raise_once(proj_fwd_kernel<DIN>, L::BYTES, ok))) return err;
  proj_fwd_kernel<DIN><<<(n_rows + ROWS - 1) / ROWS, THREADS, L::BYTES, s>>>(
      mx, mw, my, mr, (const float*)bias, (const float*)gate, n_rows, dout / TN);
  return (int)cudaGetLastError();
}

// The row kernel, db's block partials summed, then dW = x^T dg_ws and its
// split sums.
template <int DOUT>
int launch_bwd(const void* x, const void* w, const void* dy, const void* gate, void* dx,
               void* dw, void* db, void* dg_ws, void* part, int n_rows, int din, int splits,
               cudaStream_t s) {
  using L = Tiles<DOUT>;
  CUtensorMap mdy, mw, mdx, mdg, mx;
  int err;
  if ((err = hopper::encode_2d(&mdy, dy, n_rows, DOUT, 64, 64)) ||
      (err = hopper::encode_2d(&mw, w, din, DOUT, TN, 64)) ||
      (err = hopper::encode_2d(&mdx, dx, n_rows, din, 64, 64)) ||
      (err = hopper::encode_2d(&mdg, dg_ws, n_rows, DOUT, 64, 64)) ||
      (err = hopper::encode_2d(&mx, x, n_rows, din, 64, 64)))
    return err;
  static bool ok = false, ok_dw = false;  // the shared-memory limits are raised once
  if ((err = raise_once(proj_bwd_kernel<DOUT>, L::BYTES, ok)) ||
      (err = raise_once(dw_gemm_kernel, DW_BYTES, ok_dw)))
    return err;
  const int nb = (n_rows + ROWS - 1) / ROWS;
  float* p = (float*)part;
  proj_bwd_kernel<DOUT><<<nb, THREADS, L::BYTES, s>>>(mdy, mw, mdx, mdg, (const float*)gate, p,
                                                      n_rows, din / TN);
  if ((err = (int)cudaGetLastError())) return err;
  ColSums cs = {{p, nullptr, nullptr, nullptr},
                {(float*)db, nullptr, nullptr, nullptr},
                {DOUT, 0, 0, 0},
                {nb, 0, 0, 0}};
  col_sums_kernel<<<dim3(DOUT / 32, 1), 256, 0, s>>>(cs);
  if ((err = (int)cudaGetLastError())) return err;

  // one product (M2 = 0: the grid holds product 1's tiles only, so the
  // second pair of maps, product 1's again, is never read)
  const int tiles = (din + DW_M - 1) / DW_M * ((DOUT + DW_N - 1) / DW_N);
  const int per = ((n_rows + DW_K - 1) / DW_K + splits - 1) / splits * DW_K;
  dw_gemm_kernel<<<tiles * splits, DW_THREADS, DW_BYTES, s>>>(mx, mdg, mx, mdg, p, din, DOUT, 0,
                                                              0, n_rows, per, splits);
  if ((err = (int)cudaGetLastError())) return err;
  const int n4 = din * DOUT / 4;
  split_sums_kernel<<<(n4 + 255) / 256, 256, 0, s>>>((const float4*)p, splits, n4, n4,
                                                     (float4*)dw, (float4*)dw);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [n_rows, d_in], w bf16 [d_in, d_out], bias f32 [d_out], res and y
// bf16 [n_rows, d_out], gate f32 [n_rows]; d_in and d_out 192 or 384; every
// tensor 16-byte aligned (TMA).
extern "C" int ibk_fused_proj(const void* x, const void* w, const void* bias, const void* res,
                              const void* gate, void* y, int n_rows, int din, int dout,
                              void* stream) {
  if (dout != 192 && dout != 384) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return by_width<384, 192>(din, [&](auto di) {
    return launch_fwd<decltype(di)::value>(x, w, bias, res, gate, y, n_rows, dout, s);
  });
}

// Backward of ibk_fused_proj. Outputs: dx bf16 [n_rows, d_in]; dw f32 [d_in,
// d_out]; db f32 [d_out]. Workspaces: dg_ws bf16 [n_rows, d_out]; part f32
// of max(splits * d_in * d_out, ceil(n_rows / 128) * d_out). splits: the
// row splits of the dW product (ops/experimental/fused_proj.py).
extern "C" int ibk_fused_proj_bwd(const void* x, const void* w, const void* dy,
                                  const void* gate, void* dx, void* dw, void* db, void* dg_ws,
                                  void* part, int n_rows, int din, int dout, int splits,
                                  void* stream) {
  if (n_rows <= 0 || splits <= 0 || (din != 192 && din != 384))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return by_width<384, 192>(dout, [&](auto dn) {
    return launch_bwd<decltype(dn)::value>(x, w, dy, gate, dx, dw, db, dg_ws, part, n_rows, din,
                                           splits, s);
  });
}
