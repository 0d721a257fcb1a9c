// conv3d_bn_relu: one BN-folded 3x3x3 conv3d layer of a cost filter.
//
// Replaces two TPU kernels of the JAX package that compute this function:
//   lwsnet_tpu/ops/pallas/costfilter.py:_dgrid_kernel  (stage 1, D=24, C=32)
//   lwsnet_tpu/ops/pallas/costfilter.py:_folded_kernel (stages 2-3, D=9, C=8)
// Their flat-HW lanes, banded (D+2)*C weights and mask rows are TPU layout
// devices; here the layer is a plain conv over (B, C, D, H, W):
//   y[b,co,d,h,w] = relu(sum_{ci,kd,kh,kw} x[b,ci,d+kd-1,h+kh-1,w+kw-1]
//                        * wt[ci,kd*9+kh*3+kw,co] + shift[co])
// with zero padding 1 in D, H and W. The next layer's BN scale is already
// folded into wt (in float32, cast once to the compute dtype) and its shift
// into `shift`; the caller applies layer 0's BN + ReLU before the first
// launch, so padding is zero after the activation. x and y are each
// NCDHW or channels-last-3d (B, D, H, W, C) in memory (`x_cl`, `y_cl`):
// the tensor-core route reads and writes channels-last, the CUDA cores
// read NCDHW and write either.
//
// Bound on the H100: the stage-1 32->32 layer is compute bound (9.40 GFLOP
// per launch at 368x1232: 9.51 us at 989 TFLOP/s, against 21.8 MB of
// input and output, 6.5 us at 3.35 TB/s); the stage-2/3 8->8 layers are
// bound by their bytes (32.6 MB a launch at stage 3: 9.7 us), but their
// route is held by its narrow products (below).
//
// Three routes picked by shape:
// * bf16, Co == 32, Ci == 16 or 32 (the stage-1 32->32 layers), channels-
//   last in and out: tensor cores through wgmma m64n32k16, Hopper's
//   warpgroup product (helpers in `tc.cuh`).
//   - Persistent blocks of three warpgroups, one block per SM: one thread
//     of warpgroup 0 issues the TMA copies, warpgroups 1 and 2 multiply
//     and write, taking the block's tiles in turn, so that one's epilogue
//     overlaps the other's products and both overlap the next tile's
//     copies.
//   - The 27 x Ci x 32 weights (54 KB at Ci = 32) are resident in shared
//     memory for the whole launch, as 1 KB wgmma B images laid out by the
//     wrapper and loaded in one bulk copy.
//   - Tile: TD = 2 depths x TH = 2 rows x TW = 64 pixels, all 32 output
//     channels: four m64n32 accumulators a product thread. The four output
//     rows read (TD+2)(TH+2) = 16 staged (d, h) rows of 72 pixels (66
//     needed, rounded up to 8 so that rows start on a 512-byte swizzle
//     boundary), where one row per tile read 9 each, 36 in all. TD = TH
//     = 2 is what the 227 KB fit: two 72 KB stages beside the 54 KB of
//     weights (TD = 2, TH = 3 would not fit two stages, and at D = 24,
//     H = 46 would cost a 13 % tail of tiles).
//   - Staging: one TMA box per staged row (zeros outside the volume, the
//     64-byte swizzle that ldmatrix reads conflict-free), on the stage's
//     mbarrier; the copies of the next tile fly while this one's products
//     run.
//   - Products: per (channel chunk, staged row, kw) one ldmatrix.x4 per
//     warp loads the A fragment at pixel offset kw, and one to four wgmma
//     (one per output row that reads that staged row) use it with the
//     resident B of tap (kd, kh, kw): 96 A loads for 216 wgmma per tile.
//     (A read by descriptor, re-read for each wgmma, ran slower on the
//     H100.)
//   - Epilogue: relu(acc + shift) in float32, one bf16 rounding, 16-byte
//     channels-last stores from the registers, ragged D, H and W masked.
//   Registers and spills (ptxas, `chip_smoke.py` phase 2 on the H100): 127
//   a thread at Ci = 32, 124 at Ci = 16, no spills.
// * bf16, Ci == Co == 8 (the stage-2/3 8->8 layers): the same persistent
//   TMA + mbarrier + wgmma design on 16-byte voxels (`c8` below). On the
//   CUDA cores this layer cannot reach its bound: 27 x 8 x 8 float32 FMAs
//   a voxel take about 52 us at stage 3 (1.02 M voxels) against 9.7 us of
//   bytes, where the tensor cores at their peak do them in under 4 us.
//   - Input channels-last, one voxel's 8 channels one 16-byte vector. A
//     staged row is 72 pixels x 8 channels of one (d, h), 1152 bytes,
//     unswizzled: eight consecutive pixels are 128 contiguous bytes, which
//     ldmatrix reads without a bank conflict. A tile's 30 staged rows are
//     one TMA box of the voxel map (`tc::make_voxel_map`: 1152-byte runs).
//   - No im2col: in a channels-last row the 16 elements from pixel p + 2j
//     on are pixels p + 2j and p + 2j + 1, i.e. taps kw = 2j and 2j + 1 of
//     output pixel p. So per staged row (kd, kh) two K = 16 slices, j = 0
//     and 1, cover the three kw taps and a fourth whose weights are zero:
//     one ldmatrix.x4 a slice, one wgmma m64n8k16 per output row that
//     reads the staged row, against the resident 16 x 8 B slice of (kd,
//     kh, j). The 18 slices are 4.6 KB, laid out by the wrapper.
//   - Tile: TD = 3 depths (D = 9 splits with no tail) x TH = 4 rows x TW =
//     64 pixels: 12 m64n8 accumulators (48 registers) a product thread,
//     30 staged rows (34.6 KB) a stage, six stages. The halo re-reads
//     come from L2. Four product warpgroups take a block's tiles in turn.
//   - What holds it (H100, `conv3d_c8_variants.py`): about 25 us at stage
//     3, 2.5x its bytes bound. The product warpgroups are busy (products
//     about half their time, the epilogue a third) while the staging
//     thread mostly waits for free stages, so they set the pace; yet 17 %
//     fewer products (the kw = 2 taps of two rows in one slice) gained
//     6 %, half as many wider ones (rows banded on N, m64n32k16) 2-4 %,
//     and mma.sync in place of wgmma nothing: which resource they share
//     holds them is open. 16-byte TMA runs cost 24 %. 95 registers a
//     thread, no spills.
//   - Output channels-last (4 bytes, two channels, a lane; 128 contiguous
//     bytes a warp) or NCDHW (`y_cl` = 0, for a caller that asks for it;
//     the forward's layers all write channels-last: 2-byte stores, eight
//     lanes on eight consecutive pixels of one channel).
// * otherwise (float32, the Ci = 1 entries): the CUDA cores. A block takes
//   an 8 x 32 pixel tile of one (b, d) slice, one pixel per thread, with
//   CO_T output channels in float32 registers. Weights go through shared
//   memory in chunks of CI_CHUNK input channels (27 * 8 * 32 floats = 27
//   KB); input taps are read straight from global memory, each voxel's 27
//   uses within a block hitting L1. A channels-last output of 8k channels
//   is written in 16-byte vectors.
#include <algorithm>

#include "tc.cuh"

namespace {

constexpr int CI_CHUNK = 8;

template <typename T, int CO_T>
__global__ void __launch_bounds__(THREADS)
conv3d_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                      const float* __restrict__ shift, T* __restrict__ y,
                      int Ci, int Co, int D, int H, int W, int y_cl) {
  __shared__ float ws[CI_CHUNK * 27 * CO_T];
  const int tx = threadIdx.x % TILE_W, ty = threadIdx.x / TILE_W;
  const int w = blockIdx.x * TILE_W + tx;
  const int h = blockIdx.y * TILE_H + ty;
  const int n_co = Co / CO_T;
  int z = blockIdx.z;
  const int co0 = (z % n_co) * CO_T;
  z /= n_co;
  const int d = z % D;
  const int b = z / D;
  const bool active = h < H && w < W;
  const size_t plane = (size_t)H * W;
  const size_t vol = (size_t)D * plane;
  const T* xb = x + (size_t)b * Ci * vol;

  float acc[CO_T];
#pragma unroll
  for (int c = 0; c < CO_T; ++c) acc[c] = 0.f;

  for (int ci0 = 0; ci0 < Ci; ci0 += CI_CHUNK) {
    const int nci = min(CI_CHUNK, Ci - ci0);
    __syncthreads();
    for (int i = threadIdx.x; i < nci * 27 * CO_T; i += THREADS) {
      const int c = i % CO_T, row = i / CO_T;  // row = ci_local * 27 + tap
      ws[i] = to_f(wt[(size_t)(ci0 * 27 + row) * Co + co0 + c]);
    }
    __syncthreads();
    if (!active) continue;
    for (int cl = 0; cl < nci; ++cl) {
      const T* xc = xb + (size_t)(ci0 + cl) * vol;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int dd = d + kd - 1;
        if (dd < 0 || dd >= D) continue;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const int hh = h + kh - 1;
          if (hh < 0 || hh >= H) continue;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const int ww = w + kw - 1;
            if (ww < 0 || ww >= W) continue;
            const float v = to_f(xc[dd * plane + (size_t)hh * W + ww]);
            const float* wp = ws + (cl * 27 + kd * 9 + kh * 3 + kw) * CO_T;
#pragma unroll
            for (int c = 0; c < CO_T; ++c) acc[c] = fmaf(v, wp[c], acc[c]);
          }
        }
      }
    }
  }
  if (!active) return;
  const size_t voxel = d * plane + (size_t)h * W + w;
  if (!y_cl) {
    T* yb = y + ((size_t)b * Co + co0) * vol + voxel;
#pragma unroll
    for (int c = 0; c < CO_T; ++c)
      yb[c * vol] = from_f<T>(fmaxf(acc[c] + shift[co0 + c], 0.f));
    return;
  }
  // Channels-last: 16-byte vectors of the thread's CO_T (8 or 32) channels.
  T* yb = y + ((size_t)b * vol + voxel) * Co + co0;
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int c0 = 0; c0 < CO_T; c0 += VEC) {
    __align__(16) T v[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      v[c] = from_f<T>(fmaxf(acc[c0 + c] + shift[co0 + c0 + c], 0.f));
    *reinterpret_cast<uint4*>(yb + c0) = *reinterpret_cast<const uint4*>(v);
  }
}

// ---- tensor-core route ----------------------------------------------------

constexpr int TD = 2, TH = 2, TW = 64;       // output tile
constexpr int SD = TD + 2, SH = TH + 2;      // staged depths and rows
constexpr int SROWS = SD * SH;               // staged rows
constexpr int LP = (TW + 2 + 7) / 8 * 8;     // their pixels, 512-B rows
constexpr int TC_THREADS = 384;              // staging + 2 product groups
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;             // per block, opted in

// The tensor-core routes (mirrored by `conv3d_tensor_core_route` in
// ops/cuda/costfilter.py).
bool use_tc(int elem_bytes, int Ci, int Co) {
  return elem_bytes == 2 &&
         ((Co == tc::N && (Ci == 16 || Ci == 32)) || (Ci == 8 && Co == 8));
}

template <int SC>
__host__ __device__ constexpr int stage_bytes() {
  return SROWS * LP * SC * 2;
}
// Weights, 2 x MAX_STAGES + 1 mbarriers (256 B); the stage ring starts at
// the next 1024-byte boundary.
template <int SC>
__host__ __device__ constexpr int fixed_bytes() {
  return 27 * SC * tc::N * 2 + 256;
}
template <int SC>
__host__ __device__ constexpr int tc_stages() {
  return (SMEM_MAX - fixed_bytes<SC>() - 1024) / stage_bytes<SC>() <
                 MAX_STAGES
             ? (SMEM_MAX - fixed_bytes<SC>() - 1024) / stage_bytes<SC>()
             : MAX_STAGES;
}
static_assert(tc_stages<32>() >= 2, "two stages must fit");

// Ci = SC input channels, one staged slab; map_x: the TMA map of x; wt:
// the (Ci / 16, 27) B images (the wrapper lays them out).
template <int SC>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv3d_bn_relu_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                         const bf16* __restrict__ wt,
                         const float* __restrict__ shift,
                         bf16* __restrict__ y, int B, int D, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KC = SC / 16, PX = SC * 2, ROW = LP * PX;
  constexpr int S = tc_stages<SC>(), SB = stage_bytes<SC>();
  const uint32_t wbase = tc::smem_addr(smem);
  const uint32_t bars = wbase + 27 * SC * tc::N * 2;
  const uint32_t stage0 = (wbase + fixed_bytes<SC>() + 1023) & ~1023u;
  // Per stage: copies landed, read by the products; then the weights'.
  auto landed = [&](int n) { return bars + 8 * (n % S); };
  auto empty = [&](int n) { return bars + 8 * (MAX_STAGES + n % S); };
  const uint32_t weights = bars + 8 * 2 * MAX_STAGES;
  const int wg = threadIdx.x / 128;
  const int nd = ceil_div(D, TD), nh = ceil_div(H, TH), ncx = ceil_div(W, TW);
  const int ntiles = B * nd * nh * ncx;
  const int my_tiles = (int)blockIdx.x < ntiles
                           ? (ntiles - 1 - (int)blockIdx.x) / gridDim.x + 1
                           : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      tc::mbar_init(landed(s), 1);
      tc::mbar_init(empty(s), 128);
    }
    tc::mbar_init(weights, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // resident weights: one bulk copy
    tc::mbar_expect_tx(weights, 27 * SC * tc::N * 2);
    tc::bulk_load(wbase, wt, 27 * SC * tc::N * 2, weights);
  }

  struct Tile {
    int b, d0, h0, w0;
  };
  auto tile_of = [&](int n) {
    int t = blockIdx.x + n * gridDim.x;
    Tile r;
    r.w0 = (t % ncx) * TW;
    t /= ncx;
    r.h0 = (t % nh) * TH;
    t /= nh;
    r.d0 = (t % nd) * TD;
    r.b = t / nd;
    return r;
  };

  if (wg == 0) {
    // Staging: one thread issues tile n's 16 row copies into stage
    // n % S, on the stage's barrier, once the products have read it.
    if (threadIdx.x == 0)
      for (int n = 0; n < my_tiles; ++n) {
        if (n >= S) tc::mbar_wait(empty(n), ((n / S) & 1) ^ 1);
        const Tile t = tile_of(n);
        const uint32_t buf = stage0 + (n % S) * SB;
        tc::mbar_expect_tx(landed(n), SB);
        for (int sr = 0; sr < SROWS; ++sr)
          tc::tma_load_5d(buf + sr * ROW, &map_x, landed(n), 0, t.w0 - 1,
                          t.h0 - 1 + sr % SH, t.d0 - 1 + sr / SH, t.b);
      }
    return;
  }

  // Product warpgroups: warpgroup wg takes the block's tiles wg - 1,
  // wg + 1, ...; per (channel chunk, staged row, kw) one A descriptor (64
  // staged pixels from kw on), used by every output row that reads that
  // staged row with the resident B of its tap.
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint64_t desc0 = tc::b_desc(wbase);
  uint32_t ao[KC][3];  // this lane's A row at (kc, kw) in any staged row
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
      ao[kc][kw] = tc::chunk_offset<SC>(warp * 16 + lane % 16 + kw,
                                        kc * 2 + lane / 16);
  tc::mbar_wait(weights, 0);
  float sh[8];  // this lane's output channels 8j + 2(lane % 4) + {0, 1}
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sh[2 * j] = shift[8 * j + 2 * (lane % 4)];
    sh[2 * j + 1] = shift[8 * j + 2 * (lane % 4) + 1];
  }
  tc::Acc acc[TD * TH];
  for (int m = wg - 1; m < my_tiles; m += 2) {
    tc::mbar_wait(landed(m), (m / S) & 1);
    const uint32_t buf = stage0 + (m % S) * SB;
#pragma unroll
    for (int o = 0; o < TD * TH; ++o) tc::zero(acc[o]);
    constexpr int NG = KC * SROWS * 3, NBUF = 4;
    auto load = [&](uint32_t (&f)[4], int q) {
      const int kc = q / (SROWS * 3), sr = q / 3 % SROWS, kw = q % 3;
      tc::ldsm_x4(f, buf + sr * ROW + ao[kc][kw]);
    };
    uint32_t af[NBUF][4];
    load(af[0], 0);
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      if (q + 1 < NG) {
        if (q + 1 >= NBUF) tc::wgmma_wait<NBUF - 2>();
        load(af[(q + 1) % NBUF], q + 1);
      }
      tc::wgmma_fence();
      const int kc = q / (SROWS * 3), sr = q / 3 % SROWS, kw = q % 3;
#pragma unroll
      for (int o = 0; o < TD * TH; ++o) {
        const int kd = sr / SH - o / TH, kh = sr % SH - o % TH;
        if (kd < 0 || kd > 2 || kh < 0 || kh > 2) continue;
        tc::wgmma_m64n32k16(
            acc[o], af[q % NBUF],
            desc0 + (kc * 27 + kd * 9 + kh * 3 + kw) * (tc::B_SLICE >> 4));
      }
      tc::wgmma_commit();
    }
    tc::wgmma_wait<0>();
    tc::mbar_arrive(empty(m));  // the tile's wgmma have read the stage
    const Tile t = tile_of(m);
#pragma unroll
    for (int o = 0; o < TD * TH; ++o) {
      tc::fence_operand(acc[o]);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        acc[o].v[e] = fmaxf(acc[o].v[e] + sh[2 * (e / 4) + e % 2], 0.f);
      const int dz = t.d0 + o / TH, h = t.h0 + o % TH;
      const bool rv = dz < D && h < H;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = t.w0 + warp * 16 + lane / 4 + 8 * half;
        const bool ok = rv && w < W;
        bf16* px = y + ((((size_t)t.b * D + (ok ? dz : 0)) * H +
                         (ok ? h : 0)) * W + (ok ? w : 0)) * tc::N;
        tc::store_row<bf16>(acc[o], half, px, ok);
      }
    }
  }
}

template <int SC>
int launch_tc(const void* x, const void* wt, const void* shift, void* y,
              int B, int D, int H, int W, cudaStream_t s) {
  auto kernel = conv3d_bn_relu_tc_kernel<SC>;
  constexpr int smem =
      fixed_bytes<SC>() + 1024 + tc_stages<SC>() * stage_bytes<SC>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (tc::sm_count() < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cuuint64_t dims[5] = {(cuuint64_t)SC, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)D, (cuuint64_t)B};
  const int rc = tc::make_map(&map, x, 5, dims, SC, LP);
  if (rc != 0) return rc;
  const int tiles = B * ceil_div(D, TD) * ceil_div(H, TH) * ceil_div(W, TW);
  kernel<<<std::min(tiles, tc::sm_count()), TC_THREADS, smem, s>>>(
      map, (const bf16*)wt, (const float*)shift, (bf16*)y, B, D, H, W);
  return (int)cudaGetLastError();
}

// ---- the C = 8 tensor-core route ------------------------------------------

namespace c8 {

constexpr int TD = 3, TH = 4, TW = 64;   // output tile
constexpr int SD = TD + 2, SH = TH + 2;  // staged depths and rows
constexpr int SROWS = SD * SH;           // 30 staged rows
constexpr int LP = 72;                   // their pixels: TW + 3, to 8
constexpr int ROW = LP * 16;             // 16 bytes a voxel
constexpr int SB = SROWS * ROW;          // bytes a stage
constexpr int SLICE = 16 * 8 * 2;        // one 16 x 8 B slice
constexpr int WBYTES = 9 * 2 * SLICE;    // per (kd, kh, j)
constexpr int GROUPS = 4;                // product warpgroups
constexpr int THREADS = 128 * (1 + GROUPS);
constexpr int FIXED = WBYTES + 256 + 128;  // weights, mbarriers, alignment
constexpr int STAGES = (SMEM_MAX - FIXED) / SB < MAX_STAGES
                           ? (SMEM_MAX - FIXED) / SB
                           : MAX_STAGES;
constexpr int SMEM = FIXED + STAGES * SB;
static_assert(STAGES >= 2, "two stages must fit");

// map_x: the voxel map of x (`tc::make_voxel_map`); wt: the 18 B slices (the
// wrapper lays them out); y channels-last (y_cl) or NCDHW.
__global__ void __launch_bounds__(THREADS, 1)
conv3d_bn_relu_c8_kernel(const __grid_constant__ CUtensorMap map_x,
                         const bf16* __restrict__ wt,
                         const float* __restrict__ shift,
                         bf16* __restrict__ y, int B, int D, int H, int W,
                         int y_cl) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t wbase = tc::smem_addr(smem);
  const uint32_t bars = wbase + WBYTES;
  const uint32_t stage0 = (bars + 256 + 127) & ~127u;
  auto landed = [&](int n) { return bars + 8 * (n % STAGES); };
  auto empty = [&](int n) { return bars + 8 * (MAX_STAGES + n % STAGES); };
  const uint32_t weights = bars + 8 * 2 * MAX_STAGES;
  const int wg = threadIdx.x / 128;
  const int nd = ceil_div(D, TD), nh = ceil_div(H, TH), ncx = ceil_div(W, TW);
  const int ntiles = B * nd * nh * ncx;
  const int my_tiles = (int)blockIdx.x < ntiles
                           ? (ntiles - 1 - (int)blockIdx.x) / gridDim.x + 1
                           : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(landed(s), 1);
      tc::mbar_init(empty(s), 128);
    }
    tc::mbar_init(weights, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // resident weights: one bulk copy
    tc::mbar_expect_tx(weights, WBYTES);
    tc::bulk_load(wbase, wt, WBYTES, weights);
  }

  struct Tile {
    int b, d0, h0, w0;
  };
  auto tile_of = [&](int n) {
    int t = blockIdx.x + n * gridDim.x;
    Tile r;
    r.w0 = (t % ncx) * TW;
    t /= ncx;
    r.h0 = (t % nh) * TH;
    t /= nh;
    r.d0 = (t % nd) * TD;
    r.b = t / nd;
    return r;
  };

  if (wg == 0) {
    // Staging: one thread issues tile n's copy, its 30 staged rows in one
    // TMA box, into stage n % STAGES, once the products have read what it
    // held.
    if (threadIdx.x == 0)
      for (int n = 0; n < my_tiles; ++n) {
        if (n >= STAGES) tc::mbar_wait(empty(n), ((n / STAGES) & 1) ^ 1);
        const Tile t = tile_of(n);
        tc::mbar_expect_tx(landed(n), SB);
        tc::tma_load_4d(stage0 + (n % STAGES) * SB, &map_x, landed(n),
                        2 * (t.w0 - 1), t.h0 - 1, t.d0 - 1, t.b);
      }
    return;
  }

  // Product warpgroups: warpgroup wg takes the block's tiles wg - 1,
  // wg - 1 + GROUPS, ...; per (staged row, j) one A fragment, this lane's
  // row at pixel warp * 16 + lane % 16 + 2j + lane / 16 (the k half
  // lane / 16 is the next pixel), used by every output row that reads
  // that staged row.
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint64_t desc0 = tc::b_desc(wbase);
  const uint32_t ao = (warp * 16 + lane % 16 + lane / 16) * 16;
  tc::mbar_wait(weights, 0);
  const float s0 = shift[2 * (lane % 4)], s1 = shift[2 * (lane % 4) + 1];
  const size_t vol = (size_t)D * H * W;
  tc::Acc8 acc[TD * TH];
  for (int m = wg - 1; m < my_tiles; m += GROUPS) {
    tc::mbar_wait(landed(m), (m / STAGES) & 1);
    const uint32_t buf = stage0 + (m % STAGES) * SB;
#pragma unroll
    for (int o = 0; o < TD * TH; ++o) {
      tc::zero(acc[o]);
      tc::fence_operand(acc[o]);  // the zeros before the first wgmma
    }
    constexpr int NG = SROWS * 2, NBUF = 4;
    uint32_t af[NBUF][4];
    tc::ldsm_x4(af[0], buf + ao);
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      if (q + 1 < NG) {
        if (q + 1 >= NBUF) tc::wgmma_wait<NBUF - 2>();
        tc::ldsm_x4(af[(q + 1) % NBUF],
                    buf + (q + 1) / 2 * ROW + ao + (q + 1) % 2 * 32);
      }
      tc::wgmma_fence();
      const int sd = q / 2 / SH, sh = q / 2 % SH, j = q % 2;
#pragma unroll
      for (int o = 0; o < TD * TH; ++o) {
        const int kd = sd - o / TH, kh = sh - o % TH;
        if (kd < 0 || kd > 2 || kh < 0 || kh > 2) continue;
        tc::wgmma_m64n8k16(acc[o], af[q % NBUF],
                           desc0 + ((kd * 3 + kh) * 2 + j) * (SLICE >> 4));
      }
      tc::wgmma_commit();
    }
    tc::wgmma_wait<0>();
    tc::mbar_arrive(empty(m));  // the tile's wgmma have read the stage
    const Tile t = tile_of(m);
#pragma unroll
    for (int o = 0; o < TD * TH; ++o) {
      tc::fence_operand(acc[o]);
      const int dz = t.d0 + o / TH, h = t.h0 + o % TH;
      if (dz >= D || h >= H) continue;
      const size_t row = (((size_t)t.b * D + dz) * H + h) * W;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = t.w0 + warp * 16 + lane / 4 + 8 * half;
        if (w >= W) continue;
        const float v0 = fmaxf(acc[o].v[2 * half] + s0, 0.f);
        const float v1 = fmaxf(acc[o].v[2 * half + 1] + s1, 0.f);
        if (y_cl) {  // this lane's two channels of pixel w
          *reinterpret_cast<uint32_t*>(y + (row + w) * 8 + 2 * (lane % 4)) =
              tc::pack_bf16(v0, v1);
        } else {  // planes of channels 2 (lane % 4) and the next
          bf16* p = y + ((size_t)t.b * 8 + 2 * (lane % 4)) * vol +
                    ((size_t)dz * H + h) * W + w;
          p[0] = from_f<bf16>(v0);
          p[vol] = from_f<bf16>(v1);
        }
      }
    }
  }
}

int launch(const void* x, const void* wt, const void* shift, void* y, int B,
           int D, int H, int W, int y_cl, cudaStream_t s) {
  auto kernel = conv3d_bn_relu_c8_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  if (tc::sm_count() < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int rc = tc::make_voxel_map(&map, x, B, D, H, W, LP, SH, SD);
  if (rc != 0) return rc;
  const int tiles = B * ceil_div(D, TD) * ceil_div(H, TH) * ceil_div(W, TW);
  kernel<<<std::min(tiles, tc::sm_count()), THREADS, SMEM, s>>>(
      map, (const bf16*)wt, (const float*)shift, (bf16*)y, B, D, H, W, y_cl);
  return (int)cudaGetLastError();
}

}  // namespace c8

template <typename T>
int launch(const void* x, const void* wt, const void* shift, void* y, int B,
           int Ci, int Co, int D, int H, int W, int x_cl, int y_cl,
           void* stream) {
  const int co_t = Co % 32 == 0 ? 32 : (Co % 8 == 0 ? 8 : 0);
  if (co_t == 0 || Ci < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_tc(sizeof(T), Ci, Co)) {
    // The routes read channels-last only; the 32-channel one writes it
    // only, the 8-channel one either layout.
    if (!x_cl) return (int)cudaErrorInvalidValue;
    if (Co == 8) return c8::launch(x, wt, shift, y, B, D, H, W, y_cl, s);
    if (!y_cl) return (int)cudaErrorInvalidValue;
    return Ci == 32 ? launch_tc<32>(x, wt, shift, y, B, D, H, W, s)
                    : launch_tc<16>(x, wt, shift, y, B, D, H, W, s);
  }
  if (x_cl) return (int)cudaErrorInvalidValue;  // the CUDA cores read NCDHW
  dim3 grid(ceil_div(W, TILE_W), ceil_div(H, TILE_H), B * D * (Co / co_t));
  const T* xp = (const T*)x;
  const T* wp = (const T*)wt;
  const float* sp = (const float*)shift;
  if (co_t == 32)
    conv3d_bn_relu_kernel<T, 32><<<grid, THREADS, 0, s>>>(
        xp, wp, sp, (T*)y, Ci, Co, D, H, W, y_cl);
  else
    conv3d_bn_relu_kernel<T, 8><<<grid, THREADS, 0, s>>>(
        xp, wp, sp, (T*)y, Ci, Co, D, H, W, y_cl);
  return (int)cudaGetLastError();
}

}  // namespace

#define CONV3D_BN_RELU_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* x, const void* wt, const void* shift,      \
                      void* y, int B, int Ci, int Co, int D, int H, int W,   \
                      int x_cl, int y_cl, void* stream) {                    \
    return launch<T>(x, wt, shift, y, B, Ci, Co, D, H, W, x_cl, y_cl,        \
                     stream);                                                \
  }

CONV3D_BN_RELU_ENTRY(conv3d_bn_relu_f32, float)
CONV3D_BN_RELU_ENTRY(conv3d_bn_relu_bf16, bf16)
