// conv3d_bn_relu: one BN-folded 3x3x3 conv3d layer of a cost filter.
//
// Replaces two TPU kernels of the JAX package that compute this function:
//   lwsnet_tpu/ops/pallas/costfilter.py:_dgrid_kernel  (stage 1, D=24, C=32)
//   lwsnet_tpu/ops/pallas/costfilter.py:_folded_kernel (stages 2-3, D=9, C=8)
// at the shipped widths, and at every width and D they take (the JAX
// package picks between them by (D + 2) C <= 128).
// Their flat-HW lanes, banded (D+2)*C weights and mask rows are TPU layout
// devices; here the layer is a plain conv over (B, C, D, H, W):
//   y[b,co,d,h,w] = relu(sum_{ci,kd,kh,kw} act(x[b,ci,d+kd-1,h+kh-1,w+kw-1])
//                        * wt[ci,kd*9+kh*3+kw,co] + shift[co])
// with zero padding 1 in D, H and W. The next layer's BN scale is already
// folded into wt (in float32, cast once to the compute dtype) and its shift
// into `shift`. act is the identity, but at a stage's entry (Ci = 1), where
// it is layer 0's BN + ReLU, relu(x * a0 + b0) rounded once to the compute
// dtype, given as a pointer `aff` to (a0, b0): the JAX package applies it
// to the raw volume before its kernels (costfilter.py:206-210, :480-484).
// The padding is zero after the activation (relu(b0) != 0 where b0 > 0),
// so act applies inside the volume only. x and y are each NCDHW or
// channels-last-3d (B, D, H, W, C) in memory (`x_cl`, `y_cl`): the
// tensor-core routes read and write channels-last, the CUDA cores read
// NCDHW and write either.
//
// Bound on the H100: the stage-1 32->32 layer is compute bound (9.40 GFLOP
// per launch at 368x1232: 9.51 us at 989 TFLOP/s, against 21.8 MB of
// input and output, 6.5 us at 3.35 TB/s), as is a 64->64 layer over D =
// 72 at 46x154 (112.8 GFLOP, 114.1 us, against 130.6 MB, 39.0 us); the
// 16->16 layer of AnyNet's stage 1 is bound by its bytes; the stage-2/3
// 8->8 layers are bound by their bytes (32.6 MB a launch at stage 3: 9.7
// us), but their route is held by its narrow products (below). The
// entries are bound by their write stream: 10.9 MB at stage 1 (3.3 us),
// 4.1 and 16.3 MB at stages 2 and 3 (1.4 and 5.4 us); AnyNet's 1->16 2.9
// MB (0.86 us), its 1->4 1.4 and 5.7 MB at stages 2 and 3 (0.42, 1.69
// us), a 64-channel filter's 1->64 over D = 72 at 46x154 66.3 MB (19.8
// us). AnyNet's 4->4 layers are bound by their bytes: 9.1 MB a launch at
// stage 3 (2.7 us), 2.3 MB at stage 2 (0.7 us).
//
// Five routes picked by shape:
// * bf16, Co == 32, Ci == 16 or 32 (the stage-1 32->32 layers), and Ci ==
//   Co == 16 or 64 (AnyNet's stage-1 16->16 layers, a 64-channel filter),
//   channels-last in and out: tensor cores through wgmma m64n32k16,
//   Hopper's warpgroup product (helpers in `tc.cuh`).
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
//   - 16 -> 16: the 16 -> 32 body with the weights zero-padded to 32
//     outputs by the wrapper and the upper 16 columns not stored (lanes
//     t = 2, 3 of each quad skip their 16-byte store). Not an m64n16k16
//     product: the layer is bound by its bytes (AnyNet's stage 1 at
//     368x1232: 5.4 MB, 1.6 us, for 2.4 GFLOP padded, 2.4 us at the
//     tensor cores' peak), its time is the launch and the tail of its 414
//     tiles, and the padding keeps the one product body and B image
//     layout that the 32-channel route runs.
//   - 64 -> 64: the 221 KB of weights do not fit beside a stage ring in
//     227 KB, so each block takes one 32-channel half of the outputs with
//     its 110.6 KB of weights resident (blocks 2k and 2k + 1 take the two
//     halves of the same tiles, so the second reads the input from L2),
//     and stages the input in 16-channel slabs (36.9 KB a stage, three
//     stages: 222 KB in all). A tile's four slabs pass through the ring
//     in turn, the two product warpgroups' tiles interleaved slab by slab
//     so that each has its next slab in flight while it multiplies; the
//     accumulators carry over the slabs, and each slab's stage is freed
//     once its products have run (wgmma_wait<0> a slab).
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
// * bf16, Ci == 1, Co == 4, 8, 16, 32 or 64 (the stages' entries: 1->32
//   at stage 1, 1->8 at stages 2-3; AnyNet's 1->16 and 1->4, a 64-channel
//   filter's 1->64; layer 0's BN + ReLU fused): `c1` below, the 3D
//   counterpart of dense3x3's narrow entry (`dense3x3_entry.cuh`).
//   - Persistent blocks of one warpgroup, five an SM (at most 102
//     registers a thread), each walking tiles of TD = 3 depths x TH = 4
//     rows x 64 pixels of one batch image (D = 9 and 24 split with no
//     tail; at D = 5 the sixth depth is neither multiplied nor stored);
//     tile indices split by multiply and shift (`Div`).
//   - Set-up, while the first tile's values fly: the shift, (a0, b0), and
//     the B images (below), which each block gathers from the weights as
//     the caller holds them, so the wrapper prepares nothing.
//   - Staging: a tile reads (TD+2)(TH+2) = 30 rows of 66 pixels of the
//     single plane, each thread one pixel of 15 rows (and 60 threads one
//     halo pixel), in coalesced 2-byte loads, all issued before any is
//     used: the next tile's while this tile multiplies (a register
//     prefetch). Each value goes to the one staging buffer as act inside
//     the volume and as 0 outside it. The rows' pitch, 74 pixels (82 at
//     Co = 4, whose A rows pair pixels), spreads the A reads below over
//     the banks without a conflict (72 would cost about 2 wavefronts a
//     read: tests/test_torch_costfilter_entry.py).
//   - Products: G output rows of one depth in one product group, the rows
//     on N: N = G x Co, column (r, co). K is the group's 9 (G + 2) staged
//     values a pixel, k = (kd (G + 2) + sh) 3 + kw, zero-padded to KC
//     slices of 16, and B[k, (r, co)] = wt[co, kd, sh - r, kw] where 0 <=
//     sh - r <= 2 (else 0): KC wgmma m64nNk16 a group. G is what keeps N
//     a wgmma width the registers hold and K short:
//       Co =  4: G = 4, N = 16, K = 54 in 4 slices, 3 groups a tile;
//       Co =  8: G = 4, N = 32, K = 54 in 4 slices, 3 groups;
//       Co = 16: G = 4, N = 64, K = 54 in 4 slices, 3 groups (G = 2, N =
//                32, would take 18 products and 72 A words a tile for 12
//                and 48);
//       Co = 32: G = 2, N = 64, K = 36 in 3 slices, 6 groups;
//       Co = 64: G = 1, N = 64, K = 27 in 2 slices (k = 27 .. 31 zero),
//                12 groups (G = 2, N = 128, needs 64 accumulator
//                registers a thread, over the 102 of five blocks an SM).
//     Per-row products (K = 27 taps, N = Co: four times the wgmma at Co =
//     8 and twice the A reads) ran slower on the H100. Each thread holds
//     the register A of its pixels (16w + l/4, + 8; at Co = 4 16w + 2(l/4),
//     + 1) read straight from the staged rows at offsets computed once a
//     launch; columns beyond K read nothing (a test on l % 4 in the slice
//     that K cuts). The accumulators start at the shift (at Co = 64 read
//     from shared memory, the registers going to the accumulator). The
//     bf16 products are exact in float32; only the order of the float32
//     sums differs from the plain version. Registers (ptxas on the H100):
//     96 a thread at Co = 16, 32 and 64, 90 at 4 and 8, no spills.
//   - Epilogue: relu and one bf16 rounding in one cvt a pair. Co = 16, 32
//     and 64: `tc::store_row`'s quad transpose over each four 8-column
//     blocks and 16-byte channels-last stores (a quad writes a pixel's 32
//     channels, half of its 64, or two rows' 16). Co = 8 channels-last:
//     stmatrix into a shared buffer laid out as the group's box of y (4
//     rows x 64 pixels x 16 bytes), then one TMA copy of 1 KB runs
//     (16-byte runs made TMA slow on the H100); two buffers in turn. Co =
//     4, NCDHW only (the layout of AnyNet's 4 -> 4 layers): each lane holds
//     a pixel pair of two rows x two channels, one 4-byte store a pair (two
//     2-byte stores where W is odd), as `c4` does; no TMA, whose strides
//     must be multiples of 16 bytes (a stage-2 row is 616). Co = 8 NCDHW
//     (not on the forward): 2-byte lane stores.
// * bf16, Ci == Co == 4 (AnyNet's stage-2/3 layers, D = 5): `c4` below,
//   NCDHW in and out (the layout of the 1->4 entry, `c1`, and of the
//   fused 4->1 last layer, `s4` in conv3d_skip_softargmin.cu, which
//   shares this route's tile, staging and A: `stage4.cuh`). On the CUDA
//   cores one thread a
//   pixel made 108 scalar 2-byte loads, each input value loaded 27 times,
//   and 432 float32 FMAs a voxel: 47 us a launch at stage 3, 17x its
//   bytes bound (PERF.md §6 splits it).
//   - Persistent blocks of 256 threads, two an SM, walk tiles of TD = 5
//     depths x TH = 4 rows x 64 pixels; ragged D, H and W are masked.
//   - Staging: the tile's (TD + 2)(TH + 2) = 42 rows of 68 voxels (w0 - 2
//     .. w0 + 65), read from the four channel planes by coalesced 4-byte
//     loads of pixel pairs where W is even (2-byte loads where it is
//     odd), the next tile's issued before this tile's products (a
//     register prefetch, as `c1`), written channels-last as 8-byte voxels
//     by 16-byte stores, zeros outside the volume. No TMA: a map's
//     strides must be multiples of 16 bytes, and a stage-2 row is 616.
//   - Products, no im2col: in a channels-last row the 16 elements from
//     pixel p on are the 4 channels of pixels p .. p + 3, i.e. taps kw =
//     0, 1, 2 of output pixel p and a fourth whose weights are zero: one
//     K = 16 slice covers a staged row. Warp (pb, rg) takes 16 pixels of
//     output rows 2 rg and 2 rg + 1 at every depth, the two rows x 4
//     channels as N = 8 (B banded over the warp's 4 staged rows: per
//     (kd, staged row) a resident slice of the kh each output row needs,
//     12 in registers, `costfilter.c4_images`). Per staged (depth, row)
//     one A fragment by 4-byte shared loads (lane (g, t) reads word 4g +
//     t of its pixels' run: conflict-free, where an 8-byte voxel at an odd
//     pixel does not start an ldmatrix row) and one mma.sync m16n8k16 per
//     output depth that reads it: 60 a warp a tile. (N as 4 channels and
//     4 zero columns, one output row a product, took 90 products and an
//     epilogue through shared memory: 12.5 us at stage 3.)
//   - Epilogue: A's rows are the pixels in pairs, so lane (g, t) ends
//     with pixels 2g, 2g + 1 of one output row in two channels: the
//     accumulators start at the shift, relu and one bf16 rounding in one
//     cvt a pair, one 4-byte store a channel (two 2-byte where W is odd).
// * otherwise (float32 at every width; bf16 at every width but those
//   above, e.g. 3 channels): the CUDA cores, any Ci, Co >= 1, NCDHW in.
//   A block takes an 8 x 32 pixel tile of one (b, d) slice, one pixel per
//   thread, with CO_T output channels in float32 registers: 32, 16, 8 or
//   4, the widest that divides Co (4 where none does, the last tile's
//   extra channels zero-weighted and not stored). Weights go through shared memory in chunks of CI_CHUNK input
//   channels (27 * 8 * 32 floats = 27 KB); input taps are read straight
//   from global memory, each voxel's 27 uses within a block hitting L1,
//   the entry's act applied at the load (out-of-volume taps are skipped,
//   so the padding stays zero). NCDHW out, or channels-last where asked:
//   whole 16-byte vectors where the tile's channels fill them, else one
//   element a store. At 4-16 channels its bytes and its products bound it
//   about equally (PERF.md §6 has each launch's bound beside its time); a
//   simple tile, not tuned.
#include <algorithm>
#include <type_traits>

#include "stage4.cuh"
#include "tc.cuh"

namespace {

constexpr int CI_CHUNK = 8;

// Layer 0's BN + ReLU of one input value, rounded once to the compute
// dtype: relu(v * a + b) with the product and the sum rounded apart, as the
// plain version's float32 `vol * a0 + b0` (no fused multiply-add).
template <typename T>
__device__ __forceinline__ float act(float v, float a, float b) {
  return to_f(from_f<T>(fmaxf(__fadd_rn(__fmul_rn(v, a), b), 0.f)));
}

// AFF: act is layer 0's BN + ReLU from aff (Ci = 1), else the identity (a
// template argument: a run-time test in the tap loop cost the 32-channel
// tiles spills).
template <typename T, int CO_T, bool AFF>
__global__ void __launch_bounds__(THREADS)
conv3d_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                      const float* __restrict__ shift,
                      const float* __restrict__ aff, T* __restrict__ y,
                      int Ci, int Co, int D, int H, int W, int y_cl) {
  __shared__ float ws[CI_CHUNK * 27 * CO_T];
  const int tx = threadIdx.x % TILE_W, ty = threadIdx.x / TILE_W;
  const int w = blockIdx.x * TILE_W + tx;
  const int h = blockIdx.y * TILE_H + ty;
  const int n_co = ceil_div(Co, CO_T);
  int z = blockIdx.z;
  const int co0 = (z % n_co) * CO_T;
  // output channels of this tile: CO_T, fewer in the last tile where CO_T
  // does not divide Co (its other weights staged as zeros, never stored)
  const int nco = min(CO_T, Co - co0);
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
  const float a0 = AFF ? aff[0] : 1.f, b0 = AFF ? aff[1] : 0.f;

  for (int ci0 = 0; ci0 < Ci; ci0 += CI_CHUNK) {
    const int nci = min(CI_CHUNK, Ci - ci0);
    __syncthreads();
    for (int i = threadIdx.x; i < nci * 27 * CO_T; i += THREADS) {
      const int c = i % CO_T, row = i / CO_T;  // row = ci_local * 27 + tap
      ws[i] = c < nco ? to_f(wt[(size_t)(ci0 * 27 + row) * Co + co0 + c])
                      : 0.f;
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
            float v = to_f(xc[dd * plane + (size_t)hh * W + ww]);
            if (AFF) v = act<T>(v, a0, b0);
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
      if (c < nco)
        yb[c * vol] = from_f<T>(fmaxf(acc[c] + shift[co0 + c], 0.f));
    return;
  }
  // Channels-last: 16-byte vectors of the thread's CO_T channels where
  // they fill whole vectors at 16-byte offsets, else one element a store.
  T* yb = y + ((size_t)b * vol + voxel) * Co + co0;
  constexpr int VEC = 16 / sizeof(T);
  if constexpr (CO_T % VEC == 0) {
    if (nco == CO_T && Co % VEC == 0) {
#pragma unroll
      for (int c0 = 0; c0 < CO_T; c0 += VEC) {
        __align__(16) T v[VEC];
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          v[c] = from_f<T>(fmaxf(acc[c0 + c] + shift[co0 + c0 + c], 0.f));
        *reinterpret_cast<uint4*>(yb + c0) =
            *reinterpret_cast<const uint4*>(v);
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < CO_T; ++c)
    if (c < nco) yb[c] = from_f<T>(fmaxf(acc[c] + shift[co0 + c], 0.f));
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
// ops/cuda/costfilter.py): 32 -> 32 (or 16 -> 32), 16 -> 16 and 64 -> 64,
// 8 -> 8, 4 -> 4 and the entries 1 -> 4, 8, 16, 32 and 64.
bool use_tc(int elem_bytes, int Ci, int Co) {
  return elem_bytes == 2 &&
         ((Co == tc::N && (Ci == 16 || Ci == 32)) ||
          (Ci == Co && (Ci == 16 || Ci == 64)) ||
          (Ci == Co && (Ci == 8 || Ci == 4)) ||
          (Ci == 1 && (Co == 4 || Co == 8 || Co == 16 || Co == tc::N ||
                       Co == 64)));
}

template <int SC>
__host__ __device__ constexpr int stage_bytes() {
  return SROWS * LP * SC * 2;
}
// A block's weights: NS slabs of SC input channels x 27 taps x one
// 32-channel output half (tc::N), as 1 KB B images; 2 x MAX_STAGES + 1
// mbarriers (256 B); the stage ring starts at the next 1024-byte boundary.
template <int SC, int NS>
__host__ __device__ constexpr int weight_bytes() {
  return NS * 27 * SC * tc::N * 2;
}
template <int SC, int NS>
__host__ __device__ constexpr int fixed_bytes() {
  return weight_bytes<SC, NS>() + 256;
}
template <int SC, int NS>
__host__ __device__ constexpr int tc_stages() {
  return (SMEM_MAX - fixed_bytes<SC, NS>() - 1024) / stage_bytes<SC>() <
                 MAX_STAGES
             ? (SMEM_MAX - fixed_bytes<SC, NS>() - 1024) / stage_bytes<SC>()
             : MAX_STAGES;
}
static_assert(tc_stages<32, 1>() >= 2, "two stages must fit");
static_assert(tc_stages<16, 4>() >= 3, "three stages must fit");

// Ci = NS x SC input channels, staged one slab of SC at a time; Co = 16,
// 32 or 64 outputs, a block taking one 32-channel half of them (Co = 64:
// blocks 2k and 2k + 1 take the halves of the same tiles; Co = 16: the
// products' upper 16 columns multiply zero weights and are not stored);
// map_x: the TMA map of x (boxes of SC channels); wt: per output half the
// (NS x SC / 16, 27) B images (the wrapper lays them out).
template <int SC, int NS>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv3d_bn_relu_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                         const bf16* __restrict__ wt,
                         const float* __restrict__ shift,
                         bf16* __restrict__ y, int B, int D, int H, int W,
                         int Co) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KC = SC / 16, PX = SC * 2, ROW = LP * PX;
  constexpr int S = tc_stages<SC, NS>(), SB = stage_bytes<SC>();
  constexpr int WB = weight_bytes<SC, NS>();
  const uint32_t wbase = tc::smem_addr(smem);
  const uint32_t bars = wbase + WB;
  const uint32_t stage0 = (wbase + fixed_bytes<SC, NS>() + 1023) & ~1023u;
  // Per stage: copies landed, read by the products; then the weights'.
  auto landed = [&](int n) { return bars + 8 * (n % S); };
  auto empty = [&](int n) { return bars + 8 * (MAX_STAGES + n % S); };
  const uint32_t weights = bars + 8 * 2 * MAX_STAGES;
  const int wg = threadIdx.x / 128;
  const int halves = Co > tc::N ? Co / tc::N : 1;
  const int half = blockIdx.x % halves, bx = blockIdx.x / halves;
  const int nbx = gridDim.x / halves, co0 = half * tc::N;
  const int nd = ceil_div(D, TD), nh = ceil_div(H, TH), ncx = ceil_div(W, TW);
  const int ntiles = B * nd * nh * ncx;
  const int my_tiles = bx < ntiles ? (ntiles - 1 - bx) / nbx + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      tc::mbar_init(landed(s), 1);
      tc::mbar_init(empty(s), 128);
    }
    tc::mbar_init(weights, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // resident weights: one bulk copy
    tc::mbar_expect_tx(weights, WB);
    tc::bulk_load(wbase, wt + (size_t)half * (WB / 2), WB, weights);
  }

  struct Tile {
    int b, d0, h0, w0;
  };
  auto tile_of = [&](int n) {
    int t = bx + n * nbx;
    Tile r;
    r.w0 = (t % ncx) * TW;
    t /= ncx;
    r.h0 = (t % nh) * TH;
    t /= nh;
    r.d0 = (t % nd) * TD;
    r.b = t / nd;
    return r;
  };
  // The ring's items: the block's tiles in pairs (tiles 2p and 2p + 1, one
  // a product warpgroup), slab by slab, the pair's two tiles in turn:
  // item p * 2 NS + s * (tiles in the pair) + (tile % 2). With one slab,
  // item n is tile n.
  auto item_of = [&](int m, int s) {
    const int p = m / 2, ps = min(2, my_tiles - 2 * p);
    return p * 2 * NS + s * ps + m % 2;
  };

  if (wg == 0) {
    // Staging: one thread issues item n's 16 row copies (one tile's slab)
    // into stage n % S, on the stage's barrier, once the products have
    // read it.
    if (threadIdx.x == 0)
      for (int m = 0; m < my_tiles; m += 2)
        for (int s = 0; s < NS; ++s)
          for (int r = 0; r < 2 && m + r < my_tiles; ++r) {
            const int n = item_of(m + r, s);
            if (n >= S) tc::mbar_wait(empty(n), ((n / S) & 1) ^ 1);
            const Tile t = tile_of(m + r);
            const uint32_t buf = stage0 + (n % S) * SB;
            tc::mbar_expect_tx(landed(n), SB);
            for (int sr = 0; sr < SROWS; ++sr)
              tc::tma_load_5d(buf + sr * ROW, &map_x, landed(n), s * SC,
                              t.w0 - 1, t.h0 - 1 + sr % SH,
                              t.d0 - 1 + sr / SH, t.b);
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
  for (int j = 0; j < 8; ++j) {
    const int c = co0 + 8 * (j / 2) + 2 * (lane % 4) + j % 2;
    sh[j] = c < Co ? shift[c] : 0.f;
  }
  // the lanes whose 8 channels of a row the block stores
  const bool stores = 8 * (lane % 4) < min(Co, tc::N);
  tc::Acc acc[TD * TH];
  for (int m = wg - 1; m < my_tiles; m += 2) {
#pragma unroll
    for (int o = 0; o < TD * TH; ++o) tc::zero(acc[o]);
    for (int s = 0; s < NS; ++s) {
      const int n = item_of(m, s);
      tc::mbar_wait(landed(n), (n / S) & 1);
      const uint32_t buf = stage0 + (n % S) * SB;
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
          tc::wgmma_m64n32k16(acc[o], af[q % NBUF],
                              desc0 + ((s * KC + kc) * 27 + kd * 9 + kh * 3 +
                                       kw) * (tc::B_SLICE >> 4));
        }
        tc::wgmma_commit();
      }
      tc::wgmma_wait<0>();
      tc::mbar_arrive(empty(n));  // the slab's wgmma have read the stage
    }
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
      for (int half_row = 0; half_row < 2; ++half_row) {
        const int w = t.w0 + warp * 16 + lane / 4 + 8 * half_row;
        const bool ok = rv && w < W;
        bf16* px = y + ((((size_t)t.b * D + (ok ? dz : 0)) * H +
                         (ok ? h : 0)) * W + (ok ? w : 0)) * Co + co0;
        tc::store_row<bf16>(acc[o], half_row, px, ok && stores);
      }
    }
  }
}

template <int SC, int NS>
int launch_tc(const void* x, const void* wt, const void* shift, void* y,
              int B, int D, int H, int W, int Co, cudaStream_t s) {
  auto kernel = conv3d_bn_relu_tc_kernel<SC, NS>;
  constexpr int smem = fixed_bytes<SC, NS>() + 1024 +
                       tc_stages<SC, NS>() * stage_bytes<SC>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int halves = Co > tc::N ? Co / tc::N : 1;
  if (tc::sm_count() < halves) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cuuint64_t dims[5] = {(cuuint64_t)SC * NS, (cuuint64_t)W,
                              (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)B};
  const int rc = tc::make_map(&map, x, 5, dims, SC, LP);
  if (rc != 0) return rc;
  const int tiles = B * ceil_div(D, TD) * ceil_div(H, TH) * ceil_div(W, TW);
  const int grid = std::min(tiles, tc::sm_count() / halves) * halves;
  kernel<<<grid, TC_THREADS, smem, s>>>(
      map, (const bf16*)wt, (const float*)shift, (bf16*)y, B, D, H, W, Co);
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

// ---- the Ci = 1 entry route ------------------------------------------------

namespace c1 {

constexpr int TD = 3, TH = 4, TW = 64;   // output tile
constexpr int SD = TD + 2, SH = TH + 2;  // staged depths and rows
constexpr int SW = TW + 2;               // staged pixels a row
constexpr int P = 74;                    // their pitch, elements
constexpr int P_PAIRS = 82;              // the pitch where A's rows pair
constexpr int THREADS = 128;             // one warpgroup
constexpr int MIN_BLOCKS = 5;            // an SM: at most 102 registers
constexpr bool STREAM = false;           // evict-first output copies
constexpr int OBUFS = 2;                 // output buffers a block

// The products of CO = 4, 8, 16, 32 or 64 output channels: G output rows
// (oh0 .. oh0 + G - 1 of one depth) a product group, as N = G x CO
// columns, (r, co) at n = r CO + co; K = the group's KT = 9 (G + 2)
// staged values a pixel, k = (kd (G + 2) + sh) 3 + kw (staged depth od +
// kd, row oh0 + sh, pixel p + kw), zero-padded to KC slices of 16; B[k,
// (r, co)] = wt[co, kd, sh - r, kw] where 0 <= sh - r <= 2, else 0.
// PAIRS (CO = 4, written NCDHW): A's rows are the pixels in pairs, row
// 16w + g pixel 16w + 2g and row 16w + g + 8 pixel 16w + 2g + 1, so that
// a lane's two accumulator rows are adjacent pixels of y; the staged rows
// are then P_PAIRS apart, where the A reads meet no bank conflict.
template <int CO>
struct Shape {
  static constexpr int G = CO == 64 ? 1 : CO == 32 ? 2 : 4;
  static constexpr int N = G * CO;            // 16, 32 or 64
  static constexpr int KT = 9 * (G + 2);      // 27, 36 or 54
  static constexpr int KC = (KT + 15) / 16;   // 2, 3 or 4
  static constexpr int SLICE = 16 * N * 2;    // bytes of a K = 16 slice
  static constexpr int GROUPS = TD * TH / G;  // 12, 6 or 3 a tile
  static constexpr bool PAIRS = CO == 4;
  static constexpr int PITCH = PAIRS ? P_PAIRS : P;
  static constexpr int PLANE = SH * PITCH;    // one staged depth
  static constexpr int BUF = SD * PLANE;      // the staging buffer
  static_assert(TH % G == 0 && N % 16 == 0, "groups");
};

// A 64 x 16 float32 accumulator, laid out as tc::Acc over 2 column
// blocks.
struct Acc16 {
  float v[8];
};

// A 64 x 64 float32 accumulator, laid out as tc::Acc over 8 column
// blocks.
struct Acc64 {
  float v[32];
};

__device__ __forceinline__ void fence_operand(Acc16& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(a.v[i])::"memory");
}
__device__ __forceinline__ void fence_operand(Acc64& a) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(a.v[i])::"memory");
}

// d += a (64 x 16, registers, across the warpgroup) * b (16 x N, shared).
__device__ __forceinline__ void mma(Acc16& d, const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n"
      "}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]),
        "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}
__device__ __forceinline__ void mma(tc::Acc& d, const uint32_t (&a)[4],
                                    uint64_t b) {
  tc::wgmma_m64n32k16(d, a, b);
}
__device__ __forceinline__ void mma(Acc64& d, const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]),
        "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
        "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11]),
        "+f"(d.v[12]), "+f"(d.v[13]), "+f"(d.v[14]), "+f"(d.v[15]),
        "+f"(d.v[16]), "+f"(d.v[17]), "+f"(d.v[18]), "+f"(d.v[19]),
        "+f"(d.v[20]), "+f"(d.v[21]), "+f"(d.v[22]), "+f"(d.v[23]),
        "+f"(d.v[24]), "+f"(d.v[25]), "+f"(d.v[26]), "+f"(d.v[27]),
        "+f"(d.v[28]), "+f"(d.v[29]), "+f"(d.v[30]), "+f"(d.v[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// relu of two float32 values, rounded once to bf16 and packed (lo in the
// low half): one cvt.rn.relu.bf16x2.f32.
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (m, s from the host:
// s = ceil(log2 d) - 1, m = ceil(2^(32 + s) / d)), where a division by a
// value known only at run time takes some twenty instructions.
struct Div {
  int d;
  uint32_t m, s;
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : (int)(__umulhi((uint32_t)n, m) >> s);
  }
};

inline Div make_div(int d) {
  if (d == 1) return Div{1, 0u, 0u};
  int l = 0;
  while ((1LL << l) < d) ++l;  // ceil(log2 d)
  return Div{d, (uint32_t)(((1ULL << (31 + l)) + d - 1) / d),
             (uint32_t)(l - 1)};
}

// Four 8 x 8 bf16 matrices from registers to shared memory: lane l gives
// the address of row l % 8 of matrix l / 8 and holds, in r[m], elements
// (l / 4, 2 (l % 4) + {0, 1}) of matrix m (the accumulator's layout).
__device__ __forceinline__ void stsm_x4(uint32_t addr,
                                        const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// One TMA box of `map` from shared memory at `src` to the tensor at
// coordinates (innermost first); positions outside the tensor are not
// written. EVICT_FIRST: with an L2 evict-first hint (for a stream no later
// load reads soon). Then the bulk-group bookkeeping of the issuing thread.
template <bool EVICT_FIRST>
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  if (EVICT_FIRST)
    asm volatile(
        "{\n.reg .b64 pol;\n"
        "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group.L2::cache_hint"
        " [%0, {%1, %2, %3, %4}], [%5], pol;\n}\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, "
        "%3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
        : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// At most PENDING committed copies have not read their shared memory yet.
template <int PENDING>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING)
               : "memory");
}

struct Args {
  const uint16_t* x;   // (B, D, H, W)
  const uint16_t* wt;  // (Co, 1, 3, 3, 3)
  const float* shift;  // (Co,)
  const float* aff;    // (a0, b0), or null: act is the identity
  bf16* y;
  int B, D, H, W, y_cl;
  Div ncx, nh, nd;  // tiles a row, a depth's rows, depths (`with_tiles`)
};

__host__ __device__ inline int tiles(const Args& a) {
  return a.B * ceil_div(a.D, TD) * ceil_div(a.H, TH) * ceil_div(a.W, TW);
}

inline Args with_tiles(Args a) {
  a.ncx = make_div(ceil_div(a.W, TW));
  a.nh = make_div(ceil_div(a.H, TH));
  a.nd = make_div(ceil_div(a.D, TD));
  return a;
}

struct Tile {
  int b, d0, h0, w0;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  Tile r;
  int q = a.ncx(t);
  r.w0 = (t - q * a.ncx.d) * TW;
  t = q;
  q = a.nh(t);
  r.h0 = (t - q * a.nh.d) * TH;
  t = q;
  q = a.nd(t);
  r.d0 = (t - q * a.nd.d) * TD;
  r.b = q;
  return r;
}

// Staging: a tile's staged row r (0 .. SD SH - 1) is depth d0 - 1 + r / SH,
// image row h0 - 1 + r % SH, pixels w0 - 1 .. w0 + 64 (staged columns 0 ..
// 65). Threads 0-63 take pixel w0 + c - 1 (c = threadIdx.x % 64 + 1) of
// rows 0 .. RH - 1, threads 64-127 the same pixel of rows RH .. 2 RH - 1
// (a warp-uniform choice, so each half's rows are constants), and threads
// below 2 SD SH one halo pixel more: w0 - 1 (even) or w0 + 64 (odd) of row
// threadIdx.x / 2. A value outside the volume is not loaded: its register
// holds OUT.
constexpr int RH = SD * SH / 2;  // staged rows a half
constexpr int NL = RH + 1;       // values a thread stages
constexpr uint32_t OUT = 1u << 16;
static_assert(2 * RH == SD * SH && TW == 64 && THREADS == 2 * TW, "halves");

__device__ __forceinline__ int halo_col() {
  return threadIdx.x % 2 ? SW - 1 : 0;
}

// Staged row R0 + i (i < RH) at pixel ww of tile tt, or OUT. The address
// walks the rows: one image row on, or at a new depth a plane less SH - 1
// rows on (it is formed outside the volume too, but read only inside).
template <int R0>
__device__ __forceinline__ void load_rows(const Args& a, const Tile& tt,
                                          int ww, uint32_t (&v)[NL]) {
  const bool w_in = ww < a.W;
  const long long hw = (long long)a.H * a.W;
  const uint16_t* p =
      a.x + ((long long)tt.b * a.D + tt.d0 - 1 + R0 / SH) * hw +
      (long long)(tt.h0 - 1 + R0 % SH) * a.W + ww;
  const long long depth_step = hw - (long long)(SH - 1) * a.W;
#pragma unroll
  for (int i = 0; i < RH; ++i) {
    const int r = R0 + i;
    if (i > 0) p += r % SH == 0 ? depth_step : (long long)a.W;
    const bool in = w_in && (unsigned)(tt.d0 - 1 + r / SH) < (unsigned)a.D &&
                    (unsigned)(tt.h0 - 1 + r % SH) < (unsigned)a.H;
    v[i] = in ? __ldg(p) : OUT;
  }
}

// This thread's staged values of tile tt, as 16-bit values in 32-bit
// registers; nothing is used here, so the loads are all in flight
// together.
__device__ __forceinline__ void load_tile(const Args& a, const Tile& tt,
                                          uint32_t (&v)[NL]) {
  const int ww = tt.w0 + (int)threadIdx.x % TW;
  if (threadIdx.x < TW)
    load_rows<0>(a, tt, ww, v);
  else
    load_rows<RH>(a, tt, ww, v);
  if (threadIdx.x < 2 * SD * SH) {
    const int r = threadIdx.x / 2, dd = tt.d0 - 1 + r / SH;
    const int hh = tt.h0 - 1 + r % SH, w = tt.w0 - 1 + halo_col();
    v[RH] = (unsigned)dd < (unsigned)a.D && (unsigned)hh < (unsigned)a.H &&
                    (unsigned)w < (unsigned)a.W
                ? __ldg(a.x + (((size_t)tt.b * a.D + dd) * a.H + hh) * a.W +
                        w)
                : OUT;
  }
}

// One staged value: act inside the volume, zero outside it (the conv's
// padding, which comes after the activation).
__device__ __forceinline__ uint16_t staged_value(const Args& a, uint32_t u,
                                                 float a0, float b0) {
  if (u == OUT) return 0;
  if (a.aff == nullptr) return (uint16_t)u;
  return __bfloat16_as_ushort(
      from_f<bf16>(act<bf16>(__uint_as_float(u << 16), a0, b0)));
}

// Tile t's loaded values into staging buffer s, rows PITCH elements apart.
template <int PITCH>
__device__ __forceinline__ void store_tile(const uint32_t (&v)[NL],
                                           const Args& a, uint16_t* s,
                                           float a0, float b0) {
  const int r0 = threadIdx.x < TW ? 0 : RH, c = threadIdx.x % TW + 1;
#pragma unroll
  for (int i = 0; i < RH; ++i)
    s[(r0 + i) * PITCH + c] = staged_value(a, v[i], a0, b0);
  if (threadIdx.x < 2 * SD * SH)
    s[threadIdx.x / 2 * PITCH + halo_col()] =
        staged_value(a, v[RH], a0, b0);
}

// CO = 4, 8, 16, 32 or 64 output channels; y channels-last at 16, 32 and
// 64, NCDHW at 4, either at 8 (NCDHW where y_cl is 0). Shared memory: the
// KC slices of the B images, the staging buffer, at CO = 64 the shift, and
// at CO = 8 the output buffers.
template <int CO>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    conv3d_bn_relu_entry_kernel(Args a,
                                const __grid_constant__ CUtensorMap map_y) {
  using S = Shape<CO>;
  using Acc = std::conditional_t<
      S::N == 16, Acc16, std::conditional_t<S::N == tc::N, tc::Acc, Acc64>>;
  constexpr int G = S::G, KC = S::KC, PITCH = S::PITCH, PLANE = S::PLANE;
  __shared__ __align__(128) unsigned char wsm[KC * S::SLICE];
  __shared__ __align__(16) uint16_t stage[S::BUF];
  // At CO = 8 written channels-last, a group's output goes to y by TMA
  // from one of OBUFS shared buffers in turn.
  constexpr int OGROUP = G * TW * CO * 2;
  __shared__ __align__(128) unsigned char osm[CO == 8 ? OBUFS * OGROUP : 16];
  int obuf = 0;

  // The first tile's staged values in flight during the set-up.
  const int ntiles = tiles(a);
  uint32_t v[NL];
  int t = blockIdx.x;
  Tile tt = tile_of(a, t);
  if (t < ntiles) load_tile(a, tt, v);
  const float a0 = a.aff != nullptr ? a.aff[0] : 1.f;
  const float b0 = a.aff != nullptr ? a.aff[1] : 0.f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane % 4, p0 = warp * 16 + lane / 4;
  // This lane's output channels (8j + 2q) % CO + {0, 1}, j < CP: registers
  // at CO <= 32; at 64 (16 of them, where the registers are spent on the
  // accumulator) in shared memory, read by `init`.
  constexpr int CP = CO >= 8 ? CO / 8 : 1;
  constexpr bool SH_SMEM = CO == 64;
  __shared__ float shs[SH_SMEM ? CO : 1];
  float sh[SH_SMEM ? 1 : 2 * CP];
  if constexpr (SH_SMEM) {
    if (threadIdx.x < CO) shs[threadIdx.x] = a.shift[threadIdx.x];
  } else {
#pragma unroll
    for (int j = 0; j < CP; ++j) {
      sh[2 * j] = a.shift[(8 * j + 2 * q) % CO];
      sh[2 * j + 1] = a.shift[(8 * j + 2 * q) % CO + 1];
    }
  }

  // The B images (tc.cuh): element (k, n) of slice k / 16 at (n / 8) 256
  // + (k % 16 / 8) 128 + (n % 8) 16 + (k % 8) 2 bytes. Thread t writes
  // column n = t % N of the 16-byte rows of 8 k from k0 = 8 kr, kr = t /
  // N, + THREADS / N, ...: kr runs over constants (a warp-uniform test
  // picks each thread's), so each k's (kd, sh, kw) is known to the
  // compiler, and tap (kd, sh - r, kw) is wt's element co * 27 + kd * 9 +
  // sh * 3 + kw - 3r, gathered from global memory, all of a row's loads
  // in flight together. (The weights first copied into shared memory
  // behind a block barrier ran slower on the H100.)
  static_assert(THREADS % S::N == 0, "whole columns a pass");
  {
    const int n = threadIdx.x % S::N, r = n / CO, co = n % CO;
#pragma unroll
    for (int kr = 0; kr < 2 * KC; ++kr) {
      if (kr % (THREADS / S::N) != (int)threadIdx.x / S::N) continue;
      uint32_t u[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = 8 * kr + j, sh_k = k / 3 % (G + 2);
        u[j] = k < S::KT && sh_k - r >= 0 && sh_k - r <= 2
                   ? a.wt[co * 27 + k / (3 * (G + 2)) * 9 + sh_k * 3 +
                          k % 3 - 3 * r]
                   : 0u;
      }
      *(uint4*)(wsm + kr / 2 * S::SLICE + n / 8 * 256 + kr % 2 * 128 +
                n % 8 * 16) =
          make_uint4(u[0] | u[1] << 16, u[2] | u[3] << 16,
                     u[4] | u[5] << 16, u[6] | u[7] << 16);
    }
  }
  tc::fence_proxy_async();  // generic stores before wgmma reads them

  // Offsets of this thread's columns k = kc * 16 + j / 2 * 8 + 2q + j % 2
  // in a staged buffer, for group 0 and pixel 0 (columns beyond KT read
  // nothing: zeros).
  int off[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kc * 16 + j / 2 * 8 + 2 * q + j % 2;
      off[kc][j] = k < S::KT ? k / (3 * (G + 2)) * PLANE +
                                   k / 3 % (G + 2) * PITCH + k % 3
                             : 0;
    }
  const uint64_t desc0 = tc::b_desc(tc::smem_addr(wsm));

  // Whether column kc * 16 + j / 2 * 8 + 2q + j % 2 lies within KT: a
  // constant but in a slice that KT cuts, where the test is on q.
  auto live = [&](int kc, int j) {
    const int k0 = kc * 16 + j / 2 * 8 + j % 2;
    return k0 + 6 < S::KT || (k0 < S::KT && 2 * q < S::KT - k0);
  };
  // The register A of group g (depth g / (TH / G), rows from oh0 = g %
  // (TH / G) * G) from the staging buffer: row i % 2 of this lane's pair
  // is pixel p0 + 8 (i % 2), or at PAIRS 16 warp + 2 (lane / 4) + i % 2.
  auto load_a = [&](uint32_t (&af)[KC][4], int g) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // i: pixel half i % 2, k pair i / 2
        const int px = S::PAIRS ? warp * 16 + 2 * (lane / 4) + i % 2
                                : p0 + 8 * (i % 2);
        const uint16_t* sp = stage + g / (TH / G) * PLANE +
                             g % (TH / G) * G * PITCH + px;
        const int j = i / 2 * 2;
        const uint32_t lo = live(kc, j) ? (uint32_t)sp[off[kc][j]] : 0u;
        const uint32_t hi =
            live(kc, j + 1) ? (uint32_t)sp[off[kc][j + 1]] : 0u;
        af[kc][i] = lo | hi << 16;
      }
  };
  // A group's accumulators start at the shift of their columns (column
  // 8 (e / 4) + 2q + e % 2 of v[e] is channel (8 (e / 4) + 2q) % CO + e %
  // 2, that of sh[2 (e / 4 % CP) + e % 2]), so that the epilogue is relu
  // and one bf16 rounding, which commute: relu(bf16(x)) = bf16(relu(x)).
  auto init = [&](Acc& acc) {
#pragma unroll
    for (int e = 0; e < S::N / 2; ++e)
      if constexpr (SH_SMEM)
        acc.v[e] = shs[8 * (e / 4) + 2 * q + e % 2];
      else
        acc.v[e] = sh[2 * (e / 4 % CP) + e % 2];
  };
  // Group g of tile tt to y.
  auto store = [&](Acc& acc, const Tile& tt, int g) {
    fence_operand(acc);
    const int dz = tt.d0 + g / (TH / G), h0 = tt.h0 + g % (TH / G) * G;
    if constexpr (CO >= 16) {
      // Per pixel half, lane q holds word q of each 8-column block j
      // (column 8j + 2q ..); a quad transpose of blocks 4c .. 4c + 3 gives
      // it block 4c + q, columns n = 32c + 8q .., i.e. 8 channels of row
      // n / CO from n % CO: one 16-byte channels-last store
      // (tc::store_row's epilogue, with the relu). A quad writes a pixel's
      // 32 channels at CO = 32, half of its 64 at CO = 64, two rows' 16 at
      // CO = 16.
      const size_t plane = ((size_t)tt.b * a.D + dz) * a.H;
#pragma unroll
      for (int c = 0; c < S::N / 32; ++c)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t wd[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wd[j] = relu_bf16x2(acc.v[16 * c + 4 * j + 2 * half],
                                acc.v[16 * c + 4 * j + 2 * half + 1]);
          tc::quad_transpose(wd);
          const int n = 32 * c + 8 * q, r = n / CO;
          const int w = tt.w0 + p0 + 8 * half;
          if (h0 + r < a.H && w < a.W)
            tc::store16(reinterpret_cast<uint4*>(
                            a.y + ((plane + h0 + r) * a.W + w) * CO +
                            n % CO),
                        make_uint4(wd[0], wd[1], wd[2], wd[3]), STREAM);
        }
    } else if constexpr (CO == 4) {
      // NCDHW: A's rows are pixel pairs, so v[4j + 2 half + e] is pixel
      // 2 (lane / 4) + half of column 8j + 2q + e: row 2j + q / 2, channel
      // 2 (q % 2) + e. Per (j, e) one 4-byte store of the pixel pair (two
      // 2-byte stores where W is odd), 32 contiguous bytes a quad column.
      const size_t vol = (size_t)a.D * a.H * a.W;
      const int w = tt.w0 + warp * 16 + 2 * (lane / 4);
      if (w >= a.W) return;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int h = h0 + 2 * j + q / 2;
        if (h >= a.H) continue;
        bf16* py = a.y + ((size_t)tt.b * 4 + 2 * (q % 2)) * vol +
                   ((size_t)dz * a.H + h) * a.W + w;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t u =
              relu_bf16x2(acc.v[4 * j + e], acc.v[4 * j + 2 + e]);
          uint16_t* p = reinterpret_cast<uint16_t*>(py + e * vol);
          if (a.W % 2 == 0) {
            *reinterpret_cast<uint32_t*>(p) = u;
          } else {
            p[0] = (uint16_t)u;
            if (w + 1 < a.W) p[1] = (uint16_t)(u >> 16);
          }
        }
      }
    } else if (a.y_cl) {
      // The group's G rows x 64 pixels x 8 channels into a shared buffer
      // as y's TMA box lays them out, (r TW + p) 16 bytes: matrix m = 2r
      // + half of warp w (pixels 16w + 8 half .. + 7 of row r,
      // accumulator columns 8r ..) by stmatrix, whose fragment is the
      // accumulator's; four matrices, 2 x 256 contiguous bytes, a
      // stmatrix. Then one thread copies the box to y; rows beyond H and
      // pixels beyond W stay unwritten.
      const uint32_t ob = tc::smem_addr(osm) + obuf * OGROUP;
#pragma unroll
      for (int m0 = 0; m0 < 2 * G; m0 += 4) {
        uint32_t wd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wd[i] = relu_bf16x2(acc.v[2 * (m0 + i)], acc.v[2 * (m0 + i) + 1]);
        const int m = m0 + lane / 8;
        stsm_x4(ob + (m / 2 * TW + warp * 16 + 8 * (m % 2) + lane % 8) * 16,
                wd);
      }
      tc::fence_proxy_async();  // the writes before the copy reads them
      // The copy of the next buffer, issued OBUFS - 1 groups ago, has read
      // it before the barrier: the next group may write it.
      if (threadIdx.x == 0) bulk_wait_read<OBUFS - 2>();
      __syncthreads();
      if (threadIdx.x == 0) {
        tma_store_4d<STREAM>(&map_y, ob, 2 * tt.w0, h0, dz, tt.b);
        bulk_commit();
      }
      obuf = obuf + 1 == OBUFS ? 0 : obuf + 1;
    } else {  // CO = 8, NCDHW: channel planes 2q, 2q + 1
      const size_t vol = (size_t)a.D * a.H * a.W;
#pragma unroll
      for (int r = 0; r < G; ++r) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int w = tt.w0 + p0 + 8 * half;
          if (h0 + r >= a.H || w >= a.W) continue;
          bf16* py = a.y + ((size_t)tt.b * 8 + 2 * q) * vol +
                     ((size_t)dz * a.H + h0 + r) * a.W + w;
          py[0] = from_f<bf16>(fmaxf(acc.v[4 * r + 2 * half], 0.f));
          py[vol] = from_f<bf16>(fmaxf(acc.v[4 * r + 2 * half + 1], 0.f));
        }
      }
    }
  };

  // One staging buffer at a fixed address, so that every A read is one
  // instruction from a per-thread register and a constant: a barrier
  // before the stores of each tile after the first (its A reads done).
  for (bool first = true; t < ntiles; t += gridDim.x, first = false) {
    if (!first) __syncthreads();
    store_tile<PITCH>(v, a, stage, a0, b0);
    const Tile next = tile_of(a, t + gridDim.x);
    if (t + (int)gridDim.x < ntiles) load_tile(a, next, v);
    __syncthreads();  // the tile staged (and, first, the weights)
#pragma unroll
    for (int g = 0; g < S::GROUPS; ++g) {
      // a depth beyond D (D not a multiple of TD: AnyNet's D = 5) is
      // neither multiplied nor stored
      if (tt.d0 + g / (TH / G) >= a.D) continue;
      uint32_t af[KC][4];
      Acc acc;
      load_a(af, g);
      init(acc);
      tc::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma(acc, af[kc], desc0 + kc * (S::SLICE >> 4));
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      store(acc, tt, g);
    }
    tt = next;
  }
  // The last copies have read their buffers before the block's shared
  // memory goes; their writes complete by the end of the launch.
  if (CO == 8 && threadIdx.x == 0) bulk_wait_read<0>();
}

// Launch on `stream`: as many resident blocks as fit (the occupancy,
// queried once), at most one per tile. Returns a cudaError_t.
template <int CO>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = conv3d_bn_relu_entry_kernel<CO>;
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
  }
  if (per_sm < 1 || tc::sm_count() < 1) return (int)cudaErrorInvalidValue;
  const int grid = std::min(tiles(a), per_sm * tc::sm_count());
  if (grid < 1) return (int)cudaSuccess;
  // At CO = 8 channels-last, y as (B, D, H, W x 2) elements of 8 bytes, a
  // pixel's 8 channels two of them, so that a box row is one 1 KB run
  // (`tc::make_voxel_map`'s layout: 16-byte runs made TMA slow on the
  // H100).
  CUtensorMap map_y{};
  if (CO == 8 && a.y_cl) {
    const tc::EncodeTiled encode = tc::encode_tiled();
    if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
    const cuuint64_t dims[4] = {2 * (cuuint64_t)a.W, (cuuint64_t)a.H,
                                (cuuint64_t)a.D, (cuuint64_t)a.B};
    const cuuint64_t strides[3] = {8 * dims[0], 8 * dims[0] * dims[1],
                                   8 * dims[0] * dims[1] * dims[2]};
    const cuuint32_t box[4] = {2 * TW, Shape<CO>::G, 1, 1};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    const int rc = (int)encode(
        &map_y, CU_TENSOR_MAP_DATA_TYPE_UINT64, 4, a.y, dims, strides, box,
        ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != 0) return rc;
  }
  kernel<<<grid, THREADS, 0, stream>>>(with_tiles(a), map_y);
  return (int)cudaGetLastError();
}

}  // namespace c1

// ---- the C = 4 tensor-core route ------------------------------------------

namespace c4 {

// the tile, its staging and mma.sync (stage4.cuh)
using stage4::load_tile;
using stage4::mma;
using stage4::PW;
using stage4::SH;
using stage4::SROWS;
using stage4::Staged;
using stage4::store_tile;
using stage4::TD;
using stage4::TH;
using stage4::THREADS;
using stage4::Tile;
using stage4::TW;

constexpr int MIN_BLOCKS = 2;  // an SM: at most 128 registers

struct Args {
  const uint16_t* x;   // (B, 4, D, H, W)
  const uint32_t* wk;  // the 12 B slices (`c4_images`)
  const float* shift;  // (4,)
  bf16* y;             // (B, 4, D, H, W)
  int B, D, H, W;
};

__host__ __device__ inline int tiles(const Args& a) {
  return a.B * ceil_div(a.D, TD) * ceil_div(a.H, TH) * ceil_div(a.W, TW);
}

__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  const int ncx = ceil_div(a.W, TW), nh = ceil_div(a.H, TH);
  const int nd = ceil_div(a.D, TD);
  Tile r;
  r.w0 = t % ncx * TW;
  t /= ncx;
  r.h0 = t % nh * TH;
  t /= nh;
  r.d0 = t % nd * TD;
  r.b = t / nd;
  return r;
}

// Persistent blocks walk the tiles; each stages a tile's 42 rows of 68
// voxels channels-last while the next tile's pairs fly (a register
// prefetch), then warp (pb, rg) = (warp % 4, warp / 4) multiplies pixels
// 16 pb .. + 15 of output rows 2 rg, 2 rg + 1 at every depth. A's rows are
// the pixels in pairs (row g pixel 2g, row g + 8 pixel 2g + 1), its 16
// columns the elements from each pixel's staged voxel on (taps kw = 0, 1,
// 2 and a fourth of zero weight); B's 8 columns the two output rows x 4
// channels, banded over the staged rows: per staged row sh (0 .. 3 from
// row 2 rg) and kd one resident slice whose column (e, co) holds output
// row 1 - e's tap kh = sh - 1 + e (zero where it falls outside 0 .. 2).
// So per staged (depth, row) one A fragment and one product per output
// depth that reads it. The accumulators start at the shift; lane (g, t)
// ends with pixels 2g, 2g + 1 of output row 1 - t / 2, channels 2 (t % 2)
// and the next: relu, one rounding, a 4-byte store of each channel's
// pair.
template <bool EVEN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    conv3d_bn_relu_c4_kernel(Args a) {
  __shared__ __align__(16) uint32_t stage[SROWS * PW];

  const int ntiles = tiles(a);
  int t = blockIdx.x;
  Tile tt = tile_of(a, t);
  Staged<EVEN> s;
  if (t < ntiles) load_tile<EVEN>(a.x, a.D, a.H, a.W, tt, s);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4, pb = warp % 4, rg = warp / 4;
  uint32_t bw[12][2];  // B of (kd, sh): k = 2q + {0, 1} (+ 8), column g
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    bw[i][0] = __ldg(a.wk + (i * 8 + g) * 8 + q);
    bw[i][1] = __ldg(a.wk + (i * 8 + g) * 8 + q + 4);
  }
  // this lane's outputs: channels co, co + 1 of output row orow
  const int co = 2 * (q % 2), orow = 2 * rg + 1 - q / 2;
  const float s0 = a.shift[co], s1 = a.shift[co + 1];
  // this lane's A words: pixel 16 pb + 2g (+ 1) from its staged pixel on
  const int aoff = 2 * (pb * 16 + 2 * g + 1) + q;
  const size_t vol = (size_t)a.D * a.H * a.W;

  for (; t < ntiles; t += gridDim.x) {
    __syncthreads();  // the last tile's A reads done
    store_tile<EVEN>(s, stage);
    const Tile cur = tt;
    if (t + (int)gridDim.x < ntiles) {
      tt = tile_of(a, t + gridDim.x);
      load_tile<EVEN>(a.x, a.D, a.H, a.W, tt, s);
    }
    __syncthreads();  // the tile staged

    float acc[TD][4];
#pragma unroll
    for (int od = 0; od < TD; ++od) {
      acc[od][0] = acc[od][2] = s0;
      acc[od][1] = acc[od][3] = s1;
    }
#pragma unroll
    for (int sd = 0; sd < TD + 2; ++sd)
#pragma unroll
      for (int sh = 0; sh < 4; ++sh) {
        const uint32_t* ap = stage + (sd * SH + 2 * rg + sh) * PW + aoff;
        const uint32_t af[4] = {ap[0], ap[2], ap[4], ap[6]};
#pragma unroll
        for (int od = 0; od < TD; ++od) {
          const int kd = sd - od;
          if (kd >= 0 && kd <= 2) mma(acc[od], af, bw[kd * 4 + sh]);
        }
      }

    // relu, one rounding, and each channel's pixel pair to y
    const int h = cur.h0 + orow, w = cur.w0 + pb * 16 + 2 * g;
    if (h >= a.H || w >= a.W) continue;
    bf16* yp = a.y + ((size_t)cur.b * 4 + co) * vol +
               ((size_t)cur.d0 * a.H + h) * a.W + w;
#pragma unroll
    for (int od = 0; od < TD; ++od) {
      if (cur.d0 + od >= a.D) break;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t u = c1::relu_bf16x2(acc[od][c], acc[od][c + 2]);
        bf16* p = yp + c * vol + (size_t)od * a.H * a.W;
        if constexpr (EVEN) {
          *reinterpret_cast<uint32_t*>(p) = u;
        } else {
          reinterpret_cast<uint16_t*>(p)[0] = (uint16_t)u;
          if (w + 1 < a.W) reinterpret_cast<uint16_t*>(p)[1] = u >> 16;
        }
      }
    }
  }
}

// Persistent blocks, as many as fit (the occupancy, queried once), at most
// one a tile.
template <bool EVEN>
int launch_w(const Args& a, cudaStream_t s) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv3d_bn_relu_c4_kernel<EVEN>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
  }
  if (per_sm < 1 || tc::sm_count() < 1) return (int)cudaErrorInvalidValue;
  const int grid = std::min(tiles(a), per_sm * tc::sm_count());
  if (grid < 1) return (int)cudaSuccess;
  conv3d_bn_relu_c4_kernel<EVEN><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

int launch(const Args& a, cudaStream_t s) {
  return a.W % 2 == 0 ? launch_w<true>(a, s) : launch_w<false>(a, s);
}

}  // namespace c4

// The CUDA cores at any Ci, Co >= 1: x NCDHW; y NCDHW or channels-last.
// Output-channel tiles of 32, 16, 8 or 4, the widest that divides Co (4,
// the last tile masked, where none does).
template <typename T, int CO_T>
int launch_cores(const T* x, const T* wt, const float* shift,
                 const float* aff, T* y, int B, int Ci, int Co, int D, int H,
                 int W, int y_cl, cudaStream_t s) {
  dim3 grid(ceil_div(W, TILE_W), ceil_div(H, TILE_H),
            B * D * ceil_div(Co, CO_T));
  auto kernel = aff ? conv3d_bn_relu_kernel<T, CO_T, true>
                    : conv3d_bn_relu_kernel<T, CO_T, false>;
  kernel<<<grid, THREADS, 0, s>>>(x, wt, shift, aff, y, Ci, Co, D, H, W,
                                  y_cl);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wt, const void* shift, const void* aff,
           void* y, int B, int Ci, int Co, int D, int H, int W, int x_cl,
           int y_cl, void* stream) {
  if (Co < 1 || Ci < 1) return (int)cudaErrorInvalidValue;
  if (aff != nullptr && Ci != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_tc(sizeof(T), Ci, Co)) {
    // The 4 -> 4 route reads and writes NCDHW only, the 1 -> 4 entry
    // writes it only. The others write channels-last only at 16, 32 and
    // 64 channels, either layout at 8. The entries' one input channel lies
    // the same in both layouts; the other routes read channels-last only.
    // The entries take wt as (Co, 1, 3, 3, 3), the others the B images the
    // wrapper lays out.
    if (Ci == 4) {
      if (x_cl || y_cl) return (int)cudaErrorInvalidValue;
      return c4::launch(c4::Args{(const uint16_t*)x, (const uint32_t*)wt,
                                 (const float*)shift, (bf16*)y, B, D, H, W},
                        s);
    }
    if (Co == 4 ? y_cl : Co != 8 && !y_cl) return (int)cudaErrorInvalidValue;
    if (Ci == 1) {
      const c1::Args a{(const uint16_t*)x, (const uint16_t*)wt,
                       (const float*)shift, (const float*)aff, (bf16*)y,
                       B, D, H, W, y_cl};
      switch (Co) {
        case 4: return c1::launch<4>(a, s);
        case 8: return c1::launch<8>(a, s);
        case 16: return c1::launch<16>(a, s);
        case 32: return c1::launch<32>(a, s);
        default: return c1::launch<64>(a, s);
      }
    }
    if (!x_cl) return (int)cudaErrorInvalidValue;
    if (Co == 8) return c8::launch(x, wt, shift, y, B, D, H, W, y_cl, s);
    if (Ci == 32)
      return launch_tc<32, 1>(x, wt, shift, y, B, D, H, W, Co, s);
    if (Ci == 16)
      return launch_tc<16, 1>(x, wt, shift, y, B, D, H, W, Co, s);
    return launch_tc<16, 4>(x, wt, shift, y, B, D, H, W, Co, s);
  }
  if (x_cl) return (int)cudaErrorInvalidValue;  // the CUDA cores read NCDHW
  const T* xp = (const T*)x;
  const T* wp = (const T*)wt;
  const float* sp = (const float*)shift;
  const float* ap = (const float*)aff;
  if (Co % 32 == 0)
    return launch_cores<T, 32>(xp, wp, sp, ap, (T*)y, B, Ci, Co, D, H, W,
                               y_cl, s);
  if (Co % 16 == 0)
    return launch_cores<T, 16>(xp, wp, sp, ap, (T*)y, B, Ci, Co, D, H, W,
                               y_cl, s);
  if (Co % 8 == 0)
    return launch_cores<T, 8>(xp, wp, sp, ap, (T*)y, B, Ci, Co, D, H, W,
                              y_cl, s);
  return launch_cores<T, 4>(xp, wp, sp, ap, (T*)y, B, Ci, Co, D, H, W, y_cl,
                            s);
}

}  // namespace

// aff: null, or at Ci = 1 two floats (a0, b0), layer 0's BN + ReLU.
#define CONV3D_BN_RELU_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* x, const void* wt, const void* shift,      \
                      const void* aff, void* y, int B, int Ci, int Co,       \
                      int D, int H, int W, int x_cl, int y_cl,               \
                      void* stream) {                                        \
    return launch<T>(x, wt, shift, aff, y, B, Ci, Co, D, H, W, x_cl, y_cl,   \
                     stream);                                                \
  }

CONV3D_BN_RELU_ENTRY(conv3d_bn_relu_f32, float)
CONV3D_BN_RELU_ENTRY(conv3d_bn_relu_bf16, bf16)
