// conv3d_skip_softargmin: the last layer of a cost filter (3x3x3 conv3d
// Ci -> 1), the identity skip, and the soft-argmin regression, fused.
//
// Replaces lwsnet_tpu/ops/pallas/costfilter.py:_folded_last_kernel (stages
// 2-3), and for stage 1 the last _dgrid_kernel launch together with the XLA
// skip and soft-argmin that follow it (costfilter.py:251-257):
//   cost[b,d,h,w] = sum_{ci,kd,kh,kw} x[b,ci,d+kd-1,h+kh-1,w+kw-1]
//                   * wt[ci,kd*9+kh*3+kw] + vol[b,d,h,w]
//   out[b,h,w]    = sum_d softmax_d(-cost[b,:,h,w]) * (start + d)
// The skip reads the raw volume in the compute dtype it was built in,
// widened to float32; the softmax subtracts the minimum cost first, then
// sums exp and exp * bin over d in order, in float32.
//
// Bound on the H100: the bytes. At 368x1232 the three launches read about
// 35 MB (the activation once, the volume once): 3.4 / 1.4 / 5.6 us at
// 3.35 TB/s for stages 1 / 2 / 3. Their products, 27 * Ci multiply-adds
// an output (147 M at stage 1, 220 M at stage 3), would take about 12.6 us
// on the CUDA cores' float32 peak alone, so the bf16 route runs them on
// the tensor cores, where they cost next to nothing. A 64-channel
// filter's last layer over D = 72 at 46x154 reads 66.3 MB: 19.8 us.
//
// Three routes, picked by dtype and width (`costfilter.filter_routes`):
// * bf16, Ci == 64, 32 (stage 1; 16 in AnyNet's stage 1) or 8 (stages
//   2-3), any D, channels-last (B, D, H, W, C) in, as the stage's
//   tensor-core layers write it: tensor cores (`tcr` below, helpers in
//   `tc.cuh`).
//   - Tile: TH output rows x 62 pixels, every d (TH = 1 at Ci = 16, 32 and
//     64, 2 at Ci = 8). A block is one product warpgroup and one staging
//     warp; the staging thread walks the planes d' = 0 .. D-1 of the input,
//     copying each plane's TH + 2 rows (h0 - 1 .. h0 + TH) of 64 (Ci >= 16)
//     or 72 (Ci = 8) pixels from w0 - 1 into a ring of stages (6 at Ci = 32
//     and 16, 3 at Ci = 64 and 8), zeros outside the volume: the conv's
//     padding, since the input is already post-ReLU. One TMA box a plane,
//     and at Ci = 64 one a 32-channel slab (two a plane), as
//     conv3d_bn_relu's 64-channel route stages its input in slabs.
//   - Split by kd, not im2col, and the taps in N: per plane one product
//     per staged row and 16-channel slice (KP = Ci / 16 products a row; one
//     at Ci = 8): A = the staged row's 64 pixels from pixel 0, read by wgmma
//     from shared memory through a descriptor (32 channels of a slab under
//     the 64-byte swizzle at Ci = 32 and 64, 16 under the 32-byte swizzle at
//     Ci = 16; at Ci = 8 a row's k >= 8 are the next pixel's channels);
//     B = a 16 x N slice whose columns are (output row o, kw, kd) at Ci >= 16
//     and (o, tap pair t, kd) at Ci = 8 (t = 0: taps kw = 0, 1 of pixels
//     q, q + 1; t = 1: kw = 2 of pixel q + 2), zero where kh = sh - o falls
//     outside 0..2. wgmma m64n16k16 (N = 9 or 12 columns used). The output
//     pixel q then sums columns of rows q + kw: its kd terms, and plane d'
//     gives cost[d'+1] += kd 0, cost[d'] += kd 1, cost[d'-1] += kd 2. Each
//     plane is read once a tile, each staged byte once a product (where kw
//     offsets of A read it three times), and the 62 output pixels of a
//     64-row product are what the taps leave.
//   - B as multiplied (1.5 to 6 KB) is built in the block from the wrapper's
//     per-(kh, piece) 16 x 8 images (1.5 to 9.2 KB, one bulk copy into
//     the cost columns, which hold nothing before the first plane's sums),
//     written through the generic proxy and fenced before wgmma reads
//     them.
//   - Two planes in flight: plane p's products run while plane p - 1's
//     sums are formed, through two accumulator sets and two product
//     buffers (one barrier of the warpgroup a plane).
//   - Skip and softmax in the block, in chunks of up to 64 costs: a thread
//     owns one output pixel and row (q, o): it keeps cost[d'-1] and
//     cost[d'] in registers and writes each cost once complete (after plane
//     d + 1) to its private column of 64 float32 costs in shared memory;
//     the volume of the chunk (row, d, pixel) bf16 is loaded into shared
//     memory, all of a warp's loads issued before any is stored: the first
//     chunk's at the start, while the B images and the first plane land,
//     each later one once every owner has folded the chunk before it. When
//     a chunk's last cost is written the owner runs its two passes, min and
//     then the sums in order of d, and folds them into a running (least
//     cost, sum of exp, sum of exp * bin), both sums rescaled to the lesser
//     least cost, as the CUDA-core route does; at D <= 64 (one chunk) that
//     is the single two-pass soft-argmin in the order it always summed. It
//     writes float32 (B, H, W), ragged H and W masked.
//   - Filling the card: stage 1 has 46 x 3 = 138 tiles for 132 SMs. A
//     block takes 90 KB at Ci = 32 (D = 24) and 107 KB at Ci = 64 (three
//     stages of two slabs, D >= 64), so two fit an SM and all 138 are
//     resident at once: the six extra tiles run beside others, not as a
//     second wave. Stage 3 has 920 tiles of 29.9 KB and 56 registers a
//     thread (launch bounds), so that seven fit an SM (with all of its
//     shared memory as carveout): one wave. Stage 2: 230 tiles.
//   - What holds it (H100, `conv3d_c8_variants.py --skip`): a lone block
//     spends about 3K clocks before its first plane (B, the volume, the
//     first copy) and about 430 clocks a plane at Ci = 32, most of them in
//     the product threads' own sums (a barrier and shared-memory round
//     trips), not in the tensor cores or the copies; at stage 3 the first
//     planes of 920 blocks land 3.5 us after the start; at stage 1 six SMs
//     run two tiles. At Ci = 64 (D = 72, 46x154) a plane stages 24 KB a
//     tile, three times its share of the input (TH + 2 = 3 rows for one
//     output row), from L2; the first planes land about 13K clocks in (all
//     138 blocks' first stages and volumes at once), then about 860
//     clocks a plane with the staging thread mostly waiting for a free
//     stage, so the products and sums set the pace (two blocks an SM with
//     three stages ran 1.5x faster than one with five). Earlier designs
//     that ran slower: register A (ldmatrix) with N = 8 (the taps as K
//     slices, three times the A bytes), a volume read by 2-byte loads that
//     each waited, two product warpgroups splitting the planes, persistent
//     blocks, B's images read from global memory by the product threads or
//     the staging warp (5-9 % slower at the shipped shapes than one bulk
//     copy); at Ci = 16 / 64 and past D = 64 the CUDA cores below, which
//     lose 16.3x to cuDNN at Ci = 64, D = 72 (4.67 ms).
// * bf16, Ci == 4 (AnyNet's stages 2-3, D = 5), any D, NCDHW in, as the
//   stage's 4 -> 4 layers (conv3d_bn_relu's `c4`) write it: tensor cores
//   by mma.sync (`s4` below). On the CUDA cores (the route after it) a block
//   took 32 pixels of one row, three of its eight warps idle at D = 5,
//   and each input value was loaded 27 times: 39 us a stage-3 launch, 5 %
//   of its bytes bound (PERF.md §6).
//   - Persistent blocks of 256 threads, two an SM, walk columns of tiles
//     (b, 4 rows, 64 pixels), each over its depth tiles of TD = 5 (one at
//     D = 5); ragged D, H and W are masked.
//   - Staging as `c4`'s (`stage4.cuh`): the tile's 7 x 6 = 42 rows of 68
//     voxels (w0 - 2 .. w0 + 65), read from the four channel planes by
//     coalesced 4-byte loads of pixel pairs where W is even (2-byte loads
//     where it is odd), the next tile's issued before this tile's products
//     (a register prefetch, the volume at each lane's output pixel for the
//     tile's depths with them), written channels-last as 8-byte voxels by
//     16-byte stores, zeros outside the volume. No TMA: a map's strides
//     must be multiples of 16 bytes, and a stage-2 row is 616.
//   - Products, no im2col: A as `c4`'s (a staged row's 16 elements from
//     pixel p on are taps kw = 0, 1, 2 of output pixel p and a fourth of
//     zero weight; its rows the pixels in pairs). The one output channel
//     frees B's 8 columns for (output row r, kd): warp (pb, rg) takes 16
//     pixels of output rows 2 rg and 2 rg + 1, and per staged (depth,
//     row) one A fragment and one mma.sync m16n8k16 against the staged
//     row's resident slice (4 slices, 8 registers,
//     `costfilter.skip_c4_images`): 28 products a warp a tile, each
//     staged depth's four summed, column (r, kd) going to output depth sd
//     - kd after one exchange of lane pairs (two shuffles).
//   - Epilogue: each lane ends with one (row, pixel)'s TD costs; the skip,
//     the two-pass soft-argmin of the tile's depths folded into a running
//     one past the first depth tile, as above; float32 out.
// * otherwise (float32 at every width; bf16 at every other width, e.g. a
//   ragged 3): the CUDA cores, any Ci and D, NCDHW in. A block takes 32
//   pixels of one image row and walks D in chunks of 64. Its 8 warps
//   split a chunk's disparities between them:
//   each thread forms one pixel's cost at its disparities (reads coalesced
//   along W) into shared memory, the weights staged 32 input channels at a
//   time; then one warp runs the chunk's soft-argmin, the least cost and
//   then the sums in order of d as above, and folds it into its running one
//   (both sums rescaled to the lesser least cost), so D is unbounded. At
//   D <= 64 and Ci <= 32 (one chunk of each) it sums in the order of the
//   single-pass kernel it replaces. Bound: the bytes, as above; not tuned.
#include <algorithm>

#include "stage4.cuh"
#include "tc.cuh"

namespace {

constexpr int CI_CHUNK = 32;  // input channels whose weights a block stages
constexpr int D_CHUNK = 64;   // costs a pixel a block holds at once
constexpr int D_LANES = THREADS / TILE_W;
constexpr int D_PER = D_CHUNK / D_LANES;  // costs a thread forms a chunk

// x NCDHW; wt (Ci, 27); vol (B, D, H, W); all in T. out (B, H, W) float32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
skip_softargmin_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                       const T* __restrict__ vol, float* __restrict__ out,
                       int Ci, int D, int H, int W, float start) {
  __shared__ float ws[CI_CHUNK * 27];
  __shared__ float cost[D_CHUNK][TILE_W];
  const int tx = threadIdx.x % TILE_W, ty = threadIdx.x / TILE_W;
  const int w = blockIdx.x * TILE_W + tx;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const size_t plane = (size_t)H * W;
  const size_t volume = (size_t)D * plane;
  const T* xb = x + (size_t)b * Ci * volume;
  // warp 0's running soft-argmin of its pixel over the chunks so far: the
  // least cost, and the sums of exp(least - cost) and of that times the bin
  float run_m = 0.f, run_den = 0.f, run_num = 0.f;
  for (int d0 = 0; d0 < D; d0 += D_CHUNK) {
    const int dn = min(D_CHUNK, D - d0);
    float acc[D_PER];
#pragma unroll
    for (int k = 0; k < D_PER; ++k) acc[k] = 0.f;
    for (int ci0 = 0; ci0 < Ci; ci0 += CI_CHUNK) {
      const int nci = min(CI_CHUNK, Ci - ci0);
      __syncthreads();  // the last chunk's weights and costs read
      for (int i = threadIdx.x; i < nci * 27; i += THREADS)
        ws[i] = to_f(wt[(size_t)ci0 * 27 + i]);
      __syncthreads();
      if (w >= W) continue;
#pragma unroll
      for (int k = 0; k < D_PER; ++k) {
        const int d = d0 + ty + k * D_LANES;
        if (d >= d0 + dn) break;
        float a = acc[k];
        for (int ci = 0; ci < nci; ++ci) {
          const T* xc = xb + (size_t)(ci0 + ci) * volume;
          const float* wc = ws + ci * 27;
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
                a = fmaf(to_f(xc[dd * plane + (size_t)hh * W + ww]),
                         wc[kd * 9 + kh * 3 + kw], a);
              }
            }
          }
        }
        acc[k] = a;
      }
    }
    if (w < W) {
#pragma unroll
      for (int k = 0; k < D_PER; ++k) {
        const int dl = ty + k * D_LANES;
        if (dl >= dn) break;
        cost[dl][tx] = acc[k] + to_f(vol[(size_t)b * volume +
                                         (d0 + dl) * plane +
                                         (size_t)h * W + w]);
      }
    }
    __syncthreads();
    if (ty != 0 || w >= W) continue;
    float m = cost[0][tx];
    for (int d = 1; d < dn; ++d) m = fminf(m, cost[d][tx]);
    float den = 0.f, num = 0.f;
    for (int d = 0; d < dn; ++d) {
      const float e = expf(m - cost[d][tx]);
      den += e;
      num = fmaf(e, start + (float)(d0 + d), num);
    }
    if (d0 == 0) {
      run_m = m;
      run_den = den;
      run_num = num;
    } else {  // both sums rescaled to the lesser of the two least costs
      const float mm = fminf(run_m, m);
      const float s_run = expf(mm - run_m), s_new = expf(mm - m);
      run_den = run_den * s_run + den * s_new;
      run_num = run_num * s_run + num * s_new;
      run_m = mm;
    }
  }
  if (ty == 0 && w < W) out[(size_t)b * plane + (size_t)h * W + w] =
      run_num / run_den;
}

template <typename T>
int launch_cores(const void* x, const void* wt, const void* vol, void* out,
                 int B, int Ci, int D, int H, int W, float start,
                 cudaStream_t s) {
  dim3 grid(ceil_div(W, TILE_W), H, B);
  skip_softargmin_kernel<T><<<grid, THREADS, 0, s>>>(
      (const T*)x, (const T*)wt, (const T*)vol, (float*)out, Ci, D, H, W,
      start);
  return (int)cudaGetLastError();
}

// ---- the bf16 tensor-core route -------------------------------------------

namespace tcr {

constexpr int TM = 64;            // staged pixels a product row: wgmma's M
constexpr int TW = TM - 2;        // output pixels a tile (taps kw reach 2)
constexpr int VR = 6;             // volume rows a warp loads at once
constexpr int SLICE = 16 * 8 * 2; // one 16 x 8 B image, as laid out
constexpr int BARS = 256;         // bytes of mbarriers
constexpr int THREADS = 128 + 32; // the product warpgroup, the staging warp

// Per input width: output rows a tile, products a staged row (Ci >= 16:
// one a 16-channel slice; Ci = 8: one, k >= 8 the next pixel), bytes a
// staged pixel of a slab, staged pixels a row from w0 - 1 (the products
// read TM, and at Ci = 8 one more; to 8 at Ci = 8, one TMA run a row),
// slabs a plane (one TMA box each: at most 32 channels under the 64-byte
// swizzle), staged planes, accumulators a plane (independent chains of
// products), blocks an SM (registers and shared memory sized for them).
template <int SC>
struct Route;
template <>
struct Route<64> {
  static constexpr int TH = 1, KP = 4, PX = 64, LP = 64, SLABS = 2;
  static constexpr int STAGES = 3, ACC = 4, BLOCKS = 2;
};
template <>
struct Route<32> {
  static constexpr int TH = 1, KP = 2, PX = 64, LP = 64, SLABS = 1;
  static constexpr int STAGES = 6, ACC = 2, BLOCKS = 2;
};
template <>
struct Route<16> {
  static constexpr int TH = 1, KP = 1, PX = 32, LP = 64, SLABS = 1;
  static constexpr int STAGES = 6, ACC = 1, BLOCKS = 2;
};
template <>
struct Route<8> {
  static constexpr int TH = 2, KP = 1, PX = 16, LP = 72, SLABS = 1;
  static constexpr int STAGES = 3, ACC = 1, BLOCKS = 7;
};

template <int SC>
struct Geometry {
  static constexpr int TH = Route<SC>::TH, KP = Route<SC>::KP;
  static constexpr int NR = TH + 2;              // staged rows a plane
  static constexpr int LP = Route<SC>::LP;
  static constexpr int ROW = LP * Route<SC>::PX; // bytes a staged row
  static constexpr int SLAB = NR * ROW;          // bytes a slab of a stage
  static constexpr int SB = Route<SC>::SLABS * SLAB;  // bytes a stage
  static constexpr int S = Route<SC>::STAGES, ACC = Route<SC>::ACC;
  // columns a product: per output row, (kw, kd) at Ci >= 16 and (t, kd)
  // at Ci = 8 (`source_slice`); N of the product, in blocks of 8; floats
  // a row of the product buffer (odd: consecutive rows in distinct banks)
  static constexpr int PER_ROW = SC == 8 ? 6 : 9;
  static constexpr int NCOLS = TH * PER_ROW;
  static constexpr int NB = (NCOLS + 7) / 8;
  static constexpr int PSTRIDE = NCOLS | 1;
  static constexpr int BSLICE = 16 * 8 * NB * 2;      // one 16 x N B image
  static constexpr int PIECES = SC == 8 ? 2 : 3 * KP; // as laid out, a kh
  static constexpr int WBYTES = 3 * PIECES * SLICE;   // per (kh, piece)
  static constexpr int PBYTES = NR * KP * BSLICE;     // per (row, product)
  // the swizzles repeat every 256 (32-byte) or 512 (64-byte) bytes
  static constexpr int ALIGN = SC == 8 ? 128 : 1024;
  // B as multiplied, mbarriers, then the ring, then the costs (float32;
  // the weights as laid out until B is built), two product buffers
  // (float32), the volume (bf16): costs and volume of one chunk of up to
  // D_CHUNK
  static constexpr int RING = PBYTES + BARS + ALIGN;
  __host__ __device__ static int cost_bytes(int D) {
    const int bytes = TH * (D < D_CHUNK ? D : D_CHUNK) * TW * 4;
    return bytes > WBYTES ? bytes : WBYTES;
  }
  static int smem(int D) {
    const int dc = D < D_CHUNK ? D : D_CHUNK;
    return RING + S * SB + cost_bytes(D) + 2 * TM * PSTRIDE * 4 +
           TH * dc * TW * 2;
  }
  static_assert(TH * TW <= 128, "a product thread a pixel");
  static_assert(NB == 2 || NB == 3, "N = 16 or 24");
  static_assert(S >= 2, "a stage for the next plane");
  static_assert(8 * (2 * S + 1) <= BARS, "the mbarriers fit");
};

// Column n of the product of staged row sh and slice kc as the image of
// the wrapper's whose column n % 3 (kd) it holds, or -1 where the column
// is zero. Output row o reads staged row sh at kh = sh - o. Ci >= 16: n =
// o * 9 + kw * 3 + kd from image (kh, kw, kc). Ci = 8: n = o * 6 + t * 3 +
// kd from image (kh, j = t): t = 0 the taps kw = 0 (k < 8) and 1 (k >= 8)
// at pixel q, t = 1 the tap kw = 2 (k < 8) at pixel q + 2.
template <int SC>
__device__ __forceinline__ int source_slice(int sh, int kc, int n) {
  using G = Geometry<SC>;
  const int o = n / G::PER_ROW, m = n % G::PER_ROW, kh = sh - o;
  if (o >= G::TH || kh < 0 || kh > 2) return -1;
  return SC == 8 ? kh * 2 + m / 3 : kh * G::PIECES + m / 3 * G::KP + kc;
}

// A 64 x 8NB float32 accumulator: thread (warp w, lane l) holds, per
// column block j, rows 16w + l/4 (v[4j], v[4j+1]) and 16w + l/4 + 8
// (v[4j+2], v[4j+3]) at columns 8j + 2(l%4) + {0, 1}.
template <int NB>
struct Acc {
  float v[4 * NB];
};

template <int NB>
__device__ __forceinline__ void zero(Acc<NB>& a) {
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) a.v[i] = 0.f;
}

template <int NB>
__device__ __forceinline__ void fence_operand(Acc<NB>& a) {
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) asm volatile("" : "+f"(a.v[i])::"memory");
}

// d += a (64 x 16) * b (16 x 8NB), both read from shared memory through
// descriptors.
template <int NB>
__device__ __forceinline__ void wgmma_ss(Acc<NB>& d, uint64_t a,
                                         uint64_t b) {
  if constexpr (NB == 2)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]),
          "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7])
        : "l"(a), "l"(b), "n"(1));
  else
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, "
        "1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]),
          "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
          "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11])
        : "l"(a), "l"(b), "n"(1));
}

// The A descriptor of 64 staged pixels from `addr` on, K-major: Ci = 32
// and 64, a slab's 64-byte rows under TMA's 64-byte swizzle (8-row groups
// 512 bytes apart); Ci = 16, 32-byte rows under the 32-byte swizzle
// (groups 256 bytes apart); Ci = 8, 16-byte voxels unswizzled, k >= 8 the
// next voxel (16 bytes on), 8-row groups 128 bytes apart.
template <int SC>
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  const uint64_t start = (addr & 0x3FFFF) >> 4;
  if constexpr (SC == 8)
    return start | ((16ull >> 4) << 16) | ((128ull >> 4) << 32);
  else if constexpr (SC == 16)
    return start | (1ull << 16) | ((256ull >> 4) << 32) | (3ull << 62);
  else
    return start | (1ull << 16) | ((512ull >> 4) << 32) | (2ull << 62);
}

// map_x: the TMA map of x, boxes of one plane's NR staged rows (of one
// 32-channel slab at Ci = 64; Ci >= 16: `tc::make_map`; Ci = 8:
// `tc::make_voxel_map`); wt: the 3 * PIECES B images, image kh * PIECES +
// piece, column kd (the wrapper lays them out); vol (B, D, H, W); out (B,
// H, W) float32. CHUNKED: D > D_CHUNK, the costs folded chunk by chunk.
template <int SC, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, Route<SC>::BLOCKS)
skip_softargmin_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                          const bf16* __restrict__ wt,
                          const bf16* __restrict__ vol,
                          float* __restrict__ out, int D, int H, int W,
                          float start) {
  using Geo = Geometry<SC>;
  constexpr int TH = Geo::TH, KP = Geo::KP, NR = Geo::NR, ROW = Geo::ROW;
  constexpr int SLAB = Geo::SLAB, SB = Geo::SB, S = Geo::S, ACC = Geo::ACC;
  constexpr int NB = Geo::NB, NCOLS = Geo::NCOLS, PSTRIDE = Geo::PSTRIDE;
  constexpr int BSLICE = Geo::BSLICE;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t packed = tc::smem_addr(smem);
  const uint32_t bars = packed + Geo::PBYTES;
  const uint32_t ring = (bars + BARS + Geo::ALIGN - 1) & ~(Geo::ALIGN - 1u);
  // costs (row, d, pixel) float32 (first the weights as laid out),
  // product buffers (2, TM, PSTRIDE) float32, the volume (row, d, pixel)
  // bf16, each of one chunk of DC
  const int DC = CHUNKED ? D_CHUNK : D;
  unsigned char* raw_w = smem + (ring - packed) + S * SB;
  float* costs = reinterpret_cast<float*>(raw_w);
  float* pbufs = reinterpret_cast<float*>(raw_w + Geo::cost_bytes(D));
  unsigned short* vols =
      reinterpret_cast<unsigned short*>(pbufs + 2 * TM * PSTRIDE);
  auto landed = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  const uint32_t weights = bars + 8 * 2 * S;
  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH, b = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      tc::mbar_init(landed(s), 1);
      tc::mbar_init(empty(s), 128);
    }
    tc::mbar_init(weights, 1);
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // The staging warp: one thread copies the weights, then plane p's NR
    // rows (each slab's box) into stage p % S once the products have read
    // what it held.
    if (threadIdx.x == 128) {
      tc::mbar_expect_tx(weights, Geo::WBYTES);
      tc::bulk_load(tc::smem_addr(raw_w), wt, Geo::WBYTES, weights);
      for (int p = 0; p < D; ++p) {
        const int s = p % S;
        if (p >= S) tc::mbar_wait(empty(s), ((p / S) & 1) ^ 1);
        tc::mbar_expect_tx(landed(s), SB);
        if constexpr (SC == 8)
          tc::tma_load_4d(ring + s * SB, &map_x, landed(s), 2 * (w0 - 1),
                          h0 - 1, p, b);
        else
          for (int k = 0; k < Route<SC>::SLABS; ++k)
            tc::tma_load_5d(ring + s * SB + k * SLAB, &map_x, landed(s),
                            32 * k, w0 - 1, h0 - 1, p, b);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // The skip: the volume of costs d0 .. d0 + dn - 1 as rows (row, d - d0,
  // pixel), each warp rows warp, warp + 4, ..., a lane pixels lane and
  // lane + 32. The loads of VR rows are issued together, at a valid
  // address (masked after), the first chunk's now, so that they land while
  // B and the first plane do.
  const unsigned short* v16 = reinterpret_cast<const unsigned short*>(vol);
  unsigned raw[VR][2], vok = 0;  // 32-bit: no packing after each load
  auto load_volume = [&](int d0, int dn, int r0) {  // rows r0 + k * 4 + warp
    vok = 0;
#pragma unroll
    for (int k = 0; k < VR; ++k) {
      const int r = r0 + k * 4 + warp;
      const int o = r / dn, d = d0 + r % dn, h = h0 + o;
      const size_t row = (((size_t)b * D + d) * H + h) * W;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int x = lane + 32 * j, w = w0 + x;
        const bool in = r < TH * dn && h < H && x < TW && w < W;
        vok |= (unsigned)in << (2 * k + j);
        raw[k][j] = __ldg(v16 + (in ? row + w : 0));
      }
    }
  };
  auto store_volume = [&](int dn, int r0) {
#pragma unroll
    for (int k = 0; k < VR; ++k) {
      const int r = r0 + k * 4 + warp;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (r < TH * dn && lane + 32 * j < TW)
          vols[r * TW + lane + 32 * j] =
              vok >> (2 * k + j) & 1 ? raw[k][j] : 0u;
    }
  };
  auto stage_volume = [&](int d0, int from) {  // the chunk from d0
    const int dn = min(D - d0, D_CHUNK);
    for (int r0 = from; r0 < TH * dn; r0 += VR * 4) {
      load_volume(d0, dn, r0);
      store_volume(dn, r0);
    }
  };
  load_volume(0, min(D, D_CHUNK), 0);

  // The products' B, as multiplied: per (staged row, product) a 16 x N
  // slice whose column n holds `source_slice`'s column kd (n % 3): every
  // tap and output row that reads the staged row in one product. Copied
  // as 16-byte core rows (8 k of one column).
  tc::mbar_wait(weights, 0);
  for (int i = threadIdx.x; i < NR * KP * 16 * NB; i += 128) {
    const int slice = i / (16 * NB), half = i / (8 * NB) % 2,
              n = i % (8 * NB);
    const int src = source_slice<SC>(slice / KP, slice % KP, n);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (src >= 0)
      v = *reinterpret_cast<const uint4*>(raw_w + src * SLICE + half * 128 +
                                          n % 3 * 16);
    *reinterpret_cast<uint4*>(smem + slice * BSLICE + n / 8 * 256 +
                              half * 128 + n % 8 * 16) = v;
  }
  tc::fence_proxy_async();  // the writes above before wgmma reads them
  store_volume(min(D, D_CHUNK), 0);
  stage_volume(0, VR * 4);
  // This thread's output pixel q and row o, and its private column of
  // costs of the chunk from d0; cost[p - 1] and cost[p] so far while
  // plane p is summed. Its running soft-argmin over the chunks folded so
  // far: the least cost, and the sums of exp(least - cost) and of that
  // times the bin.
  const int q = threadIdx.x % TM, o = threadIdx.x / TM;
  const bool owner = o < TH && q < TW;
  float* mine = costs + o * DC * TW + q;
  float open_a = 0.f, open_b = 0.f;
  int d0 = 0;
  float run_m = 0.f, run_den = 0.f, run_num = 0.f;
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  // Costs d0 .. d0 + dn - 1 of this thread's pixel (its own column, the
  // skip added: the volume stored by other threads before a barrier since)
  // into the running soft-argmin: the least cost, then the sums in order
  // of d, both rescaled to the lesser least cost past the first chunk.
  auto fold = [&](int dn) {
    auto cost = [&](int k) {
      return mine[k * TW] +
             __uint_as_float((unsigned)vols[(o * dn + k) * TW + q] << 16);
    };
    float m = cost(0);
#pragma unroll 8
    for (int k = 1; k < dn; ++k) m = fminf(m, cost(k));
    float den = 0.f, num = 0.f;
#pragma unroll 8
    for (int k = 0; k < dn; ++k) {
      const float e = expf(m - cost(k));
      den += e;
      num = fmaf(e, start + (float)(d0 + k), num);
    }
    if (!CHUNKED || d0 == 0) {
      run_m = m;
      run_den = den;
      run_num = num;
    } else {
      const float mm = fminf(run_m, m);
      const float s_run = expf(mm - run_m), s_new = expf(mm - m);
      run_den = run_den * s_run + den * s_new;
      run_num = run_num * s_run + num * s_new;
      run_m = mm;
    }
  };

  const uint64_t desc0 = tc::b_desc(packed);
  // Two planes in flight: plane p's products run while the sums of plane
  // p - 1 are formed, into accumulator sets a and b by turns, through
  // product buffers a and b.
  using Accs = Acc<NB>[ACC];
  Accs acc_a, acc_b;
  float* pbuf_a = pbufs;
  float* pbuf_b = pbufs + TM * PSTRIDE;
  // Plane p's products: one wgmma per (staged row, 16-channel slice kc)
  // from pixel 0 of the staged row (slice kc in slab kc / 2, at byte
  // 32 (kc % 2) of a pixel); ACC independent chains.
  auto issue = [&](int p, Accs& acc) {
    tc::mbar_wait(landed(p % S), (p / S) & 1);
    const uint32_t buf = ring + (p % S) * SB;
#pragma unroll
    for (int k = 0; k < ACC; ++k) {
      zero(acc[k]);
      fence_operand(acc[k]);
    }
    tc::wgmma_fence();
#pragma unroll
    for (int i = 0; i < NR * KP; ++i) {
      const int kc = i % KP;
      wgmma_ss(acc[i % ACC],
               a_desc<SC>(buf + kc / 2 * SLAB + i / KP * ROW + kc % 2 * 32),
               desc0 + i * (BSLICE >> 4));
    }
    tc::wgmma_commit();
  };
  // Plane p's sums, once its products are done: the product rows into a
  // buffer; then for this thread's pixel q and row o, P's columns of each
  // kd summed over the taps (rows q + kw): cost[p+1] gets kd 0, cost[p]
  // kd 1, cost[p-1] kd 2, which completes it. Where that completes a
  // chunk of D_CHUNK costs, the owners fold it, and once all have, the
  // warpgroup loads the next chunk's volume.
  auto sums = [&](int p, Accs& acc, float* pb) {
    tc::mbar_arrive(empty(p % S));  // the products have read the stage
    float v[4 * NB] = {};
#pragma unroll
    for (int k = 0; k < ACC; ++k) {
      fence_operand(acc[k]);
#pragma unroll
      for (int i = 0; i < 4 * NB; ++i) v[i] += acc[k].v[i];
    }
    const int r = warp * 16 + lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 4 * NB; ++i)
      if (i / 4 * 8 + c + i % 2 < NCOLS)
        pb[(r + i / 2 % 2 * 8) * PSTRIDE + i / 4 * 8 + c + i % 2] = v[i];
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
    if (owner) {
      float kd[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if constexpr (SC == 8)
          kd[k] = pb[q * PSTRIDE + o * 6 + k] +
                  pb[(q + 2) * PSTRIDE + o * 6 + 3 + k];
        else
          kd[k] = pb[q * PSTRIDE + o * 9 + k] +
                  pb[(q + 1) * PSTRIDE + o * 9 + 3 + k] +
                  pb[(q + 2) * PSTRIDE + o * 9 + 6 + k];
      }
      if (p > 0) mine[(p - 1 - d0) * TW] = open_a + kd[2];
      open_a = open_b + kd[1];
      open_b = kd[0];
    }
    if constexpr (CHUNKED) {
      if (p - d0 == D_CHUNK) {  // costs d0 .. p - 1 complete; p < D
        if (owner) fold(D_CHUNK);
        d0 = p;
        asm volatile("bar.sync 1, 128;\n" ::: "memory");  // folds read
        stage_volume(d0, 0);
      }
    }
  };
  issue(0, acc_a);
  int p = 1;
  for (; p + 1 < D; p += 2) {
    issue(p, acc_b);
    tc::wgmma_wait<1>();
    sums(p - 1, acc_a, pbuf_a);
    issue(p + 1, acc_a);
    tc::wgmma_wait<1>();
    sums(p, acc_b, pbuf_b);
  }
  if (p < D) {  // D even: the last plane in b
    issue(p, acc_b);
    tc::wgmma_wait<1>();
    sums(p - 1, acc_a, pbuf_a);
    tc::wgmma_wait<0>();
    sums(p, acc_b, pbuf_b);
  } else {
    tc::wgmma_wait<0>();
    sums(p - 1, acc_a, pbuf_a);
  }
  // the last chunk's volume, stored after the barrier of its last sums
  if constexpr (CHUNKED) asm volatile("bar.sync 1, 128;\n" ::: "memory");

  // Soft-argmin of this thread's pixel: the last chunk folded in.
  const int h = h0 + o, w = w0 + q;
  if (!owner || h >= H || w >= W) return;
  mine[(D - 1 - d0) * TW] = open_a;
  fold(D - d0);
  out[((size_t)b * H + h) * W + w] = run_num / run_den;
}

template <int SC>
int launch(const void* x, const void* wt, const void* vol, void* out, int B,
           int D, int H, int W, float start, cudaStream_t s) {
  using G = Geometry<SC>;
  auto kernel = D > D_CHUNK ? skip_softargmin_tc_kernel<SC, true>
                            : skip_softargmin_tc_kernel<SC, false>;
  const int smem = G::smem(D);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)  // all of the SM's shared memory, for BLOCKS blocks
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  int rc;
  if constexpr (SC == 8) {
    rc = tc::make_voxel_map(&map, x, B, D, H, W, G::LP, G::NR, 1);
  } else {  // boxes of one slab: all 16 or 32 channels, or 32 of 64
    const cuuint64_t dims[5] = {SC, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)D, (cuuint64_t)B};
    rc = tc::make_map(&map, x, 5, dims, SC < 32 ? SC : 32, G::LP, G::NR);
  }
  if (rc != 0) return rc;
  const dim3 grid(ceil_div(W, TW), ceil_div(H, G::TH), B);
  kernel<<<grid, THREADS, smem, s>>>(map, (const bf16*)wt,
                                     (const bf16*)vol, (float*)out, D, H,
                                     W, start);
  return (int)cudaGetLastError();
}

}  // namespace tcr

// ---- the bf16 4-channel tensor-core route ----------------------------------

namespace s4 {

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
  const uint16_t* x;    // (B, 4, D, H, W)
  const uint32_t* wk;   // the 4 B slices (`costfilter.skip_c4_images`)
  const uint16_t* vol;  // (B, D, H, W)
  float* out;           // (B, H, W)
  int B, D, H, W;
  float start;
};

// Columns of tiles: (b, h0, w0), each walked over its depth tiles.
__host__ __device__ inline int columns(const Args& a) {
  return a.B * ceil_div(a.H, TH) * ceil_div(a.W, TW);
}

__device__ __forceinline__ Tile tile_of(const Args& a, int t, int dt) {
  const int ncx = ceil_div(a.W, TW), nh = ceil_div(a.H, TH);
  Tile r;
  r.w0 = t % ncx * TW;
  t /= ncx;
  r.h0 = t % nh * TH;
  r.b = t / nh;
  r.d0 = dt * TD;
  return r;
}

// The volume at output row `orow`, pixel `opix` of tile `tt` for each of
// its depths, 0 outside; loaded with the tile's staged values, in flight
// together.
__device__ __forceinline__ void load_volume(const Args& a, const Tile& tt,
                                            int orow, int opix,
                                            uint32_t (&v)[TD]) {
  const int h = tt.h0 + orow, w = tt.w0 + opix;
  const bool in = h < a.H && w < a.W;
  const uint16_t* p =
      a.vol + (((size_t)tt.b * a.D + tt.d0) * a.H + h) * a.W + w;
#pragma unroll
  for (int od = 0; od < TD; ++od)
    v[od] = in && tt.d0 + od < a.D ? __ldg(p + (size_t)od * a.H * a.W) : 0u;
}

// Persistent blocks walk columns of tiles, each column over its depth
// tiles; a tile's 42 rows of 68 voxels are staged channels-last while the
// next tile's pairs and volume fly (a register prefetch), then warp (pb,
// rg) = (warp % 4, warp / 4) multiplies pixels 16 pb .. + 15 of output
// rows 2 rg, 2 rg + 1. A's rows are the pixels in pairs (row g pixel 2g,
// row g + 8 pixel 2g + 1), its 16 columns the elements from each pixel's
// staged voxel on (taps kw = 0, 1, 2 and a fourth of zero weight), as in
// `c4`. The one output channel frees B's columns for the depth taps: per
// staged row sh (0 .. 3 from row 2 rg) one resident slice whose column
// n = 4 r + kd holds output row r's tap (kd, kh = sh - r) (zero where kh
// falls outside 0 .. 2, and at kd = 3). So per staged (depth, row) one A
// fragment and one product, 28 a warp a tile, summed over the four rows
// into P of staged depth sd: column (r, kd) belongs to output depth sd -
// kd. Lane (g, t) holds columns 2t, 2t + 1 of pixels 2g and 2g + 1; one
// exchange with lane t ^ 1 (two shuffles) leaves lane (g, t) all three kd
// terms of output row t / 2, pixel 2g + t % 2. Then the skip, and the
// soft-argmin of the tile's depths (the least cost, then the sums in
// order of d) folded into the lane's running one, both sums rescaled to
// the lesser least cost, as the other routes do; at D <= TD that is the
// single two-pass soft-argmin. The column's last depth tile writes
// float32, ragged H and W masked.
template <bool EVEN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    skip_softargmin_c4_kernel(Args a) {
  __shared__ __align__(16) uint32_t stage[SROWS * PW];

  const int ncols = columns(a), nd = ceil_div(a.D, TD);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4, pb = warp % 4, rg = warp / 4;
  const bool odd = q & 1;
  // this lane's output once exchanged: row orow, pixel opix of the tile
  const int orow = 2 * rg + q / 2, opix = pb * 16 + 2 * g + (q & 1);
  int t = blockIdx.x, dt = 0;
  Tile tt = tile_of(a, t, 0);
  Staged<EVEN> s;
  uint32_t vnext[TD];
  if (t < ncols) {
    load_tile<EVEN>(a.x, a.D, a.H, a.W, tt, s);
    load_volume(a, tt, orow, opix, vnext);
  }

  uint32_t bw[4][2];  // B of staged row sh: k = 2q + {0, 1} (+ 8), column g
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bw[i][0] = __ldg(a.wk + (i * 8 + g) * 8 + q);
    bw[i][1] = __ldg(a.wk + (i * 8 + g) * 8 + q + 4);
  }
  // this lane's A words: pixel 16 pb + 2g (+ 1) from its staged pixel on
  const int aoff = 2 * (pb * 16 + 2 * g + 1) + q;
  // the running soft-argmin of this lane's pixel over the column's depth
  // tiles so far: the least cost, and the sums of exp(least - cost) and of
  // that times the bin
  float run_m = 0.f, run_den = 0.f, run_num = 0.f;

  while (t < ncols) {
    __syncthreads();  // the last tile's A reads done
    store_tile<EVEN>(s, stage);
    uint32_t vraw[TD];
#pragma unroll
    for (int od = 0; od < TD; ++od) vraw[od] = vnext[od];
    const Tile cur = tt;
    const bool last = dt == nd - 1;
    if (last) {
      dt = 0;
      t += gridDim.x;
    } else {
      ++dt;
    }
    if (t < ncols) {
      tt = tile_of(a, t, dt);
      load_tile<EVEN>(a.x, a.D, a.H, a.W, tt, s);
      load_volume(a, tt, orow, opix, vnext);
    }
    __syncthreads();  // the tile staged

    float cost[TD];
#pragma unroll
    for (int od = 0; od < TD; ++od) cost[od] = 0.f;
#pragma unroll
    for (int sd = 0; sd < TD + 2; ++sd) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int sh = 0; sh < 4; ++sh) {
        const uint32_t* ap = stage + (sd * SH + 2 * rg + sh) * PW + aoff;
        const uint32_t af[4] = {ap[0], ap[2], ap[4], ap[6]};
        mma(p, af, bw[sh]);
      }
      // even lanes hold (kd 0, kd 1) of row t / 2, odd lanes (kd 2, 0):
      // the even lane sends pixel 2g + 1's kd 0 and kd 1, the odd lane
      // pixel 2g's kd 2
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? p[0] : p[2], 1);
      const float r2 = __shfl_xor_sync(0xffffffffu, p[3], 1);
      const float k0 = odd ? r1 : p[0], k1 = odd ? r2 : p[1];
      const float k2 = odd ? p[2] : r1;
      if (sd < TD) cost[sd] += k0;
      if (sd >= 1 && sd - 1 < TD) cost[sd - 1] += k1;
      if (sd >= 2) cost[sd - 2] += k2;
    }

    // the skip, then this tile's depths into the running soft-argmin
    const int dn = min(TD, a.D - cur.d0);
#pragma unroll
    for (int od = 0; od < TD; ++od)
      cost[od] += __uint_as_float(vraw[od] << 16);
    float m = cost[0];
#pragma unroll
    for (int od = 1; od < TD; ++od)
      if (od < dn) m = fminf(m, cost[od]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int od = 0; od < TD; ++od) {
      if (od >= dn) break;
      const float e = expf(m - cost[od]);
      den += e;
      num = fmaf(e, a.start + (float)(cur.d0 + od), num);
    }
    if (cur.d0 == 0) {
      run_m = m;
      run_den = den;
      run_num = num;
    } else {  // both sums rescaled to the lesser of the two least costs
      const float mm = fminf(run_m, m);
      const float s_run = expf(mm - run_m), s_new = expf(mm - m);
      run_den = run_den * s_run + den * s_new;
      run_num = run_num * s_run + num * s_new;
      run_m = mm;
    }
    const int h = cur.h0 + orow, w = cur.w0 + opix;
    if (last && h < a.H && w < a.W)
      a.out[((size_t)cur.b * a.H + h) * a.W + w] = run_num / run_den;
  }
}

// Persistent blocks, as many as fit (the occupancy, queried once), at most
// one a column.
template <bool EVEN>
int launch_w(const Args& a, cudaStream_t s) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, skip_softargmin_c4_kernel<EVEN>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
  }
  if (per_sm < 1 || tc::sm_count() < 1) return (int)cudaErrorInvalidValue;
  const int grid = std::min(columns(a), per_sm * tc::sm_count());
  if (grid < 1) return (int)cudaSuccess;
  skip_softargmin_c4_kernel<EVEN><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

int launch(const void* x, const void* wt, const void* vol, void* out, int B,
           int D, int H, int W, float start, cudaStream_t s) {
  const Args a{(const uint16_t*)x, (const uint32_t*)wt,
               (const uint16_t*)vol, (float*)out, B, D, H, W, start};
  return W % 2 == 0 ? launch_w<true>(a, s) : launch_w<false>(a, s);
}

}  // namespace s4

}  // namespace

// x NCDHW; wt (1, Ci, 3, 3, 3).
extern "C" int conv3d_skip_softargmin_f32(const void* x, const void* wt,
                                          const void* vol, void* out, int B,
                                          int Ci, int D, int H, int W,
                                          float start, void* stream) {
  if (Ci < 1 || D < 1) return (int)cudaErrorInvalidValue;
  return launch_cores<float>(x, wt, vol, out, B, Ci, D, H, W, start,
                             (cudaStream_t)stream);
}

// The tensor-core routes where they take the width (`tcr`: x
// channels-last, wt the B images of `costfilter.skip_images`; `s4`, Ci =
// 4: x NCDHW, wt the B slices of `costfilter.skip_c4_images`), else the
// CUDA cores (x NCDHW, wt (1, Ci, 3, 3, 3)). Mirrored by
// `costfilter.skip_tensor_core_route`.
extern "C" int conv3d_skip_softargmin_bf16(const void* x, const void* wt,
                                           const void* vol, void* out, int B,
                                           int Ci, int D, int H, int W,
                                           float start, void* stream) {
  if (Ci < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Ci) {
    case 64:
      return tcr::launch<64>(x, wt, vol, out, B, D, H, W, start, s);
    case 32:
      return tcr::launch<32>(x, wt, vol, out, B, D, H, W, start, s);
    case 16:
      return tcr::launch<16>(x, wt, vol, out, B, D, H, W, start, s);
    case 8:
      return tcr::launch<8>(x, wt, vol, out, B, D, H, W, start, s);
    case 4:
      return s4::launch(x, wt, vol, out, B, D, H, W, start, s);
  }
  return launch_cores<bf16>(x, wt, vol, out, B, Ci, D, H, W, start, s);
}
