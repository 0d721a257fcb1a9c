// The tensor-core route of dwsep3x3, redesigned for Hopper: bf16, C = 16
// or 32 input channels, Co = 32 outputs (a pair: C -> 32 -> 32), d <= 16,
// at most two weight groups, on channels-last (B, H, W, C) activations,
// in and out. A layer (as in `dwsep3x3.cu`):
//   act  = relu(x * a + s), rounded to bf16, zero outside the image;
//   dw_c = the 9 dilated taps of channel c of act, float32, rounded once;
//   y    = pw . dw, float32, rounded once.
// The pair rounds layer 1's output to bf16; layer 2 applies its affine +
// ReLU to it, rounds again and keeps zeros outside the image.
//
// Replaces the TPU kernels lwsnet_tpu/ops/pallas/refine_rows.py:
// _dwsep_kernel and _dwsep2_kernel, and lwsnet_tpu/ops/pallas/refine.py:
// _dwsep_layer_kernel and _dwsep2_layer_kernel. Bound on the H100: bytes
// (a 368x1232 tower layer, B = 2, moves 116 MB, 34.7 us at 3.35 TB/s, for
// 1.2 GFLOP).
//
// Design (256 threads, two warpgroups; persistent blocks, as many per SM
// as shared memory and 128 registers a thread allow):
// * Tile: R = 4 output rows spaced d apart by TW = 64 pixels, all 32
//   output channels; rows are tiled within each class h mod d, as in
//   `dense3x3_tc.cuh`, so the R rows read R + 2 staged rows.
// * Staging: one thread issues a TMA box per staged row (channels-last,
//   the 64- / 32-byte swizzle of `tc.cuh`, zeros outside the tensor) into
//   a ring of two stages, the next tile's copies in flight while the
//   current tile computes. Every thread then applies the pre-activation
//   once per staged element, inside the image only: TMA's zero fill comes
//   before the affine, and relu(0 * a + s) != 0.
// * Depthwise on CUDA cores: a thread takes (pixel, 8 channels) for all
//   R output rows; per tap column it reads the R + 2 staged rows as one
//   16-byte vector each and feeds each to up to three output rows, the
//   tap weights broadcast from shared memory (float32). The float32 sums
//   are rounded once and written as a swizzled 64-pixel A tile per row.
// * Pointwise on tensor cores: per output row one ldmatrix A fragment per
//   16 channels and one wgmma m64n32k16 against the group's resident
//   pointwise weights (1 KB B images, laid out by the wrapper); the
//   16-byte channels-last epilogue of `tc.cuh`. A product of two bf16
//   values is exact in float32: only the order of the sums changes.
// * Pair: one cooperative launch runs layer 1 over every tile into a
//   channels-last scratch tensor (the wrapper's), then, after a grid-wide
//   barrier, layer 2 over every tile from it, both layers' weights
//   resident. Computing layer 1 per tile over layer 2's halo instead
//   (recomputing 1.69-2.25 intermediate pixels an output pixel, kept in
//   shared memory) ran slower on the H100 than this and than two solo
//   launches (PERF.md, PR 5): the 29-58 MB intermediate costs less in L2
//   and device memory than its recompute costs the CUDA cores.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "tc.cuh"

namespace dwsep_tc {

constexpr int R = 4;          // output rows per tile, d apart
constexpr int TW = 64;        // output pixels per tile row: the wgmma M
constexpr int NT = 256;       // two warpgroups
constexpr int MAX_D = 16;
constexpr int MAX_G = 2;      // weight groups resident in shared memory
constexpr int CM = 32;        // the pair's intermediate channels
constexpr int A_TILE = TW * 32 * 2;   // one 64-pixel A tile, <= 32 channels
constexpr int SMEM_MAX = 232448;

// One layer or two (`layers` = 2, a pair: x -> mid -> y). Layer i reads
// `x` (i = 0, C channels) or `mid` (i = 1, CM channels) and writes `mid`
// (i = 0 of a pair) or `y`.
struct Args {
  const void* x;         // (B, H, W, C) bf16
  const float* aff[2];   // (G, 2, Ci) float32
  const void* dw[2];     // (G, Ci, 9) bf16
  const void* pw[2];     // (G, Ci / 16) B images of (32, Ci) bf16
  void* mid;             // (B, H, W, CM) bf16 scratch of a pair
  void* y;               // (B, H, W, 32) bf16
  int B, G, C, H, W, d[2], layers;
};

// The route's shapes (Cm = 0: a solo layer); everything else takes the
// CUDA-core route of `dwsep3x3.cu`.
__host__ __device__ inline bool use(int elem_bytes, int C, int Cm, int Co,
                                    int d1, int d, int G) {
  return elem_bytes == 2 && Co == tc::N && (C == 16 || C == 32) &&
         d >= 1 && d <= MAX_D && G >= 1 && G <= MAX_G &&
         (Cm == 0 || (Cm == CM && d1 >= 1 && d1 <= MAX_D));
}

__host__ __device__ inline int align_up(int n, int a) {
  return (n + a - 1) / a * a;
}
__host__ __device__ inline int in_channels(const Args& a, int i) {
  return i == 0 ? a.C : CM;
}
__host__ __device__ inline int row_tiles(const Args& a, int d) {
  return ceil_div(ceil_div(a.H, d), R);
}
__host__ __device__ inline int tiles(const Args& a, int d) {
  return a.B * d * row_tiles(a, d) * ceil_div(a.W, TW);
}
// Pixels of a staged row: TW + 2d, rounded up to 8 so that each row
// starts on its swizzle period.
__host__ __device__ inline int row_pixels(int d) {
  return (TW + 2 * d + 7) / 8 * 8;
}

// Byte offsets into the block's shared memory, from a 1024-byte boundary:
// two stages of R + 2 rows (of the widest layer), R A tiles, then per
// layer its B images, float32 taps (g, tap, channel) and affines.
struct Layout {
  int stage_bytes, a, pw[2], dw[2], aff[2], bars, total;
};

__host__ __device__ inline Layout layout(const Args& a) {
  Layout l;
  const int d = a.layers == 2 && a.d[1] > a.d[0] ? a.d[1] : a.d[0];
  l.stage_bytes = align_up((R + 2) * row_pixels(d) * CM * 2, 1024);
  int o = 2 * l.stage_bytes;
  l.a = o;
  o += R * A_TILE;
  for (int i = 0; i < 2; ++i) {
    const int n = i < a.layers ? a.G * in_channels(a, i) : 0;
    l.pw[i] = o;
    o += n / 16 * tc::B_SLICE;
  }
  for (int i = 0; i < 2; ++i) {
    const int n = i < a.layers ? a.G * in_channels(a, i) : 0;
    l.dw[i] = o;
    o += n * 9 * 4;
    l.aff[i] = o;
    o += n * 2 * 4;
  }
  l.bars = align_up(o, 8);
  l.total = l.bars + 3 * 8 + 1024;  // 1024: room to align the base
  return l;
}

// One tile: batch b, row class c = h mod d, row tile k in the class,
// first column w0, weight group g.
struct Tile {
  int b, c, k, w0, g;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int d, int tile) {
  const int ncx = ceil_div(a.W, TW), nk = row_tiles(a, d);
  Tile t;
  t.w0 = (tile % ncx) * TW;
  tile /= ncx;
  t.k = tile % nk;
  tile /= nk;
  t.c = tile % d;
  t.b = tile / d;
  t.g = t.b / (a.B / a.G);
  return t;
}

// Image row of staged row r = 0 .. R + 1, i.e. of output row r - 1.
__device__ __forceinline__ int image_row(const Tile& t, int d, int r) {
  return t.c + (t.k * R + r - 1) * d;
}

// relu(v * a + s), rounded to bf16, of the R + 2 staged rows of `buf`
// (LP pixels of SC channels each; image rows row0, row0 + d, ..., first
// image column w0), inside the image only: the zeros TMA fills in outside
// it are the padding, which comes after the activation. `aff`: the
// group's (2, SC) affine. Thread t takes channels (t % CPP) * 8 .. of
// pixels t / CPP + k * NT / CPP of every row; all its chunks are loaded
// before any is written back, so that their latencies overlap.
template <int SC>
__device__ __forceinline__ void activate(const Args& a, unsigned char* buf,
                                         int LP, int row0, int d, int w0,
                                         const float* aff) {
  constexpr int CPP = SC / 8, PPI = NT / CPP, ROWS = R + 2;
  constexpr int KS = (TW + 2 * MAX_D + PPI - 1) / PPI;  // pixels a row
  const int cc = threadIdx.x % CPP, q0 = threadIdx.x / CPP;
  float sa[8], ss[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    sa[m] = aff[cc * 8 + m];
    ss[m] = aff[SC + cc * 8 + m];
  }
  const int qlo = max(0, -w0), qhi = min(LP, a.W - w0);  // inside columns
  uint4 u[ROWS][KS];
  bool in[ROWS][KS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int hh = row0 + r * d;
    const bool hv = hh >= 0 && hh < a.H;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int q = q0 + k * PPI;
      in[r][k] = hv && q >= qlo && q < qhi;
      if (in[r][k])
        u[r][k] = *reinterpret_cast<const uint4*>(
            buf + r * LP * SC * 2 + tc::chunk_offset<SC>(q, cc));
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int k = 0; k < KS; ++k)
      if (in[r][k])
        *reinterpret_cast<uint4*>(buf + r * LP * SC * 2 +
                                  tc::chunk_offset<SC>(q0 + k * PPI, cc)) =
            tc::activate8(u[r][k], sa, ss);
}

// The depthwise taps of the R output rows (row o reads staged rows o,
// o + 1, o + 2 of `in`, ROW bytes apart, at pixel offsets 0, d, 2d) for
// output pixels 0 .. TW-1, summed in float32 and rounded once to bf16 into
// A tile o, swizzled as a staged row. `w`: the group's (9, SC) float32
// taps.
template <int SC>
__device__ __forceinline__ void depthwise(const unsigned char* in, int ROW,
                                          int d, const float* w,
                                          unsigned char* A) {
  constexpr int CPP = SC / 8;
  const int cc = threadIdx.x % CPP;
  for (int e = threadIdx.x; e < TW * CPP; e += NT) {
    const int q = e / CPP;
    float acc[R][8];
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[o][m] = 0.f;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const uint32_t off = tc::chunk_offset<SC>(q + kx * d, cc);
      float v[R + 2][8];
#pragma unroll
      for (int r = 0; r < R + 2; ++r)
        tc::unpack8(*reinterpret_cast<const uint4*>(in + r * ROW + off),
                    v[r]);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float4* wp =
            reinterpret_cast<const float4*>(w + (ky * 3 + kx) * SC + cc * 8);
        const float4 w0 = wp[0], w1 = wp[1];
        const float wk[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int o = 0; o < R; ++o)
#pragma unroll
          for (int m = 0; m < 8; ++m)
            acc[o][m] = fmaf(wk[m], v[o + ky][m], acc[o][m]);
      }
    }
#pragma unroll
    for (int o = 0; o < R; ++o) {
      uint4 u;
      u.x = tc::pack_bf16(acc[o][0], acc[o][1]);
      u.y = tc::pack_bf16(acc[o][2], acc[o][3]);
      u.z = tc::pack_bf16(acc[o][4], acc[o][5]);
      u.w = tc::pack_bf16(acc[o][6], acc[o][7]);
      *reinterpret_cast<uint4*>(A + o * A_TILE +
                                tc::chunk_offset<SC>(q, cc)) = u;
    }
  }
}

// Output row h of the tile from `acc`, channels-last into y.
__device__ __forceinline__ void store_out(const Args& a, const Tile& t,
                                          const tc::Acc& acc, int h,
                                          bf16* y) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const bool hv = h < a.H;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int w = t.w0 + warp * 16 + lane / 4 + 8 * half;
    const bool ok = hv && w < a.W;
    bf16* px = y + (((size_t)t.b * a.H + (hv ? h : 0)) * a.W + (ok ? w : 0)) *
                       tc::N;
    tc::store_row<bf16>(acc, half, px, ok);
  }
}

// Layer i over every tile of the block (blockIdx.x, + gridDim.x, ...),
// its input through `map` (SC channels), jobs numbered from n0 in the
// block's two-stage ring (stage n % 2, phase n / 2). Returns the number
// of tiles it took.
template <int SC>
__device__ __forceinline__ int run_layer(const Args& a, int i,
                                         const CUtensorMap* map,
                                         const Layout& L, uint32_t base,
                                         unsigned char* sm, int n0) {
  const int d = a.d[i], LP = row_pixels(d), ROW = LP * SC * 2;
  const int tid = threadIdx.x, wg = tid / 128;
  const int ntiles = tiles(a, d);
  const int my = (int)blockIdx.x < ntiles
                     ? (ntiles - 1 - (int)blockIdx.x) / gridDim.x + 1
                     : 0;
  const uint32_t bar0 = base + L.bars;
  auto landed = [&](int n) { return bar0 + 8 * (n & 1); };
  // Tile m's TMA copies into stage (n0 + m) % 2 (one thread).
  auto issue = [&](int m) {
    const Tile t = tile_of(a, d, blockIdx.x + m * gridDim.x);
    const int n = n0 + m;
    const uint32_t buf = base + (n & 1) * L.stage_bytes;
    tc::mbar_expect_tx(landed(n), (R + 2) * ROW);
#pragma unroll
    for (int r = 0; r < R + 2; ++r)
      tc::tma_load_4d(buf + r * ROW, map, landed(n), 0, t.w0 - d,
                      image_row(t, d, r), t.b);
  };
  if (tid == 0) {
    tc::fence_proxy_async();  // the stages' earlier generic writes
    for (int m = 0; m < 2 && m < my; ++m) issue(m);
  }
  const float* dw_s = (const float*)(sm + L.dw[i]);
  const float* aff_s = (const float*)(sm + L.aff[i]);
  const uint64_t desc = tc::b_desc(base + L.pw[i]);
  bf16* out = (bf16*)(i + 1 < a.layers ? a.mid : a.y);
  unsigned char* A = sm + L.a;
  tc::Acc acc;
  for (int m = 0; m < my; ++m) {
    const Tile t = tile_of(a, d, blockIdx.x + m * gridDim.x);
    const int n = n0 + m;
    unsigned char* buf = sm + (n & 1) * L.stage_bytes;
    tc::mbar_wait(landed(n), (n >> 1) & 1);
    activate<SC>(a, buf, LP, image_row(t, d, 0), d, t.w0 - d,
                 aff_s + t.g * 2 * SC);
    __syncthreads();
    depthwise<SC>(buf, ROW, d, dw_s + t.g * 9 * SC, A);
    __syncthreads();  // stage n read; A tiles written
    if (tid == 0 && m + 2 < my) {
      tc::fence_proxy_async();
      issue(m + 2);
    }
    // The products: warpgroup wg takes output rows 2wg, 2wg + 1.
#pragma unroll 1
    for (int oo = 0; oo < R / 2; ++oo) {
      const int o = wg * (R / 2) + oo;
      tc::tile_product<SC>(acc, base + L.a + o * A_TILE,
                           desc + t.g * (SC / 16) * (tc::B_SLICE >> 4));
      store_out(a, t, acc, image_row(t, d, o + 1), out);
    }
  }
  return my;
}

// SC = C, the channels of x. A pair runs as a cooperative launch: layer 1
// writes `mid`, a grid-wide barrier, layer 2 reads it through map_mid.
template <int SC, bool PAIR>
__global__ void __launch_bounds__(NT, 2)
    dwsep3x3_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_mid, Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout L = layout(a);
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const uint32_t bar0 = base + L.bars, weights = bar0 + 16;

  if (tid == 0) {
    tc::mbar_init(bar0, 1);
    tc::mbar_init(bar0 + 8, 1);
    tc::mbar_init(weights, 1);
  }
  __syncthreads();
  // Every layer's weights: B images by bulk copy, taps as (g, tap,
  // channel) float32, affines (g, 2, channel).
  constexpr int LAYERS = PAIR ? 2 : 1;
  if (tid == 0) {
    int bytes = 0;
#pragma unroll
    for (int i = 0; i < LAYERS; ++i)
      bytes += a.G * in_channels(a, i) / 16 * tc::B_SLICE;
    tc::mbar_expect_tx(weights, bytes);
#pragma unroll
    for (int i = 0; i < LAYERS; ++i)
      tc::bulk_load(base + L.pw[i], a.pw[i],
                    a.G * in_channels(a, i) / 16 * tc::B_SLICE, weights);
  }
#pragma unroll
  for (int i = 0; i < LAYERS; ++i) {
    const int Ci = in_channels(a, i);
    const bf16* dw = (const bf16*)a.dw[i];
    float* dw_s = (float*)(sm + L.dw[i]);
    float* aff_s = (float*)(sm + L.aff[i]);
    for (int e = tid; e < a.G * Ci * 9; e += NT)
      dw_s[(e / (Ci * 9) * 9 + e % 9) * Ci + e / 9 % Ci] = to_f(dw[e]);
    for (int e = tid; e < a.G * 2 * Ci; e += NT) aff_s[e] = a.aff[i][e];
  }
  __syncthreads();
  tc::mbar_wait(weights, 0);

  const int n = run_layer<SC>(a, 0, &map_x, L, base, sm, 0);
  if constexpr (PAIR) {
    // Layer 1's stores reach TMA's reads of mid on every SM.
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    cooperative_groups::this_grid().sync();
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    run_layer<CM>(a, 1, &map_mid, L, base, sm, n);
  }
}

// Launch on `stream`: persistent blocks, as many per SM as fit, at most
// one per tile; a pair as a cooperative launch, every block resident.
// Returns a cudaError_t (or the CUresult of a refused TMA map).
template <int SC, bool PAIR>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = dwsep3x3_tc_kernel<SC, PAIR>;
  const Layout L = layout(a);
  if (L.total > SMEM_MAX || a.B % a.G != 0 || (PAIR && a.mid == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  const cuuint64_t dims[4] = {(cuuint64_t)a.C, (cuuint64_t)a.W,
                              (cuuint64_t)a.H, (cuuint64_t)a.B};
  int rc = tc::make_map(&maps[0], a.x, 4, dims, SC, row_pixels(a.d[0]));
  if (rc != 0) return rc;
  maps[1] = maps[0];
  if (PAIR) {
    const cuuint64_t mdims[4] = {(cuuint64_t)CM, (cuuint64_t)a.W,
                                 (cuuint64_t)a.H, (cuuint64_t)a.B};
    rc = tc::make_map(&maps[1], a.mid, 4, mdims, CM, row_pixels(a.d[1]));
    if (rc != 0) return rc;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                    L.total);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1 || tc::sm_count() < 1) return (int)cudaErrorInvalidValue;
  int work = tiles(a, a.d[0]);
  if (PAIR) work = std::max(work, tiles(a, a.d[1]));
  const int grid = std::min(work, per_sm * tc::sm_count());
  if (!PAIR) {
    kernel<<<grid, NT, L.total, stream>>>(maps[0], maps[1], a);
    return (int)cudaGetLastError();
  }
  Args args = a;
  void* params[] = {(void*)&maps[0], (void*)&maps[1], (void*)&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(NT),
                                  params, L.total, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

inline int launch_any(const Args& a, cudaStream_t stream) {
  if (a.layers == 2)
    return a.C == 32 ? launch<32, true>(a, stream)
                     : launch<16, true>(a, stream);
  return a.C == 32 ? launch<32, false>(a, stream)
                   : launch<16, false>(a, stream);
}

}  // namespace dwsep_tc
