// The narrow-entry route of dense3x3, for Hopper: bf16, one input of Ci = 1,
// 2 or 3 channels (Ci x 9 <= 32 taps), 32 outputs, G <= 2 weight groups,
// d <= 16. It computes the layer of `dense3x3.cuh`,
//   y[b,h,w,co] = sum_{ci,ky,kx} act(x[b,ci,h+(ky-1)d,w+(kx-1)d])
//                 * wt[g,ci,ky*3+kx,co]
// reading x NCHW, as the refinement's callers hand it, and writing y
// channels-last (B, H, W, 32), as every later layer reads it.
//
// Replaces the TPU kernels lwsnet_tpu/ops/pallas/refine_rows.py:
// _dense_kernel at the towers' 3-channel entry and lwsnet_tpu/ops/pallas/
// refine.py:_dense_stack_layer_kernel (the im2col tap stack, one matmul
// over K = ci * 9 + tap). Bound on the H100: bytes, the channels-last write
// stream. The "mxu" tower entry at 368x1232 (B = 2) reads 5.4 MB and
// writes 58 MB (18.95 us at 3.35 TB/s) for 1.96 GFLOP.
//
// Design:
// * Several blocks of one warpgroup an SM, persistent, each walking tiles
//   blockIdx.x, + gridDim.x, ...: R = 8 output rows d apart (h, h+d, ...,
//   h+7d, tiled within each class h mod d as `dense3x3_tc.cuh` tiles them)
//   by 64 pixels, all 32 outputs.
// * Staging: a tile reads Ci planes x (R + 2) rows (h-d .. h+8d) x (64 +
//   2d) pixels of NCHW x, one column a thread, in coalesced 2-byte loads
//   from clamped addresses, all issued before any is used: the next tile's
//   while this tile multiplies (a register prefetch into a second staging
//   buffer). Written to shared memory, each value becomes the activation
//   inside the image and zero outside it: the conv's zero padding, which
//   comes after the activation.
// * The A fragments straight from the staged rows: each thread holds the
//   wgmma register A of its pixels (16w + l/4, + 8) at its columns k, the
//   shared-memory offset of each of its k (ci, ky, kx) computed once per
//   launch; k >= Ci x 9 reads a plane of zeros. No A tile, no ldmatrix,
//   one block barrier a tile.
// * Products: per output row one (Ci = 1, K = 16) or two (K = 32) wgmma
//   m64n32k16 against the group's resident B images: the (32, K)
//   pointwise kernel over the taps as K-major 1 KB slices, which each
//   block lays out from the weights as the caller has them, so that the
//   wrapper prepares nothing (host time a call). The bf16 products are
//   exact in float32, so only the order of the float32 sums differs from
//   the CUDA-core tiles and the plain version.
// * Epilogue: `tc::store_row`, 16-byte channels-last vectors, one 4 KB run
//   a tile row, evict-first (st.global.cs: the 58 MB stream exceeds the 50
//   MB L2, and plain stores ran slower on the H100); ragged rows and
//   columns masked at the store.
#pragma once

#include <algorithm>
#include <cstdint>

#include "dense3x3.cuh"
#include "tc.cuh"

namespace dense_entry {

using dense::Args;

constexpr int R = 8;          // output rows a tile, d apart
constexpr int TW = 64;        // output pixels a tile row: the wgmma M
constexpr int THREADS = 128;  // one warpgroup
constexpr int MIN_BLOCKS = 4;  // an SM, at most 128 registers a thread
constexpr int MAX_D = 16;
constexpr int MAX_G = 2;
constexpr int K = 32;         // Ci x 9 taps, zero-padded: two K=16 slices
constexpr int P = TW + 2 * MAX_D + 8;  // staged row pitch, elements
constexpr int PLANE = (R + 2) * P;     // one channel's staged rows

// The route's shapes (mirrored by `dense_entry_route` in
// ops/cuda/refine_rows.py).
__host__ __device__ inline bool use(int elem_bytes, int Ci, int Co, int d,
                                    int nin, int G) {
  return elem_bytes == 2 && nin == 1 && Ci >= 1 && Ci * 9 <= K &&
         Co == tc::N && d >= 1 && d <= MAX_D && G >= 1 && G <= MAX_G;
}

__host__ __device__ inline int row_tiles(const Args& a) {
  return ceil_div(ceil_div(a.H, a.d), R);
}
__host__ __device__ inline int col_tiles(const Args& a) {
  return ceil_div(a.W, TW);
}
__host__ __device__ inline int tiles(const Args& a) {
  return a.B * a.d * row_tiles(a) * col_tiles(a);
}

// Tile t: batch b, row class c = h mod d, row tile k of the class, first
// column w0; staged row r (0 .. R+1) is image row c + (k R + r - 1) d,
// output row o is staged row o + 1.
struct Tile {
  int b, c, k, w0;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  const int ncx = col_tiles(a), nk = row_tiles(a);
  Tile r;
  r.w0 = t % ncx * TW;
  t /= ncx;
  r.k = t % nk;
  t /= nk;
  r.c = t % a.d;
  r.b = t / a.d;
  return r;
}

__device__ __forceinline__ int image_row(const Args& a, const Tile& t,
                                         int r) {
  return t.c + (t.k * R + r - 1) * a.d;
}

// This thread's staged column (threads < 64 + 2d) of every row of tile t,
// from clamped addresses, as 16-bit values in 32-bit registers; nothing
// is used here, so the loads are all in flight together.
template <int CI>
__device__ __forceinline__ void load_tile(const Args& a, int t,
                                          uint32_t (&v)[CI * (R + 2)]) {
  if ((int)threadIdx.x >= TW + 2 * a.d) return;
  const Tile tt = tile_of(a, t);
  const uint16_t* x = (const uint16_t*)a.x;
  const int ww = min(max(tt.w0 - a.d + (int)threadIdx.x, 0), a.W - 1);
#pragma unroll
  for (int r = 0; r < R + 2; ++r) {
    const int hh = min(max(image_row(a, tt, r), 0), a.H - 1);
#pragma unroll
    for (int ci = 0; ci < CI; ++ci)
      v[ci * (R + 2) + r] =
          __ldg(x + (((size_t)tt.b * CI + ci) * a.H + hh) * a.W + ww);
  }
}

// Tile t's loaded values into staging buffer s: the activation (when an
// affine is given) inside the image, zero outside it.
template <int CI>
__device__ __forceinline__ void store_tile(const Args& a, int t,
                                           const uint32_t (&v)[CI * (R + 2)],
                                           uint16_t* s) {
  const Tile tt = tile_of(a, t);
  const int col = threadIdx.x, ww = tt.w0 - a.d + col;
  if (col >= TW + 2 * a.d) return;
  const bool w_in = ww >= 0 && ww < a.W;
  float sa[CI], ss[CI];
  if (a.aff != nullptr) {
    const int g = tt.b / (a.B / a.G);
#pragma unroll
    for (int ci = 0; ci < CI; ++ci) {
      sa[ci] = a.aff[(size_t)g * 2 * CI + ci];
      ss[ci] = a.aff[((size_t)g * 2 + 1) * CI + ci];
    }
  }
#pragma unroll
  for (int r = 0; r < R + 2; ++r) {
    const int hh = image_row(a, tt, r);
    const bool in = w_in && hh >= 0 && hh < a.H;
#pragma unroll
    for (int ci = 0; ci < CI; ++ci) {
      uint32_t u = in ? v[ci * (R + 2) + r] : 0u;
      if (in && a.aff != nullptr) {
        const float f = __uint_as_float(u << 16);
        u = __bfloat16_as_ushort(
            __float2bfloat16(fmaxf(fmaf(f, sa[ci], ss[ci]), 0.f)));
      }
      s[ci * PLANE + r * P + col] = (uint16_t)u;
    }
  }
}

// CI input channels, TO the output dtype; a.wt: (G, 32, CI, 3, 3). Shared
// memory: two staging buffers of CI planes and a plane of zeros each, and
// the B images of every weight group.
template <int CI, typename TO>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    dense3x3_entry_kernel(Args a) {
  constexpr int KC = CI * 9 > 16 ? 2 : 1;  // K = 16 slices a product
  constexpr int NV = CI * (R + 2);
  constexpr int BUF = (CI + 1) * PLANE;
  __shared__ __align__(128) unsigned char wsm[MAX_G * K / 16 * tc::B_SLICE];
  __shared__ __align__(16) uint16_t stage[2 * BUF];

  // The B images, per group two 16 x 32 slices (tc.cuh): element (k, co)
  // of slice k / 16 at (co / 8) 256 + (k % 16 / 8) 128 + (co % 8) 16 +
  // (k % 8) 2 bytes, wt[g, co, k] (k = ci * 9 + tap, as the wt of
  // `_entry_images`), zero beyond CI * 9: per 16-byte row of 8 k, the
  // loads in a batch, one store. Then the zero planes, which no tile
  // overwrites.
  const int ntiles = tiles(a);
  const uint16_t* wt = (const uint16_t*)a.wt;
  for (int e = threadIdx.x; e < a.G * tc::N * K / 8; e += THREADS) {
    const int k0 = e % (K / 8) * 8, co = e / (K / 8) % tc::N;
    const int g = e / (K / 8 * tc::N);
    uint32_t u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      u[j] = k0 + j < CI * 9 ? wt[(g * tc::N + co) * CI * 9 + k0 + j] : 0u;
    *(uint4*)(wsm + (g * 2 + k0 / 16) * tc::B_SLICE + co / 8 * 256 +
              k0 % 16 / 8 * 128 + co % 8 * 16) =
        make_uint4(u[0] | u[1] << 16, u[2] | u[3] << 16, u[4] | u[5] << 16,
                   u[6] | u[7] << 16);
  }
  for (int e = threadIdx.x; e < PLANE; e += THREADS)
    stage[CI * PLANE + e] = stage[BUF + CI * PLANE + e] = 0;
  tc::fence_proxy_async();  // generic stores before wgmma reads them

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane % 4, p0 = warp * 16 + lane / 4;
  // Offsets of this thread's columns k = kc * 16 + j / 2 * 8 + 2q + j % 2
  // in a staged buffer, for output row 0 and pixel 0.
  int off[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kc * 16 + j / 2 * 8 + 2 * q + j % 2;
      const int ci = k / 9, ky = k % 9 / 3, kx = k % 3;
      off[kc][j] = k < CI * 9 ? ci * PLANE + ky * P + kx * a.d : CI * PLANE;
    }
  const uint64_t desc0 = tc::b_desc(tc::smem_addr(wsm));
  TO* y = (TO*)a.y;

  uint32_t v[NV];
  int t = blockIdx.x;
  if (t < ntiles) load_tile<CI>(a, t, v);
  for (int buf = 0; t < ntiles; t += gridDim.x, buf ^= 1) {
    uint16_t* s = stage + buf * BUF;
    store_tile<CI>(a, t, v, s);
    if (t + (int)gridDim.x < ntiles) load_tile<CI>(a, t + gridDim.x, v);
    __syncthreads();  // the tile staged (and, first, the weights)
    const Tile tt = tile_of(a, t);
    const uint64_t dg = desc0 + (uint64_t)(tt.b / (a.B / a.G)) * (K / 16) *
                                    (tc::B_SLICE >> 4);
#pragma unroll
    for (int o = 0; o < R; ++o) {
      uint32_t af[KC][4];
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // i: pixel half i % 2, k pair i / 2
          const uint16_t* sp = s + o * P + p0 + 8 * (i % 2);
          af[kc][i] = (uint32_t)sp[off[kc][i / 2 * 2]] |
                      (uint32_t)sp[off[kc][i / 2 * 2 + 1]] << 16;
        }
      tc::Acc acc;
      tc::zero(acc);
      tc::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        tc::wgmma_m64n32k16(acc, af[kc], dg + kc * (tc::B_SLICE >> 4));
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_operand(acc);
      const int h = image_row(a, tt, o + 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = tt.w0 + p0 + 8 * half;
        const bool ok = h < a.H && w < a.W;
        TO* px = y + (((size_t)tt.b * a.H + (ok ? h : 0)) * a.W +
                      (ok ? w : 0)) * tc::N;
        tc::store_row<TO>(acc, half, px, ok, true);
      }
    }
  }
}

// Launch on `stream`: as many resident blocks as fit (the occupancy,
// queried once), at most one per tile. Returns a cudaError_t.
template <int CI, typename TO>
int launch_ci(const Args& a, cudaStream_t stream) {
  auto kernel = dense3x3_entry_kernel<CI, TO>;
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
  }
  if (per_sm < 1 || tc::sm_count() < 1) return (int)cudaErrorInvalidValue;
  const int grid = std::min(tiles(a), per_sm * tc::sm_count());
  kernel<<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch(const Args& a, cudaStream_t stream) {
  switch (a.Ci) {
    case 1:
      return launch_ci<1, TO>(a, stream);
    case 2:
      return launch_ci<2, TO>(a, stream);
    case 3:
      return launch_ci<3, TO>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace dense_entry
