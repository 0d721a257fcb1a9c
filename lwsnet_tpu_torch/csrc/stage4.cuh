// The tile and staging of the bf16 4-channel tensor-core routes, which read
// a (B, 4, D, H, W) activation: conv3d_bn_relu's 4 -> 4 layers (`c4` in
// conv3d_bn_relu.cu) and the fused 4 -> 1 last layer (`s4` in
// conv3d_skip_softargmin.cu).
//
// A tile is TD = 5 depths x TH = 4 rows x TW = 64 pixels of the output.
// Its (TD + 2)(TH + 2) = 42 staged rows of 68 voxels (w0 - 2 .. w0 + 65)
// are read from the four channel planes by coalesced 4-byte loads of pixel
// pairs where W is even (2-byte loads where it is odd), all of a thread's
// loads issued together into registers (a tile ahead of their use, by the
// routes' persistent blocks), then written channels-last as 8-byte voxels
// by 16-byte stores, zeros outside the volume. No TMA: a map's strides
// must be multiples of 16 bytes, and a stage-2 row is 616. In a staged row
// the 16 elements from pixel p on are the 4 channels of pixels p .. p + 3:
// taps kw = 0, 1, 2 of output pixel p and a fourth of zero weight, one
// K = 16 slice of mma.sync m16n8k16 (`mma`).
#pragma once

#include <cstdint>

namespace stage4 {

constexpr int TD = 5, TH = 4, TW = 64;  // output tile
constexpr int SH = TH + 2;              // staged rows a depth
constexpr int SROWS = (TD + 2) * SH;    // 42 staged (depth, row) rows
constexpr int PX = TW + 4;              // their pixels: w0 - 2 .. w0 + 65
constexpr int PW = 2 * PX;              // 32-bit words a row (8-byte voxels)
constexpr int THREADS = 256;            // 4 pixel blocks x 2 row pairs
// Staging: thread t loads pixel pair k = t % 32 (pixels w0 - 2 + 2k, + 1)
// of rows t / 32 + 8i, i < RI, and, below 2 SROWS, pair 32 + t % 2 of row
// t / 2: the PX / 2 = 34 pairs of every row.
constexpr int RI = (SROWS + 7) / 8;
static_assert(THREADS == 8 * 32 && PX == 2 * 34 && 2 * SROWS <= THREADS,
              "staging");

struct Tile {
  int b, d0, h0, w0;
};

// A thread's staged values of a tile: per (row, channel) a pixel pair,
// 0 outside the volume. EVEN (W even: a pair lies in or out of the volume
// whole and starts 4-byte aligned): one 4-byte load, two bf16 in a
// register; else two 2-byte loads, each in a register of its own. Nothing
// is used here, so the loads are all in flight together.
template <bool EVEN>
struct Staged {
  static constexpr int N = EVEN ? 1 : 2;
  uint32_t v[RI + 1][4][N];  // [RI]: the extra pair
};

// x: (B, 4, D, H, W) bf16 as 16-bit words.
template <bool EVEN>
__device__ __forceinline__ void load_pair(const uint16_t* x, int D, int H,
                                          int W, const Tile& tt, int r,
                                          int k, bool row_ok,
                                          uint32_t (&v)[4][Staged<EVEN>::N]) {
  const size_t vol = (size_t)D * H * W;
  const int dd = tt.d0 - 1 + r / SH, hh = tt.h0 - 1 + r % SH;
  const int w = tt.w0 - 2 + 2 * k;
  const bool in = row_ok && (unsigned)dd < (unsigned)D &&
                  (unsigned)hh < (unsigned)H;
  const uint16_t* p = x + (((size_t)tt.b * 4 * D + dd) * H + hh) * W + w;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (EVEN) {
      v[c][0] = in && (unsigned)w < (unsigned)W
                    ? __ldg(reinterpret_cast<const uint32_t*>(p + c * vol))
                    : 0u;
    } else {
      v[c][0] = in && (unsigned)w < (unsigned)W ? __ldg(p + c * vol) : 0u;
      v[c][1] = in && (unsigned)(w + 1) < (unsigned)W
                    ? __ldg(p + c * vol + 1)
                    : 0u;
    }
  }
}

template <bool EVEN>
__device__ __forceinline__ void load_tile(const uint16_t* x, int D, int H,
                                          int W, const Tile& tt,
                                          Staged<EVEN>& s) {
  const int k = threadIdx.x % 32, q = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < RI; ++i)
    load_pair<EVEN>(x, D, H, W, tt, q + 8 * i, k, q + 8 * i < SROWS,
                    s.v[i]);
  if (threadIdx.x < 2 * SROWS)
    load_pair<EVEN>(x, D, H, W, tt, threadIdx.x / 2, 32 + threadIdx.x % 2,
                    true, s.v[RI]);
}

// Pair k of staged row r to the staging buffer: its two voxels,
// channels-last (staged pixel j = pixel - (w0 - 2) at words 2j, 2j + 1),
// one 16-byte store.
template <bool EVEN>
__device__ __forceinline__ void store_pair(
    const uint32_t (&v)[4][Staged<EVEN>::N], uint32_t* stage, int r, int k) {
  uint32_t c[4];  // channel c's pixels: lo the first, hi the second
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (EVEN)
      c[i] = v[i][0];
    else
      c[i] = v[i][0] | v[i][1] << 16;
  }
  *reinterpret_cast<uint4*>(stage + r * PW + 4 * k) = make_uint4(
      __byte_perm(c[0], c[1], 0x5410), __byte_perm(c[2], c[3], 0x5410),
      __byte_perm(c[0], c[1], 0x7632), __byte_perm(c[2], c[3], 0x7632));
}

template <bool EVEN>
__device__ __forceinline__ void store_tile(const Staged<EVEN>& s,
                                           uint32_t* stage) {
  const int k = threadIdx.x % 32, q = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < RI; ++i)
    if (q + 8 * i < SROWS) store_pair<EVEN>(s.v[i], stage, q + 8 * i, k);
  if (threadIdx.x < 2 * SROWS)
    store_pair<EVEN>(s.v[RI], stage, threadIdx.x / 2, 32 + threadIdx.x % 2);
}

// d += a (16 pixels x 16, row-major) * b (16 x 8, col-major), float32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace stage4
