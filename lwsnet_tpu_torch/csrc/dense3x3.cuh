// The tile code of a dense dilated 3x3 conv (padding = dilation), with an
// optional per-input-channel pre-activation, optional weight groups and an
// optional second input summed into the same accumulator. One tile is the
// work of one 256-thread block; `dense3x3.cu` launches one block per tile
// on the CUDA-core route, `chain3x3.cu` walks the tiles of several layers
// in one cooperative launch. The layer computed is
//   y[b,co,h,w] = sum_{ci,ky,kx} act(x[b,ci,h+(ky-1)d,w+(kx-1)d])
//                 * wt[g,ci,ky*3+kx,co]        (+ the same over x2, wt2)
// with act(v) = relu(v * a[g,ci] + s[g,ci]) when an affine is given, else
// v, rounded to the compute dtype as the module path rounds it; taps
// outside the image contribute zero, i.e. the zero padding comes after the
// activation, as the TPU mask row enforces. Batch b uses weight set
// g = b / (B / G).
//
// Two routes picked by shape (`use_mma`); the WMMA route reads and writes
// NCHW, the CUDA-core route also reads and writes channels-last
// (B, H, W, C) memory (`Args::x_cl`, `Args::y_cl`):
// * bf16 with Ci % 16 == 0, Co == 32 and d <= 16 (every 32->32 layer):
//   tensor cores through WMMA (mma.sync m16n16k16, float32 accumulate),
//   the route `chain3x3.cu` runs (`dense3x3.cu` runs `dense3x3_tc.cuh`). A
//   tile is 128 pixels of one image row and all 32 output channels. Per
//   chunk of 16 input channels it stages the three input rows the taps
//   read (activated once, zero-padded, channels innermost) and the chunk's
//   9 x 16 x 32 weights in shared memory, then runs the 9 taps as 9 K=16
//   products straight off the staged rows.
// * otherwise (float32, the 3-channel entry, the 1-channel output): the
//   CUDA cores. A tile is 8 x 32 pixels, one pixel per thread, with CO_T
//   output channels in float32 registers; weights and affines go through
//   shared memory in chunks of CI_CHUNK input channels. From channels-last
//   input a thread reads its taps 8 channels per 16-byte load.
#pragma once

#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace dense {

// One layer's operands. x, x2: (B, Ci, H, W) in the compute dtype; wt, wt2:
// (G, Ci, 9, Co) in the compute dtype (B images on the tensor-core route
// of `dense3x3_tc.cuh`; (G, Co, Ci, 3, 3) on dense3x3's narrow routes,
// whose blocks lay out their own); aff, aff2: (G, 2, Ci) float32 or null; y:
// (B, Co, H, W) in the output dtype. x2 == null: one input. x_cl / y_cl:
// the inputs / y lie channels-last in memory (not on the WMMA route; on
// the CUDA cores x_cl needs Ci % 8 == 0).
struct Args {
  const void* x;
  const float* aff;
  const void* wt;
  const void* x2;
  const float* aff2;
  const void* wt2;
  void* y;
  int B, G, Ci, Co, H, W, d;
  int x_cl = 0, y_cl = 0;
};

constexpr int CI_CHUNK = 16;
constexpr int MMA_M = 128;     // pixels per tile: 8 warps x 16
constexpr int MMA_K = 16;      // input channels per chunk
constexpr int MMA_N = 32;      // output channels
constexpr int MMA_THREADS = 256;
constexpr int MAX_D = 16;      // widest dilation the halo buffer holds
static_assert(MMA_THREADS == THREADS, "both routes run 256-thread blocks");

// Shared memory of each route, in bytes.
template <int CO_T>
__host__ __device__ constexpr int cuda_smem() {
  return (CI_CHUNK * 9 * CO_T + 2 * CI_CHUNK) * 4;
}
constexpr int HALO_BYTES = 3 * (MMA_M + 2 * MAX_D) * MMA_K * 2;
constexpr int BS_BYTES = 9 * MMA_K * MMA_N * 2;
constexpr int CS_BYTES = MMA_N * MMA_M * 4;
constexpr int MMA_SMEM = HALO_BYTES + BS_BYTES + CS_BYTES;

__host__ __device__ inline bool use_mma(int elem_bytes, int Ci, int Co,
                                        int d) {
  return elem_bytes == 2 && Ci % MMA_K == 0 && Co == MMA_N && d <= MAX_D;
}

// Output channels per thread on the CUDA-core route.
__host__ __device__ inline int co_tile(int Co) {
  return Co % 32 == 0 ? 32 : (Co % 8 == 0 ? 8 : 1);
}

__host__ __device__ inline int cuda_tiles(const Args& a, int co_t) {
  return ceil_div(a.W, TILE_W) * ceil_div(a.H, TILE_H) * a.B * (a.Co / co_t);
}

__host__ __device__ inline int mma_tiles(const Args& a) {
  return ceil_div(a.W, MMA_M) * a.H * a.B;
}

template <typename T>
__device__ __forceinline__ float activate(float v, float a, float s) {
  return to_f(from_f<T>(fmaxf(fmaf(v, a, s), 0.f)));
}

// ---- CUDA-core route ------------------------------------------------------

// Eight consecutive channels of one pixel of a channels-last input: one
// 16-byte vector in bf16, two in float32.
template <typename T>
struct Px8 {
  uint4 v[8 * sizeof(T) / 16];
};

__device__ __forceinline__ float px8_at(const Px8<bf16>& p, int c) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(p.v)[c / 2];
  return __uint_as_float(c % 2 ? w & 0xffff0000u : w << 16);
}
__device__ __forceinline__ float px8_at(const Px8<float>& p, int c) {
  return reinterpret_cast<const float*>(p.v)[c];
}

// XCL: x lies channels-last (Ci % 8 == 0); each thread then loads its
// pixel's taps 8 channels at a time and sums in the same order as from
// NCHW, so the two layouts give the same bits.
template <typename T, int CO_T, bool XCL>
__device__ __forceinline__ void accumulate(
    float (&acc)[CO_T], float* ws, float* as, const T* __restrict__ x,
    const float* __restrict__ aff, const T* __restrict__ wt, int b, int g,
    int Ci, int Co, int co0, int H, int W, int d, int h, int w, bool active) {
  const size_t plane = (size_t)H * W;
  for (int ci0 = 0; ci0 < Ci; ci0 += CI_CHUNK) {
    const int nci = min(CI_CHUNK, Ci - ci0);
    __syncthreads();
    for (int i = threadIdx.x; i < nci * 9 * CO_T; i += THREADS) {
      const int c = i % CO_T, row = i / CO_T;  // row = ci_local * 9 + tap
      ws[i] = to_f(wt[((size_t)g * Ci * 9 + ci0 * 9 + row) * Co + co0 + c]);
    }
    if (aff != nullptr && threadIdx.x < 2 * nci) {
      const int k = threadIdx.x / nci, c = threadIdx.x % nci;
      as[threadIdx.x] = aff[((size_t)g * 2 + k) * Ci + ci0 + c];
    }
    __syncthreads();
    if (!active) continue;
    if constexpr (XCL) {
      const T* xb = x + (size_t)b * plane * Ci + ci0;
      for (int c8 = 0; c8 < nci; c8 += 8) {
        Px8<T> px[9];
        bool in[9];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int hh = h + (tap / 3 - 1) * d, ww = w + (tap % 3 - 1) * d;
          in[tap] = hh >= 0 && hh < H && ww >= 0 && ww < W;
          if (in[tap])
            px[tap] = *reinterpret_cast<const Px8<T>*>(
                xb + ((size_t)hh * W + ww) * Ci + c8);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int cl = c8 + c;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            if (!in[tap]) continue;
            float v = px8_at(px[tap], c);
            if (aff != nullptr) v = activate<T>(v, as[cl], as[nci + cl]);
            const float* wp = ws + (cl * 9 + tap) * CO_T;
#pragma unroll
            for (int o = 0; o < CO_T; ++o) acc[o] = fmaf(v, wp[o], acc[o]);
          }
        }
      }
      continue;
    }
    for (int cl = 0; cl < nci; ++cl) {
      const T* xc = x + ((size_t)b * Ci + ci0 + cl) * plane;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int hh = h + (ky - 1) * d;
        if (hh < 0 || hh >= H) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int ww = w + (kx - 1) * d;
          if (ww < 0 || ww >= W) continue;
          float v = to_f(xc[(size_t)hh * W + ww]);
          if (aff != nullptr) v = activate<T>(v, as[cl], as[nci + cl]);
          const float* wp = ws + (cl * 9 + ky * 3 + kx) * CO_T;
#pragma unroll
          for (int c = 0; c < CO_T; ++c) acc[c] = fmaf(v, wp[c], acc[c]);
        }
      }
    }
  }
}

// Tile `tile` of `cuda_tiles(a, CO_T)`; smem holds `cuda_smem<CO_T>()`
// bytes. XCL: x and x2 lie channels-last (`Args::x_cl`).
template <typename T, typename TO, int CO_T, bool XCL = false>
__device__ void cuda_tile(const Args& a, float* smem, int tile) {
  float* ws = smem;
  float* as = smem + CI_CHUNK * 9 * CO_T;
  const int n_bx = ceil_div(a.W, TILE_W), n_by = ceil_div(a.H, TILE_H);
  const int n_co = a.Co / CO_T;
  const int bx = tile % n_bx, by = (tile / n_bx) % n_by;
  const int z = tile / (n_bx * n_by);
  const int tx = threadIdx.x % TILE_W, ty = threadIdx.x / TILE_W;
  const int w = bx * TILE_W + tx;
  const int h = by * TILE_H + ty;
  const int co0 = (z % n_co) * CO_T;
  const int b = z / n_co;
  const int g = b / (a.B / a.G);
  const bool active = h < a.H && w < a.W;

  float acc[CO_T];
#pragma unroll
  for (int c = 0; c < CO_T; ++c) acc[c] = 0.f;
  accumulate<T, CO_T, XCL>(acc, ws, as, (const T*)a.x, a.aff,
                           (const T*)a.wt, b, g, a.Ci, a.Co, co0, a.H, a.W,
                           a.d, h, w, active);
  if (a.x2 != nullptr)
    accumulate<T, CO_T, XCL>(acc, ws, as, (const T*)a.x2, a.aff2,
                             (const T*)a.wt2, b, g, a.Ci, a.Co, co0, a.H,
                             a.W, a.d, h, w, active);
  if (!active) return;
  const size_t plane = (size_t)a.H * a.W;
  if (!a.y_cl) {
    TO* yb = (TO*)a.y + ((size_t)b * a.Co + co0) * plane + (size_t)h * a.W + w;
#pragma unroll
    for (int c = 0; c < CO_T; ++c) yb[c * plane] = from_f<TO>(acc[c]);
    return;
  }
  TO* yb = (TO*)a.y + ((size_t)b * plane + (size_t)h * a.W + w) * a.Co + co0;
  if constexpr (CO_T % 8 == 0) {  // 16-byte vectors of CO_T channels
    constexpr int VEC = 16 / sizeof(TO);
#pragma unroll
    for (int c0 = 0; c0 < CO_T; c0 += VEC) {
      __align__(16) TO v[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) v[c] = from_f<TO>(acc[c0 + c]);
      *reinterpret_cast<uint4*>(yb + c0) = *reinterpret_cast<const uint4*>(v);
    }
  } else {
#pragma unroll
    for (int c = 0; c < CO_T; ++c) yb[c] = from_f<TO>(acc[c]);
  }
}

// ---- tensor-core route (bf16, Ci % 16 == 0, Co == 32, d <= 16) -----------

namespace wmma = nvcuda::wmma;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// One input's contribution. Per chunk of 16 input channels, the block
// stages the three input rows its taps read (h-d, h, h+d; columns
// w0-d .. w0+127+d), activated and zero-padded, as halo[row][col][c], and
// the chunk's weights as Bs[tap][c][co]. A tap's 16 x 16 operand for a
// warp is then the halo at column offset kx*d: row-major with ldm 16, and
// 32-byte aligned for any d because one pixel's 16 channels are 32 bytes.
// Staging puts a lane on one channel of one of two adjacent pixels, so
// the shared-memory stores are conflict-free and the global reads stay
// within two 128-byte lines per channel row.
__device__ __forceinline__ void mma_accumulate(
    AccFrag (&acc)[2], bf16* halo, bf16* Bs, const bf16* __restrict__ x,
    const float* __restrict__ aff, const bf16* __restrict__ wt, int b, int g,
    int Ci, int H, int W, int d, int h, int w0) {
  const size_t plane = (size_t)H * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % MMA_K, pix = lane / MMA_K;
  const int L = MMA_M + 2 * d;  // halo columns
  for (int ci0 = 0; ci0 < Ci; ci0 += MMA_K) {
    float a = 1.f, s = 0.f;
    if (aff != nullptr) {
      a = aff[(size_t)g * 2 * Ci + ci0 + c];
      s = aff[((size_t)g * 2 + 1) * Ci + ci0 + c];
    }
    const bf16* xc = x + ((size_t)b * Ci + ci0 + c) * plane;
    __syncthreads();
    for (int ky = 0; ky < 3; ++ky) {
      const int hh = h + (ky - 1) * d;
      const bool row_in = hh >= 0 && hh < H;
#pragma unroll 4
      for (int col = warp * 2 + pix; col < L; col += 2 * MMA_THREADS / 32) {
        const int ww = w0 - d + col;
        float v = 0.f;
        if (row_in && ww >= 0 && ww < W) {
          v = __bfloat162float(xc[(size_t)hh * W + ww]);
          if (aff != nullptr) v = activate<bf16>(v, a, s);
        }
        halo[(ky * L + col) * MMA_K + c] = __float2bfloat16(v);
      }
    }
    // Weights: 16-byte vectors of 8 output channels.
    for (int i = threadIdx.x; i < 9 * MMA_K * MMA_N / 8; i += MMA_THREADS) {
      const int n8 = i % (MMA_N / 8), rest = i / (MMA_N / 8);
      const int tap = rest % 9, k = rest / 9;
      *(uint4*)(Bs + (tap * MMA_K + k) * MMA_N + n8 * 8) = *(const uint4*)(
          wt + (((size_t)g * Ci + ci0 + k) * 9 + tap) * MMA_N + n8 * 8);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(
          fa, halo + (ky * L + warp * 16 + kx * d) * MMA_K, MMA_K);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + (tap * MMA_K) * MMA_N + j * 16,
                               MMA_N);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
}

// Tile `tile` of `mma_tiles(a)`; smem holds MMA_SMEM bytes, 32-byte
// aligned.
template <typename TO>
__device__ void mma_tile(const Args& a, unsigned char* smem, int tile) {
  bf16* halo = (bf16*)smem;
  bf16* Bs = (bf16*)(smem + HALO_BYTES);
  float* Cs = (float*)(smem + HALO_BYTES + BS_BYTES);
  const int n_wx = ceil_div(a.W, MMA_M);
  const int w0 = (tile % n_wx) * MMA_M;
  const int h = (tile / n_wx) % a.H;
  const int b = tile / (n_wx * a.H);
  const int g = b / (a.B / a.G);
  const int warp = threadIdx.x / 32;

  AccFrag acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  mma_accumulate(acc, halo, Bs, (const bf16*)a.x, a.aff, (const bf16*)a.wt,
                 b, g, a.Ci, a.H, a.W, a.d, h, w0);
  if (a.x2 != nullptr)
    mma_accumulate(acc, halo, Bs, (const bf16*)a.x2, a.aff2,
                   (const bf16*)a.wt2, b, g, a.Ci, a.H, a.W, a.d, h, w0);
  // Cs[co][p]: column-major store puts a fragment row's pixels next to
  // each other, so the NCHW writes below are coalesced.
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + j * 16 * MMA_M + warp * 16, acc[j], MMA_M,
                            wmma::mem_col_major);
  __syncthreads();
  const size_t plane = (size_t)a.H * a.W;
  TO* y = (TO*)a.y;
  for (int i = threadIdx.x; i < MMA_N * MMA_M; i += MMA_THREADS) {
    const int n = i / MMA_M, p = i % MMA_M;
    if (w0 + p < a.W)
      y[((size_t)b * MMA_N + n) * plane + (size_t)h * a.W + w0 + p] =
          from_f<TO>(Cs[i]);
  }
}

// Every tile of one layer, tiles first .. by stride, on the route its
// shape picks; smem holds max(MMA_SMEM, cuda_smem<32>()) bytes.
template <typename T, typename TO>
__device__ void layer_tiles(const Args& a, unsigned char* smem, int first,
                            int stride) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (use_mma(2, a.Ci, a.Co, a.d)) {
      for (int t = first; t < mma_tiles(a); t += stride)
        mma_tile<TO>(a, smem, t);
      return;
    }
  }
  const int co_t = co_tile(a.Co);
  const int n = cuda_tiles(a, co_t);
  float* fs = (float*)smem;
  if (co_t == 32)
    for (int t = first; t < n; t += stride) cuda_tile<T, TO, 32>(a, fs, t);
  else if (co_t == 8)
    for (int t = first; t < n; t += stride) cuda_tile<T, TO, 8>(a, fs, t);
  else
    for (int t = first; t < n; t += stride) cuda_tile<T, TO, 1>(a, fs, t);
}

}  // namespace dense
