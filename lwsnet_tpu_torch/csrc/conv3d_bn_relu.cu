// conv3d_bn_relu: one BN-folded 3x3x3 conv3d layer of a cost filter.
//
// Replaces two TPU kernels of the JAX package that compute this function:
//   lwsnet_tpu/ops/pallas/costfilter.py:_dgrid_kernel  (stage 1, D=24, C=32)
//   lwsnet_tpu/ops/pallas/costfilter.py:_folded_kernel (stages 2-3, D=9, C=8)
// Their flat-HW lanes, banded (D+2)*C weights and mask rows are TPU layout
// devices; here the layer is a plain NCDHW conv:
//   y[b,co,d,h,w] = relu(sum_{ci,kd,kh,kw} x[b,ci,d+kd-1,h+kh-1,w+kw-1]
//                        * wt[ci,kd*9+kh*3+kw,co] + shift[co])
// with zero padding 1 in D, H and W. The next layer's BN scale is already
// folded into wt (in float32, cast once to the compute dtype) and its shift
// into `shift`; the caller applies layer 0's BN + ReLU before the first
// launch, so padding is zero after the activation.
//
// Bound on the H100: the stage-1 32->32 layer is compute bound (9.40 GFLOP
// per launch at 368x1232); the stage-2/3 8->8 layers are memory bound.
//
// Design, two routes picked by shape:
// * bf16 with Ci % 16 == 0 and Co == 32 (the stage-1 32->32 layers, the
//   compute-bound ones): tensor cores through WMMA (mma.sync m16n16k16,
//   float32 accumulate). A block of 4 warps takes 64 pixels of one
//   (b, d, h) row and all 32 output channels. Per chunk of 16 input
//   channels it stages the 9 input rows the taps read and the chunk's
//   27 x 16 x 32 weights in shared memory, then runs the 27 taps as 27
//   K=16 products straight off the staged rows.
// * otherwise (float32, Ci = 1 entries, the C = 8 layers of stages 2-3):
//   the CUDA cores. A block takes an 8 x 32 pixel tile of one (b, d)
//   slice, one pixel per thread, with CO_T output channels in float32
//   registers. Weights go through shared memory in chunks of CI_CHUNK
//   input channels (27 * 8 * 32 floats = 27 KB), which keeps a stage-1
//   layer's 110 KB of float32 weights under the 48 KB static limit; input
//   taps are read straight from global memory, neighbouring threads on
//   neighbouring addresses, each voxel's 27 uses within a block hitting L1.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int CI_CHUNK = 8;

template <typename T, int CO_T>
__global__ void __launch_bounds__(THREADS)
conv3d_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                      const float* __restrict__ shift, T* __restrict__ y,
                      int Ci, int Co, int D, int H, int W) {
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
  T* yb = y + ((size_t)b * Co + co0) * vol + d * plane + (size_t)h * W + w;
#pragma unroll
  for (int c = 0; c < CO_T; ++c)
    yb[c * vol] = from_f<T>(fmaxf(acc[c] + shift[co0 + c], 0.f));
}

constexpr int MMA_M = 64;      // pixels per block: 4 warps x 16
constexpr int MMA_K = 16;      // input channels per chunk
constexpr int MMA_N = 32;      // output channels
constexpr int MMA_THREADS = 128;
constexpr int HALO_L = MMA_M + 2;                  // staged columns
constexpr int HALO = 9 * HALO_L * MMA_K;          // 9 (dd, hh) rows
constexpr int SMEM_BYTES = (HALO + 27 * MMA_K * MMA_N) * 2;

namespace wmma = nvcuda::wmma;

// Per chunk of 16 input channels, the block stages the 9 (d, h) input rows
// its taps read (columns w0-1 .. w0+64, zero-padded) as halo[row][col][c]
// and the chunk's weights as Bs[tap][c][co]; a tap's 64 x 16 operand is the
// halo at column offset kw: row-major with ldm 16, 32-byte aligned because
// one pixel's 16 channels are 32 bytes. The output tile reuses the same
// shared memory once the products are done (46 KB in all).
__global__ void __launch_bounds__(MMA_THREADS)
conv3d_bn_relu_mma_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ wt,
                          const float* __restrict__ shift,
                          bf16* __restrict__ y, int Ci, int D, int H, int W) {
  __shared__ __align__(32) unsigned char smem[SMEM_BYTES];
  bf16* halo = (bf16*)smem;
  bf16* Bs = halo + HALO;
  float* Cs = (float*)smem;  // after the last product
  const int w0 = blockIdx.x * MMA_M;
  const int h = blockIdx.y;
  const int d = blockIdx.z % D;
  const int b = blockIdx.z / D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % MMA_K, pix = lane / MMA_K;
  const size_t plane = (size_t)H * W;
  const size_t vol = (size_t)D * plane;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int ci0 = 0; ci0 < Ci; ci0 += MMA_K) {
    const bf16* xc = x + ((size_t)b * Ci + ci0 + c) * vol;
    __syncthreads();
    // A lane stages one channel of one of two adjacent pixels, so the
    // shared-memory stores are conflict-free.
    for (int row = 0; row < 9; ++row) {
      const int dd = d + row / 3 - 1, hh = h + row % 3 - 1;
      const bool row_in = dd >= 0 && dd < D && hh >= 0 && hh < H;
#pragma unroll 4
      for (int col = warp * 2 + pix; col < HALO_L;
           col += 2 * MMA_THREADS / 32) {
        const int ww = w0 - 1 + col;
        bf16 v = __float2bfloat16(0.f);
        if (row_in && ww >= 0 && ww < W)
          v = xc[dd * plane + (size_t)hh * W + ww];
        halo[(row * HALO_L + col) * MMA_K + c] = v;
      }
    }
    // Weights: 16-byte vectors of 8 output channels, read in source order.
    for (int i = threadIdx.x; i < 27 * MMA_K * MMA_N / 8; i += MMA_THREADS) {
      const int n8 = i % (MMA_N / 8), rest = i / (MMA_N / 8);
      const int tap = rest % 27, k = rest / 27;
      *(uint4*)(Bs + (tap * MMA_K + k) * MMA_N + n8 * 8) = *(const uint4*)(
          wt + ((size_t)(ci0 + k) * 27 + tap) * MMA_N + n8 * 8);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      const int row = tap / 3, kw = tap % 3;  // row = kd * 3 + kh
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(
          fa, halo + (row * HALO_L + warp * 16 + kw) * MMA_K, MMA_K);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + (tap * MMA_K) * MMA_N + j * 16,
                               MMA_N);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();
  // Cs[co][p]: column-major store keeps a fragment row's pixels adjacent,
  // so the NCDHW writes below are coalesced.
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + j * 16 * MMA_M + warp * 16, acc[j], MMA_M,
                            wmma::mem_col_major);
  __syncthreads();
  for (int i = threadIdx.x; i < MMA_N * MMA_M; i += MMA_THREADS) {
    const int n = i / MMA_M, q = i % MMA_M;
    if (w0 + q < W)
      y[((size_t)b * MMA_N + n) * vol + d * plane + (size_t)h * W + w0 + q] =
          __float2bfloat16(fmaxf(Cs[i] + shift[n], 0.f));
  }
}

template <typename T>
int launch(const void* x, const void* wt, const void* shift, void* y, int B,
           int Ci, int Co, int D, int H, int W, void* stream) {
  const int co_t = Co % 32 == 0 ? 32 : (Co % 8 == 0 ? 8 : 0);
  if (co_t == 0 || Ci < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (sizeof(T) == 2 && Ci % MMA_K == 0 && Co == MMA_N) {
    dim3 grid(ceil_div(W, MMA_M), H, B * D);
    conv3d_bn_relu_mma_kernel<<<grid, MMA_THREADS, 0, s>>>(
        (const bf16*)x, (const bf16*)wt, (const float*)shift, (bf16*)y, Ci,
        D, H, W);
    return (int)cudaGetLastError();
  }
  dim3 grid(ceil_div(W, TILE_W), ceil_div(H, TILE_H), B * D * (Co / co_t));
  const T* xp = (const T*)x;
  const T* wp = (const T*)wt;
  const float* sp = (const float*)shift;
  if (co_t == 32)
    conv3d_bn_relu_kernel<T, 32><<<grid, THREADS, 0, s>>>(
        xp, wp, sp, (T*)y, Ci, Co, D, H, W);
  else
    conv3d_bn_relu_kernel<T, 8><<<grid, THREADS, 0, s>>>(
        xp, wp, sp, (T*)y, Ci, Co, D, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv3d_bn_relu_f32(const void* x, const void* wt,
                                  const void* shift, void* y, int B, int Ci,
                                  int Co, int D, int H, int W, void* stream) {
  return launch<float>(x, wt, shift, y, B, Ci, Co, D, H, W, stream);
}

extern "C" int conv3d_bn_relu_bf16(const void* x, const void* wt,
                                   const void* shift, void* y, int B, int Ci,
                                   int Co, int D, int H, int W, void* stream) {
  return launch<bf16>(x, wt, shift, y, B, Ci, Co, D, H, W, stream);
}
