// dense3x3: a dense dilated 3x3 conv (padding = dilation) over NCHW, with
// an optional per-input-channel pre-activation, optional weight groups, and
// an optional second input summed into the same accumulator.
//
// Replaces two TPU kernels of the JAX package's stage-4 refinement:
//   lwsnet_tpu/ops/pallas/refine_rows.py:_dense_kernel  (one input)
//   lwsnet_tpu/ops/pallas/refine_rows.py:_dense2_kernel (two inputs)
// Their row canvas, mask row and 128-lane padding are TPU layout devices;
// here the layer is
//   y[b,co,h,w] = sum_{ci,ky,kx} act(x[b,ci,h+(ky-1)d,w+(kx-1)d])
//                 * wt[g,ci,ky*3+kx,co]        (+ the same over x2, wt2)
// with act(v) = relu(v * a[g,ci] + s[g,ci]) when an affine is given, else
// v, rounded to the compute dtype as the module path rounds it; taps
// outside the image contribute zero, i.e. the zero padding comes after the
// activation, as the TPU mask row enforces. Batch b uses weight set
// g = b / (B / G). The two-input form is conv(concat(x, x2)) without the
// concat ever being written.
//
// Bound on the H100: memory for every refinement layer at 368x1232 (the
// 32->32 tower layer moves 116 MB for 16.7 GFLOP).
//
// Design, two routes picked by shape:
// * bf16 with Ci % 16 == 0, Co == 32 and d <= 16 (every 32->32 layer):
//   tensor cores through WMMA (mma.sync m16n16k16, float32 accumulate). A
//   block of 8 warps takes 128 pixels of one image row and all 32 output
//   channels. Per chunk of 16 input channels it stages the three input
//   rows the taps read (activated once, zero-padded, channels innermost)
//   and the chunk's 9 x 16 x 32 weights in shared memory, then runs the 9
//   taps as 9 K=16 products straight off the staged rows.
// * otherwise (float32, the 3-channel entry, the 1-channel output): the
//   CUDA cores. A block takes an 8 x 32 pixel tile, one pixel per thread,
//   with CO_T output channels in float32 registers; weights and affines go
//   through shared memory in chunks of CI_CHUNK input channels.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int CI_CHUNK = 16;

template <typename T>
__device__ __forceinline__ float activate(float v, float a, float s) {
  return to_f(from_f<T>(fmaxf(fmaf(v, a, s), 0.f)));
}

// ---- CUDA-core route ------------------------------------------------------

template <typename T, int CO_T>
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

template <typename T, typename TO, int CO_T>
__global__ void __launch_bounds__(THREADS)
dense3x3_kernel(const T* __restrict__ x, const float* __restrict__ aff,
                const T* __restrict__ wt, const T* __restrict__ x2,
                const float* __restrict__ aff2, const T* __restrict__ wt2,
                TO* __restrict__ y, int B, int G, int Ci, int Co, int H,
                int W, int d) {
  __shared__ float ws[CI_CHUNK * 9 * CO_T];
  __shared__ float as[2 * CI_CHUNK];
  const int tx = threadIdx.x % TILE_W, ty = threadIdx.x / TILE_W;
  const int w = blockIdx.x * TILE_W + tx;
  const int h = blockIdx.y * TILE_H + ty;
  const int n_co = Co / CO_T;
  const int co0 = (blockIdx.z % n_co) * CO_T;
  const int b = blockIdx.z / n_co;
  const int g = b / (B / G);
  const bool active = h < H && w < W;

  float acc[CO_T];
#pragma unroll
  for (int c = 0; c < CO_T; ++c) acc[c] = 0.f;
  accumulate<T, CO_T>(acc, ws, as, x, aff, wt, b, g, Ci, Co, co0, H, W, d,
                      h, w, active);
  if (x2 != nullptr)
    accumulate<T, CO_T>(acc, ws, as, x2, aff2, wt2, b, g, Ci, Co, co0, H, W,
                        d, h, w, active);
  if (!active) return;
  const size_t plane = (size_t)H * W;
  TO* yb = y + ((size_t)b * Co + co0) * plane + (size_t)h * W + w;
#pragma unroll
  for (int c = 0; c < CO_T; ++c) yb[c * plane] = from_f<TO>(acc[c]);
}

// ---- tensor-core route (bf16, Ci % 16 == 0, Co == 32, d <= 16) -----------

constexpr int MMA_M = 128;     // pixels per block: 8 warps x 16
constexpr int MMA_K = 16;      // input channels per chunk
constexpr int MMA_N = 32;      // output channels
constexpr int MMA_THREADS = 256;
constexpr int MAX_D = 16;      // widest dilation the halo buffer holds

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

template <typename TO>
__global__ void __launch_bounds__(MMA_THREADS)
dense3x3_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ aff,
                    const bf16* __restrict__ wt, const bf16* __restrict__ x2,
                    const float* __restrict__ aff2,
                    const bf16* __restrict__ wt2, TO* __restrict__ y, int B,
                    int G, int Ci, int H, int W, int d) {
  __shared__ __align__(32) bf16 halo[3 * (MMA_M + 2 * MAX_D) * MMA_K];
  __shared__ __align__(32) bf16 Bs[9 * MMA_K * MMA_N];
  __shared__ __align__(32) float Cs[MMA_N * MMA_M];
  const int w0 = blockIdx.x * MMA_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = b / (B / G);
  const int warp = threadIdx.x / 32;

  AccFrag acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  mma_accumulate(acc, halo, Bs, x, aff, wt, b, g, Ci, H, W, d, h, w0);
  if (x2 != nullptr)
    mma_accumulate(acc, halo, Bs, x2, aff2, wt2, b, g, Ci, H, W, d, h, w0);
  // Cs[co][p]: column-major store puts a fragment row's pixels next to
  // each other, so the NCHW writes below are coalesced.
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + j * 16 * MMA_M + warp * 16, acc[j], MMA_M,
                            wmma::mem_col_major);
  __syncthreads();
  const size_t plane = (size_t)H * W;
  for (int i = threadIdx.x; i < MMA_N * MMA_M; i += MMA_THREADS) {
    const int n = i / MMA_M, p = i % MMA_M;
    if (w0 + p < W)
      y[((size_t)b * MMA_N + n) * plane + (size_t)h * W + w0 + p] =
          from_f<TO>(Cs[i]);
  }
}

template <typename T, typename TO>
int launch(const void* x, const void* aff, const void* wt, const void* x2,
           const void* aff2, const void* wt2, void* y, int B, int G, int Ci,
           int Co, int H, int W, int d, void* stream) {
  if (G < 1 || B % G != 0 || Ci < 1 || Co < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (sizeof(T) == 2 && Ci % MMA_K == 0 && Co == MMA_N && d <= MAX_D) {
    dim3 grid(ceil_div(W, MMA_M), H, B);
    dense3x3_mma_kernel<TO><<<grid, MMA_THREADS, 0, s>>>(
        (const bf16*)x, (const float*)aff, (const bf16*)wt, (const bf16*)x2,
        (const float*)aff2, (const bf16*)wt2, (TO*)y, B, G, Ci, H, W, d);
    return (int)cudaGetLastError();
  }
  const int co_t = Co % 32 == 0 ? 32 : (Co % 8 == 0 ? 8 : 1);
  dim3 grid(ceil_div(W, TILE_W), ceil_div(H, TILE_H), B * (Co / co_t));
#define DENSE3X3_LAUNCH(CT)                                                 \
  dense3x3_kernel<T, TO, CT><<<grid, THREADS, 0, s>>>(                      \
      (const T*)x, (const float*)aff, (const T*)wt, (const T*)x2,           \
      (const float*)aff2, (const T*)wt2, (TO*)y, B, G, Ci, Co, H, W, d)
  if (co_t == 32)
    DENSE3X3_LAUNCH(32);
  else if (co_t == 8)
    DENSE3X3_LAUNCH(8);
  else
    DENSE3X3_LAUNCH(1);
#undef DENSE3X3_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

#define DENSE3X3_ENTRY(NAME, T, TO)                                          \
  extern "C" int NAME(const void* x, const void* aff, const void* wt,        \
                      const void* x2, const void* aff2, const void* wt2,     \
                      void* y, int B, int G, int Ci, int Co, int H, int W,   \
                      int d, void* stream) {                                 \
    return launch<T, TO>(x, aff, wt, x2, aff2, wt2, y, B, G, Ci, Co, H, W,   \
                         d, stream);                                         \
  }

DENSE3X3_ENTRY(dense3x3_f32, float, float)
DENSE3X3_ENTRY(dense3x3_bf16, bf16, bf16)
DENSE3X3_ENTRY(dense3x3_bf16_f32out, bf16, float)
