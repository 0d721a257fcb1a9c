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
// widened to float32; the softmax subtracts the minimum cost first.
//
// Bound on the H100: memory (the Ci-channel activation is read once; the
// stage-1 layer's 0.34 GFLOP is small beside 5.4 MB of reads).
//
// Design: a block takes 32 pixels of one image row. Its 8 warps split the
// D disparities between them: each thread forms one pixel's cost at its
// disparities (reads coalesced along W) into shared memory; then one warp
// runs the softmax over D for its 32 pixels. The Ci*27 weights sit in
// shared memory. No cross-block state: every pixel's D costs live in one
// block.
#include "common.cuh"

namespace {

constexpr int MAX_CI = 32;
constexpr int MAX_D = 64;
constexpr int D_LANES = THREADS / TILE_W;

template <typename T>
__global__ void __launch_bounds__(THREADS)
skip_softargmin_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                       const T* __restrict__ vol, float* __restrict__ out,
                       int Ci, int D, int H, int W, float start) {
  __shared__ float ws[MAX_CI * 27];
  __shared__ float cost[MAX_D][TILE_W];
  const int tx = threadIdx.x % TILE_W, ty = threadIdx.x / TILE_W;
  const int w = blockIdx.x * TILE_W + tx;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  for (int i = threadIdx.x; i < Ci * 27; i += THREADS) ws[i] = to_f(wt[i]);
  __syncthreads();

  const size_t plane = (size_t)H * W;
  const size_t volume = (size_t)D * plane;
  if (w < W) {
    const T* xb = x + (size_t)b * Ci * volume;
    for (int d = ty; d < D; d += D_LANES) {
      float acc = 0.f;
      for (int ci = 0; ci < Ci; ++ci) {
        const T* xc = xb + (size_t)ci * volume;
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
              acc = fmaf(to_f(xc[dd * plane + (size_t)hh * W + ww]),
                         wc[kd * 9 + kh * 3 + kw], acc);
            }
          }
        }
      }
      cost[d][tx] = acc + to_f(vol[(size_t)b * volume + d * plane +
                                   (size_t)h * W + w]);
    }
  }
  __syncthreads();
  if (ty != 0 || w >= W) return;
  float m = cost[0][tx];
  for (int d = 1; d < D; ++d) m = fminf(m, cost[d][tx]);
  float den = 0.f, num = 0.f;
  for (int d = 0; d < D; ++d) {
    const float e = expf(m - cost[d][tx]);
    den += e;
    num = fmaf(e, start + (float)d, num);
  }
  out[(size_t)b * plane + (size_t)h * W + w] = num / den;
}

template <typename T>
int launch(const void* x, const void* wt, const void* vol, void* out, int B,
           int Ci, int D, int H, int W, float start, void* stream) {
  if (Ci < 1 || Ci > MAX_CI || D < 1 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  dim3 grid(ceil_div(W, TILE_W), H, B);
  skip_softargmin_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)wt, (const T*)vol, (float*)out, Ci, D, H, W,
      start);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv3d_skip_softargmin_f32(const void* x, const void* wt,
                                          const void* vol, void* out, int B,
                                          int Ci, int D, int H, int W,
                                          float start, void* stream) {
  return launch<float>(x, wt, vol, out, B, Ci, D, H, W, start, stream);
}

extern "C" int conv3d_skip_softargmin_bf16(const void* x, const void* wt,
                                           const void* vol, void* out, int B,
                                           int Ci, int D, int H, int W,
                                           float start, void* stream) {
  return launch<bf16>(x, wt, vol, out, B, Ci, D, H, W, start, stream);
}
