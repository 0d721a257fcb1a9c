// dense3x3: a dense dilated 3x3 conv (padding = dilation) over NCHW, with
// an optional per-input-channel pre-activation, optional weight groups, and
// an optional second input summed into the same accumulator.
//
// Replaces two TPU kernels of the JAX package's stage-4 refinement:
//   lwsnet_tpu/ops/pallas/refine_rows.py:_dense_kernel  (one input)
//   lwsnet_tpu/ops/pallas/refine_rows.py:_dense2_kernel (two inputs)
// Their row canvas, mask row and 128-lane padding are TPU layout devices;
// here the layer is the one `dense3x3.cuh` describes, one block per tile.
// The two-input form is conv(concat(x, x2)) without the concat ever being
// written.
//
// Bound on the H100: memory for every refinement layer at 368x1232 (the
// 32->32 tower layer moves 116 MB for 16.7 GFLOP).
//
// Design: the two routes of `dense3x3.cuh`, WMMA tensor cores for the bf16
// 32->32 layers and CUDA cores for the rest.
#include "dense3x3.cuh"

namespace {

using dense::Args;

template <typename T, typename TO, int CO_T>
__global__ void __launch_bounds__(THREADS) dense3x3_kernel(Args a) {
  __shared__ float smem[dense::cuda_smem<CO_T>() / 4];
  dense::cuda_tile<T, TO, CO_T>(a, smem, blockIdx.x);
}

template <typename TO>
__global__ void __launch_bounds__(dense::MMA_THREADS)
dense3x3_mma_kernel(Args a) {
  __shared__ __align__(32) unsigned char smem[dense::MMA_SMEM];
  dense::mma_tile<TO>(a, smem, blockIdx.x);
}

template <typename T, typename TO>
int launch(const Args& a, void* stream) {
  if (a.G < 1 || a.B % a.G != 0 || a.Ci < 1 || a.Co < 1 || a.d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dense::use_mma(sizeof(T), a.Ci, a.Co, a.d)) {
    dense3x3_mma_kernel<TO><<<dense::mma_tiles(a), dense::MMA_THREADS, 0,
                              s>>>(a);
    return (int)cudaGetLastError();
  }
  const int co_t = dense::co_tile(a.Co);
  const int n = dense::cuda_tiles(a, co_t);
  if (co_t == 32)
    dense3x3_kernel<T, TO, 32><<<n, THREADS, 0, s>>>(a);
  else if (co_t == 8)
    dense3x3_kernel<T, TO, 8><<<n, THREADS, 0, s>>>(a);
  else
    dense3x3_kernel<T, TO, 1><<<n, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define DENSE3X3_ENTRY(NAME, T, TO)                                          \
  extern "C" int NAME(const void* x, const void* aff, const void* wt,        \
                      const void* x2, const void* aff2, const void* wt2,     \
                      void* y, int B, int G, int Ci, int Co, int H, int W,   \
                      int d, void* stream) {                                 \
    const Args a{x, (const float*)aff, wt, x2, (const float*)aff2, wt2, y,   \
                 B, G, Ci, Co, H, W, d};                                     \
    return launch<T, TO>(a, stream);                                         \
  }

DENSE3X3_ENTRY(dense3x3_f32, float, float)
DENSE3X3_ENTRY(dense3x3_bf16, bf16, bf16)
DENSE3X3_ENTRY(dense3x3_bf16_f32out, bf16, float)
