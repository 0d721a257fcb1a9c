// dense3x3: a dense dilated 3x3 conv (padding = dilation), with an optional
// per-input-channel pre-activation, optional weight groups, and an optional
// second input summed into the same accumulator.
//
// Replaces two TPU kernels of the JAX package's stage-4 refinement:
//   lwsnet_tpu/ops/pallas/refine_rows.py:_dense_kernel  (one input)
//   lwsnet_tpu/ops/pallas/refine_rows.py:_dense2_kernel (two inputs)
// Their row canvas, mask row and 128-lane padding are TPU layout devices.
// The two-input form is conv(concat(x, x2)) without the concat ever being
// written.
//
// Bound on the H100: memory for every refinement layer at 368x1232 (the
// 32->32 tower layer moves 116 MB for 16.7 GFLOP).
//
// Five routes, picked by shape:
// * bf16 32->32 layers (`dense_tc::use`): `dense3x3_tc.cuh`, wgmma tensor
//   cores on channels-last activations with resident weights, multi-row
//   tiles and a ring of TMA-staged rows; x, x2 and y channels-last.
// * bf16 narrow outputs, Co <= 8 (`dense_tc::use_narrow`: the refinement's
//   32->1 output conv): the same body on wgmma m64n8k16; x channels-last,
//   y (B, Co, H, W).
// * bf16 narrow entries, Ci x 9 <= 32 (`dense_entry::use`: the 3- and
//   1-channel tower entries): `dense3x3_entry.cuh`, the taps of NCHW x as
//   the K of one or two wgmma m64n32k16; y channels-last.
// * float32 32-output layers, Ci % 8 == 0 (`dense_f32::use`: the
//   refinement's float32 32 -> 32 layers and its two-input head entry):
//   `dense3x3_f32.cuh`, CUDA-core FMAs on a register micro-tile of 8
//   pixels x 8 outputs a lane, from TMA-staged channels-last rows with
//   resident weights; x and x2 channels-last, y either layout.
// * everything else (float32's narrow entries and outputs): the CUDA-core
//   tiles of `dense3x3.cuh`, one block per 8 x 32 pixel tile, reading and
//   writing NCHW or channels-last.
#include "dense3x3_entry.cuh"
#include "dense3x3_f32.cuh"
#include "dense3x3_tc.cuh"

namespace {

using dense::Args;

template <typename T, typename TO, int CO_T, bool XCL>
__global__ void __launch_bounds__(THREADS) dense3x3_kernel(Args a) {
  __shared__ float smem[dense::cuda_smem<CO_T>() / 4];
  dense::cuda_tile<T, TO, CO_T, XCL>(a, smem, blockIdx.x);
}

template <typename T, typename TO, bool XCL>
void launch_cuda(const Args& a, cudaStream_t s) {
  const int co_t = dense::co_tile(a.Co);
  const int n = dense::cuda_tiles(a, co_t);
  if (co_t == 32)
    dense3x3_kernel<T, TO, 32, XCL><<<n, THREADS, 0, s>>>(a);
  else if (co_t == 8)
    dense3x3_kernel<T, TO, 8, XCL><<<n, THREADS, 0, s>>>(a);
  else
    dense3x3_kernel<T, TO, 1, XCL><<<n, THREADS, 0, s>>>(a);
}

template <typename T, typename TO>
int launch(const Args& a, void* stream) {
  if (a.G < 1 || a.B % a.G != 0 || a.Ci < 1 || a.Co < 1 || a.d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 2) {
    const int nin = dense_tc::inputs(a);
    if (dense_tc::use(2, a.Ci, a.Co, a.d, nin, a.G)) {
      // The route reads and writes channels-last only.
      if (!a.x_cl || !a.y_cl) return (int)cudaErrorInvalidValue;
      return a.Ci % 32 == 0 ? dense_tc::launch<32, TO>(a, s)
                            : dense_tc::launch<16, TO>(a, s);
    }
    if (dense_tc::use_narrow(2, a.Ci, a.Co, a.d, nin, a.G)) {
      // Channels-last in, (B, Co, H, W) out only.
      if (!a.x_cl || a.y_cl) return (int)cudaErrorInvalidValue;
      return a.Ci % 32 == 0 ? dense_tc::launch<32, TO, 8>(a, s)
                            : dense_tc::launch<16, TO, 8>(a, s);
    }
    if (dense_entry::use(2, a.Ci, a.Co, a.d, nin, a.G)) {
      // NCHW in, channels-last out only.
      if (a.x_cl || !a.y_cl) return (int)cudaErrorInvalidValue;
      return dense_entry::launch<TO>(a, s);
    }
  } else if (dense_f32::use(4, a.Ci, a.Co, a.d, dense_tc::inputs(a), a.G)) {
    // Channels-last in only.
    if (!a.x_cl) return (int)cudaErrorInvalidValue;
    return dense_f32::slab(a.Ci) == 16 ? dense_f32::launch<16>(a, s)
                                       : dense_f32::launch<8>(a, s);
  }
  if (!a.x_cl) {
    launch_cuda<T, TO, false>(a, s);
  } else {
    // channels-last reads take whole 16-byte vectors of 8 channels
    if (a.Ci % 8 != 0) return (int)cudaErrorInvalidValue;
    launch_cuda<T, TO, true>(a, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define DENSE3X3_ENTRY(NAME, T, TO)                                          \
  extern "C" int NAME(const void* x, const void* aff, const void* wt,        \
                      const void* x2, const void* aff2, const void* wt2,     \
                      void* y, int B, int G, int Ci, int Co, int H, int W,   \
                      int d, int x_cl, int y_cl, void* stream) {             \
    const Args a{x,    (const float*)aff, wt, x2, (const float*)aff2, wt2,   \
                 y,    B, G,  Ci, Co, H, W, d, x_cl, y_cl};                  \
    return launch<T, TO>(a, stream);                                         \
  }

DENSE3X3_ENTRY(dense3x3_f32, float, float)
DENSE3X3_ENTRY(dense3x3_bf16, bf16, bf16)
DENSE3X3_ENTRY(dense3x3_bf16_f32out, bf16, float)
