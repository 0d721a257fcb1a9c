// chain3x3: N dense dilated 3x3 conv layers of a refinement stack in one
// launch, each with an optional BN-affine + ReLU before it; the first
// layer may take two inputs with split affines (the head's 64-channel
// entry without the concat), and the last may write float32.
//
// Replaces the TPU kernel of the JAX package's rows_dw="chain" engine:
//   lwsnet_tpu/ops/pallas/refine_rows.py:_chain_kernel
// The TPU kernel keeps every intermediate in VMEM, with a halo of whole
// canvas rows. On Hopper the tower's reach is 1+2+4+8+16 = 31 pixels on
// every side (24 for the head): a 32-channel tile with that halo does not
// fit in shared memory except at tile sizes where recompute dominates. So
// the layers run one after another inside one cooperative launch:
// `cudaLaunchCooperativeKernel` with as many blocks as can be co-resident,
// each block walking the tiles of a layer by grid stride, and
// `cooperative_groups::this_grid().sync()` between layers. Intermediates
// go through two ping-pong scratch tensors the caller allocates, rounded to
// the compute dtype as the TPU kernel rounds them. Each layer's tiles are
// `dense3x3.cuh`'s, the same code `dense3x3.cu` launches, on the route the
// layer's shape picks (WMMA tensor cores for the bf16 32->32 layers).
//
// Bound on the H100: operations (the tower's 68 GFLOP against 64 MB of
// input and output at 368x1232).
//
// A grid that cannot be co-resident is refused (cudaErrorCooperative-
// LaunchTooLarge); there is no fallback to launches per layer.
#include <cooperative_groups.h>

#include "dense3x3.cuh"

namespace {

namespace cg = cooperative_groups;
using dense::Args;

constexpr int MAX_LAYERS = 8;
constexpr int SMEM = dense::MMA_SMEM > dense::cuda_smem<32>()
                         ? dense::MMA_SMEM
                         : dense::cuda_smem<32>();

struct Chain {
  int n;
  Args layer[MAX_LAYERS];
};

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS, 2) chain3x3_kernel(Chain c) {
  __shared__ __align__(32) unsigned char smem[SMEM];
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < c.n; ++i) {
    if (i + 1 < c.n) {
      dense::layer_tiles<T, T>(c.layer[i], smem, blockIdx.x, gridDim.x);
      grid.sync();
    } else {
      dense::layer_tiles<T, TO>(c.layer[i], smem, blockIdx.x, gridDim.x);
    }
  }
}

template <typename T, typename TO>
int launch(const Chain& c, void* stream) {
  for (int i = 0; i < c.n; ++i) {
    const Args& a = c.layer[i];
    if (a.G < 1 || a.B % a.G != 0 || a.Ci < 1 || a.Co < 1 || a.d < 1)
      return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = chain3x3_kernel<T, TO>;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {(void*)&c};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms),
                                  dim3(THREADS), params, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Layer i reads xs[i] (and, for i == 0, x2 with wt2 / aff2 when x2 is not
// null) and writes ys[i]; affs[i] may be null. All layers share B, G, H, W.
#define CHAIN_ENTRY(NAME, T, TO)                                             \
  extern "C" int NAME(int n, const void* const* xs, const void* const* affs, \
                      const void* const* wts, const void* x2,                \
                      const void* aff2, const void* wt2,                     \
                      void* const* ys, const int* ci, const int* co,         \
                      const int* ds, int B, int G, int H, int W,             \
                      void* stream) {                                        \
    if (n < 1 || n > MAX_LAYERS) return (int)cudaErrorInvalidValue;         \
    Chain c{};                                                               \
    c.n = n;                                                                 \
    for (int i = 0; i < n; ++i)                                              \
      c.layer[i] = Args{xs[i], (const float*)affs[i], wts[i],                \
                        i == 0 ? x2 : nullptr,                               \
                        i == 0 ? (const float*)aff2 : nullptr,               \
                        i == 0 ? wt2 : nullptr, ys[i], B, G, ci[i], co[i],   \
                        H, W, ds[i]};                                        \
    return launch<T, TO>(c, stream);                                         \
  }

CHAIN_ENTRY(chain3x3_f32, float, float)
CHAIN_ENTRY(chain3x3_bf16, bf16, bf16)
CHAIN_ENTRY(chain3x3_bf16_f32out, bf16, float)
