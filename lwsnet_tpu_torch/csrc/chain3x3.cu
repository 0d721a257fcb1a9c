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
// the layers run one after another inside one cooperative launch
// (`cudaLaunchCooperativeKernel`, every block resident, each walking the
// tiles of a layer by grid stride, a grid-wide barrier between layers).
// Intermediates go through two ping-pong scratch tensors the caller
// allocates, rounded to the compute dtype as the TPU kernel rounds them.
//
// Bound on the H100: operations (the tower's 68 GFLOP against 64 MB of
// input and output at 368x1232).
//
// Two routes, picked by the stack's shapes:
// * The tensor-core route (`chain_tc::use`: bf16, every layer with whole
//   32-channel input slabs on `dense3x3_tc.cuh`'s shapes, 32 outputs or
//   at most 8 in the last layer, but a narrow entry of at most 3 input
//   channels such as the tower's 3 -> 32). One block of 512 threads an
//   SM. The narrow entry (NCHW in, channels-last out) runs first: each
//   warpgroup gathers a 64-pixel row piece's Ci x 9 taps into an A tile
//   and multiplies it by two wgmma m64n32k16 (`entry_run`). Then the
//   registers are split 88 / 168 once (`setmaxnreg`), and each role of
//   `dense3x3_tc_kernel` (TMA-staged channels-last rows, resident B
//   images, wgmma m64n32k16; m64n8k16, B padded to 8 outputs, for a last
//   layer of at most 8 such as the head's 32 -> 1) loops over the other
//   layers in its own copy of the steps: the ring's set-up (mbarriers, the
//   layer's weights by bulk copy), its part of the layer, the take-down,
//   the grid barrier. Roles that rejoined for each barrier at one register
//   count made ptxas spill in every role (2.2 KB of spill stores against
//   72 bytes) and ran 0.1-0.2 ms a layer on the H100 against 0.03-0.07
//   alone (PERF.md), so the block and grid barriers are the non-aligned
//   ones of `tc.cuh`, which threads reach from different code.
//   `fence.proxy.async` on both sides of each grid barrier orders one
//   layer's generic stores before the next one's TMA reads.
// * Everything else (float32, the other bf16 stacks): `dense3x3.cuh`'s
//   tiles on NCHW, as `dense3x3.cu`'s first design ran them (WMMA tensor
//   cores for bf16 layers with Ci % 16 == 0, Co == 32, d <= 16; CUDA cores
//   otherwise), up to two 256-thread blocks an SM,
//   `cooperative_groups::this_grid().sync()` between layers.
//
// A grid that cannot be co-resident is refused (cudaErrorCooperative-
// LaunchTooLarge); there is no fallback to launches per layer.
#include <cooperative_groups.h>

#include "dense3x3_tc.cuh"

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

// Every thread of a cooperative launch of `kernel` resident, `blocks`
// blocks at most: the grid size, or 0 with *e set.
template <typename K>
int cooperative_grid(K kernel, int threads, int smem, int blocks,
                     cudaError_t* e) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  *e = cudaGetDevice(&dev);
  if (*e == cudaSuccess)
    *e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (*e == cudaSuccess)
    *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*e == cudaSuccess)
    *e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, smem);
  if (*e != cudaSuccess) return 0;
  if (!coop) {
    *e = cudaErrorNotSupported;
    return 0;
  }
  if (per_sm < 1) {
    *e = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  return std::min(blocks, per_sm * sms);
}

template <typename T, typename TO>
int launch(const Chain& c, void* stream) {
  cudaError_t e;
  auto kernel = chain3x3_kernel<T, TO>;
  const int grid = cooperative_grid(kernel, THREADS, 0, 1 << 30, &e);
  if (grid == 0) return (int)e;
  void* params[] = {(void*)&c};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(THREADS), params, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// ---- the tensor-core route ------------------------------------------------

namespace chain_tc {

constexpr int NT = dense_tc::THREADS;  // 512: the route's block
constexpr int SC = 32;                  // channel slab of every 32-ch layer
constexpr int ENTRY_K = 32;             // a narrow entry's Ci x 9 taps, padded
constexpr int ENTRY_A = 64 * ENTRY_K * 2;  // its A tile of 64 pixels

// A layer of `dense3x3_tc.cuh`'s body: 32 outputs on its shapes, or (the
// last layer only) at most 8, zero-padded to 8 (m64n8k16).
__host__ __device__ inline bool ring_layer(int Ci, int Co, int d, int nin,
                                           int G) {
  return Ci % SC == 0 &&
         dense_tc::use(2, Ci, Co <= 8 ? tc::N : Co, d, nin, G);
}
__host__ __device__ inline bool ring_layer(const Args& a) {
  return ring_layer(a.Ci, a.Co, a.d, dense_tc::inputs(a), a.G);
}
// A narrow entry: one input of at most 3 channels, whose taps fit one
// K = 32 product, 32 outputs.
__host__ __device__ inline bool narrow_entry(int Ci, int Co, int nin) {
  return nin == 1 && Ci * 9 <= ENTRY_K && Co == tc::N;
}

// The route's stacks (mirrored by `chain_tensor_core_route` in
// ops/cuda/refine_rows.py): bf16, 2 .. MAX_LAYERS layers, each a ring
// layer (32 outputs, or at most 8 in the last layer) but a narrow entry
// in the first.
inline bool use(int elem_bytes, int n, const int* ci, const int* co,
                const int* ds, int G, bool two_input) {
  if (elem_bytes != 2 || n < 2 || n > MAX_LAYERS) return false;
  for (int i = 0; i < n; ++i) {
    const int nin = i == 0 && two_input ? 2 : 1;
    if (co[i] == tc::N || (i == n - 1 && co[i] <= 8))
      if (ring_layer(ci[i], co[i], ds[i], nin, G)) continue;
    if (i == 0 && ds[i] >= 1 && narrow_entry(ci[i], co[i], nin)) continue;
    return false;
  }
  return true;
}

// The TMA maps of the tensor-core layers' inputs: x[i] of layer i, x2 of
// layer 0.
struct Maps {
  CUtensorMap x[MAX_LAYERS];
  CUtensorMap x2;
};

// A barrier of the 128 threads of warpgroup `wg` (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("barrier.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The narrow entry, from NCHW into channels-last, on the tensor cores: each
// warpgroup takes 64-pixel pieces of output rows in turn, gathers each
// pixel's Ci x 9 taps (zero outside the image; K = ci * 9 + tap, zero
// beyond Ci * 9) into a swizzled 64 x 32 A tile and multiplies it with
// the pixel's weight group, resident as the B images of a (32, K)
// pointwise kernel (`_pw_images`), by two wgmma m64n32k16. No affine: the
// taps are the bf16 inputs, whose products are exact in float32, so only
// the order of the sums differs from `dense3x3.cuh`'s CUDA-core tiles.
__device__ __forceinline__ void entry_run(const Args& a, unsigned char* smem) {
  constexpr int SET = ENTRY_K / 16 * tc::B_SLICE;  // one group's images
  for (int e = threadIdx.x; e < a.G * SET / 16; e += NT)
    reinterpret_cast<uint4*>(smem)[e] =
        reinterpret_cast<const uint4*>(a.wt)[e];
  tc::fence_proxy_async();  // generic stores before wgmma reads them
  __syncthreads();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  unsigned char* A = smem + a.G * SET + wg * ENTRY_A;
  const uint64_t desc0 = tc::b_desc(tc::smem_addr(smem));
  const int ncx = ceil_div(a.W, dense_tc::TW), ntiles = a.B * a.H * ncx;
  const int p = tid % 64, c0 = tid / 64 * 2;  // pixel, first of two chunks
  const size_t plane = (size_t)a.H * a.W;
  const bf16* x = (const bf16*)a.x;
  bf16* y = (bf16*)a.y;
  tc::Acc acc;
  for (int t = blockIdx.x * 4 + wg; t < ntiles; t += gridDim.x * 4) {
    const int w0 = t % ncx * dense_tc::TW, h = t / ncx % a.H;
    const int b = t / (ncx * a.H), g = b / (a.B / a.G);
#pragma unroll
    for (int c = c0; c < c0 + 2; ++c) {
      uint32_t v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float f[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = c * 8 + 2 * m + e, ci = k / 9;
          const int hh = h + (k % 9 / 3 - 1) * a.d;
          const int ww = w0 + p + (k % 3 - 1) * a.d;
          f[e] = ci < a.Ci && hh >= 0 && hh < a.H && ww >= 0 && ww < a.W
                     ? to_f(x[((size_t)b * a.Ci + ci) * plane +
                              (size_t)hh * a.W + ww])
                     : 0.f;
        }
        v[m] = tc::pack_bf16(f[0], f[1]);
      }
      *reinterpret_cast<uint4*>(A + tc::chunk_offset<ENTRY_K>(p, c)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    warpgroup_sync(wg);  // the A tile written
    tc::tile_product<ENTRY_K>(acc, tc::smem_addr(A),
                              desc0 + g * SET / 16);
    warpgroup_sync(wg);  // the A tile read
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int w = w0 + warp * 16 + lane / 4 + 8 * half;
      const bool ok = w < a.W;
      bf16* px = y + (((size_t)b * a.H + h) * a.W + (ok ? w : 0)) * tc::N;
      tc::store_row<bf16>(acc, half, px, ok);
    }
  }
}

// After a layer, every thread (from its role's own copy of the step): this
// layer's generic stores (global and shared) ordered before the next
// layer's asynchronous copies, on every SM, and the grid-wide barrier.
__device__ __forceinline__ void next_layer(unsigned* bar) {
  tc::fence_proxy_async_global();
  tc::fence_proxy_async();
  tc::grid_sync(bar);
  tc::fence_proxy_async_global();
}

// The tensor-core layers [first, end) as one role: the staging warps (S)
// or the product warpgroups, each layer's ring set up and taken down by
// both roles, each in its own copy of the steps.
template <bool STAGE, typename TO>
__device__ __forceinline__ void tc_layers(const Maps& maps, const Chain& c,
                                          int first, int end,
                                          unsigned char* smem,
                                          unsigned* bar) {
  for (int i = first; i < end; ++i) {
    const Args& a = c.layer[i];
    const dense_tc::Ring r =
        dense_tc::ring(a, smem, dense_tc::stages<SC>(a));
    dense_tc::begin_layer(a, r);
    if constexpr (STAGE) {
      dense_tc::stage_layer<SC>(&maps.x[i], &maps.x2, a, r);
      __syncwarp();
    } else if (i + 1 < c.n) {
      dense_tc::multiply_layer<SC, bf16>(a, r);
    } else if (a.Co <= 8) {  // the narrow output, (B, Co, H, W)
      dense_tc::multiply_layer<SC, TO, 8>(a, r);
    } else {
      dense_tc::multiply_layer<SC, TO>(a, r);
    }
    dense_tc::end_layer(r);
    if (i + 1 < c.n) next_layer(bar);
  }
}

// TO: the last layer's output dtype; every other layer writes bf16. The
// narrow entry runs before the registers are split; from then on each warp
// keeps its role, and with it its register count, for every tensor-core
// layer, as in `dense3x3_tc_kernel`. bar: the grid barrier's two words
// (`tc::grid_sync`).
template <typename TO>
__global__ void __launch_bounds__(NT, 1)
    chain3x3_tc_kernel(const __grid_constant__ Maps maps,
                       const __grid_constant__ Chain c, unsigned* bar) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int first = 0;
  if (!ring_layer(c.layer[0])) {  // the narrow entry
    entry_run(c.layer[0], smem);
    next_layer(bar);
    first = 1;
  }
  if (threadIdx.x < dense_tc::STAGERS) {
    tc::setmaxnreg_dec<dense_tc::STAGER_REGS>();
    tc_layers<true, TO>(maps, c, first, c.n, smem, bar);
  } else {
    tc::setmaxnreg_inc<dense_tc::PRODUCT_REGS>();
    tc_layers<false, TO>(maps, c, first, c.n, smem, bar);
  }
}

// Launch on `stream`. Layer i's pointers as the C entry takes them: the
// tensor-core layers' x, x2 and y channels-last (a narrow output's y
// (B, Co, H, W)), their weights B images (a narrow output's padded to 8
// outputs); a narrow entry's x NCHW, its y channels-last, its weights
// the B images of (G, 32, K), K = Ci x 9 padded to 32.
template <typename TO>
int launch(Chain c, unsigned* bar, cudaStream_t stream) {
  if (bar == nullptr) return (int)cudaErrorInvalidValue;
  Maps maps{};
  int smem = 0, work = 0;
  for (int i = 0; i < c.n; ++i) {
    Args& a = c.layer[i];
    if (!ring_layer(a)) {  // the narrow entry
      a.x_cl = 0;
      a.y_cl = 1;
      smem = a.G * ENTRY_K / 16 * tc::B_SLICE + 4 * ENTRY_A;
      work = ceil_div(a.B * a.H * ceil_div(a.W, dense_tc::TW), 4);
      continue;
    }
    a.x_cl = a.y_cl = 1;
    const int S = dense_tc::stages<SC>(a);
    if (S == 0) return (int)cudaErrorInvalidValue;
    smem = std::max(smem, dense_tc::fixed_bytes(a) + 1024 +
                              S * dense_tc::stage_bytes<SC>(a.d));
    work = std::max(work, dense_tc::tiles(a));
    const cuuint64_t dims[4] = {(cuuint64_t)a.Ci, (cuuint64_t)a.W,
                                (cuuint64_t)a.H, (cuuint64_t)a.B};
    int rc = tc::make_map(&maps.x[i], a.x, 4, dims, SC,
                          dense_tc::row_pixels(a.d));
    if (rc == 0 && a.x2 != nullptr)
      rc = tc::make_map(&maps.x2, a.x2, 4, dims, SC,
                        dense_tc::row_pixels(a.d));
    if (rc != 0) return rc;
  }
  auto kernel = chain3x3_tc_kernel<TO>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = cooperative_grid(kernel, NT, smem, work, &e);
  if (grid == 0) return (int)e;
  void* params[] = {(void*)&maps, (void*)&c, (void*)&bar};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(NT),
                                  params, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace chain_tc

namespace {

// tc: the caller's route (`chain_tensor_core_route`), which must be the
// kernel's own.
template <typename T, typename TO>
int launch_any(const Chain& c, const int* ci, const int* co, const int* ds,
               int tc, void* bar, void* stream) {
  for (int i = 0; i < c.n; ++i) {
    const Args& a = c.layer[i];
    if (a.G < 1 || a.B % a.G != 0 || a.Ci < 1 || a.Co < 1 || a.d < 1)
      return (int)cudaErrorInvalidValue;
  }
  const bool route =
      chain_tc::use(sizeof(T), c.n, ci, co, ds, c.layer[0].G,
                    c.layer[0].x2 != nullptr);
  if (route != (tc != 0)) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (route)
      return chain_tc::launch<TO>(c, (unsigned*)bar, (cudaStream_t)stream);
  }
  return launch<T, TO>(c, stream);
}

}  // namespace

// Layer i reads xs[i] (and, for i == 0, x2 with wt2 / aff2 when x2 is not
// null) and writes ys[i]; affs[i] may be null. All layers share B, G, H, W.
// tc: the stack takes the tensor-core route (layouts as `chain_tc::launch`
// says; bar: the grid barrier's two words, `tc::grid_sync`); else every
// tensor is NCHW and the weights (G, Ci, 9, Co), and bar is not read.
#define CHAIN_ENTRY(NAME, T, TO)                                             \
  extern "C" int NAME(int n, const void* const* xs, const void* const* affs, \
                      const void* const* wts, const void* x2,                \
                      const void* aff2, const void* wt2,                     \
                      void* const* ys, const int* ci, const int* co,         \
                      const int* ds, int B, int G, int H, int W, int tc,     \
                      void* bar, void* stream) {                             \
    if (n < 1 || n > MAX_LAYERS) return (int)cudaErrorInvalidValue;         \
    Chain c{};                                                               \
    c.n = n;                                                                 \
    for (int i = 0; i < n; ++i)                                              \
      c.layer[i] = Args{xs[i], (const float*)affs[i], wts[i],                \
                        i == 0 ? x2 : nullptr,                               \
                        i == 0 ? (const float*)aff2 : nullptr,               \
                        i == 0 ? wt2 : nullptr, ys[i], B, G, ci[i], co[i],   \
                        H, W, ds[i]};                                        \
    return launch_any<T, TO>(c, ci, co, ds, tc, bar, stream);                \
  }

CHAIN_ENTRY(chain3x3_f32, float, float)
CHAIN_ENTRY(chain3x3_bf16, bf16, bf16)
CHAIN_ENTRY(chain3x3_bf16_f32out, bf16, float)
