// Hopper building blocks of the port's tensor-core routes
// (`dense3x3_tc.cuh`, `dwsep3x3_tc.cuh`, `conv3d_bn_relu.cu`,
// `chain3x3.cu`): TMA copies of channels-last rows into swizzled shared
// memory, mbarriers, bulk copies of the resident weights, ldmatrix A
// fragments, wgmma m64n32k16 (and m64n8k16) with A in registers and B (the
// resident weights) read from shared memory through a descriptor, an
// epilogue that writes 16-byte channels-last vectors straight from the
// accumulator registers, and block and grid barriers that warp-specialized
// roles reach from their own code.
//
// Staged rows. A row of pixels holds each pixel's SC channels (SC = 16
// or 32) as SC * 2 contiguous bytes, CPP = SC / 8 chunks of 16 bytes, the
// chunk order XOR-swizzled by the pixel index: TMA's 64-byte (SC = 32) or
// 32-byte (SC = 16) swizzle, which it applies to the absolute address, so
// rows start on a 512-byte boundary. Eight consecutive pixels' same chunk
// then fall in eight distinct 16-byte bank groups: ldmatrix can start a
// tap at any pixel offset (k * d) without a bank conflict. (wgmma itself
// also reads A through a swizzled descriptor at any pixel offset, with no
// base offset; both routes ran faster on the H100 with register A, which
// one ldmatrix fragment feeds to up to three or four wgmma.)
//
// Weights. One 16 (K) x 32 (N) bf16 slice of B is a 1 KB image in the
// canonical K-major layout without swizzle: eight 8 x 8 core matrices of
// 128 contiguous bytes, core (n / 8, k / 8) at (n / 8) * 256 + (k / 8) *
// 128, a core row (one n) 16 bytes of 8 consecutive k. The descriptor's
// leading offset is the K step (128 B), its stride offset the N step
// (256 B). A 16 x 8 slice (m64n8k16, a layer of at most 8 outputs) is
// the first 256 bytes of the same layout. The wrappers lay the weights out
// in global memory as these images, so a block copies them to shared
// memory in one bulk copy.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "common.cuh"

namespace tc {

constexpr int N = 32;                 // output channels of every route
constexpr int B_SLICE = 16 * N * 2;   // bytes of one K=16 slice of B

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of chunk c (8 channels) of pixel p in a staged row.
template <int SC>
__device__ __forceinline__ uint32_t chunk_offset(int p, int c) {
  constexpr int CPP = SC / 8;
  return p * (SC * 2) + ((c ^ ((p / (8 / CPP)) % CPP)) << 4);
}

// The A fragment of one warp: 16 pixels x 16 channels, four 8 x 8
// matrices (pixels 0-7 / 8-15 x channels 0-7 / 8-15), the register layout
// of mma.m16n8k16 and of wgmma's register A. `addr` is this lane's row:
// pixel lane % 16, channel half lane / 16.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// K-major B descriptor without swizzle (see the note at the top).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t LBO = 128, SBO = 256;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) |
         ((SBO >> 4) << 32);
}

// A 64 x 32 float32 accumulator: thread (warp w, lane l) holds rows
// 16w + l/4 (v[4j], v[4j+1]) and 16w + l/4 + 8 (v[4j+2], v[4j+3]) at
// columns 8j + 2(l%4) + {0, 1}.
struct Acc {
  float v[16];
};

__device__ __forceinline__ void zero(Acc& a) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a.v[i] = 0.f;
}

// Keep the compiler from moving accumulator accesses across wgmma.
__device__ __forceinline__ void fence_operand(Acc& a) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(a.v[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// d += a (64 x 16, registers, across the warpgroup) * b (16 x 32, shared).
__device__ __forceinline__ void wgmma_m64n32k16(Acc& d,
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]),
        "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
        "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11]),
        "+f"(d.v[12]), "+f"(d.v[13]), "+f"(d.v[14]), "+f"(d.v[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// A 64 x 8 float32 accumulator: thread (warp w, lane l) holds rows
// 16w + l/4 (v[0], v[1]) and 16w + l/4 + 8 (v[2], v[3]) at columns
// 2(l%4) + {0, 1}.
struct Acc8 {
  float v[4];
};

__device__ __forceinline__ void zero(Acc8& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.v[i] = 0.f;
}

__device__ __forceinline__ void fence_operand(Acc8& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(a.v[i])::"memory");
}

// d += a (64 x 16, registers) * b (16 x 8, shared: one core matrix column
// of the K-major image, 256 bytes a 16-deep slice).
__device__ __forceinline__ void wgmma_m64n8k16(Acc8& d, const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// acc = the A tile at `a_tile` (64 pixels x SC channels, swizzled as a
// staged row) times the SC / 16 B images from descriptor `desc` on; one
// warpgroup (the dw-sep route's pointwise product, the chain's entry).
template <int SC>
__device__ __forceinline__ void tile_product(Acc& acc, uint32_t a_tile,
                                             uint64_t desc) {
  constexpr int KC = SC / 16;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  uint32_t f[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldsm_x4(f[kc], a_tile + chunk_offset<SC>(warp * 16 + lane % 16,
                                             kc * 2 + lane / 16));
  zero(acc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    wgmma_m64n32k16(acc, f[kc], desc + kc * (B_SLICE >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(acc);
}

// Within each quad of lanes (one accumulator row), lane t holds word j of
// column block j; afterwards it holds word i of lane i's block t, i.e.
// its block's words in column order. A 4 x 4 transpose in two butterfly
// rounds: swap the off-diagonal 2 x 2 blocks with lane t ^ 2, then the
// off-diagonal words of each 2 x 2 block with lane t ^ 1.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4]) {
  const bool hi = threadIdx.x & 2, odd = threadIdx.x & 1;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
  if (hi) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  r1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  if (odd) {
    v[0] = r0;
    v[2] = r1;
  } else {
    v[1] = r0;
    v[3] = r1;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// relu(v * a + s) of the 8 bf16 channels in u, in float32 with one bf16
// rounding per element.
__device__ __forceinline__ uint4 activate8(uint4 u, const float (&sa)[8],
                                           const float (&ss)[8]) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float lo = __uint_as_float(w[m] << 16);
    const float hi = __uint_as_float(w[m] & 0xffff0000u);
    w[m] = pack_bf16(fmaxf(fmaf(lo, sa[2 * m], ss[2 * m]), 0.f),
                     fmaxf(fmaf(hi, sa[2 * m + 1], ss[2 * m + 1]), 0.f));
  }
  return u;
}

// The 8 bf16 channels in u as float32.
__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v[2 * m] = __uint_as_float(w[m] << 16);
    v[2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
  }
}

// Order this thread's (and, after a barrier, the block's) generic-proxy
// accesses to shared memory before later asynchronous (TMA) copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The same for global memory: this thread's generic-proxy writes before
// later TMA reads (after a grid-wide barrier, on any SM).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// One 16-byte vector to global memory; `stream`: evict-first
// (st.global.cs), for a write stream no later load of this launch reads.
template <typename V>
__device__ __forceinline__ void store16(V* p, V v, bool stream) {
  if (stream)
    __stcs(p, v);
  else
    *p = v;
}

// Write the accumulator's rows `half` (0: l/4, 1: l/4 + 8) as channels-last
// vectors: row pixel -> out_row + 32 channels; channels 8t .. 8t+7 of the
// row go to this lane (t = l % 4). Every lane of the warp must call it;
// `store` masks the write; `stream` as `store16`'s.
template <typename TO>
__device__ __forceinline__ void store_row(const Acc& a, int half, TO* px,
                                          bool store, bool stream = false);

template <>
__device__ __forceinline__ void store_row<bf16>(const Acc& a, int half,
                                                bf16* px, bool store,
                                                bool stream) {
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = pack_bf16(a.v[4 * j + 2 * half], a.v[4 * j + 2 * half + 1]);
  quad_transpose(v);
  if (store)
    store16(reinterpret_cast<uint4*>(px + 8 * (threadIdx.x % 4)),
            make_uint4(v[0], v[1], v[2], v[3]), stream);
}

template <>
__device__ __forceinline__ void store_row<float>(const Acc& a, int half,
                                                 float* px, bool store,
                                                 bool stream) {
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = __float_as_uint(a.v[4 * j + 2 * half]);
    hi[j] = __float_as_uint(a.v[4 * j + 2 * half + 1]);
  }
  quad_transpose(lo);
  quad_transpose(hi);
  if (store) {
    float4* p = reinterpret_cast<float4*>(px + 8 * (threadIdx.x % 4));
    store16(p, make_float4(__uint_as_float(lo[0]), __uint_as_float(hi[0]),
                           __uint_as_float(lo[1]), __uint_as_float(hi[1])),
            stream);
    store16(p + 1,
            make_float4(__uint_as_float(lo[2]), __uint_as_float(hi[2]),
                        __uint_as_float(lo[3]), __uint_as_float(hi[3])),
            stream);
  }
}

// mbarriers in shared memory: `count` arrivals complete a phase; a waiter
// names the parity of the phase it waits for.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
// Before the memory of an mbarrier holds anything else (or a new one).
__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// A barrier of every thread of the block that threads may reach from
// different places in the code (warp-specialized roles each running their
// own copy of a step): the non-aligned form of __syncthreads.
__device__ __forceinline__ void cta_sync() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

// A barrier of every thread of every block of a cooperative launch (all
// blocks resident), reachable from different places in the code as
// `cta_sync`. `bar`: two words in global memory, arrivals and generation,
// the arrivals 0 before the first barrier on them (each barrier leaves
// them so); one pair per stream, so that launches on it never overlap.
// Memory ordering: every thread's earlier writes reach every thread's
// later reads, through the block barriers and thread 0's fences around
// its arrival, as cooperative_groups' grid barrier orders them.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  cta_sync();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  cta_sync();
}

// Hand registers back to / take them from the block's pool, per thread,
// for the rest of a warpgroup's run (all its threads execute it).
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Arrive on `bar` and expect `bytes` more of asynchronous copies on it.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// One TMA box of `map` at coordinates (innermost first) into shared
// memory at `dst`, completing `bytes` of `bar`'s transaction count;
// positions outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing that many bytes of `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (no link to libcuda); nullptr where it is missing.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = (EncodeTiled)fn;
  }
  return encode;
}

// A TMA map of a channels-last tensor whose dims[0] = C channels are
// innermost (dims and byte strides innermost first, `rank` <= 5), of bf16
// or, with `elem_bytes` 4, float32 elements: boxes of SC channels x
// `pixels` pixels x `rows` of dims[2] x 1 of every outer dim, swizzled as
// the staged rows are (see the note at the top; a pixel of SC x
// `elem_bytes` = 64 bytes takes the 64-byte swizzle, of 32 the 32-byte
// one), zeros outside the tensor. Returns a CUresult.
inline int make_map(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dims, int SC, int pixels,
                    int rows = 1, int elem_bytes = 2) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  cuuint64_t strides[4];
  cuuint64_t stride = elem_bytes;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t box[5] = {(cuuint32_t)SC, (cuuint32_t)pixels,
                             (cuuint32_t)rows, 1, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return (int)encode(map,
                     elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     rank, const_cast<void*>(base), dims, strides, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     SC * elem_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A TMA map of a channels-last bf16 tensor of 8 channels, (B, D, H, W, 8),
// whose boxes are `depths` x `rows` staged rows of `pixels` voxels each,
// dense in that order, unswizzled, zeros outside the tensor. Each voxel's
// 16 bytes go as two 8-byte elements of one innermost run of W * 2: TMA
// moves a box one innermost run at a time, and with the 8 channels as
// their own innermost dimension those runs are 16 bytes each (the
// stage-3 8->8 launch ran about 19 % slower so on the H100,
// `conv3d_c8_variants.py`). A box's innermost dimension is at most 256
// elements: 128 voxels. Returns a CUresult.
inline int make_voxel_map(CUtensorMap* map, const void* base, int B, int D,
                          int H, int W, int pixels, int rows, int depths) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)W * 2, (cuuint64_t)H,
                              (cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t strides[3] = {dims[0] * 8, dims[0] * 8 * H,
                                 dims[0] * 8 * H * D};
  const cuuint32_t box[4] = {(cuuint32_t)pixels * 2, (cuuint32_t)rows,
                             (cuuint32_t)depths, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 4,
                     const_cast<void*>(base), dims, strides, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Number of SMs of the current device (read once).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

}  // namespace tc
