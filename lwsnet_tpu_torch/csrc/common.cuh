// Shared helpers of the port's kernels: element conversions and launch
// geometry. Every kernel reads float32 or bfloat16 and accumulates in
// float32; a bfloat16 store rounds to nearest even, as torch's cast does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// A block covers TILE_H x TILE_W output pixels of one plane, one per thread.
constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int THREADS = TILE_W * TILE_H;

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
