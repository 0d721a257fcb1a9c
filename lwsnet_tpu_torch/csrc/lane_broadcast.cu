// lane_broadcast: y[c, n] = v[c, 0], a (C, 1) column broadcast to (C, N).
//
// Replaces the probe kernel `bkernel` of the JAX package's rows microbench
// (examples/microbench_rows.py), which asked whether Mosaic could broadcast
// a (C, 1) column along the 128-wide lane axis inside a TPU kernel. On
// Hopper the question does not arise: a thread reads its row's value and
// writes it. The kernel exists so that the probe has a counterpart and the
// port's microbench line reports a launch on this card.
//
// Bound on the H100: launch latency; the bytes (C + C * N elements) are a
// few microseconds' worth at most.
//
// Design: one thread per 8 outputs of a row, each writing one 16-byte
// vector where N % 8 == 0 and the row starts 16-byte aligned, else one
// element at a time.
#include "common.cuh"

namespace {

constexpr int VEC_BYTES = 16;

template <typename T>
__global__ void lane_broadcast_kernel(const T* __restrict__ v,
                                      T* __restrict__ y, int C, int N) {
  constexpr int PER = VEC_BYTES / sizeof(T);
  const int per_row = (N + PER - 1) / PER;
  const long long total = (long long)C * per_row;
  const bool vec = N % PER == 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i / per_row), n0 = (int)(i % per_row) * PER;
    const T val = v[c];
    T* row = y + (size_t)c * N;
    if (vec) {
      __align__(16) T pack[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) pack[k] = val;
      *(uint4*)(row + n0) = *(const uint4*)pack;
    } else {
      for (int k = 0; k < PER && n0 + k < N; ++k) row[n0 + k] = val;
    }
  }
}

template <typename T>
int launch(const void* v, void* y, int C, int N, void* stream) {
  if (C < 1 || N < 1) return (int)cudaErrorInvalidValue;
  constexpr int PER = VEC_BYTES / sizeof(T);
  const long long total = (long long)C * ((N + PER - 1) / PER);
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 65535 ? want : 65535);
  lane_broadcast_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)v, (T*)y, C, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lane_broadcast_f32(const void* v, void* y, int C, int N,
                                  void* stream) {
  return launch<float>(v, y, C, N, stream);
}

extern "C" int lane_broadcast_bf16(const void* v, void* y, int C, int N,
                                   void* stream) {
  return launch<bf16>(v, y, C, N, stream);
}
