// dwsep3x3: depthwise-separable dilated 3x3 layers, one layer (solo) or
// two consecutive layers in one launch (pair), with weight groups: batch b
// uses weight set g = b / (B / G).
//
// Replaces two TPU kernels of the JAX package's stage-4 refinement
// (rows_dw="vpu"), and the planar path's two (pallas_mode="layers"):
//   lwsnet_tpu/ops/pallas/refine_rows.py:_dwsep_kernel  (solo)
//   lwsnet_tpu/ops/pallas/refine_rows.py:_dwsep2_kernel (pair)
//   lwsnet_tpu/ops/pallas/refine.py:_dwsep_layer_kernel, _dwsep2_layer_kernel
// Their row canvas and mask row are TPU layout devices. A layer here is,
// per pixel, with zero padding applied after the activation:
//   act  = relu(x * a + s), rounded to the compute dtype;
//   dw_c = sum of the 9 dilated taps of channel c of act, accumulated in
//          float32 and rounded once to the compute dtype (the module path
//          rounds the depthwise conv's output there);
//   y    = pw . dw, accumulated in float32, rounded to the compute dtype.
// A pair's result equals two solo launches: layer 1's output rounded,
// layer 2's BN-affine + ReLU applied to it, rounded again and zero
// outside the image, so that layer 2's zero padding surrounds the
// activated intermediate. The CUDA-core pair computes layer 1 over the
// tile plus layer 2's halo, so its intermediate never reaches device
// memory.
//
// Bound on the H100: memory for the solo layer at 368x1232 (the grouped
// tower layer moves 116 MB for 1.2 GFLOP); the pair's recompute of its
// intermediate over the halo adds operations, not bytes.
//
// Two routes, picked by shape:
// * bf16, C = 16 or 32 -> (Cm = 32 ->) Co = 32, d <= 16, G <= 2
//   (`dwsep_tc::use`): `dwsep3x3_tc.cuh`, TMA-staged channels-last rows,
//   the depthwise taps on CUDA cores, the pointwise product on wgmma
//   tensor cores; x and y channels-last. Its pair runs both layers in one
//   cooperative launch through a channels-last scratch tensor `mid` (the
//   wrapper's) with a grid-wide barrier between them.
// * everything else (float32, and bf16 at any other C, Cm, Co >= 1, e.g.
//   a refinement of 48 or 20 channels): the CUDA-core tiles below, x
//   NCHW, y NCHW or channels-last (`y_cl`).
//
// CUDA-core design: a block of 256 threads owns a 16 x 32 output tile and
// CO_T of the Co output channels, two pixels per thread, CO_T float32
// accumulators each: CO_T = 32, 16, 8 or 4, the widest that divides Co
// (4 where none does, the last tile's extra channels zero-weighted and
// not stored), one block per (tile, channel tile). Per pass over a chunk
// of at most MK = 32 channels of the last layer's input it stages that
// chunk's taps, affine and pointwise weights in shared memory, and that
// input, activated, over the tile plus a d-pixel halo in dynamic shared
// memory (raised with cudaFuncSetAttribute), in the compute dtype; in a
// solo it is the activated input read from device memory, in a pair it is
// layer 1's output computed there (layer 1's taps read the input through
// L1; its weights are staged CK = 32 input channels at a time, once a
// pass where C <= CK, else for each round of NT staged pixels, while the
// intermediate sums stay in registers). Then each thread runs the 9 taps
// of each staged channel for its pixels and the pointwise product on CUDA
// cores, weights broadcast from shared memory. Shared memory and
// registers are bounded at any width. A pair whose intermediate takes
// more than one pass (the (8,16) pair in float32 takes two) computes
// layer 1's depthwise taps once per pass. At C, Cm, Co <= 32 the tiles
// and the order of every sum are those of the kernel's first design,
// which took 32 channels at most.
#include "dwsep3x3_tc.cuh"

namespace {

constexpr int TH = 16, TW = 32;       // output tile
constexpr int NT = 256;               // threads; (tx, ty) = (t % 32, t / 32)
constexpr int PX = TH * TW / NT;      // output pixels per thread
constexpr int MK = 32;                // last layer's input channels a pass
constexpr int CK = 32;                // a pair's layer-1 inputs a staging
// Staged-activation budget: 100 KB lets two blocks share an SM; a pair,
// which recomputes layer 1's taps on every pass, takes 200 KB and one pass.
constexpr int ACT_BYTES = 100 * 1024;

struct Args {
  const void* x;      // (B, C, H, W), C = Cs for a solo
  const float* aff0;  // pair's layer 1: (G, 2, C)
  const void* dw0;    //                 (G, C, 9)
  const void* pw0;    //                 (G, Cs, C)
  const float* aff;   // last layer: (G, 2, Cs)
  const void* dw;     //             (G, Cs, 9)
  const void* pw;     //             (G, Co, Cs)
  void* y;            // (B, Co, H, W), or (B, H, W, Co) where y_cl
  int B, G, C, Cs, Co, H, W, d0, d, mk, y_cl;
};

template <typename T>
__device__ __forceinline__ float act_round(float v, float a, float s) {
  return to_f(from_f<T>(fmaxf(fmaf(v, a, s), 0.f)));
}

template <typename T, bool PAIR, int CO_T>
__global__ void __launch_bounds__(NT, 2) dwsep3x3_kernel(Args a) {
  // This pass's pointwise weights with the output channel innermost, so a
  // thread's loop over output channels reads 16-byte vectors.
  __shared__ __align__(16) float s_pw[MK * CO_T];           // [k][co]
  __shared__ __align__(16) float s_pw0[PAIR ? CK * MK : 1];  // [c][k]
  __shared__ float s_dw[MK * 9], s_aff[2 * MK];
  __shared__ float s_dw0[PAIR ? CK * 9 : 1], s_aff0[PAIR ? 2 * CK : 1];
  extern __shared__ __align__(16) unsigned char dyn[];
  T* act = (T*)dyn;  // [mk][IH * IW]

  const int d = a.d, IW = TW + 2 * d, NI = (TH + 2 * d) * IW;
  const int n_tx = ceil_div(a.W, TW), n_ty = ceil_div(a.H, TH);
  const int n_co = ceil_div(a.Co, CO_T);
  const int w0 = (blockIdx.x % n_tx) * TW;
  const int h0 = ((blockIdx.x / n_tx) % n_ty) * TH;
  const int z = blockIdx.x / (n_tx * n_ty);
  const int co0 = (z % n_co) * CO_T;
  const int b = z / n_co;
  const int g = b / (a.B / a.G);
  const int tid = threadIdx.x, tx = tid % TW, ty = tid / TW;
  const int Cs = a.Cs, Co = a.Co, C = a.C;
  const size_t plane = (size_t)a.H * a.W;
  const T* dw0 = PAIR ? (const T*)a.dw0 + (size_t)g * C * 9 : nullptr;
  const T* pw0 = PAIR ? (const T*)a.pw0 + (size_t)g * Cs * C : nullptr;
  const float* aff0 = PAIR ? a.aff0 + (size_t)g * 2 * C : nullptr;

  // A pair's layer-1 weights of input channels c0 .. c0+nc and
  // intermediate channels m0 .. m0+nk.
  auto stage_layer1 = [&](int c0, int nc, int m0, int nk) {
    for (int i = tid; i < nc * 9; i += NT) s_dw0[i] = to_f(dw0[c0 * 9 + i]);
    for (int i = tid; i < nk * nc; i += NT)  // s_pw0[c][k]
      s_pw0[(i % nc) * MK + i / nc] =
          to_f(pw0[(size_t)(m0 + i / nc) * C + c0 + i % nc]);
    for (int i = tid; i < 2 * nc; i += NT)
      s_aff0[(i / nc) * CK + i % nc] = aff0[(i / nc) * C + c0 + i % nc];
  };

  float acc[PX][CO_T];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int co = 0; co < CO_T; ++co) acc[p][co] = 0.f;

  const T* x = (const T*)a.x + (size_t)b * C * plane;
  for (int m0 = 0; m0 < Cs; m0 += a.mk) {
    const int nk = min(a.mk, Cs - m0);
    __syncthreads();  // the last pass's readers are done
    {
      const T* dw = (const T*)a.dw + ((size_t)g * Cs + m0) * 9;
      const T* pw = (const T*)a.pw + (size_t)g * Co * Cs;
      for (int i = tid; i < nk * 9; i += NT) s_dw[i] = to_f(dw[i]);
      for (int i = tid; i < nk * CO_T; i += NT) {  // s_pw[k][co]
        const int k = i / CO_T, co = co0 + i % CO_T;
        s_pw[i] = co < Co ? to_f(pw[(size_t)co * Cs + m0 + k]) : 0.f;
      }
      for (int i = tid; i < 2 * nk; i += NT)
        s_aff[(i / nk) * MK + i % nk] =
            a.aff[((size_t)g * 2 + i / nk) * Cs + m0 + i % nk];
      if (PAIR && C <= CK) stage_layer1(0, C, m0, nk);
    }
    __syncthreads();
    // Stage channels m0 .. m0+nk of the last layer's activated input over
    // the tile and its d-pixel halo; zero outside the image.
    if constexpr (!PAIR) {
      for (int q = tid; q < NI; q += NT) {
        const int hh = h0 - d + q / IW, ww = w0 - d + q % IW;
        if (hh < 0 || hh >= a.H || ww < 0 || ww >= a.W) {
          for (int k = 0; k < nk; ++k) act[k * NI + q] = from_f<T>(0.f);
          continue;
        }
        for (int k = 0; k < nk; ++k) {
          const float v =
              to_f(x[(size_t)(m0 + k) * plane + (size_t)hh * a.W + ww]);
          act[k * NI + q] =
              from_f<T>(act_round<T>(v, s_aff[k], s_aff[MK + k]));
        }
      }
    } else {
      const int d0 = a.d0;
      for (int q0 = 0; q0 < NI; q0 += NT) {
        const int q = q0 + tid;
        const int hh = h0 - d + q / IW, ww = w0 - d + q % IW;
        const bool in =
            q < NI && hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
        float inter[MK];
#pragma unroll
        for (int k = 0; k < MK; ++k) inter[k] = 0.f;
        for (int c0 = 0; c0 < C; c0 += CK) {
          const int nc = min(CK, C - c0);
          if (C > CK) {  // the block's round: every thread takes part
            __syncthreads();
            stage_layer1(c0, nc, m0, nk);
            __syncthreads();
          }
          if (!in) continue;
          for (int c = 0; c < nc; ++c) {
            const T* xc = x + (size_t)(c0 + c) * plane;
            const float a0 = s_aff0[c], s0 = s_aff0[CK + c];
            float v = 0.f;
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
              const int hy = hh + (ky - 1) * d0;
              if (hy < 0 || hy >= a.H) continue;
#pragma unroll
              for (int kx = 0; kx < 3; ++kx) {
                const int wx = ww + (kx - 1) * d0;
                if (wx < 0 || wx >= a.W) continue;
                v = fmaf(s_dw0[c * 9 + ky * 3 + kx],
                         act_round<T>(to_f(xc[(size_t)hy * a.W + wx]), a0,
                                      s0),
                         v);
              }
            }
            v = to_f(from_f<T>(v));
#pragma unroll
            for (int k = 0; k < MK; ++k)
              if (k < nk) inter[k] = fmaf(s_pw0[c * MK + k], v, inter[k]);
          }
        }
        if (q >= NI) continue;
#pragma unroll
        for (int k = 0; k < MK; ++k)
          if (k < nk)
            act[k * NI + q] =
                in ? from_f<T>(act_round<T>(to_f(from_f<T>(inter[k])),
                                            s_aff[k], s_aff[MK + k]))
                   : from_f<T>(0.f);
      }
    }
    __syncthreads();
    // The last layer's depthwise taps and pointwise product on the staged
    // channels.
    for (int k = 0; k < nk; ++k) {
      const T* ak = act + k * NI;
      float wk[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) wk[t] = s_dw[k * 9 + t];
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int oy = ty + p * (NT / TW);
        float v = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int r = oy + (t / 3) * d, col = tx + (t % 3) * d;
          v = fmaf(wk[t], to_f(ak[r * IW + col]), v);
        }
        v = to_f(from_f<T>(v));
#pragma unroll
        for (int co = 0; co < CO_T; ++co)
          acc[p][co] = fmaf(s_pw[k * CO_T + co], v, acc[p][co]);
      }
    }
  }

  const int w = w0 + tx;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int h = h0 + ty + p * (NT / TW);
    if (h >= a.H || w >= a.W) continue;
    const size_t px = (size_t)h * a.W + w;
    T* yb = a.y_cl ? (T*)a.y + ((size_t)b * plane + px) * Co + co0
                   : (T*)a.y + ((size_t)b * Co + co0) * plane + px;
    const size_t step = a.y_cl ? 1 : plane;
#pragma unroll
    for (int co = 0; co < CO_T; ++co)
      if (co0 + co < Co) yb[co * step] = from_f<T>(acc[p][co]);
  }
}

template <typename T, bool PAIR, int CO_T>
int launch_tiles(Args a, size_t smem, void* stream) {
  auto kernel = dwsep3x3_kernel<T, PAIR, CO_T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ceil_div(a.W, TW) * ceil_div(a.H, TH) * a.B *
                    ceil_div(a.Co, CO_T);
  kernel<<<tiles, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool PAIR>
int launch(Args a, void* stream) {
  if (a.G < 1 || a.B % a.G != 0 || a.d < 1 || (PAIR && a.d0 < 1) ||
      a.C < 1 || a.Cs < 1 || a.Co < 1)
    return (int)cudaErrorInvalidValue;
  const size_t ni = (size_t)(TH + 2 * a.d) * (TW + 2 * a.d);
  const size_t budget = PAIR ? 2 * ACT_BYTES : ACT_BYTES;
  int mk = std::min(a.Cs, MK);
  while (mk > 1 && mk * ni * sizeof(T) > budget) mk = (mk + 1) / 2;
  const size_t smem = mk * ni * sizeof(T);
  if (smem > budget) return (int)cudaErrorInvalidValue;
  a.mk = mk;
  // Output-channel tiles: the widest of 32 / 16 / 8 / 4 that divides Co,
  // else 4 with the last tile masked.
  if (a.Co % 32 == 0) return launch_tiles<T, PAIR, 32>(a, smem, stream);
  if (a.Co % 16 == 0) return launch_tiles<T, PAIR, 16>(a, smem, stream);
  if (a.Co % 8 == 0) return launch_tiles<T, PAIR, 8>(a, smem, stream);
  return launch_tiles<T, PAIR, 4>(a, smem, stream);
}

// The bf16 tensor-core route where it takes the shape (x, y and the
// pair's scratch `mid` channels-last, pw as wgmma B images), else the
// CUDA-core tiles (x NCHW; y NCHW or, where y_cl, channels-last).
template <typename T, bool PAIR>
int entry(Args a, void* mid, int x_cl, void* stream) {
  if (sizeof(T) == 2 &&
      dwsep_tc::use(2, a.C, PAIR ? a.Cs : 0, a.Co, a.d0, a.d, a.G)) {
    if (!x_cl || !a.y_cl) return (int)cudaErrorInvalidValue;
    // A solo is layer 0 of dwsep_tc::Args.
    const dwsep_tc::Args t{
        a.x, {PAIR ? a.aff0 : a.aff, a.aff}, {PAIR ? a.dw0 : a.dw, a.dw},
        {PAIR ? a.pw0 : a.pw, a.pw}, mid, a.y, a.B, a.G, a.C, a.H, a.W,
        {PAIR ? a.d0 : a.d, a.d}, PAIR ? 2 : 1};
    return dwsep_tc::launch_any(t, (cudaStream_t)stream);
  }
  if (x_cl) return (int)cudaErrorInvalidValue;
  return launch<T, PAIR>(a, stream);
}

}  // namespace

#define DWSEP_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* x, const void* aff, const void* dw,        \
                      const void* pw, void* y, int B, int G, int C, int Co,  \
                      int H, int W, int d, int x_cl, int y_cl,               \
                      void* stream) {                                        \
    const Args a{x, nullptr, nullptr, nullptr, (const float*)aff, dw, pw, y, \
                 B, G, C, C, Co, H, W, 0, d, 0, y_cl};                       \
    return entry<T, false>(a, nullptr, x_cl, stream);                        \
  }

#define DWSEP_PAIR_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* x, const void* aff1, const void* dw1,      \
                      const void* pw1, const void* aff2, const void* dw2,    \
                      const void* pw2, void* y, int B, int G, int C, int Cm, \
                      int Co, int H, int W, int d1, int d2, void* mid,       \
                      int x_cl, int y_cl, void* stream) {                    \
    const Args a{x, (const float*)aff1, dw1, pw1, (const float*)aff2, dw2,   \
                 pw2, y, B, G, C, Cm, Co, H, W, d1, d2, 0, y_cl};            \
    return entry<T, true>(a, mid, x_cl, stream);                             \
  }

DWSEP_ENTRY(dwsep3x3_f32, float)
DWSEP_ENTRY(dwsep3x3_bf16, bf16)
DWSEP_PAIR_ENTRY(dwsep3x3_pair_f32, float)
DWSEP_PAIR_ENTRY(dwsep3x3_pair_bf16, bf16)
