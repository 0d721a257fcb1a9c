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
// activated intermediate.
//
// Bound on the H100: bytes for the solo layer at 368x1232 (a 48-channel
// tower layer, B = 2, moves 87 MB in and 87 MB out for 5.0 GFLOP); a pair
// writes its intermediate once and reads it back (its bytes beside the
// function's own in PERF.md).
//
// Two routes, picked by shape:
// * bf16, C = 16 or 32 -> (Cm = 32 ->) Co = 32, d <= 16, G <= 2
//   (`dwsep_tc::use`): `dwsep3x3_tc.cuh`, TMA-staged channels-last rows,
//   the depthwise taps on CUDA cores, the pointwise product on wgmma
//   tensor cores; x and y channels-last.
// * everything else (float32, and bf16 at any other C, Cm, Co >= 1, e.g.
//   a refinement of 48 or 20 channels): the tile body below, x NCHW, y
//   NCHW or channels-last (`y_cl`).
//
// Tile body (256 threads, persistent blocks, two an SM up to 48 channels
// in bf16; a block owns a 16 x 32 pixel tile and all Co outputs of it, so
// no input byte of a tile is staged twice and each depthwise tap runs once
// a layer):
// * Weights: a layer's taps and affines (float32) and, at Co <= 64, its
//   pointwise weights stay in shared memory, staged where a block's weight
//   group changes.
// * Depthwise: the layer's input, CH channels a round (8 in bf16 up to
//   d = 16), is read from NCHW over the tile and its halo by
//   coalesced 16-byte loads where rows allow (W a multiple of 8 in bf16,
//   the halo widened to a whole vector each side, so that a vector lies
//   all inside or all outside the image; else 2-byte loads), activated and
//   rounded once per element into shared memory; each thread then runs the
//   9 taps of each staged channel for its two pixels and keeps the rounded
//   results, 16 bytes a pixel, in `dwo`: the tile's depthwise outputs of
//   up to KC = 64 input channels (512 pixels x 48 channels: 56 KB in
//   bf16).
// * Pointwise: the output channels in chunks of NB = 32 against `dwo`.
//   bf16: mma.sync m16n8k16 on the tensor cores, each warp 64 pixels x
//   32 outputs, A and B by ldmatrix from `dwo` and the staged weights
//   (rows an odd multiple of 16 bytes apart: conflict-free; K zero-padded
//   to 16, N to 8). A product of two bf16 values is exact in float32, so
//   only the order of the float32 sums differs from the plain version.
//   float32: the CUDA cores, each thread its two pixels x 32 outputs.
//   The chunk's results are rounded into shared memory (reusing the
//   staging buffer) and written out by 16-byte stores where rows allow:
//   rows of the NCHW planes, or the pixels' channel runs of a
//   channels-last y.
// * A layer of more than KC input channels (`WIDE`) recomputes its
//   depthwise outputs once for each chunk of 32 outputs (ceil(Co / 32)
//   times), so shared memory and registers stay bounded at any C, Cm, Co.
// * Pair: one cooperative launch, every block resident; layer 1 over
//   every tile into the wrapper's NCHW scratch tensor `mid`, a grid-wide
//   barrier, layer 2 over every tile from `mid`. Layer 1 runs once per
//   intermediate pixel; `mid` costs its bytes written and read back (87 MB
//   each way for a 48-channel tower pair, more than the 50 MB L2).
// Its times beside cuDNN's and a clock64() split of a block's phases:
// PERF.md (`kernel_device_times.py --widths`, `conv3d_c8_variants.py
// --dwsep`).
#include "dwsep3x3_tc.cuh"

namespace {

constexpr int TH = 16, TW = 32;       // output tile
constexpr int NPX = TH * TW;          // its pixels
constexpr int NT = 256;               // threads; pixels (t / 32 + 8 i, t % 32)
constexpr int KC = 64;                // input channels `dwo` holds
constexpr int NB = 32;                // output channels a pointwise chunk
constexpr int SMEM_MAX = 232448;

// clock64() split of the layer body (thread 0 of each block): off here;
// conv3d_c8_variants.py --dwsep builds a copy with CLOCK = true.
constexpr bool CLOCK = false;
constexpr int CLOCK_BLOCKS = 1024;
enum Slot { STAGING, TAPS, POINTWISE, STORES, BARRIERS, GRID_BARRIER,
            TILES, TOTAL, SLOTS };
__device__ long long clk[CLOCK_BLOCKS * SLOTS];

struct Clock {
  long long t0, t, v[SLOTS];
  __device__ void start() {
    if constexpr (CLOCK) {
      t0 = t = clock64();
      for (int i = 0; i < SLOTS; ++i) v[i] = 0;
    }
  }
  // The time since the last mark goes to slot s.
  __device__ void mark(int s) {
    if constexpr (CLOCK) {
      const long long n = clock64();
      v[s] += n - t;
      t = n;
    }
  }
  __device__ void count_tile() {
    if constexpr (CLOCK) ++v[TILES];
  }
  __device__ void store() {
    if constexpr (CLOCK) {
      if (threadIdx.x == 0 && blockIdx.x < CLOCK_BLOCKS) {
        v[TOTAL] = clock64() - t0;
        for (int i = 0; i < SLOTS; ++i) clk[blockIdx.x * SLOTS + i] = v[i];
      }
    }
  }
};

__device__ __forceinline__ void block_sync(Clock& ck) {
  __syncthreads();
  ck.mark(BARRIERS);
}

// One layer: x (B, Ci, H, W) -> y (B, Co, H, W), or (B, H, W, Co) where
// y_cl.
struct Layer {
  const void* x;
  const float* aff;  // (G, 2, Ci)
  const void* dw;    // (G, Ci, 9)
  const void* pw;    // (G, Co, Ci)
  void* y;
  int Ci, Co, d, y_cl;
  int vec;  // x's rows are read as 16-byte vectors (`launch` decides)
  int vy;   // y is written as 16-byte vectors: NCHW rows, or (bf16) the
            // channels of a channels-last pixel
};

struct Args {
  Layer L[2];         // a pair: L[0] writes mid, L[1] reads it
  int layers, B, G, H, W;
  int dwo_elems, stage_elems;  // the shared-memory carve-up, in elements
};

__host__ __device__ inline int round_up(int n, int a) {
  return (n + a - 1) / a * a;
}
// Elements between two pixels' rows of `dwo` (and between two output
// channels' rows of the staged bf16 weights): bf16 an odd multiple of 16
// bytes, float32 an odd number of words.
template <typename T>
__host__ __device__ inline int dwo_stride(int Ci) {
  const int kc = Ci < KC ? Ci : KC;
  return sizeof(T) == 2 ? round_up(kc, 16) + 8 : kc + 1;
}
// The staged pointwise results of one chunk: bf16 [co][NPX + 8] or
// [px][NB + 8]; float32 [co][NPX] or [px][NB + 1].
template <typename T>
__host__ __device__ inline int out_stride(bool y_cl) {
  return sizeof(T) == 2 ? (y_cl ? NB + 8 : NPX + 8) : (y_cl ? NB + 1 : NPX);
}
template <typename T>
__host__ __device__ inline int out_elems() {
  return sizeof(T) == 2 ? NPX * (NB + 8) : NPX * (NB + 1);
}
// Elements of a 16-byte vector.
template <typename T>
constexpr int VW = 16 / sizeof(T);
// Columns staged on each side of the tile: d, or, where x's rows are read
// as 16-byte vectors, d rounded up to a whole vector.
template <typename T>
__host__ __device__ inline int halo_cols(int d, bool vec) {
  return vec ? round_up(d, VW<T>) : d;
}
template <typename T>
__host__ __device__ inline int halo_elems(int d, bool vec) {
  return (TH + 2 * d) * (TW + 2 * halo_cols<T>(d, vec));
}
// Channels staged a round, at most: 8, whose taps' results a thread
// writes to `dwo` as one 16-byte store a pixel in bf16 (16 ran 8-16 %
// slower on the H100: more registers live in the taps).
constexpr int MAX_CH = 8;
// Channels staged a round: as many as fit beside the pointwise results
// (bf16: 48 KB, 8 channels up to d = 16), at most MAX_CH, at least 1.
template <typename T>
__host__ __device__ inline int round_channels(int d, bool vec) {
  const int cap = sizeof(T) == 2 ? 24576 : out_elems<T>();
  const int n = cap / halo_elems<T>(d, vec);
  return n < 1 ? 1 : n > MAX_CH ? MAX_CH : n;
}
template <typename T>
__host__ __device__ inline int stage_elems(int d, bool vec) {
  const int n = round_channels<T>(d, vec) * halo_elems<T>(d, vec);
  return round_up(n > out_elems<T>() ? n : out_elems<T>(), 8);
}
// Output rows of the staged pointwise weights: a layer's Co (to a
// multiple of 8) where its weights stay resident (input channels <= KC,
// Co <= 2 NB), else one chunk of NB, staged for each chunk.
template <bool WIDE>
__host__ __device__ inline int pw_rows(int Co) {
  return !WIDE && Co <= 2 * NB ? round_up(Co, 8) : NB;
}
template <typename T, bool WIDE>
__host__ __device__ inline int weight_elems(int Ci, int Co) {
  return pw_rows<WIDE>(Co) * (sizeof(T) == 2 ? dwo_stride<T>(Ci) : KC);
}
constexpr int TAP_STRIDE = 12;  // floats a channel's 9 taps take: 3 float4

template <typename T>
__device__ __forceinline__ float act_round(float v, float a, float s) {
  return to_f(from_f<T>(fmaxf(fmaf(v, a, s), 0.f)));
}

__device__ __forceinline__ void mma_bf16(float& c0, float& c1, float& c2,
                                         float& c3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// act_round of each element of a 16-byte vector of x.
template <typename T>
__device__ __forceinline__ uint32_t act_word(uint32_t w, float a, float s) {
  if constexpr (sizeof(T) == 2) {
    const float lo = __uint_as_float(w << 16);
    const float hi = __uint_as_float(w & 0xffff0000u);
    return pack_bf16(fmaxf(fmaf(lo, a, s), 0.f), fmaxf(fmaf(hi, a, s), 0.f));
  } else {
    return __float_as_uint(fmaxf(fmaf(__uint_as_float(w), a, s), 0.f));
  }
}
template <typename T>
__device__ __forceinline__ uint4 act_vec(uint4 v, float a, float s) {
  return make_uint4(act_word<T>(v.x, a, s), act_word<T>(v.y, a, s),
                    act_word<T>(v.z, a, s), act_word<T>(v.w, a, s));
}

// Shared memory of a block: dwo [NPX][stride], the staging buffer (a
// round's activated input [CH][halo], then a chunk's pointwise results),
// the staged pointwise weights, the float32 taps and affines of up to KC
// channels.
template <typename T>
struct Smem {
  T* dwo;
  T* stg;
  T* pws;
  float* taps;  // [KC][TAP_STRIDE]
  float* aff;   // [2][KC]
};

// The depthwise taps and affines of input channels c0 .. c0 + kc of
// weight group g.
template <typename T>
__device__ __forceinline__ void stage_taps(const Layer& L, const Smem<T>& s,
                                           int g, int c0, int kc) {
  const T* dw = (const T*)L.dw + ((size_t)g * L.Ci + c0) * 9;
  for (int i = threadIdx.x; i < kc * 9; i += NT)
    s.taps[i / 9 * TAP_STRIDE + i % 9] = to_f(dw[i]);
  for (int i = threadIdx.x; i < 2 * kc; i += NT)
    s.aff[(i / kc) * KC + i % kc] =
        L.aff[((size_t)g * 2 + i / kc) * L.Ci + c0 + i % kc];
}

// The pointwise weights of outputs n0 .. n0 + rows and inputs c0 .. c0 +
// kc of weight group g, zero past Co and (bf16) to K's multiple of 16:
// bf16 [n][dwo_stride], float32 [k][rows].
template <typename T>
__device__ __forceinline__ void stage_pw(const Layer& L, const Smem<T>& s,
                                         int g, int c0, int kc, int n0,
                                         int rows) {
  const T* pw = (const T*)L.pw + (size_t)g * L.Co * L.Ci + c0;
  if constexpr (sizeof(T) == 2) {
    const int KR = round_up(kc, 16), KS = dwo_stride<T>(L.Ci);
    for (int i = threadIdx.x; i < rows * KR; i += NT) {
      const int n = i / KR, k = i % KR;
      s.pws[n * KS + k] = n0 + n < L.Co && k < kc
                              ? pw[(size_t)(n0 + n) * L.Ci + k]
                              : from_f<T>(0.f);
    }
  } else {
    for (int i = threadIdx.x; i < kc * rows; i += NT) {
      const int k = i / rows, n = i % rows;
      s.pws[i] = n0 + n < L.Co ? pw[(size_t)(n0 + n) * L.Ci + k] : 0.f;
    }
  }
}

// The depthwise outputs of input channels c0 .. c0 + kc of tile (b, h0,
// w0) into dwo[p][k].
template <typename T>
__device__ __forceinline__ void depthwise(const Args& a, const Layer& L,
                                          const Smem<T>& s, int b, int h0,
                                          int w0, int c0, int kc, Clock& ck) {
  const int d = L.d, Ci = L.Ci, dl = halo_cols<T>(d, L.vec);
  const int IW = TW + 2 * dl, IH = TH + 2 * d, NI = IH * IW;
  const int CH = round_channels<T>(d, L.vec), KS = dwo_stride<T>(Ci);
  const int tid = threadIdx.x, tx = tid % TW, ty = tid / TW;
  const size_t plane = (size_t)a.H * a.W;
  const T* x = (const T*)L.x + ((size_t)b * Ci + c0) * plane;

  // Each thread walks (channel, halo row, halo column) of the round, NT
  // units a step: 16-byte vectors of x's rows (L.vec: rows a whole number
  // of vectors, the halo a whole vector each side, so a vector lies all
  // inside or all outside the image), else single elements.
  const int V = L.vec ? VW<T> : 1, IWV = IW / V, NU = IH * IWV;
  // a step of NT units: step_ch channels, step_r rows, step_c columns
  const int step_ch = NT / NU, step_r = NT % NU / IWV, step_c = NT % IWV;
  constexpr int U = 4;  // units a thread loads before it stores any
  for (int cc = 0; cc < kc; cc += CH) {
    const int nc = min(CH, kc - cc), n_u = nc * IH * IWV;
    // the taps and affines staged (`stage_taps`); the last readers of
    // the staging buffer done
    block_sync(ck);
    // Stage channels cc .. cc + nc, activated and rounded, over the tile
    // and halo; zero outside the image.
    int c = tid / NU, r = tid % NU / IWV, col = tid % IWV;
    for (int q0 = tid; q0 < n_u; q0 += U * NT) {
      uint4 raw[U];
      int ch[U];
      bool in[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int hh = h0 - d + r, ww = w0 - dl + col * V;
        in[u] = q0 + u * NT < n_u && hh >= 0 && hh < a.H && ww >= 0 &&
                ww < a.W;
        const T* src = x + (size_t)(cc + c) * plane + (size_t)hh * a.W + ww;
        raw[u] = make_uint4(0, 0, 0, 0);
        if (in[u]) {
          if (L.vec)
            raw[u] = *reinterpret_cast<const uint4*>(src);
          else if constexpr (sizeof(T) == 2)
            raw[u].x = *reinterpret_cast<const unsigned short*>(src);
          else
            raw[u].x = *reinterpret_cast<const uint32_t*>(src);
        }
        ch[u] = cc + c;
        col += step_c;
        r += step_r;
        c += step_ch;
        if (col >= IWV) {
          col -= IWV;
          ++r;
        }
        if (r >= IH) {
          r -= IH;
          ++c;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u * NT;
        if (q >= n_u) continue;
        const float sa = s.aff[ch[u]], sb = s.aff[KC + ch[u]];
        if (L.vec) {
          reinterpret_cast<uint4*>(s.stg)[q] =
              in[u] ? act_vec<T>(raw[u], sa, sb) : make_uint4(0, 0, 0, 0);
        } else {
          float v = 0.f;
          if (in[u])
            v = act_round<T>(sizeof(T) == 2 ? __uint_as_float(raw[u].x << 16)
                                            : __uint_as_float(raw[u].x),
                             sa, sb);
          s.stg[q] = from_f<T>(v);
        }
      }
    }
    ck.mark(STAGING);
    block_sync(ck);
    // The 9 taps of each staged channel at this thread's two pixels, rows
    // ty and ty + 8.
    float v0[MAX_CH], v1[MAX_CH];
#pragma unroll
    for (int k = 0; k < MAX_CH; ++k) {
      v0[k] = v1[k] = 0.f;
      if (k < nc) {
        const float4* wk =
            reinterpret_cast<const float4*>(s.taps + (cc + k) * TAP_STRIDE);
        const float4 wa = wk[0], wb = wk[1], wc = wk[2];
        const float w[9] = {wa.x, wa.y, wa.z, wa.w, wb.x,
                            wb.y, wb.z, wb.w, wc.x};
        const T* ak = s.stg + k * NI + ty * IW + tx + dl - d;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int o = (t / 3) * d * IW + (t % 3) * d;
          v0[k] = fmaf(w[t], to_f(ak[o]), v0[k]);
          v1[k] = fmaf(w[t], to_f(ak[o + 8 * IW]), v1[k]);
        }
      }
    }
    T* out0 = s.dwo + (ty * TW + tx) * KS + cc;
    T* out1 = out0 + 8 * TW * KS;
#pragma unroll
    for (int k8 = 0; k8 < MAX_CH; k8 += 8) {
      if constexpr (sizeof(T) == 2) {
        if (k8 + 8 <= nc) {  // 8 channels, 16 bytes a pixel
          *reinterpret_cast<uint4*>(out0 + k8) = make_uint4(
              pack_bf16(v0[k8], v0[k8 + 1]), pack_bf16(v0[k8 + 2], v0[k8 + 3]),
              pack_bf16(v0[k8 + 4], v0[k8 + 5]),
              pack_bf16(v0[k8 + 6], v0[k8 + 7]));
          *reinterpret_cast<uint4*>(out1 + k8) = make_uint4(
              pack_bf16(v1[k8], v1[k8 + 1]), pack_bf16(v1[k8 + 2], v1[k8 + 3]),
              pack_bf16(v1[k8 + 4], v1[k8 + 5]),
              pack_bf16(v1[k8 + 6], v1[k8 + 7]));
          continue;
        }
      }
#pragma unroll
      for (int k = k8; k < k8 + 8; ++k)
        if (k < nc) {
          out0[k] = from_f<T>(v0[k]);
          out1[k] = from_f<T>(v1[k]);
        }
    }
    ck.mark(TAPS);
  }
}

// Pointwise accumulators of one chunk of NB outputs, ACC floats a thread:
// bf16, warp w's pixels 64 w .. 64 w + 63 as 4 x 4 m16n8 tiles (tile
// (mt, nt) at 16 mt + 4 nt); float32, the thread's two pixels x NB.
constexpr int ACC = 64;

// acc += dwo[:, 0 .. kc] . pw[n0 .. n0 + nb, c0 .. c0 + kc]^T, the weights
// staged by `stage_pw` (`rows` of them, output n0 at row `row0`).
template <typename T>
__device__ __forceinline__ void pointwise(const Layer& L, const Smem<T>& s,
                                          float (&acc)[ACC], int kc, int nb,
                                          int row0, int rows, Clock& ck) {
  const int KS = dwo_stride<T>(L.Ci), tid = threadIdx.x;
  block_sync(ck);  // dwo written, the weights staged
  if constexpr (sizeof(T) == 2) {
    const int lane = tid % 32, warp = tid / 32, ntn = (nb + 7) / 8;
    const uint32_t a_base = tc::smem_addr(
        s.dwo + (warp * 64 + lane % 16) * KS + (lane / 16) * 8);
    const uint32_t b_base = tc::smem_addr(
        s.pws + (row0 + (lane / 16) * 8 + lane % 8) * KS +
        ((lane / 8) % 2) * 8);
    for (int k = 0; k < kc; k += 16) {
      uint32_t bf[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r[4];
        tc::ldsm_x4(r, b_base + (h * 16 * KS + k) * 2);
        bf[2 * h][0] = r[0];
        bf[2 * h][1] = r[1];
        bf[2 * h + 1][0] = r[2];
        bf[2 * h + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        tc::ldsm_x4(af, a_base + (mt * 16 * KS + k) * 2);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (nt < ntn)
            mma_bf16(acc[mt * 16 + nt * 4], acc[mt * 16 + nt * 4 + 1],
                     acc[mt * 16 + nt * 4 + 2], acc[mt * 16 + nt * 4 + 3],
                     af, bf[nt][0], bf[nt][1]);
      }
    }
  } else {
    const int p0 = tid, p1 = tid + NT;  // rows t / 32 and t / 32 + 8
    for (int k = 0; k < kc; ++k) {
      const float x0 = to_f(s.dwo[p0 * KS + k]), x1 = to_f(s.dwo[p1 * KS + k]);
      const float4* w =
          reinterpret_cast<const float4*>(s.pws + k * rows + row0);
#pragma unroll
      for (int q = 0; q < NB / 4; ++q) {
        const float4 v = w[q];
        acc[4 * q] = fmaf(x0, v.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(x0, v.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(x0, v.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(x0, v.w, acc[4 * q + 3]);
        acc[NB + 4 * q] = fmaf(x1, v.x, acc[NB + 4 * q]);
        acc[NB + 4 * q + 1] = fmaf(x1, v.y, acc[NB + 4 * q + 1]);
        acc[NB + 4 * q + 2] = fmaf(x1, v.z, acc[NB + 4 * q + 2]);
        acc[NB + 4 * q + 3] = fmaf(x1, v.w, acc[NB + 4 * q + 3]);
      }
    }
  }
  ck.mark(POINTWISE);
}

// The chunk's results, rounded, into the staging buffer, then into y.
template <typename T>
__device__ __forceinline__ void store_chunk(const Args& a, const Layer& L,
                                            const Smem<T>& s,
                                            const float (&acc)[ACC], int b,
                                            int h0, int w0, int n0, int nb,
                                            Clock& ck) {
  const int tid = threadIdx.x, OS = out_stride<T>(L.y_cl);
  T* out = s.stg;  // the taps are done with it (the pointwise's barrier)
  if constexpr (sizeof(T) == 2) {
    const int lane = tid % 32, warp = tid / 32, ntn = (nb + 7) / 8;
    const int gr = lane / 4, tq = lane % 4;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= ntn) continue;
        const int p = warp * 64 + mt * 16 + gr, co = nt * 8 + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int pp = p + 8 * hf, i = mt * 16 + nt * 4 + 2 * hf;
          if (L.y_cl) {
            *reinterpret_cast<uint32_t*>(out + pp * OS + co) =
                pack_bf16(acc[i], acc[i + 1]);
          } else {
            out[co * OS + pp] = from_f<T>(acc[i]);
            out[(co + 1) * OS + pp] = from_f<T>(acc[i + 1]);
          }
        }
      }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = tid + i * NT;
#pragma unroll
      for (int co = 0; co < NB; ++co)
        out[L.y_cl ? p * OS + co : co * OS + p] = acc[i * NB + co];
    }
  }
  ck.mark(POINTWISE);
  block_sync(ck);
  const size_t plane = (size_t)a.H * a.W;
  T* y = (T*)L.y;
  constexpr int V = VW<T>;
  if (L.y_cl && L.vy && nb % V == 0) {  // a pixel's nb channels, by vectors
    const int per = nb / V;
    for (int e = tid; e < NPX * per; e += NT) {
      const int p = e / per, co = e % per * V;
      const int h = h0 + p / TW, w = w0 + p % TW;
      if (h < a.H && w < a.W)
        *reinterpret_cast<uint4*>(
            y + ((size_t)b * plane + (size_t)h * a.W + w) * L.Co + n0 + co) =
            *reinterpret_cast<const uint4*>(out + p * OS + co);
    }
  } else if (L.y_cl) {  // each pixel's nb channels, pixels in turn
    const int step_p = NT / nb, step_c = NT % nb;
    int p = tid / nb, co = tid % nb;
    for (int e = tid; e < NPX * nb; e += NT) {
      const int h = h0 + p / TW, w = w0 + p % TW;
      if (h < a.H && w < a.W)
        y[((size_t)b * plane + (size_t)h * a.W + w) * L.Co + n0 + co] =
            out[p * OS + co];
      p += step_p;
      co += step_c;
      if (co >= nb) {
        co -= nb;
        ++p;
      }
    }
  } else if (L.vy) {  // rows of the nb output planes, by vectors (a
                      // vector lies all inside or all outside the image)
    for (int e = tid; e < nb * (NPX / V); e += NT) {
      const int co = e / (NPX / V), p = e % (NPX / V) * V;
      const int h = h0 + p / TW, w = w0 + p % TW;
      if (h < a.H && w < a.W)
        *reinterpret_cast<uint4*>(
            y + ((size_t)b * L.Co + n0 + co) * plane + (size_t)h * a.W + w) =
            *reinterpret_cast<const uint4*>(out + co * OS + p);
    }
  } else {  // rows of the nb output planes
    for (int e = tid; e < nb * NPX; e += NT) {
      const int co = e / NPX, p = e % NPX;
      const int h = h0 + p / TW, w = w0 + p % TW;
      if (h < a.H && w < a.W)
        y[((size_t)b * L.Co + n0 + co) * plane + (size_t)h * a.W + w] =
            out[co * OS + p];
    }
  }
  ck.mark(STORES);
}

// WIDE: some layer of the launch has more than KC input channels. Else
// the layer's taps, affines and (Co <= 2 NB) pointwise weights stay
// resident in shared memory, staged again only where the weight group
// changes.
template <typename T, bool WIDE>
__device__ __forceinline__ void run_layer(const Args& a, const Layer& L,
                                          const Smem<T>& s, Clock& ck) {
  const int n_tx = ceil_div(a.W, TW), n_ty = ceil_div(a.H, TH);
  const int tiles = a.B * n_tx * n_ty;
  const int n_in = ceil_div(L.Ci, KC), n_out = ceil_div(L.Co, NB);
  const int rows = pw_rows<WIDE>(L.Co);
  const bool resident = rows >= L.Co;
  int staged = -1;  // the weight group in shared memory
  // The last launch's or layer's readers of the weights are done: every
  // thread passed a barrier after its last read of them.
  __syncthreads();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int w0 = (tile % n_tx) * TW, h0 = (tile / n_tx % n_ty) * TH;
    const int b = tile / (n_tx * n_ty), g = b / (a.B / a.G);
    if (!WIDE) {
      if (g != staged) {
        stage_taps<T>(L, s, g, 0, L.Ci);
        if (resident) stage_pw<T>(L, s, g, 0, L.Ci, 0, rows);
        staged = g;
        ck.mark(STAGING);
      }
      depthwise<T>(a, L, s, b, h0, w0, 0, L.Ci, ck);
    }
    for (int j = 0; j < n_out; ++j) {
      const int n0 = j * NB, nb = min(NB, L.Co - n0);
      float acc[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
      if constexpr (WIDE) {
        // past KC input channels, again for each chunk of outputs
        for (int i = 0; i < n_in; ++i) {
          const int c0 = i * KC, kc = min(KC, L.Ci - c0);
          stage_taps<T>(L, s, g, c0, kc);
          depthwise<T>(a, L, s, b, h0, w0, c0, kc, ck);
          stage_pw<T>(L, s, g, c0, kc, n0, NB);
          ck.mark(POINTWISE);
          pointwise<T>(L, s, acc, kc, nb, 0, NB, ck);
        }
      } else {
        if (!resident) {
          stage_pw<T>(L, s, g, 0, L.Ci, n0, NB);
          ck.mark(POINTWISE);
        }
        pointwise<T>(L, s, acc, L.Ci, nb, resident ? n0 : 0, rows, ck);
      }
      store_chunk<T>(a, L, s, acc, b, h0, w0, n0, nb, ck);
    }
    ck.count_tile();
  }
}

template <typename T, bool PAIR, bool WIDE>
__global__ void __launch_bounds__(NT, 2) dwsep3x3_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  Smem<T> s;
  s.dwo = (T*)dyn;
  s.stg = s.dwo + a.dwo_elems;
  s.pws = s.stg + a.stage_elems;
  int nw = 0;
  for (int i = 0; i < a.layers; ++i)
    nw = max(nw, weight_elems<T, WIDE>(a.L[i].Ci, a.L[i].Co));
  s.taps = (float*)(s.pws + round_up(nw, 8));
  s.aff = s.taps + KC * TAP_STRIDE;
  Clock ck;
  ck.start();
  // dwo's zero padding (K to a multiple of 16) must hold finite values.
  for (int i = threadIdx.x; i < a.dwo_elems; i += NT)
    s.dwo[i] = from_f<T>(0.f);
  run_layer<T, WIDE>(a, a.L[0], s, ck);
  if constexpr (PAIR) {
    __threadfence();  // layer 1's stores of mid, before any block reads
    cooperative_groups::this_grid().sync();
    ck.mark(GRID_BARRIER);
    run_layer<T, WIDE>(a, a.L[1], s, ck);
  }
  ck.store();
}

template <typename T, bool PAIR, bool WIDE>
int launch(Args a, void* stream) {
  int dwo = 0, stg = 0, nw = 0;
  for (int i = 0; i < a.layers; ++i) {
    Layer& L = a.L[i];
    if (L.Ci < 1 || L.Co < 1 || L.d < 1) return (int)cudaErrorInvalidValue;
    // 16-byte vectors where every row of every plane starts on one
    L.vec = a.W % VW<T> == 0 && (uintptr_t)L.x % 16 == 0;
    L.vy = (uintptr_t)L.y % 16 == 0 &&
           (L.y_cl ? sizeof(T) == 2 && L.Co % VW<T> == 0
                   : a.W % VW<T> == 0);
    dwo = std::max(dwo, round_up(NPX * dwo_stride<T>(L.Ci), 8));
    stg = std::max(stg, stage_elems<T>(L.d, L.vec));
    nw = std::max(nw, weight_elems<T, WIDE>(L.Ci, L.Co));
  }
  if (a.G < 1 || a.B % a.G != 0 || (PAIR && a.L[0].y == nullptr))
    return (int)cudaErrorInvalidValue;
  a.dwo_elems = dwo;
  a.stage_elems = stg;
  const size_t smem = (size_t)(dwo + stg + round_up(nw, 8)) * sizeof(T) +
                      KC * (TAP_STRIDE + 2) * sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = dwsep3x3_kernel<T, PAIR, WIDE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1 || tc::sm_count() < 1) return (int)cudaErrorInvalidValue;
  const int tiles = a.B * ceil_div(a.W, TW) * ceil_div(a.H, TH);
  const int grid = std::min(tiles, per_sm * tc::sm_count());
  if (!PAIR) {
    kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  void* params[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(NT),
                                  params, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The bf16 tensor-core route where it takes the shape (x, y and the
// pair's scratch `mid` channels-last, pw as wgmma B images), else the
// tile body (x and a pair's `mid` NCHW; y NCHW or, where y_cl,
// channels-last).
template <typename T, bool PAIR>
int entry(const Layer& l1, const Layer& l2, int B, int G, int H, int W,
          void* mid, int x_cl, void* stream) {
  const Layer& last = PAIR ? l2 : l1;
  if (sizeof(T) == 2 && dwsep_tc::use(2, l1.Ci, PAIR ? l2.Ci : 0, last.Co,
                                      l1.d, last.d, G)) {
    if (!x_cl || !last.y_cl) return (int)cudaErrorInvalidValue;
    // A solo is layer 0 of dwsep_tc::Args.
    const dwsep_tc::Args t{l1.x, {l1.aff, l2.aff}, {l1.dw, l2.dw},
                           {l1.pw, l2.pw}, mid, last.y, B, G, l1.Ci, H, W,
                           {l1.d, last.d}, PAIR ? 2 : 1};
    return dwsep_tc::launch_any(t, (cudaStream_t)stream);
  }
  if (x_cl) return (int)cudaErrorInvalidValue;
  const Args a{{l1, l2}, PAIR ? 2 : 1, B, G, H, W, 0, 0};
  return std::max(l1.Ci, l2.Ci) > KC ? launch<T, PAIR, true>(a, stream)
                                     : launch<T, PAIR, false>(a, stream);
}

}  // namespace

#define DWSEP_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* x, const void* aff, const void* dw,        \
                      const void* pw, void* y, int B, int G, int C, int Co,  \
                      int H, int W, int d, int x_cl, int y_cl,               \
                      void* stream) {                                        \
    const Layer l{x, (const float*)aff, dw, pw, y, C, Co, d, y_cl, 0, 0};    \
    return entry<T, false>(l, l, B, G, H, W, nullptr, x_cl, stream);         \
  }

#define DWSEP_PAIR_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* x, const void* aff1, const void* dw1,      \
                      const void* pw1, const void* aff2, const void* dw2,    \
                      const void* pw2, void* y, int B, int G, int C, int Cm, \
                      int Co, int H, int W, int d1, int d2, void* mid,       \
                      int x_cl, int y_cl, void* stream) {                    \
    const Layer l1{x, (const float*)aff1, dw1, pw1, mid, C, Cm, d1, 0, 0, 0}; \
    const Layer l2{mid, (const float*)aff2, dw2, pw2, y, Cm, Co, d2, y_cl,    \
                   0, 0};                                                    \
    return entry<T, true>(l1, l2, B, G, H, W, mid, x_cl, stream);            \
  }

DWSEP_ENTRY(dwsep3x3_f32, float)
DWSEP_ENTRY(dwsep3x3_bf16, bf16)
DWSEP_PAIR_ENTRY(dwsep3x3_pair_f32, float)
DWSEP_PAIR_ENTRY(dwsep3x3_pair_bf16, bf16)
