// The float32 route of dense3x3, designed for Hopper's CUDA cores: float32,
// Co = 32, Ci % 8 == 0, d <= 16, one or two inputs, at most two weight
// groups, the weights of every input and group resident (Ci x inputs x G
// <= 128). It computes the layer of `dense3x3.cuh`,
//   y[b,h,w,co] = sum_{ci,ky,kx} act(x[b,h+(ky-1)d,w+(kx-1)d,ci])
//                 * wt[g,ci,ky*3+kx,co]      (+ the same over x2, wt2)
// from channels-last (B, H, W, C) inputs, into channels-last or
// (B, Co, H, W) output (`Args::y_cl`), with float32 FMAs throughout: no
// TF32, so that the float32 bars, set for float32 products, hold; only
// the order of the sums differs from the plain version's.
//
// Replaces, in float32, the TPU kernels lwsnet_tpu/ops/pallas/
// refine_rows.py:_dense_kernel (the 32 -> 32 layers) and _dense2_kernel
// (the head's two-input entry), and refine.py:_dense_acc_layer_kernel's
// 32 -> 32 head halves, where the CUDA-core tiles of `dense3x3.cuh` (one
// pixel and 32 outputs a thread, 8 shared loads and an L1 tap for 32
// FMAs) ran before. Bound on the H100: operations. A 368x1232 32 -> 32
// image-layer is 8.36 GFLOP, 125 us at 66.9 TFLOP/s of float32 on the
// CUDA cores, against 35 us for its 116 MB at 3.35 TB/s.
//
// Design:
// * Persistent blocks, one per SM, walking the tiles of `dense3x3_tc.cuh`
//   (R = 4 output rows spaced d apart by TW = 64 pixels, all 32 outputs;
//   rows tiled within each class h mod d), blockIdx.x, + gridDim.x, ...
//   Warp 0 copies (one thread issues TMA), warps 1-3 activate, and two
//   consumer groups of four warps take the block's tiles in turn, so that
//   one's epilogue overlaps the other's products.
// * Resident weights: each (group, input) set as the wrapper lays it out,
//   (Ci, 9, 32) float32 (36.9 KB at Ci = 32; 73.7 KB for the towers' two
//   groups or the head entry's two inputs), one bulk copy a set, with the
//   float32 affines, once a block.
// * Staging: per job (tile, input, slab of SC = 16 or 8 channels) the copy
//   thread issues one TMA box a staged row, R + 2 = 6 rows of 64 + 2d
//   pixels (rounded up to 8), into a ring of stages on mbarriers (landed,
//   activated, read), as far ahead as the free stages allow: the next
//   tiles' copies fly during this tile's products. The ring, its copy and
//   activation loops (`stage_jobs`) are the bf16 route's, at 4-byte
//   elements; a shape whose ring holds no more stages than a tile has
//   jobs is refused (`dense_tc::ring_stages`). A pixel's SC channels
//   are 64 (or 32) bytes, 16-byte chunks swizzled by TMA's 64- (or 32-)
//   byte pattern as `tc.cuh`'s staged rows, so that eight consecutive
//   pixels' same chunk lie in eight distinct bank groups.
// * The pre-activation relu(v * a + s) is applied once per staged element
//   in shared memory, inside the image only, by the three activating
//   warps, two rows' loads in flight at a time; the zeros TMA fills in
//   outside the image are the padding, which comes after the activation.
//   The activating warps share their SMs' issue slots with the products,
//   so their work takes many times its issue time: with one activating
//   warp, or with each consumer group activating its own jobs behind a
//   group barrier, the products waited on it.
// * Products: warp o of a group computes output row o of the tile; lane
//   (p, q) = (lane % 8, lane / 8) holds a register micro-tile of 8 pixels
//   (p, p + 8, ..., p + 56) by 8 outputs (8q .. 8q + 7): 64 accumulators.
//   Per (tap, 4 channels) a lane reads 8 float4 of activations (its 8
//   pixels' 4 channels: eight consecutive pixels a load, free of bank
//   conflicts at any pixel offset kx * d) and 8 float4 of weights (4
//   channels x its 8 outputs, four addresses a warp) for 256 FMAs: each
//   value read from shared memory feeds 4 (a weight) or 8 (an activation)
//   FMAs, where the CUDA-core tile read one weight a FMA.
// * Epilogue: a lane's 8 x 8 outputs as two 16-byte channels-last vectors
//   a pixel, or (B, Co, H, W) runs of 8 pixels a channel; ragged rows
//   (h >= H) and columns (w >= W) masked at the store.
// * A clock64() split of a block (its copy thread's waits for free stages,
//   an activating thread's waits and work, a consumer's waits for
//   activated jobs, products and epilogue): off here;
//   conv3d_c8_variants.py --dense32 builds a copy with DENSE_F32_CLOCK
//   defined 1.
#pragma once

#include <algorithm>

#include "dense3x3_tc.cuh"
#include "tc.cuh"

#ifndef DENSE_F32_CLOCK
#define DENSE_F32_CLOCK 0
#endif

namespace dense_f32 {

using dense::Args;
using dense_tc::Job;
using dense_tc::R;
using dense_tc::Ring;
using dense_tc::TW;

constexpr int CO = 32;
constexpr int PX = 8, CO_T = 8;  // a lane's micro-tile: pixels x outputs
constexpr int GROUP = 128;       // a consumer group: warp o, output row o
constexpr int GROUPS = 2;
constexpr int ACTIVATORS = 96;            // warps 1-3
constexpr int STAGERS = 32 + ACTIVATORS;  // the copy warp, then those
constexpr int THREADS = STAGERS + GROUPS * GROUP;
constexpr int MIN_STAGES = 2;  // staged jobs in `dense_tc`'s ring
constexpr int MAX_D = 16;
constexpr int MAX_K = 128;  // Ci x inputs x groups of resident weights
static_assert(R * 32 == GROUP && TW == PX * 8 && CO == CO_T * 4,
              "a group's four warps cover a tile, a warp a tile row");

// Channels a staged slab: 16 (64-byte pixels) where Ci allows, else 8.
__host__ __device__ inline int slab(int Ci) { return Ci % 16 == 0 ? 16 : 8; }

__host__ __device__ inline int weight_floats(int Ci, int nin, int G) {
  return G * nin * Ci * 9 * CO;
}
__host__ __device__ inline int weight_floats(const Args& a) {
  return weight_floats(a.Ci, dense_tc::inputs(a), a.G);
}
__host__ __device__ inline int affine_floats(const Args& a) {
  return a.G * dense_tc::inputs(a) * 2 * a.Ci;
}
// The ring's stages at a shape (`dense_tc::ring_stages`; 0: refused).
__host__ __device__ inline int stages(int Ci, int d, int nin, int G) {
  const int sc = slab(Ci);
  return dense_tc::ring_stages(
      dense_tc::ring_fixed_bytes(weight_floats(Ci, nin, G) * 4,
                                 G * nin * 2 * Ci),
      sc == 16 ? dense_tc::stage_bytes<16, 4>(d)
               : dense_tc::stage_bytes<8, 4>(d),
      MIN_STAGES, nin * Ci / sc);
}

// The route's shapes; everything else in float32 takes dense3x3's CUDA-core
// tiles. Mirrored by `dense_f32_route` in ops/cuda/refine_rows.py.
__host__ __device__ inline bool use(int elem_bytes, int Ci, int Co, int d,
                                    int nin, int G) {
  return elem_bytes == 4 && Co == CO && Ci >= 8 && Ci % 8 == 0 && d >= 1 &&
         d <= MAX_D && nin >= 1 && nin <= 2 && G >= 1 && G <= 2 &&
         Ci * nin * G <= MAX_K && stages(Ci, d, nin, G) > 0;
}

// Byte offset of chunk c (4 channels) of pixel p in a staged row of SC
// channels a pixel: TMA's swizzle, as tc::chunk_offset for 2-byte
// elements of the same pixel bytes.
template <int SC>
__device__ __forceinline__ uint32_t chunk_offset(int p, int c) {
  return tc::chunk_offset<2 * SC>(p, c);
}

// The block's ring (`dense_tc::make_ring`): the weights (set, ci, tap,
// co), set = g * nin + i, from the base of its dynamic shared memory, the
// affines (set, {scale, shift}, ci) at r.asm_.
__device__ __forceinline__ Ring ring(const Args& a, unsigned char* smem,
                                     int S) {
  return dense_tc::make_ring(smem, weight_floats(a) * 4, affine_floats(a),
                             S);
}

// clock64() slots of a block, summed over its jobs or tiles: the copy
// thread's waits for free stages and the rest of its loop (decoding jobs,
// issuing copies); the first activating thread's waits for landed jobs
// and its activation; thread 0 of consumer group 0: the set-up to the
// weights' arrival, waits for activated jobs, products, epilogue, its
// tiles, and its whole run.
enum Slot { FREE_WAIT, ISSUE, LANDED_WAIT, ACTIVATION, SETUP, FULL_WAIT,
            PRODUCTS, EPILOGUE, TILES, TOTAL, SLOTS };
static_assert((int)FREE_WAIT == dense_tc::FREED &&
                  (int)ISSUE == dense_tc::ISSUED &&
                  (int)LANDED_WAIT == dense_tc::LANDED &&
                  (int)ACTIVATION == dense_tc::STAGED,
              "the staging roles' marks close the first four slots");
constexpr int CLOCK_BLOCKS = 132;
__device__ long long clk[CLOCK_BLOCKS * SLOTS];

struct Clock {
  long long t0, t, v[SLOTS];
  __device__ __forceinline__ void start() {
    if constexpr (DENSE_F32_CLOCK) {
      t0 = t = clock64();
      for (int i = 0; i < SLOTS; ++i) v[i] = 0;
    }
  }
  // The time since the last mark goes to slot s.
  __device__ __forceinline__ void mark(int s) {
    if constexpr (DENSE_F32_CLOCK) {
      const long long n = clock64();
      v[s] += n - t;
      t = n;
    }
  }
  __device__ __forceinline__ void count_tile() {
    if constexpr (DENSE_F32_CLOCK) ++v[TILES];
  }
  // This thread of block b < CLOCK_BLOCKS keeps slots `first` .. `last`.
  __device__ __forceinline__ void store(int first, int last) {
    if constexpr (DENSE_F32_CLOCK) {
      if (blockIdx.x < CLOCK_BLOCKS) {
        v[TOTAL] = clock64() - t0;
        for (int i = first; i <= last; ++i) clk[blockIdx.x * SLOTS + i] = v[i];
      }
    }
  }
};

// Activating thread w (of ACTIVATORS) activates its share of staged job
// t: relu(v * a + s) in float32, inside the image only (outside, the
// zeros TMA filled in are the padding). The thread keeps one 4-channel
// chunk c of every pixel it takes (its affine loaded once a job), pixels
// w / CPP + k * PXS of each staged row; two rows' chunks are loaded
// before any is written back, so that their latencies overlap (the
// activating warps share their SMs' issue slots with the products).
template <int SC>
__device__ __forceinline__ void activate_job(const Args& a, const Ring& r,
                                             const Job& t,
                                             unsigned char* buf, int w) {
  constexpr int CPP = SC / 4;              // float4 chunks a pixel
  constexpr int PXS = ACTIVATORS / CPP;    // pixels a pass over a row
  constexpr int KP = (TW + 2 * MAX_D + PXS - 1) / PXS;  // passes a row
  constexpr int RB = 2;                    // rows a batch
  static_assert(ACTIVATORS % CPP == 0 && (R + 2) % RB == 0, "");
  const int d = a.d, Ci = a.Ci;
  const int ROW = dense_tc::row_pixels(d) * SC * 4;
  const int npx = TW + 2 * d, c = w % CPP, q0 = w / CPP;
  const float* av =
      r.asm_ + (t.g * dense_tc::inputs(a) + t.i) * 2 * Ci + t.s * SC + 4 * c;
  const float4 sa = *(const float4*)av, ss = *(const float4*)(av + Ci);
#pragma unroll
  for (int r0 = 0; r0 < R + 2; r0 += RB) {
    float4 u[RB][KP];
    bool in[RB][KP];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int hh = dense_tc::image_row(a, t, r0 + k);
#pragma unroll
      for (int e = 0; e < KP; ++e) {
        const int q = q0 + e * PXS, ww = t.w0 - d + q;
        in[k][e] = q < npx && hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
        if (in[k][e])
          u[k][e] = *(const float4*)(buf + (r0 + k) * ROW +
                                     chunk_offset<SC>(q, c));
      }
    }
#pragma unroll
    for (int k = 0; k < RB; ++k)
#pragma unroll
      for (int e = 0; e < KP; ++e)
        if (in[k][e]) {
          float4 v = u[k][e];
          v.x = fmaxf(fmaf(v.x, sa.x, ss.x), 0.f);
          v.y = fmaxf(fmaf(v.y, sa.y, ss.y), 0.f);
          v.z = fmaxf(fmaf(v.z, sa.z, ss.z), 0.f);
          v.w = fmaxf(fmaf(v.w, sa.w, ss.w), 0.f);
          *(float4*)(buf + (r0 + k) * ROW + chunk_offset<SC>(q0 + e * PXS,
                                                            c)) = v;
        }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// One staged job's products into this lane's micro-tile: output row o of
// the tile, pixels p + 8j, outputs 8q ..; `w` the job's weights (its set
// and slab) at output 8q. Sums in the order: 8-channel group, tap
// (ky, kx), channel. The order decides the largest float32 errors: with
// the taps outside a slab's 16 channels, the seed-0 network's last
// float32 head layer read 4.88x the module's largest error from the
// float64 truth on the H100 (chip_smoke.py phase 4b), against its 3.5 bar
// (`ROUTE_BARS` in tools/parity_layers.py); groups of 8 channels keep it
// under the bar, and groups of 4 cost more time than they gain.
template <int SC>
__device__ __forceinline__ void multiply_job(float (&acc)[PX][CO_T],
                                             const unsigned char* buf,
                                             const float* w, int ROW, int d,
                                             int o, int p) {
  constexpr int CPP = SC / 4, PB = SC * 4;
  constexpr int GC = 2;  // 4-channel chunks a group
  static_assert(CPP % GC == 0, "whole groups of 8 channels");
#pragma unroll 1
  for (int g = 0; g < CPP; g += GC) {
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const int q0 = p + kx * d;  // staged pixel of j = 0
      const unsigned char* px = buf + (o + ky) * ROW + q0 * PB;
      const int sw = (q0 / (8 / CPP)) % CPP;  // the same for every j
      const float* wt = w + tap * CO;
#pragma unroll
      for (int c = 0; c < GC; ++c) {
        const int c4 = g + c;
        float4 av[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j)
          av[j] = *(const float4*)(px + j * 8 * PB + ((c4 ^ sw) << 4));
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* wp = wt + (c4 * 4 + cc) * 9 * CO;
          const float4 w0 = *(const float4*)wp;
          const float4 w1 = *(const float4*)(wp + 4);
#pragma unroll
          for (int j = 0; j < PX; ++j) {
            const float v = lane_of(av[j], cc);
            acc[j][0] = fmaf(v, w0.x, acc[j][0]);
            acc[j][1] = fmaf(v, w0.y, acc[j][1]);
            acc[j][2] = fmaf(v, w0.z, acc[j][2]);
            acc[j][3] = fmaf(v, w0.w, acc[j][3]);
            acc[j][4] = fmaf(v, w1.x, acc[j][4]);
            acc[j][5] = fmaf(v, w1.y, acc[j][5]);
            acc[j][6] = fmaf(v, w1.z, acc[j][6]);
            acc[j][7] = fmaf(v, w1.w, acc[j][7]);
          }
        }
      }
    }
  }
}

// S: the ring's stages, `stages`. map_x / map_x2: TMA maps of the inputs
// (`launch`).
template <int SC>
__global__ void __launch_bounds__(THREADS, 1)
    dense3x3_f32_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_x2, Args a,
                        int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring r = ring(a, smem, S);
  const float* wts = (const float*)smem;
  const int nin = dense_tc::inputs(a), Ci = a.Ci, d = a.d;
  const int jobs = nin * (Ci / SC);
  const int my_tiles = dense_tc::block_tiles(a);
  const int ROW = dense_tc::row_pixels(d) * SC * 4;
  const int sbytes = dense_tc::stage_bytes<SC, 4>(d);
  Clock ck;
  ck.start();
  dense_tc::init_ring(r, ACTIVATORS);
  tc::cta_sync();
  dense_tc::load_weights<THREADS>(a, Ci * 9 * CO * 4, r.wbase, r.asm_,
                                  r.weights());
  tc::cta_sync();

  if (threadIdx.x < STAGERS) {  // the copy warp, then the activating warps
    dense_tc::stage_jobs<SC, 4>(
        &map_x, &map_x2, a, r,
        [&](const Job& t, unsigned char* buf) {
          activate_job<SC>(a, r, t, buf, threadIdx.x - 32);
          tc::fence_proxy_async();  // before the next copy into the stage
        },
        [&](dense_tc::StageMark m) { ck.mark(m); });
    if (threadIdx.x == 0) {
      ck.mark(ISSUE);
      ck.store(FREE_WAIT, ISSUE);
    } else if (threadIdx.x == 32) {
      ck.store(LANDED_WAIT, ACTIVATION);
    }
    return;
  }

  const int grp = (threadIdx.x - STAGERS) / GROUP;
  const int lt = (threadIdx.x - STAGERS) % GROUP;
  const int o = lt / 32, lane = lt % 32;
  const int p = lane % 8, q = lane / 8;
  tc::mbar_wait(r.weights(), 0);
  ck.mark(SETUP);
  for (int m = grp; m < my_tiles; m += GROUPS) {
    float acc[PX][CO_T];
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int k = 0; k < CO_T; ++k) acc[j][k] = 0.f;
    Job t;
    for (int jb = 0; jb < jobs; ++jb) {
      const int n = m * jobs + jb;
      tc::mbar_wait(r.full(n), (n / S) & 1);
      ck.mark(FULL_WAIT);
      t = r.jobs[n % S];
      multiply_job<SC>(acc, r.stage0_p + (n % S) * sbytes,
                       wts + ((t.g * nin + t.i) * Ci + t.s * SC) * 9 * CO +
                           CO_T * q,
                       ROW, d, o, p);
      ck.mark(PRODUCTS);
      tc::mbar_arrive(r.empty(n));
    }
    const int h = dense_tc::image_row(a, t, o + 1);
    if (h < a.H) {
      float* y = (float*)a.y;
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int w = t.w0 + p + 8 * j;
        if (w >= a.W) continue;
        if (a.y_cl) {
          float4* px = (float4*)(y + (((size_t)t.b * a.H + h) * a.W + w) * CO +
                                 CO_T * q);
          px[0] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
          px[1] = make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
        } else {
#pragma unroll
          for (int k = 0; k < CO_T; ++k)
            y[(((size_t)t.b * CO + CO_T * q + k) * a.H + h) * a.W + w] =
                acc[j][k];
        }
      }
    }
    ck.mark(EPILOGUE);
    ck.count_tile();
  }
  if (threadIdx.x == STAGERS) ck.store(SETUP, TOTAL);
}

// Launch on `stream`: one persistent block per SM, at most one per tile,
// with the shared memory of its ring. Returns a cudaError_t (or the
// CUresult of a refused TMA map).
template <int SC>
int launch(const Args& a, cudaStream_t stream) {
  const int S = stages(a.Ci, a.d, dense_tc::inputs(a), a.G);
  if (S == 0) return (int)cudaErrorInvalidValue;
  const int smem =
      dense_tc::ring_fixed_bytes(weight_floats(a) * 4, affine_floats(a)) +
      1024 + S * dense_tc::stage_bytes<SC, 4>(a.d);
  CUtensorMap maps[2];
  const cuuint64_t dims[4] = {(cuuint64_t)a.Ci, (cuuint64_t)a.W,
                              (cuuint64_t)a.H, (cuuint64_t)a.B};
  for (int i = 0; i < dense_tc::inputs(a); ++i) {
    const int rc = tc::make_map(&maps[i], i ? a.x2 : a.x, 4, dims, SC,
                                dense_tc::row_pixels(a.d), 1, 4);
    if (rc != 0) return rc;
  }
  if (dense_tc::inputs(a) == 1) maps[1] = maps[0];
  const cudaError_t e = opt_in<dense3x3_f32_kernel<SC>>(smem);
  if (e != cudaSuccess) return (int)e;
  if (tc::sm_count() < 1) return (int)cudaErrorInvalidValue;
  const int grid = std::min(dense_tc::tiles(a), tc::sm_count());
  dense3x3_f32_kernel<SC><<<grid, THREADS, smem, stream>>>(maps[0], maps[1],
                                                           a, S);
  return (int)cudaGetLastError();
}

}  // namespace dense_f32
