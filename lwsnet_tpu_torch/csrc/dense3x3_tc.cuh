// The tensor-core route of dense3x3, redesigned for Hopper: bf16, Co = 32,
// Ci % 16 == 0, d <= 16, with the weights of every input and weight group
// resident (Ci x inputs x G <= 128). It computes the layer of
// `dense3x3.cuh`,
//   y[b,h,w,co] = sum_{ci,ky,kx} act(x[b,h+(ky-1)d,w+(kx-1)d,ci])
//                 * wt[g,ci,ky*3+kx,co]      (+ the same over x2, wt2)
// on channels-last (B, H, W, C) activations, in and out; and, on the same
// shapes with one input and Co <= 8 (`use_narrow`), the narrow output
// layer, written (B, Co, H, W).
//
// Replaces the TPU kernels lwsnet_tpu/ops/pallas/refine_rows.py:
// _dense_kernel and _dense2_kernel (and the 32->32 layers of
// lwsnet_tpu/ops/pallas/refine.py:_dense_acc_layer_kernel; its 32->1
// output, refine.py:_dense_vpu_layer_kernel). Bound on the H100: bytes. A
// 368x1232 tower layer (B = 2) moves 116 MB (34.66 us at 3.35 TB/s) for
// 16.7 GFLOP (16.9 us at 989 TFLOP/s); the 32->1 output (B = 1) reads 29
// MB and writes 1.8 MB in float32 (9.20 us).
//
// Design (all on the H100's 227 KB of shared memory a block may opt into):
// * Persistent blocks, one per SM, each walking tiles blockIdx.x,
//   + gridDim.x, ... Four warpgroups, specialized: warp 0 copies (one
//   thread issues TMA), warps 1-7 activate, warpgroups 2 and 3 multiply
//   and write, taking the block's tiles in turn, so that one's epilogue
//   overlaps the other's products and both overlap the next tiles' copies.
//   `setmaxnreg` gives the staging warps 88 registers a thread and the
//   product warps 168.
// * Resident weights: every (group, input, 16-channel chunk, tap) 16 x 32
//   slice as a 1 KB wgmma B image (`tc.cuh`; laid out by the wrapper), 18
//   KB per 32-channel input and weight group, 36 KB for the towers' two
//   groups or the head entry's two inputs, one bulk copy per set, with
//   the float32 affines, once per block.
// * Tile: R = 4 output rows spaced d apart (h, h+d, h+2d, h+3d) by TW = 64
//   pixels, all 32 output channels: four m64n32 accumulators, 64 float32
//   registers a product thread. The four rows read R + 2 = 6 staged input
//   rows (h-d .. h+4d) where one row per tile read 3 each, 12 in all, and
//   64 + 2d columns (rounded up to 8 pixels so that each row starts on a
//   512-byte swizzle boundary). R = 4 keeps a product thread within its
//   168 registers and a stage at 6 x 96 x 64 B = 36 KB for d = 16, so a
//   ring of 5 stages (7 at d = 2) fits beside 36 KB of weights; rows are
//   tiled within each class h mod d, so H need not be a multiple of R * d.
// * Staging: per job (tile, input, channel slab of SC = 32 or 16) the copy
//   thread decodes the job once into the stage's Job slot and issues one
//   TMA box per staged row (zeros outside the image, the 64-byte swizzle
//   the products' ldmatrix reads conflict-free); it runs ahead as far as
//   the ring's free stages allow. Three mbarriers per stage order the
//   roles: landed (TMA), full (activated), empty (read).
// * The pre-activation relu(v * a + s), rounded to bf16, is applied once
//   per staged element in shared memory, inside the image only, since the
//   zero padding comes after the activation; the seven activating warps
//   and the product warpgroup that takes the job share it (224 + 128
//   threads); on the staging warps alone it held the products back.
// * Products: per (channel chunk, staged row, kx) one ldmatrix.x4 per warp
//   loads the A fragment at pixel offset kx * d, and up to three wgmma
//   m64n32k16 (one per output row that reads this staged row) use it with
//   the resident B of tap (ky, kx): 36 A loads for 72 wgmma per 32
//   channels. Each fragment is loaded while the previous group's wgmma
//   issue. (A read by descriptor from the swizzled rows, which wgmma
//   accepts at any pixel offset, re-reads A for each of the three wgmma
//   and ran slower on the H100.)
// * Epilogue: each accumulator row is rounded, transposed within its quad
//   of lanes by shuffles, and written as 16-byte channels-last vectors.
//   Ragged rows (h >= H) and columns (w >= W) are masked at the store.
// * One layer's body (`ring`, `begin_layer`, the roles `stage_layer` and
//   `multiply_layer`, `end_layer`) is also what `chain3x3.cu` runs for
//   each layer of its stacks, its set-up and barriers reachable from each
//   role's own code. `multiply_layer` also takes a layer of at most 8
//   outputs (N = 8, m64n8k16), written (B, Co, H, W): the chain's last
//   layer, and here the refinement's 32 -> 1 output (`use_narrow`).
// Registers and spills (ptxas, `chip_smoke.py` phase 2 on the H100): 128
// registers a thread at launch (the 65536 / 512 of `__launch_bounds__`,
// redistributed by `setmaxnreg`), no spills, in all eight instances.
#pragma once

#include <algorithm>

#include "dense3x3.cuh"
#include "tc.cuh"

namespace dense_tc {

using dense::Args;

constexpr int R = 4;          // output rows per tile, d apart
constexpr int TW = 64;        // output pixels per tile row: the wgmma M
constexpr int STAGERS = 256;  // two staging warpgroups: a copy warp
constexpr int ACTIVATORS = STAGERS - 32;  // and seven activating warps,
constexpr int WORKERS = ACTIVATORS + 128;  // with a product warpgroup
constexpr int THREADS = STAGERS + 256;  // and two product warpgroups
constexpr int STAGER_REGS = 88, PRODUCT_REGS = 168;  // 65536 / 256 in all
constexpr int MIN_STAGES = 4, MAX_STAGES = 8;  // staged jobs in the ring
constexpr int SMEM_MAX = 232448;                // per block, opted in
constexpr int MAX_D = 16;
constexpr int MAX_K = 128;    // Ci x inputs x groups of resident weights

__host__ __device__ inline int inputs(const Args& a) {
  return a.x2 != nullptr ? 2 : 1;
}

__host__ __device__ inline int row_tiles(const Args& a) {
  return ceil_div(ceil_div(a.H, a.d), R);
}
__host__ __device__ inline int col_tiles(const Args& a) {
  return ceil_div(a.W, TW);
}
__host__ __device__ inline int tiles(const Args& a) {
  return a.B * a.d * row_tiles(a) * col_tiles(a);
}
// Staged pixels of a row: 64 + 2d, rounded up to 8 so that every row
// starts on a 512-byte swizzle boundary.
__host__ __device__ inline int row_pixels(int d) {
  return (TW + 2 * d + 7) / 8 * 8;
}
// A staged job's bytes: R + 2 rows of SC channels of EB-byte elements.
template <int SC, int EB = 2>
__host__ __device__ inline int stage_bytes(int d) {
  return (R + 2) * row_pixels(d) * SC * EB;
}

// The ring of staged jobs, shared with dense3x3_f32.cuh's float32 route.
// Its shared memory before the stages: `wbytes` of resident weights,
// `afloats` float32 affines, 3 x MAX_STAGES + 1 mbarriers (256 B) and a
// Job per stage (256 B); the stages start at the next 1024-byte boundary.
__host__ __device__ inline int ring_fixed_bytes(int wbytes, int afloats) {
  return wbytes + afloats * 4 + 512;
}
// The ring's stages beside `fixed` bytes: as many as fit, up to
// MAX_STAGES; none (0) with fewer than `min_stages`, or with no more than
// a tile's `jobs`. The two product groups take alternate tiles and wait
// each job's mbarriers by the parity of its lap of the ring. That parity
// names the right phase only if the stage's previous lap is done when
// the group waits: a group reaches its tile's first job n having read
// every job of its previous tile, up to n - jobs - 1, so job n - S must
// be among them, S > jobs. (With S <= jobs the wait may pass on the
// previous lap, or wait on the wrong one.)
__host__ __device__ inline int ring_stages(int fixed, int sbytes,
                                           int min_stages, int jobs) {
  int n = (SMEM_MAX - fixed - 1024) / sbytes;
  if (n > MAX_STAGES) n = MAX_STAGES;
  return n < min_stages || n <= jobs ? 0 : n;
}

// Output channels of the B images: 32, or 8 for a narrow layer (Co <= 8,
// zero-padded by the chain's wrapper, or by the block on dense3x3's
// narrow-output route).
__host__ __device__ inline int image_n(int Co) { return Co <= 8 ? 8 : tc::N; }
__host__ __device__ inline int image_n(const Args& a) { return image_n(a.Co); }
// Bytes of one 16-deep slice of B.
__host__ __device__ inline int slice_bytes(const Args& a) {
  return 16 * image_n(a) * 2;
}
__host__ __device__ inline int weight_bytes(int Ci, int Co, int nin, int G) {
  return G * nin * 9 * Ci / 16 * (16 * image_n(Co) * 2);
}
__host__ __device__ inline int weight_bytes(const Args& a) {
  return weight_bytes(a.Ci, a.Co, inputs(a), a.G);
}
__host__ __device__ inline int affine_floats(const Args& a) {
  return a.G * inputs(a) * 2 * a.Ci;
}
__host__ __device__ inline int fixed_bytes(const Args& a) {
  return ring_fixed_bytes(weight_bytes(a), affine_floats(a));
}
// The ring's stages at a shape, slabs of SC channels (0: refused).
__host__ __device__ inline int stages(int SC, int Ci, int Co, int d, int nin,
                                      int G) {
  return ring_stages(
      ring_fixed_bytes(weight_bytes(Ci, Co, nin, G), G * nin * 2 * Ci),
      SC == 32 ? stage_bytes<32>(d) : stage_bytes<16>(d), MIN_STAGES,
      nin * Ci / SC);
}
template <int SC>
__host__ __device__ inline int stages(const Args& a) {
  return stages(SC, a.Ci, a.Co, a.d, inputs(a), a.G);
}

// The route's shapes; everything else takes dense3x3's other routes.
// Slabs of 32 channels where Ci allows, else 16.
__host__ __device__ inline bool use(int elem_bytes, int Ci, int Co, int d,
                                    int nin, int G) {
  return elem_bytes == 2 && Co == tc::N && Ci % 16 == 0 && d >= 1 &&
         d <= MAX_D && Ci * nin * G <= MAX_K &&
         stages(Ci % 32 == 0 ? 32 : 16, Ci, Co, d, nin, G) > 0;
}

// The narrow-output shapes (mirrored by `dense_output_route` in
// ops/cuda/refine_rows.py): one input, at most 8 outputs (the
// refinement's 32 -> 1), the same body on m64n8k16 with the B images
// zero-padded to 8 outputs (`layout_narrow_weights`), y written
// (B, Co, H, W).
__host__ __device__ inline bool use_narrow(int elem_bytes, int Ci, int Co,
                                           int d, int nin, int G) {
  return nin == 1 && Co >= 1 && Co <= 8 &&
         use(elem_bytes, Ci, tc::N, d, nin, G);
}

// One staged job: tile (batch b, row class c = h mod d, row tile k in the
// class, first column w0), weight group g, input i, channel slab s. The
// copy thread decodes it once and leaves it beside its stage.
struct Job {
  int b, c, k, w0, g, i, s, pad;
};

__device__ __forceinline__ Job job_of(const Args& a, int tile, int j,
                                      int nslab) {
  const int ncx = col_tiles(a), nk = row_tiles(a);
  Job r;
  r.w0 = (tile % ncx) * TW;
  tile /= ncx;
  r.k = tile % nk;
  tile /= nk;
  r.c = tile % a.d;
  r.b = tile / a.d;
  r.g = r.b / (a.B / a.G);
  r.i = j / nslab;
  r.s = j % nslab;
  r.pad = 0;
  return r;
}

// Image row of staged row r (0 .. R+1) or output row r - 1.
__device__ __forceinline__ int image_row(const Args& a, const Job& t, int r) {
  return t.c + (t.k * R + r - 1) * a.d;
}

// Every group's weights of every input into shared memory by bulk copies on
// `bar` (one thread), `set` bytes for one group of one input, as a.wt /
// a.wt2 hold them: here (G, Ci / 16, 9) B images each (`_wgmma_images` in
// ops/cuda/refine_rows.py). The affines (g, i, {scale, shift}, ci) by
// every thread of the block's NT.
template <int NT = THREADS>
__device__ __forceinline__ void load_weights(const Args& a, int set,
                                             uint32_t wsm, float* asm_,
                                             uint32_t bar) {
  const int nin = inputs(a), Ci = a.Ci;
  if (threadIdx.x == 0) {
    tc::mbar_expect_tx(bar, a.G * nin * set);
    for (int gi = 0; gi < a.G * nin; ++gi)
      tc::bulk_load(wsm + gi * set,
                    (const unsigned char*)(gi % nin ? a.wt2 : a.wt) +
                        (size_t)(gi / nin) * set,
                    set, bar);
  }
  for (int gi = 0; gi < a.G * nin; ++gi) {
    const float* aff = gi % nin ? a.aff2 : a.aff;
    if (aff != nullptr)
      for (int e = threadIdx.x; e < 2 * Ci; e += NT)
        asm_[gi * 2 * Ci + e] = aff[(size_t)(gi / nin) * 2 * Ci + e];
  }
}

// Worker w (of WORKERS) activates its chunks of a staged job in `buf`:
// relu(v * a + s) in float32 with one bf16 rounding, inside the image
// only, since the zeros TMA fills in outside it are the padding, which
// comes after the activation. Chunk e = w + k * WORKERS of a row is pixel
// e / CPP, channels (e % CPP) * 8 ..; two rows' chunks are loaded before
// any is written back, so their latencies overlap.
template <int SC>
__device__ __forceinline__ void activate_job(const Args& a, const Job& t,
                                             const float* asm_,
                                             unsigned char* buf, int w) {
  constexpr int CPP = SC / 8, ROW_PX = SC * 2;
  constexpr int KS = ((TW + 2 * MAX_D) * CPP + WORKERS - 1) / WORKERS;
  constexpr int RB = 2;  // rows a batch
  const int d = a.d, Ci = a.Ci, ROW = row_pixels(d) * ROW_PX;
  const int cc = w % CPP;  // this worker's 8 channels (WORKERS % CPP == 0)
  const float* av =
      asm_ + (t.g * inputs(a) + t.i) * 2 * Ci + t.s * SC + cc * 8;
  float sa[8], ss[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    sa[m] = av[m];
    ss[m] = av[Ci + m];
  }
#pragma unroll
  for (int r0 = 0; r0 < R + 2; r0 += RB) {
    uint4 u[RB][KS];
    bool in[RB][KS];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int hh = image_row(a, t, r0 + r);
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int q = (w + k * WORKERS) / CPP, ww = t.w0 - d + q;
        in[r][k] = q < TW + 2 * d && hh >= 0 && hh < a.H && ww >= 0 &&
                   ww < a.W;
        if (in[r][k])
          u[r][k] = *(const uint4*)(buf + (r0 + r) * ROW +
                                    tc::chunk_offset<SC>(q, cc));
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int k = 0; k < KS; ++k)
        if (in[r][k])
          *(uint4*)(buf + (r0 + r) * ROW +
                    tc::chunk_offset<SC>((w + k * WORKERS) / CPP, cc)) =
              tc::activate8(u[r][k], sa, ss);
  }
}

// One layer's shared memory, from the base of the block's dynamic shared
// memory: weights, affines, the mbarriers, a Job per stage, then the ring
// of S stages at the next 1024-byte boundary (`ring_fixed_bytes`). Per
// stage three mbarriers: copies landed, staged (activated), read by the
// products; and one more for the weights.
struct Ring {
  unsigned char* stage0_p;  // the first stage (generic address)
  float* asm_;              // the affines
  Job* jobs;                // a Job per stage
  uint32_t wbase;           // the weights (shared address)
  uint32_t bars;            // the mbarriers (shared address)
  uint32_t stage0;          // the first stage (shared address)
  int S;                    // stages, `stages<SC>(a)`

  __device__ __forceinline__ uint32_t landed(int n) const {
    return bars + 8 * (n % S);
  }
  __device__ __forceinline__ uint32_t full(int n) const {
    return bars + 8 * (MAX_STAGES + n % S);
  }
  __device__ __forceinline__ uint32_t empty(int n) const {
    return bars + 8 * (2 * MAX_STAGES + n % S);
  }
  __device__ __forceinline__ uint32_t weights() const {
    return bars + 8 * 3 * MAX_STAGES;
  }
};

__device__ __forceinline__ Ring make_ring(unsigned char* smem, int wbytes,
                                          int afloats, int S) {
  Ring r;
  r.asm_ = (float*)(smem + wbytes);
  r.jobs = (Job*)(r.asm_ + afloats + 64);
  r.wbase = tc::smem_addr(smem);
  r.bars = tc::smem_addr(r.asm_ + afloats);
  r.stage0 = (r.wbase + ring_fixed_bytes(wbytes, afloats) + 1023) & ~1023u;
  r.stage0_p = smem + (r.stage0 - r.wbase);
  r.S = S;
  return r;
}
__device__ __forceinline__ Ring ring(const Args& a, unsigned char* smem,
                                     int S) {
  return make_ring(smem, weight_bytes(a), affine_floats(a), S);
}

// Thread 0: the ring's mbarriers initialised, `full_arrivals` a stage's
// activation (its activating threads), 128 its read (a product group).
__device__ __forceinline__ void init_ring(const Ring& r, int full_arrivals) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.S; ++s) {
      tc::mbar_init(r.landed(s), 1);
      tc::mbar_init(r.full(s), full_arrivals);
      tc::mbar_init(r.empty(s), 128);
    }
    tc::mbar_init(r.weights(), 1);
  }
}

// Every thread of a narrow layer's block (one input, Co <= 8): its B
// images (g, ci / 16, tap) of 16 x 8, zero beyond Co, laid out in `w`
// from the weights as the caller has them, a.wt (G, Co, Ci, 3, 3), so
// that the wrapper prepares nothing (host time a call): element
// (k = ci % 16, n = co) of a 256-byte slice at (k / 8) 128 + n 16 +
// (k % 8) 2 bytes, the images `_wgmma_images(_pad_outputs(wt))` in
// ops/cuda/refine_rows.py would give: per 16-byte row (8 k of one n), the
// loads in a batch, one store.
__device__ __forceinline__ void layout_narrow_weights(const Args& a,
                                                      unsigned char* w) {
  const uint16_t* wt = (const uint16_t*)a.wt;
  const int Ci = a.Ci;
  for (int e = threadIdx.x; e < a.G * Ci / 16 * 9 * 16; e += THREADS) {
    const int n = e % 8, half = e / 8 % 2, tap = e / 16 % 9;
    const int slab = e / 144;  // g * Ci / 16 + ci / 16
    const int g = slab / (Ci / 16), ci0 = slab % (Ci / 16) * 16 + half * 8;
    uint32_t u[8] = {};
    if (n < a.Co)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        u[j] = wt[((size_t)(g * a.Co + n) * Ci + ci0 + j) * 9 + tap];
    *(uint4*)(w + (slab * 9 + tap) * 256 + half * 128 + n * 16) =
        make_uint4(u[0] | u[1] << 16, u[2] | u[3] << 16, u[4] | u[5] << 16,
                   u[6] | u[7] << 16);
  }
  tc::fence_proxy_async();  // generic stores before wgmma reads them
}

// Every thread of the block, before its role's part of the layer (each
// role may run its own copy of this step): the ring's mbarriers
// initialised, the layer's weights on their way by bulk copy (or, for a
// narrow layer of `dense3x3.cu`, `narrow`, laid out by the block), its
// affines in shared memory.
__device__ __forceinline__ void begin_layer(const Args& a, const Ring& r,
                                            bool narrow = false) {
  init_ring(r, WORKERS);
  tc::cta_sync();
  if (narrow) {
    layout_narrow_weights(a, (unsigned char*)r.asm_ - weight_bytes(a));
    if (a.aff != nullptr)  // (G, 2, Ci), as `load_weights` lays it out
      for (int e = threadIdx.x; e < a.G * 2 * a.Ci; e += THREADS)
        r.asm_[e] = a.aff[e];
  } else {
    load_weights(a, a.Ci / 16 * 9 * slice_bytes(a), r.wbase, r.asm_,
                 r.weights());
  }
  tc::cta_sync();  // the affines (and a narrow layer's weights)
  if (narrow && threadIdx.x == 0) tc::mbar_arrive(r.weights());
}

// Every thread of the block, after its role's part of the layer: once all
// have arrived, the mbarriers invalidated, so that their memory may hold
// anything next.
__device__ __forceinline__ void end_layer(const Ring& r) {
  tc::cta_sync();
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.S; ++s) {
      tc::mbar_inval(r.landed(s));
      tc::mbar_inval(r.full(s));
      tc::mbar_inval(r.empty(s));
    }
    tc::mbar_inval(r.weights());
  }
}

// Jobs of this block: my_tiles x jobs a tile.
__device__ __forceinline__ int block_tiles(const Args& a) {
  const int ntiles = tiles(a);
  return (int)blockIdx.x < ntiles
             ? (ntiles - 1 - (int)blockIdx.x) / gridDim.x + 1
             : 0;
}

// The staging roles over this block's jobs, shared with dense3x3_f32.cuh
// (EB-byte elements). Thread 0 of warp 0, the copy thread, keeps the TMA
// copies of every job in flight as soon as its stage is free: the job
// decoded once into its stage's Job slot, one box per staged row. Every
// other thread that calls it activates: it takes each job once its copies
// have landed, calls `activate(job, stage)` where the layer has an affine,
// and arrives on the job's `full`. `mark(m)` closes a span of a clock64()
// split (the float32 route's; a no-op here): the wait for a free stage
// (FREED), the copy thread's other work (ISSUED), an activating thread's
// wait for copies (LANDED) and its activation (STAGED).
enum StageMark { FREED, ISSUED, LANDED, STAGED };
template <int SC, int EB = 2, typename Activate, typename Mark>
__device__ __forceinline__ void stage_jobs(const CUtensorMap* map_x,
                                           const CUtensorMap* map_x2,
                                           const Args& a, const Ring& r,
                                           Activate&& activate, Mark&& mark) {
  const int d = a.d, S = r.S;
  const int ROW = row_pixels(d) * SC * EB, sbytes = stage_bytes<SC, EB>(d);
  const int nslab = a.Ci / SC, jobs = inputs(a) * nslab;
  const int njobs = block_tiles(a) * jobs;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      for (int n = 0; n < njobs; ++n) {
        mark(ISSUED);
        if (n >= S) tc::mbar_wait(r.empty(n), ((n / S) & 1) ^ 1);
        mark(FREED);
        const Job t =
            job_of(a, blockIdx.x + n / jobs * gridDim.x, n % jobs, nslab);
        r.jobs[n % S] = t;  // published by the arrive below
        const uint32_t buf = r.stage0 + (n % S) * sbytes;
        tc::mbar_expect_tx(r.landed(n), sbytes);
#pragma unroll
        for (int k = 0; k < R + 2; ++k)
          tc::tma_load_4d(buf + k * ROW, t.i ? map_x2 : map_x, r.landed(n),
                          t.s * SC, t.w0 - d, image_row(a, t, k), t.b);
      }
    return;
  }
  for (int n = 0; n < njobs; ++n) {
    tc::mbar_wait(r.landed(n), (n / S) & 1);
    mark(LANDED);
    const Job t = r.jobs[n % S];
    if ((t.i ? a.aff2 : a.aff) != nullptr)
      activate(t, r.stage0_p + (n % S) * sbytes);
    tc::mbar_arrive(r.full(n));
    mark(STAGED);
  }
}

// The staging role (threads 0 .. STAGERS-1, STAGER_REGS registers): the
// copy warp and the activating warps of `stage_jobs` (the product
// warpgroup that takes a job does the rest of its activation). map_x /
// map_x2: TMA maps of the inputs.
template <int SC>
__device__ __forceinline__ void stage_layer(const CUtensorMap* map_x,
                                            const CUtensorMap* map_x2,
                                            const Args& a, const Ring& r) {
  stage_jobs<SC>(
      map_x, map_x2, a, r,
      [&](const Job& t, unsigned char* buf) {
        activate_job<SC>(a, t, r.asm_, buf, threadIdx.x - 32);
      },
      [](StageMark) {});
}

// The product role (threads STAGERS .. THREADS-1, PRODUCT_REGS registers):
// product warpgroup p = wg - 2 takes the block's tiles p, p + 2, ...: its
// share of each job's activation, then the products, A from the staged
// rows, B from the resident weights, and the channels-last epilogue. N = 8:
// a narrow layer (Co <= 8, m64n8k16), written (B, Co, H, W).
template <int SC, typename TO, int N = tc::N>
__device__ __forceinline__ void multiply_layer(const Args& a,
                                               const Ring& r) {
  using Acc = typename std::conditional<N == tc::N, tc::Acc, tc::Acc8>::type;
  constexpr int SLICE = 16 * N * 2 >> 4;  // descriptor step of a slice
  constexpr int KC = SC / 16;
  const int d = a.d, H = a.H, W = a.W, Ci = a.Ci, S = r.S;
  const int ROW = row_pixels(d) * SC * 2, sbytes = stage_bytes<SC>(d);
  const int nin = inputs(a), jobs = nin * (Ci / SC);
  const int my_tiles = block_tiles(a);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint64_t desc0 = tc::b_desc(r.wbase);
  uint32_t ao[KC][3];  // this lane's A row at (kc, kx) in any staged row
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
      ao[kc][kx] = tc::chunk_offset<SC>(warp * 16 + lane % 16 + kx * d,
                                        kc * 2 + lane / 16);
  tc::mbar_wait(r.weights(), 0);
  Acc acc[R];
  for (int m = wg - 2; m < my_tiles; m += 2) {
    Job t;
#pragma unroll
    for (int o = 0; o < R; ++o) tc::zero(acc[o]);
    for (int j = 0; j < jobs; ++j) {
      const int n = m * jobs + j;
      tc::mbar_wait(r.landed(n), (n / S) & 1);
      t = r.jobs[n % S];
      if ((t.i ? a.aff2 : a.aff) != nullptr)  // this warpgroup's share
        activate_job<SC>(a, t, r.asm_, r.stage0_p + (n % S) * sbytes,
                         ACTIVATORS + threadIdx.x % 128);
      tc::mbar_arrive(r.full(n));
      tc::mbar_wait(r.full(n), (n / S) & 1);
      const uint32_t buf = r.stage0 + (n % S) * sbytes;
      const uint64_t dj =
          desc0 + (uint64_t)((t.g * nin + t.i) * (Ci / 16) + t.s * KC) * 9 *
                      SLICE;
      // Group q: channel chunk kc, staged row k, tap column kx: one A
      // fragment (ldmatrix) for up to three wgmma, loaded while group
      // q - 1's wgmma issue; four register buffers.
      constexpr int NG = KC * (R + 2) * 3, NBUF = 4;
      auto load = [&](uint32_t (&f)[4], int q) {
        const int kc = q / ((R + 2) * 3), k = q / 3 % (R + 2), kx = q % 3;
        tc::ldsm_x4(f, buf + k * ROW + ao[kc][kx]);
      };
      uint32_t af[NBUF][4];
      load(af[0], 0);
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        if (q + 1 < NG) {
          if (q + 1 >= NBUF) tc::wgmma_wait<NBUF - 2>();
          load(af[(q + 1) % NBUF], q + 1);
        }
        tc::wgmma_fence();
        const int kc = q / ((R + 2) * 3), k = q / 3 % (R + 2), kx = q % 3;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int o = k - ky;
          if (o < 0 || o >= R) continue;
          const uint64_t b = dj + (kc * 9 + ky * 3 + kx) * SLICE;
          if constexpr (N == tc::N)
            tc::wgmma_m64n32k16(acc[o], af[q % NBUF], b);
          else
            tc::wgmma_m64n8k16(acc[o], af[q % NBUF], b);
        }
        tc::wgmma_commit();
      }
      tc::wgmma_wait<0>();
      tc::mbar_arrive(r.empty(n));  // the job's wgmma have read the stage
    }
#pragma unroll
    for (int o = 0; o < R; ++o) tc::fence_operand(acc[o]);
    TO* y = (TO*)a.y;
#pragma unroll
    for (int o = 0; o < R; ++o) {
      const int h = image_row(a, t, o + 1);
      const bool hv = h < H;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = t.w0 + warp * 16 + lane / 4 + 8 * half;
        const bool ok = hv && w < W;
        if constexpr (N == tc::N) {
          TO* px = y + (((size_t)t.b * H + (hv ? h : 0)) * W +
                        (ok ? w : 0)) * tc::N;
          tc::store_row<TO>(acc[o], half, px, ok);
        } else {  // this lane's columns 2 (lane % 4) + {0, 1}, if < Co
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = 2 * (lane % 4) + e;
            if (ok && co < a.Co)
              y[(((size_t)t.b * a.Co + co) * H + h) * W + w] =
                  from_f<TO>(acc[o].v[2 * half + e]);
          }
        }
      }
    }
  }
}

// S: the ring's stages, `stages<SC>(a)`. map_x / map_x2: TMA maps of the
// inputs (`launch`). N: 32, or 8 for a narrow layer (`use_narrow`), whose
// block lays out its weights itself (a.wt as the caller has it). Each warp
// keeps its role, and with it its register count, for the whole launch.
template <int SC, typename TO, int N>
__global__ void __launch_bounds__(THREADS, 1)
    dense3x3_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_x2, Args a,
                       int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring r = ring(a, smem, S);
  begin_layer(a, r, N == 8);
  if (threadIdx.x < STAGERS) {
    tc::setmaxnreg_dec<STAGER_REGS>();
    stage_layer<SC>(&map_x, &map_x2, a, r);
  } else {
    tc::setmaxnreg_inc<PRODUCT_REGS>();
    multiply_layer<SC, TO, N>(a, r);
  }
}

}  // namespace dense_tc

namespace {

// The shared-memory opt-in of `kernel`, once per device and size (host
// time a call). Internal linkage: a function-local static of a template
// of external linkage is one object across every library loaded in the
// process, so a copy of these sources built as a second library
// (conv3d_c8_variants.py) would skip its own opt-in.
template <auto kernel>
cudaError_t opt_in(int smem) {
  static int opted[16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || opted[dev] < smem) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 16) opted[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace

namespace dense_tc {

// Launch on `stream`: one persistent block per SM, at most one per tile,
// with all the shared memory a block may have. Returns a cudaError_t (or
// the CUresult of a refused TMA map).
template <int SC, typename TO, int N = tc::N>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = dense3x3_tc_kernel<SC, TO, N>;
  const int S = stages<SC>(a);
  if (S == 0) return (int)cudaErrorInvalidValue;
  const int smem = fixed_bytes(a) + 1024 + S * stage_bytes<SC>(a.d);
  CUtensorMap maps[2];
  const cuuint64_t dims[4] = {(cuuint64_t)a.Ci, (cuuint64_t)a.W,
                              (cuuint64_t)a.H, (cuuint64_t)a.B};
  for (int i = 0; i < inputs(a); ++i) {
    const int rc = tc::make_map(&maps[i], i ? a.x2 : a.x, 4, dims, SC,
                                row_pixels(a.d));
    if (rc != 0) return rc;
  }
  if (inputs(a) == 1) maps[1] = maps[0];
  const cudaError_t e = opt_in<dense3x3_tc_kernel<SC, TO, N>>(smem);
  if (e != cudaSuccess) return (int)e;
  if (tc::sm_count() < 1) return (int)cudaErrorInvalidValue;
  const int grid = std::min(tiles(a), tc::sm_count());
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], a, S);
  return (int)cudaGetLastError();
}

}  // namespace dense_tc
