#!/usr/bin/env python3
"""Variants of conv3d_bn_relu's 8 -> 8 tensor-core route (with --skip, of
conv3d_skip_softargmin's; with --entry, of conv3d_bn_relu's 1 -> C entry
route; with --dwsep, of dwsep3x3's tile body; with --c4, of the 4 -> 4
route and of the CUDA-core kernel it replaced; with --skip4, of the fused
last layer's 4-channel route and of the CUDA-core kernel it replaced;
with --dense32, of dense3x3's float32 route), timed on one GPU.

Run from the repository root on a machine with a card:

    python3 conv3d_c8_variants.py [--skip | --entry | --dwsep | --c4 |
                                   --skip4 | --dense32] [--json PATH]

Each variant is `lwsnet_tpu_torch/csrc/conv3d_bn_relu.cu` with a few
textual changes to its `c8` namespace, written beside copies of the
headers to build/c8_variants/<name>/ and built with the port's nvcc flags,
all at once. Each is held against `conv3d_bn_relu_plain` at the stage-3
shape of the 368x1232 forward (every bf16 element within two rounding
steps) and timed alone on the device (`chip_smoke.kernel_device_ms`) at
the stage-2 and stage-3 shapes, writing channels-last and NCDHW, beside
the repository's own library, in one process:

  groups1 .. groups3  1-3 product warpgroups a block (the route has 4);
  mma_sync            mma.sync.m16n8k16 per warp from the same ldmatrix
                      fragments, the 18 B slices as register fragments,
                      in place of wgmma m64n8k16;
  n32_rows            output rows on N: per (staged row, j) one wgmma
                      m64n32k16 per output depth against B banded over
                      the tile's 4 rows (zero where a row's tap falls
                      outside), 108 products a tile for 216;
  kw2_pairs           the kw = 2 taps of staged rows h and h + 1 in one
                      K = 16 slice (A's second half from the next row),
                      in place of kw = 2 beside a zero fourth tap: 15
                      products an output row for 18;
  channel_runs        the TMA map with the 8 channels as the innermost
                      dimension (16-byte runs) in place of the voxel map;
  clock               clock64() per role: the staging thread's waits for
                      free stages, each product warpgroup's waits for
                      landed stages, products and epilogue (median over
                      the blocks of one stage-3 and one stage-2 launch).

--skip times conv3d_skip_softargmin's tensor-core route instead (its `tcr`
namespace in `csrc/conv3d_skip_softargmin.cu`), each variant held against
`conv3d_skip_softargmin_plain` (every element within two bf16 rounding
steps) and timed at the three stage shapes of the 368x1232 forward, at
two small ones (one row of two tiles, each tile's block alone on its SM),
at AnyNet's stage 1 (16 channels, D = 12), the wide filter's last layer
(64 channels, D = 72) and the stage-1 width past D = 64 (32 channels,
D = 72), all at 46x154, and the stage-2/3 width past D = 64 (8 channels,
D = 65, B = 2 at 5x37):

  c32_rows2           2 output rows a C = 32 tile (the route has 1): 69
                      tiles for 138, N = 24 for 16;
  c32_stages4         a ring of 4 staged planes at C = 32 (the route has 6);
  c32_acc1            one accumulator a plane at C = 32 (the route has two);
  c8_stages4          a ring of 4 at C = 8 (the route has 3; then six
                      blocks fit an SM, not seven);
  c8_acc2             two accumulators a plane at C = 8 (the route has one);
  c64_stages5_blocks1 a ring of 5 at C = 64, one block an SM (the route has
                      3 and two blocks an SM);
  c64_acc2            two accumulators a plane at C = 64 (the route has 4);
  clock               clock64() marks of a block (thread 0 of the products
                      and the staging thread): B images built, first plane
                      landed, waits for landed planes, products done, end,
                      the last copy issued, waits for free stages (medians
                      over the blocks of each launch), and the spread of
                      the blocks' starts, the launch's span and the most
                      blocks one SM ran, from %globaltimer and %smid.

--entry times the stage entries' route instead (its `c1` namespace in
`csrc/conv3d_bn_relu.cu`: layer 0's BN + ReLU and the 1 -> C layer), each
variant held against `conv3d_entry_plain` (every bf16 element within two
rounding steps) at the three stage shapes of the 368x1232 forward, at
AnyNet's three (1 -> 16 over D = 12, 1 -> 4 over D = 5 at stages 2 and 3)
and at a 64-channel filter's (1 -> 64 over D = 72 at 46x154), and timed
there alone and together with the stage's first C -> C layer reading its
output (both kernels' device time a call); at the 4-, 16- and 64-channel
shapes also the CUDA-core kernel that ran those entries before `c1` took
them:

  evict_first         the output written with an L2 evict-first policy
                      (st.global.cs at Co = 32, the TMA copy's cache hint
                      at Co = 8), as dense3x3's narrow entry writes its
                      58 MB; the route's plain stores leave it in L2 for
                      the next layer;
  blocks4             four blocks an SM (at most 128 registers a thread;
                      the route has five, at most 102);
  obufs3              three output buffers at Co = 8 (the route has two);
  rolled              the loop over a tile's product groups not unrolled
                      (a third or a sixth of the code);
  pitch72             staged rows 72 pixels apart (the route has 74, at
                      which no A read of a warp meets a bank conflict;
                      at 72 they take 1.75-2 wavefronts on average:
                      `a_read_wavefronts` in
                      tests/test_torch_costfilter_entry.py; the 4-output
                      entry's 82 stays);
  clock               clock64() per block (thread 0): set-up (the B images,
                      shift, offsets; within it, the images laid out, from
                      the block's start), the first tile's staging (the
                      wait for its loads, issued before the set-up, and
                      its stores), the later tiles' staging (stores and
                      the block barrier), products (A reads, wgmma and
                      the wait for them), epilogue (relu, rounding,
                      stores), tiles a block and the whole block (medians
                      over the blocks of each launch, in clocks);
  entry_cores         the CUDA-core kernel at the 1 -> 4, 16 and 64
                      entries (`use_tc` without them), as they ran it;
  entry_cores_clock   its clock64() split, thread 0 of each block: the
                      weights staged, the taps (loads, layer 0's affine,
                      FMAs), the stores.

--dwsep splits `dwsep3x3`'s tile body instead (the anonymous namespace
of `csrc/dwsep3x3.cu`, solo and pair): each variant held against
`dwsep_plain` / `dwsep2_plain` (every bf16 element within two rounding
steps) and timed alone on the device at the "vpu" engines' launches of
the 368x1232 forward at refine_channels 48, 20 and 64:

  clock               clock64() of thread 0 of each block, by phase: the
                      depthwise input staged (loads, activation, weights),
                      the taps, the pointwise product (its weights staged,
                      the mma.sync or CUDA-core sums, the results rounded
                      into shared memory), the results stored to y, the
                      block barriers, the pair's grid barrier; tiles a
                      block and the block's total (medians over the
                      blocks of one launch, in clocks, and each phase's
                      share of the total).

--c4 times the 4 -> 4 route instead (its `c4` namespace in
`csrc/conv3d_bn_relu.cu`), each variant held against
`conv3d_bn_relu_plain` (every bf16 element within two rounding steps) and
timed alone on the device at the stage-2 and stage-3 geometry of SHAPES
with 4 channels and D = 5 (AnyNet's settings), beside the CUDA-core kernel
that took bf16 4 -> 4 before it (`conv3d_bn_relu_kernel<bf16, 4>`, built
with the 4 -> 4 clause of `use_tc` removed and called with its (Ci, 27,
Co) weights, NCDHW in and out):

  blocks1             one block an SM (at most 255 registers; the route
                      has two, at most 128);
  clock               clock64() of thread 0 of each block: the tile
                      staged (barrier, stores to shared memory, the next
                      tile's loads issued, barrier), products (issued: the
                      last ones' completion falls in the epilogue),
                      epilogue (relu, rounding, stores to y), set-up before
                      the first tile, tiles a block and the block's total
                      (medians over the blocks, in clocks);
  cores               the CUDA-core kernel as it was;
  cores_clock         its clock64() split, thread 0 of each block: the
                      weights staged (between the two block barriers), the
                      taps (loads and FMAs), the stores;
  cores_noload        each tap's global load replaced by a value from the
                      pixel index (its FMAs, address and bounds arithmetic
                      kept): the time without the 108 loads a thread;
  cores_nofma         each tap's 4 FMAs cut to one (its loads kept): the
                      time without three quarters of the FMAs.

--skip4 times conv3d_skip_softargmin's 4-channel route instead (its `s4`
namespace in `csrc/conv3d_skip_softargmin.cu`), each variant held against
`conv3d_skip_softargmin_plain` (every element within two bf16 rounding
steps) and timed alone on the device at the stage-2 and stage-3 geometry
of SHAPES with 4 channels and D = 5 (AnyNet's settings), NCDHW in, beside
the CUDA-core kernel that took bf16 Ci = 4 before it
(`skip_softargmin_kernel<bf16>`, built with the dispatcher's `case 4`
removed and called with (1, 4, 3, 3, 3) weights):

  blocks1, blocks3    one or three blocks an SM (at most 255 or 85
                      registers; the route has two, at most 128);
  clock               clock64() of thread 0 of each block: set-up (the B
                      fragments, the first tile's loads issued), the first
                      tile's staging (the wait for its loads and its
                      stores), later tiles' staging (barriers, stores, the
                      next tile's loads issued), products (A reads,
                      mma.sync, the kd exchange), epilogue (skip,
                      soft-argmin, fold, store), tiles a block and the
                      block's total (medians over the blocks, in clocks);
  cores               the CUDA-core kernel as it was;
  cores_clock         its clock64() split, thread 0 of each block: the
                      weights staged (two block barriers), the taps
                      (loads and FMAs), the costs and volume into shared
                      memory (with the barrier after), warp 0's
                      soft-argmin, the block's total.

--dense32 splits dense3x3's float32 route instead (`csrc/dense3x3_f32.cuh`,
built from `csrc/dense3x3.cu` with DENSE_F32_CLOCK defined 1), held
against `dense3x3_plain` (TF32 off, atol 2e-4 / rtol 1e-3) and timed
alone on the device beside the route as built, at the float32 "mxu"
forward's launches of the route at 368x1232 (the tower layers at B = 2,
the head's two-input entry, the head layers):

  clock               clock64() of a block: its copy thread's waits for
                      free stages and the rest of its loop (jobs decoded,
                      copies issued); its first activating thread's waits
                      for landed jobs and its activation; thread 0 of its
                      first consumer group: the set-up up to the weights'
                      arrival, waits for activated jobs, products,
                      epilogue, tiles and its whole run (medians over the
                      blocks of one launch, in clocks, and each of the
                      consumer's phases' share of its run).

Exits 1 without CUDA, 2 if a variant fails to build or its check.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"stage3": (1, 9, 184, 616), "stage2": (1, 9, 92, 308)}

_CLOCK_READ = '''
extern "C" int c8_clock_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, c8::clk, sizeof(c8::clk));
}
'''

VARIANTS = {
    **{f"groups{g}": [("constexpr int GROUPS = 4;",
                       f"constexpr int GROUPS = {g};")] for g in (1, 2, 3)},
    "mma_sync": [
        ("  tc::Acc8 acc[TD * TH];", """  uint32_t bf[18][2];  // B fragments: k = 2 (lane % 4) + {0, 1} (+ 8)
#pragma unroll
  for (int i = 0; i < 18; ++i) {
    const unsigned char* sl = smem + i * SLICE + lane / 4 * 16 + lane % 4 * 4;
    bf[i][0] = *reinterpret_cast<const uint32_t*>(sl);
    bf[i][1] = *reinterpret_cast<const uint32_t*>(sl + 128);
  }
  tc::Acc8 acc[TD * TH];"""),
        ("""        tc::wgmma_m64n8k16(acc[o], af[q % NBUF],
                           desc0 + ((kd * 3 + kh) * 2 + j) * (SLICE >> 4));""",
         """        const uint32_t* b = bf[(kd * 3 + kh) * 2 + j];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\\n"
            : "+f"(acc[o].v[0]), "+f"(acc[o].v[1]), "+f"(acc[o].v[2]),
              "+f"(acc[o].v[3])
            : "r"(af[q % NBUF][0]), "r"(af[q % NBUF][1]),
              "r"(af[q % NBUF][2]), "r"(af[q % NBUF][3]), "r"(b[0]),
              "r"(b[1]));"""),
        ("        if (q + 1 >= NBUF) tc::wgmma_wait<NBUF - 2>();", ""),
        ("      tc::wgmma_fence();\n", ""),
        ("      tc::wgmma_commit();\n", ""),
        ("    tc::wgmma_wait<0>();\n", ""),
    ],
    "n32_rows": [
        ("constexpr int FIXED = WBYTES + 256 + 128;",
         "constexpr int IMG = 36 * 1024;  // per (sh, kd, j): N = oh * 8 + co\n"
         "constexpr int FIXED = WBYTES + IMG + 256 + 128;"),
        ("  const uint32_t bars = wbase + WBYTES;",
         "  const uint32_t bars = wbase + WBYTES + IMG;"),
        ("  const uint64_t desc0 = tc::b_desc(wbase);",
         "  const uint64_t desc0 = tc::b_desc(wbase + WBYTES);"),
        ("  tc::mbar_wait(weights, 0);\n", """  tc::mbar_wait(weights, 0);
  for (int i = threadIdx.x - 128; i < 36 * 64; i += 128 * GROUPS) {
    const int chunk = i % 16, blk = i / 16 % 4, img = i / 64;
    const int j = img % 2, kd = img / 2 % 3, sh = img / 6, kh = sh - blk;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (kh >= 0 && kh <= 2)
      v = *reinterpret_cast<const uint4*>(
          smem + ((kd * 3 + kh) * 2 + j) * SLICE + chunk * 16);
    *reinterpret_cast<uint4*>(smem + WBYTES + img * 1024 + blk * 256 +
                              chunk * 16) = v;
  }
  tc::fence_proxy_async();
  asm volatile("bar.sync 1, %0;\\n" ::"r"(128 * GROUPS) : "memory");
"""),
        ("  tc::Acc8 acc[TD * TH];", "  tc::Acc acc[TD];"),
        ("    for (int o = 0; o < TD * TH; ++o) {\n      tc::zero(acc[o]);",
         "    for (int o = 0; o < TD; ++o) {\n      tc::zero(acc[o]);"),
        ("""      for (int o = 0; o < TD * TH; ++o) {
        const int kd = sd - o / TH, kh = sh - o % TH;
        if (kd < 0 || kd > 2 || kh < 0 || kh > 2) continue;
        tc::wgmma_m64n8k16(acc[o], af[q % NBUF],
                           desc0 + ((kd * 3 + kh) * 2 + j) * (SLICE >> 4));
      }""", """      for (int od = 0; od < TD; ++od) {
        const int kd = sd - od;
        if (kd < 0 || kd > 2) continue;
        tc::wgmma_m64n32k16(acc[od], af[q % NBUF],
                            desc0 + ((sh * 3 + kd) * 2 + j) * (1024 >> 4));
      }"""),
        ("      tc::fence_operand(acc[o]);\n",
         "      if (o % TH == 0) tc::fence_operand(acc[o / TH]);\n"),
        ("acc[o].v[2 * half] + s0", "acc[o / TH].v[4 * (o % TH) + 2 * half] + s0"),
        ("acc[o].v[2 * half + 1] + s1",
         "acc[o / TH].v[4 * (o % TH) + 2 * half + 1] + s1"),
    ],
    "kw2_pairs": [
        ("constexpr int FIXED = WBYTES + 256 + 128;",
         "constexpr int FIXED = WBYTES + 3 * SLICE + 256 + 128;"),
        ("  const uint32_t bars = wbase + WBYTES;",
         "  const uint32_t bars = wbase + WBYTES + 3 * SLICE;"),
        ("  const uint32_t ao = (warp * 16 + lane % 16 + lane / 16) * 16;\n"
         "  tc::mbar_wait(weights, 0);\n",
         """  const uint32_t ao = (warp * 16 + lane % 16 + lane / 16) * 16;
  // the kw = 2 pair slice: lanes 16-31 read the next staged row (h + 1)
  const uint32_t ao2_last = (warp * 16 + lane % 16 + 2) * 16;
  const uint32_t ao2 = ao2_last + lane / 16 * ROW;
  tc::mbar_wait(weights, 0);
  // P(kd): k < 8 the kw = 2 taps of (kd, 0), k >= 8 those of (kd, 1)
  for (int i = threadIdx.x - 128; i < 3 * 16; i += 128 * GROUPS) {
    const int kd = i / 16, chunk = i % 16;
    const uint4 v = *reinterpret_cast<const uint4*>(
        smem + ((kd * 3 + chunk / 8) * 2 + 1) * SLICE + chunk % 8 * 16);
    *reinterpret_cast<uint4*>(smem + WBYTES + kd * SLICE + chunk * 16) = v;
  }
  tc::fence_proxy_async();
  asm volatile("bar.sync 1, %0;\\n" ::"r"(128 * GROUPS) : "memory");
"""),
        ("                    buf + (q + 1) / 2 * ROW + ao + (q + 1) % 2 * 32);",
         """                    buf + (q + 1) / 2 * ROW +
                        ((q + 1) % 2 == 0 ? ao
                         : (q + 1) / 2 % SH < SH - 1 ? ao2 : ao2_last));"""),
        ("""      for (int o = 0; o < TD * TH; ++o) {
        const int kd = sd - o / TH, kh = sh - o % TH;
        if (kd < 0 || kd > 2 || kh < 0 || kh > 2) continue;
        tc::wgmma_m64n8k16(acc[o], af[q % NBUF],
                           desc0 + ((kd * 3 + kh) * 2 + j) * (SLICE >> 4));
      }""", """      for (int o = 0; o < TD * TH; ++o) {
        const int kd = sd - o / TH, kh = sh - o % TH;
        if (kd < 0 || kd > 2 || kh < 0 || kh > 2) continue;
        if (j == 0)
          tc::wgmma_m64n8k16(acc[o], af[q % NBUF],
                             desc0 + (kd * 3 + kh) * 2 * (SLICE >> 4));
        else if (kh == 0)  // taps (kd, 0, 2) and (kd, 1, 2)
          tc::wgmma_m64n8k16(acc[o], af[q % NBUF],
                             desc0 + (18 + kd) * (SLICE >> 4));
        else if (kh == 2)  // tap (kd, 2, 2), the next row's weights zero
          tc::wgmma_m64n8k16(acc[o], af[q % NBUF],
                             desc0 + ((kd * 3 + 2) * 2 + 1) * (SLICE >> 4));
      }"""),
    ],
    "channel_runs": [
        ("""        tc::tma_load_4d(stage0 + (n % STAGES) * SB, &map_x, landed(n),
                        2 * (t.w0 - 1), t.h0 - 1, t.d0 - 1, t.b);""",
         """        tc::tma_load_5d(stage0 + (n % STAGES) * SB, &map_x, landed(n),
                        0, t.w0 - 1, t.h0 - 1, t.d0 - 1, t.b);"""),
        ("  const int rc = tc::make_voxel_map(&map, x, B, D, H, W, LP, SH, SD);",
         """  const cuuint64_t dims[5] = {8, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t strides[4] = {16, 16ull * W, 16ull * W * H,
                                 16ull * W * H * D};
  const cuuint32_t box[5] = {8, LP, SH, SD, 1}, ones[5] = {1, 1, 1, 1, 1};
  const int rc = tc::encode_tiled() == nullptr ? (int)CUDA_ERROR_NOT_FOUND
      : (int)tc::encode_tiled()(
            &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);"""),
    ],
    "clock": [
        ("__global__ void __launch_bounds__(THREADS, 1)\nconv3d_bn_relu_c8_kernel(",
         "__device__ unsigned long long clk[132 * 8 * 8];  // block, role\n"
         "__global__ void __launch_bounds__(THREADS, 1)\n"
         "conv3d_bn_relu_c8_kernel("),
        ("    if (threadIdx.x == 0)\n      for (int n = 0; n < my_tiles; ++n) {\n"
         "        if (n >= STAGES) tc::mbar_wait(empty(n), ((n / STAGES) & 1) ^ 1);",
         "    long long pw = 0;\n"
         "    if (threadIdx.x == 0)\n      for (int n = 0; n < my_tiles; ++n) {\n"
         "        const long long a = clock64();\n"
         "        if (n >= STAGES) tc::mbar_wait(empty(n), ((n / STAGES) & 1) ^ 1);\n"
         "        pw += clock64() - a;"),
        ("                        2 * (t.w0 - 1), t.h0 - 1, t.d0 - 1, t.b);\n"
         "      }\n    return;",
         "                        2 * (t.w0 - 1), t.h0 - 1, t.d0 - 1, t.b);\n"
         "      }\n"
         "    if (threadIdx.x == 0 && blockIdx.x < 132) {\n"
         "      clk[blockIdx.x * 64] = pw;\n"
         "      clk[blockIdx.x * 64 + 1] = my_tiles;\n    }\n    return;"),
        ("  for (int m = wg - 1; m < my_tiles; m += GROUPS) {\n"
         "    tc::mbar_wait(landed(m), (m / STAGES) & 1);",
         "  long long t_wait = 0, t_mma = 0, t_epi = 0;\n"
         "  for (int m = wg - 1; m < my_tiles; m += GROUPS) {\n"
         "    const long long c0 = clock64();\n"
         "    tc::mbar_wait(landed(m), (m / STAGES) & 1);\n"
         "    const long long c1 = clock64();\n    t_wait += c1 - c0;"),
        ("    tc::wgmma_wait<0>();\n",
         "    tc::wgmma_wait<0>();\n    const long long c2 = clock64();\n"
         "    t_mma += c2 - c1;\n"),
        ("          p[vol] = from_f<bf16>(v1);\n        }\n      }\n    }\n  }\n}\n",
         "          p[vol] = from_f<bf16>(v1);\n        }\n      }\n    }\n"
         "    t_epi += clock64() - c2;\n  }\n"
         "  if (threadIdx.x % 128 == 0 && blockIdx.x < 132) {\n"
         "    unsigned long long* c = clk + blockIdx.x * 64 + wg * 8;\n"
         "    c[0] = t_wait; c[1] = t_mma; c[2] = t_epi;\n  }\n}\n"),
    ],
}


_SKIP_CLOCK_READ = '''
extern "C" int skip_clock_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, tcr::clk, sizeof(tcr::clk));
}
extern "C" int skip_clock_reset() {
  static long long zero[sizeof(tcr::clk) / sizeof(long long)];
  return (int)cudaMemcpyToSymbol(tcr::clk, zero, sizeof(tcr::clk));
}
'''
SKIP_SHAPES = {"stage1": (1, 32, 24, 46, 154, 0),
               "stage2": (1, 8, 9, 92, 308, -4),
               "stage3": (1, 8, 9, 184, 616, -4),
               "one tile, C = 32": (1, 32, 24, 1, 64, 0),
               "one tile, C = 8": (1, 8, 9, 2, 64, -4),
               # AnyNet's stage 1, the wide filter's last layer, and the
               # stage-1 width past D = 64 (two chunks of costs)
               "anynet stage1, C = 16": (1, 16, 12, 46, 154, 0),
               "wide, C = 64, D = 72": (1, 64, 72, 46, 154, 0),
               "C = 32, D = 72": (1, 32, 72, 46, 154, 0),
               "C = 8, B = 2, D = 65, 5x37": (2, 8, 65, 5, 37, -32)}
SKIP_BLOCKS = 2048  # blocks whose clocks are kept
# clock64() slots of a block (clocks from its start, thread 0 of the
# product warpgroups unless marked; slot 5 marks a block that wrote): the
# weights landed and B built (the first volume loads in flight), the first
# plane landed, waits for landed planes, its products and sums done, end;
# the staging thread's last copy issued and its waits for free stages; the
# block's wall time (globaltimer, ns). Slot 0 holds the start's
# globaltimer and slot 6 the SM.
SKIP_ROLES = {"images_at": 1, "first_plane_at": 2, "landed_waits": 7,
              "products_done_at": 3, "end_at": 4, "last_copy_issued_at": 8,
              "staging_free_waits": 9, "wall_ns": 10}

SKIP_VARIANTS = {
    "c32_rows2": [("static constexpr int TH = 1, KP = 2,",
                   "static constexpr int TH = 2, KP = 2,"),
                  ("ACC = 2, BLOCKS = 2;", "ACC = 2, BLOCKS = 1;")],
    "c32_stages4": [("STAGES = 6, ACC = 2,", "STAGES = 4, ACC = 2,")],
    "c32_acc1": [("ACC = 2, BLOCKS = 2;", "ACC = 1, BLOCKS = 2;")],
    "c8_stages4": [("STAGES = 3, ACC = 1, BLOCKS = 7;",
                    "STAGES = 4, ACC = 1, BLOCKS = 7;")],
    "c8_acc2": [("ACC = 1, BLOCKS = 7;", "ACC = 2, BLOCKS = 7;")],
    # 64 channels: one block an SM with a deeper ring (a second wave of
    # six tiles at 46x154), or two accumulator chains
    "c64_stages5_blocks1": [("STAGES = 3, ACC = 4, BLOCKS = 2;",
                             "STAGES = 5, ACC = 4, BLOCKS = 1;")],
    "c64_acc2": [("STAGES = 3, ACC = 4, BLOCKS = 2;",
                  "STAGES = 3, ACC = 2, BLOCKS = 2;")],
    "clock": [
        ("template <int SC, bool CHUNKED>\n__global__ void "
         "__launch_bounds__(THREADS, Route<SC>::BLOCKS)\n",
         f"__device__ long long clk[{SKIP_BLOCKS} * 16];\n"
         "__device__ __forceinline__ long long gtime() {\n"
         "  long long t;\n"
         "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n"
         "template <int SC, bool CHUNKED>\n__global__ void "
         "__launch_bounds__(THREADS, Route<SC>::BLOCKS)\n"),
        ("  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH, "
         "b = blockIdx.z;\n",
         "  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH, "
         "b = blockIdx.z;\n  const long long t0 = clock64(), g0 = gtime();\n"
         "  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
         " + blockIdx.x;\n"
         f"  long long* ck = clk + (blk < {SKIP_BLOCKS} ? blk : 0) * 16;\n"
         "  long long t_land = 0, t_free = 0;\n"),
        ("        if (p >= S) tc::mbar_wait(empty(s), ((p / S) & 1) ^ 1);\n",
         "        const long long e0 = clock64();\n"
         "        if (p >= S) tc::mbar_wait(empty(s), ((p / S) & 1) ^ 1);\n"
         "        t_free += clock64() - e0;\n"),
        ("                            32 * k, w0 - 1, h0 - 1, p, b);\n"
         "      }\n    }\n    return;\n",
         "                            32 * k, w0 - 1, h0 - 1, p, b);\n"
         "      }\n"
         "      ck[8] = clock64() - t0;\n      ck[9] = t_free;\n    }\n"
         "    return;\n"),
        ("  tc::fence_proxy_async();  // the writes above before wgmma reads "
         "them\n",
         "  tc::fence_proxy_async();  // the writes above before wgmma reads "
         "them\n  if (threadIdx.x == 0) ck[1] = clock64() - t0;\n"),
        ("    tc::mbar_wait(landed(p % S), (p / S) & 1);\n",
         "    const long long l0 = clock64();\n"
         "    tc::mbar_wait(landed(p % S), (p / S) & 1);\n"
         "    t_land += clock64() - l0;\n"
         "    if (p == 0 && threadIdx.x == 0) ck[2] = clock64() - t0;\n"),
        ("\n  // Soft-argmin of this thread's pixel",
         "\n  if (threadIdx.x == 0) { ck[3] = clock64() - t0; ck[7] = t_land; }"
         "\n  // Soft-argmin of this thread's pixel"),
        ("  out[((size_t)b * H + h) * W + w] = run_num / run_den;\n}\n",
         "  out[((size_t)b * H + h) * W + w] = run_num / run_den;\n"
         "  if (threadIdx.x == 0) {\n    ck[4] = clock64() - t0; ck[0] = g0;"
         " ck[10] = gtime() - g0; ck[5] = 1;\n"
         "    unsigned sm;\n"
         "    asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(sm));\n"
         "    ck[6] = sm;\n  }\n}\n"),
    ],
}


ENTRY_VARIANTS = {
    "evict_first": [("constexpr bool STREAM = false;",
                     "constexpr bool STREAM = true;")],
    "pitch72": [("constexpr int P = 74;", "constexpr int P = 72;")],
    "blocks4": [("constexpr int MIN_BLOCKS = 5;",
                 "constexpr int MIN_BLOCKS = 4;")],
    "obufs3": [("constexpr int OBUFS = 2;", "constexpr int OBUFS = 3;")],
    "rolled": [("#pragma unroll\n    for (int g = 0; g < S::GROUPS;",
                "#pragma unroll 1\n    for (int g = 0; g < S::GROUPS;")],
    "clock": [
        ("constexpr int TD = 3, TH = 4, TW = 64;",
         "__device__ long long clk[4096][12];\n"
         "constexpr int TD = 3, TH = 4, TW = 64;"),
        ("  const int ntiles = tiles(a);\n  uint32_t v[NL];",
         "  const long long c_start = clock64();\n"
         "  long long c_stage = 0, c_first = 0, c_prod = 0, c_epi = 0;\n"
         "  long long c_tiles = 0;\n"
         "  const int ntiles = tiles(a);\n  uint32_t v[NL];"),
        ("  for (bool first = true; t < ntiles; t += gridDim.x, "
         "first = false) {",
         "  const long long c_setup = clock64();\n"
         "  for (bool first = true; t < ntiles; t += gridDim.x, "
         "first = false) {\n"
         "    const long long c_top = clock64();"),
        ("  tc::fence_proxy_async();  // generic stores before wgmma reads "
         "them\n\n  // Offsets",
         "  tc::fence_proxy_async();  // generic stores before wgmma reads "
         "them\n  const long long c_img = clock64();\n\n  // Offsets"),
        ("    __syncthreads();  // the tile staged (and, first, the weights)",
         "    __syncthreads();  // the tile staged (and, first, the weights)\n"
         "    const long long c_mid = clock64();\n"
         "    if (first) c_first = c_mid - c_top;\n"
         "    else c_stage += c_mid - c_top;"),
        ("      load_a(af, g);",
         "      const long long c_g0 = clock64();\n      load_a(af, g);"),
        ("      tc::wgmma_wait<0>();\n      store(acc, tt, g);",
         "      tc::wgmma_wait<0>();\n"
         "      const long long c_g1 = clock64();\n"
         "      c_prod += c_g1 - c_g0;\n"
         "      store(acc, tt, g);\n"
         "      c_epi += clock64() - c_g1;"),
        ("    tt = next;\n  }\n",
         "    tt = next;\n    ++c_tiles;\n  }\n"
         "  if (threadIdx.x == 0 && blockIdx.x < 4096) {\n"
         "    long long* ck = clk[blockIdx.x];\n"
         "    ck[0] = c_setup - c_start; ck[1] = c_stage; ck[2] = c_prod;\n"
         "    ck[3] = c_tiles; ck[4] = clock64() - c_start; ck[5] = 1;\n"
         "    ck[6] = c_img - c_start; ck[7] = c_first; ck[8] = c_epi;\n"
         "  }\n"),
    ],
}
_ENTRY_CLOCK = '''
extern "C" int entry_clock_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, c1::clk, sizeof(c1::clk));
}
extern "C" int entry_clock_reset() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, c1::clk);
  return e != cudaSuccess ? (int)e : (int)cudaMemset(p, 0, sizeof(c1::clk));
}
'''
# The slots of a block in `c1::clk` (the clock variant), and the flag.
ENTRY_ROLES = {"setup": 0, "first_tile": 7, "staging": 1, "products": 2,
               "epilogue": 8, "tiles": 3, "block": 4, "images_laid": 6}
# (B, Co, D, H, W) of the three entries of the 368x1232 forward, of
# AnyNet's three (`parity_layers.ANYNET`) and of a 64-channel filter's over
# D = 72.
ENTRY_SHAPES = {"stage1": (1, 32, 24, 46, 154), "stage2": (1, 8, 9, 92, 308),
                "stage3": (1, 8, 9, 184, 616),
                "anynet1": (1, 16, 12, 46, 154),
                "anynet2": (1, 4, 5, 92, 308),
                "anynet3": (1, 4, 5, 184, 616),
                "wide": (1, 64, 72, 46, 154)}
# The CUDA-core kernel at the bf16 1 -> 4, 16 and 64 entries (`use_tc`
# without them), the route `c1` replaced there.
_NO_C1 = ("(Ci == 1 && (Co == 4 || Co == 8 || Co == 16 || Co == tc::N ||\n"
          "                       Co == 64))",
          "(Ci == 1 && (Co == tc::N || Co == 8))")


def namespace_body(src, namespace):
    """(head, body, rest) of `src` around the namespace that opens with
    `namespace` ("namespace c8 {", or "namespace {" for the anonymous one)
    and closes with its "}  // namespace <name>" line."""
    name = namespace[len("namespace"):-1].strip()
    close = "}  // namespace" + (f" {name}" if name else "") + "\n"
    head, rest = src.split(namespace, 1)
    body, after = rest.split(close, 1)
    return head + namespace, body, close + after


DWSEP_VARIANTS = {
    "clock": [("constexpr bool CLOCK = false;",
               "constexpr bool CLOCK = true;")],
}
_DWSEP_CLOCK = '''
extern "C" int dwsep_clock_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, clk, sizeof(clk));
}
extern "C" int dwsep_clock_reset() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, clk);
  return e != cudaSuccess ? (int)e : (int)cudaMemset(p, 0, sizeof(clk));
}
'''
# The slots of a block in `clk` (csrc/dwsep3x3.cu: enum Slot).
DWSEP_SLOTS = ("staging", "taps", "pointwise", "stores", "barriers",
               "grid_barrier", "tiles", "total")
DWSEP_WIDTHS = (48, 20, 64)


def write_variant(name, edits, out_dir, source="conv3d_bn_relu",
                  namespace="namespace c8 {", tail=""):
    """The variant's sources in out_dir; raises where an edit's anchor is
    not found exactly once in the route's namespace (from its opening line
    to its closing "}  // namespace" line, so that an anchor of the c8
    route does not also match the c1 route after it; None: the whole
    file). `tail` is appended to the file."""
    csrc = os.path.join(ROOT, "lwsnet_tpu_torch", "csrc")
    src = open(os.path.join(csrc, f"{source}.cu")).read()
    head, body, rest = (("", src, "") if namespace is None
                        else namespace_body(src, namespace))
    for old, new in edits:
        if body.count(old) != 1:
            raise RuntimeError(f"{name}: anchor found {body.count(old)} "
                               f"times: {old[:60]!r}")
        body = body.replace(old, new)
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), out_dir)
    with open(os.path.join(out_dir, f"{source}.cu"), "w") as f:
        f.write(head + body + rest + tail)


def build_variants(variants, base, source, namespace, tails, kernel=None):
    """Write and build every variant at once; {name: CDLL} (and "repo":
    None) and rc 2 if a build failed. `kernel`: a substring of kernel
    names whose ptxas register, shared-memory and spill lines are printed
    for each variant."""
    from lwsnet_tpu_torch.ops.cuda import build
    jobs = {}
    for name, edits in variants.items():
        d = os.path.join(base, name)
        write_variant(name, edits, d, source, namespace, tails.get(name, ""))
        so = os.path.join(d, f"lib{source}.so")
        jobs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so,
             os.path.join(d, f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, rc = {"repo": None}, 0
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: build failed\n{out}")
            rc = 2
            continue
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if kernel and "Compiling entry" in line and kernel in line:
                print(f"{name}: ptxas {line.split()[-3]}: "
                      + "; ".join(x.split(":", 1)[-1].strip()
                                  for x in lines[i + 2:i + 4]))
        libs[name] = ctypes.CDLL(so)
    return libs, rc


def skip_variants(dev, report):
    """The --skip family: each variant checked and timed at SKIP_SHAPES;
    rc 2 if a build or a check failed."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.ops.cuda import costfilter as CF
    libs, rc = build_variants(
        SKIP_VARIANTS, os.path.join(ROOT, "build", "skip_variants"),
        "conv3d_skip_softargmin", "namespace tcr {",
        {"clock": _SKIP_CLOCK_READ})

    def operands(B, C, D, H, W):
        rng = np.random.default_rng(0)
        x = torch.as_tensor(np.maximum(rng.standard_normal(
            (B, C, D, H, W)), 0), dtype=torch.float32).to(
            dev, torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d)
        wt = torch.as_tensor(rng.standard_normal((1, C, 3, 3, 3))
                             * np.sqrt(2 / (27 * C)), dtype=torch.float32)
        vol = torch.as_tensor(rng.standard_normal((B, D, H, W)) * 2,
                              dtype=torch.float32)
        return x, wt.to(dev, torch.bfloat16), vol.to(dev, torch.bfloat16)

    kern = build.CONV3D_SKIP_SOFTARGMIN
    kern._fn("conv3d_skip_softargmin_bf16")  # loads the library
    repo_lib = kern._lib
    for name, lib in libs.items():
        kern._lib = repo_lib if lib is None else lib
        kern._fns = {}
        row = {}
        for shape, (B, C, D, H, W, start) in SKIP_SHAPES.items():
            x, wt, vol = operands(B, C, D, H, W)
            want = CF.conv3d_skip_softargmin_plain(x, wt, vol, start)
            got = CF.conv3d_skip_softargmin(x, wt, vol, start)
            tol = 2 * 2.0 ** -8 * want.abs() + 2e-2 * want.abs().max()
            bad = int(((got - want).abs() > tol).sum())
            if bad:
                print(f"{name}: {shape}: {bad} elements beyond two rounding "
                      f"steps")
                rc = 2
            ms = cs.kernel_device_ms(
                lambda: CF.conv3d_skip_softargmin(x, wt, vol, start),
                "skip_softargmin")
            row[shape] = ms
            print(f"{name}: {shape}: "
                  f"{'not measured' if ms is None else f'{ms:.4f} ms'}")
            if name.endswith("clock"):
                torch.cuda.synchronize()
                lib.skip_clock_reset()
                CF.conv3d_skip_softargmin(x, wt, vol, start)
                torch.cuda.synchronize()
                clk = np.zeros(SKIP_BLOCKS * 16, np.int64)
                lib.skip_clock_read(ctypes.c_void_p(clk.ctypes.data))
                c = clk.reshape(SKIP_BLOCKS, 16)
                c = c[c[:, 5] == 1]
                split = {r: float(np.median(c[:, k]))
                         for r, k in SKIP_ROLES.items()}
                split["blocks"] = int(len(c))
                starts = c[:, 0] - c[:, 0].min()
                split["start_spread_ns"] = [float(np.percentile(starts, q))
                                            for q in (50, 90, 100)]
                split["span_ns"] = float((c[:, 0] + c[:, 10]).max()
                                         - c[:, 0].min())
                split["blocks_per_sm_max"] = int(np.bincount(c[:, 6]).max())
                row[f"{shape} clock64"] = split
                print(f"{name}: {shape} clock64 medians over the blocks "
                      f"(thread 0): {split}")
        report["variants"][name] = row
    kern._lib = repo_lib
    kern._fns = {}
    return rc


def entry_variants(dev, report):
    """The --entry family: each variant of the route (`c1`) checked and
    timed at ENTRY_SHAPES, alone and with the stage's first C -> C layer,
    and at the 4-, 16- and 64-channel shapes the CUDA-core kernel that
    took those entries before it (`ENTRY_CORES_VARIANTS`, called with
    (1, 27, Co) weights, writing NCDHW at 4 and channels-last at 16 and 64,
    as the path had it), alone; the clock variants' splits; rc 2 if a
    build or a check failed."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.ops.cuda import costfilter as CF
    base = os.path.join(ROOT, "build", "entry_variants")
    libs, rc = build_variants(
        ENTRY_VARIANTS, base, "conv3d_bn_relu", "namespace c1 {",
        {"clock": _ENTRY_CLOCK})
    cores, rc2 = build_variants(
        ENTRY_CORES_VARIANTS, base, "conv3d_bn_relu", "namespace {",
        {"entry_cores_clock": _CORES_CLOCK})
    cores.pop("repo")
    rc = rc or rc2

    def operands(B, Co, D, H, W):
        rng = np.random.default_rng(0)

        def t(a, dt=torch.bfloat16):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(
                dev, dt)

        return (t(rng.standard_normal((B, D, H, W))),
                t([rng.uniform(0.5, 1.5), rng.uniform(0.1, 0.5)],
                  torch.float32),
                t(rng.standard_normal((Co, 1, 3, 3, 3)) * np.sqrt(2 / 27)),
                t(rng.normal(0, 0.1, Co), torch.float32),
                t(rng.standard_normal((Co, Co, 3, 3, 3))
                  * np.sqrt(2 / (27 * Co))),
                t(rng.normal(0, 0.1, Co), torch.float32))

    def cores_call(lib, vol, a0b0, wt, sh):
        """The CUDA-core kernel of `lib` at a bf16 1 -> Co entry, layer 0's
        affine at its loads, its weights as (1, 27, Co), writing NCDHW at 4
        outputs and channels-last otherwise; a fn of no arguments."""
        fn = lib.conv3d_bn_relu_bf16
        fn.argtypes = build.CONV3D_BN_RELU.argtypes
        fn.restype = ctypes.c_int
        B, D, H, W = vol.shape
        Co = wt.shape[0]
        wk = wt.permute(1, 2, 3, 4, 0).reshape(1, 27, Co).contiguous()
        y_cl = Co != 4
        y = (torch.empty((B, D, H, W, Co), dtype=vol.dtype,
                         device=vol.device).permute(0, 4, 1, 2, 3) if y_cl
             else torch.empty((B, Co, D, H, W), dtype=vol.dtype,
                              device=vol.device))

        def run():
            rc = fn(vol.data_ptr(), wk.data_ptr(), sh.data_ptr(),
                    a0b0.data_ptr(), y.data_ptr(), B, 1, Co, D, H, W, 0,
                    int(y_cl), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"cudaError {rc}")
            return y
        return run

    def split(read, reset, fn, roles, flag):
        torch.cuda.synchronize()
        reset()
        fn()
        torch.cuda.synchronize()
        width = 12 if flag == 5 else 8
        clk = np.zeros(4096 * width, np.int64)
        read(ctypes.c_void_p(clk.ctypes.data))
        c = clk.reshape(4096, width)
        c = c[c[:, flag] == 1]
        out = {r: float(np.median(c[:, k])) for r, k in roles.items()}
        out["blocks"] = int(len(c))
        return out

    kern = build.CONV3D_BN_RELU
    kern._fn("conv3d_bn_relu_bf16")  # loads the library
    repo_lib = kern._lib
    for name, lib in list(libs.items()) + list(cores.items()):
        on_c1 = name in libs
        kern._lib = repo_lib if lib is None else lib
        kern._fns = {}
        row = {}
        for shape, dims in ENTRY_SHAPES.items():
            if not on_c1 and dims[1] not in (4, 16, 64):
                continue
            vol, a0b0, wt, sh, wt2, sh2 = operands(*dims)
            entry = ((lambda: CF.conv3d_entry(vol, a0b0, wt, sh)) if on_c1
                     else cores_call(lib, vol, a0b0, wt, sh))
            want = CF.conv3d_entry_plain(vol, a0b0, wt, sh).float()
            got = entry().float()
            tol = 2 * 2.0 ** -8 * want.abs() + 2e-2 * want.abs().max()
            bad = int(((got - want).abs() > tol).sum())
            if bad:
                print(f"{name}: {shape}: {bad} elements beyond two rounding "
                      f"steps")
                rc = 2
            timed = [("entry", entry)]
            if on_c1:
                timed.append(("entry + C->C", lambda: CF.conv3d_bn_relu(
                    CF.conv3d_entry(vol, a0b0, wt, sh), wt2, sh2)))
            for key, fn in timed:
                ms = cs.kernel_device_ms(fn, "conv3d_bn_relu")
                row[f"{shape} {key}"] = ms
                print(f"{name}: {shape} {key}: "
                      f"{'not measured' if ms is None else f'{ms:.4f} ms'}")
            clock = (("entry", ENTRY_ROLES, 5) if name == "clock" else
                     ("cores", CORES_ROLES, 6)
                     if name == "entry_cores_clock" else None)
            if clock:
                pre, roles, flag = clock
                row[f"{shape} clock64"] = out = split(
                    getattr(lib, f"{pre}_clock_read"),
                    getattr(lib, f"{pre}_clock_reset"), entry, roles, flag)
                print(f"{name}: {shape} clock64 medians over the blocks "
                      f"(thread 0, clocks): {out}")
        report["variants"][name] = row
    kern._lib = repo_lib
    kern._fns = {}
    return rc


def dwsep_variants(dev, report):
    """The --dwsep family: each variant checked and timed at the "vpu"
    engines' dw-sep launches of the 368x1232 forward at DWSEP_WIDTHS, the
    clock variant's split of each; rc 2 if a build or a check failed."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.ops.cuda import build
    libs, rc = build_variants(
        DWSEP_VARIANTS, os.path.join(ROOT, "build", "dwsep_variants"),
        "dwsep3x3", "namespace {", {"clock": _DWSEP_CLOCK})
    calls = [(k, f"{label} at {w}", p, n)
             for w in DWSEP_WIDTHS
             for k, label, p, n, engine in cs.variant_calls(
                 ModelConfig(refine_channels=w))
             if k.startswith("dwsep") and "vpu" in engine]
    kernels = (build.DWSEP3X3, build.DWSEP3X3_PAIR)
    build.DWSEP3X3._fn("dwsep3x3_bf16")  # loads the library
    repo_lib = build.DWSEP3X3._lib
    for name, lib in libs.items():
        for k in kernels:
            k._lib = repo_lib if lib is None else lib
            k._fns = {}
        row = {}
        for i, (kernel, label, p, n) in enumerate(calls):
            c = cs.make_call(kernel, p, torch.bfloat16,
                             np.random.default_rng(6000 + i), dev)
            want, got = c["plain"]().float(), c["kernel"]().float()
            tol = 2 * 2.0 ** -8 * want.abs() + 2e-2 * want.abs().max()
            bad = int(((got - want).abs() > tol).sum())
            if bad:
                print(f"{name}: {kernel} [{label}]: {bad} elements beyond "
                      f"two rounding steps")
                rc = 2
            ms = cs.kernel_device_ms(c["kernel"], "dwsep")
            row[f"{kernel} [{label}]"] = dict(device_ms=ms, launches=n)
            print(f"{name}: {kernel} [{label}] x{n}: "
                  f"{'not measured' if ms is None else f'{ms:.4f} ms'}")
            if name == "clock":
                torch.cuda.synchronize()
                lib.dwsep_clock_reset()
                c["kernel"]()
                torch.cuda.synchronize()
                clk = np.zeros(1024 * len(DWSEP_SLOTS), np.int64)
                lib.dwsep_clock_read(ctypes.c_void_p(clk.ctypes.data))
                ck = clk.reshape(1024, len(DWSEP_SLOTS))
                ck = ck[ck[:, DWSEP_SLOTS.index("tiles")] > 0]
                split = {s: float(np.median(ck[:, j]))
                         for j, s in enumerate(DWSEP_SLOTS)}
                total = split["total"]
                split["share"] = {s: round(split[s] / total, 4)
                                  for s in DWSEP_SLOTS[:6]}
                split["blocks"] = int(len(ck))
                row[f"{kernel} [{label}] clock64"] = split
                print(f"{name}: {kernel} [{label}] clock64 medians over the "
                      f"blocks (thread 0, clocks): {split}")
            del c
        report["variants"][name] = row
    for k in kernels:
        k._lib = repo_lib
        k._fns = {}
    return rc


DENSE32_VARIANTS = {
    "clock": [('#include "dense3x3_entry.cuh"',
               '#define DENSE_F32_CLOCK 1\n#include "dense3x3_entry.cuh"')],
}
_DENSE32_CLOCK = '''
extern "C" int dense32_clock_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, dense_f32::clk, sizeof(dense_f32::clk));
}
extern "C" int dense32_clock_reset() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, dense_f32::clk);
  return e != cudaSuccess ? (int)e
                          : (int)cudaMemset(p, 0, sizeof(dense_f32::clk));
}
'''
# The slots of a block in `dense_f32::clk` (csrc/dense3x3_f32.cuh: Slot).
DENSE32_SLOTS = ("free_wait", "issue", "landed_wait", "activation", "setup",
                 "full_wait", "products", "epilogue", "tiles", "total")


def dense32_variants(dev, report):
    """The --dense32 family: each variant checked and timed at the float32
    "mxu" forward's launches of dense3x3's float32 route, the clock
    variant's split of each; rc 2 if a build or a check failed."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.tools.parity import tf32_off
    libs, rc = build_variants(
        DENSE32_VARIANTS, os.path.join(ROOT, "build", "dense32_variants"),
        "dense3x3", None, {"clock": _DENSE32_CLOCK}, kernel="dense_f32")
    calls = [c for c in cs.main_path_calls(ModelConfig(), torch.float32)
             if c[0] == "dense3x3"
             and cs.dense_route(c[2], torch.float32) == "f32"]
    build.DENSE3X3._fn("dense3x3_f32")  # loads the library
    repo_lib = build.DENSE3X3._lib
    with tf32_off():
        for name, lib in libs.items():
            build.DENSE3X3._lib = repo_lib if lib is None else lib
            build.DENSE3X3._fns = {}
            row = {}
            for i, (kernel, label, p, n, _) in enumerate(calls):
                c = cs.make_call(kernel, p, torch.float32,
                                 np.random.default_rng(7000 + i), dev)
                want, got = c["plain"](), c["kernel"]()
                bad = int((~torch.isclose(got, want, atol=2e-4,
                                          rtol=1e-3)).sum())
                if bad:
                    print(f"{name}: {label}: {bad} elements beyond atol "
                          f"2e-4 / rtol 1e-3")
                    rc = 2
                ms = cs.kernel_device_ms(c["kernel"], "dense3x3")
                row[label] = dict(device_ms=ms, launches=n)
                print(f"{name}: {label} x{n}: "
                      f"{'not measured' if ms is None else f'{ms:.4f} ms'}")
                if name == "clock":
                    torch.cuda.synchronize()
                    lib.dense32_clock_reset()
                    c["kernel"]()
                    torch.cuda.synchronize()
                    k = len(DENSE32_SLOTS)
                    clk = np.zeros(132 * k, np.int64)
                    lib.dense32_clock_read(ctypes.c_void_p(clk.ctypes.data))
                    ck = clk.reshape(132, k)
                    ck = ck[ck[:, DENSE32_SLOTS.index("tiles")] > 0]
                    split = {s: float(np.median(ck[:, j]))
                             for j, s in enumerate(DENSE32_SLOTS)}
                    split["share"] = {
                        s: round(split[s] / split["total"], 4)
                        for s in DENSE32_SLOTS[4:8]}
                    split["blocks"] = int(len(ck))
                    row[f"{label} clock64"] = split
                    print(f"{name}: {label} clock64 medians over the blocks "
                          f"(clocks): {split}")
                del c
            report["variants"][name] = row
    build.DENSE3X3._lib = repo_lib
    build.DENSE3X3._fns = {}
    return rc


C4_VARIANTS = {
    "blocks1": [("constexpr int MIN_BLOCKS = 2;",
                 "constexpr int MIN_BLOCKS = 1;")],
    "clock": [
        ("constexpr int MIN_BLOCKS = 2;",
         "__device__ long long clk[4096][8];\n"
         "constexpr int MIN_BLOCKS = 2;"),
        ("  const int ntiles = tiles(a);\n  int t = blockIdx.x;",
         "  const long long c_start = clock64();\n"
         "  long long c_stage = 0, c_prod = 0, c_epi = 0, c_first = 0;\n"
         "  int c_tiles = 0;\n"
         "  const int ntiles = tiles(a);\n  int t = blockIdx.x;"),
        ("    __syncthreads();  // the last tile's A reads done",
         "    const long long c_top = clock64();\n"
         "    if (c_tiles == 0) c_first = c_top - c_start;\n"
         "    __syncthreads();  // the last tile's A reads done"),
        ("    __syncthreads();  // the tile staged\n",
         "    __syncthreads();  // the tile staged\n"
         "    const long long c_staged = clock64();\n"
         "    c_stage += c_staged - c_top;\n"),
        ("    // relu, one rounding, and each channel's pixel pair to y",
         "    const long long c_prods = clock64();\n"
         "    c_prod += c_prods - c_staged;\n"
         "    // relu, one rounding, and each channel's pixel pair to y"),
        # thread 0 (pixel w0, row h0 + 1) reaches the stores at C4_SHAPES
        # (H a multiple of 4)
        ("(p)[1] = u >> 16;\n        }\n      }\n    }\n  }\n}",
         "(p)[1] = u >> 16;\n        }\n      }\n    }\n"
         "    c_epi += clock64() - c_prods;\n    ++c_tiles;\n  }\n"
         "  if (threadIdx.x == 0 && blockIdx.x < 4096) {\n"
         "    long long* ck = clk[blockIdx.x];\n"
         "    ck[0] = c_stage; ck[1] = c_prod; ck[2] = c_epi;\n"
         "    ck[3] = c_first; ck[4] = c_tiles;\n"
         "    ck[5] = clock64() - c_start; ck[6] = 1;\n"
         "  }\n}"),
    ],
}
_C4_CLOCK = '''
extern "C" int c4_clock_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, c4::clk, sizeof(c4::clk));
}
extern "C" int c4_clock_reset() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, c4::clk);
  return e != cudaSuccess ? (int)e : (int)cudaMemset(p, 0, sizeof(c4::clk));
}
'''
C4_ROLES = {"staging": 0, "products": 1, "epilogue": 2, "setup": 3,
            "tiles": 4, "block": 5}
# The CUDA-core kernel at bf16 4 -> 4 (`use_tc` without its 4 -> 4 clause)
_NO_C4 = ("(Ci == Co && (Ci == 8 || Ci == 4))", "(Ci == Co && Ci == 8)")
CORES_VARIANTS = {
    "cores": [_NO_C4],
    "cores_clock": [
        _NO_C4,
        ("constexpr int CI_CHUNK = 8;",
         "constexpr int CI_CHUNK = 8;\n__device__ long long clk[4096][8];"),
        ("  const float a0 = AFF ? aff[0] : 1.f, b0 = AFF ? aff[1] : 0.f;\n",
         "  const float a0 = AFF ? aff[0] : 1.f, b0 = AFF ? aff[1] : 0.f;\n"
         "  long long c_w = 0, c_taps = 0, c0 = clock64();\n"),
        ("    __syncthreads();\n    if (!active) continue;",
         "    __syncthreads();\n    const long long c1_ = clock64();\n"
         "    c_w += c1_ - c0;\n    if (!active) continue;"),
        ("  if (!active) return;\n  const size_t voxel",
         "  c_taps = clock64() - c0 - c_w;\n"
         "  const long long c_end = clock64();\n"
         "  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
         " + blockIdx.x;\n"
         "  if (!active) return;\n  const size_t voxel"),
        # thread 0 is always inside the volume: it reaches the NCDHW stores
        ("        yb[c * vol] = from_f<T>(fmaxf(acc[c] + shift[co0 + c], "
         "0.f));\n    return;",
         "        yb[c * vol] = from_f<T>(fmaxf(acc[c] + shift[co0 + c], "
         "0.f));\n"
         "    if (threadIdx.x == 0 && blk < 4096) {\n"
         "      clk[blk][0] = c_w; clk[blk][1] = c_taps;\n"
         "      clk[blk][2] = clock64() - c_end; clk[blk][6] = 1;\n"
         "    }\n    return;"),
    ],
    "cores_noload": [
        _NO_C4,
        ("            float v = to_f(xc[dd * plane + (size_t)hh * W + ww]);",
         "            float v = (float)((dd * plane + (size_t)hh * W + ww)"
         " & 7);"),
    ],
    "cores_nofma": [
        _NO_C4,
        ("            for (int c = 0; c < CO_T; ++c) acc[c] = fmaf(v, wp[c], "
         "acc[c]);",
         "            for (int c = 0; c < 1; ++c) acc[c] = fmaf(v, wp[c], "
         "acc[c]);"),
    ],
}
_CORES_CLOCK = '''
extern "C" int cores_clock_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, clk, sizeof(clk));
}
extern "C" int cores_clock_reset() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, clk);
  return e != cudaSuccess ? (int)e : (int)cudaMemset(p, 0, sizeof(clk));
}
'''
# The CUDA-core kernel as the bf16 1 -> 4, 16 and 64 entries ran it, and
# its clock64() split (`CORES_VARIANTS`' marks, and one at the
# channels-last stores, which the 16- and 64-channel entries wrote).
ENTRY_CORES_VARIANTS = {
    "entry_cores": [_NO_C1],
    "entry_cores_clock": [_NO_C1] + CORES_VARIANTS["cores_clock"][1:] + [
        ("        *reinterpret_cast<uint4*>(yb + c0) =\n"
         "            *reinterpret_cast<const uint4*>(v);\n      }\n"
         "      return;",
         "        *reinterpret_cast<uint4*>(yb + c0) =\n"
         "            *reinterpret_cast<const uint4*>(v);\n      }\n"
         "      if (threadIdx.x == 0 && blk < 4096) {\n"
         "        clk[blk][0] = c_w; clk[blk][1] = c_taps;\n"
         "        clk[blk][2] = clock64() - c_end; clk[blk][6] = 1;\n"
         "      }\n      return;")],
}
CORES_ROLES = {"weights": 0, "taps": 1, "stores": 2}
# (B, D, H, W) of AnyNet's 4 -> 4 layers: SHAPES' geometry at D = 5.
C4_SHAPES = {k: (B, 5, H, W) for k, (B, _, H, W) in SHAPES.items()}



# The --skip4 family: the fused last layer's 4-channel route (`s4` in
# csrc/conv3d_skip_softargmin.cu) and the CUDA-core kernel it replaced,
# whose variants send Ci = 4 back to the CUDA cores by removing the
# dispatcher's `case 4` (edits anywhere in the file: namespace None).
_NO_S4 = ("    case 4:\n"
          "      return s4::launch(x, wt, vol, out, B, D, H, W, start, s);\n",
          "")
# s4's blocks an SM (launch bounds)
_S4_BLOCKS = ("constexpr int MIN_BLOCKS = 2;  // an SM: at most 128 registers\n"
              "\nstruct Args {\n  const uint16_t* x;    // (B, 4, D, H, W)\n")
SKIP4_VARIANTS = {
    **{f"blocks{n}": [(_S4_BLOCKS, _S4_BLOCKS.replace("2;", f"{n};"))]
       for n in (1, 3, 4)},
    "clock": [
        (_S4_BLOCKS, "__device__ long long clk[4096][16];\n" + _S4_BLOCKS),
        ("  const int ncols = columns(a), nd = ceil_div(a.D, TD);\n",
         "  const long long c_start = clock64();\n"
         "  long long c_stage = 0, c_prod = 0, c_epi = 0, c_first = 0;\n"
         "  int c_tiles = 0;\n"
         "  const int ncols = columns(a), nd = ceil_div(a.D, TD);\n"),
        ("  uint32_t vnext[TD];\n  if (t < ncols) {\n",
         "  uint32_t vnext[TD];\n"
         "  const long long c_ix = clock64() - c_start;\n"
         "  if (t < ncols) {\n"),
        ("    load_volume(a, tt, orow, opix, vnext);\n  }\n",
         "    load_volume(a, tt, orow, opix, vnext);\n  }\n"
         "  const long long c_issued = clock64() - c_start;\n"),
        ("  while (t < ncols) {\n    __syncthreads();  // the last tile's A "
         "reads done\n",
         "  const long long c_setup = clock64() - c_start;\n"
         "  while (t < ncols) {\n    const long long c_top = clock64();\n"
         "    __syncthreads();  // the last tile's A reads done\n"),
        ("    __syncthreads();  // the tile staged\n",
         "    __syncthreads();  // the tile staged\n"
         "    const long long c_staged = clock64();\n"
         "    if (c_tiles == 0) c_first = c_staged - c_top;\n"
         "    else c_stage += c_staged - c_top;\n"),
        ("    // the skip, then this tile's depths into the running "
         "soft-argmin\n",
         "    const long long c_prods = clock64();\n"
         "    c_prod += c_prods - c_staged;\n"
         "    // the skip, then this tile's depths into the running "
         "soft-argmin\n"),
        ("      a.out[((size_t)cur.b * a.H + h) * a.W + w] = run_num / "
         "run_den;\n  }\n}\n",
         "      a.out[((size_t)cur.b * a.H + h) * a.W + w] = run_num / "
         "run_den;\n"
         "    c_epi += clock64() - c_prods;\n    ++c_tiles;\n  }\n"
         "  if (threadIdx.x == 0 && blockIdx.x < 4096) {\n"
         "    long long* ck = clk[blockIdx.x];\n"
         "    ck[0] = c_stage; ck[1] = c_prod; ck[2] = c_epi;\n"
         "    ck[3] = c_setup; ck[4] = c_tiles; ck[5] = clock64() - c_start;\n"
         "    ck[6] = 1; ck[7] = c_first; ck[8] = c_ix; ck[9] = c_issued;\n"
         "  }\n}\n"),
    ],
    "cores": [_NO_S4],
    "cores_clock": [
        _NO_S4,
        ("constexpr int CI_CHUNK = 32;  // input channels whose weights a "
         "block stages\n",
         "constexpr int CI_CHUNK = 32;  // input channels whose weights a "
         "block stages\n__device__ long long clk[4096][8];\n"),
        ("  float run_m = 0.f, run_den = 0.f, run_num = 0.f;\n"
         "  for (int d0 = 0; d0 < D; d0 += D_CHUNK) {\n",
         "  float run_m = 0.f, run_den = 0.f, run_num = 0.f;\n"
         "  const long long c_start = clock64();\n"
         "  long long c_w = 0, c_taps = 0, c_skip = 0, c_soft = 0;\n"
         "  for (int d0 = 0; d0 < D; d0 += D_CHUNK) {\n"),
        ("      __syncthreads();  // the last chunk's weights and costs read\n",
         "      const long long cw0 = clock64();\n"
         "      __syncthreads();  // the last chunk's weights and costs read\n"),
        ("      __syncthreads();\n      if (w >= W) continue;\n",
         "      __syncthreads();\n      c_w += clock64() - cw0;\n"
         "      if (w >= W) continue;\n"
         "      const long long ct0 = clock64();\n"),
        ("        acc[k] = a;\n      }\n",
         "        acc[k] = a;\n      }\n      c_taps += clock64() - ct0;\n"),
        ("    if (w < W) {\n#pragma unroll\n      for (int k = 0; k < D_PER; "
         "++k) {\n        const int dl = ty + k * D_LANES;\n",
         "    const long long cs0 = clock64();\n"
         "    if (w < W) {\n#pragma unroll\n      for (int k = 0; k < D_PER; "
         "++k) {\n        const int dl = ty + k * D_LANES;\n"),
        ("    __syncthreads();\n    if (ty != 0 || w >= W) continue;\n",
         "    __syncthreads();\n    c_skip += clock64() - cs0;\n"
         "    if (ty != 0 || w >= W) continue;\n"
         "    const long long cm0 = clock64();\n"),
        ("      run_m = mm;\n    }\n  }\n  if (ty == 0 && w < W)",
         "      run_m = mm;\n    }\n    c_soft += clock64() - cm0;\n  }\n"
         "  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
         " + blockIdx.x;\n"
         "  if (threadIdx.x == 0 && blk < 4096) {\n"
         "    clk[blk][0] = c_w; clk[blk][1] = c_taps; clk[blk][2] = c_skip;\n"
         "    clk[blk][3] = c_soft; clk[blk][5] = clock64() - c_start;\n"
         "    clk[blk][6] = 1;\n  }\n"
         "  if (ty == 0 && w < W)"),
    ],
}
_SKIP4_CLOCK = _C4_CLOCK.replace("c4_clock", "skip4_clock").replace(
    "c4::clk", "s4::clk")
_SKIP4_CORES_CLOCK = _CORES_CLOCK
# The slots of a block in `s4::clk` (the clock variant): thread 0's
# staging of later tiles (barrier, stores, the next tile's loads issued,
# barrier), products (A reads, mma.sync and the kd exchange), epilogue
# (skip, soft-argmin, fold, store), set-up (B fragments, the first tile's
# loads issued), tiles a block, the block's total, and the first tile's
# staging (the wait for its loads, issued in the set-up, and its stores).
SKIP4_ROLES = {"staging": 0, "products": 1, "epilogue": 2, "setup": 3,
               "tiles": 4, "block": 5, "first_tile": 7, "indices_at": 8,
               "loads_issued_at": 9}
# ... and in the CUDA-core kernel's `clk` (cores_clock): the weights staged
# (two block barriers), the taps (loads and FMAs of thread 0's depths),
# the costs and the volume into shared memory with the barrier after, and
# warp 0's soft-argmin, each summed over the chunks; the block's total.
SKIP4_CORES_ROLES = {"weights": 0, "taps": 1, "skip": 2, "soft_argmin": 3,
                     "block": 5}
# (B, D, H, W, start) of AnyNet's 4 -> 1 layers: SHAPES' geometry at D = 5,
# residual bins from -2.
SKIP4_SHAPES = {k: (B, 5, H, W, -2) for k, (B, _, H, W) in SHAPES.items()}


def skip4_variants(dev, report):
    """The --skip4 family: each variant of the 4-channel route (`s4`) and
    of the CUDA-core kernel it replaced, checked (every element within two
    bf16 rounding steps of `conv3d_skip_softargmin_plain`) and timed alone
    on the device at SKIP4_SHAPES, NCDHW in; the clock variants' splits
    (medians over the blocks, thread 0, in clocks). rc 2 if a build or a
    check failed."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.ops.cuda import costfilter as CF
    libs, rc = build_variants(
        SKIP4_VARIANTS, os.path.join(ROOT, "build", "skip4_variants"),
        "conv3d_skip_softargmin", None,
        {"clock": _SKIP4_CLOCK, "cores_clock": _SKIP4_CORES_CLOCK},
        kernel="c4_kernel")

    def operands(B, D, H, W):
        rng = np.random.default_rng(0)
        x = torch.as_tensor(np.maximum(rng.standard_normal((B, 4, D, H, W)),
                                       0), dtype=torch.float32)
        wt = torch.as_tensor(rng.standard_normal((1, 4, 3, 3, 3))
                             * np.sqrt(2 / 108), dtype=torch.float32)
        vol = torch.as_tensor(rng.standard_normal((B, D, H, W)) * 2,
                              dtype=torch.float32)
        return (x.to(dev, torch.bfloat16), wt.to(dev, torch.bfloat16),
                vol.to(dev, torch.bfloat16))

    def cores_call(lib, x, wt, vol, start):
        """The CUDA-core kernel of `lib` at bf16 4 -> 1, NCDHW in, the
        weights as (1, 4, 3, 3, 3); a fn of no arguments."""
        fn = lib.conv3d_skip_softargmin_bf16
        fn.argtypes = build.CONV3D_SKIP_SOFTARGMIN.argtypes
        fn.restype = ctypes.c_int
        B, _, D, H, W = x.shape
        out = torch.empty((B, H, W), dtype=torch.float32, device=x.device)

        def run():
            rc = fn(x.data_ptr(), wt.data_ptr(), vol.data_ptr(),
                    out.data_ptr(), B, 4, D, H, W, float(start),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"cudaError {rc}")
            return out
        return run

    def split(read, reset, fn, roles, slots):
        torch.cuda.synchronize()
        reset()
        fn()
        torch.cuda.synchronize()
        clk = np.zeros(4096 * slots, np.int64)
        read(ctypes.c_void_p(clk.ctypes.data))
        c = clk.reshape(4096, slots)
        c = c[c[:, 6] == 1]
        out = {r: float(np.median(c[:, k])) for r, k in roles.items()}
        out["blocks"] = int(len(c))
        return out

    kern = build.CONV3D_SKIP_SOFTARGMIN
    kern._fn("conv3d_skip_softargmin_bf16")  # loads the library
    repo_lib = kern._lib
    for name, lib in libs.items():
        on_s4 = not name.startswith("cores")
        kern._lib = repo_lib if lib is None else lib
        kern._fns = {}
        row = {}
        for shape, (B, D, H, W, start) in SKIP4_SHAPES.items():
            x, wt, vol = operands(B, D, H, W)
            fn = ((lambda: CF.conv3d_skip_softargmin(x, wt, vol, start))
                  if on_s4 else cores_call(lib, x, wt, vol, start))
            want = CF.conv3d_skip_softargmin_plain(x, wt, vol, start)
            got = fn()
            tol = 2 * 2.0 ** -8 * want.abs() + 2e-2 * want.abs().max()
            bad = int(((got - want).abs() > tol).sum())
            if bad:
                print(f"{name}: {shape}: {bad} elements beyond two rounding "
                      f"steps")
                rc = 2
            ms = cs.kernel_device_ms(fn, "skip_softargmin")
            row[shape] = ms
            print(f"{name}: {shape} 4->1: "
                  f"{'not measured' if ms is None else f'{ms:.4f} ms'}")
            if name in ("clock", "cores_clock"):
                prefix = "skip4" if name == "clock" else "cores"
                row[f"{shape} clock64"] = out = split(
                    getattr(lib, f"{prefix}_clock_read"),
                    getattr(lib, f"{prefix}_clock_reset"), fn,
                    *((SKIP4_ROLES, 16) if name == "clock"
                      else (SKIP4_CORES_ROLES, 8)))
                print(f"{name}: {shape} clock64 medians over the blocks "
                      f"(thread 0, clocks): {out}")
        report["variants"][name] = row
    kern._lib = repo_lib
    kern._fns = {}
    return rc

def c4_variants(dev, report):
    """The --c4 family: each variant of the 4 -> 4 route and of the
    CUDA-core kernel it replaced, checked and timed at C4_SHAPES, the clock
    variants' splits; rc 2 if a build or a check failed."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.ops.cuda import costfilter as CF
    base = os.path.join(ROOT, "build", "c4_variants")
    libs, rc = build_variants(C4_VARIANTS, base, "conv3d_bn_relu",
                              "namespace c4 {", {"clock": _C4_CLOCK})
    cores, rc2 = build_variants(CORES_VARIANTS, base, "conv3d_bn_relu",
                                "namespace {", {"cores_clock": _CORES_CLOCK})
    cores.pop("repo")
    rc = rc or rc2

    def operands(B, D, H, W):
        rng = np.random.default_rng(0)
        x = torch.as_tensor(np.maximum(rng.standard_normal((B, 4, D, H, W)),
                                       0), dtype=torch.float32)
        wt = torch.as_tensor(rng.standard_normal((4, 4, 3, 3, 3))
                             * np.sqrt(2 / 108), dtype=torch.float32)
        sh = torch.as_tensor(rng.normal(0, 0.1, 4), dtype=torch.float32)
        return (x.to(dev, torch.bfloat16), wt.to(dev, torch.bfloat16),
                sh.to(dev))

    def cores_call(lib, x, wt, sh):
        """The CUDA-core kernel of `lib` at bf16 4 -> 4, NCDHW in and out,
        its weights as (Ci, 27, Co); a fn of no arguments."""
        fn = lib.conv3d_bn_relu_bf16
        fn.argtypes = build.CONV3D_BN_RELU.argtypes
        fn.restype = ctypes.c_int
        B, _, D, H, W = x.shape
        wk = wt.permute(1, 2, 3, 4, 0).reshape(4, 27, 4).contiguous()
        y = torch.empty_like(x)

        def run():
            rc = fn(x.data_ptr(), wk.data_ptr(), sh.data_ptr(), None,
                    y.data_ptr(), B, 4, 4, D, H, W, 0, 0,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"cudaError {rc}")
            return y
        return run

    def split(read, reset, fn, roles, blocks):
        torch.cuda.synchronize()
        reset()
        fn()
        torch.cuda.synchronize()
        clk = np.zeros(4096 * 8, np.int64)
        read(ctypes.c_void_p(clk.ctypes.data))
        c = clk.reshape(4096, 8)
        c = c[c[:, 6] == 1][:blocks]
        out = {r: float(np.median(c[:, k])) for r, k in roles.items()}
        out["blocks"] = int(len(c))
        return out

    kern = build.CONV3D_BN_RELU
    kern._fn("conv3d_bn_relu_bf16")  # loads the library
    repo_lib = kern._lib
    for name, lib in list(libs.items()) + list(cores.items()):
        on_c4 = name in libs
        kern._lib = repo_lib if lib is None else lib
        kern._fns = {}
        row = {}
        for shape, dims in C4_SHAPES.items():
            x, wt, sh = operands(*dims)
            fn = ((lambda: CF.conv3d_bn_relu(x, wt, sh)) if on_c4
                  else cores_call(lib, x, wt, sh))
            want = CF.conv3d_bn_relu_plain(x, wt, sh).float()
            got = fn().float()
            tol = 2 * 2.0 ** -8 * want.abs() + 2e-2 * want.abs().max()
            bad = int(((got - want).abs() > tol).sum())
            if bad and name not in ("cores_noload", "cores_nofma"):
                print(f"{name}: {shape}: {bad} elements beyond two rounding "
                      f"steps")
                rc = 2
            ms = cs.kernel_device_ms(fn, "conv3d_bn_relu")
            row[shape] = ms
            print(f"{name}: {shape} 4->4: "
                  f"{'not measured' if ms is None else f'{ms:.4f} ms'}")
            if name == "clock":
                row[f"{shape} clock64"] = out = split(
                    lib.c4_clock_read, lib.c4_clock_reset, fn, C4_ROLES,
                    4096)
                print(f"{name}: {shape} clock64 medians over the blocks "
                      f"(thread 0, clocks): {out}")
            if name == "cores_clock":
                row[f"{shape} clock64"] = out = split(
                    lib.cores_clock_read, lib.cores_clock_reset, fn,
                    CORES_ROLES, 4096)
                print(f"{name}: {shape} clock64 medians over the blocks "
                      f"(thread 0, clocks): {out}")
        report["variants"][name] = row
    kern._lib = repo_lib
    kern._fns = {}
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None)
    family = ap.add_mutually_exclusive_group()
    family.add_argument("--skip", action="store_true")
    family.add_argument("--entry", action="store_true")
    family.add_argument("--dwsep", action="store_true")
    family.add_argument("--c4", action="store_true")
    family.add_argument("--skip4", action="store_true")
    family.add_argument("--dense32", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("conv3d_c8_variants: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.ops.cuda import costfilter as CF
    from lwsnet_tpu_torch.utils.timing import card

    dev = torch.device("cuda")
    print(f"card: {card()}")
    build.build_all()
    report = {"card": card(), "variants": {}}
    if (args.skip or args.entry or args.dwsep or args.c4 or args.skip4
            or args.dense32):
        rc = (skip_variants if args.skip else entry_variants if args.entry
              else dwsep_variants if args.dwsep else c4_variants if args.c4
              else dense32_variants if args.dense32
              else skip4_variants)(dev, report)
        if args.json:
            os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
            with open(args.json, "w") as f:
                json.dump(report, f, indent=1)
        return rc
    libs, rc = build_variants(VARIANTS, os.path.join(ROOT, "build",
                                                     "c8_variants"),
                              "conv3d_bn_relu", "namespace c8 {",
                              {"clock": _CLOCK_READ})

    def operands(B, D, H, W):
        rng = np.random.default_rng(0)
        x = torch.as_tensor(np.maximum(rng.standard_normal((B, 8, D, H, W)),
                                       0), dtype=torch.float32)
        x = x.to(dev, torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d)
        wt = torch.as_tensor(rng.standard_normal((8, 8, 3, 3, 3))
                             * np.sqrt(2 / 216), dtype=torch.float32)
        sh = torch.as_tensor(rng.normal(0, 0.1, 8), dtype=torch.float32)
        return x, wt.to(dev, torch.bfloat16), sh.to(dev)

    build.CONV3D_BN_RELU._fn("conv3d_bn_relu_bf16")  # loads the library
    repo_lib = build.CONV3D_BN_RELU._lib
    for name, lib in libs.items():
        build.CONV3D_BN_RELU._lib = repo_lib if lib is None else lib
        build.CONV3D_BN_RELU._fns = {}
        row = {}
        x, wt, sh = operands(*SHAPES["stage3"])
        want = CF.conv3d_bn_relu_plain(x, wt, sh).float()
        got = CF.conv3d_bn_relu(x, wt, sh).float()
        tol = 2 * 2.0 ** -8 * want.abs() + 2e-2 * want.abs().max()
        bad = int(((got - want).abs() > tol).sum())
        if bad:
            print(f"{name}: {bad} elements beyond two rounding steps")
            rc = 2
        for shape, (B, D, H, W) in SHAPES.items():
            x, wt, sh = operands(B, D, H, W)
            for out_cl in (True, False):
                ms = cs.kernel_device_ms(
                    lambda: CF.conv3d_bn_relu(x, wt, sh,
                                              channels_last=out_cl),
                    "conv3d_bn_relu")
                key = f"{shape} {'channels-last' if out_cl else 'NCDHW'} out"
                row[key] = ms
                print(f"{name}: {key}: "
                      f"{'not measured' if ms is None else f'{ms:.4f} ms'}")
            if name == "clock":
                CF.conv3d_bn_relu(x, wt, sh)
                torch.cuda.synchronize()
                clk = np.zeros(132 * 64, np.uint64)
                lib.c8_clock_read(ctypes.c_void_p(clk.ctypes.data))
                c = clk.reshape(132, 8, 8).astype(np.int64)
                split = dict(staging_free_wait=float(np.median(c[:, 0, 0])),
                             tiles_a_block=float(np.median(c[:, 0, 1])))
                for k, what in enumerate(("landed_wait", "products",
                                          "epilogue")):
                    split[what] = float(np.median(c[:, 1:5, k]))
                row[f"{shape} clock64"] = split
                print(f"{name}: {shape} clock64 medians over the blocks "
                      f"(the staging thread; each product warpgroup): {split}")
        report["variants"][name] = row
    build.CONV3D_BN_RELU._lib = repo_lib
    build.CONV3D_BN_RELU._fns = {}
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
