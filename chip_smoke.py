#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`lwsnet_tpu_torch`) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                    # phases 1-13
    python3 chip_smoke.py --only multicard   # phases 1 and 13, 4 cards

It builds the Hopper kernels from `lwsnet_tpu_torch/csrc/` and drives the
port's main path, the 368x1232 batch-1 bf16 4-stage inference forward, on
seeded random weights, under each stage-4 refinement engine: the shipped
`rows_dw="mxu"`, then "vpu" with `rows_paired` True and False, "chain",
and the planar `pallas_mode="layers"`; then the rows microbench; then the
training path through the finetune CLI; then pretrain, finetune and
infer through their CLIs; then every tool of `lwsnet_tpu_torch.tools`;
then row sharding; then the port's bench; then, where 2 or more cards
are visible, data x spatial training across them under NCCL. Phases, in
order; any failure exits non-zero:

  1. the card's name and power limit, and the number of cards visible;
  2. build every kernel (nvcc, sm_90a) and print ptxas register / shared
     memory lines;
  3. every kernel against its plain PyTorch version at each shape and
     memory layout a path gives it, and the tensor-core routes of
     dense3x3 (32 outputs; the narrow entry, Ci 1 and 3, and the narrow
     output, Co 1 and 8), dwsep3x3 (solo and pair), chain3x3 (tower and
     head), conv3d_bn_relu (32 -> 32; 8 -> 8 writing either layout; the
     stage entries 1 -> 8 and 1 -> 32 with layer 0's BN + ReLU fused,
     b0 > 0) and conv3d_skip_softargmin (32 and 8 channels) at ragged
     shapes from both layouts (NCHW / channels-last), in float32 (TF32
     off; atol 2e-4, rtol 1e-3) and bf16 (mean |delta| < 2 % of the plain
     output's span; chain3x3, the 8-channel conv3d_bn_relu layers and the
     entries, conv3d_skip_softargmin and dense3x3's narrow routes also
     every element within two rounding steps, or, writing float32, atol
     2e-4 / rtol 1e-3); each bf16 dense3x3 call on the route its shape
     picks (`dense_route`), each conv3d_bn_relu entry counted as the
     "entry" route and no other call;
     conv3d_skip_softargmin's copies: none for bf16 channels-last input,
     one to channels-last for bf16 NCDHW, one to the default layout for
     float32 channels-last (its CUDA-core kernel reads NCDHW);
  4. for each engine, the full forward through `make_forward` (kernels)
     and the module path on the card, each held against the module path
     in float64 (the reference): per stage and dtype the kernel path's
     mean |delta| at most 1.1 x the module path's, and in float32 its max
     |delta| at most 2 x the module path's (printed with the pixel where
     the two float32 paths lie farthest apart); the launch counters of
     the bf16 kernel run, set to 0 just before it, must equal
     `want_counts` (the shipped engine: conv3d_bn_relu 15,
     conv3d_skip_softargmin 3, dense3x3 11, 1 of them two-input), its
     route launches `WANT_ROUTES` (dense3x3's narrow routes, and the
     three cost filters' entries on conv3d_bn_relu's), and the
     wrappers' layout copies `WANT_COPIES` (none on any path); then the
     "layers" refinement alone at 96x3712, where the (8, 16) tower pair
     splits into two solo layers, against the module path's towers + head
     at the same bars, with its own launch counts;
 4b. every kernel launch against the module layer it replaces
     (`lwsnet_tpu_torch.tools.parity_layers`), before any timing: the
     368x1232 forward under each engine in bf16 and float32 (TF32 off,
     cuDNN's deterministic algorithms), on the seed-0 network with phase 4's batch norms and on
     `tools.parity`'s "trained_wide" set (the fixture's trained weights on
     `wide_pair`), each launch's output held with its module
     reference in the launch's dtype against the float64 truth on the
     same input (phase 4's rule per launch, or the route's own bar in
     `parity_layers.ROUTE_BARS`; the cost filters' launches under the
     first engine); each engine's launches, each matched to a reference,
     as many as `want_counts` holds, and its kernel launches equal to
     `want_counts`; then a x1.01 weight
     error planted in each route's first launch (`parity_layers.ROUTES`,
     seed-0, bf16, kernel side) must miss at that launch and no other,
     printed beside the sound reading; its time printed, every reading in
     chiprun_out/parity_layers.json;
  5. `InferenceEngine` answers 4 seeded requests at num_stages 1..4 under
     the shipped engine, with per-stage latency from CUDA events after a
     warm-up; under each other engine it answers one request at
     num_stages 1..4, and its 4-stage latency is timed the same way; then
     one torch.profiler window each gives the 4-stage forward's device
     busy share under "mxu", "vpu" paired, "chain" and "layers";
  6. each kernel timed at its path's shapes and layouts beside its plain
     version, its bound from bytes and operations, and one cuDNN call that
     computes the same function on the same inputs where there is one
     (else the sum of per-layer cuDNN calls), with the cuDNN call on NCHW
     copies beside it for the channels-last shapes, and its wrapper's host
     time a call (no path makes a layout copy left to time); after phase
     7, each kernel's device time from the profiler,
     for the dw-sep launches beside their bound, the cuDNN call(s) over
     the composed rank-1 kernels on the device and the wrapper's host time,
     for the chain3x3 launches beside their bound, the per-layer cuDNN
     calls on the same channels-last input, the same layers as "mxu"'s
     dense3x3 launches on the device and the wrapper's host time;
  7. the rows microbench (`lwsnet_tpu_torch.tools.microbench_rows`) once,
     its counters set to 0 just before: its probe must print OK, which
     launches `lane_broadcast`; then `lane_broadcast`, `Tensor.repeat` of
     the same and an empty kernel, 1000 each in profiler windows of 250
     calls of their own, a window run again (twice at most) when the
     profiler dropped over a tenth of its kernels (median and spread of
     each kernel's device time);
  8. training on the card, which launches none of the kernels above (the
     train step runs the module path, as the JAX train step runs no
     Pallas kernel): `make -B -C native` (the native decoder; without it
     the pipeline decodes through PIL or the stdlib codec), a synthetic
     KITTI2015 corpus of 16 frames at 375x1242 written from a seed, then
     `lwsnet_tpu_torch.cli.finetune` at full width in bf16 (batch 4 at
     256x512, eval batch 8 at 368x1232, 2 epochs of 2 steps): every step
     finite, the parameters moved, a checkpoint and its metadata written,
     `--resume --epoch 3` restoring the epoch and best error, `--evaluate`
     a finite D1, the launch counters still 0; the trained weights through
     `make_forward` (kernels) and the module path at 368x1232 against the
     float64 module path, with phase 4's bf16 bar; one float32 train step
     on the card against the
     CPU (`card_vs_cpu_step`'s bars), beside the CPU's own step with its
     input scaled by 1 + 1e-7; the bf16 train step's median and max over
     10 steps (CUDA events) with images/s and peak memory, one profiler
     window over 3 steps (device busy share, costliest kernels), and the
     eval step's time at batch 8;
  9. the two-phase recipe and inference through the three CLIs, full
     width, bf16, seed 0, in under 120 s: (a) `cli.pretrain` on a
     synthetic SceneFlow corpus (a monkaa scene of 16 and a
     frames_cleanpass/TEST/A sequence of 8 frames at 540x960, PFM ground
     truth), batch 8 at 256x512, eval batch 8 at 544x960, one epoch,
     under a `torch.distributed` NCCL group of one process set up from a
     launcher's environment (127.0.0.1, a free port): the group's
     backend, one collective per batch norm, mask count, gradient and
     loss reduction of each step, one per eval step, a barrier after the
     checkpoint, no kernel launch; one float32 step (TF32 off,
     deterministic algorithms: the default backward's grad_norm moves by
     about 1e-5 from run to run, printed) through the distributed path
     against the single-process one (loss rel 1e-6, grad_norm rel 1e-5);
     the bf16 pretrain step's median and max of 10
     (CUDA events), images/s and peak memory, and the eval step's median,
     under the group; (b) `cli.finetune --pretrained` on phase 8's corpus
     for one epoch: the state before its first step equals the
     pretrained checkpoint's exactly; (c) `cli.infer --model` (the
     finetuned checkpoint) on "mxu" over a KITTI testing directory of 4
     frames at 375x1242, then in single-pair mode: four PNGs a frame,
     the launch counters (0 before) at `want_counts("mxu")` times the
     forwards the CLI ran (two a frame), frame 0's four stages through
     the CLI held with the bf16 module path against the float64 module
     path on the restored weights at phase 4's bar, and each frame's
     forward time and host-clock time as the CLI logs them;
 10. the tools (`lwsnet_tpu_torch.tools`), in process, their JSON under
     chiprun_out/tools/: (a) `parity --fixture` under each engine in
     float32 (TF32 off) and bf16 on each of the JAX fixture's three sets
     (`tests/torch_fixtures/`: the JAX float32 module path at every
     4th pixel of 368x1232), each stage of each path at
     `tools.parity`'s fixture bars, and the bf16 "mxu" launch counts at
     `want_counts("mxu")`; (b) `parity_kernels` on the trained weights
     in both dtypes; (c) `profile_forward --trace`: per-stage and
     per-component times, and the trace's `stage1` .. `stage4_refinement`
     ranges, `stage1` enclosing a `conv3d_bn_relu` launch and
     `stage4_refinement` a `dense3x3` one, and the forward's time with
     and without the ranges, in turns; (d) `golden_pair_inference` on
     phase 9's finetuned checkpoint and a seeded 375x1242 pair: four
     finite stages, four PNGs, 2 x `want_counts("mxu")` launches; (e)
     `microbench_refine` and `microbench_3d`, their equivalence checks
     first; (f) `aot_warm` names every library; (g) `scaling_sweep
     --devices 1 --iters 3` under NCCL: one finite point; (h) a
     miniature `overfit_proof` (8 pairs, 1 + 1 epochs, batch 4) and
     `cpu_truth_eval` on its best checkpoint, finite, no EPE bar; (i) a
     miniature `overfit_diag` (configs "f32" and "primed", 8 steps over
     4 pairs at batch 2): every number of its result finite;
 11. row sharding on the card: two processes on the one card under gloo
     (NCCL refuses two processes on one device), laid out as data x
     spatial 1 x 2 through `tools.dryrun_ddp.spawn`, against the same
     work in this process (`dryrun_ddp.layout_child`, held by
     `dryrun_ddp.layout_failures`, as phase 13 holds its layouts), with
     seeded weights (phase 4's jittered batch norms): (a) one train step
     of the full-width model at 256x512, batch 2, TF32 off and
     deterministic algorithms, in float32 (loss rel 1e-5, BN statistics
     rtol 1e-4 / atol 1e-6) and in float64 compute (also grad_norm rel
     1e-5 and every gradient tensor's cosine >= 0.9999; float32's
     cosines are printed: they move with the order of summation alone);
     (b) the eval step at the KITTI window 368x1232, 184 rows a shard: in
     float64 compute EPE and D1 sums within rel 1e-5, weight equal in
     both dtypes, float32's gaps printed (threshold pixels flip, and
     stage 4 of a random network amplifies rounding); (c) 3 bf16 train
     steps, finite, after which the two shards' parameters and
     statistics are bit-identical; (d) the collectives by purpose,
     "halo" equal to `LWSNet.halo_exchanges` (forward and backward a
     train step, forward an eval step), and no kernel launch;
     printed with no bar: each process's peak memory and the bf16 step's
     median time beside the single process's at the same global batch;
 12. the port's bench, `python -m lwsnet_tpu_torch.tools.bench` in a
     process of its own with BENCH_BUDGET_S=120 (detail in
     chiprun_out/bench_detail.json): its last line holds the four keys
     and a finite positive value; its detail holds stages 1-4, the
     monotonicity check, the module path, both train steps and their
     projections, the MFU and the card with its power limit, and no
     skipped step or low-budget estimate; its headline forward launched
     `want_counts("mxu")`, its module-path forward and train steps
     launched nothing; its 4-stage time is printed beside phase 5's
     median, with no bar;
 13. multi-card, with 2 or more cards visible (one card: it prints that
     it was not run and records {"cards": 1, "run": false}): each data x
     spatial layout of 2 x 1, 1 x 2 and, with 4 cards, 4 x 1, 2 x 2 and
     1 x 4 on as many processes, one a card under NCCL
     (`tools.dryrun_ddp.spawn(..., device="cuda")`, `layout_child`),
     against one process on card 0 on the same data and weights (phase
     11's: seeded, jittered batch norms; batch 2, or 4 for 4 x 1 and
     2 x 2): (a) one float64 train step at 256x512 and the float64 eval
     step at 368x1232 (deterministic algorithms, TF32 off) with phase
     11's float64 bars, the processes' gradients, statistics and sums
     equal; (b) the collectives by purpose, "halo" at
     `LWSNet.halo_exchanges` (49 + 47 a train step, 49 an eval step)
     under row sharding; (c) after 3 bf16 steps every process's
     parameters and batch-norm statistics bit-identical (the largest
     difference printed); no kernel launch; printed with no bar: each
     process's bf16 step time (CUDA events, median of 5) and peak memory
     beside the one process's; (f) a torch.profiler window on rank 0 over
     3 bf16 steps of 4 x 1 and 2 x 2: device busy, NCCL kernels (all-
     gather, all-reduce) and other kernels; then (d) `torchrun
     --standalone --nproc_per_node=4 -m lwsnet_tpu_torch.cli.pretrain`
     (2 with two or three cards) for one epoch on phase 9's synthetic
     SceneFlow corpus: exactly one checkpoint, whose EPE equals this
     process's eval of it (rel 1e-5), then `cli.finetune --pretrained`
     from it the same way on phase 8's KITTI corpus: one checkpoint, a
     D1 in [0, 1]; (e) `tools.scaling_sweep --devices 1 2 4` at 256x512
     in bf16, per-card batch 4 and global batch 8. `--only multicard`
     runs phases 1 and 13 alone and fails with fewer than 4 cards.

Without CUDA it exits 1 and prints no result. Details of the run are also
written to chiprun_out/chip_smoke.json; the scaling sweeps' to
chiprun_out/scaling_sweep_{weak,strong}.json.
"""

import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

from lwsnet_tpu_torch.tools.dryrun_ddp import deterministic_algorithms
from lwsnet_tpu_torch.tools.parity_layers import (ENGINES, MAX_RATIO,
                                                  MEAN_RATIO,
                                                  jitter_batchnorm)

H, W = 368, 1232          # KITTI eval window
WIDE_H, WIDE_W = 96, 3712  # a width where the layers path splits a pair
PEAK_BF16 = 989e12        # H100 SXM dense tensor-core FLOP/s (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


PORT_KERNELS = ("conv3d_bn_relu", "skip_softargmin", "dense3x3", "dwsep3x3",
                "chain3x3")
# The engines whose 4-stage forward phase 5 profiles for device busy time.
PROFILED = ("mxu", "vpu-paired", "chain", "layers")

# Launches per 368x1232 batch-1 forward beyond stages 1-3's
# (conv3d_bn_relu 15, conv3d_skip_softargmin 3).
REFINE_LAUNCHES = {
    "mxu": {"dense3x3": 11, "dense3x3[dual]": 1},
    "vpu-paired": {"dense3x3": 3, "dense3x3[dual]": 1, "dwsep3x3_pair": 4},
    "vpu-unpaired": {"dense3x3": 3, "dense3x3[dual]": 1, "dwsep3x3": 8},
    "chain": {"chain3x3": 2, "chain3x3[dual]": 1},
    "layers": {"dense3x3": 5, "dwsep3x3_pair": 6},
}
# Layout copies the wrappers make per forward (build.LAYOUT_COPIES): the
# tensor-core routes (dense3x3's, dwsep3x3's, conv3d_bn_relu's,
# conv3d_skip_softargmin's) read and write channels-last, every other
# kernel the default layout (the CUDA cores of dense3x3 either). Every
# bf16 layer, the cost filters' fused last one too, reads the layout the
# layer before it writes: no path copies, nor the refinement alone at
# WIDE_H x WIDE_W.
WANT_COPIES = {engine: {"to channels-last": 0, "to contiguous": 0}
               for engine in (*ENGINES, "layers-wide")}
# Launches of the layers refinement alone at WIDE_H x WIDE_W.
WIDE_LAUNCHES = {"dense3x3": 5, "dwsep3x3": 4, "dwsep3x3_pair": 4}
# Route launches per bf16 forward (build.route_counts()): every path but
# "chain" runs its tower entries (one at 2B with two weight groups, or
# "layers"' two at batch 1) on dense3x3's narrow-entry route and its
# 32 -> 1 output conv on the narrow-output route; every forward runs the
# three cost filters' entries (1 -> 32, 1 -> 8, 1 -> 8) on conv3d_bn_relu's
# entry route. The refinement alone ("layers-wide") runs no cost filter.
WANT_ROUTES = {engine: {"dense3x3[entry]": 2 if engine.startswith("layers")
                        else 1, "dense3x3[output]": 1}
               for engine in (*ENGINES, "layers-wide")}
WANT_ROUTES["chain"] = {}
for _engine in ENGINES:
    WANT_ROUTES[_engine]["conv3d_bn_relu[entry]"] = 3
# The path whose run gives each kernel's launches on the kernels line.
ENGINE_OF = {"conv3d_bn_relu": "mxu", "conv3d_skip_softargmin": "mxu",
             "dense3x3": "mxu", "dwsep3x3": "vpu-unpaired",
             "dwsep3x3_pair": "vpu-paired", "chain3x3": "chain",
             "lane_broadcast": "microbench"}
REPLACES = {
    "conv3d_bn_relu": "lwsnet_tpu/ops/pallas/costfilter.py:138 "
                      "(_dgrid_kernel); lwsnet_tpu/ops/pallas/"
                      "costfilter.py:345 (_folded_kernel)",
    "conv3d_skip_softargmin": "lwsnet_tpu/ops/pallas/costfilter.py:382 "
                              "(_folded_last_kernel)",
    "dense3x3": "lwsnet_tpu/ops/pallas/refine_rows.py:243 "
                "(_dense_kernel); lwsnet_tpu/ops/pallas/"
                "refine_rows.py:271 (_dense2_kernel); lwsnet_tpu/ops/"
                "pallas/refine.py:336 (_dense_stack_layer_kernel), :354 "
                "(_dense_acc_layer_kernel), :374 (_dense_vpu_layer_kernel)",
    "dwsep3x3": "lwsnet_tpu/ops/pallas/refine_rows.py:170 (_dwsep_kernel); "
                "lwsnet_tpu/ops/pallas/refine.py:183 (_dwsep_layer_kernel)",
    "dwsep3x3_pair": "lwsnet_tpu/ops/pallas/refine_rows.py:193 "
                     "(_dwsep2_kernel); lwsnet_tpu/ops/pallas/refine.py:244 "
                     "(_dwsep2_layer_kernel)",
    "chain3x3": "lwsnet_tpu/ops/pallas/refine_rows.py:503 (_chain_kernel)",
    "lane_broadcast": "examples/microbench_rows.py:184 (bkernel)",
}


def dense_route(p, dtype):
    """The route dense3x3 takes for call `p` in `dtype` (its C++ rule,
    mirrored by the predicates of ops/cuda/refine_rows.py): "entry",
    "output", "tensor cores" or "CUDA cores"."""
    from lwsnet_tpu_torch.ops.cuda import refine_rows as RR
    args = (dtype, p["Ci"], p["Co"], p["d"], 2 if p.get("dual") else 1,
            p["G"])
    if RR.dense_entry_route(*args):
        return "entry"
    if RR.dense_output_route(*args):
        return "output"
    return ("tensor cores" if RR.dense_tensor_core_route(*args)
            else "CUDA cores")


def want_counts(engine, zero):
    """Launch counts of one bf16 forward under `engine`; `zero` holds every
    counter's name."""
    counts = dict.fromkeys(zero, 0)
    counts.update(conv3d_bn_relu=15, conv3d_skip_softargmin=3)
    counts.update(REFINE_LAUNCHES[engine])
    return counts


def device_profile(fn, reps=5):
    """One torch.profiler window over `reps` runs of fn(), after a warm-up.
    Returns per-run host-clock ms, device-busy ms (the union of kernel
    intervals), the port's kernels' ms, and the five costliest other
    kernels; None when the profiler recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the device rows of the forward's stage ranges span idle gaps: not
    # kernels
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation)
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    port, other = 0.0, {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        if any(k in name for k in PORT_KERNELS):
            port += e - s
        else:
            other[name] = other.get(name, 0.0) + e - s
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    return dict(wall_ms=wall_us / reps / 1e3, busy_ms=busy / reps / 1e3,
                port_kernels_ms=port / reps / 1e3,
                other_kernels_ms=sum(other.values()) / reps / 1e3,
                top_other=[(n[:80], t / reps / 1e3) for n, t in top])


# Substring of each kernel's CUDA function names, for the profiler.
KERNEL_NAMES = {"conv3d_bn_relu": "conv3d_bn_relu",
                "conv3d_skip_softargmin": "skip_softargmin",
                "dense3x3": "dense3x3", "dwsep3x3": "dwsep",
                "dwsep3x3_pair": "dwsep", "chain3x3": "chain3x3",
                "lane_broadcast": "lane_broadcast"}


def kernel_device_ms(fn, name, reps=10):
    """Device ms per call of fn() in kernels whose name holds `name` (""
    for all), from one torch.profiler window over `reps` calls after a
    warm-up: the sum over kernel names of each name's median duration
    times its launches a call. The kernel alone, without the wrapper's host
    time that a pair of events around one call also counts. The profiler
    may drop a few of a window's kernels, or most of them: a window in
    which no name shows 90 % of its launches is run again, over 5 x `reps`
    calls, twice at most; None when none was whole."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for n in (reps, 5 * reps, 5 * reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and name in e.name:
                spans.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        if spans and max(len(v) for v in spans.values()) >= 0.9 * n:
            return sum(statistics.median(v) * max(1, round(len(v) / n))
                       for v in spans.values() if len(v) >= 0.5 * n) / 1e3
    return None


def launch_floor(dev, n=1000, window=250):
    """`lane_broadcast` (32, 1) -> (32, 1024) bf16, `Tensor.repeat` of the
    same, and an empty kernel (`torch.cuda._sleep(0)`, the launch floor),
    each called n times, `window` calls to a torch.profiler window of its
    own: {what: device us of each of its kernels, as median, p10, p90,
    min, max and count}. The kernels are told apart by name
    (`lane_broadcast`, `spin`, the rest). The profiler may drop some of a
    long window's kernels (888 of 3000 in PR 11, 672 of 1000 empty
    kernels in PR 16): a window that recorded under 90 % of its calls is
    run again, twice at most, and the phase fails if none was."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lwsnet_tpu_torch.ops.cuda import probe as PR
    v = torch.randn(32, 1, device=dev, dtype=torch.bfloat16)
    fns = {"lane_broadcast": lambda: PR.lane_broadcast(v, 1024),
           "Tensor.repeat": lambda: v.repeat(1, 1024),
           "empty kernel": lambda: torch.cuda._sleep(0)}
    out = {}
    for what, f in fns.items():
        f()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n // window):
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(window):
                        f()
                    torch.cuda.synchronize()
                got = [e.time_range.end - e.time_range.start
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and ("lane_broadcast" if what == "lane_broadcast"
                            else "spin" if what == "empty kernel" else "")
                       in e.name]
                if len(got) >= 0.9 * window:
                    break
            require(len(got) >= 0.9 * window,
                    f"launch floor: {len(got)} {what} kernels recorded of "
                    f"{window}, in each of three windows")
            ts += got
        q = np.percentile(ts, [10, 50, 90])
        out[what] = dict(median=float(q[1]), p10=float(q[0]),
                         p90=float(q[2]), min=float(min(ts)),
                         max=float(max(ts)), count=len(ts))
    return out


def host_us(fn, reps=50):
    """Host microseconds per call of fn() while its launches queue on the
    card (no synchronisation between calls): the wrapper's own cost, which
    a pair of events around one call adds to the kernel's time when it is
    the larger."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


# --- the kernels' main-path calls ------------------------------------------

def main_path_calls(cfg):
    """Every distinct kernel call of the 368x1232 batch-1 forward:
    (kernel, label, shape dict, launches per forward, engine). `cl`: the
    input lies channels-last, as the path hands it over; `cl_out`: the
    kernel is asked to write channels-last (`ncdhw_out`, in the ragged
    checks only: NCDHW); `entry`: a stage's 1 -> C entry, layer 0's BN +
    ReLU fused (`conv3d_entry`), which writes what the next layer reads."""
    calls = []
    for s in range(3):
        h, w = H // 8 * 2 ** s, W // 8 * 2 ** s
        D = cfg.max_disp_list[s] if s == 0 else 2 * cfg.max_disp_list[s] - 1
        C = cfg.channels_3d * cfg.growth_rate[s]
        geo = dict(B=1, D=D, H=h, W=w)
        calls.append(("conv3d_bn_relu", f"stage{s + 1} 1->{C} entry",
                      dict(geo, Ci=1, Co=C, entry=True), 1, "mxu"))
        # the bf16 C -> C layers read and write channels-last, and the
        # fused last layer reads it
        calls.append(("conv3d_bn_relu", f"stage{s + 1} {C}->{C}",
                      dict(geo, Ci=C, Co=C, cl=True), cfg.layers_3d, "mxu"))
        calls.append(("conv3d_skip_softargmin", f"stage{s + 1} {C}->1",
                      dict(geo, Ci=C, cl=True, start=0 if s == 0 else
                           -cfg.max_disp_list[s] + 1), 1, "mxu"))
    c = cfg.refine_channels
    geo = dict(H=H, W=W)
    calls.append(("dense3x3", "tower entry 3->32 G=2",
                  dict(geo, B=2, G=2, Ci=3, Co=c, d=1, aff=False,
                       cl_out=True), 1, "mxu"))
    for d in (2, 4, 8, 16):
        calls.append(("dense3x3", f"tower 32->32 d={d} G=2",
                      dict(geo, B=2, G=2, Ci=c, Co=c, d=d, aff=True,
                           cl=True), 1, "mxu"))
    calls.append(("dense3x3", "head entry 2x32->32 d=8 (dual)",
                  dict(geo, B=1, G=1, Ci=c, Co=c, d=8, aff=True, dual=True,
                       cl=True), 1, "mxu"))
    for d in (8, 4, 2, 1):
        calls.append(("dense3x3", f"head 32->32 d={d}",
                      dict(geo, B=1, G=1, Ci=c, Co=c, d=d, aff=True,
                           cl=True), 1, "mxu"))
    calls.append(("dense3x3", "out 32->1 f32 out",
                  dict(geo, B=1, G=1, Ci=c, Co=1, d=1, aff=False,
                       f32_out=True, cl=True), 1, "mxu"))
    return calls


def variant_calls(cfg):
    """Every distinct call of the kernels that only the other "rows"
    engines run (368x1232 batch 1): (kernel, label, shape dict, launches
    per forward under the engine that runs it, that engine)."""
    from lwsnet_tpu_torch.models.refinement import (HEAD_DENSE_DILATION,
                                                    HEAD_DILATIONS,
                                                    TOWER_DILATIONS)
    c = cfg.refine_channels
    tower = dict(H=H, W=W, C=c, B=2, G=2)
    head = dict(H=H, W=W, C=c, B=1, G=1)
    calls = [("dwsep3x3", f"tower d={d} G=2", dict(tower, d=d, cl=True),
              1, "vpu-unpaired") for d in TOWER_DILATIONS]
    calls += [("dwsep3x3", f"head d={d}", dict(head, d=d, cl=True), 1,
               "vpu-unpaired") for d in HEAD_DILATIONS]
    for geo, dils, name in ((tower, TOWER_DILATIONS, "tower"),
                            (head, HEAD_DILATIONS, "head")):
        for i in (0, 2):
            d1, d2 = dils[i], dils[i + 1]
            calls.append(("dwsep3x3_pair", f"{name} ({d1},{d2}) G={geo['G']}",
                          dict(geo, d1=d1, d2=d2, cl=True), 1,
                          "vpu-paired"))
    calls.append(("chain3x3", "tower 3->32, d=1,2,4,8,16, G=2",
                  dict(tower, Ci0=3, dils=(1,) + TOWER_DILATIONS,
                       aff=(False,) + (True,) * 4, dual=False, co_last=c,
                       f32_out=False), 1, "chain"))
    dils = (HEAD_DENSE_DILATION,) + HEAD_DILATIONS + (1,)
    calls.append(("chain3x3", f"head 2x32->32->1, d={dils}, f32 out",
                  dict(head, Ci0=c, dils=dils, aff=(True,) * 5 + (False,),
                       dual=True, co_last=1, f32_out=True, cl=True), 1,
                  "chain"))
    return calls


def layers_calls(cfg):
    """Every distinct kernel call of the planar "layers" refinement, each
    tower on its own at batch 1 with one weight set: engine "layers" at
    368x1232, where every dw-sep pair fuses, and "layers-wide" at
    WIDE_H x WIDE_W for the solo layers of the split (8, 16) tower pair;
    then the rows microbench's probe (engine "microbench"). Tuples as
    `main_path_calls`."""
    c = cfg.refine_channels
    geo = dict(H=H, W=W, B=1, G=1)
    calls = [
        ("dense3x3", "layers entry 3->32 G=1",
         dict(geo, Ci=3, Co=c, d=1, aff=False), 1, "layers"),
        ("dense3x3", "layers entry 1->32",
         dict(geo, Ci=1, Co=c, d=1, aff=False), 1, "layers"),
        ("dense3x3", "layers head half 32->32 d=8",
         dict(geo, Ci=c, Co=c, d=8, aff=True, cl=True), 2, "layers"),
        ("dense3x3", "layers out 32->1 bf16 out",
         dict(geo, Ci=c, Co=1, d=1, aff=False, cl=True), 1, "layers")]
    for (d1, d2), n in (((2, 4), 2), ((8, 16), 2), ((8, 4), 1), ((2, 1), 1)):
        calls.append(("dwsep3x3_pair", f"layers ({d1},{d2}) G=1",
                      dict(geo, C=c, d1=d1, d2=d2, cl=True), n, "layers"))
    wide = dict(H=WIDE_H, W=WIDE_W, B=1, G=1, C=c, cl=True)
    for d in (8, 16):
        calls.append(("dwsep3x3", f"layers d={d} G=1 at {WIDE_H}x{WIDE_W}",
                      dict(wide, d=d), 2, "layers-wide"))
    calls.append(("lane_broadcast", "probe (32,1)->(32,1024)",
                  dict(C=32, N=1024), 1, "microbench"))
    return calls


def ragged_calls():
    """Phase 3 only: the tensor-core routes of dense3x3 (32 outputs, the
    narrow entry and the narrow output), dwsep3x3 (solo and
    pair), chain3x3, conv3d_bn_relu (with its entries 1 -> 8 and 1 -> 32)
    and conv3d_skip_softargmin at shapes no tile divides (W = 150, 75, 70
    and 37, H = 37, 29, 11 and 5 not a multiple of R * d = 4d, of the skip
    route's two rows or of the entries' four, D = 7), two
    weight groups at batch 2, C = 16 -> 32 dw-sep layers, the two-input
    form, the chain's tower and head at every dilation of the path, from
    NCHW (one counted copy where the route reads channels-last) and
    channels-last input (one where it reads NCHW). Tuples as
    `main_path_calls` (launches and engine unused)."""
    from lwsnet_tpu_torch.models.refinement import (HEAD_DENSE_DILATION,
                                                    HEAD_DILATIONS,
                                                    TOWER_DILATIONS)
    calls = []
    for cl in (False, True):
        tag = "channels-last" if cl else "NCHW"
        dils = (HEAD_DENSE_DILATION,) + HEAD_DILATIONS + (1,)
        for (h, w) in ((29, 150), (11, 75)):
            geo = dict(H=h, W=w, C=32, cl=cl)
            calls.append(("chain3x3", f"ragged tower {h}x{w} {tag}",
                          dict(geo, B=2, G=2, Ci0=3,
                               dils=(1,) + TOWER_DILATIONS,
                               aff=(False,) + (True,) * 4, dual=False,
                               co_last=32, f32_out=False), 0, None))
            calls.append(("chain3x3", f"ragged head {h}x{w} {tag}",
                          dict(geo, B=1, G=1, Ci0=32, dils=dils,
                               aff=(True,) * 5 + (False,), dual=True,
                               co_last=1, f32_out=True), 0, None))
        for (h, w, b, g) in ((37, 75, 2, 2), (11, 37, 1, 1)):
            for d in (1, 16):
                for c in (32, 16):
                    geo = dict(H=h, W=w, B=b, G=g, C=c, Co=32, cl=cl)
                    calls.append(("dwsep3x3", f"ragged {c}->32 d={d} G={g} "
                                  f"{h}x{w} {tag}", dict(geo, d=d), 0, None))
                    calls.append(("dwsep3x3_pair", f"ragged {c}->32->32 "
                                  f"({17 - d},{d}) G={g} {h}x{w} {tag}",
                                  dict(geo, d1=17 - d, d2=d), 0, None))
        for d in (1, 16):
            calls.append(("dense3x3", f"ragged 32->32 d={d} G=2 {tag}",
                          dict(H=37, W=75, B=2, G=2, Ci=32, Co=32, d=d,
                               aff=True, cl=cl), 0, None))
        calls.append(("dense3x3", f"ragged 2x32->32 d=8 (dual) {tag}",
                      dict(H=37, W=75, B=1, G=1, Ci=32, Co=32, d=8, aff=True,
                           dual=True, cl=cl), 0, None))
        for d in (1, 16):
            for ci, b, g, (h, w) in ((3, 2, 2, (37, 75)), (1, 1, 1, (29, 70))):
                calls.append(("dense3x3", f"ragged entry {ci}->32 d={d} "
                              f"G={g} {h}x{w} {tag}",
                              dict(H=h, W=w, B=b, G=g, Ci=ci, Co=32, d=d,
                                   aff=False, cl=cl), 0, None))
            for co, b, g, f32 in ((1, 1, 1, True), (8, 2, 2, False)):
                calls.append(("dense3x3", f"ragged out 32->{co} d={d} G={g} "
                              f"37x75 {'f32' if f32 else 'bf16'} out {tag}",
                              dict(H=37, W=75, B=b, G=g, Ci=32, Co=co, d=d,
                                   aff=co == 8, f32_out=f32, cl=cl), 0,
                              None))
        calls.append(("conv3d_bn_relu", f"ragged 32->32 B=2 7x11x37 {tag}",
                      dict(B=2, Ci=32, Co=32, D=7, H=11, W=37, cl=cl), 0,
                      None))
        for out, to in (("cl_out", "channels-last"), ("ncdhw_out", "NCDHW")):
            calls.append(("conv3d_bn_relu",
                          f"ragged 8->8 B=2 7x11x37 {tag} to {to}",
                          dict(B=2, Ci=8, Co=8, D=7, H=11, W=37, cl=cl,
                               **{out: True}), 0, None))
        calls.append(("conv3d_skip_softargmin", f"ragged 32->1 B=2 24x3x70 "
                      f"{tag}", dict(B=2, Ci=32, D=24, H=3, W=70, cl=cl,
                                     start=-4), 0, None))
        calls.append(("conv3d_skip_softargmin", f"ragged 8->1 B=2 9x5x37 "
                      f"{tag}", dict(B=2, Ci=8, D=9, H=5, W=37, cl=cl,
                                     start=0), 0, None))
    # the entries' one input channel lies the same in both layouts
    for co in (8, 32):
        calls.append(("conv3d_bn_relu", f"ragged 1->{co} entry B=2 7x11x37",
                      dict(B=2, Ci=1, Co=co, D=7, H=11, W=37, entry=True), 0,
                      None))
    return calls


def _conv(inp, wt, d):
    """One cuDNN conv of inp with wt (G, Co, Ci, 3, 3), batch b with set
    b // (B / G), padding = dilation: the timing yardstick of a layer. With
    groups, the (B / G, G * Ci, H, W) input keeps inp's memory format."""
    import torch
    import torch.nn.functional as F
    G, B = wt.shape[0], inp.shape[0]
    if G == 1:
        return lambda: F.conv2d(inp, wt[0], padding=d, dilation=d)
    fmt = (torch.channels_last if not inp.is_contiguous()
           else torch.contiguous_format)
    xg = inp.reshape(B // G, G * inp.shape[1], *inp.shape[2:]).contiguous(
        memory_format=fmt)
    wg = wt.reshape(-1, *wt.shape[2:])
    return lambda: F.conv2d(xg, wg, padding=d, dilation=d, groups=G)


def _composed(dw, pw):
    """A dw-sep layer's weights (G, C, 3, 3), (G, Co, C) as the dense
    (G, Co, C, 3, 3) kernel pw . dw, formed in float32: a conv over it
    computes pointwise(depthwise(x)) exactly, by associativity."""
    return (pw.float()[:, :, :, None, None] * dw.float()[:, None]).to(
        dw.dtype)


def make_call(kernel, p, dtype, rng, dev):
    """One call on seeded random operands: {kernel, plain, library} fns
    (library None where no one PyTorch call computes the function; then
    `layers` times one cuDNN call per layer; `library_nchw` the library
    call on NCHW copies of channels-last inputs; for chain3x3 `mxu` runs
    the same layers as "mxu"'s dense3x3 launches), bytes and operations.
    p["cl"]: the activation input lies channels-last in memory."""
    import torch
    import torch.nn.functional as F
    from lwsnet_tpu_torch.ops.cuda import costfilter as CF
    from lwsnet_tpu_torch.ops.cuda import probe as PR
    from lwsnet_tpu_torch.ops.cuda import refine_rows as RR

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=torch.float32).to(dev, dt)

    def affine(G, C):
        return t(np.stack([rng.uniform(0.5, 1.5, (G, C)),
                           rng.normal(0, 0.5, (G, C))], 1), torch.float32)

    def call(kernel_fn, plain_fn, library, nbytes, ops, layers=None,
             library_nchw=None, mxu=None):
        return dict(kernel=kernel_fn, plain=plain_fn, library=library,
                    layers=layers, bytes=nbytes, ops=ops,
                    library_nchw=library_nchw, mxu=mxu)

    def lay(a):
        """a channels-last in memory where p["cl"] says so."""
        if not p.get("cl"):
            return a
        return a.contiguous(memory_format=torch.channels_last if a.dim() == 4
                            else torch.channels_last_3d)

    es = torch.tensor([], dtype=dtype).element_size()
    if kernel == "lane_broadcast":
        C, N = p["C"], p["N"]
        v = t(rng.standard_normal((C, 1)))
        return call(lambda: PR.lane_broadcast(v, N),
                    lambda: PR.lane_broadcast_plain(v, N),
                    lambda: v.repeat(1, N), (C + C * N) * es, 0)
    if kernel in ("dwsep3x3", "dwsep3x3_pair"):
        # C -> Co (solo) or C -> Co -> Co (pair); the path's layers are
        # 32 -> 32, the ragged checks also 16 -> 32.
        B, G, C, h, w = (p[k] for k in ("B", "G", "C", "H", "W"))
        Co = p.get("Co", C)
        pair = kernel == "dwsep3x3_pair"
        chans = [(C, Co), (Co, Co)] if pair else [(C, Co)]
        x = lay(t(rng.standard_normal((B, C, h, w))))
        layers = [(t(rng.standard_normal((G, ci, 3, 3)) / 3),
                   t(rng.standard_normal((G, co, ci)) / np.sqrt(ci)),
                   affine(G, ci)) for ci, co in chans]
        n_w = sum(dw.numel() + pw.numel() for dw, pw, _ in layers)
        nbytes = ((C + Co) * B * h * w + n_w) * es + sum(
            8 * G * ci for ci, _ in chans)
        ops = sum(2 * B * h * w * (9 * ci + ci * co) for ci, co in chans)
        if not pair:
            (dw, pw, aff), = layers
            kw = dict(dilation=p["d"], affine=aff)
            k = _composed(dw, pw)
            return call(lambda: RR.dwsep(x, dw, pw, **kw),
                        lambda: RR.dwsep_plain(x, dw, pw, **kw),
                        _conv(x, k, p["d"]), nbytes, ops,
                        library_nchw=(_conv(x.contiguous(), k, p["d"])
                                      if p.get("cl") else None))
        (dw1, pw1, a1), (dw2, pw2, a2) = layers
        kw = dict(dilation1=p["d1"], dilation2=p["d2"], affine1=a1,
                  affine2=a2)
        inner = lay(t(rng.standard_normal((B, Co, h, w))))  # yardstick
        convs = [_conv(x, _composed(dw1, pw1), p["d1"]),
                 _conv(inner, _composed(dw2, pw2), p["d2"])]
        return call(lambda: RR.dwsep2(x, dw1, pw1, dw2, pw2, **kw),
                    lambda: RR.dwsep2_plain(x, dw1, pw1, dw2, pw2, **kw),
                    None, nbytes, ops, lambda: [c() for c in convs])
    if kernel == "chain3x3":
        B, G, C, h, w = (p[k] for k in ("B", "G", "C", "H", "W"))
        dils, n, dual = p["dils"], len(p["dils"]), p["dual"]
        out_dt = torch.float32 if p["f32_out"] else dtype
        cis = [p["Ci0"]] + [C] * (n - 1)
        cos = [C] * (n - 1) + [p["co_last"]]
        fan = [(2 if dual and i == 0 else 1) * cis[i] for i in range(n)]
        wts = [t(rng.standard_normal((G, cos[i], cis[i], 3, 3))
                 * np.sqrt(2 / (9 * fan[i]))) for i in range(n)]
        affs = [affine(G, cis[i]) if p["aff"][i] else None for i in range(n)]
        x = lay(t(rng.standard_normal((B, cis[0], h, w))))
        kw = dict(dilations=dils, out_dtype=out_dt)
        # yardstick operand, channels-last as the route's scratch
        inner = t(rng.standard_normal((B, C, h, w))).contiguous(
            memory_format=torch.channels_last)
        convs = [_conv(inner, wts[i], dils[i]) for i in range(1, n)]
        n_w = sum(wt.numel() for wt in wts)
        if dual:
            x2 = lay(t(rng.standard_normal((B, cis[0], h, w))))
            wt2 = t(rng.standard_normal(tuple(wts[0].shape))
                    * np.sqrt(2 / (9 * fan[0])))
            kw.update(x2=x2, wt2=wt2, aff2=affine(G, cis[0]))
            both = torch.cat([x, x2], 1)
            wcat = torch.cat([wts[0], wt2], 2)
            convs.insert(0, _conv(both, wcat, dils[0]))
            n_w += wt2.numel()
        else:
            convs.insert(0, _conv(x, wts[0], dils[0]))
        out_es = torch.tensor([], dtype=out_dt).element_size()
        n_px = B * h * w
        nbytes = (((2 if dual else 1) * cis[0] * n_px + n_w) * es
                  + cos[-1] * n_px * out_es)
        ops = sum(2 * 9 * fan[i] * cos[i] * n_px for i in range(n))

        def mxu():
            """The same layers as "mxu" runs them: one dense3x3 launch
            each, the entry writing channels-last."""
            y = x
            for i in range(n):
                extra = dict(x2=x2, wt2=wt2, affine2=kw["aff2"]) \
                    if dual and i == 0 else {}
                y = RR.dense3x3(y, wts[i], dilation=dils[i], affine=affs[i],
                                out_dtype=out_dt if i == n - 1 else None,
                                channels_last=i == 0, **extra)
            return y

        return call(lambda: RR.chain(x, wts, affs, **kw),
                    lambda: RR.chain_plain(x, wts, affs, **kw), None,
                    nbytes, ops, lambda: [c() for c in convs], mxu=mxu)
    if kernel == "conv3d_bn_relu" and p.get("entry"):
        # raw volume, layer 0's (a0, b0) with b0 > 0: relu(b0) > 0, so a
        # padding that took the affine would show
        B, Co, D, h, w = (p[k] for k in ("B", "Co", "D", "H", "W"))
        vol = t(rng.standard_normal((B, D, h, w)))
        a0b0 = t([rng.uniform(0.5, 1.5), rng.uniform(0.1, 0.5)],
                 torch.float32)
        wt = t(rng.standard_normal((Co, 1, 3, 3, 3)) * np.sqrt(2 / 27))
        shift = t(rng.normal(0, 0.1, Co), torch.float32)

        def act():  # layer 0's BN + ReLU as plain torch ops
            return F.relu(vol.float() * a0b0[0] + a0b0[1]).to(dtype)[:, None]

        n_vox = B * D * h * w
        a1 = act()
        # a checkout from before the fused entry: the torch ops, then the
        # layer (its profiled kernel time is the layer's alone)
        fused = hasattr(CF, "conv3d_entry")
        return call((lambda: CF.conv3d_entry(vol, a0b0, wt, shift)) if fused
                    else (lambda: CF.conv3d_bn_relu(act(), wt, shift)),
                    (lambda: CF.conv3d_entry_plain(vol, a0b0, wt, shift))
                    if fused
                    else (lambda: CF.conv3d_bn_relu_plain(act(), wt, shift)),
                    lambda: F.conv3d(a1, wt, padding=1),
                    (n_vox * (1 + Co) + wt.numel()) * es + 4 * Co + 8,
                    2 * 27 * Co * n_vox)
    if kernel == "conv3d_bn_relu":
        B, Ci, Co, D, h, w = (p[k] for k in ("B", "Ci", "Co", "D", "H", "W"))
        x = lay(t(np.maximum(rng.standard_normal((B, Ci, D, h, w)), 0)))
        wt = t(rng.standard_normal((Co, Ci, 3, 3, 3)) * np.sqrt(2 / (27 * Ci)))
        shift = t(rng.normal(0, 0.1, Co), torch.float32)
        n_in = B * Ci * D * h * w
        n_out = B * Co * D * h * w
        xn = x.contiguous()
        out = ({"channels_last": True} if p.get("cl_out") else
               {"channels_last": False} if p.get("ncdhw_out") else {})
        return call(lambda: CF.conv3d_bn_relu(x, wt, shift, **out),
                    lambda: CF.conv3d_bn_relu_plain(x, wt, shift),
                    lambda: F.conv3d(x, wt, padding=1),
                    (n_in + n_out + wt.numel()) * es + 4 * Co,
                    2 * 27 * Ci * n_out,
                    library_nchw=(lambda: F.conv3d(xn, wt, padding=1))
                    if p.get("cl") else None)
    if kernel == "conv3d_skip_softargmin":
        B, Ci, D, h, w = (p[k] for k in ("B", "Ci", "D", "H", "W"))
        x = lay(t(np.maximum(rng.standard_normal((B, Ci, D, h, w)), 0)))
        wt = t(rng.standard_normal((1, Ci, 3, 3, 3)) * np.sqrt(2 / (27 * Ci)))
        vol = t(rng.standard_normal((B, D, h, w)) * 2)
        start = p["start"]
        n_vox = B * D * h * w
        return call(lambda: CF.conv3d_skip_softargmin(x, wt, vol, start),
                    lambda: CF.conv3d_skip_softargmin_plain(x, wt, vol,
                                                            start),
                    lambda: F.conv3d(x, wt, padding=1),
                    (B * Ci * D * h * w + n_vox + wt.numel()) * es
                    + 4 * B * h * w,
                    2 * 27 * Ci * n_vox + 5 * n_vox)
    B, G, Ci, Co, d, h, w = (p[k] for k in ("B", "G", "Ci", "Co", "d", "H",
                                            "W"))
    dual = p.get("dual", False)
    out_dt = torch.float32 if p.get("f32_out") else dtype
    x = lay(t(rng.standard_normal((B, Ci, h, w))))
    wt = t(rng.standard_normal((G, Co, Ci, 3, 3)) * np.sqrt(2 / (9 * Ci)))
    aff = affine(G, Ci) if p["aff"] else None
    kw = dict(dilation=d, affine=aff, out_dtype=out_dt)
    if dual:
        x2 = lay(t(rng.standard_normal((B, Ci, h, w))))
        wt2 = t(rng.standard_normal((G, Co, Ci, 3, 3)) * np.sqrt(2 / (9 * Ci)))
        kw.update(x2=x2, wt2=wt2, affine2=affine(G, Ci))
        both, wboth = torch.cat([x, x2], 1), torch.cat([wt, wt2], 2)
        library = _conv(both, wboth, d)
        library_nchw = _conv(both.contiguous(), wboth, d)
    else:
        library = _conv(x, wt, d)
        library_nchw = _conv(x.contiguous(), wt, d)
    n_in = (2 if dual else 1) * B * Ci * h * w
    n_out = B * Co * h * w
    out_es = torch.tensor([], dtype=out_dt).element_size()
    kkw = dict(kw, channels_last=True) if p.get("cl_out") else kw
    return call(lambda: RR.dense3x3(x, wt, **kkw),
                lambda: RR.dense3x3_plain(x, wt, **kw), library,
                (n_in + (2 if dual else 1) * wt.numel()) * es
                + n_out * out_es,
                2 * 9 * Ci * n_out * (2 if dual else 1),
                library_nchw=library_nchw if p.get("cl") else None)


def check_close(got, want, dtype, what):
    """Phase-3 bar; returns (max |delta|, span)."""
    import torch
    got, want = got.float(), want.float()
    require(torch.isfinite(got).all().item(), f"{what}: non-finite output")
    delta = (got - want).abs()
    span = (want.max() - want.min()).item()
    require(span >= 1e-3, f"{what}: span {span:.3g} < 1e-3, ill-posed check")
    if dtype == torch.float32:
        bad = (delta > 2e-4 + 1e-3 * want.abs()).sum().item()
        require(bad == 0, f"{what}: {bad} elements outside atol 2e-4 / rtol "
                f"1e-3 (max |delta| {delta.max().item():.3g})")
    else:
        mean = delta.mean().item()
        require(mean < 0.02 * span, f"{what}: mean |delta| {mean:.3g} >= 2% "
                f"of span {span:.3g}")
    return delta.max().item(), span


def two_steps(got, want, what):
    """The bar of chain3x3, of conv3d_bn_relu's 8-channel layers and of
    conv3d_skip_softargmin on the card: every element within two rounding
    steps of the plain value (2 * 2**-8 relative) plus 2e-2 of the plain
    output's largest magnitude for sums that cancel, as
    tests/test_torch_gpu.py holds it."""
    got, want = got.float(), want.float()
    tol = 2 * 2.0 ** -8 * want.abs() + 2e-2 * want.abs().max()
    bad = ((got - want).abs() > tol).sum().item()
    require(bad == 0, f"{what}: {bad} elements beyond two bf16 rounding "
            f"steps")


def compare(what, truth, plain, got, dtype, shape, failures):
    """Phase-4 bar of one output: finite, of `shape`, and held with the
    module path's output in the same dtype (`plain`) against the float64
    module path's (`truth`): the kernel path's mean |delta| at most
    MEAN_RATIO x the module path's, and in float32 also its max |delta|
    at most MAX_RATIO x the module path's. A miss is appended to
    `failures`. Prints, as % of span (the truth's range + 1), both paths'
    distance from the truth and from each other and, in float32, the pixel
    (batch 1) where the two lie farthest apart with the three values."""
    import torch
    require(tuple(got.shape) == shape, f"{what}: shape {tuple(got.shape)}")
    require(torch.isfinite(got).all().item(), f"{what}: finite")
    span = (truth.max() - truth.min()).item() + 1.0
    e_k, e_m, d = ((a - b).abs() for a, b in ((got, truth), (plain, truth),
                                              (got, plain)))
    row = dict(span=span, mean_abs=d.mean().item(), max_abs=d.max().item(),
               kernels_mean=e_k.mean().item(), kernels_max=e_k.max().item(),
               module_mean=e_m.mean().item(), module_max=e_m.max().item())
    row["mean_ratio"] = row["kernels_mean"] / max(row["module_mean"], 1e-30)
    row["max_ratio"] = row["kernels_max"] / max(row["module_max"], 1e-30)
    pc = {k: f"{100 * v / span:.4g} %" for k, v in row.items()}
    print(f"[4] {what}: span {span:.4g}; from the float64 module path: "
          f"kernels mean {pc['kernels_mean']} max {pc['kernels_max']}, "
          f"module mean {pc['module_mean']} max {pc['module_max']} (ratios "
          f"{row['mean_ratio']:.4f}, {row['max_ratio']:.4f}); kernels - "
          f"module mean {pc['mean_abs']} max {pc['max_abs']}")
    if not row["mean_ratio"] <= MEAN_RATIO:
        failures.append(f"{what}: kernel path mean |delta| "
                        f"{pc['kernels_mean']} > {MEAN_RATIO} x the module "
                        f"path's {pc['module_mean']}")
    if dtype == "float32":
        i = int(d.reshape(-1).argmax())  # batch 1: i = row * W + col
        vals = [float(t.reshape(-1)[i]) for t in (got, plain, truth)]
        row["worst"] = dict(pixel=divmod(i, shape[2]), kernels=vals[0],
                            module=vals[1], float64=vals[2])
        print(f"[4] {what}: kernels and module farthest apart at (row, "
              f"col) {divmod(i, shape[2])}: kernels {vals[0]:.6f}, module "
              f"{vals[1]:.6f}, float64 {vals[2]:.6f}")
        if not row["max_ratio"] <= MAX_RATIO:
            failures.append(f"{what}: kernel path max |delta| "
                            f"{pc['kernels_max']} > {MAX_RATIO} x the "
                            f"module path's {pc['module_max']}")
    return row


def float64_reference(cfg_fields, dev, forward, state=None):
    """The float64 module path's output of `forward(model)` (the phase-4
    reference) for the network of ModelConfig(**cfg_fields) with seed-0
    weights and phase 4's batch norms, or `state` where given."""
    import torch
    from lwsnet_tpu_torch import LWSNet, ModelConfig
    model = LWSNet(ModelConfig(**dict(cfg_fields, compute_dtype="float64")),
                   device=dev, seed=0)
    if state is None:
        jitter_batchnorm(model, np.random.default_rng(3))
    else:
        model.load_state_dict(state)
    out = forward(model)
    del model
    torch.cuda.empty_cache()
    return out


def forward_phase(dev, engines=None):
    """Phase 4: for each engine of `engines` (default all), the 368x1232
    forward through `make_forward` (kernels) and the module path, in bf16
    and float32, each held with `compare` against the float64 module path;
    the bf16 kernel run's launch, route and layout-copy counts; then the
    "layers" refinement alone at WIDE_H x WIDE_W. Fails after printing
    every comparison if any missed its bar. Returns (report, launch
    counts, layout copies, route launches) by engine."""
    import torch
    from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward
    from lwsnet_tpu_torch.models.refine_kernels import refine_residual
    from lwsnet_tpu_torch.ops.cuda import build
    engines = {e: ENGINES[e] for e in (engines or ENGINES)}
    left_np = np.random.default_rng(1).standard_normal((1, H, W, 3))
    right_np = np.random.default_rng(2).standard_normal((1, H, W, 3))
    left = torch.as_tensor(left_np, dtype=torch.float32, device=dev)
    right = torch.as_tensor(right_np, dtype=torch.float32, device=dev)
    # every engine's module path computes the same function: one reference
    truth = float64_reference({}, dev, lambda m: make_forward(
        m, use_pallas=False, device=dev)(left, right))
    build.reset_launch_counts()
    zero = build.launch_counts()
    counts, copies, routes, failures = {}, {}, {}, []
    forward_report = {}
    for dt in ("bfloat16", "float32"):
        plain = None
        for engine, fields in engines.items():
            model = LWSNet(ModelConfig(compute_dtype=dt, **fields),
                           device=dev, seed=0)
            jitter_batchnorm(model, np.random.default_rng(3))
            if plain is None:  # the module path runs no refinement kernel
                plain = make_forward(model, use_pallas=False,
                                     device=dev)(left, right)
            fwd = make_forward(model, use_pallas=True, device=dev)
            build.reset_launch_counts()
            got = fwd(left, right)
            torch.cuda.synchronize()
            if dt == "bfloat16":
                counts[engine] = build.launch_counts()
                copies[engine] = dict(build.LAYOUT_COPIES)
                routes[engine] = build.route_counts()
            forward_report[f"{dt} {engine}"] = [
                dict(stage=s + 1, **compare(f"{dt} {engine} stage {s + 1}",
                                            t, a, b, dt, (1, H, W, 1),
                                            failures))
                for s, (t, a, b) in enumerate(zip(truth, plain, got))]
            del model, got
        del plain
    del truth
    for engine in engines:
        want = want_counts(engine, zero)
        print(f"[4] launch counts of the bf16 {engine} kernel forward: "
              f"{counts[engine]}")
        require(counts[engine] == want,
                f"{engine} launch counts {counts[engine]} != {want}")
        print(f"[4] route launches (dense3x3's narrow routes, the cost "
              f"filters' entries) of the bf16 {engine} kernel forward: "
              f"{routes[engine]}")
        require(routes[engine] == WANT_ROUTES[engine],
                f"{engine} route launches {routes[engine]} != "
                f"{WANT_ROUTES[engine]}")
        print(f"[4] layout copies of the bf16 {engine} kernel forward: "
              f"{copies[engine]}")
        require(copies[engine] == WANT_COPIES[engine],
                f"{engine} layout copies {copies[engine]} != "
                f"{WANT_COPIES[engine]}")
    if "layers" not in engines:
        require(not failures, "; ".join(failures))
        return forward_report, counts, copies, routes

    # the layers refinement alone at a width where its (8, 16) tower pair
    # splits: the only run of the path's solo branch
    rng = np.random.default_rng(4)
    wide_left = torch.as_tensor(rng.standard_normal((1, WIDE_H, WIDE_W, 3)),
                                dtype=torch.float32, device=dev)
    wide_disp = torch.as_tensor(rng.uniform(0, 60, (1, WIDE_H, WIDE_W, 1)),
                                dtype=torch.float32, device=dev)

    def towers_and_head(model):
        with torch.inference_mode():
            both = torch.cat([
                model.RefinementTower_0(
                    wide_left.permute(0, 3, 1, 2).to(model.cfg.dtype)),
                model.RefinementTower_1(
                    wide_disp.permute(0, 3, 1, 2).to(model.cfg.dtype))], 1)
            return model.RefinementHead_0(both).permute(0, 2, 3, 1).float()

    truth = float64_reference(dict(pallas_mode="layers"), dev,
                                towers_and_head)
    for dt in ("bfloat16", "float32"):
        model = LWSNet(ModelConfig(compute_dtype=dt, pallas_mode="layers"),
                       device=dev, seed=0)
        jitter_batchnorm(model, np.random.default_rng(3))
        want = towers_and_head(model)
        with torch.inference_mode():
            build.reset_launch_counts()
            got = refine_residual(model, wide_left, wide_disp)
            torch.cuda.synchronize()
        if dt == "bfloat16":
            counts["layers-wide"] = build.launch_counts()
            copies["layers-wide"] = dict(build.LAYOUT_COPIES)
            routes["layers-wide"] = build.route_counts()
        forward_report[f"{dt} layers-wide residual"] = compare(
            f"{dt} layers residual at {WIDE_H}x{WIDE_W}", truth, want, got,
            dt, (1, WIDE_H, WIDE_W, 1), failures)
        del model, want, got
    want = dict(zero, **WIDE_LAUNCHES)
    print(f"[4] launch counts of the bf16 layers refinement at "
          f"{WIDE_H}x{WIDE_W}: {counts['layers-wide']}")
    require(counts["layers-wide"] == want,
            f"layers-wide launch counts {counts['layers-wide']} != {want}")
    require(routes["layers-wide"] == WANT_ROUTES["layers-wide"],
            f"layers-wide narrow-route launches {routes['layers-wide']}")
    print(f"[4] layout copies of the bf16 layers refinement at "
          f"{WIDE_H}x{WIDE_W}: {copies['layers-wide']}")
    require(copies["layers-wide"] == WANT_COPIES["layers-wide"],
            f"layers-wide layout copies {copies['layers-wide']}")
    require(not failures, "; ".join(failures))
    return forward_report, counts, copies, routes


def layer_phase(dev, zero):
    """Phase 4b: `tools.parity_layers` at H x W, batch 1: every launch of
    the forward under each engine, in bf16 and float32 (TF32 off), on the
    seed-0 network with phase 4's batch norms and on "trained_wide",
    against its module layer (the cost filters' launches held under the
    first engine); each engine's launches, each matched to a reference,
    as many as `want_counts` holds (`zero`: every counter's name), and its
    kernels' launch counts equal to it; then each route of
    `parity_layers.ROUTES` planted (weights x1.01, kernel side, seed-0,
    bf16), which must miss at its launch and nowhere else. Fails after
    printing every reading if any missed. Returns the phase's report."""
    import torch
    from lwsnet_tpu_torch.tools import parity_layers as PL
    from lwsnet_tpu_torch.tools.parity import tf32_off
    t0 = time.time()
    failures, report = [], {"sound": {}, "planted": {}}

    def log(line):
        print(f"[4b] {line}")

    with tf32_off():
        for set_name in PL.SETS:
            for dt in ("bfloat16", "float32"):
                runs = PL.check_set(set_name, dt, list(ENGINES), H, W, dev,
                                    log=log)
                for engine, res in runs.items():
                    want = want_counts(engine, zero)
                    what = f"{set_name} {dt} {engine}"
                    # a "[dual]" launch is one of its kernel's launches
                    launches = sum(v for k, v in want.items() if "[" not in k)
                    require(res["launches"] == launches,
                            f"{what}: {res['launches']} launches matched to "
                            f"references, want_counts has {launches}")
                    require(res["kernel_counts"] == want,
                            f"{what}: kernel launches {res['kernel_counts']}"
                            f" != {want}")
                    failures += [f"{what} #{r['index']} {r['route']} "
                                 f"({r['where']}): ratio "
                                 f"{r['mean_ratio']:.3f} (max "
                                 f"{r['max_ratio']:.3f})"
                                 for r in res["rows"] if not r["ok"]]
                    log(f"{what}: {res['launches']} launches, each with its "
                        f"reference, {res['held']} held here (the cost "
                        f"filters' under {next(iter(ENGINES))}); kernel "
                        f"launches {res['kernel_counts']}")
                report["sound"][f"{set_name} {dt}"] = runs
        sound = report["sound"]["seed0 bfloat16"]
        for route, engine in PL.ROUTES.items():
            res = PL.check_plant(route, H, W, dev, log=lambda _: None)
            at = res["planted_at"]
            got = next(r for r in res["rows"] if r["index"] == at)
            ref = next(r for r in sound[engine]["rows"] if r["index"] == at)
            log(f"planted x{PL.PLANT_SCALE} {route} ({engine} #{at}, "
                f"{got['where']}): ratio {got['mean_ratio']:.3f} (max "
                f"{got['max_ratio']:.3f}) against sound "
                f"{ref['mean_ratio']:.3f} (max {ref['max_ratio']:.3f}), bar "
                f"{PL.bars(torch.bfloat16, route)[0]}; launches that "
                f"missed: {res['missed']}")
            if not res["caught"]:
                failures.append(f"planted {route}: missed at {res['missed']}"
                                f", want [{at}] alone")
            report["planted"][route] = res
    report["seconds"] = time.time() - t0
    with open(os.path.join("chiprun_out", "parity_layers.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"[4b] per-launch check: {len(failures)} misses; "
          f"{report['seconds']:.1f} s")
    require(not failures, "; ".join(failures))
    return report


TRAIN_FRAMES, TRAIN_H, TRAIN_W = 16, 375, 1242  # the KITTI frame size
TRAIN_CROP = (256, 512)   # the published finetune crop, batch 4
STEP_SHAPE = (2, 128, 256)  # card against CPU: batch, height, width


def write_kitti_corpus(root, seed=0):
    """A synthetic KITTI2015 `training/` corpus: TRAIN_FRAMES frames of
    image_2 / image_3 (right = left shifted 5-40 px) and disp_occ_0 (uint16
    disparity x 256, about a third of the pixels valid, 1-150 px), and a
    split file naming 8 frames for validation. Returns the split's path."""
    from lwsnet_tpu_torch.data.png import write_png
    rng = np.random.default_rng(seed)
    for d in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(TRAIN_FRAMES):
        name = f"{i:06d}_10.png"
        img = rng.integers(0, 256, (TRAIN_H, TRAIN_W, 3), dtype=np.uint8)
        shift = int(rng.integers(5, 41))
        disp = rng.uniform(1.0, 150.0, (TRAIN_H, TRAIN_W))
        disp[rng.uniform(size=disp.shape) > 1 / 3] = 0.0
        for sub, arr in (("image_2", img),
                         ("image_3", np.roll(img, -shift, axis=1)),
                         ("disp_occ_0", (disp * 256).astype(np.uint16))):
            write_png(os.path.join(root, sub, name), arr, compress_level=1)
    split = os.path.join(root, "val.txt")
    with open(split, "w") as f:
        f.write("".join(f"{i}\n" for i in range(0, TRAIN_FRAMES, 2)))
    return split


def build_native():
    """`make -B -C native`: the native PNG decoder and fused crops of the
    data path, built for this machine (a library copied from another
    machine is removed first). Returns what happened, for the log; without
    it the pipeline decodes through PIL or the stdlib codec."""
    import subprocess
    lib = os.path.join("native", "libstereoload.so")
    if os.path.exists(lib):
        os.remove(lib)
    try:
        r = subprocess.run(["make", "-B", "-C", "native"],
                           capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not built ({e})"
    if r.returncode != 0 or not os.path.exists(lib):
        return f"not built (make: {r.stderr.strip()[-300:]})"
    return "built"


def _grad_agreement(a, b, floor):
    """(cosine of the whole gradient, least per-tensor cosine and its
    tensor, {tensor: |a - b|} of the tensors below `floor`) of two
    {name: gradient} dicts, float64."""
    cos, zero = {}, {}
    for n, g in a.items():
        if float(b[n].norm()) < floor:
            zero[n] = float((g - b[n]).norm())
        else:
            cos[n] = float((g * b[n]).sum() / (g.norm() * b[n].norm()))
    x, y = (np.concatenate([d[n].reshape(-1).numpy() for n in cos])
            for d in (a, b))
    worst = min(cos, key=cos.get)
    whole = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
    return whole, cos[worst], worst, zero


def card_vs_cpu_step(dev, seed=0):
    """One float32 train step (TF32 off) of the full-width model at
    STEP_SHAPE, on the card and on the CPU from the same seed-0 weights and
    batch, and on the CPU once more with the left image scaled by
    1 + 1e-7, which shows how far the float32 gradient moves when only
    its rounding changes. Fails past the bars: loss and stage losses rtol
    1e-4; grad_norm rtol 1e-3; the whole gradient's cosine >= 0.997 and
    each tensor's >= 0.95, but a tensor whose gradient lies below 1e-6 of
    the global norm (zero to float32, with no direction) within 1e-6 of
    the global norm of the CPU's; BN running statistics rtol 1e-4 (atol
    1e-6). The cosine bars lie between the nudge's spread (1 - 1.1e-3,
    least tensor 0.985) and a planted fault's reading at this geometry
    (the batch mean's gradient dropped in train-mode BN: 1 - 0.11, least
    tensor -0.28); grad_norm's between the card's (1.4e-5 to 8.6e-5 on
    this batch) and the whole gradient 1 % off (1.0e-2) (PERF.md,
    Findings). Returns the measured agreement of both."""
    import torch
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step
    tcfg = TrainConfig(mask_min_disp=0.0)
    rng = np.random.default_rng(seed)
    batch = [rng.standard_normal(STEP_SHAPE + (3,)),
             rng.standard_normal(STEP_SHAPE + (3,)),
             rng.uniform(1.0, 150.0, STEP_SHAPE)]
    batch[2][rng.uniform(size=batch[2].shape) > 1 / 3] = 0.0
    nudged = [batch[0] * (1.0 + 1e-7)] + batch[1:]
    cpu = torch.device("cpu")
    out = {}
    for what, d, b in (("card", dev, batch), ("cpu", cpu, batch),
                       ("nudged", cpu, nudged)):
        st = create_train_state(ModelConfig(compute_dtype="float32"), tcfg,
                                seed=0, device=d)
        st, aux = make_train_step(tcfg, 1)(
            st, *[torch.as_tensor(a, dtype=torch.float32, device=d)
                  for a in b])
        out[what] = dict(
            aux={k: (v.detach().cpu().double() if torch.is_tensor(v)
                     else v) for k, v in aux.items()},
            grads={n: p.grad.detach().cpu().double()
                   for n, p in st.model.named_parameters()},
            stats={n: b.detach().cpu().double()
                   for n, b in st.model.named_buffers()})
        del st
    ref = out["cpu"]
    floor = 1e-6 * float(ref["aux"]["grad_norm"])
    rel = lambda a, b: float(((a - b).abs() / b.abs()).max())  # noqa: E731
    res = {}
    for what in ("card", "nudged"):
        got = out[what]
        whole, least, worst, zero = _grad_agreement(got["grads"],
                                                    ref["grads"], floor)
        res[what] = dict(
            {k: rel(got["aux"][k], ref["aux"][k])
             for k in ("loss", "stage_losses", "grad_norm")},
            cosine=whole, min_cosine=least, min_cosine_tensor=worst,
            zero_max=max(zero.values()), zero_tensors=len(zero),
            stats=max(float(((b - ref["stats"][n]).abs()
                             / (1e-4 * ref["stats"][n].abs() + 1e-6)).max())
                      for n, b in got["stats"].items()))
        r = res[what]
        print(f"[8] {what} vs CPU, one float32 step (batch "
              f"{STEP_SHAPE[0]}, {STEP_SHAPE[1]}x{STEP_SHAPE[2]}, TF32 off):"
              f" loss rel {r['loss']:.3g}, stage losses rel "
              f"{r['stage_losses']:.3g}, grad_norm rel {r['grad_norm']:.3g}"
              f" (of {float(ref['aux']['grad_norm']):.6g}), gradient cosine"
              f" {r['cosine']:.7f}, least of {len(got['grads']) - len(zero)}"
              f" tensors {r['min_cosine']:.7f} ({worst}), {len(zero)} "
              f"tensors below the float32 floor {floor:.3g} within "
              f"{r['zero_max']:.3g}; BN statistics worst |delta| / (1e-4 "
              f"|cpu| + 1e-6) {r['stats']:.3g}")
    r = res["card"]
    require(r["loss"] <= 1e-4 and r["stage_losses"] <= 1e-4,
            "card vs CPU: loss beyond rtol 1e-4")
    require(r["grad_norm"] <= 1e-3, "card vs CPU: grad_norm beyond rtol "
            "1e-3")
    require(r["cosine"] >= 0.997 and r["min_cosine"] >= 0.95,
            f"card vs CPU: gradient cosine {r['cosine']}, least "
            f"{r['min_cosine']} ({r['min_cosine_tensor']})")
    require(r["zero_max"] <= floor, "card vs CPU: gradients below the "
            "float32 floor differ")
    require(r["stats"] <= 1.0, "card vs CPU: BN running statistics beyond "
            "rtol 1e-4")
    return res


def training_phase(dev, smi, tmp):
    """Phase 8: the finetune CLI on the card at full width on a KITTI
    corpus written to `tmp`/training (phase 9 reads it too), card-vs-CPU
    parity of one step, the trained weights through the kernel path, and
    the train and eval step timings. Returns the phase's report."""
    import torch
    from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward
    from lwsnet_tpu_torch.cli import finetune
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.data import transforms as T
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.training.checkpoint import CheckpointManager
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import (make_eval_step,
                                                 make_train_step)
    from lwsnet_tpu_torch.utils.timing import event_times
    t0 = time.time()
    report = {"native_decode": build_native()}
    print(f"[8] native decode library: {report['native_decode']}")
    root = os.path.join(tmp, "training")
    split = write_kitti_corpus(root)
    save = os.path.join(tmp, "finetune")
    common = ["--datapath", root, "--val_set", split, "--pretrained", "",
              "--train_batch_size", "4", "--test_batch_size", "8",
              "--crop_height", str(TRAIN_CROP[0]),
              "--crop_width", str(TRAIN_CROP[1]),
              "--eval_height", str(H), "--eval_width", str(W),
              "--save_path", save, "--num_workers", "4",
              "--device", "cuda"]
    print(f"[8] corpus: {TRAIN_FRAMES} frames at {TRAIN_H}x{TRAIN_W}, "
          f"8 for validation ({time.time() - t0:.1f} s)")

    # 2. train through the CLI, resume, evaluate; the training path
    # launches none of the port's kernels
    build.reset_launch_counts()
    zero = build.launch_counts()
    fresh = LWSNet(ModelConfig(), device="cpu", seed=0).state_dict()
    trained = finetune.run(["--epoch", "2"] + common)
    hist = trained.history
    require(len(hist) == 4 and all(
        h["finite"] == 1.0 and np.isfinite(h["loss"]) for h in hist),
        f"finetune: step losses {hist}")
    moved = sum(not torch.equal(v.cpu(), fresh[k]) for k, v in
                trained.state.model.state_dict().items())
    require(moved > 0, "finetune: no parameter moved")
    ckpt = CheckpointManager(save)
    require(ckpt.exists() and os.path.exists(ckpt.meta_path),
            "finetune: no checkpoint and metadata")
    with open(ckpt.meta_path) as f:
        meta = json.load(f)
    require(set(meta) == {"epoch", "lr", "error", "time_cost"},
            f"checkpoint metadata {meta}")
    resumed = finetune.run(["--epoch", "3", "--resume"] + common)
    require(resumed.start_epoch == int(meta["epoch"]) + 1
            and resumed.best_error <= meta["error"]
            and resumed.history[-1]["epoch"] == 2,
            f"resume: start epoch {resumed.start_epoch}, best "
            f"{resumed.best_error}, metadata {meta}")
    d1 = finetune.main(["--evaluate", "--resume"] + common)
    require(np.isfinite(d1) and 0.0 <= d1 <= 1.0, f"--evaluate: D1 {d1}")
    counts = build.launch_counts()
    require(counts == zero, f"the training path launched kernels: "
            f"{counts}")
    print(f"[8] finetune CLI, bf16 full width, batch 4 at "
          f"{TRAIN_CROP[0]}x{TRAIN_CROP[1]}: "
          f"losses {[round(h['loss'], 3) for h in hist]}, {moved} "
          f"tensors moved, best D1 {meta['error']:.4f} at epoch "
          f"{int(meta['epoch'])}; --resume --epoch 3 ran epochs "
          f"{sorted({h['epoch'] for h in resumed.history})}; "
          f"--evaluate D1 {d1:.4f}; port kernel launches {counts}")
    report["finetune"] = dict(losses=[h["loss"] for h in hist],
                              resumed_losses=[h["loss"] for h in
                                              resumed.history],
                              metadata=meta, evaluate_d1=d1)

    # 4. trained weights through the kernel path and the module path,
    # each against the float64 module path at the eval window: phase
    # 4's bf16 bar
    state = torch.load(ckpt.path, map_location=dev,
                       weights_only=True)["model"]
    model = LWSNet(ModelConfig(), device=dev)
    model.load_state_dict(state)
    left, right = (torch.as_tensor(T.crop_normalize(
        T.decode_image_u8(os.path.join(root, sub, "000001_10.png")),
        TRAIN_H - H, TRAIN_W - W, H, W)[None], device=dev)
        for sub in ("image_2", "image_3"))
    del trained, resumed
    truth = float64_reference({}, dev, lambda m: make_forward(
        m, use_pallas=False, device=dev)(left, right), state=state)
    want = make_forward(model, use_pallas=False, device=dev)(left, right)
    got = make_forward(model, use_pallas=True, device=dev)(left, right)
    torch.cuda.synchronize()
    failures = []
    report["trained_forward"] = [
        dict(stage=s + 1, **compare(f"bfloat16 trained weights stage "
                                    f"{s + 1}", t, a, b, "bfloat16",
                                    (1, H, W, 1), failures))
        for s, (t, a, b) in enumerate(zip(truth, want, got))]
    require(not failures, "; ".join(failures))
    del model, state, truth, want, got

    # 3. one float32 step, card against CPU
    report["card_vs_cpu"] = card_vs_cpu_step(dev)

    # 5. timings: the bf16 train step at batch 4 and the finetune crop, and
    # the eval step at batch 8 and the eval window
    tcfg = TrainConfig(mask_min_disp=0.0)
    st = create_train_state(ModelConfig(), tcfg, seed=0, device=dev)
    rng = np.random.default_rng(7)
    l, r = (torch.as_tensor(rng.standard_normal((4, *TRAIN_CROP, 3)),
                            dtype=torch.float32, device=dev)
            for _ in range(2))
    g = torch.as_tensor(rng.uniform(1, 150, (4, *TRAIN_CROP)),
                        dtype=torch.float32, device=dev)
    step = make_train_step(tcfg, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts = event_times(lambda: step(st, l, r, g), reps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(ts)
    # after the event timings: timings taken after a profiler window read
    # slower (PERF.md)
    prof = device_profile(lambda: step(st, l, r, g), reps=3)
    del l, r, g
    l8, r8 = (torch.as_tensor(rng.standard_normal((8, H, W, 3)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    g8 = torch.as_tensor(rng.uniform(1, 150, (8, H, W)),
                         dtype=torch.float32, device=dev)
    valid = torch.ones(8, device=dev)
    evaluate = make_eval_step()
    te = event_times(lambda: evaluate(st, l8, r8, g8, valid), reps=5,
                     warmup=2)
    report["timing"] = dict(
        card=smi, train_step_ms=med, train_step_max_ms=ts[-1],
        train_step_samples=len(ts), images_per_s=4 / (med / 1e3),
        peak_bytes=peak, train_step_profile=prof,
        eval_step_ms=statistics.median(te), eval_step_max_ms=te[-1],
        eval_step_samples=len(te))
    print(f"[8] bf16 train step, batch 4 at {TRAIN_CROP[0]}x{TRAIN_CROP[1]}: "
          f"median {med:.3f} ms, "
          f"max {ts[-1]:.3f} ms over {len(ts)} after 3 warm-ups (CUDA "
          f"events), {4 / (med / 1e3):.2f} images/s, peak memory "
          f"{peak / 2**30:.3f} GiB (max_memory_allocated) ({smi})")
    if prof is None:
        print("[8] train step device busy share: not measured (the "
              "profiler recorded no device activity)")
    else:
        print(f"[8] profiled bf16 train step: host clock "
              f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} "
              f"ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %); "
              f"costliest kernels: " + "; ".join(
                  f"{t:.3f} ms {n}" for n, t in prof["top_other"]))
    print(f"[8] bf16 eval step, batch 8 at {H}x{W}: median "
          f"{statistics.median(te):.3f} ms, max {te[-1]:.3f} ms over "
          f"{len(te)} after 2 warm-ups ({smi})")
    report["seconds"] = time.time() - t0
    print(f"[8] training phase: {report['seconds']:.1f} s")
    return report


SF_TRAIN, SF_TEST, SF_H, SF_W = 16, 8, 540, 960  # SceneFlow's frame size
SF_EVAL = (544, 960)       # the published SceneFlow eval window
INFER_FRAMES = 4


def write_sceneflow_corpus(root, seed=1):
    """A synthetic SceneFlow root: a monkaa scene of SF_TRAIN frames (the
    train split) and a frames_cleanpass/TEST/A sequence of SF_TEST frames
    (the test split), SF_H x SF_W, right = left shifted 5-40 px, PFM
    disparity 1-150 px with a tenth of the pixels at 250 (past the
    pretrain mask's 192)."""
    from lwsnet_tpu_torch.data.pfm import write_pfm
    from lwsnet_tpu_torch.data.png import write_png
    rng = np.random.default_rng(seed)
    for img_dir, disp_dir, n in (
            (("monkaa_frames_cleanpass", "scene"),
             ("monkaa_disparity", "scene"), SF_TRAIN),
            (("frames_cleanpass", "TEST", "A", "0000"),
             ("frames_disparity", "TEST", "A", "0000"), SF_TEST)):
        img_dir, disp_dir = (os.path.join(root, *d)
                             for d in (img_dir, disp_dir))
        for d in (os.path.join(img_dir, "left"),
                  os.path.join(img_dir, "right"),
                  os.path.join(disp_dir, "left")):
            os.makedirs(d, exist_ok=True)
        for i in range(n):
            img = rng.integers(0, 256, (SF_H, SF_W, 3), dtype=np.uint8)
            shift = int(rng.integers(5, 41))
            name = f"{i:04d}.png"
            write_png(os.path.join(img_dir, "left", name), img,
                      compress_level=1)
            write_png(os.path.join(img_dir, "right", name),
                      np.roll(img, -shift, axis=1), compress_level=1)
            disp = rng.uniform(1.0, 150.0, (SF_H, SF_W)).astype(np.float32)
            disp[rng.uniform(size=disp.shape) < 0.1] = 250.0
            write_pfm(os.path.join(disp_dir, "left", f"{i:04d}.pfm"), disp)


def write_testing_dir(root, seed=2):
    """A KITTI `testing/` directory (no ground truth) of INFER_FRAMES
    frames at TRAIN_H x TRAIN_W, and beside it `pair/` with frame 0 as
    left_test.png and its sibling right_test.png for the single-pair
    mode. Returns the single pair's left path."""
    from lwsnet_tpu_torch.data.png import write_png
    rng = np.random.default_rng(seed)
    pair = os.path.join(os.path.dirname(root), "pair")
    for d in (os.path.join(root, "image_2"), os.path.join(root, "image_3"),
              pair):
        os.makedirs(d, exist_ok=True)
    for i in range(INFER_FRAMES):
        img = rng.integers(0, 256, (TRAIN_H, TRAIN_W, 3), dtype=np.uint8)
        right = np.roll(img, -int(rng.integers(5, 41)), axis=1)
        name = f"{i:06d}_10.png"
        paths = [os.path.join(root, "image_2", name),
                 os.path.join(root, "image_3", name)]
        if i == 0:
            paths += [os.path.join(pair, "left_test.png"),
                      os.path.join(pair, "right_test.png")]
        for path, arr in zip(paths, (img, right, img, right)):
            write_png(path, arr, compress_level=1)
    return os.path.join(pair, "left_test.png")


def free_port():
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def probe_step(dev, deterministic=True):
    """One float32 train step (TF32 off) of the full-width model at
    STEP_SHAPE from the seed-0 state, on `card_vs_cpu_step`'s batch with
    the pretrain recipe's mask; {loss, grad_norm} and the collectives it
    ran (none without a process group). With `deterministic`, under
    `torch.use_deterministic_algorithms` and cuDNN's deterministic
    algorithms, which raise rather than run an op that has none: the
    default backward (atomic adds in the warp's and the resize's
    gradients, cuDNN's algorithm choice) moves grad_norm from run to run."""
    import torch
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.parallel import mesh
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step
    tcfg = TrainConfig(mask_max_disp=192.0)
    rng = np.random.default_rng(0)
    batch = [rng.standard_normal(STEP_SHAPE + (3,)),
             rng.standard_normal(STEP_SHAPE + (3,)),
             rng.uniform(1.0, 250.0, STEP_SHAPE)]
    st = create_train_state(ModelConfig(compute_dtype="float32"), tcfg,
                            seed=0, device=dev)
    mesh.reset_collective_counts()
    with (deterministic_algorithms() if deterministic
          else contextlib.nullcontext()):
        _, aux = make_train_step(tcfg, 1)(
            st, *[torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in batch])
        return dict(loss=float(aux["loss"]),
                    grad_norm=float(aux["grad_norm"]),
                    collectives=mesh.collective_counts())


def recipe_phase(dev, smi, tmp):
    """Phase 9: the two-phase recipe and inference through the three CLIs
    at full width in bf16, seed 0: (a) `cli.pretrain` on a synthetic
    SceneFlow corpus under an NCCL process group of one process, with one
    float32 step through the distributed path against the single-process
    one and the pretrain and eval step timings; (b) `cli.finetune
    --pretrained` on phase 8's KITTI corpus in `tmp`; (c) `cli.infer
    --model` on "mxu" over a KITTI testing directory and on one pair,
    its launch counts and one frame against the float64 module path.
    Returns the phase's report."""
    import shutil
    import torch
    import torch.distributed as dist
    from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward
    from lwsnet_tpu_torch.cli import finetune, infer, pretrain
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.data import transforms as T
    from lwsnet_tpu_torch.models.blocks import BatchNorm
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.parallel import mesh
    from lwsnet_tpu_torch.training import loop
    from lwsnet_tpu_torch.training.checkpoint import CheckpointManager
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import (make_eval_step,
                                                 make_train_step)
    from lwsnet_tpu_torch.utils.timing import event_times
    t0 = time.time()
    report = {}
    sf = os.path.join(tmp, "sceneflow")
    write_sceneflow_corpus(sf)
    print(f"[9] SceneFlow corpus: {SF_TRAIN} train and {SF_TEST} test "
          f"frames at {SF_H}x{SF_W} ({time.time() - t0:.1f} s)")

    # (a) pretrain under NCCL at world size 1, from the launcher's
    # environment as torchrun sets it
    single = probe_step(dev)
    require(not dist.is_initialized() and not single["collectives"],
            "the single-process step ran collectives")
    spread = [probe_step(dev, deterministic=False)["grad_norm"]
              for _ in range(2)]
    spread = abs(spread[1] / spread[0] - 1.0)
    launcher = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    os.environ.update(launcher)
    pre = os.path.join(tmp, "pretrained")
    try:
        mesh.reset_collective_counts()
        build.reset_launch_counts()
        zero = build.launch_counts()
        trainer = pretrain.run([
            "--datapath", sf, "--epoch", "1", "--train_batch_size", "8",
            "--test_batch_size", "8", "--crop_height", str(TRAIN_CROP[0]),
            "--crop_width", str(TRAIN_CROP[1]),
            "--eval_height", str(SF_EVAL[0]), "--eval_width",
            str(SF_EVAL[1]), "--save_path", pre, "--num_workers", "4",
            "--device", dev.type])
        backend = dist.get_backend() if dist.is_initialized() else None
        counts = mesh.collective_counts()
        require(backend == ("nccl" if dev.type == "cuda" else "gloo"),
                f"pretrain: process group {backend}")
        require(trainer.process_count == 1
                and trainer.device == mesh.process_device(dev.type),
                f"pretrain: {trainer.process_count} processes on "
                f"{trainer.device}")
        hist = trainer.history
        steps = SF_TRAIN // 8
        require(len(hist) == steps and all(
            h["finite"] == 1.0 and np.isfinite(h["loss"]) for h in hist),
            f"pretrain: step losses {hist}")
        require(np.isfinite(trainer.last_error),
                f"pretrain: EPE {trainer.last_error}")
        require(CheckpointManager(pre).exists(), "pretrain: no checkpoint")
        n_bn = sum(isinstance(m, BatchNorm)
                   for m in trainer.state.model.modules())
        want = {"batch_norm": n_bn * steps, "loss_count": steps,
                "gradients": steps, "loss": steps, "eval": SF_TEST // 8,
                "barrier": 1}
        require(counts == want, f"pretrain collectives {counts} != {want}")
        require(build.launch_counts() == zero,
                "the pretrain path launched kernels")
        print(f"[9a] cli.pretrain under torch.distributed ({backend}, world "
              f"size 1, {trainer.device}), bf16 full width, batch 8 at "
              f"{TRAIN_CROP[0]}x{TRAIN_CROP[1]}, eval 8 at {SF_EVAL[0]}x"
              f"{SF_EVAL[1]}: losses {[round(h['loss'], 3) for h in hist]}, "
              f"EPE {trainer.last_error:.4f}; collectives {counts}")
        report["pretrain"] = dict(losses=[h["loss"] for h in hist],
                                  epe=trainer.last_error,
                                  collectives=counts)
        del trainer

        ddp = probe_step(dev)
        rel = {k: abs(ddp[k] / single[k] - 1.0)
               for k in ("loss", "grad_norm")}
        print(f"[9a] one float32 step (batch {STEP_SHAPE[0]}, "
              f"{STEP_SHAPE[1]}x{STEP_SHAPE[2]}, TF32 off, deterministic "
              f"algorithms), distributed vs single-process: loss "
              f"{ddp['loss']:.9g} vs {single['loss']:.9g} (rel "
              f"{rel['loss']:.3g}), grad_norm {ddp['grad_norm']:.9g} vs "
              f"{single['grad_norm']:.9g} (rel {rel['grad_norm']:.3g}); "
              f"collectives {ddp['collectives']}; the default algorithms' "
              f"grad_norm moves by rel {spread:.3g} between two "
              f"single-process runs")
        require(ddp["collectives"].get("gradients") == 1
                and ddp["collectives"].get("batch_norm", 0) > 0,
                f"the distributed step ran {ddp['collectives']}")
        require(rel["loss"] <= 1e-6 and rel["grad_norm"] <= 1e-5,
                f"distributed vs single step: {rel}")
        report["distributed_vs_single"] = dict(
            single=single, ddp=ddp, rel=rel, default_algorithms_spread=spread)

        # timings under the group: the bf16 pretrain step, batch 8 at the
        # crop, and the eval step, batch 8 at the eval window (540-row
        # ground truth, row offset 4)
        tcfg = TrainConfig(mask_max_disp=192.0)
        st = create_train_state(ModelConfig(), tcfg, seed=0, device=dev)
        rng = np.random.default_rng(7)
        l, r = (torch.as_tensor(rng.standard_normal((8, *TRAIN_CROP, 3)),
                                dtype=torch.float32, device=dev)
                for _ in range(2))
        g = torch.as_tensor(rng.uniform(1, 250, (8, *TRAIN_CROP)),
                            dtype=torch.float32, device=dev)
        step = make_train_step(tcfg, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts = event_times(lambda: step(st, l, r, g), reps=10, warmup=3)
        peak = torch.cuda.max_memory_allocated()
        del l, r, g
        l8, r8 = (torch.as_tensor(rng.standard_normal((8, *SF_EVAL, 3)),
                                  dtype=torch.float32, device=dev)
                  for _ in range(2))
        g8 = torch.as_tensor(rng.uniform(1, 250, (8, SF_H, SF_W)),
                             dtype=torch.float32, device=dev)
        valid = torch.ones(8, device=dev)
        evaluate = make_eval_step(sceneflow_row_offset=4)
        te = event_times(lambda: evaluate(st, l8, r8, g8, valid), reps=5,
                         warmup=2)
        del st, l8, r8, g8
        med = statistics.median(ts)
        report["timing"] = dict(
            card=smi, train_step_ms=med, train_step_max_ms=ts[-1],
            train_step_samples=len(ts), images_per_s=8 / (med / 1e3),
            peak_bytes=peak, eval_step_ms=statistics.median(te),
            eval_step_max_ms=te[-1], eval_step_samples=len(te))
        print(f"[9a] bf16 pretrain step under {backend}, batch 8 at "
              f"{TRAIN_CROP[0]}x{TRAIN_CROP[1]}: median {med:.3f} ms, max "
              f"{ts[-1]:.3f} ms over {len(ts)} after 3 warm-ups (CUDA "
              f"events), {8 / (med / 1e3):.2f} images/s, peak memory "
              f"{peak / 2**30:.3f} GiB (max_memory_allocated) ({smi})")
        print(f"[9a] bf16 eval step under {backend}, batch 8 at {SF_EVAL[0]}x"
              f"{SF_EVAL[1]} (ground truth {SF_H}x{SF_W}, row offset 4): "
              f"median {statistics.median(te):.3f} ms, max {te[-1]:.3f} ms "
              f"over {len(te)} after 2 warm-ups ({smi})")

        # (b) finetune from the pretrained checkpoint on phase 8's corpus;
        # the state the first train epoch starts from is read as it starts
        want_state = torch.load(CheckpointManager(pre).path,
                                map_location="cpu",
                                weights_only=True)["model"]
        first = {}
        train_epoch = loop.Trainer.train_epoch

        def spy(self, epoch):
            first.setdefault("state", {
                k: v.detach().cpu().clone()
                for k, v in self.state.model.state_dict().items()})
            return train_epoch(self, epoch)

        loop.Trainer.train_epoch = spy
        ft = os.path.join(tmp, "finetuned")
        try:
            tuned = finetune.run([
                "--datapath", os.path.join(tmp, "training"), "--val_set",
                os.path.join(tmp, "training", "val.txt"), "--pretrained",
                pre, "--epoch", "1", "--train_batch_size", "4",
                "--test_batch_size", "8", "--crop_height",
                str(TRAIN_CROP[0]), "--crop_width", str(TRAIN_CROP[1]),
                "--eval_height", str(H), "--eval_width", str(W),
                "--save_path", ft, "--num_workers", "4", "--device", dev.type])
        finally:
            loop.Trainer.train_epoch = train_epoch
        got = first["state"]
        equal = got.keys() == want_state.keys() and all(
            torch.equal(got[k], v) for k, v in want_state.items())
        require(equal, "finetune: the state before the first step is not "
                "the pretrained checkpoint's")
        require(len(tuned.history) == 2 and all(
            h["finite"] == 1.0 for h in tuned.history)
            and CheckpointManager(ft).exists()
            and 0.0 <= tuned.last_error <= 1.0,
            f"finetune from pretrained: {tuned.history}, D1 "
            f"{tuned.last_error}")
        print(f"[9b] cli.finetune --pretrained: the {len(want_state)} "
              f"tensors before the first step equal the pretrained "
              f"checkpoint's exactly; losses "
              f"{[round(h['loss'], 3) for h in tuned.history]}, D1 "
              f"{tuned.last_error:.4f}")
        report["finetune"] = dict(losses=[h["loss"] for h in tuned.history],
                                  d1=tuned.last_error)
        del tuned, first, got
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in launcher:
            os.environ.pop(k, None)

    # (c) infer with the finetuned weights on the kernel path ("mxu")
    testing = os.path.join(tmp, "testing")
    left = write_testing_dir(testing)
    out = os.path.join(tmp, "inference")
    build.reset_launch_counts()
    zero = build.launch_counts()
    window = ["--eval_height", str(H), "--eval_width", str(W), "--model",
              ft, "--device", dev.type]
    frames = infer.run(["--img_path", testing, "--save_path", out] + window)
    frames += infer.run(["--left_img", left, "--save_path",
                         os.path.join(out, "single")] + window)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    # InferenceEngine.infer_files runs two forwards a frame: a warm-up,
    # then the timed one
    forwards = 2 * len(frames)
    want = {k: forwards * n for k, n in want_counts("mxu", zero).items()}
    require(counts == want, f"infer CLI launch counts {counts} != {want}")
    names = sorted(os.listdir(out))
    for i in range(INFER_FRAMES):
        for s in range(1, 5):
            require(f"{i:06d}_10_stage{s}.png" in names,
                    f"infer: no PNG for frame {i} stage {s}")
    require(sorted(os.listdir(os.path.join(out, "single"))) ==
            [f"{s}.png" for s in range(1, 5)], "infer: single-pair PNGs")
    for f in frames:
        print(f"[9c] cli.infer {f['name']}: forward {f['seconds'] * 1e3:.3f}"
              f" ms (CUDA events, after a warm-up), frame "
              f"{f['host_seconds'] * 1e3:.3f} ms on the host clock (decode, "
              f"two forwards, four PNGs) ({smi})")
    print(f"[9c] cli.infer launches over {forwards} forwards "
          f"({len(frames)} frames): {counts}")

    # frame 0 through the CLI against the float64 module path on the same
    # restored weights, with the bf16 module path beside it: phase 4's bar
    state = torch.load(CheckpointManager(ft).path, map_location=dev,
                       weights_only=True)["model"]
    l, r = (torch.as_tensor(T.normalize(T.bottom_right_crop(
        T.load_image(p), H, W))[None], dtype=torch.float32, device=dev)
        for p in (os.path.join(testing, sub, "000000_10.png")
                  for sub in ("image_2", "image_3")))
    truth = float64_reference({}, dev, lambda m: make_forward(
        m, use_pallas=False, device=dev)(l, r), state=state)
    model = LWSNet(ModelConfig(), device=dev)
    model.load_state_dict(state)
    plain = make_forward(model, use_pallas=False, device=dev)(l, r)
    got = [torch.as_tensor(d, device=dev)[None, :, :, None]
           for d in frames[0]["disparities"]]
    failures = []
    report["infer_forward"] = [
        dict(stage=s + 1, **compare(f"cli.infer frame 0 (finetuned "
                                    f"weights) stage {s + 1}", t, a, b,
                                    "bfloat16", (1, H, W, 1), failures))
        for s, (t, a, b) in enumerate(zip(truth, plain, got))]
    require(not failures, "; ".join(failures))
    del model, state, truth, plain, got
    shutil.rmtree(out)
    report["infer"] = dict(
        launches=counts, forwards=forwards,
        frames=[dict(name=f["name"], forward_ms=f["seconds"] * 1e3,
                     host_ms=f["host_seconds"] * 1e3) for f in frames])
    report["seconds"] = time.time() - t0
    print(f"[9] recipe phase: {report['seconds']:.1f} s")
    return report


# Phase 10: the tools. Each engine as `tools.parity` options.
PARITY_ARGS = {"mxu": ["--rows_dw", "mxu"],
               "vpu-paired": ["--rows_dw", "vpu"],
               "vpu-unpaired": ["--rows_dw", "vpu", "--unpaired"],
               "chain": ["--rows_dw", "chain"],
               "layers": ["--pallas_mode", "layers"]}
OVERFIT_MINI = ["--regimes", "kitti_mask", "--pairs", "8", "--epochs", "1",
                "--tail-epochs", "1", "--tail-seg-epochs", "1", "--batch",
                "4", "--tail-batch", "4"]
DIAG_MINI = ["--configs", "f32", "primed", "--steps", "8", "--pairs", "4",
             "--batch", "2"]


def tools_phase(dev, smi, tmp, phase5_ms=None):
    """Phase 10: the tools of `lwsnet_tpu_torch.tools` on the card, in
    process, with their JSON under chiprun_out/tools/: (a) `parity
    --fixture` under every engine in float32 and bf16 on each of the
    fixture's sets, the "mxu" launch counts; (b) `parity_kernels` on the trained
    weights; (c) `profile_forward --trace` with its four stage ranges,
    each enclosing a launch of the port's kernels; (d)
    `golden_pair_inference` on phase 9's finetuned checkpoint; (e) the
    two microbenches; (f) `aot_warm`; (g) `scaling_sweep --devices 1`
    under NCCL; (h) a miniature `overfit_proof` and `cpu_truth_eval` on
    its best checkpoint. `phase5_ms`: phase 5's 4-stage "mxu" median,
    printed beside profile_forward's. Returns the phase's report."""
    import torch
    from lwsnet_tpu_torch.data.png import write_png
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.tools import (aot_warm, cpu_truth_eval,
                                        golden_pair_inference, microbench_3d,
                                        microbench_refine, overfit_diag,
                                        overfit_proof, parity,
                                        parity_kernels, profile_forward,
                                        scaling_sweep)
    t0 = time.time()
    out = os.path.join("chiprun_out", "tools")
    os.makedirs(out, exist_ok=True)
    report = {}

    # (a) both paths against the JAX fixture
    build.reset_launch_counts()
    zero = build.launch_counts()
    report["parity"] = {}
    for engine, args in PARITY_ARGS.items():
        for dtype in ("float32", "bfloat16"):
            res = parity.main(
                ["--fixture", parity.FIXTURE, "--dtype", dtype, *args,
                 "--out", os.path.join(out, f"parity_{engine}_{dtype}.json")])
            report["parity"][f"{engine} {dtype}"] = res["sets"]
            for name, st in res["sets"].items():
                for row in st["stages"]:
                    k, m = row["kernels"], row["module"]
                    failed = [b for b, ok in row["bars"].items()
                              if ok is False]
                    unheld = [b for b, ok in row["bars"].items()
                              if ok is None]
                    print(f"[10a] {engine} {dtype} {name} stage "
                          f"{row['stage']}: fixture span "
                          f"{row['fixture_span']:.3f} px (guard "
                          f"{row['span_guard_px']:.1f}), mean |delta| "
                          f"(bar {row['mean_bar_pct']:g} %) "
                          f"kernels {k['mean_delta_pct_of_span']:.4f} % "
                          f"(max {k['max_abs_delta']:.4g} px), module "
                          f"{m['mean_delta_pct_of_span']:.4f} % (max "
                          f"{m['max_abs_delta']:.4g} px)"
                          + (f"; not applied: {unheld}" if unheld else "")
                          + (f"; FAILED {failed}" if failed else ""))
                if engine == "mxu":
                    print(f"[10a] mxu {dtype} {name} launches: "
                          f"{st['launches']}")
                    if dtype == "bfloat16":
                        require(st["launches"] == want_counts("mxu", zero),
                                f"parity {name}: launches {st['launches']}")
            require(res["pass"], f"parity --fixture {engine} {dtype} failed")

    # (b) the kernel families where parity is well-posed
    res = parity_kernels.main(
        ["--ckpt", os.path.join(os.path.dirname(parity.FIXTURE),
                                parity.WEIGHTS) + ":trained",
         "--out", os.path.join(out, "parity_kernels.json")])
    for c in res["checks"]:
        print(f"[10b] {c['check']} {c['dtype']}: mean |delta| "
              f"{c['mean_delta_pct_of_span']:.4f} % of span {c['span']:.3f} "
              f"(bar {c['bar_pct']:g} %)")
    require(res["pass"], "parity_kernels failed")
    report["parity_kernels"] = res["checks"]

    # (c) per-stage and per-component times, and the trace's ranges
    prof = profile_forward.main(["--trace", out])
    ranges = prof["trace"]["ranges"]
    require(set(profile_forward.STAGE_RANGES) <= set(ranges),
            f"trace ranges {sorted(ranges)}")
    for rng_name, kernel in (("stage1", "conv3d_bn_relu"),
                             ("stage4_refinement", "dense3x3")):
        require(any(KERNEL_NAMES[kernel] in n for n in ranges[rng_name]),
                f"trace: no {kernel} launch inside {rng_name}: "
                f"{ranges[rng_name]}")
    inc = prof["forward_ms"]["kernels"]
    print(f"[10c] profile_forward ({smi}): kernel path per-stage "
          f"increments {[round(inc[k]['increment_ms'], 3) for k in inc]} ms "
          f"sum {sum(r['increment_ms'] for r in inc.values()):.3f} ms; "
          f"phase 5's 4-stage median "
          f"{'not measured' if phase5_ms is None else f'{phase5_ms:.3f} ms'}")
    report["profile_forward"] = prof

    # (d) golden-pair inference on phase 9's finetuned checkpoint
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (TRAIN_H, TRAIN_W, 3), dtype=np.uint8)
    pair = [os.path.join(tmp, f"golden_{s}.png") for s in ("l", "r")]
    for path, arr in zip(pair, (img, np.roll(img, -17, axis=1))):
        write_png(path, arr, compress_level=1)
    pngs = os.path.join(tmp, "golden_out")
    build.reset_launch_counts()
    res = golden_pair_inference.main(
        ["--ckpt", os.path.join(tmp, "finetuned"), "--left", pair[0],
         "--right", pair[1], "--out", pngs])
    torch.cuda.synchronize()
    counts = build.launch_counts()
    want = {k: 2 * n for k, n in want_counts("mxu", zero).items()}
    require(res["ok"] and sorted(os.listdir(pngs)) ==
            [f"{s}.png" for s in range(1, 5)], f"golden pair: {res}")
    require(counts == want, f"golden pair launches {counts} != {want}")
    print(f"[10d] golden_pair_inference: 4 finite stages, 4 PNGs, forward "
          f"{res['seconds'] * 1e3:.3f} ms, launches {counts} ({smi})")
    report["golden_pair"] = dict(res, launches=counts)

    # (e) the microbenches, their equivalence checks first
    report["microbench_refine"] = microbench_refine.main([])
    report["microbench_3d"] = microbench_3d.main([])

    # (f) the ahead-of-time build
    res = aot_warm.main([])
    require(set(res["libraries"]) == set(build.SOURCES),
            f"aot_warm named {sorted(res['libraries'])}")
    report["aot_warm"] = res

    # (g) the data-parallel sweep at one process under NCCL
    res = scaling_sweep.main(["--devices", "1", "--iters", "3", "--out",
                              os.path.join(out, "scaling_sweep.json")])
    require(len(res["points"]) == 1
            and np.isfinite(res["points"][0]["step_ms"]),
            f"scaling_sweep: {res['points']}")
    print(f"[10g] scaling_sweep --devices 1: step "
          f"{res['points'][0]['step_ms']:.3f} ms, "
          f"{res['points'][0]['frames_per_s']:.2f} frames/s ({smi})")
    report["scaling_sweep"] = res

    # (h) the overfit proof in miniature, and its CPU float32 truth
    src = os.path.join(tmp, "overfit_source.png")
    write_png(src, rng.integers(0, 256, (TRAIN_H, TRAIN_W, 3),
                                dtype=np.uint8), compress_level=1)
    work = os.path.join(tmp, "overfit")
    res = overfit_proof.main(OVERFIT_MINI + [
        "--source", src, "--workdir", work,
        "--out", os.path.join(out, "overfit_proof.json")])
    run = res["runs"][0]
    require(all(run[k] is not None for k in ("final_epe_px", "best_epe_px",
                                             "first_loss", "last_loss")),
            f"overfit_proof: {run}")
    truth = cpu_truth_eval.main(
        ["--ckpt", run["best_ckpt"], "--workdir", work, "--pairs", "8",
         "--device", "cpu", "--out", os.path.join(out, "cpu_truth_eval.json")])
    require(np.isfinite(truth["cpu_f32_stage4_epe_px"]),
            f"cpu_truth_eval: {truth}")
    print(f"[10h] overfit_proof (miniature): {run['steps']} steps, EPE "
          f"{run['initial_epe_px']} -> best {run['best_epe_px']}, final "
          f"{run['final_epe_px']} px; cpu_truth_eval stage-4 EPE "
          f"{truth['cpu_f32_stage4_epe_px']} px over 8 pairs")
    report["overfit_proof"] = dict(run=run, truth=truth)

    # (i) the overfit microscope in miniature
    t1 = time.time()
    runs = overfit_diag.main(DIAG_MINI + [
        "--source", src, "--out", os.path.join(out, "overfit_diag.json")])
    for res in runs:
        nums = [v for k, v in res.items() if k != "milestones"
                and isinstance(v, (int, float))] + [
            x for k in ("loss_last_10", "final_stage_losses",
                        "step_stage_recheck") for x in res[k]]
        require(all(np.isfinite(x) for x in nums),
                f"overfit_diag {res['config']}: {res}")
        print(f"[10i] overfit_diag {res['config']}: loss {res['first_loss']}"
              f" -> {res['last_loss']} in {res['steps']} steps "
              f"({res['wall_s']} s), max grad norm {res['max_gnorm']}, "
              f"stage-4 EPE eval {res['final_epe_eval']} / train "
              f"{res['final_epe_train']} / restat {res['epe_eval_restat']}"
              f" px, recheck {res['step_loss_recheck']}")
    print(f"[10i] overfit_diag: {time.time() - t1:.1f} s ({smi})")
    report["overfit_diag"] = runs
    report["seconds"] = time.time() - t0
    print(f"[10] tools phase: {report['seconds']:.1f} s")
    return report


# Phase 11: row sharding, two processes on the one card.
SHARD_STEP = (2, 256, 512)  # the train step: batch, height, width


def row_shard_phase(smi, tmp):
    """Phase 11: `tools.dryrun_ddp.layout_child` with its float32 step
    and eval, in this process without a process group, then as 1 x 2 row
    shards spawned on the one card under gloo (NCCL refuses two
    processes on one device), the two held against the one by
    `dryrun_ddp.layout_failures`. Returns the phase's report."""
    from lwsnet_tpu_torch.tools import dryrun_ddp
    t0 = time.time()
    work = os.path.join(tmp, "shards")
    os.makedirs(work, exist_ok=True)
    b, h, w = SHARD_STEP
    halo, n_bn = dryrun_ddp.write_layout_weights(work)
    dryrun_ddp.write_layout_data(os.path.join(work, "batch.npz"), b, (h, w),
                                 (H, W))
    dryrun_ddp.layout_child(0, 1, work, "batch", "cuda:0", timed=True,
                            float32=True)
    t1 = time.time()
    dryrun_ddp.spawn(dryrun_ddp.layout_child, 2,
                     (work, "batch", "cuda:0", True, False, True), 300.0,
                     work, device="cuda:0", spatial=2, backend="gloo")
    print(f"[11] one process {t1 - t0:.1f} s, two row shards on the card "
          f"{time.time() - t1:.1f} s")
    one = dryrun_ddp.layout_records(work, "batch", 1)[0]
    two = dryrun_ddp.layout_records(work, "batch", 2)
    require([(r["rows"], r["eval_rows"]) for r in two]
            == [((0, h // 2), (0, H // 2)), ((h // 2, h), (H // 2, H))],
            f"row shards {[(r['rows'], r['eval_rows']) for r in two]}")
    rd, fails = dryrun_ddp.layout_failures(two, one, halo, n_bn)
    r32 = rd["float32"]
    print(f"[11a] 1 x 2 row shards vs one process, train step at batch "
          f"{b}, {h}x{w} (TF32 off, deterministic): float32 loss rel "
          f"{r32['loss_rel']:.3g}, grad_norm rel {r32['grad_norm_rel']:.3g},"
          f" BN statistics {r32['stats']:.3g} of the bar, least tensor "
          f"cosine {r32['min_cosine']:.9f}; float64 loss rel "
          f"{rd['loss_rel']:.3g}, grad_norm rel {rd['grad_norm_rel']:.3g}, "
          f"BN statistics {rd['stats']:.3g} of the bar, least tensor cosine "
          f"1 - {1 - rd['min_cosine']:.3g} ({rd['least_tensor']}), "
          f"{rd['tensors_under']} tensors under 0.9999")
    print(f"[11b] eval step at {H}x{W} (batch {b}, {H // 2} rows a shard): "
          f"float64 EPE / D1 gaps {rd['eval_gaps']}, weight {rd['weight']};"
          f" float32 gaps {r32['eval_gaps']}, weight {r32['weight']}; "
          f"collectives {rd['counts']}")
    med = [statistics.median(r["bf16"]["ms"]) for r in two + [one]]
    peak = [r["bf16"]["peak_bytes"] / 2 ** 30 for r in two + [one]]
    print(f"[11c] bf16 train step, batch {b} at {h}x{w} ({smi}): 1 x 2 row "
          f"shards {med[0]:.3f} / {med[1]:.3f} ms median of 5 (max "
          f"{max(two[0]['bf16']['ms']):.3f}), one process {med[2]:.3f} ms; "
          f"peak memory {peak[0]:.3f} / {peak[1]:.3f} GiB a shard, one "
          f"process {peak[2]:.3f} GiB ({peak[0] / peak[2]:.3f} of it); "
          f"after {dryrun_ddp.LAYOUT_BF16_STEPS} bf16 steps the shards "
          f"differ by {rd['bf16_max_diff']}")
    require(not fails, f"row shards: {fails}")
    rd.update(bf16_ms=med, peak_gib=peak, halo=halo,
              seconds=time.time() - t0)
    print(f"[11] row sharding phase: {rd['seconds']:.1f} s")
    return rd


# Detail keys of the bench that a run with BENCH_BUDGET_S=120 must hold.
BENCH_KEYS = ("stage1_fps", "stage2_fps", "stage3_fps", "stage4_fps",
              "per_stage_monotonicity", "stage4_fps_no_pallas",
              "train_step_ms_256x512_b8", "train_step_ms_256x512_b4",
              "pretrain_projection_h", "pretrain_projection_vs_baseline",
              "finetune_projection_h", "finetune_projection_vs_baseline",
              "mfu_pct", "card")


def bench_phase(smi, phase5_ms=None):
    """Phase 12: `python -m lwsnet_tpu_torch.tools.bench` in a process of
    its own with BENCH_BUDGET_S=120: its last line, a complete detail
    (chiprun_out/bench_detail.json) with no skipped or low-budget step,
    and its launch counts (the headline forward's `want_counts("mxu")`,
    none on the module path or in a train step). `phase5_ms`: phase 5's
    4-stage "mxu" median, printed beside the bench's 4-stage time.
    Returns the phase's report."""
    import subprocess
    import torch
    from lwsnet_tpu_torch.ops.cuda import build
    t0 = time.time()
    path = os.path.join("chiprun_out", "bench_detail.json")
    if os.path.exists(path):
        os.remove(path)
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, "-m", "lwsnet_tpu_torch.tools.bench", "--detail",
         path], env=dict(os.environ, BENCH_BUDGET_S="120"),
        capture_output=True, text=True, timeout=420)
    require(proc.returncode == 0, f"bench exited {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    require(sorted(last) == ["metric", "unit", "value", "vs_baseline"]
            and last["metric"] == "torch_4stage_inference_fps_368x1232"
            and np.isfinite(last["value"]) and last["value"] > 0,
            f"bench's last line: {last}")
    with open(path) as f:
        detail = json.load(f)
    missing = [k for k in BENCH_KEYS if k not in detail]
    require(not missing, f"bench detail lacks {missing}")
    short = [k for k in detail if k.endswith(("_skipped", "_note"))]
    require(not short, f"bench at 120 s: {short}")
    require(detail["card"] == smi, f"bench card {detail['card']!r}")
    zero = build.launch_counts()
    want = want_counts("mxu", zero)
    require(detail["launches_4stage_forward"] == want,
            f"bench headline launches {detail['launches_4stage_forward']} "
            f"!= {want}")
    for what in ("launches_module_forward", "launches_train_step_b8",
                 "launches_train_step_b4"):
        require(not any(detail[what].values()),
                f"bench {what}: {detail[what]}")
    ms = detail["stage_ms"]["4"]
    busy = detail.get("stage4_device_busy_ms")
    print(f"[12] bench: {last}; stages 1-4 "
          f"{[detail[f'stage{k}_fps'] for k in (1, 2, 3, 4)]} frames/s, "
          f"monotonicity {detail['per_stage_monotonicity']}, module path "
          f"{detail['stage4_fps_no_pallas']} frames/s, MFU "
          f"{detail['mfu_pct']} %, train steps "
          f"{detail['train_step_ms_256x512_b8']} / "
          f"{detail['train_step_ms_256x512_b4']} ms (b8 / b4), build "
          f"{detail['build_s']:.1f} s, elapsed {detail['elapsed_s']} s "
          f"({smi})")
    print(f"[12] bench 4-stage {ms:.3f} ms a frame (host-paced loop) "
          f"beside phase 5's median "
          f"{'not measured' if phase5_ms is None else f'{phase5_ms:.3f}'} "
          f"ms; device busy {busy}")
    report = dict(line=last, detail=detail, seconds=time.time() - t0)
    print(f"[12] bench phase: {report['seconds']:.1f} s")
    return report


# Phase 13: data x spatial training on 2 and 4 cards under NCCL.
# (data, spatial) layouts, one process a card; those of more processes
# than cards visible are not run.
MULTI_LAYOUTS = ((2, 1), (1, 2), (4, 1), (2, 2), (1, 4))
MULTI_STEP_HW = (256, 512)  # phase 11's train step
MULTI_PROFILED = ((4, 1), (2, 2))
MULTI_TIMEOUT = 240.0       # each layout's processes, start-up included


def multicard_batch(dp, sp):
    """Phase 11's global batch (2), or 4 for the layouts of 4 processes
    with more than one data slice."""
    return 4 if dp * sp == 4 and dp > 1 else 2


def checkpoint_eval(ckpt, sf_root, batch, dev):
    """The SceneFlow eval of `ckpt` in this process alone, as the pretrain
    CLI evaluates (its default model flags, eval batch `batch` at
    SF_EVAL, EPE with the 4-row offset): the EPE it returns."""
    import logging
    from lwsnet_tpu_torch.cli import common, pretrain
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.data.pipeline import StereoPipeline
    from lwsnet_tpu_torch.data.sceneflow import index_sceneflow
    from lwsnet_tpu_torch.training.loop import Trainer, TrainerConfig
    _, test_idx = index_sceneflow(sf_root)
    pipe = StereoPipeline(test_idx, batch, training=False, crop=SF_EVAL,
                          kitti=False, num_workers=2)
    model = common.model_config(pretrain.build_parser().parse_args([]))
    t = Trainer(TrainerConfig(model=model, train=TrainConfig(
        mask_max_disp=192.0, save_path=ckpt), eval_metric="epe",
        sceneflow_row_offset=4), pipe, pipe,
        logging.getLogger("chip_smoke"), device=dev)
    t.init_state(0)
    require(t.resume(), f"no checkpoint to restore in {ckpt}")
    return t.evaluate()


def multicard_layouts(smi, work, cards, report, failures):
    """Phase 13 (a)-(c), (f): each layout of MULTI_LAYOUTS that the cards
    hold, its processes spawned one a card under NCCL
    (`tools.dryrun_ddp.layout_child`), held against the one process on
    card 0 (`dryrun_ddp.layout_failures`); stops at the first layout
    whose processes hang, and then returns False."""
    import torch
    from lwsnet_tpu_torch.tools import dryrun_ddp
    halo, n_bn = dryrun_ddp.write_layout_weights(work)
    layouts = [(dp, sp) for dp, sp in MULTI_LAYOUTS if dp * sp <= cards]
    singles = {}
    for b in sorted({multicard_batch(*lay) for lay in layouts}):
        dryrun_ddp.write_layout_data(os.path.join(work, f"b{b}.npz"), b,
                                     MULTI_STEP_HW, (H, W))
        dryrun_ddp.layout_child(0, 1, work, f"b{b}", "cuda", timed=True)
        singles[b] = dryrun_ddp.layout_records(work, f"b{b}", 1)[0]
        torch.cuda.empty_cache()
        one = singles[b]["bf16"]
        print(f"[13] one process on card 0, batch {b}: bf16 step "
              f"{statistics.median(one['ms']):.3f} ms median of 5 (max "
              f"{max(one['ms']):.3f}), peak memory "
              f"{one['peak_bytes'] / 2 ** 30:.3f} GiB ({smi})")
    for dp, sp in layouts:
        world, b = dp * sp, multicard_batch(dp, sp)
        what = f"{dp} x {sp}"
        t0 = time.time()
        try:
            dryrun_ddp.spawn(dryrun_ddp.layout_child, world,
                             (work, f"b{b}", "cuda", True,
                              (dp, sp) in MULTI_PROFILED),
                             MULTI_TIMEOUT, work, device="cuda", spatial=sp)
        except TimeoutError as e:
            failures.append(f"{what}: {e}")
            print(f"[13] {what}: {e}; the remaining layouts not run")
            return False
        except RuntimeError as e:
            failures.append(f"{what}: {e}")
            print(f"[13] {what}: {e}")
            continue
        records = dryrun_ddp.layout_records(work, f"b{b}", world)
        readings, fails = dryrun_ddp.layout_failures(records, singles[b],
                                                     halo, n_bn)
        failures.extend(f"{what}: {f}" for f in fails)
        med = [statistics.median(r["bf16"]["ms"]) for r in records]
        peak = [r["bf16"]["peak_bytes"] / 2 ** 30 for r in records]
        one = singles[b]["bf16"]
        readings.update(seconds=time.time() - t0, batch=b, bf16_ms=med,
                        peak_gib=peak, rows=[r["rows"] for r in records],
                        single_ms=statistics.median(one["ms"]),
                        single_peak_gib=one["peak_bytes"] / 2 ** 30)
        print(f"[13a] {what}, batch {b} at {MULTI_STEP_HW[0]}x"
              f"{MULTI_STEP_HW[1]}, rows {readings['rows']}, float64 step "
              f"vs one process: loss rel {readings['loss_rel']:.3g}, "
              f"grad_norm rel {readings['grad_norm_rel']:.3g}, BN statistics "
              f"{readings['stats']:.3g} of the bar, least tensor cosine 1 - "
              f"{1 - readings['min_cosine']:.3g} ({readings['least_tensor']})"
              f", {readings['tensors_under']} tensors under 0.9999; eval at "
              f"{H}x{W}: EPE / D1 gaps {readings['eval_gaps']}, weight "
              f"{readings['weight']}")
        print(f"[13b] {what}: collectives {readings['counts']}")
        print(f"[13c] {what}: after {dryrun_ddp.LAYOUT_BF16_STEPS} bf16 "
              f"steps the processes' parameters and statistics differ by "
              f"{readings['bf16_max_diff']}; bf16 step "
              f"{', '.join(f'{m:.3f}' for m in med)} ms a process (median "
              f"of 5), one process {readings['single_ms']:.3f} ms; peak "
              f"memory {', '.join(f'{p:.3f}' for p in peak)} GiB a process, "
              f"one process {readings['single_peak_gib']:.3f} GiB ({smi}); "
              f"{readings['seconds']:.1f} s; "
              f"{'ok' if not fails else 'FAILED: ' + '; '.join(fails)}")
        prof = records[0].get("profile")
        if prof is not None:
            readings["profile"] = prof
            print(f"[13f] {what} profiler window on rank 0, 3 bf16 steps: "
                  f"host clock {prof['wall_ms']:.3f} ms a step, device busy "
                  f"{prof['busy_ms']:.3f} ms "
                  f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %), NCCL "
                  f"kernels {prof['nccl_ms']:.3f} ms "
                  f"({prof['nccl_kernels']:.0f} a step; all-gather "
                  f"{prof['all_gather_ms']:.3f}, "
                  f"all-reduce {prof['all_reduce_ms']:.3f}), other kernels "
                  f"{prof['other_ms']:.3f} ms")
        report[what] = readings
    return True


def torchrun(n, module, args):
    """`torchrun --standalone --nproc_per_node=n -m module args` (through
    `python -m torch.distributed.run`): (seconds, the process's result);
    fails unless it exits 0."""
    import subprocess
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", module] + args
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=420)
    require(proc.returncode == 0, f"torchrun {module} exited "
            f"{proc.returncode}: {proc.stderr[-4000:]}")
    return time.time() - t0, proc


def multicard_clis(smi, tmp, cards, report):
    """Phase 13 (d): `cli.pretrain` under torchrun on `cards` processes
    (4, or 2 with two or three cards visible) for one epoch on phase 9's
    SceneFlow corpus, per-process batch 8 / cards, eval batch 2: exactly
    one checkpoint, and its EPE (the checkpoint's metadata, from the
    reduced eval sums) equal to this process's eval of that checkpoint
    at the same per-process batch (rel 1e-5); then `cli.finetune
    --pretrained` from it under torchrun for one epoch on phase 8's KITTI
    corpus (per-process batch 4 / cards): one checkpoint, a D1 in [0, 1]."""
    import torch
    sf = os.path.join(tmp, "sceneflow")
    write_sceneflow_corpus(sf)
    n = 4 if cards >= 4 else 2
    out = os.path.join(tmp, f"pretrained_{n}cards")
    took, _ = torchrun(n, "lwsnet_tpu_torch.cli.pretrain", [
        "--datapath", sf, "--epoch", "1",
        "--train_batch_size", str(8 // n), "--test_batch_size", "2",
        "--crop_height", str(TRAIN_CROP[0]),
        "--crop_width", str(TRAIN_CROP[1]),
        "--eval_height", str(SF_EVAL[0]), "--eval_width", str(SF_EVAL[1]),
        "--save_path", out, "--num_workers", "2"])
    files = sorted(os.listdir(out))
    require(files == ["checkpoint", "checkpoint.meta.json"],
            f"torchrun pretrain wrote {files}")
    with open(os.path.join(out, "checkpoint.meta.json")) as f:
        meta = json.load(f)
    torch.cuda.empty_cache()
    epe = checkpoint_eval(out, sf, 2, torch.device("cuda", 0))
    rel = abs(epe / meta["error"] - 1.0)
    print(f"[13d] torchrun --standalone --nproc_per_node={n} cli.pretrain, "
          f"one epoch ({SF_TRAIN} frames, batch {8 // n} a process, bf16, "
          f"{took:.1f} s): one checkpoint, {files}; its EPE "
          f"{meta['error']:.9g} from {n} processes, {epe:.9g} from one "
          f"process (rel {rel:.3g}; bar 1e-5) ({smi})")
    require(rel <= 1e-5, f"pretrain on {n} cards: EPE {meta['error']} vs "
            f"one process's {epe}")
    report["pretrain"] = dict(processes=n, seconds=took, epe=meta["error"],
                              single_epe=epe, rel=rel)
    kitti = os.path.join(tmp, "training")
    split = write_kitti_corpus(kitti)
    ft = os.path.join(tmp, f"finetuned_{n}cards")
    took, _ = torchrun(n, "lwsnet_tpu_torch.cli.finetune", [
        "--datapath", kitti, "--val_set", split, "--pretrained", out,
        "--epoch", "1", "--train_batch_size", str(4 // n),
        "--test_batch_size", "2", "--crop_height", str(TRAIN_CROP[0]),
        "--crop_width", str(TRAIN_CROP[1]), "--eval_height", str(H),
        "--eval_width", str(W), "--save_path", ft, "--num_workers", "2"])
    files = sorted(os.listdir(ft))
    with open(os.path.join(ft, "checkpoint.meta.json")) as f:
        d1 = json.load(f)["error"]
    print(f"[13d] torchrun --standalone --nproc_per_node={n} cli.finetune "
          f"--pretrained, one epoch ({TRAIN_FRAMES} frames, batch {4 // n} "
          f"a process, {took:.1f} s): {files}, D1 {d1:.6f}")
    require(files == ["checkpoint", "checkpoint.meta.json"]
            and 0.0 <= d1 <= 1.0, f"torchrun finetune: {files}, D1 {d1}")
    report["finetune"] = dict(processes=n, seconds=took, d1=d1)


def multicard_sweeps(smi, cards, report):
    """Phase 13 (e): `tools.scaling_sweep --devices 1 2 4` at 256x512,
    bf16, per-card batch 4 (weak) and global batch 8 (strong, the
    pretrain recipe's), each point a finite step time."""
    from lwsnet_tpu_torch.tools import scaling_sweep
    want = [n for n in (1, 2, 4) if n <= cards]
    for mode, extra in (("weak", []), ("strong", ["--global-batch", "8"])):
        res = scaling_sweep.main(
            ["--devices", "1", "2", "4", "--iters", "5", "--out",
             os.path.join("chiprun_out", f"scaling_sweep_{mode}.json")]
            + extra)
        pts = res["points"]
        require([p["devices"] for p in pts] == want and all(
            np.isfinite(p["step_ms"]) and p["step_ms"] > 0 for p in pts),
            f"scaling_sweep {mode}: {pts}")
        print(f"[13e] scaling_sweep {mode}: " + ", ".join(
            f"{p['devices']} card(s) {p['step_ms']:.3f} ms "
            f"{p['frames_per_s']:.1f} frames/s" for p in pts)
            + f"; efficiency {res['efficiency_pct']} % ({smi})")
        report[f"sweep_{mode}"] = res


def multicard_phase(smi, tmp, only=False):
    """Phase 13: data x spatial training on the cards under NCCL, one
    process a card. Not run with fewer than 2 cards visible (with `only`,
    fewer than 4 fail). Returns the phase's report."""
    import torch
    cards = torch.cuda.device_count()
    if only:
        require(cards >= 4, f"--only multicard needs 4 cards; "
                f"torch.cuda.device_count() = {cards}")
    if cards < 2:
        print(f"[13] multi-card phase: {cards} card visible, needs 2 or "
              f"more: not run")
        return {"cards": cards, "run": False}
    t0 = time.time()
    report = {"cards": cards, "run": True,
              "names": [torch.cuda.get_device_name(i) for i in range(cards)]}
    print(f"[13] multi-card phase: {cards} cards, {report['names']}; NCCL "
          f"{torch.cuda.nccl.version()}")
    failures = []
    work = os.path.join(tmp, "multicard")
    os.makedirs(work, exist_ok=True)
    hung = not multicard_layouts(smi, work, cards, report, failures)
    for what, piece in () if hung else (
            ("clis", lambda: multicard_clis(smi, tmp, cards, report)),
            ("scaling_sweep", lambda: multicard_sweeps(smi, cards, report))):
        try:
            piece()
        except Exception as e:  # every piece runs; the phase fails below
            failures.append(f"{what}: {e!r}")
            print(f"[13] {what} FAILED: {e!r}")
    report.update(failures=failures, seconds=time.time() - t0)
    print(f"[13] multi-card phase: {report['seconds']:.1f} s, "
          f"{len(failures)} failure(s)")
    require(not failures, f"multi-card phase: {failures}")
    return report


def main(argv=None):
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", choices=("multicard",),
        help="multicard: phases 1 and 13 alone, which need 4 cards")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import lwsnet_tpu_torch  # noqa: F401  (fails outside the repository)
    from lwsnet_tpu_torch import InferenceEngine, LWSNet, ModelConfig
    from lwsnet_tpu_torch import make_forward
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.ops.cuda import costfilter as CF
    from lwsnet_tpu_torch.tools import microbench_rows
    from lwsnet_tpu_torch.utils.timing import card, event_ms, event_times

    dev = torch.device("cuda")
    report = {}
    t_start = time.time()
    os.makedirs("chiprun_out", exist_ok=True)

    # 1. the card
    smi = card()
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {smi}")
    print(f"[1] torch.cuda.get_device_name(0): {name}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[1] cards visible: torch.cuda.device_count() = "
          f"{torch.cuda.device_count()}")
    report["card"] = smi
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[1] TF32 off for cuDNN and matmul: float32 checks and yardsticks "
          "run in full float32")
    if args.only == "multicard":
        os.makedirs("build", exist_ok=True)
        with tempfile.TemporaryDirectory(dir="build") as tmp:
            report["multicard"] = multicard_phase(smi, tmp, only=True)
        report["seconds"] = time.time() - t_start
        with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(f"card: {smi}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    # 2. build
    t0 = time.time()
    logs = build.build_all()
    print(f"[2] kernels built in {time.time() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "wgmma", "setmaxnreg",
                                       "warning")):
                print(f"[2] {src}: {line.strip()}")

    cfg = ModelConfig()
    calls = main_path_calls(cfg) + variant_calls(cfg) + layers_calls(cfg)

    # 3. kernels against their plain versions
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (kernel, label, p, _, _) in enumerate(calls + ragged_calls()):
            rng = np.random.default_rng(1000 + i)
            c = make_call(kernel, p, dtype, rng, dev)
            build.reset_launch_counts()
            got = c["kernel"]()
            made = dict(build.LAYOUT_COPIES)
            routes = build.route_counts()
            want = c["plain"]()
            torch.cuda.synchronize()
            what = f"{kernel} [{label}] {str(dtype)[6:]}"
            err, span = check_close(got, want, dtype, what)
            narrow = None
            if kernel == "dense3x3":
                route = dense_route(p, dtype)
                narrow = route if route in ("entry", "output") else None
                require(routes == ({f"dense3x3[{narrow}]": 1} if narrow
                                   else {}),
                        f"{what}: route launches {routes}, want {route}")
            if kernel == "conv3d_bn_relu":
                require(routes == ({"conv3d_bn_relu[entry]": 1}
                                   if p.get("entry") else {}),
                        f"{what}: route launches {routes}")
            if dtype == torch.bfloat16 and narrow and p.get("f32_out"):
                require(((got - want).abs()
                         <= 2e-4 + 1e-3 * want.abs()).all().item(),
                        f"{what}: beyond atol 2e-4 / rtol 1e-3")
            elif dtype == torch.bfloat16 and (
                    kernel in ("chain3x3", "conv3d_skip_softargmin")
                    or (kernel == "conv3d_bn_relu"
                        and (p["Co"] == 8 or p.get("entry")))
                    or narrow):
                two_steps(got, want, what)
            if kernel == "conv3d_skip_softargmin":
                # bf16 reads channels-last (its tensor-core route), float32
                # NCDHW (the CUDA-core kernel): one counted copy otherwise
                bf = dtype == torch.bfloat16
                require(CF.skip_tensor_core_route(dtype, p["Ci"]) == bf,
                        f"{what}: route rule")
                cl = bool(p.get("cl"))
                require(made == {"to channels-last": int(bf and not cl),
                                 "to contiguous": int(cl and not bf)},
                        f"{what}: layout copies {made}")
            checks.setdefault(kernel, {})[(label, str(dtype)[6:])] = err
            print(f"[3] ok {what}: max |delta| {err:.3g}, span {span:.4g}")
            del c, got, want

    # 4. the whole forward under each engine, kernels vs module path
    report["forward"], counts, copies, routes = forward_phase(dev)
    report["layout_copies"] = copies
    report["narrow_route_launches"] = routes
    # 4b. every launch against its module layer, before any timing
    build.reset_launch_counts()
    layers = layer_phase(dev, build.launch_counts())
    report["layer_check_seconds"] = layers["seconds"]

    # 5. the inference engine: 4 seeded requests, num_stages 1..4, under the
    # shipped engine; one request and the 4-stage latency under each other
    model = LWSNet(cfg, device="cpu", seed=0)
    jitter_batchnorm(model, np.random.default_rng(3))
    state = model.state_dict()
    del model
    latency, profiled = {}, {}
    for engine, fields in ENGINES.items():
        eng = InferenceEngine(ModelConfig(**fields), state, device=dev)
        for req in range(4 if engine == "mxu" else 1):
            rng = np.random.default_rng(100 + req)
            l_img = rng.uniform(0, 1, (375, 1242, 3)).astype(np.float32)
            r_img = rng.uniform(0, 1, (375, 1242, 3)).astype(np.float32)
            l, r = eng.preprocess(l_img, r_img)
            full = eng(l, r, num_stages=4)
            for stages in (1, 2, 3, 4):
                outs = eng(l, r, num_stages=stages)
                require(len(outs) == stages, "stage count")
                for s, o in enumerate(outs):
                    require(o.shape == (1, H, W) and np.isfinite(o).all(),
                            f"{engine} request {req} stages {stages}: "
                            f"stage {s + 1}")
                    span = float(full[s].max() - full[s].min()) + 1.0
                    require(np.abs(o - full[s]).mean() < 1e-3 * span,
                            f"{engine} request {req}: stages={stages} is "
                            f"not a prefix")
        print(f"[5] {engine}: InferenceEngine answered "
              f"{4 if engine == 'mxu' else 1} request(s) at num_stages 1..4")
        l, r = eng.preprocess(l_img, r_img)
        for stages in ((1, 2, 3, 4) if engine == "mxu" else (4,)):
            fwd = make_forward(eng.model, num_stages=stages, device=dev)
            kt = event_times(lambda: fwd(l, r))
            row = dict(kernels_ms=statistics.median(kt),
                       kernels_max_ms=kt[-1], samples=len(kt))
            msg = (f"[5] {engine} num_stages={stages}: kernel path median "
                   f"{row['kernels_ms']:.3f} ms (max {kt[-1]:.3f})")
            if engine == "mxu":
                plain = make_forward(eng.model, num_stages=stages,
                                     use_pallas=False, device=dev)
                pt = event_times(lambda: plain(l, r))
                row.update(plain_ms=statistics.median(pt),
                           plain_max_ms=pt[-1])
                msg += (f", module path median {row['plain_ms']:.3f} ms "
                        f"(max {pt[-1]:.3f})")
            latency.setdefault(engine, {})[stages] = row
            print(f"{msg} over {len(kt)} 368x1232 bf16 batch-1 forwards "
                  f"({smi})")
        if engine in PROFILED:
            profiled[engine] = (make_forward(eng.model, num_stages=4,
                                             device=dev), l, r)
        del eng
    report["latency_ms"] = latency
    # The profiler windows come after every latency: forwards timed after
    # one read slower (PERF.md, PR 2).
    report["profile_4_stages"] = {}
    for engine, (fwd, l, r) in profiled.items():
        prof = device_profile(lambda: fwd(l, r))
        report["profile_4_stages"][engine] = prof
        if prof is None:
            print(f"[5] {engine} device busy share: not measured (the "
                  f"profiler recorded no device activity)")
            continue
        print(f"[5] profiled 4-stage {engine} kernel forward: host clock "
              f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} "
              f"ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %), of "
              f"which the port's kernels {prof['port_kernels_ms']:.3f} ms "
              f"and other kernels {prof['other_kernels_ms']:.3f} ms")
        for n, t in prof["top_other"]:
            print(f"[5]   other kernel {t:.3f} ms: {n}")
    del profiled

    # 6. kernel times at the paths' shapes; totals per (kernel, engine)
    per_shape = []
    totals = {}
    for i, (kernel, label, p, n, engine) in enumerate(calls):
        rng = np.random.default_rng(2000 + i)
        c = make_call(kernel, p, torch.bfloat16, rng, dev)
        t_bytes = c["bytes"] / PEAK_BYTES * 1e3
        t_ops = c["ops"] / PEAK_BF16 * 1e3
        row = dict(kernel=kernel, label=label, engine=engine, launches=n,
                   route=(dense_route(p, torch.bfloat16)
                          if kernel == "dense3x3" else
                          "entry" if p.get("entry") else None),
                   ms=event_ms(c["kernel"]), host_us=host_us(c["kernel"]),
                   plain_ms=event_ms(c["plain"]),
                   library_ms=(None if c["library"] is None
                               else event_ms(c["library"])),
                   library_nchw_ms=(None if c["library_nchw"] is None
                                    else event_ms(c["library_nchw"])),
                   layers_cudnn_ms=(None if c["layers"] is None
                                    else event_ms(c["layers"])),
                   bytes=c["bytes"], operations=c["ops"],
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        del c
        per_shape.append(row)
        tot = totals.setdefault((kernel, engine), dict(
            launches=0, ms=0.0, plain_ms=0.0, library_ms=0.0,
            layers_cudnn_ms=0.0, bytes_ms=0.0, ops_ms=0.0, bound_ms=0.0))
        tot["launches"] += n
        for k in ("ms", "plain_ms", "bound_ms"):
            tot[k] += n * row[k]
        for k in ("library_ms", "layers_cudnn_ms"):
            if row[k] is None or tot[k] is None:
                tot[k] = None
            else:
                tot[k] += n * row[k]
        tot["bytes_ms" if row["bound_by"] == "bytes" else "ops_ms"] += \
            n * row["bound_ms"]
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        if row["library_nchw_ms"] is not None:
            lib += f" (on NCHW copies {row['library_nchw_ms']:.4f} ms)"
        layers = ("" if row["layers_cudnn_ms"] is None else
                  f", per-layer cuDNN sum {row['layers_cudnn_ms']:.4f} ms")
        route = "" if row["route"] is None else f" ({row['route']} route)"
        print(f"[6] {kernel} [{label}]{route} x{n}: {row['ms']:.4f} ms (host "
              f"{row['host_us']:.1f} us a call), plain "
              f"{row['plain_ms']:.4f} ms, cuDNN {lib}{layers}, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    report["per_shape"] = per_shape
    for (kernel, engine), tot in totals.items():
        lib = [f"{tot[k]:.4f}" if tot[k] is not None else "none"
               for k in ("library_ms", "layers_cudnn_ms")]
        print(f"[6] per forward: {kernel} under {engine}, {tot['launches']} "
              f"launches: {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} "
              f"ms, cuDNN {lib[0]} (per-layer sum {lib[1]}), bound "
              f"{tot['bound_ms']:.4f} ms")
    report["totals"] = {f"{k} under {e}": tot
                        for (k, e), tot in totals.items()}
    print("[6] layout copies: none remains on any path (phase 4: "
          "WANT_COPIES), so none is timed")
    # 7. the rows microbench, whose probe is the one launch of
    # lane_broadcast on a user's path
    build.reset_launch_counts()
    bench = microbench_rows.main(
        ["--json", os.path.join("chiprun_out", "microbench_rows.json")])
    torch.cuda.synchronize()
    counts["microbench"] = build.launch_counts()
    require(bench["probe"] == "OK", "microbench probe did not print OK")
    require(counts["microbench"]["lane_broadcast"] >= 1,
            "the microbench launched no lane_broadcast")
    print(f"[7] microbench_rows: probe OK, lane_broadcast launched "
          f"{counts['microbench']['lane_broadcast']} time(s)")
    report["microbench_rows"] = bench
    report["launch_counts"] = counts
    floor = launch_floor(dev)
    report["launch_floor_us"] = floor
    for what, st in floor.items():
        print(f"[7] {what}: {st['count']} kernels in its profiler windows, "
              f"device us each: median {st['median']:.3f}, p10 "
              f"{st['p10']:.3f}, p90 {st['p90']:.3f}, min {st['min']:.3f}, "
              f"max {st['max']:.3f}")

    # 6, continued: the kernels alone on the device, from the profiler,
    # after every event timing (phase 7's too), since timings taken after a
    # profiler window read slower (PERF.md, PR 2).
    for i, (row, (kernel, label, p, _, _)) in enumerate(zip(per_shape,
                                                           calls)):
        c = make_call(kernel, p, torch.bfloat16,
                      np.random.default_rng(2000 + i), dev)
        row["device_ms"] = kernel_device_ms(c["kernel"], KERNEL_NAMES[kernel])
        row["library_device_ms"] = (None if c["library"] is None else
                                    kernel_device_ms(c["library"], ""))
        row["layers_device_ms"] = (None if c["layers"] is None else
                                   kernel_device_ms(c["layers"], ""))
        del c
        dev_ms = ("not measured" if row["device_ms"] is None
                  else f"{row['device_ms']:.4f} ms")
        lib = ("" if row["library_device_ms"] is None else
               f", the cuDNN call {row['library_device_ms']:.4f} ms")
        if row["layers_device_ms"] is not None:
            lib += (f", the per-layer cuDNN calls "
                    f"{row['layers_device_ms']:.4f} ms")
        print(f"[6] {kernel} [{label}]: kernel alone on the device {dev_ms}"
              f"{lib} (events around the call {row['ms']:.4f} ms)")
        if kernel == "chain3x3":
            row["mxu_device_ms"] = kernel_device_ms(
                make_call(kernel, p, torch.bfloat16,
                          np.random.default_rng(2000 + i), dev)["mxu"],
                KERNEL_NAMES["dense3x3"])
            yard, mxu = (("not measured" if v is None else f"{v:.4f} ms")
                         for v in (row["layers_device_ms"],
                                   row["mxu_device_ms"]))
            print(f"[6] {kernel} [{label}] on the device: kernel {dev_ms}, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"per-layer cuDNN on the same channels-last input {yard}, "
                  f"the same layers as \"mxu\" dense3x3 launches {mxu}, "
                  f"wrapper host {row['host_us']:.1f} us a call")
        if kernel.startswith("dwsep"):
            yard = (row["library_device_ms"] if row["layers_device_ms"] is None
                    else row["layers_device_ms"])
            per = "" if row["layers_device_ms"] is None else ", per layer,"
            print(f"[6] {kernel} [{label}] on the device: kernel {dev_ms}, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"cuDNN over the composed rank-1 kernel{per} on the same "
                  f"channels-last input "
                  f"{'not measured' if yard is None else f'{yard:.4f} ms'}, "
                  f"wrapper host {row['host_us']:.1f} us a call")

    for (kernel, engine), tot in totals.items():
        rows = [(r["device_ms"], r["launches"]) for r in per_shape
                if (r["kernel"], r["engine"]) == (kernel, engine)]
        tot["device_ms"] = (None if any(t is None for t, _ in rows)
                            else sum(t * n for t, n in rows))
        if tot["device_ms"] is not None:
            print(f"[6] per forward: {kernel} under {engine} alone on the "
                  f"device {tot['device_ms']:.4f} ms (events "
                  f"{tot['ms']:.4f} ms)")

    # 8. training on the card; 9. the recipe through the three CLIs;
    # 10. the tools, phase 9's finetuned checkpoint among their inputs
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        report["training"] = training_phase(dev, smi, tmp)
        report["recipe"] = recipe_phase(dev, smi, tmp)
        report["tools"] = tools_phase(dev, smi, tmp,
                                      latency["mxu"][4]["kernels_ms"])
        report["row_shards"] = row_shard_phase(smi, tmp)
    # 12. the port's bench, in a process of its own
    report["bench"] = bench_phase(smi, latency["mxu"][4]["kernels_ms"])
    # 13. data x spatial training on 2 and 4 cards, where they are visible
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        report["multicard"] = multicard_phase(smi, tmp)

    line = []
    for k in build.KERNELS:
        engine = ENGINE_OF[k.name]
        tot = totals[(k.name, engine)]
        launches = counts[engine][k.name]
        require(launches > 0, f"{k.name}: launched no time under {engine}")
        line.append(dict(
            name=k.name, route="cuda", source=k.source,
            replaces=REPLACES[k.name], launches=launches,
            max_abs_err=max(v for (_, d), v in checks[k.name].items()
                            if d == "bfloat16"),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                      else "operations"),
            library_ms=tot["library_ms"]))
    report["kernels"] = line
    report["seconds"] = time.time() - t_start
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"[6] per forward under each kernel's engine (ms are launches x "
          f"per-launch time; bound from {PEAK_BF16 / 1e12:.0f} TFLOP/s bf16 "
          f"and {PEAK_BYTES / 1e12:.2f} TB/s); {report['seconds']:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
