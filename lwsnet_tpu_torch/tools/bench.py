"""Headline benchmark of the port: 4-stage inference frames/s on the
368x1232 KITTI eval window, batch 1, on one card.

The counterpart of the JAX package's root `bench.py`, step for step:

  1. the headline first: the shipped `ModelConfig()` (bf16,
     `pallas_mode="rows"`, `rows_dw="mxu"`), `LWSNet(cfg, seed=0)`, inputs
     drawn as `bench.py` draws them, `make_forward(model, num_stages=4)`;
  2. MFU from the analytic conv FLOP count (`utils/flops.py`) against the
     card's dense bf16 peak (`PEAK_FLOPS`, keyed by
     `torch.cuda.get_device_name(0)`; a card missing from it gets no
     `mfu_pct`);
  3. frames/s at stages 1-3: under 60 s of budget left a cheap estimate
     (one run of 16 calls), under 20 s skipped;
  4. the monotonicity check: the k-stage forward contains the (k-1)-stage
     one, so a faster stage k is a bad sample. Violating pairs are
     measured again with a longer loop, the whole sweep twice at most (a
     re-measured stage k-1 can break the pair below it), and violations
     are recorded from the final times, never failed on;
  5. the module path (`use_pallas=False`) at 4 stages;
  6. the train step at both recipe shapes, 256x512 at batch 8 (pretrain:
     10 x (35454 // 8) steps against 18.0 h) and batch 4 (finetune: 300 x
     (160 // 4) steps against 2.8 h), with hour projections;
  7. last, after every timing (a timing taken after a profiler window
     reads slower), one torch.profiler window over the 4-stage kernel
     forward: its device busy time and idle share.

    python -m lwsnet_tpu_torch.tools.bench [--detail PATH]

**Timing.** Frames/s and the train step come from `utils.timing.
device_time`: N back-to-back calls between one pair of CUDA events, the
best of 3 runs, N sized so that a run lasts at least 0.25 s. JAX loops the
forward inside one compiled program; here each call is launched from the
host, and the forward is host-bound (the device idles most of the time),
so the reading is the pace of host and device together, not device time.
The train step also waits on the host every step (its finite check and
the clip's norm). The profiler window gives the device-only figure. No
CUDA graph is captured.

**Budget.** `BENCH_BUDGET_S` (default 480) seconds from the start of the
process, the kernel build (`ops/cuda/build.build_all`, recorded as
`build_s`) included. `BENCH_SKIP_TRAIN=1` skips the train steps.

**Kernels.** The detail records the launch counters
(`ops/cuda/build.launch_counts()`, set to 0 just before each run) of one
4-stage headline forward, one module-path forward and one train step of
each recipe: the module path and the train step launch none.

Runs on the card only: without one it raises (`device.resolve_device`);
it has no CPU option and catches no exception. The detail goes to its
own JSON file (default `chiprun_out/bench_detail.json`, never the JAX
bench's `BENCH_DETAIL.json`); the last line printed is one JSON object,
{"metric", "value", "unit", "vs_baseline"}, under a metric name of its
own, `torch_4stage_inference_fps_368x1232`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

BASELINE_FPS = 10.0  # Titan Xp, all 4 stages (reference README.md:136)
# Training wall-time baselines (reference README.md:90-105): ~18 h for the
# 10-epoch SceneFlow pretrain at batch 8, ~2.8 h for the 300-epoch KITTI
# finetune at batch 4.
BASELINE_PRETRAIN_H = 18.0
BASELINE_FINETUNE_H = 2.8
METRIC = "torch_4stage_inference_fps_368x1232"
H, W, BATCH = 368, 1232, 1
TRAIN_H, TRAIN_W = 256, 512
# (recipe, batch, steps over the recipe, baseline hours)
RECIPES = (
    # 10 epochs x (35,454 SceneFlow train pairs // 8)
    ("pretrain", 8, 10 * (35454 // 8), BASELINE_PRETRAIN_H),
    # 300 epochs x (160 KITTI train frames // 4)
    ("finetune", 4, 300 * (160 // 4), BASELINE_FINETUNE_H),
)
# Dense bf16 tensor-core FLOP/s per card, for the MFU estimate.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM, data sheet
}
DETAIL = os.path.join("chiprun_out", "bench_detail.json")
MIN_LOOP_S = 0.25   # a timed run lasts at least this long
CHEAP_ITERS = 16    # the low-budget estimate: one run of this many calls
FLOP_ACCOUNTING = (
    "conv MACs*2 only; elementwise/resize/soft-argmin and the one-hot "
    "warp matmul excluded (see lwsnet_tpu_torch/utils/flops.py)")
METHODS = {
    "fps": "utils.timing.device_time: N back-to-back calls between one "
           "pair of CUDA events, best of 3 runs, N sized to a run of at "
           f"least {MIN_LOOP_S} s (cheap: one run of {CHEAP_ITERS}); "
           "host-paced, since the forward is host-bound: not device time",
    "train_step_ms": "as fps, over back-to-back train steps, each of "
                     "which waits on the host (finite check, clip norm)",
    "stage4_device_busy_ms": "torch.profiler: the union of the kernel "
                             "intervals of 5 4-stage kernel forwards, a "
                             "forward; idle share = 1 - busy / host clock",
}

_T0 = time.monotonic()

# timer(fn, iters, repeats) -> seconds a call of fn()
Timer = Callable[[Callable[[], object], int, int], float]


class Budget:
    """Seconds left of `seconds`, counted from `start` on `clock`."""

    def __init__(self, seconds: float, start: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.seconds, self.clock = seconds, clock
        self.start = clock() if start is None else start

    def remaining(self) -> float:
        return self.seconds - (self.clock() - self.start)


def event_timer(fn: Callable[[], object], iters: int, repeats: int
                ) -> float:
    from lwsnet_tpu_torch.utils.timing import device_time
    return device_time(fn, iters=iters, repeats=repeats)


def measure(fn, timer: Timer, min_loop_s: float = MIN_LOOP_S,
            cheap: bool = False) -> float:
    """Seconds a call of fn(): a 10-call probe sizes the loop so that a
    run lasts at least `min_loop_s`, which keeps the 3 ms stage-1 forward
    from drowning in per-run noise; `cheap` takes one run of CHEAP_ITERS
    calls instead, the low-budget estimate."""
    if cheap:
        return timer(fn, CHEAP_ITERS, 1)
    sec = timer(fn, 10, 3)
    if sec * 10 < min_loop_s:
        sec = timer(fn, math.ceil(min_loop_s / sec), 3)
    return sec


def inputs(rng: np.random.Generator, batch: int = BATCH, h: int = H,
           w: int = W) -> Tuple[np.ndarray, np.ndarray]:
    """The left and right images, float32 NHWC, drawn in that order."""
    return tuple(rng.standard_normal((batch, h, w, 3)).astype(np.float32)
                 for _ in range(2))


def train_inputs(rng: np.random.Generator, batch: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A train batch at 256x512: left, right and ground truth in 1-100."""
    left, right = inputs(rng, batch, TRAIN_H, TRAIN_W)
    gt = rng.uniform(1.0, 100.0, (batch, TRAIN_H, TRAIN_W))
    return left, right, gt.astype(np.float32)


def time_forwards(forward: Callable[[int], Callable], timer: Timer,
                  budget: Budget, detail: Dict, flops: float,
                  peak: Optional[float]) -> Dict[int, float]:
    """Steps 1-4: the 4-stage headline, its MFU, stages 1-3 and the
    monotonicity fixed point, into `detail`. `forward(k)` is the k-stage
    call. Returns {stages: seconds a frame}."""
    stage_sec = {4: measure(forward(4), timer) / BATCH}

    def headline():
        detail["stage4_fps"] = round(1.0 / stage_sec[4], 2)
        if peak:
            detail["mfu_pct"] = round(100.0 * flops / stage_sec[4] / peak,
                                      3)

    headline()

    def measure_stage(k, min_loop_s=MIN_LOOP_S):
        cheap = budget.remaining() < 60
        stage_sec[k] = measure(forward(k), timer, min_loop_s, cheap) / BATCH
        detail[f"stage{k}_fps"] = round(1.0 / stage_sec[k], 2)
        if cheap:
            detail[f"stage{k}_note"] = "single-loop low-budget estimate"
        else:
            detail.pop(f"stage{k}_note", None)

    for k in (1, 2, 3):
        if budget.remaining() < 20:  # never risk losing the headline
            detail[f"stage{k}_skipped"] = "under 20s of budget left"
            continue
        measure_stage(k)

    def violations():
        return [k for k in (2, 3, 4)
                if k in stage_sec and (k - 1) in stage_sec
                and stage_sec[k] < stage_sec[k - 1]]

    for _ in range(2):
        bad = violations()
        if not bad or budget.remaining() < 90:
            break
        for k in sorted({j for k in bad for j in (k - 1, k)}):
            measure_stage(k, min_loop_s=2 * MIN_LOOP_S)
    bad = [f"stage{k} faster than stage{k - 1}" for k in violations()]
    detail["per_stage_monotonicity"] = bad if bad else "ok"
    detail["stage_ms"] = {k: stage_sec[k] * 1e3 for k in sorted(stage_sec)}
    headline()  # after any re-measurement of stage 4
    return stage_sec


def time_module_path(forward: Callable, timer: Timer, budget: Budget,
                     detail: Dict) -> None:
    """Step 5: the module path at 4 stages, `forward` its call."""
    if budget.remaining() <= 20:
        detail["module_path_skipped"] = "under 20s of budget left"
        return
    cheap = budget.remaining() < 60
    sec = measure(forward, timer, cheap=cheap) / BATCH
    detail["stage4_fps_no_pallas"] = round(1.0 / sec, 2)
    detail["stage4_no_pallas_ms"] = sec * 1e3
    if cheap:
        detail["stage4_no_pallas_note"] = "single-loop low-budget estimate"


def time_train(make_step: Callable[[int], Callable], timer: Timer,
               budget: Budget, detail: Dict) -> None:
    """Step 6: the train step of each recipe; `make_step(batch)` returns
    the call of one step on a batch of that size."""
    if os.environ.get("BENCH_SKIP_TRAIN") == "1" or budget.remaining() <= 25:
        detail["train_step_skipped"] = "budget or BENCH_SKIP_TRAIN"
        return
    for name, batch, steps_total, base_h in RECIPES:
        if budget.remaining() < 25:
            detail[f"{name}_step_skipped"] = "under 25s of budget left"
            continue
        cheap = budget.remaining() < 70
        sec = measure(make_step(batch), timer, cheap=cheap)
        detail[f"train_step_ms_{TRAIN_H}x{TRAIN_W}_b{batch}"] = round(
            sec * 1e3, 3)
        if cheap:
            detail[f"{name}_step_note"] = "single-loop low-budget estimate"
        # Data loading overlaps compute (host threads), so the projection
        # is steps x step time.
        hours = steps_total * sec / 3600
        detail[f"{name}_projection_h"] = round(hours, 2)
        detail[f"{name}_projection_vs_baseline"] = round(base_h / hours, 1)


def main(argv: Optional[List[str]] = None,
         timer: Timer = event_timer) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--detail", default=DETAIL,
                   help=f"where the detail JSON goes (default {DETAIL})")
    args = p.parse_args(argv)
    budget = Budget(float(os.environ.get("BENCH_BUDGET_S", "480")), _T0)

    import torch

    from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.device import resolve_device
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step
    from lwsnet_tpu_torch.utils import timing
    from lwsnet_tpu_torch.utils.flops import forward_flops

    dev = resolve_device("cuda")
    t0 = time.monotonic()
    build.build_all()
    build_s = time.monotonic() - t0
    cfg = ModelConfig()
    name = torch.cuda.get_device_name(0)
    detail: Dict = {
        "input": f"{H}x{W}", "batch": BATCH, "device": name,
        "card": timing.card(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "compute_dtype": cfg.compute_dtype,
        "use_pallas": cfg.use_pallas, "pallas_mode": cfg.pallas_mode,
        "rows_dw": cfg.rows_dw, "budget_s": budget.seconds,
        "build_s": build_s, "methods": METHODS}

    def launches(fn) -> Dict[str, int]:
        build.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return build.launch_counts()

    model = LWSNet(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    left, right = (torch.from_numpy(a).to(dev) for a in inputs(rng))

    def forward(k: int, kernels: bool = True) -> Callable:
        fwd = make_forward(model, num_stages=k, use_pallas=kernels,
                           device=dev)
        return lambda: fwd(left, right)

    detail["launches_4stage_forward"] = launches(forward(4))
    flops = forward_flops(cfg, H, W, batch=BATCH, num_stages=4)
    detail["model_gflops_analytic"] = round(flops / 1e9, 2)
    detail["flop_accounting"] = FLOP_ACCOUNTING
    stage_sec = time_forwards(forward, timer, budget, detail, flops,
                              PEAK_FLOPS.get(name))
    module = forward(4, kernels=False)
    detail["launches_module_forward"] = launches(module)
    time_module_path(module, timer, budget, detail)
    del model, module
    torch.cuda.empty_cache()

    tcfg = TrainConfig(mask_max_disp=192.0)
    state = None
    step = make_train_step(tcfg, 1000)

    def make_step(batch: int) -> Callable:
        nonlocal state
        if state is None:
            state = create_train_state(cfg, tcfg, seed=0, device=dev)
        tl, tr, tg = (torch.from_numpy(a).to(dev)
                      for a in train_inputs(rng, batch))

        def run():
            return step(state, tl, tr, tg)

        detail[f"launches_train_step_b{batch}"] = launches(run)
        return run

    time_train(make_step, timer, budget, detail)
    del state, make_step
    torch.cuda.empty_cache()

    fwd4 = make_forward(LWSNet(cfg, device=dev, seed=0), num_stages=4,
                        device=dev)
    wall_ms, spans = timing.profile_window(lambda: fwd4(left, right))
    if spans:
        busy = timing.busy_ms(spans, 5)
        detail.update(stage4_device_busy_ms=busy,
                      stage4_profiled_ms=wall_ms,
                      stage4_device_idle_pct=100.0 * (1.0 - busy / wall_ms))
    else:
        detail["stage4_device_busy_ms"] = (
            "not measured: the profiler recorded no device activity")

    detail["headline_mode"] = cfg.pallas_mode
    detail["elapsed_s"] = round(time.monotonic() - budget.start, 1)
    os.makedirs(os.path.dirname(os.path.abspath(args.detail)), exist_ok=True)
    with open(args.detail, "w") as f:
        json.dump(detail, f, indent=1, sort_keys=True)
    fps = 1.0 / stage_sec[4]
    line = {"metric": METRIC, "value": round(fps, 2), "unit": "frames/s",
            "vs_baseline": round(fps / BASELINE_FPS, 3)}
    print(json.dumps(line))
    return dict(line=line, detail=detail)


if __name__ == "__main__":
    main()
