"""Trainability proof: overfit a synthetic stereo set through the `Trainer`.

Counterpart of the JAX package's `examples/overfit_proof.py`, with its
options, recipe, JSON and PASS rule. It builds `--pairs` stereo pairs with
exactly known ground truth from a source image (`synth_pair`: a
left-coordinate disparity field inverted to synthesize the right view),
then runs the port's `Trainer.fit` (pipeline -> train step -> eval -> best
checkpoint) under both loss-mask regimes (pretrain gt < 192, finetune
gt > 0) until the network overfits the set:

  phase A: batch-mode BN at --lr with exact precise-BN before every eval,
           best-only selection;
  phase B: frozen BN in --tail-dtype as rollback segments, each from the
           best checkpoint so far with a fresh optimizer and a one-epoch
           warmup, on a ladder that doubles the lr after an improving
           segment and halves it after a dud; the last segment at a
           quarter of the surviving lr.

The JAX tool's comments give the measured failures behind each choice.
PASS: every regime ends below 1 px EPE with final - best < 0.3 px.

    python -m lwsnet_tpu_torch.tools.overfit_proof --source PNG \
        [--epochs 8] [--out results/OVERFIT_PROOF.json] [--device cuda]

`--source` names the image the strips are cut from, any RGB PNG of at
least 256x560 (the JAX tool reads the reference's golden left image,
which is not in the repository). `--matmul-precision highest` (the
default) turns TF32 off for cuDNN and matmuls, the card's counterpart of
JAX's "highest". Runs on the card (raises without one)
unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

H, W = 256, 512  # the reference's train crop (reference: dataloader.py:61)
MARGIN = 48      # right-view sampling margin beyond the left crop


def synth_pair(strip: np.ndarray, rng: np.random.Generator,
               amp: float = 3.0):
    """Given a source strip (h, w + MARGIN, 3) float in [0, 1], synthesize a
    smooth strictly-positive LEFT-coordinate disparity field d and the
    views left = strip[:, :w] and right with right[y, x - d(y, x)] =
    left[y, x], the stereo convention the network's warp implements.
    Returns (left, right, disp) float32.

    The JAX tool's function, draw for draw and operation for operation:
    from the same strip and generator state it gives the same arrays bit
    for bit. (h, w) come from the strip, the JAX tool's module constants
    H, W where it is 256 x (512 + MARGIN). The strip is textured with
    rng noise so that matching is identifiable at every pixel; the field
    is a base level in [18, 28) plus sinusoids of amplitude < `amp`, so
    it stays within (0, MARGIN) and every right-view sample lands inside
    the strip; each right pixel u samples the strip at the fixed point of
    x = u + d(y, x) (contraction ~0.05, 30 iterations)."""
    h, w = strip.shape[0], strip.shape[1] - MARGIN
    noise = rng.random((strip.shape[0], strip.shape[1], 3)).astype(np.float32)
    noise = (noise + np.roll(noise, 1, 0) + np.roll(noise, 1, 1)) / 3.0
    strip = np.clip(0.6 * strip + 0.4 * noise, 0.0, 1.0)
    left = np.ascontiguousarray(strip[:, :w])
    a = rng.uniform(18, 28)
    b, c = rng.uniform(0, amp), rng.uniform(0, amp)
    p1, p2 = rng.uniform(0, 6), rng.uniform(0, 6)
    ys = np.linspace(0, 3, h, dtype=np.float32)[:, None]

    def dfield(x):
        """The analytic disparity field at (possibly fractional) left
        x-coordinates; (h, w) in, (h, w) out."""
        return (a + b * np.sin(ys + p1)
                + c * np.cos(3.0 * x / (w - 1) + p2)).astype(np.float32)

    u = np.broadcast_to(np.arange(w, dtype=np.float32), (h, w))
    x = u + 25.0
    for _ in range(30):
        x = u + dfield(x)

    i0 = np.floor(x).astype(np.int64)
    i1 = np.minimum(i0 + 1, w + MARGIN - 1)
    w1 = (x - np.floor(x)).astype(np.float32)[..., None]
    rows = np.arange(h)[:, None]
    right = strip[rows, i0] * (1 - w1) + strip[rows, i1] * w1
    disp = dfield(u)  # GT at left coordinates: exact by construction
    return left, right.astype(np.float32), disp


def write_corpus(src: np.ndarray, pairs: int, workdir: str):
    """`pairs` random (H, W + MARGIN) strips of `src` through `synth_pair`
    (one generator, seed 0, as the JAX tool draws them), written as
    l_i.png / r_i.png (8-bit) and d_i.png (uint16 = disp * 256) under
    `workdir`. Returns the `StereoIndex`."""
    from lwsnet_tpu_torch.data.kitti2015 import StereoIndex
    from lwsnet_tpu_torch.data.png import write_png

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(0)
    lefts, rights, disps = [], [], []
    for i in range(pairs):
        y0 = int(rng.integers(0, src.shape[0] - H + 1))
        x0 = int(rng.integers(0, src.shape[1] - W - MARGIN + 1))
        strip = src[y0:y0 + H, x0:x0 + W + MARGIN]
        left, right, disp = synth_pair(strip, rng)
        lp, rp, dp = (os.path.join(workdir, f"{k}_{i}.png")
                      for k in ("l", "r", "d"))
        write_png(lp, (left * 255).astype(np.uint8))
        write_png(rp, (right * 255).astype(np.uint8))
        write_png(dp, (disp * 256).astype(np.uint16))
        lefts.append(lp)
        rights.append(rp)
        disps.append(dp)
    return StereoIndex(lefts, rights, disps)


def run_regime(name: str, index, args, mask_kwargs: Dict,
               workdir: str) -> Dict:
    """Phase A then phase B (the module docstring) under one loss-mask
    regime; returns the JAX tool's result dict (curves, final and best
    EPE)."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.data.pipeline import StereoPipeline
    from lwsnet_tpu_torch.training.loop import Trainer, TrainerConfig

    def make_trainer(bn_mode, lr, epochs, dtype, batch, save_dir,
                     warmup=0):
        # Eval batches cover the corpus in as few forwards as possible;
        # the metric sums are validity-weighted, so the math is the same.
        eval_batch = min(2 * batch, args.pairs)
        tcfg = TrainConfig(lr=lr, epochs=epochs, train_batch_size=batch,
                           eval_batch_size=eval_batch, lr_gamma=0.25,
                           warmup_steps=warmup, bn_mode=bn_mode,
                           # exact precise-BN before every phase-A eval;
                           # the frozen tail keeps its statistics pinned
                           bn_reestimate_batches=(
                               args.pairs // args.batch
                               if bn_mode == "batch" else 0),
                           bn_reestimate_exact=True, save_path=save_dir,
                           log_every=10, **mask_kwargs)
        train_pipe = StereoPipeline(index, batch, training=True,
                                    crop=(H, W), kitti=True, num_workers=4)
        eval_pipe = StereoPipeline(index, eval_batch, training=False,
                                   crop=(H, W), kitti=True, num_workers=4)
        # training=False: fixed order and identity crops, so the exact
        # statistics are a function of the parameters alone.
        stat_pipe = StereoPipeline(index, args.batch, training=False,
                                   crop=(H, W), kitti=True, num_workers=4)
        return Trainer(
            TrainerConfig(model=ModelConfig(compute_dtype=dtype),
                          train=tcfg, eval_metric="epe"),
            train_pipe, eval_pipe, logging.getLogger(f"overfit.{name}"),
            stat_pipe=stat_pipe, device=args.device)

    losses: List[float] = []
    skipped: List[int] = []

    def spy_on(t):
        orig = t.train_step

        def spy(state, l, r, g):
            state, aux = orig(state, l, r, g)
            losses.append(float(aux["loss"]))
            if float(aux["finite"]) == 0.0:
                skipped.append(len(losses) - 1)
            return state, aux

        t.train_step = spy

    # Phase A: batch-mode BN with per-epoch precise-BN at constant lr.
    dir_a = os.path.join(workdir, f"ckpt_{name}_a")
    trainer = make_trainer("batch", args.lr, args.epochs, args.dtype,
                           args.batch, dir_a)
    trainer.init_state()
    epe0 = trainer.evaluate()  # random-init EPE for contrast
    spy_on(trainer)
    t0 = time.time()
    trainer.fit(args.epochs)
    phase_a_best = trainer.best_error
    best, best_dir = phase_a_best, dir_a

    # Phase B: frozen-BN rollback segments on the adaptive lr ladder.
    seg_len = max(1, args.tail_seg_epochs)
    n_segs = max(1, args.tail_epochs // seg_len)
    lr_scale = args.tail_lr_scale
    seg_bests, seg_lrs = [], []
    final_epe = float("inf")
    for k in range(n_segs):
        pin = k == n_segs - 1
        scale = lr_scale / 4 if pin else lr_scale
        dir_k = os.path.join(workdir, f"ckpt_{name}_b{k}")
        tb = make_trainer("frozen", args.lr * scale, seg_len,
                          args.tail_dtype, args.tail_batch, dir_k,
                          warmup=args.pairs // args.tail_batch)
        tb.init_state()
        if not tb.load_pretrained(best_dir):
            raise RuntimeError(f"no checkpoint in {best_dir}")
        tb.best_error = math.inf  # qualify under this segment's eval
        spy_on(tb)
        final_epe = tb.fit(seg_len)
        seg_bests.append(tb.best_error)
        seg_lrs.append(args.lr * scale)
        if tb.best_error < best:
            best, best_dir = tb.best_error, dir_k
            lr_scale = min(lr_scale * 2, args.tail_lr_scale_max)
        else:
            lr_scale *= 0.5
    phase_b_best = min(seg_bests)
    wall = time.time() - t0

    def num(x):
        """Rounded, None for a non-finite value (not valid JSON)."""
        x = float(x)
        return round(x, 3) if np.isfinite(x) else None

    return {
        "mask_regime": name,
        "epochs": args.epochs,
        "tail_epochs": args.tail_epochs,
        "phase_a_best_epe_px": num(phase_a_best),
        "tail_segment_bests_epe_px": [num(x) for x in seg_bests],
        "tail_segment_lrs": [round(x, 8) for x in seg_lrs],
        "steps": len(losses),
        "nonfinite_steps_skipped": skipped,
        "initial_epe_px": num(epe0),
        "final_epe_px": num(final_epe),
        # final vs the phase-B best: both frozen-BN evals of the same tail
        "best_epe_px": num(phase_b_best),
        "best_ckpt": best_dir,
        "first_loss": num(losses[0]),
        "last_loss": num(losses[-1]),
        "loss_curve_every_20": [num(x) for x in losses[::20]],
        "train_wall_s": round(wall, 1),
    }


def passed(runs: List[Dict]) -> bool:
    """The JAX tool's PASS rule: every regime below 1 px EPE at the end,
    within 0.3 px of its best."""
    return all(r["final_epe_px"] is not None and r["best_epe_px"] is not None
               and r["final_epe_px"] < 1.0
               and r["final_epe_px"] - r["best_epe_px"] < 0.3
               for r in runs)


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--tail-epochs", type=int, default=60,
                   help="total frozen-tail epochs, split into adaptive "
                        "rollback segments")
    p.add_argument("--tail-seg-epochs", type=int, default=5,
                   help="epochs per rollback segment")
    p.add_argument("--tail-dtype", type=str, default="float32",
                   help="phase-B compute dtype")
    p.add_argument("--tail-batch", type=int, default=4, help="phase-B batch")
    p.add_argument("--pairs", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1.5e-3)
    p.add_argument("--tail-lr-scale", type=float, default=0.05,
                   help="first frozen segment's lr as a fraction of --lr; "
                        "doubled after improving segments, halved after "
                        "duds")
    p.add_argument("--tail-lr-scale-max", type=float, default=0.2,
                   help="ladder ceiling")
    p.add_argument("--dtype", type=str, default="float32")
    p.add_argument("--matmul-precision", type=str, default="highest",
                   choices=["default", "highest"],
                   help="'highest' turns TF32 off for cuDNN and matmuls")
    p.add_argument("--regimes", nargs="*",
                   default=["kitti_mask", "sceneflow_mask"])
    p.add_argument("--out", type=str,
                   default="results/OVERFIT_PROOF.json")
    p.add_argument("--workdir", type=str, default="results/overfit_proof")
    p.add_argument("--source", type=str, required=True,
                   help="RGB PNG the strips are cut from")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch

    from lwsnet_tpu_torch.data import transforms as T
    from lwsnet_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.matmul_precision == "highest":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    index = write_corpus(T.load_image(args.source), args.pairs,
                         args.workdir)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    # Both loss-mask regimes (reference: train.py:137 masks gt < maxdisp
    # for SceneFlow pretrain; finetune.py:153 masks gt > 0 for KITTI).
    regimes = {"kitti_mask": dict(mask_min_disp=0.0),
               "sceneflow_mask": dict(mask_max_disp=192.0)}
    runs = []
    for name in args.regimes:
        runs.append(run_regime(name, index, args, regimes[name],
                               args.workdir))
        # kept after every regime, so a later failure keeps the earlier
        with open(args.out + ".partial", "w") as f:
            json.dump(runs, f, indent=1, allow_nan=False)

    n_segs = max(1, args.tail_epochs // args.tail_seg_epochs)
    result = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "pairs": args.pairs,
        "batch": args.batch,
        "recipe": (f"phase A: batch-mode BN + per-epoch precise-BN, "
                   f"{args.dtype}, batch {args.batch}, lr {args.lr:g}, "
                   f"{args.epochs} epochs, best-only selection; phase B: "
                   f"frozen-BN adaptive rollback-anneal — {n_segs} "
                   f"segments of {args.tail_seg_epochs} epochs, each from "
                   f"the best checkpoint so far with a FRESH optimizer, "
                   f"{args.tail_dtype}, batch {args.tail_batch}, lr "
                   f"starting at {args.lr * args.tail_lr_scale:g}, doubled "
                   f"after improving segments (cap "
                   f"{args.lr * args.tail_lr_scale_max:g}), halved after "
                   f"duds; final segment at a quarter of the surviving lr"),
        "runs": runs,
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1, allow_nan=False)
    print(json.dumps(result, allow_nan=False))
    ok = passed(runs)
    print("OVERFIT PROOF:", "PASS" if ok else "FAIL")
    result["pass"] = ok
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
