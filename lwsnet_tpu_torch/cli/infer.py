"""Batch / single-pair inference entry point of the port (reference:
inference.py).

    # batch mode over a KITTI testing dir:
    python -m lwsnet_tpu_torch.cli.infer \
        --img_path dataset/kitti2015/testing/ --model results/finetune \
        [--device cuda]

    # single pair (expects a sibling right_test.png, like the reference):
    python -m lwsnet_tpu_torch.cli.infer --left_img reference/left_test.png \
        --model results/finetune

`--model` is a checkpoint directory of the port (`cli.pretrain`,
`cli.finetune`); `--random_weights` runs seeded random weights instead.
The forward is `InferenceEngine`'s: on the card, the Hopper kernels
(`--no_pallas`: the plain module path). Every stage of every frame is
saved as a JET-colormapped PNG: `<name>_stage<s>.png` in batch mode,
`<s>.png` for a single pair. Logs go to ./log/.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List


def build_parser() -> argparse.ArgumentParser:
    from lwsnet_tpu_torch.cli import common

    p = argparse.ArgumentParser(description="Model inference")
    p.add_argument("--img_path", type=str,
                   default="dataset/kitti2015/testing/")
    p.add_argument("--left_img", type=str, default="")
    p.add_argument("--model", type=str, default="results/finetune",
                   help="checkpoint directory")
    p.add_argument("--save_path", type=str, default="results/inference")
    p.add_argument("--random_weights", action="store_true")
    p.add_argument("--eval_height", type=int, default=368,
                   help="inference window (bottom-right crop, reference: "
                        "inference.py:93-100)")
    p.add_argument("--eval_width", type=int, default=1232)
    common.add_model_flags(p)
    return p


def run(argv=None) -> List[Dict]:
    """What `main` does; returns one record per frame: {"name", "left",
    "disparities": the per-stage (H, W) float32 maps, "seconds": the
    forward's time (`InferenceEngine.infer_files`: after a warm-up run,
    CUDA events on the card), "host_seconds": the frame on the host
    clock, decode to the last PNG written}."""
    from lwsnet_tpu_torch.cli import common
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.data.kitti2015 import index_kitti2015_testing
    from lwsnet_tpu_torch.inference import (InferenceEngine,
                                            save_disparity_png)
    from lwsnet_tpu_torch.training.checkpoint import CheckpointManager
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.utils.logger import setup_logger

    args = build_parser().parse_args(argv)
    log = setup_logger("inference", "./log/")
    for k, v in sorted(vars(args).items()):
        log.info("%s: %s", k, v)

    model_cfg = common.model_config(args)
    state = create_train_state(model_cfg, TrainConfig(), seed=0,
                               device=args.device)
    if args.random_weights:
        log.info("using randomly initialized weights")
    elif CheckpointManager(args.model).restore_params_only(state) is None:
        raise SystemExit(f"no checkpoint found in {args.model}")
    else:
        log.info("loaded checkpoint from %s", args.model)
    engine = InferenceEngine(model_cfg, state.model.state_dict(),
                             eval_height=args.eval_height,
                             eval_width=args.eval_width, device=args.device)
    del state

    stages = range(1, model_cfg.num_stages + 1)
    if args.left_img:
        # single pair: sibling right_test.png, outputs <stage>.png
        # (reference: inference.py:66-70, 117-122)
        out_dir = args.save_path or os.path.dirname(args.left_img)
        right = os.path.join(os.path.dirname(args.left_img),
                             "right_test.png")
        name = os.path.splitext(os.path.basename(args.left_img))[0]
        frames = [(name, args.left_img, right,
                   [os.path.join(out_dir, f"{s}.png") for s in stages])]
    else:
        index = index_kitti2015_testing(args.img_path)
        out_dir = args.save_path
        frames = []
        for left, right in zip(index.left, index.right):
            name = os.path.splitext(os.path.basename(left))[0]
            frames.append((name, left, right, [
                os.path.join(out_dir, f"{name}_stage{s}.png")
                for s in stages]))
    os.makedirs(out_dir, exist_ok=True)

    records = []
    for i, (name, left, right, paths) in enumerate(frames):
        t0 = time.perf_counter()
        disps, dt = engine.infer_files(left, right,
                                       num_stages=model_cfg.num_stages)
        for path, d in zip(paths, disps):
            save_disparity_png(path, d)
        host = time.perf_counter() - t0
        log.info("[%d/%d] %s: %d stages, forward %.3f ms (%.1f FPS), frame "
                 "%.3f ms on the host clock", i + 1, len(frames), name,
                 len(disps), dt * 1e3, 1.0 / dt, host * 1e3)
        records.append(dict(name=name, left=left, disparities=disps,
                            seconds=dt, host_seconds=host))
    return records


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
