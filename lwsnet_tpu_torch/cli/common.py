"""Shared argparse <-> config plumbing for the port's CLI entry points.

The JAX package's `cli/common.py` flag set, plus `--device` (default
`cuda`): the entry points run on the card and raise without one unless
asked for the CPU. `setup` starts a training entry point: the process
group when a launcher such as `torchrun` set one up, and the logger."""

from __future__ import annotations

import argparse
import logging
from typing import Tuple

from lwsnet_tpu_torch.config import ModelConfig, TrainConfig


def add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--maxdisplist", type=int, nargs="+", default=[24, 5, 5])
    p.add_argument("--channels_3d", type=int, default=8)
    p.add_argument("--layers_3d", type=int, default=4)
    p.add_argument("--growth_rate", type=int, nargs="+", default=[4, 1, 1])
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--no_pallas", action="store_true",
                   help="inference on the plain module path instead of "
                        "the Hopper kernels (training always runs it)")
    p.add_argument("--num_stages", type=int, default=4, choices=[1, 2, 3, 4])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; `cpu` runs the plain PyTorch path")


def add_data_flags(p: argparse.ArgumentParser, eval_height: int,
                   eval_width: int) -> None:
    """Train crop and eval window (368x1232 KITTI, 544x960 SceneFlow)."""
    p.add_argument("--crop_height", type=int, default=256)
    p.add_argument("--crop_width", type=int, default=512)
    p.add_argument("--eval_height", type=int, default=eval_height)
    p.add_argument("--eval_width", type=int, default=eval_width)


def add_train_flags(p: argparse.ArgumentParser, epochs: int,
                    batch: int, save_path: str) -> None:
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--epoch", type=int, default=epochs)
    p.add_argument("--train_batch_size", type=int, default=batch)
    p.add_argument("--test_batch_size", type=int, default=8)
    p.add_argument("--loss_weights", type=float, nargs="+",
                   default=[0.25, 0.5, 1.0, 1.0])
    p.add_argument("--save_path", type=str, default=save_path)
    p.add_argument("--resume", action="store_true",
                   help="resume from the checkpoint in --save_path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=8)


def model_config(args) -> ModelConfig:
    return ModelConfig(
        max_disp=args.maxdisp,
        max_disp_list=tuple(args.maxdisplist),
        channels_3d=args.channels_3d,
        layers_3d=args.layers_3d,
        growth_rate=tuple(args.growth_rate),
        compute_dtype=args.compute_dtype,
        use_pallas=not args.no_pallas,
        num_stages=args.num_stages,
    )


def train_config(args, **overrides) -> TrainConfig:
    base = dict(
        lr=args.lr,
        epochs=args.epoch,
        train_batch_size=args.train_batch_size,
        eval_batch_size=args.test_batch_size,
        loss_weights=tuple(args.loss_weights),
        save_path=args.save_path,
        seed=args.seed,
    )
    base.update(overrides)
    return TrainConfig(**base)


def setup(name: str, args) -> Tuple[logging.Logger, int, int]:
    """Initialize the process group from the launcher's environment (a
    no-op without one: `parallel/mesh.py`) and the logger, which writes
    to stderr and ./log/ on process 0 only; logs the flags. Returns
    (logger, process index, process count)."""
    from lwsnet_tpu_torch.parallel import mesh
    from lwsnet_tpu_torch.utils.logger import setup_logger

    mesh.maybe_initialize_distributed(args.device)
    pi = mesh.process_index()
    log = setup_logger(name, "./log/", pi)
    for k, v in sorted(vars(args).items()):
        log.info("%s: %s", k, v)
    return log, pi, mesh.process_count()
