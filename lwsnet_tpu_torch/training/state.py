"""Train state: the model (parameters and batch-norm statistics), Adam, the
step counters, and the learning-rate schedule.

Counterpart of the JAX package's `training/state.py`. Adam takes Paddle's
defaults (b1 0.9, b2 0.999, eps 1e-8; reference: train.py:80), after a
global-norm gradient clip. The schedule is indexed by the optimizer's own
update count, as optax's `scale_by_schedule` is: a step skipped for a
non-finite loss does not advance it (`TrainState.updates`), while
`TrainState.step` counts every step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from lwsnet_tpu_torch.config import ModelConfig, TrainConfig
from lwsnet_tpu_torch.device import resolve_device
from lwsnet_tpu_torch.models.lwsnet import LWSNet

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    """The model with its optimizer; the step functions update it in place."""

    model: LWSNet
    optimizer: torch.optim.Optimizer
    step: int = 0     # train steps taken, skipped ones included
    updates: int = 0  # optimizer updates applied; indexes the schedule


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """lr x gamma^(milestones passed), the milestones in epochs x
    `steps_per_epoch` (reference: finetune.py:82-84); with
    `cfg.warmup_steps` a linear 0 -> lr ramp first, after which the base
    schedule starts from its step 0. The arithmetic is optax's
    `piecewise_constant_schedule`, `linear_schedule` and `join_schedules`
    in float32, operation for operation."""
    lr = np.float32(cfg.lr)
    bounds = sorted({int(m) * steps_per_epoch: cfg.lr_gamma
                     for m in cfg.lr_milestones}.items())

    def base(count: int) -> float:
        if not bounds:  # optax.constant_schedule: lr as given
            return cfg.lr
        v = lr
        for threshold, scale in bounds:
            if count >= threshold:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    warm = cfg.warmup_steps

    def schedule(step: int) -> float:
        step = int(step)
        if warm <= 0:
            return base(step)
        if step < warm:
            frac = np.float32(1.0) - (np.float32(max(step, 0))
                                      / np.float32(warm))
            return float(np.float32(-lr) * frac + lr)
        return float(np.float32(base(step - warm)))

    return schedule


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with Paddle's defaults. Its learning rate is set before every
    update from the schedule (`steps.make_train_step`)."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=ADAM_BETAS,
                            eps=ADAM_EPS)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of all elements together (optax.global_norm), as a
    float32 scalar on the tensors' device."""
    return torch.nn.utils.get_total_norm(tensors, 2.0)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         norm: float) -> None:
    """optax.clip_by_global_norm in place: g stays when norm < max_norm,
    else is scaled by max_norm / norm (no epsilon, unlike
    torch.nn.utils.clip_grad_norm_)."""
    if norm < max_norm:
        return
    torch._foreach_mul_(list(grads), max_norm / norm)


def create_train_state(model_cfg: ModelConfig, cfg: TrainConfig,
                       seed: int = 0, device="cuda") -> TrainState:
    """A fresh `LWSNet` on `device` (He-normal weights from `seed`,
    identity batch norms) with a fresh Adam. Raises without a card unless
    `device` is the CPU."""
    model = LWSNet(model_cfg, device=resolve_device(device), seed=seed)
    return TrainState(model, make_optimizer(model.parameters(), cfg))


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
