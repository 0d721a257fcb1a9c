"""Staged masked smooth-L1 loss (reference: train.py:127-166,
finetune.py:142-181).

Counterpart of the JAX package's `training/losses.py`: each stage's
smooth-L1 (delta 1) over the pixels whose ground truth lies strictly
between the mask bounds, normalized by max(count, 1), weighted and summed.
Pretrain masks gt < max_disp, finetune gt > 0.

Under a process group the count is the global batch's, as the JAX loss
under pjit divides by it: each process returns its own pixels' share of
the global loss, and the shares sum to it (`training/steps.py` sums the
gradients).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from lwsnet_tpu_torch.parallel import mesh


def smooth_l1(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """0.5 x^2 / delta for |x| < delta, else |x| - 0.5 delta."""
    ax = x.abs()
    return torch.where(ax < delta, 0.5 * ax * ax / delta, ax - 0.5 * delta)


def disparity_mask(gt: torch.Tensor, min_disp: float, max_disp: float
                   ) -> torch.Tensor:
    """Valid-pixel mask, float32; both bounds exclusive."""
    return ((gt > min_disp) & (gt < max_disp)).float()


def staged_loss(outputs: Sequence[torch.Tensor], gt: torch.Tensor,
                loss_weights: Sequence[float],
                min_disp: float = float("-inf"),
                max_disp: float = float("inf"),
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted sum of per-stage masked smooth-L1 losses.

    outputs: per-stage (B, H, W, 1) or (B, H, W) disparities; gt (B, H, W).
    Returns (total, per-stage losses before weighting), as the reference
    logs the de-weighted values; under a process group, this process's
    shares of them.
    """
    mask = disparity_mask(gt, min_disp, max_disp)
    count = torch.clamp(mesh.all_reduce_(mask.sum(), "loss_count"), min=1.0)
    per_stage = []
    for out in outputs:
        if out.dim() == 4:
            out = out[..., 0]
        per_stage.append((smooth_l1(out - gt) * mask).sum() / count)
    per_stage = torch.stack(per_stage)
    weights = torch.tensor(loss_weights[: len(per_stage)],
                           dtype=torch.float32, device=per_stage.device)
    return (per_stage * weights).sum(), per_stage
