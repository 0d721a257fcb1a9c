"""Evaluation metrics: EPE and the 3-pixel error (D1).

Counterpart of the JAX package's `training/metrics.py`:
* EPE: mean |pred - gt| over the pixels with gt < max_disp
  (reference: train.py:180-190);
* D1: the share of pixels with 0 < gt < max_disp where |err| > 3 px and
  |err| / gt > 5 % (reference: finetune.py:212-219), with +1e-9 in the
  denominator so an empty mask gives 0.
"""

from __future__ import annotations

import torch


def _squeeze(pred: torch.Tensor) -> torch.Tensor:
    return pred[..., 0] if pred.dim() == 4 else pred


def epe(pred: torch.Tensor, gt: torch.Tensor,
        max_disp: float = 192.0) -> torch.Tensor:
    """End-point error over valid pixels. pred/gt: (B, H, W)."""
    mask = (gt < max_disp).float()
    count = torch.clamp(mask.sum(), min=1.0)
    return ((_squeeze(pred) - gt).abs() * mask).sum() / count


def d1_error(pred: torch.Tensor, gt: torch.Tensor,
             max_disp: float = 192.0) -> torch.Tensor:
    """3-pixel error rate. pred/gt: (B, H, W)."""
    mask = ((gt > 0) & (gt < max_disp)).float()
    err = (_squeeze(pred) - gt).abs()
    bad = ((err > 3.0) & (err / torch.clamp(gt, min=1e-9) > 0.05)).float()
    return (bad * mask).sum() / (mask.sum() + 1e-9)


class AverageMeter:
    """Running val/avg/sum/count accumulator (reference: utils/utils.py:1-17)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count
