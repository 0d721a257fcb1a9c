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


def epe_terms(pred: torch.Tensor, gt: torch.Tensor,
              max_disp: float = 192.0) -> torch.Tensor:
    """EPE's numerator and pixel count, (2,): sums that row shards add
    before `epe_ratio` divides (over the last dim)."""
    mask = (gt < max_disp).float()
    return torch.stack([((_squeeze(pred) - gt).abs() * mask).sum(),
                        mask.sum()])


def epe_ratio(terms: torch.Tensor) -> torch.Tensor:
    return terms[..., 0] / torch.clamp(terms[..., 1], min=1.0)


def epe(pred: torch.Tensor, gt: torch.Tensor,
        max_disp: float = 192.0) -> torch.Tensor:
    """End-point error over valid pixels. pred/gt: (B, H, W)."""
    return epe_ratio(epe_terms(pred, gt, max_disp))


def d1_terms(pred: torch.Tensor, gt: torch.Tensor,
             max_disp: float = 192.0) -> torch.Tensor:
    """D1's bad-pixel count and pixel count, (2,)."""
    mask = ((gt > 0) & (gt < max_disp)).float()
    err = (_squeeze(pred) - gt).abs()
    bad = ((err > 3.0) & (err / torch.clamp(gt, min=1e-9) > 0.05)).float()
    return torch.stack([(bad * mask).sum(), mask.sum()])


def d1_ratio(terms: torch.Tensor) -> torch.Tensor:
    return terms[..., 0] / (terms[..., 1] + 1e-9)


def d1_error(pred: torch.Tensor, gt: torch.Tensor,
             max_disp: float = 192.0) -> torch.Tensor:
    """3-pixel error rate. pred/gt: (B, H, W)."""
    return d1_ratio(d1_terms(pred, gt, max_disp))


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
