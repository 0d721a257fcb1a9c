"""LWSNet: the 4-stage anytime stereo cascade in PyTorch.

Counterpart of the JAX package's `models/lwsnet.py`, eval mode:

  stage 1: full L1 cost volume over 24 disparities at 1/8 res -> 3D-CNN
           (+ identity skip) -> soft-argmin -> upsample           (absolute)
  stage 2: warped residual volume (9 offsets) at 1/4 res -> ...  (residual)
  stage 3: the same at 1/2 res                                   (residual)
  stage 4: colour-guidance refinement towers at full res         (residual)

`forward(..., kernels=False)` is the plain module path, the counterpart of
the JAX `use_pallas=False`. With `kernels=True` the cost filters and the
refinement run on the Hopper kernels (`lwsnet_tpu_torch.ops.cuda`);
`inference.make_forward` selects it. `num_stages` is an early exit: the
stages after it do not run.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from lwsnet_tpu_torch.config import ModelConfig
from lwsnet_tpu_torch.device import resolve_device
from lwsnet_tpu_torch.models.blocks import CostFilter3D, init_params
from lwsnet_tpu_torch.models.feature import FeatureExtractor
from lwsnet_tpu_torch.models.refine_kernels import refine_residual
from lwsnet_tpu_torch.models.refinement import (RefinementHead,
                                                RefinementTower)
from lwsnet_tpu_torch.ops import stereo
from lwsnet_tpu_torch.ops.cuda.costfilter import filter_soft_argmin


class LWSNet(nn.Module):
    """Anytime stereo disparity network. Inputs: left/right (B, H, W, 3)
    NHWC, ImageNet-normalized, H and W multiples of 8. Output: a list of
    (B, H, W, 1) float32 full-res disparities, one per stage run.

    The model is built on `device` (default the card; raises without one)
    with He-normal weights drawn from `seed` and identity batch norms."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        dt = cfg.dtype
        self.FeatureExtractor_0 = FeatureExtractor(cfg.feature_channels, dt)
        for s in range(3):
            self.add_module(f"CostFilter3D_{s}", CostFilter3D(
                cfg.layers_3d, cfg.channels_3d * cfg.growth_rate[s], dt))
        c = cfg.refine_channels
        self.RefinementTower_0 = RefinementTower(3, c, dt)
        self.RefinementTower_1 = RefinementTower(1, c, dt)
        self.RefinementHead_0 = RefinementHead(2 * c, c, dt)
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(dev)
        self.eval()

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                num_stages: Optional[int] = None,
                kernels: bool = False) -> List[torch.Tensor]:
        cfg = self.cfg
        stages = num_stages if num_stages is not None else cfg.num_stages
        if not 1 <= stages <= 4:
            raise ValueError(f"num_stages must be 1..4, got {stages}")
        B, H, W, _ = left.shape
        if H % 8 or W % 8:
            raise ValueError(f"input dims must be multiples of 8, got "
                             f"{H}x{W}")
        dtype = cfg.dtype

        # Shared-weight feature extraction on one 2B batch.
        both = torch.cat([left, right], 0).permute(0, 3, 1, 2).to(dtype)
        feats = [f.permute(0, 2, 3, 1) for f in self.FeatureExtractor_0(both)]

        preds: List[torch.Tensor] = []
        for scale in range(min(stages, 3)):
            fl, fr = feats[scale][:B], feats[scale][B:]
            fh, fw = fl.shape[1], fl.shape[2]
            D = cfg.max_disp_list[scale]
            if scale == 0:
                cost = stereo.build_cost_volume(fl, fr, D)
                start = 0
            else:
                # Disparities stay float32: bf16 has too little mantissa
                # for sub-pixel warp offsets.
                wflow = stereo.resize_bilinear(preds[-1], fh, fw) * (fh / H)
                cost = stereo.build_residual_volume(fl, fr, wflow, D)
                start = -D + 1
            filt = getattr(self, f"CostFilter3D_{scale}")
            if kernels:
                d = filter_soft_argmin(
                    cost, dict(filt.named_parameters()),
                    dict(filt.named_buffers()), layers=cfg.layers_3d,
                    channels=cfg.channels_3d * cfg.growth_rate[scale],
                    start=start, dtype=dtype)
            else:
                d = stereo.soft_argmin(filt(cost) + cost, start,
                                       start + cost.shape[-1])
            d_up = stereo.resize_bilinear(d * (H / fh), H, W)
            preds.append(d_up if scale == 0 else d_up + preds[-1])

        if stages == 4:
            if kernels:
                res = refine_residual(self, left, preds[-1], dtype=dtype)
            else:
                tower_l = self.RefinementTower_0(
                    left.permute(0, 3, 1, 2).to(dtype))
                tower_d = self.RefinementTower_1(
                    preds[-1].permute(0, 3, 1, 2).to(dtype))
                res = self.RefinementHead_0(
                    torch.cat([tower_l, tower_d], 1)).permute(0, 2, 3, 1)
            preds.append(preds[-1] + res.float())
        return [p.float() for p in preds]
