"""Colour-guidance refinement towers and head (stage 4), NCHW.

Counterparts of the JAX package's `models/refinement.py`: two full-res
towers (left image, stage-3 disparity) of depthwise-separable dilated
convs, concatenated and reduced to a 1-channel residual. This is the plain
module path; `models/refine_kernels.py` runs the same function on the
Hopper kernels.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from lwsnet_tpu_torch.models.blocks import Conv, PreConv, PreConvDW

TOWER_DILATIONS = (2, 4, 8, 16)
HEAD_DILATIONS = (8, 4, 2, 1)
HEAD_DENSE_DILATION = 8


class RefinementTower(nn.Module):
    """3x3 conv, then 4 depthwise-separable convs with dilations 2..16."""

    def __init__(self, ci: int, features: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(ci, features)
        for k, d in enumerate(TOWER_DILATIONS):
            self.add_module(f"PreConvDW_{k}",
                            PreConvDW(features, features, d, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x, self.dtype)
        for k in range(len(TOWER_DILATIONS)):
            x = getattr(self, f"PreConvDW_{k}")(x)
        return x


class RefinementHead(nn.Module):
    """PreConv d=8, 4 depthwise-separable convs with dilations 8..1, then a
    3x3 conv to 1 channel."""

    def __init__(self, ci: int = 64, features: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.PreConv_0 = PreConv(ci, features, HEAD_DENSE_DILATION, dtype)
        for k, d in enumerate(HEAD_DILATIONS):
            self.add_module(f"PreConvDW_{k}",
                            PreConvDW(features, features, d, dtype))
        self.out_weight = nn.Parameter(torch.empty(1, features, 3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.PreConv_0(x)
        for k in range(len(HEAD_DILATIONS)):
            x = getattr(self, f"PreConvDW_{k}")(x)
        return F.conv2d(x.to(self.dtype), self.out_weight.to(self.dtype),
                        None, 1, 1)
