"""Conv/BN building blocks of the port, eval mode, NCHW / NCDHW inside.

Counterparts of the JAX package's `models/blocks.py`. Submodules and
parameters carry the Flax tree's names (`Conv_0`, `BatchNorm_0`, `kernel`
-> `weight`), so the weight bridge (`lwsnet_tpu_torch.convert`) is a pure
layout flip. As in the JAX package:

* parameters and batch-norm statistics are float32 under any compute
  dtype; batch norm runs in float32 and casts back;
* convolutions cast their input and weight to the compute dtype;
* padding equals the dilation whenever the dilation is above 1;
* the transposed conv is k3/s2/p1/output_padding 1, which doubles each
  spatial dim.

Only inference is ported: batch norm always uses the running statistics.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def _pad_for(dilation: int, padding: int) -> int:
    """Reference quirk: padding = dilation whenever dilation > 1."""
    return dilation if dilation > 1 else padding


def bn_affine(weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference batch norm as the float32 affine x * scale' + shift'."""
    a = weight.float() * torch.rsqrt(var.float() + BN_EPS)
    return a, bias.float() - mean.float() * a


class BatchNorm(nn.Module):
    """Inference batch norm over dim 1 in float32; returns float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        return ((x.float() - self.running_mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape))


class Conv(nn.Module):
    """Bias-free 2-D conv holding an OIHW float32 weight."""

    def __init__(self, ci: int, co: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(co, ci // groups, kernel, kernel))
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = _pad_for(dilation, padding)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.conv2d(x.to(dtype), self.weight.to(dtype), None,
                        self.stride, self.padding, self.dilation, self.groups)


class ConvBN(nn.Module):
    """Conv2D (no bias) + BatchNorm."""

    def __init__(self, ci: int, co: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(ci, co, kernel, stride, padding, dilation)
        self.BatchNorm_0 = BatchNorm(co)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(self.Conv_0(x, self.dtype)).to(self.dtype)


class DeconvBN(nn.Module):
    """Transposed Conv2D k3/s2/p1/output_padding 1 (no bias) + BatchNorm.

    The weight is held in the transposed-conv layout (ci, co, kh, kw), as
    Paddle and PyTorch store it; the Flax tree keeps the spatially flipped
    HWIO correlation kernel, and the bridge flips it back."""

    def __init__(self, ci: int, co: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(ci, co, 3, 3))
        self.BatchNorm_0 = BatchNorm(co)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                               stride=2, padding=1, output_padding=1)
        return self.BatchNorm_0(y).to(self.dtype)


class PreConv(nn.Module):
    """BN + ReLU + dilated Conv2D."""

    def __init__(self, ci: int, co: int, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.BatchNorm_0 = BatchNorm(ci)
        self.Conv_0 = Conv(ci, co, 3, 1, 1, dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(F.relu(self.BatchNorm_0(x)), self.dtype)


class PreConvDW(nn.Module):
    """BN + ReLU + depthwise dilated 3x3 + pointwise 1x1."""

    def __init__(self, ci: int, co: int, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dilation = dilation
        self.BatchNorm_0 = BatchNorm(ci)
        self.dw_weight = nn.Parameter(torch.empty(ci, 1, 3, 3))
        self.Conv_0 = Conv(ci, co, kernel=1, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(x)).to(self.dtype)
        d = self.dilation
        x = F.conv2d(x, self.dw_weight.to(self.dtype), None, 1, d, d,
                     x.shape[1])
        return self.Conv_0(x, self.dtype)


class BNReLUConv3D(nn.Module):
    """BN3D + ReLU + 3x3x3 Conv3D (padding 1, no bias) on (B, C, D, H, W).
    The JAX package's three conv3d formulations compute this one function."""

    def __init__(self, ci: int, co: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.BatchNorm_0 = BatchNorm(ci)
        self.weight = nn.Parameter(torch.empty(co, ci, 3, 3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(x)).to(self.dtype)
        return F.conv3d(x, self.weight.to(self.dtype), None, 1, 1)


class CostFilter3D(nn.Module):
    """The per-stage 3D cost filter: 1 -> C, `layers` x (C -> C), C -> 1,
    each BN + ReLU + Conv3D. Takes and returns the volume as (B, H, W, D);
    the caller adds the identity skip."""

    def __init__(self, layers: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [1] + [channels] * (layers + 1) + [1]
        for i in range(layers + 2):
            self.add_module(f"BNReLUConv3D_{i}",
                            BNReLUConv3D(widths[i], widths[i + 1], dtype))

    def forward(self, cost: torch.Tensor) -> torch.Tensor:
        x = cost.permute(0, 3, 1, 2)[:, None]  # (B, 1, D, H, W)
        for layer in self.children():
            x = layer(x)
        return x[:, 0].permute(0, 2, 3, 1)


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """He-normal conv weights from `generator`; identity batch norms."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
                continue
            for name, p in module.named_parameters(recurse=False):
                out = p.shape[1] if isinstance(module, DeconvBN) else p.shape[0]
                std = math.sqrt(2.0 * out / p.numel())
                p.copy_(torch.randn(p.shape, generator=generator) * std)
