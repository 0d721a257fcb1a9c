"""Conv/BN building blocks of the port, NCHW / NCDHW inside.

Counterparts of the JAX package's `models/blocks.py`. Submodules and
parameters carry the Flax tree's names (`Conv_0`, `BatchNorm_0`, `kernel`
-> `weight`), so the weight bridge (`lwsnet_tpu_torch.convert`) is a pure
layout flip. As in the JAX package:

* parameters and batch-norm statistics are float32 under any compute
  dtype; batch norm runs in at least float32 and casts back;
* convolutions cast their input and weight to the compute dtype;
* padding equals the dilation whenever the dilation is above 1;
* the transposed conv is k3/s2/p1/output_padding 1, which doubles each
  spatial dim.

* in training mode (`module.train()`) batch norm normalizes by the
  batch's float32 statistics and updates the running ones as Flax
  `nn.BatchNorm(momentum=0.9)` does: biased variance
  max(0, E[x^2] - E[x]^2), r <- 0.9 r + 0.1 batch; in eval mode it uses
  the running statistics. Under a process group the batch is the global
  one, as under pjit: E[x] and E[x^2] are averaged over the processes,
  which hold equal batches; under row sharding, whose shards may differ
  (48 and 40 rows), the sums of x and x^2 and the element counts are
  summed instead;
* under row sharding (`parallel/mesh.py`) every convolution with a
  kernel taller than one row takes its H padding from the spatial
  neighbours' rows (`parallel/halo.py`) and keeps its W padding; without
  it the convolutions run as they always did;
* conv weights start He-normal, truncated at 2 sigma, as
  `nn.initializers.he_normal()` draws them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lwsnet_tpu_torch.parallel import halo, mesh

BN_EPS = 1e-5
# Flax's running-average momentum: r <- BN_MOMENTUM * r + (1 - BN_MOMENTUM) * b
BN_MOMENTUM = 0.9
# Standard deviation of the unit normal truncated to [-2, 2]; he_normal
# divides by it so the truncated draw keeps the variance 2 / fan_in.
TRUNC_STD = 0.87962566103423978


def _pad_for(dilation: int, padding: int) -> int:
    """Reference quirk: padding = dilation whenever dilation > 1."""
    return dilation if dilation > 1 else padding


def halo_rows(kernel: int, stride: int, padding: int, dilation: int
              ) -> Tuple[int, int]:
    """Rows above and below its shard that a convolution reads: output row
    o reads rows stride * o - padding + dilation * j, j < kernel, so a
    shard of whole output rows needs `padding` rows above and
    dilation * (kernel - 1) - padding - (stride - 1) below."""
    return padding, max(0, dilation * (kernel - 1) - padding - (stride - 1))


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           padding: int = 0, dilation: int = 1, groups: int = 1
           ) -> torch.Tensor:
    """Bias-free `F.conv2d` on NCHW; under row sharding the H padding comes
    from the halo rows."""
    if mesh.spatial_count() == 1:
        return F.conv2d(x, weight, None, stride, padding, dilation, groups)
    top, bottom = halo_rows(weight.shape[2], stride, padding, dilation)
    x = halo.extend_rows(x, 2, top, bottom)
    return F.conv2d(x, weight, None, stride, (0, padding), dilation, groups)


def conv3d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Bias-free 3x3x3 `F.conv3d`, padding 1, on (B, C, D, H, W); under row
    sharding the H padding comes from the halo rows."""
    if mesh.spatial_count() == 1:
        return F.conv3d(x, weight, None, 1, 1)
    x = halo.extend_rows(x, 3, 1, 1)
    return F.conv3d(x, weight, None, 1, (1, 0, 1))


def conv_transpose2d_up2(x: torch.Tensor, weight: torch.Tensor
                         ) -> torch.Tensor:
    """The k3/s2/p1/output_padding 1 transposed conv, which doubles H and
    W. Output rows 2 r .. 2 r + 1 read input rows r and r + 1: under row
    sharding a shard takes one row below (zeros past the image's bottom)
    and keeps its first 2 L output rows."""
    if mesh.spatial_count() == 1:
        return F.conv_transpose2d(x, weight, stride=2, padding=1,
                                  output_padding=1)
    L = x.shape[2]
    x = halo.extend_rows(x, 2, 0, 1)
    return F.conv_transpose2d(x, weight, stride=2, padding=1,
                              output_padding=1)[:, :, :2 * L]


def bn_affine(weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference batch norm as the float32 affine x * scale' + shift'."""
    a = weight.float() * torch.rsqrt(var.float() + BN_EPS)
    return a, bias.float() - mean.float() * a


class BatchNorm(nn.Module):
    """Batch norm over dim 1 in at least float32, as Flax computes it;
    returns that dtype. Training mode normalizes by the batch statistics
    (reduced over every dim but 1, and over every process of a process
    group) and folds them into the running ones; eval mode uses the
    running ones."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            # The global moments under a process group; the collective's
            # backward carries each process's loss to every process's input.
            if mesh.spatial_count() > 1:
                # row shards hold unequal element counts (48 and 40 rows):
                # the moments from the summed sums and counts
                n = x.new_full((1,), float(x.numel() // x.shape[1]))
                sums = mesh.all_reduce_autograd(
                    torch.cat([x.sum(dims), (x * x).sum(dims), n]),
                    "batch_norm")
                mean, mean_sq = (sums[:-1] / sums[-1]).chunk(2)
            else:
                mean, mean_sq = x.mean(dims), (x * x).mean(dims)
                if mesh.is_distributed():
                    # every process holds as many elements (the lockstep
                    # pipeline's equal batches): the mean of the moments
                    both = mesh.all_reduce_autograd(
                        torch.cat([mean, mean_sq]), "batch_norm")
                    mean, mean_sq = (both / mesh.process_count()).chunk(2)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


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
        return conv2d(x.to(dtype), self.weight.to(dtype), self.stride,
                      self.padding, self.dilation, self.groups)


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
        y = conv_transpose2d_up2(x.to(self.dtype),
                                 self.weight.to(self.dtype))
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
        # NCHW for the depthwise conv: on the CPU, oneDNN's bf16 depthwise
        # weight gradient from channels-last input is garbage (torch 2.13)
        x = F.relu(self.BatchNorm_0(x)).to(self.dtype).contiguous()
        d = self.dilation
        x = conv2d(x, self.dw_weight.to(self.dtype), 1, d, d, x.shape[1])
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
        return conv3d(x, self.weight.to(self.dtype))


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


def he_normal(shape, fan_in: int, generator: torch.Generator
              ) -> torch.Tensor:
    """`nn.initializers.he_normal()`'s draw: the unit normal truncated to
    [-2, 2] (by its inverse CDF), scaled by sqrt(2 / fan_in) / TRUNC_STD."""
    lo, hi = (0.5 * (1.0 + math.erf(t / math.sqrt(2.0))) for t in (-2, 2))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0) * math.sqrt(2.0)
    std = math.sqrt(2.0 / fan_in) / TRUNC_STD
    return (z.clamp(-2.0, 2.0) * std).float()


def fan_in(module: nn.Module, p: torch.Tensor) -> int:
    """Receptive field x input channels of a conv weight: (co, ci, k...)
    for a conv, (ci, co, k...) for the transposed conv."""
    out = p.shape[1] if isinstance(module, DeconvBN) else p.shape[0]
    return p.numel() // out


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
                p.copy_(he_normal(p.shape, fan_in(module, p), generator))
