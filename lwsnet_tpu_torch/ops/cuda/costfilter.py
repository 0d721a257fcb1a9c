"""Cost filter + identity skip + soft-argmin on the Hopper kernels.

Counterpart of the JAX package's `ops/pallas/costfilter.py`. A stage's
filter is `layers + 2` BN + ReLU + conv3d layers; in inference every BN
folds into an affine, so the stage runs as

  act = relu(a0 * vol + b0)                       (plain torch, layer 0's BN)
  act = conv3d_bn_relu(act, w_k * a_{k+1}, b_{k+1})   for k = 0 .. n-2
  out = conv3d_skip_softargmin(act, w_{n-1}, vol, start)

Layer k+1's BN scale folds into layer k's weights in float32, cast once to
the compute dtype; its shift is the epilogue's bias. Stages 1, 2 and 3 all
take this one path (the JAX package's `_dgrid` and `_folded` formulations
compute the same function).

Each kernel wrapper launches its CUDA kernel for a CUDA tensor and runs
its plain PyTorch version, beside it here, for a CPU tensor.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from lwsnet_tpu_torch.models.blocks import bn_affine
from lwsnet_tpu_torch.ops.cuda.build import (CONV3D_BN_RELU,
                                             CONV3D_SKIP_SOFTARGMIN, check,
                                             on_card, symbol_suffix)


def conv3d_bn_relu_plain(x: torch.Tensor, wt: torch.Tensor,
                         shift: torch.Tensor) -> torch.Tensor:
    """relu(conv3d(x, wt, padding=1) + shift), float32 arithmetic on the
    compute-dtype operands, result in x's dtype. x: (B, Ci, D, H, W);
    wt: (Co, Ci, 3, 3, 3) in x's dtype; shift: (Co,) float32."""
    y = F.conv3d(x.float(), wt.float(), padding=1)
    return F.relu(y + shift.view(1, -1, 1, 1, 1)).to(x.dtype)


def conv3d_bn_relu(x: torch.Tensor, wt: torch.Tensor,
                   shift: torch.Tensor) -> torch.Tensor:
    """One BN-folded conv3d layer; see `conv3d_bn_relu_plain`."""
    if not on_card(x):
        return conv3d_bn_relu_plain(x, wt, shift)
    B, Ci, D, H, W = x.shape
    Co = wt.shape[0]
    check(x, "x", (B, Ci, D, H, W), x.dtype, x.device)
    check(wt, "wt", (Co, Ci, 3, 3, 3), x.dtype, x.device)
    check(shift, "shift", (Co,), torch.float32, x.device)
    wk = wt.permute(1, 2, 3, 4, 0).reshape(Ci, 27, Co).contiguous()
    y = torch.empty((B, Co, D, H, W), dtype=x.dtype, device=x.device)
    CONV3D_BN_RELU.launch(
        f"conv3d_bn_relu_{symbol_suffix(x.dtype)}", x.device,
        x.data_ptr(), wk.data_ptr(), shift.data_ptr(), y.data_ptr(),
        B, Ci, Co, D, H, W)
    return y


def conv3d_skip_softargmin_plain(x: torch.Tensor, wt: torch.Tensor,
                                 vol: torch.Tensor,
                                 start: int) -> torch.Tensor:
    """Last conv3d Ci -> 1, plus the raw volume, then the expectation of
    bins start .. start+D-1 under softmax(-cost) over D, all float32.
    x: (B, Ci, D, H, W); wt: (1, Ci, 3, 3, 3); vol: (B, D, H, W), both in
    x's dtype. Returns (B, H, W) float32."""
    cost = F.conv3d(x.float(), wt.float(), padding=1)[:, 0] + vol.float()
    D = cost.shape[1]
    bins = torch.arange(start, start + D, dtype=torch.float32,
                        device=x.device)
    return (torch.softmax(-cost, dim=1) * bins.view(1, D, 1, 1)).sum(1)


def conv3d_skip_softargmin(x: torch.Tensor, wt: torch.Tensor,
                           vol: torch.Tensor, start: int) -> torch.Tensor:
    """Fused last layer + skip + soft-argmin; see the plain version."""
    if not on_card(x):
        return conv3d_skip_softargmin_plain(x, wt, vol, start)
    B, Ci, D, H, W = x.shape
    check(x, "x", (B, Ci, D, H, W), x.dtype, x.device)
    check(wt, "wt", (1, Ci, 3, 3, 3), x.dtype, x.device)
    check(vol, "vol", (B, D, H, W), x.dtype, x.device)
    out = torch.empty((B, H, W), dtype=torch.float32, device=x.device)
    CONV3D_SKIP_SOFTARGMIN.launch(
        f"conv3d_skip_softargmin_{symbol_suffix(x.dtype)}", x.device,
        x.data_ptr(), wt.data_ptr(), vol.data_ptr(), out.data_ptr(),
        B, Ci, D, H, W, float(start))
    return out


def _fold_bn(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
             prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale', shift') float32 of the inference BatchNorm at `prefix`."""
    return bn_affine(params[f"{prefix}.weight"], params[f"{prefix}.bias"],
                     stats[f"{prefix}.running_mean"],
                     stats[f"{prefix}.running_var"])


def filter_soft_argmin(cost: torch.Tensor, params: Dict[str, torch.Tensor],
                       stats: Dict[str, torch.Tensor], *, layers: int,
                       channels: int, start: int,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """CostFilter3D (eval) + identity skip + soft-argmin:

        soft_argmin(CostFilter3D(cost) + cost, start, start + D)

    cost: (B, H, W, D). params / stats: a `CostFilter3D` module's
    `named_parameters()` / `named_buffers()` as dicts. layers: mid-layer
    count; channels: mid-layer width. Returns (B, H, W, 1) float32 in bin
    units.
    """
    n = layers + 2
    widths = [1] + [channels] * (layers + 1) + [1]
    for i in range(n):
        shape = tuple(params[f"BNReLUConv3D_{i}.weight"].shape)
        if shape != (widths[i + 1], widths[i], 3, 3, 3):
            raise ValueError(f"layer {i}: weight {shape} does not match "
                             f"layers={layers}, channels={channels}")
    affs = [_fold_bn(params, stats, f"BNReLUConv3D_{i}.BatchNorm_0")
            for i in range(n)]
    vol = cost.permute(0, 3, 1, 2).to(dtype).contiguous()  # (B, D, H, W)
    a0, b0 = affs[0]
    act = F.relu(vol.float() * a0 + b0).to(dtype)[:, None]
    for i in range(n - 1):
        a_next, b_next = affs[i + 1]
        wt = params[f"BNReLUConv3D_{i}.weight"].float() \
            * a_next.view(-1, 1, 1, 1, 1)
        act = conv3d_bn_relu(act, wt.to(dtype), b_next)
    wt = params[f"BNReLUConv3D_{n - 1}.weight"].to(dtype)
    return conv3d_skip_softargmin(act, wt, vol, start)[..., None]
