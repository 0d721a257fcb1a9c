"""Stage-4 refinement on the Hopper kernels (inference only).

Counterpart of the JAX package's `models/refine_pallas.py` in its shipped
configuration, `pallas_mode="rows"`, `rows_dw="mxu"`: every layer of both
towers and of the head runs as one `dense3x3` launch, 11 in all.

* BatchNorm folds into a per-channel affine applied before each layer.
* Each depthwise-separable layer becomes one dense 3x3 over the composed
  rank-1 kernel k[co, ci] = dw[ci] * pw[co, ci], formed in float32 and
  cast once to the compute dtype.
* The two towers run as one 2B batch with two weight groups; the disparity
  tower's 1-channel input and entry kernel are zero-padded to 3 channels,
  which is exact.
* The head's 64-channel entry reads the two tower halves without forming
  the concat (the dual-input `dense2_layer`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lwsnet_tpu_torch.models.blocks import BatchNorm, PreConvDW, bn_affine
from lwsnet_tpu_torch.models.refinement import (HEAD_DENSE_DILATION,
                                                HEAD_DILATIONS,
                                                TOWER_DILATIONS)
from lwsnet_tpu_torch.ops.cuda.refine_rows import dense2_layer, dense_layer


def fold_bn(bn: BatchNorm) -> torch.Tensor:
    """Inference BatchNorm as a (2, C) float32 affine (scale', shift')."""
    return torch.stack(bn_affine(bn.weight, bn.bias, bn.running_mean,
                                 bn.running_var))


def _compose_dwsep(block: PreConvDW) -> torch.Tensor:
    """The depthwise (C, 1, 3, 3) and pointwise (Co, C, 1, 1) kernels of a
    dw-sep layer as one dense (Co, C, 3, 3) kernel, in float32:
    k[co, ci, y, x] = dw[ci, 0, y, x] * pw[co, ci]. Exact by
    associativity."""
    dw = block.dw_weight.float()[:, 0]             # (C, 3, 3)
    pw = block.Conv_0.weight.float()[:, :, 0, 0]   # (Co, C)
    return pw[:, :, None, None] * dw[None]


def refine_residual(model, left: torch.Tensor, disp: torch.Tensor, *,
                    dtype: Optional[torch.dtype] = None,
                    mode: Optional[str] = None,
                    dw: Optional[str] = None) -> torch.Tensor:
    """The stage-4 residual, equal to RefinementTower(left) ++
    RefinementTower(disp) -> RefinementHead in eval mode.

    model: an `LWSNet` (its towers and head hold the weights). left:
    (B, H, W, 3) normalized image; disp: (B, H, W, 1) stage-3 disparity.
    dtype, mode, dw default to the model's config. Returns (B, H, W, 1)
    float32.
    """
    cfg = model.cfg
    dtype = dtype or cfg.dtype
    mode = mode or cfg.pallas_mode
    dw = dw or cfg.rows_dw
    if mode != "rows":
        raise NotImplementedError(
            f'pallas_mode="{mode}" not yet ported, see ROADMAP.md')
    if dw != "mxu":
        raise NotImplementedError(
            f'rows_dw="{dw}" not yet ported, see ROADMAP.md')
    tl, td = model.RefinementTower_0, model.RefinementTower_1
    head = model.RefinementHead_0

    x = torch.cat([left.permute(0, 3, 1, 2).to(dtype),
                   F.pad(disp.permute(0, 3, 1, 2).to(dtype),
                         (0, 0, 0, 0, 0, 2))], 0).contiguous()
    entries = torch.stack([tl.Conv_0.weight,
                           F.pad(td.Conv_0.weight, (0, 0, 0, 0, 0, 2))])
    y = dense_layer(x, entries, dilation=1, groups=2)
    for i, d in enumerate(TOWER_DILATIONS):
        bl = getattr(tl, f"PreConvDW_{i}")
        bd = getattr(td, f"PreConvDW_{i}")
        y = dense_layer(
            y, torch.stack([_compose_dwsep(bl), _compose_dwsep(bd)]),
            dilation=d, groups=2,
            affine=torch.stack([fold_bn(bl.BatchNorm_0),
                                fold_bn(bd.BatchNorm_0)]))

    pre = head.PreConv_0
    y = dense2_layer(y, pre.Conv_0.weight, dilation=HEAD_DENSE_DILATION,
                     affine=fold_bn(pre.BatchNorm_0))
    for i, d in enumerate(HEAD_DILATIONS):
        blk = getattr(head, f"PreConvDW_{i}")
        y = dense_layer(y, _compose_dwsep(blk), dilation=d,
                        affine=fold_bn(blk.BatchNorm_0))
    y = dense_layer(y, head.out_weight.to(dtype), dilation=1,
                    out_dtype=torch.float32)
    return y.permute(0, 2, 3, 1)
