"""Stage-4 refinement on the Hopper kernels (inference only).

Counterpart of the JAX package's `models/refine_pallas.py` under
`pallas_mode="rows"`, in each of its three engines (`rows_dw`):

* "mxu" (shipped): every layer of both towers and of the head runs as one
  `dense3x3` launch, 11 in all; each depthwise-separable layer becomes one
  dense 3x3 over the composed rank-1 kernel
  k[co, ci] = dw[ci] * pw[co, ci], formed in float32 and cast once to the
  compute dtype. On the card in bf16 the activations from the entry to
  the output conv lie channels-last in memory, as the tensor-core route
  reads them.
* "vpu": the dw-sep layers run as they are on the `dwsep3x3` kernel, two
  per launch with `rows_paired` (4 launches) or one (8), the depthwise and
  pointwise weights each cast to the compute dtype; the entries and the
  output conv stay on `dense3x3` (3 launches).
* "chain": the whole tower stack and the whole head run as one `chain3x3`
  launch each, over the composed kernels as in "mxu". On the card in bf16
  the tower reads its 3-channel input NCHW and writes channels-last, and
  the head reads its two halves from that (`x[:B]`, `x[B:]`).

In every engine BatchNorm folds into a per-channel affine applied before
each layer; the two towers run as one 2B batch with two weight groups, the
disparity tower's 1-channel input and entry kernel zero-padded to 3
channels, which is exact; and the head's 64-channel entry reads the two
tower halves without forming the concat.

Under `pallas_mode="layers"` (`_layers_mode`) it mirrors the JAX planar
path instead, through `ops/cuda/refine.py`: each tower runs alone at batch
B with its own weights, the disparity tower on its 1-channel input; the
dw-sep layers pair as `layer_plan` says (all pairs at 368x1232, 6 pair
launches); the head's entry runs as two single-input convs, one per tower,
each rounded to the compute dtype and summed in it (in bf16 all of it
channels-last in memory, as the tensor-core routes read it); and the
output conv writes the compute dtype, so the residual is rounded to it
before it becomes float32. The weights are cast to the compute dtype, the
folded BN affines stay float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lwsnet_tpu_torch.config import PALLAS_MODES
from lwsnet_tpu_torch.models.blocks import BatchNorm, PreConvDW, bn_affine
from lwsnet_tpu_torch.models.refinement import (HEAD_DENSE_DILATION,
                                                HEAD_DILATIONS,
                                                TOWER_DILATIONS)
from lwsnet_tpu_torch.ops.cuda.refine import (fused_dense, fused_dwsep,
                                              fused_dwsep2, layer_plan)
from lwsnet_tpu_torch.ops.cuda.refine_rows import (chain_layer, dense2_layer,
                                                   dense_layer, dwsep2_layer,
                                                   dwsep_layer,
                                                   dwsep_tensor_core_route)

ENGINES = ("mxu", "vpu", "chain")


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


def _dwsep_weights(block: PreConvDW):
    """(affine, depthwise (C, 1, 3, 3), pointwise (Co, C)) of a dw-sep
    layer, float32; the layer functions cast each to the compute dtype."""
    return (fold_bn(block.BatchNorm_0), block.dw_weight,
            block.Conv_0.weight[:, :, 0, 0])


def refine_residual(model, left: torch.Tensor, disp: torch.Tensor, *,
                    dtype: Optional[torch.dtype] = None,
                    mode: Optional[str] = None,
                    dw: Optional[str] = None,
                    paired: Optional[bool] = None) -> torch.Tensor:
    """The stage-4 residual, equal to RefinementTower(left) ++
    RefinementTower(disp) -> RefinementHead in eval mode.

    model: an `LWSNet` (its towers and head hold the weights). left:
    (B, H, W, 3) normalized image; disp: (B, H, W, 1) stage-3 disparity.
    dtype, mode, dw and paired default to the model's config (compute
    dtype, `pallas_mode`, `rows_dw`, `rows_paired`). Returns (B, H, W, 1)
    float32.
    """
    cfg = model.cfg
    dtype = dtype or cfg.dtype
    mode = mode or cfg.pallas_mode
    dw = dw or cfg.rows_dw
    paired = cfg.rows_paired if paired is None else paired
    if mode not in PALLAS_MODES:
        raise ValueError(f'pallas_mode="{mode}": expected one of '
                         f'{PALLAS_MODES}')
    if mode == "layers":
        return _layers_mode(model, left, disp, dtype)
    if dw not in ENGINES:
        raise ValueError(f'rows_dw="{dw}": expected one of {ENGINES}')
    tl, td = model.RefinementTower_0, model.RefinementTower_1
    head = model.RefinementHead_0
    tower = [(getattr(tl, f"PreConvDW_{i}"), getattr(td, f"PreConvDW_{i}"))
             for i in range(len(TOWER_DILATIONS))]
    head_dw = [getattr(head, f"PreConvDW_{i}")
               for i in range(len(HEAD_DILATIONS))]
    pre = head.PreConv_0

    x = torch.cat([left.permute(0, 3, 1, 2).to(dtype),
                   F.pad(disp.permute(0, 3, 1, 2).to(dtype),
                         (0, 0, 0, 0, 0, 2))], 0).contiguous()
    entries = torch.stack([tl.Conv_0.weight,
                           F.pad(td.Conv_0.weight, (0, 0, 0, 0, 0, 2))])

    if dw == "chain":
        # In bf16 on the card y lies channels-last; the head's two halves
        # are views of it in the same layout.
        y = chain_layer(
            x, [entries] + [torch.stack([_compose_dwsep(bl),
                                         _compose_dwsep(bd)])
                            for bl, bd in tower],
            [None] + [torch.stack([fold_bn(bl.BatchNorm_0),
                                   fold_bn(bd.BatchNorm_0)])
                      for bl, bd in tower],
            dilations=(1,) + TOWER_DILATIONS, groups=2)
        y = chain_layer(
            y, [pre.Conv_0.weight] + [_compose_dwsep(b) for b in head_dw]
            + [head.out_weight],
            [fold_bn(pre.BatchNorm_0)] + [fold_bn(b.BatchNorm_0)
                                          for b in head_dw] + [None],
            dilations=(HEAD_DENSE_DILATION,) + HEAD_DILATIONS + (1,),
            two_input=True, out_dtype=torch.float32)
        return y.permute(0, 2, 3, 1)

    def grouped(i):
        """Tower layer i's (affine, dw, pw), stacked left, disparity."""
        return [torch.stack(w) for w in zip(_dwsep_weights(tower[i][0]),
                                            _dwsep_weights(tower[i][1]))]

    # Under bf16 "mxu" and "vpu" every later layer but the output conv runs
    # on a tensor-core route, which reads channels-last: the entry writes
    # it.
    c = cfg.refine_channels
    y = dense_layer(x, entries, dilation=1, groups=2,
                    channels_last=(dw == "mxu" and dtype == torch.bfloat16)
                    or (dw == "vpu" and dwsep_tensor_core_route(
                        dtype, (c, c), TOWER_DILATIONS[:1], 2)))
    if dw == "mxu":
        for (bl, bd), d in zip(tower, TOWER_DILATIONS):
            y = dense_layer(
                y, torch.stack([_compose_dwsep(bl), _compose_dwsep(bd)]),
                dilation=d, groups=2,
                affine=torch.stack([fold_bn(bl.BatchNorm_0),
                                    fold_bn(bd.BatchNorm_0)]))
    elif paired:
        for i in (0, 2):  # pairs (2, 4) and (8, 16)
            y = dwsep2_layer(y, *grouped(i), *grouped(i + 1),
                             dilation1=TOWER_DILATIONS[i],
                             dilation2=TOWER_DILATIONS[i + 1], groups=2)
    else:
        for i, d in enumerate(TOWER_DILATIONS):
            y = dwsep_layer(y, *grouped(i), dilation=d, groups=2)

    y = dense2_layer(y, pre.Conv_0.weight, dilation=HEAD_DENSE_DILATION,
                     affine=fold_bn(pre.BatchNorm_0))
    if dw == "mxu":
        for blk, d in zip(head_dw, HEAD_DILATIONS):
            y = dense_layer(y, _compose_dwsep(blk), dilation=d,
                            affine=fold_bn(blk.BatchNorm_0))
    elif paired:
        for i in (0, 2):  # pairs (8, 4) and (2, 1)
            y = dwsep2_layer(y, *_dwsep_weights(head_dw[i]),
                             *_dwsep_weights(head_dw[i + 1]),
                             dilation1=HEAD_DILATIONS[i],
                             dilation2=HEAD_DILATIONS[i + 1])
    else:
        for blk, d in zip(head_dw, HEAD_DILATIONS):
            y = dwsep_layer(y, *_dwsep_weights(blk), dilation=d)
    y = dense_layer(y, head.out_weight.to(dtype), dilation=1,
                    out_dtype=torch.float32)
    return y.permute(0, 2, 3, 1)


def _hwio(weight: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3) -> the JAX (3, 3, Ci, Co)."""
    return weight.permute(2, 3, 1, 0)


def _planar_dwsep(block: PreConvDW):
    """(affine (2, C), taps (3, 3, 1, C), pointwise (Co, C)) of a dw-sep
    layer in the JAX planar path's layout."""
    return (fold_bn(block.BatchNorm_0), _hwio(block.dw_weight),
            block.Conv_0.weight[:, :, 0, 0])


def _dwsep_chain(y: torch.Tensor, blocks, dilations) -> torch.Tensor:
    """A dw-sep chain, one launch per entry of `layer_plan`: a pair where
    the JAX chunk holds the joint halo, else a solo."""
    k = 0
    for step in layer_plan(y.shape[2], y.shape[3], dilations):
        if len(step) == 2:
            y = fused_dwsep2(y, *_planar_dwsep(blocks[k]),
                             *_planar_dwsep(blocks[k + 1]),
                             dilation1=step[0], dilation2=step[1])
        else:
            y = fused_dwsep(y, *_planar_dwsep(blocks[k]), dilation=step[0])
        k += len(step)
    return y


def _layers_mode(model, left: torch.Tensor, disp: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The counterpart of the JAX `refine_residual(mode="layers")`."""
    tl, td = model.RefinementTower_0, model.RefinementTower_1
    head = model.RefinementHead_0
    n = len(TOWER_DILATIONS)

    # The bf16 dw-sep layers read channels-last: the entries write it.
    c = model.cfg.refine_channels
    cl = dwsep_tensor_core_route(dtype, (c, c), TOWER_DILATIONS[:1])

    def tower(t, x):
        y = fused_dense(x.permute(0, 3, 1, 2).to(dtype).contiguous(),
                        _hwio(t.Conv_0.weight), dilation=1, channels_last=cl)
        return _dwsep_chain(y, [getattr(t, f"PreConvDW_{i}")
                                for i in range(n)], TOWER_DILATIONS)

    y_l, y_d = tower(tl, left), tower(td, disp)
    pre = head.PreConv_0
    dense, aff0 = _hwio(pre.Conv_0.weight), fold_bn(pre.BatchNorm_0)
    c = y_l.shape[1]
    y = (fused_dense(y_l, dense[:, :, :c], dilation=HEAD_DENSE_DILATION,
                     affine=aff0[:, :c])
         + fused_dense(y_d, dense[:, :, c:], dilation=HEAD_DENSE_DILATION,
                       affine=aff0[:, c:]))
    y = _dwsep_chain(y, [getattr(head, f"PreConvDW_{i}")
                         for i in range(len(HEAD_DILATIONS))],
                     HEAD_DILATIONS)
    y = fused_dense(y, _hwio(head.out_weight), dilation=1)
    return y.permute(0, 2, 3, 1).float()
