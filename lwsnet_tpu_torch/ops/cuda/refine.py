"""The planar per-layer stage-4 refinement layers on the Hopper kernels.

Counterpart of the JAX package's `ops/pallas/refine.py` (the path of
`pallas_mode="layers"`): `fused_dense`, `fused_dwsep` and `fused_dwsep2`
take the JAX arguments (HWIO kernels, (3, 3, 1, C) depthwise taps, (Co, C)
pointwise weights, (2, C) folded BN affines) on plain NCHW tensors, and
return NCHW in x's dtype. Each routes to a hand-written kernel that
computes its function, so no kernel of its own is needed:

* `fused_dense` (all three JAX bodies: the im2col stack for 9 * Ci <= 48,
  the per-tap accumulation, the Co = 1 scalar form) -> `dense3x3`;
* `fused_dwsep` -> `dwsep3x3`;
* `fused_dwsep2` -> the `dwsep3x3` pair kernel.

On the card each launch writes the layout the next one reads, as the
refinement's route rule (`models/refine_kernels.refine_routes`) says:
e.g. the bf16 32-channel dw-sep layers read and write channels-last memory
(`dwsep_tensor_core_route`), so the "layers" path asks the tower entries to
write it (`fused_dense(channels_last=True)`).

The JAX layer canvas (`layer_canvas`, `layer_uncanvas`: a top pad of one
row chunk, 128-lane aligned width, garbage rows outside the image that
every kernel masks) is a TPU layout device and has no counterpart here:
the kernels take the image itself and zero-pad at its edges. The row chunk
survives only as the rule that pairs dw-sep layers (`layer_plan`), so that
the port pairs exactly the layers the JAX package pairs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from lwsnet_tpu_torch.ops.cuda.refine_rows import dense3x3, dwsep, dwsep2


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def pick_layer_chunk(h: int, w: int, max_channels: int,
                     dtype_bytes: int = 2,
                     budget: int = 80 * 1024 * 1024) -> int:
    """The JAX package's row chunk of the planar path, copied as it is: the
    largest chunk whose TPU window buffers fit its VMEM budget. Raises
    ValueError where the JAX package does (a 128-aligned width over 7296
    at 32 channels)."""
    wc = -(-w // 128) * 128
    for chunk in (192, 160, 128, 96, 64, 48, 32, 16):
        blocks = 14 * max_channels * chunk * wc * dtype_bytes
        if blocks <= 100 * 1024 * 1024:
            return chunk
    raise ValueError("no layer chunk fits VMEM")


def layer_plan(h: int, w: int, dilations: Sequence[int],
               channels: int) -> Tuple[Tuple[int, ...], ...]:
    """The launches of a dw-sep chain of `channels` (the refinement's
    width, `refine_channels`) at an h x w image, as the JAX `_dwsep_chain`
    makes them with the chunk the JAX package picks for that width
    (`refine_pallas.py`: `pick_layer_chunk(H, W, refine_channels)`): two
    consecutive layers fuse into one pair when the chunk holds their joint
    halo (chunk >= round8(d1 + d2)), else the first runs alone. Returns a
    tuple of (d,) solos and (d1, d2) pairs, e.g. ((2, 4), (8,), (16,)) for
    the 32-channel tower at 96 x 3712. Raises ValueError where the JAX
    package finds no chunk."""
    chunk = pick_layer_chunk(h, w, channels)
    plan, k = [], 0
    while k < len(dilations):
        if (k + 1 < len(dilations)
                and chunk >= _round8(dilations[k] + dilations[k + 1])):
            plan.append((dilations[k], dilations[k + 1]))
            k += 2
        else:
            plan.append((dilations[k],))
            k += 1
    return tuple(plan)


def _dense_weight(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(3, 3, Ci, Co) HWIO -> dense3x3's (1, Co, Ci, 3, 3)."""
    return kernel.permute(3, 2, 0, 1)[None].to(dtype).contiguous()


def _dwsep_operands(x: torch.Tensor, affine: torch.Tensor,
                    dwk: torch.Tensor, pwk: torch.Tensor):
    """(dw (1, C, 3, 3), pw (1, Co, C), affine (1, 2, C)) for dwsep3x3:
    the taps and pointwise weights in x's dtype, the affine in float32."""
    dw = dwk[:, :, 0, :].permute(2, 0, 1)[None].to(x.dtype).contiguous()
    return (dw, pwk[None].to(x.dtype).contiguous(),
            affine[None].float().contiguous())


def fused_dense(x: torch.Tensor, kernel: torch.Tensor, *, dilation: int,
                affine: Optional[torch.Tensor] = None,
                channels_last: bool = False) -> torch.Tensor:
    """[BN-affine + ReLU +] dense dilated 3x3 conv, padding = dilation.

    x: (B, Ci, H, W); kernel: (3, 3, Ci, Co) HWIO, cast to x's dtype;
    affine: optional (2, Ci) folded BN. Returns (B, Co, H, W) in x's dtype,
    as every JAX body writes it (the Co = 1 output conv included); on the
    card channels-last in memory where `dense3x3` computes it so or
    `channels_last` asks."""
    return dense3x3(x, _dense_weight(kernel, x.dtype), dilation=dilation,
                    affine=(None if affine is None
                            else affine[None].float().contiguous()),
                    channels_last=channels_last)


def fused_dwsep(x: torch.Tensor, affine: torch.Tensor, dwk: torch.Tensor,
                pwk: torch.Tensor, *, dilation: int,
                channels_last: bool = False) -> torch.Tensor:
    """BN-affine + ReLU + depthwise dilated 3x3 + pointwise 1x1.

    x: (B, C, H, W); affine: (2, C); dwk: (3, 3, 1, C) HWIO taps; pwk:
    (Co, C). Returns (B, Co, H, W) in x's dtype; on the card channels-last
    in memory as `dwsep` says."""
    dw, pw, aff = _dwsep_operands(x, affine, dwk, pwk)
    return dwsep(x, dw, pw, dilation=dilation, affine=aff,
                 channels_last=channels_last)


def fused_dwsep2(x: torch.Tensor, affine1: torch.Tensor, dwk1: torch.Tensor,
                 pwk1: torch.Tensor, affine2: torch.Tensor,
                 dwk2: torch.Tensor, pwk2: torch.Tensor, *, dilation1: int,
                 dilation2: int, channels_last: bool = False) -> torch.Tensor:
    """Two `fused_dwsep` layers in one launch (`dwsep2`); arguments as
    `fused_dwsep`, twice. Returns (B, Co2, H, W) in x's dtype."""
    dw1, pw1, a1 = _dwsep_operands(x, affine1, dwk1, pwk1)
    dw2, pw2, a2 = _dwsep_operands(x, affine2, dwk2, pwk2)
    return dwsep2(x, dw1, pw1, dw2, pw2, dilation1=dilation1,
                  dilation2=dilation2, affine1=a1, affine2=a2,
                  channels_last=channels_last)
