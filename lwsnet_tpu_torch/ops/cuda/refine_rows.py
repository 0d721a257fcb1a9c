"""Dense dilated 3x3 convs of the stage-4 refinement on the Hopper kernel.

Counterpart of `dense_layer` and `dense2_layer` in the JAX package's
`ops/pallas/refine_rows.py`. The JAX row canvas exists for the TPU's
layout; here activations are plain NCHW tensors.

`dense3x3` is the kernel wrapper: it launches the CUDA kernel for a CUDA
tensor and runs `dense3x3_plain`, beside it here, for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lwsnet_tpu_torch.ops.cuda.build import (DENSE3X3, check, on_card,
                                             symbol_suffix)


def _conv_plain(x, wt, affine, dilation):
    """Grouped conv of one input, float32 arithmetic; the activation is
    rounded to x's dtype, as the module path rounds it. x: (B, Ci, H, W);
    wt: (G, Co, Ci, 3, 3); affine: (G, 2, Ci) or None."""
    G = wt.shape[0]
    per = x.shape[0] // G
    outs = []
    for g in range(G):
        xg = x[g * per:(g + 1) * per].float()
        if affine is not None:
            a, s = affine[g, 0], affine[g, 1]
            xg = F.relu(xg * a.view(1, -1, 1, 1) + s.view(1, -1, 1, 1))
            xg = xg.to(x.dtype).float()
        outs.append(F.conv2d(xg, wt[g].float(), padding=dilation,
                             dilation=dilation))
    return torch.cat(outs, 0)


def dense3x3_plain(x: torch.Tensor, wt: torch.Tensor, *, dilation: int,
                   affine: Optional[torch.Tensor] = None,
                   x2: Optional[torch.Tensor] = None,
                   wt2: Optional[torch.Tensor] = None,
                   affine2: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dilated 3x3 conv, padding = dilation, of relu(x * a + s) rounded to
    x's dtype (or of x when `affine` is None), plus the same over
    (x2, wt2, affine2) when x2 is given. Batch b uses weight set
    b // (B // G). Float32 arithmetic on the compute-dtype operands, result
    in `out_dtype` (default x's).

    x, x2: (B, Ci, H, W); wt, wt2: (G, Co, Ci, 3, 3) in x's dtype;
    affine, affine2: (G, 2, Ci) float32. Returns (B, Co, H, W).
    """
    y = _conv_plain(x, wt, affine, dilation)
    if x2 is not None:
        y = y + _conv_plain(x2, wt2, affine2, dilation)
    return y.to(out_dtype or x.dtype)


def dense3x3(x: torch.Tensor, wt: torch.Tensor, *, dilation: int,
             affine: Optional[torch.Tensor] = None,
             x2: Optional[torch.Tensor] = None,
             wt2: Optional[torch.Tensor] = None,
             affine2: Optional[torch.Tensor] = None,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The dense3x3 kernel; arguments as `dense3x3_plain`."""
    if not on_card(x):
        return dense3x3_plain(x, wt, dilation=dilation, affine=affine, x2=x2,
                              wt2=wt2, affine2=affine2, out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    B, Ci, H, W = x.shape
    G, Co = wt.shape[0], wt.shape[1]
    dev, dt = x.device, x.dtype
    if B % G:
        raise ValueError(f"batch {B} not divisible by {G} weight groups")
    if out_dtype != dt and not (dt == torch.bfloat16
                                and out_dtype == torch.float32):
        raise TypeError(f"no {dt} -> {out_dtype} dense3x3 kernel")

    def operands(xi, wi, ai, name):
        """(x, affine, weight) pointers; the weight re-laid (G, Ci, 9, Co)."""
        check(xi, name, (B, Ci, H, W), dt, dev)
        check(wi, f"{name} weight", (G, Co, Ci, 3, 3), dt, dev)
        if ai is not None:
            check(ai, f"{name} affine", (G, 2, Ci), torch.float32, dev)
        wk = wi.permute(0, 2, 3, 4, 1).reshape(G, Ci, 9, Co).contiguous()
        return wk, (xi.data_ptr(), None if ai is None else ai.data_ptr(),
                    wk.data_ptr())

    wk1, first = operands(x, wt, affine, "x")
    wk2, second = None, (None, None, None)
    if x2 is not None:
        wk2, second = operands(x2, wt2, affine2, "x2")
    y = torch.empty((B, Co, H, W), dtype=out_dtype, device=dev)
    symbol = f"dense3x3_{symbol_suffix(dt)}"
    if out_dtype != dt:
        symbol += "_f32out"
    DENSE3X3.launch(symbol, dev, *first, *second, y.data_ptr(),
                    B, G, Ci, Co, H, W, dilation, dual=x2 is not None)
    return y


def _grouped(t: torch.Tensor, base_ndim: int, groups: int) -> torch.Tensor:
    """Give a weight operand its leading (G, ...) group axis."""
    if t.dim() == base_ndim:
        if groups != 1:
            raise ValueError(f"{tuple(t.shape)}: no group axis for "
                             f"groups={groups}")
        return t[None]
    if t.shape[0] != groups:
        raise ValueError(f"{tuple(t.shape)}: expected {groups} groups")
    return t


def dense_layer(x: torch.Tensor, kernel: torch.Tensor, *, dilation: int,
                affine: Optional[torch.Tensor] = None, groups: int = 1,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense dilated 3x3 conv, optionally preceded by a folded BN affine +
    ReLU. x: (B, Ci, H, W); kernel: ([G,] Co, Ci, 3, 3), any float dtype,
    cast once to x's; affine: ([G,] 2, Ci). Returns (B, Co, H, W)."""
    wt = _grouped(kernel, 4, groups).to(x.dtype)
    if affine is not None:
        affine = _grouped(affine, 2, groups).float().contiguous()
    return dense3x3(x, wt.contiguous(), dilation=dilation, affine=affine,
                    out_dtype=out_dtype)


def dense2_layer(x: torch.Tensor, kernel: torch.Tensor, *, dilation: int,
                 affine: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense dilated 3x3 conv over the channel concatenation of the two
    batch halves of x, without forming the concat:
    conv(concat(A, B)) = conv_A(A) + conv_B(B), each half with its own
    BN affine + ReLU. x: (2B, Ci, H, W); kernel: (Co, 2*Ci, 3, 3);
    affine: (2, 2*Ci). Returns (B, Co, H, W)."""
    B2, Ci = x.shape[0], x.shape[1]
    if B2 % 2:
        raise ValueError(f"batch {B2} is not two halves")
    B = B2 // 2
    wt = kernel.to(x.dtype)
    aff = affine.float()
    return dense3x3(
        x[:B], wt[None, :, :Ci].contiguous(), dilation=dilation,
        affine=aff[None, :, :Ci].contiguous(), x2=x[B:],
        wt2=wt[None, :, Ci:].contiguous(),
        affine2=aff[None, :, Ci:].contiguous(), out_dtype=out_dtype)
