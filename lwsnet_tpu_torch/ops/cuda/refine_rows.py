"""The stage-4 refinement layers on the Hopper kernels.

Counterpart of the JAX package's `ops/pallas/refine_rows.py`:
`dense_layer`, `dense2_layer`, `dwsep_layer`, `dwsep2_layer` and
`chain_layer`, with the JAX arguments on plain NCHW tensors. The JAX row
canvas, mask row, canvas geometry and block rows exist for the TPU's
layout and have no counterpart here.

`dense3x3`, `dwsep`, `dwsep2` and `chain` are the kernel wrappers: each
launches its CUDA kernel for a CUDA tensor and runs its `*_plain` twin,
beside it here, for a CPU tensor. Weight groups follow the JAX rule:
batch b uses weight set b // (B // G).

Layout on the card: the tensor-core routes of `dense3x3`
(`dense_tensor_core_route`), of `dwsep` / `dwsep2`
(`dwsep_tensor_core_route`) and of `chain` (`chain_tensor_core_route`)
read and write channels-last memory, (B, H, W, C) under the logical
(B, C, H, W) shape; `dense3x3`'s narrow-entry route (`dense_entry_route`)
reads NCHW and writes channels-last, its narrow-output route
(`dense_output_route`) reads channels-last and writes (B, Co, H, W), its
float32 route (`dense_f32_route`) reads channels-last and writes either
layout, and its CUDA-core route reads either layout (channels-last where
Ci % 8 == 0) and writes channels-last when asked. The tile body of `dwsep` / `dwsep2`
(any width, `dwsep_route`) reads the default layout and writes
channels-last when asked; `chain`'s read and write the default layout.
The refinement's route rule (`models/refine_kernels.refine_routes`) says
which layout each launch of a forward writes: the one its next launch
reads (under bf16 at 32 channels, channels-last from the "mxu" and "vpu"
engines' entry to the output conv; "chain"'s tower reads its 3-channel
input NCHW and writes channels-last, which the head reads). Each copy is
`build.in_layout`'s, counted. The plain versions take any layout.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from lwsnet_tpu_torch.ops.cuda.build import (CHAIN3X3, DENSE3X3, DWSEP3X3,
                                             DWSEP3X3_PAIR, check, empty,
                                             in_layout, lies_channels_last,
                                             on_card, symbol_suffix)
from lwsnet_tpu_torch.ops.cuda.costfilter import CUDA_CORES, TENSOR_CORES

# `dwsep3x3`'s tile body in bf16: the depthwise taps on the CUDA cores, the
# pointwise product on mma.sync tensor cores (`dwsep_route`); its launches
# count as "dwsep3x3[mma]" / "dwsep3x3_pair[mma]", the float32 body's as
# "[cores]".
MMA = "mma"
# `dense3x3`'s float32 route (`dense_f32_route`): its launches count as
# "dense3x3[f32]".
F32 = "f32"


def ring_stages(elem_bytes: int, Ci: int, dilation: int, inputs: int,
                groups: int) -> int:
    """The stages of the ring of staged jobs that `dense3x3`'s bf16
    tensor-core route (elem_bytes 2) and its float32 route (4) keep beside
    their resident weights (`dense_tc::ring_stages` in
    csrc/dense3x3_tc.cuh), at 32 outputs; 0 where the route refuses the
    shape: fewer stages than it needs (4 / 2), or no more than a tile has
    jobs (inputs x channel slabs), which its two product groups' waits
    need."""
    r, tw, smem_max, max_stages = 4, 64, 232448, 8
    if elem_bytes == 2:
        sc, wbytes, min_stages = (32 if Ci % 32 == 0 else 16,
                                  9 * Ci // 16 * 16 * 32 * 2, 4)
    else:
        sc, wbytes, min_stages = 16 if Ci % 16 == 0 else 8, Ci * 9 * 32 * 4, 2
    sets = groups * inputs
    fixed = sets * (wbytes + 2 * Ci * 4) + 512
    row = (tw + 2 * dilation + 7) // 8 * 8
    n = min((smem_max - fixed - 1024) // ((r + 2) * row * sc * elem_bytes),
            max_stages)
    return 0 if n < min_stages or n <= inputs * Ci // sc else n


def dense_tensor_core_route(dtype: torch.dtype, Ci: int, Co: int,
                            dilation: int, inputs: int = 1,
                            groups: int = 1) -> bool:
    """Whether `dense3x3` runs its wgmma route, which reads and writes
    channels-last only (`dense_tc::use` in csrc/dense3x3_tc.cuh): bf16,
    32 output channels, whole 16-channel chunks, a dilation the staged halo
    holds, weights that stay resident in shared memory, and a ring of
    staged jobs beside them (`ring_stages`)."""
    return (dtype == torch.bfloat16 and Co == 32 and Ci % 16 == 0
            and 1 <= dilation <= 16 and Ci * inputs * groups <= 128
            and ring_stages(2, Ci, dilation, inputs, groups) > 0)


def dense_f32_route(dtype: torch.dtype, Ci: int, Co: int, dilation: int,
                    inputs: int = 1, groups: int = 1) -> bool:
    """Whether `dense3x3` runs its float32 route, which reads channels-last
    and writes either layout (`dense_f32::use` in csrc/dense3x3_f32.cuh):
    float32, 32 output channels, whole 8-channel slabs, a dilation the
    staged rows hold, one or two inputs, at most two weight groups,
    weights that stay resident in shared memory, and a ring of staged jobs
    beside them (`ring_stages`). Float32 FMAs on the CUDA cores, not
    TF32."""
    return (dtype == torch.float32 and Co == 32 and Ci >= 8 and Ci % 8 == 0
            and 1 <= dilation <= 16 and 1 <= inputs <= 2
            and 1 <= groups <= 2 and Ci * inputs * groups <= 128
            and ring_stages(4, Ci, dilation, inputs, groups) > 0)


def dense_entry_route(dtype: torch.dtype, Ci: int, Co: int, dilation: int,
                      inputs: int = 1, groups: int = 1) -> bool:
    """Whether `dense3x3` runs its narrow-entry route, which reads NCHW and
    writes channels-last only (`dense_entry::use` in
    csrc/dense3x3_entry.cuh): bf16, one input whose Ci x 9 taps fit one
    K = 32 product (Ci <= 3), 32 outputs, a dilation the staged rows hold,
    at most two weight groups."""
    return (dtype == torch.bfloat16 and inputs == 1 and 1 <= Ci
            and Ci * 9 <= 32 and Co == 32 and 1 <= dilation <= 16
            and 1 <= groups <= 2)


def dense_output_route(dtype: torch.dtype, Ci: int, Co: int, dilation: int,
                       inputs: int = 1, groups: int = 1) -> bool:
    """Whether `dense3x3` runs its narrow-output route, which reads
    channels-last and writes (B, Co, H, W) only (`dense_tc::use_narrow` in
    csrc/dense3x3_tc.cuh): the 32-output route's shapes with one input and
    at most 8 outputs (wgmma m64n8k16, the weights zero-padded to 8 by
    the kernel's blocks)."""
    return (inputs == 1 and 1 <= Co <= 8
            and dense_tensor_core_route(dtype, Ci, 32, dilation, inputs,
                                        groups))


def dwsep_tensor_core_route(dtype: torch.dtype, channels: Sequence[int],
                            dilations: Sequence[int],
                            groups: int = 1) -> bool:
    """Whether `dwsep` (channels (C, Co), dilations (d,)) or `dwsep2`
    ((C, Cm, Co), (d1, d2)) runs its wgmma route, which reads and writes
    channels-last only (`dwsep_tc::use` in csrc/dwsep3x3_tc.cuh): bf16, C
    = 16 or 32, a 32-channel intermediate, 32 outputs, dilations the staged
    halo holds, and at most two weight groups resident in shared
    memory."""
    C, *mid, Co = channels
    return (dtype == torch.bfloat16 and C in (16, 32) and Co == 32
            and all(m == 32 for m in mid)
            and len(dilations) == len(channels) - 1
            and all(1 <= d <= 16 for d in dilations) and 1 <= groups <= 2)


def dwsep_route(dtype: torch.dtype, channels: Sequence[int],
                dilations: Sequence[int], groups: int = 1) -> str:
    """The route of `dwsep` (channels (C, Co), dilations (d,)) or `dwsep2`
    ((C, Cm, Co), (d1, d2)) on the card: TENSOR_CORES (the wgmma route,
    `dwsep_tensor_core_route`, channels-last in and out), else the tile
    body of csrc/dwsep3x3.cu (NCHW in, either layout out), MMA in bf16
    (the pointwise product on mma.sync) and CUDA_CORES in float32."""
    if dwsep_tensor_core_route(dtype, channels, dilations, groups):
        return TENSOR_CORES
    return MMA if dtype == torch.bfloat16 else CUDA_CORES


def dwsep_counted(route: str) -> Optional[str]:
    """The name `build.route_counts()` counts a dw-sep launch of `route`
    under (none for the wgmma route)."""
    return {MMA: MMA, CUDA_CORES: "cores"}.get(route)


def _narrow_entry(cis: Sequence[int], cos: Sequence[int],
                  two_input: bool) -> bool:
    """Whether a `chain` stack opens with a narrow entry: one input of at
    most 3 channels (its taps fit one K = 32 product), 32 outputs."""
    return not two_input and cis[0] * 9 <= 32 and cos[0] == 32


def chain_tensor_core_route(dtype: torch.dtype, cis: Sequence[int],
                            cos: Sequence[int], dilations: Sequence[int],
                            groups: int = 1, two_input: bool = False) -> bool:
    """Whether `chain` runs the stack (layer i: cis[i] -> cos[i] channels
    at dilations[i]) on its tensor-core route, one cooperative launch on
    channels-last scratch (`chain_tc::use` in csrc/chain3x3.cu): bf16, 2
    to 8 layers, each with whole 32-channel input slabs on `dense3x3`'s
    tensor-core shapes, with 32 outputs or, in the last layer, at most 8
    (the head's 32 -> 1, zero-padded to 8), but a narrow entry first (the
    tower's 3 -> 32)."""
    n = len(cis)
    if dtype != torch.bfloat16 or not 2 <= n <= 8:
        return False
    for i, (ci, co, d) in enumerate(zip(cis, cos, dilations)):
        inputs = 2 if two_input and i == 0 else 1
        if ((co == 32 or (i == n - 1 and co <= 8)) and ci % 32 == 0
                and dense_tensor_core_route(dtype, ci, 32, d, inputs,
                                            groups)):
            continue
        if i == 0 and d >= 1 and _narrow_entry(cis, cos, two_input):
            continue
        return False
    return True


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
             out_dtype: Optional[torch.dtype] = None,
             channels_last: bool = False) -> torch.Tensor:
    """The dense3x3 kernel; arguments as `dense3x3_plain`. On the card the
    tensor-core, narrow-output and float32 routes read channels-last, the
    narrow-entry route NCHW, the CUDA cores x's layout where Ci % 8 == 0
    and NCHW otherwise (x and x2 are copied where they lie otherwise); the
    result lies channels-last where the tensor-core or narrow-entry route
    computes it or `channels_last` asks. The narrow-output route writes
    (B, Co, H, W) only: asking it for channels-last raises where Co > 1."""
    if not on_card(x):
        return dense3x3_plain(x, wt, dilation=dilation, affine=affine, x2=x2,
                              wt2=wt2, affine2=affine2, out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    B, Ci, H, W = x.shape
    G, Co = wt.shape[0], wt.shape[1]
    dev, dt = x.device, x.dtype
    if B % G:
        raise ValueError(f"batch {B} not divisible by {G} weight groups")
    _check_out_dtype(dt, out_dtype, "dense3x3")
    inputs = 1 if x2 is None else 2
    tensor_core = dense_tensor_core_route(dt, Ci, Co, dilation, inputs, G)
    output = dense_output_route(dt, Ci, Co, dilation, inputs, G)
    entry = dense_entry_route(dt, Ci, Co, dilation, inputs, G)
    f32 = dense_f32_route(dt, Ci, Co, dilation, inputs, G)
    if output and channels_last and Co > 1:
        raise ValueError("dense3x3: the narrow-output route writes "
                         "(B, Co, H, W) only")
    x_cl = (tensor_core or output or f32
            or (Ci % 8 == 0 and lies_channels_last(x)))
    y_cl = tensor_core or entry or (channels_last and not output)
    route = ("entry" if entry else "output" if output else F32 if f32
             else None)

    def operands(xi, wi, ai, name):
        """The tensors (x in the route's layout, the weight re-laid for
        the route), kept alive until the launch, and the (x, affine,
        weight) pointers."""
        xi = in_layout(xi, x_cl)
        check(xi, name, (B, Ci, H, W), dt, dev, x_cl)
        check(wi, f"{name} weight", (G, Co, Ci, 3, 3), dt, dev)
        if ai is not None:
            check(ai, f"{name} affine", (G, 2, Ci), torch.float32, dev)
        if tensor_core:
            wk = _wgmma_images(wi)
        else:  # the narrow routes lay out their B images themselves
            wk = wi if entry or output else _relayout(wi)
        return (xi, wk), (xi.data_ptr(),
                          None if ai is None else ai.data_ptr(),
                          wk.data_ptr())

    keep1, first = operands(x, wt, affine, "x")
    keep2, second = None, (None, None, None)
    if x2 is not None:
        keep2, second = operands(x2, wt2, affine2, "x2")
    y = empty((B, Co, H, W), out_dtype, dev, y_cl)
    symbol = f"dense3x3_{symbol_suffix(dt)}"
    if out_dtype != dt:
        symbol += "_f32out"
    DENSE3X3.launch(symbol, dev, *first, *second, y.data_ptr(),
                    B, G, Ci, Co, H, W, dilation, x_cl, y_cl,
                    dual=x2 is not None, route=route)
    return y


def _check_out_dtype(dt: torch.dtype, out_dtype: torch.dtype,
                     kernel: str) -> None:
    if out_dtype != dt and not (dt == torch.bfloat16
                                and out_dtype == torch.float32):
        raise TypeError(f"no {dt} -> {out_dtype} {kernel} kernel")


def _relayout(wt: torch.Tensor) -> torch.Tensor:
    """(G, Co, Ci, 3, 3) -> the CUDA-core kernels' (G, Ci, 9, Co)."""
    G, Co, Ci = wt.shape[:3]
    return wt.permute(0, 2, 3, 4, 1).reshape(G, Ci, 9, Co).contiguous()


def _wgmma_images(wt: torch.Tensor) -> torch.Tensor:
    """(G, 32, Ci, 3, 3) -> the tensor-core route's resident B images:
    per (g, ci // 16, tap) a 16 x 32 K-major slice as 8 x 8 core matrices,
    (G, Ci/16, 9, co // 8, ci % 16 // 8, co % 8, ci % 8) (csrc/tc.cuh)."""
    G, Co, Ci = wt.shape[:3]
    return wt.reshape(G, Co // 8, 8, Ci // 16, 2, 8, 9).permute(
        0, 3, 6, 1, 4, 2, 5).contiguous()


def _pad_outputs(wt: torch.Tensor) -> torch.Tensor:
    """(G, Co, Ci, 3, 3) with Co <= 8 zero-padded to 8 outputs, the
    narrowest wgmma B image (m64n8k16); other widths as they are."""
    Co = wt.shape[1]
    return wt if Co >= 8 else F.pad(wt, (0, 0, 0, 0, 0, 0, 0, 8 - Co))


def _entry_images(wt: torch.Tensor) -> torch.Tensor:
    """A narrow entry's (G, 32, Ci, 3, 3), Ci <= 3, as the B images of the
    (G, 32, K) pointwise kernel over its taps, K = ci * 9 + tap, padded
    with zeros to 32 (csrc/chain3x3.cu: `entry_run`; dense3x3's
    narrow-entry route lays out the same images in its blocks)."""
    G, Co, Ci = wt.shape[:3]
    return _pw_images(F.pad(wt.reshape(G, Co, Ci * 9), (0, 32 - Ci * 9)))


def _pw_images(pw: torch.Tensor) -> torch.Tensor:
    """(G, 32, C) pointwise weights -> the dw-sep tensor-core route's
    resident B images: per (g, c // 16) a 16 x 32 K-major slice,
    (G, C/16, co // 8, c % 16 // 8, co % 8, c % 8), as `_wgmma_images`."""
    G, Co, C = pw.shape
    return pw.reshape(G, Co // 8, 8, C // 16, 2, 8).permute(
        0, 3, 1, 4, 2, 5).contiguous()


def dwsep_plain(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, *,
                dilation: int, affine: torch.Tensor) -> torch.Tensor:
    """One depthwise-separable layer: act = relu(x * a + s) rounded to x's
    dtype, zero-padded; the dilated depthwise 3x3 of act in float32,
    rounded to x's dtype (the module path's rounding); the pointwise 1x1 in
    float32; result in x's dtype. Batch b uses weight set b // (B // G).

    x: (B, C, H, W); dw: (G, C, 3, 3) and pw: (G, Co, C) in x's dtype;
    affine: (G, 2, C) float32. Returns (B, Co, H, W).
    """
    G, C = dw.shape[0], dw.shape[1]
    per = x.shape[0] // G
    outs = []
    for g in range(G):
        a, s = affine[g, 0].view(1, -1, 1, 1), affine[g, 1].view(1, -1, 1, 1)
        act = F.relu(x[g * per:(g + 1) * per].float() * a + s)
        act = act.to(x.dtype).float()
        t = F.conv2d(act, dw[g].float()[:, None], padding=dilation,
                     dilation=dilation, groups=C)
        t = t.to(x.dtype).float()
        outs.append(F.conv2d(t, pw[g].float()[:, :, None, None]))
    return torch.cat(outs, 0).to(x.dtype)


def dwsep(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, *,
          dilation: int, affine: torch.Tensor,
          channels_last: bool = False) -> torch.Tensor:
    """The dwsep3x3 kernel (one layer); arguments as `dwsep_plain`. On
    the card the tensor-core route reads and writes channels-last, the
    tile body (any C, Co; `dwsep_route`) reads NCHW (x is copied where it
    lies otherwise) and writes NCHW, or channels-last where
    `channels_last` asks."""
    if not on_card(x):
        return dwsep_plain(x, dw, pw, dilation=dilation, affine=affine)
    B, C, H, W = x.shape
    G, Co = pw.shape[0], pw.shape[1]
    dev, dt = x.device, x.dtype
    if B % G:
        raise ValueError(f"batch {B} not divisible by {G} weight groups")
    route = dwsep_route(dt, (C, Co), (dilation,), G)
    cl = route == TENSOR_CORES
    y_cl = cl or channels_last
    x = in_layout(x, cl)
    check(x, "x", (B, C, H, W), dt, dev, cl)
    check(dw, "dw", (G, C, 3, 3), dt, dev)
    check(pw, "pw", (G, Co, C), dt, dev)
    check(affine, "affine", (G, 2, C), torch.float32, dev)
    pk = _pw_images(pw) if cl else pw
    y = empty((B, Co, H, W), dt, dev, y_cl)
    DWSEP3X3.launch(f"dwsep3x3_{symbol_suffix(dt)}", dev, x.data_ptr(),
                    affine.data_ptr(), dw.data_ptr(), pk.data_ptr(),
                    y.data_ptr(), B, G, C, Co, H, W, dilation, cl, y_cl,
                    route=dwsep_counted(route))
    return y


def dwsep2_plain(x: torch.Tensor, dw1: torch.Tensor, pw1: torch.Tensor,
                 dw2: torch.Tensor, pw2: torch.Tensor, *, dilation1: int,
                 dilation2: int, affine1: torch.Tensor,
                 affine2: torch.Tensor) -> torch.Tensor:
    """Two consecutive `dwsep_plain` layers."""
    y = dwsep_plain(x, dw1, pw1, dilation=dilation1, affine=affine1)
    return dwsep_plain(y, dw2, pw2, dilation=dilation2, affine=affine2)


def dwsep2(x: torch.Tensor, dw1: torch.Tensor, pw1: torch.Tensor,
           dw2: torch.Tensor, pw2: torch.Tensor, *, dilation1: int,
           dilation2: int, affine1: torch.Tensor, affine2: torch.Tensor,
           channels_last: bool = False) -> torch.Tensor:
    """The dwsep3x3 pair kernel: both layers in one launch; arguments as
    `dwsep2_plain`. The layouts as `dwsep`'s. Both routes pass the
    intermediate through a scratch tensor, channels-last on the
    tensor-core route and NCHW on the tile body, in one cooperative launch
    with a grid-wide barrier between the layers."""
    if not on_card(x):
        return dwsep2_plain(x, dw1, pw1, dw2, pw2, dilation1=dilation1,
                            dilation2=dilation2, affine1=affine1,
                            affine2=affine2)
    B, C, H, W = x.shape
    G, Cm, Co = pw1.shape[0], pw1.shape[1], pw2.shape[1]
    dev, dt = x.device, x.dtype
    if B % G:
        raise ValueError(f"batch {B} not divisible by {G} weight groups")
    route = dwsep_route(dt, (C, Cm, Co), (dilation1, dilation2), G)
    cl = route == TENSOR_CORES
    y_cl = cl or channels_last
    x = in_layout(x, cl)
    check(x, "x", (B, C, H, W), dt, dev, cl)
    check(dw1, "dw1", (G, C, 3, 3), dt, dev)
    check(pw1, "pw1", (G, Cm, C), dt, dev)
    check(affine1, "affine1", (G, 2, C), torch.float32, dev)
    check(dw2, "dw2", (G, Cm, 3, 3), dt, dev)
    check(pw2, "pw2", (G, Co, Cm), dt, dev)
    check(affine2, "affine2", (G, 2, Cm), torch.float32, dev)
    pk1, pk2 = (_pw_images(pw1), _pw_images(pw2)) if cl else (pw1, pw2)
    mid = empty((B, Cm, H, W), dt, dev, cl)
    y = empty((B, Co, H, W), dt, dev, y_cl)
    DWSEP3X3_PAIR.launch(
        f"dwsep3x3_pair_{symbol_suffix(dt)}", dev, x.data_ptr(),
        affine1.data_ptr(), dw1.data_ptr(), pk1.data_ptr(),
        affine2.data_ptr(), dw2.data_ptr(), pk2.data_ptr(), y.data_ptr(),
        B, G, C, Cm, Co, H, W, dilation1, dilation2, mid.data_ptr(), cl,
        y_cl, route=dwsep_counted(route))
    return y


def chain_plain(x: torch.Tensor, wts: Sequence[torch.Tensor],
                affs: Sequence[Optional[torch.Tensor]], *,
                dilations: Sequence[int], x2: Optional[torch.Tensor] = None,
                wt2: Optional[torch.Tensor] = None,
                aff2: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """N `dense3x3_plain` layers: layer i convolves the previous layer's
    output, rounded to x's dtype, with wts[i] at dilations[i] after the
    pre-activation affs[i] (none when None); layer 0 also sums the second
    input (x2, wt2, aff2) when x2 is given; the last layer's result is in
    `out_dtype` (default x's). Shapes as `dense3x3_plain`, per layer."""
    y, n = x, len(wts)
    for i in range(n):
        second = dict(x2=x2, wt2=wt2, affine2=aff2) if i == 0 else {}
        y = dense3x3_plain(y, wts[i], dilation=dilations[i], affine=affs[i],
                           out_dtype=out_dtype if i == n - 1 else None,
                           **second)
    return y


def _pointers(ctype, values):
    return (ctype * len(values))(*values)


# The grid barrier words of `chain3x3`'s tensor-core route, one pair per
# (device, stream), so that launches sharing them never overlap; each
# barrier leaves them as it found the first (csrc/tc.cuh: `grid_sync`).
_GRID_BARRIERS = {}


def _grid_barrier(dev: torch.device) -> torch.Tensor:
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _GRID_BARRIERS:
        _GRID_BARRIERS[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _GRID_BARRIERS[key]


def chain(x: torch.Tensor, wts: Sequence[torch.Tensor],
          affs: Sequence[Optional[torch.Tensor]], *,
          dilations: Sequence[int], x2: Optional[torch.Tensor] = None,
          wt2: Optional[torch.Tensor] = None,
          aff2: Optional[torch.Tensor] = None,
          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The chain3x3 kernel: every layer in one cooperative launch, the
    intermediates in two ping-pong scratch tensors of x's dtype; arguments
    as `chain_plain`. On the tensor-core route (`chain_tensor_core_route`)
    the scratch is channels-last; the first layer reads x and x2
    channels-last, or NCHW where it is a narrow entry; a last layer of 32
    outputs writes channels-last. Elsewhere every tensor is NCHW. x and x2
    are copied where they lie otherwise."""
    if not on_card(x):
        return chain_plain(x, wts, affs, dilations=dilations, x2=x2,
                           wt2=wt2, aff2=aff2, out_dtype=out_dtype)
    n = len(wts)
    if not 1 <= n == len(affs) == len(dilations):
        raise ValueError(f"{n} weights, {len(affs)} affines and "
                         f"{len(dilations)} dilations for one chain")
    out_dtype = out_dtype or x.dtype
    B, _, H, W = x.shape
    G = wts[0].shape[0]
    dev, dt = x.device, x.dtype
    if B % G:
        raise ValueError(f"batch {B} not divisible by {G} weight groups")
    _check_out_dtype(dt, out_dtype, "chain3x3")
    cis, cos = [], []
    for i, (wt, aff) in enumerate(zip(wts, affs)):
        Co, Ci = wt.shape[1], wt.shape[2]
        check(wt, f"weight {i}", (G, Co, Ci, 3, 3), dt, dev)
        if i and Ci != cos[-1]:
            raise ValueError(f"layer {i} takes {Ci} channels, layer {i - 1} "
                             f"gives {cos[-1]}")
        if aff is not None:
            check(aff, f"affine {i}", (G, 2, Ci), torch.float32, dev)
        cis.append(Ci)
        cos.append(Co)
    tc = chain_tensor_core_route(dt, cis, cos, dilations, G,
                                 x2 is not None)
    entry = tc and _narrow_entry(cis, cos, x2 is not None)
    if tc:
        wks = [_entry_images(wt) if entry and i == 0
               else _wgmma_images(_pad_outputs(wt))
               for i, wt in enumerate(wts)]
    else:
        wks = [_relayout(wt) for wt in wts]
    aps = [None if aff is None else aff.data_ptr() for aff in affs]
    x_cl = tc and not entry
    x = in_layout(x, x_cl)
    check(x, "x", (B, cis[0], H, W), dt, dev, x_cl)
    second = (None, None, None)
    if x2 is not None:
        x2 = in_layout(x2, x_cl)
        check(x2, "x2", tuple(x.shape), dt, dev, x_cl)
        check(wt2, "weight 0, second input", tuple(wts[0].shape), dt, dev)
        if aff2 is not None:
            check(aff2, "affine 0, second input", (G, 2, cis[0]),
                  torch.float32, dev)
        wk2 = _wgmma_images(wt2) if tc else _relayout(wt2)
        second = (x2.data_ptr(), None if aff2 is None else aff2.data_ptr(),
                  wk2.data_ptr())
    if tc:
        scratch = [empty((B, cos[0], H, W), dt, dev, True)
                   for _ in range(min(2, n - 1))]
    else:
        scratch = [torch.empty(B * max(cos[:-1]) * H * W, dtype=dt,
                               device=dev) for _ in range(min(2, n - 1))]
    y = empty((B, cos[-1], H, W), out_dtype, dev, tc and cos[-1] > 8)
    outs = [scratch[i % 2] for i in range(n - 1)] + [y]
    ins = [x] + outs[:-1]
    symbol = f"chain3x3_{symbol_suffix(dt)}"
    if out_dtype != dt:
        symbol += "_f32out"
    ptrs = [_pointers(ctypes.c_void_p, v) for v in (
        [t.data_ptr() for t in ins], aps, [w.data_ptr() for w in wks])]
    CHAIN3X3.launch(
        symbol, dev, n, *ptrs, *second,
        _pointers(ctypes.c_void_p, [t.data_ptr() for t in outs]),
        _pointers(ctypes.c_int, cis), _pointers(ctypes.c_int, cos),
        _pointers(ctypes.c_int, list(dilations)), B, G, H, W, int(tc),
        _grid_barrier(dev).data_ptr() if tc else None, dual=x2 is not None)
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
                out_dtype: Optional[torch.dtype] = None,
                channels_last: bool = False) -> torch.Tensor:
    """Dense dilated 3x3 conv, optionally preceded by a folded BN affine +
    ReLU. x: (B, Ci, H, W); kernel: ([G,] Co, Ci, 3, 3), any float dtype,
    cast once to x's; affine: ([G,] 2, Ci). Returns (B, Co, H, W), on the
    card channels-last in memory as `dense3x3` says."""
    wt = _grouped(kernel, 4, groups).to(x.dtype)
    if affine is not None:
        affine = _grouped(affine, 2, groups).float().contiguous()
    return dense3x3(x, wt.contiguous(), dilation=dilation, affine=affine,
                    out_dtype=out_dtype, channels_last=channels_last)


def dense2_layer(x: torch.Tensor, kernel: torch.Tensor, *, dilation: int,
                 affine: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None,
                 channels_last: bool = False) -> torch.Tensor:
    """Dense dilated 3x3 conv over the channel concatenation of the two
    batch halves of x, without forming the concat:
    conv(concat(A, B)) = conv_A(A) + conv_B(B), each half with its own
    BN affine + ReLU. x: (2B, Ci, H, W); kernel: (Co, 2*Ci, 3, 3);
    affine: (2, 2*Ci). Returns (B, Co, H, W), on the card channels-last in
    memory as `dense3x3` says."""
    B2, Ci = x.shape[0], x.shape[1]
    if B2 % 2:
        raise ValueError(f"batch {B2} is not two halves")
    B = B2 // 2
    if on_card(x) and dense_tensor_core_route(x.dtype, Ci, kernel.shape[0],
                                              dilation, 2):
        x = in_layout(x, True)  # one copy for both halves, if any
    wt = kernel.to(x.dtype)
    aff = affine.float()
    return dense3x3(
        x[:B], wt[None, :, :Ci].contiguous(), dilation=dilation,
        affine=aff[None, :, :Ci].contiguous(), x2=x[B:],
        wt2=wt[None, :, Ci:].contiguous(),
        affine2=aff[None, :, Ci:].contiguous(), out_dtype=out_dtype,
        channels_last=channels_last)


def dwsep_layer(x: torch.Tensor, affine: torch.Tensor, dwk: torch.Tensor,
                pwk: torch.Tensor, *, dilation: int, groups: int = 1,
                channels_last: bool = False) -> torch.Tensor:
    """Folded BN-affine + ReLU + depthwise dilated 3x3 + pointwise 1x1.
    x: (B, C, H, W); affine: ([G,] 2, C); dwk: ([G,] C, 1, 3, 3) and pwk:
    ([G,] Co, C), each cast on its own to x's dtype. Returns
    (B, Co, H, W), on the card channels-last in memory as `dwsep`
    says."""
    return dwsep(x, _grouped(dwk, 4, groups)[:, :, 0].to(x.dtype).contiguous(),
                 _grouped(pwk, 2, groups).to(x.dtype).contiguous(),
                 dilation=dilation,
                 affine=_grouped(affine, 2, groups).float().contiguous(),
                 channels_last=channels_last)


def dwsep2_layer(x: torch.Tensor, affine1: torch.Tensor, dwk1: torch.Tensor,
                 pwk1: torch.Tensor, affine2: torch.Tensor,
                 dwk2: torch.Tensor, pwk2: torch.Tensor, *, dilation1: int,
                 dilation2: int, groups: int = 1,
                 channels_last: bool = False) -> torch.Tensor:
    """Two consecutive dw-sep layers in one launch; arguments as
    `dwsep_layer`, twice. Returns (B, Co2, H, W)."""
    def prep(aff, dwk, pwk):
        return (_grouped(dwk, 4, groups)[:, :, 0].to(x.dtype).contiguous(),
                _grouped(pwk, 2, groups).to(x.dtype).contiguous(),
                _grouped(aff, 2, groups).float().contiguous())

    dw1, pw1, a1 = prep(affine1, dwk1, pwk1)
    dw2, pw2, a2 = prep(affine2, dwk2, pwk2)
    return dwsep2(x, dw1, pw1, dw2, pw2, dilation1=dilation1,
                  dilation2=dilation2, affine1=a1, affine2=a2,
                  channels_last=channels_last)


def chain_layer(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                affines: Sequence[Optional[torch.Tensor]], *,
                dilations: Sequence[int], groups: int = 1,
                two_input: bool = False,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """N dense dilated 3x3 layers in one launch, each preceded by its
    folded BN-affine + ReLU (none where affines[i] is None).
    x: (B, Ci0, H, W); kernels[i]: ([G,] Co, Ci, 3, 3), any float dtype,
    cast once to x's; affines[i]: ([G,] 2, Ci). With `two_input` (G = 1)
    the first layer is `dense2_layer`'s: kernels[0] is (Co, 2*Ci0, 3, 3)
    over the channel concatenation of the two batch halves of x and
    affines[0] is (2, 2*Ci0). Returns (B or B/2, Co_last, H, W) in
    `out_dtype` (default x's)."""
    wts = [_grouped(k, 4, groups).to(x.dtype) for k in kernels]
    affs = [None if a is None else _grouped(a, 2, groups).float()
            for a in affines]
    second = {}
    if two_input:
        if groups != 1 or x.shape[0] % 2:
            raise ValueError(f"two_input takes one weight group and an even "
                             f"batch, got {groups} and {x.shape[0]}")
        B, Ci = x.shape[0] // 2, x.shape[1]
        second = dict(x2=x[B:], wt2=wts[0][:, :, Ci:].contiguous(),
                      aff2=None if affs[0] is None
                      else affs[0][:, :, Ci:].contiguous())
        wts[0] = wts[0][:, :, :Ci]
        affs[0] = None if affs[0] is None else affs[0][:, :, :Ci]
        x = x[:B]
    return chain(x, [w.contiguous() for w in wts],
                 [None if a is None else a.contiguous() for a in affs],
                 dilations=dilations, out_dtype=out_dtype, **second)
