"""Cost filter + identity skip + soft-argmin on the Hopper kernels.

Counterpart of the JAX package's `ops/pallas/costfilter.py`. A stage's
filter is `layers + 2` BN + ReLU + conv3d layers; in inference every BN
folds into an affine, so the stage runs as

  act = conv3d_entry(vol, (a0, b0), w_0 * a_1, b_1)   (layer 0's BN inside)
  act = conv3d_bn_relu(act, w_k * a_{k+1}, b_{k+1})   for k = 1 .. n-2
  out = conv3d_skip_softargmin(act, w_{n-1}, vol, start)

Layer k+1's BN scale folds into layer k's weights in float32, cast once to
the compute dtype; its shift is the epilogue's bias. Layer 0's BN + ReLU,
relu(a0 * vol + b0) rounded once to the compute dtype, runs inside the
entry launch, on the values it stages, inside the volume only (the conv's
zero padding comes after the activation), where the JAX package runs it
as XLA before its kernels. Stages 1, 2 and 3 all take this one path (the
JAX package's `_dgrid` and `_folded` formulations compute the same
function).

Each kernel wrapper launches its CUDA kernel for a CUDA tensor and runs
its plain PyTorch version, beside it here, for a CPU tensor.

Routes and layouts on the card (`filter_routes`, the one rule that the
wrappers, `filter_soft_argmin`, chip_smoke.py and `tools.parity_layers`
consult): a bf16 stage of 32, 16, 64 or 8 channels runs its 1 -> C
entry and its C -> C layers on the tensor cores and its activations lie
channels-last-3d in memory, (B, D, H, W, C) under the logical
(B, C, D, H, W) shape, because those routes of `conv3d_bn_relu`
(`conv3d_reads_channels_last`) read it so. The entry writes it (its one
input channel, the raw volume, lies the same in both layouts), the
C -> C layers read and write it, and the fused last layer reads it on
the tensor cores, at any D. A bf16 stage of 4 channels (AnyNet's stages
2-3) runs every launch on the tensor cores in the default layout, NCDHW,
which its entry and its 4 -> 4 layers write and its 4 -> 4 layers and
fused last layer read, at any D. Every other stage, float32 at any width
and bf16 at any other width, and any D, runs on the CUDA cores in the
default layout. No
filter makes a layout copy. A copy, where a caller hands a kernel the
other layout, is `build.in_layout`'s, counted.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from lwsnet_tpu_torch.models.blocks import bn_affine
from lwsnet_tpu_torch.ops.cuda.build import (CONV3D_BN_RELU,
                                             CONV3D_SKIP_SOFTARGMIN, check,
                                             empty, in_layout, on_card,
                                             symbol_suffix)


TENSOR_CORES, CUDA_CORES = "tensor cores", "CUDA cores"


def conv3d_tensor_core_route(dtype: torch.dtype, Ci: int, Co: int) -> bool:
    """Whether `conv3d_bn_relu` runs a tensor-core route (`use_tc` in
    csrc/conv3d_bn_relu.cu): bf16 32 -> 32 (or 16 -> 32), 16 -> 16 and
    64 -> 64, which read and write channels-last only; bf16 8 -> 8, which
    reads channels-last and writes either layout; bf16 4 -> 4 (`c4`,
    mma.sync), which reads and writes NCDHW only; and the bf16 entries
    1 -> 4, 8, 16, 32 and 64 (`c1`, wgmma), whose one input channel lies
    the same in either layout, writing channels-last at 16, 32 and 64
    channels, NCDHW at 4 and either layout at 8."""
    return dtype == torch.bfloat16 and (
        (Co == 32 and Ci in (1, 16, 32)) or (Ci == Co and Ci in (16, 64))
        or (Co == 8 and Ci in (1, 8)) or Ci == Co == 4
        or (Ci == 1 and Co in (4, 16, 64)))


def conv3d_reads_channels_last(dtype: torch.dtype, Ci: int,
                               Co: int) -> bool:
    """Whether `conv3d_bn_relu`'s route reads channels-last: the
    tensor-core routes but `c4` (NCDHW) and the entries (one input
    channel, which lies the same in both layouts)."""
    return conv3d_tensor_core_route(dtype, Ci, Co) and Ci not in (1, 4)


def conv3d_writes_ncdhw(dtype: torch.dtype, Ci: int, Co: int) -> bool:
    """Whether `conv3d_bn_relu` can write NCDHW: every route but the
    tensor-core ones of 16, 32 and 64 outputs (the entries among them)."""
    return not (conv3d_tensor_core_route(dtype, Ci, Co)
                and Co in (16, 32, 64))


def conv3d_writes_channels_last(dtype: torch.dtype, Ci: int,
                                Co: int) -> bool:
    """Whether `conv3d_bn_relu` can write channels-last: every route but
    the tensor-core ones of 4 outputs, the 4 -> 4 route (`c4`) and the
    1 -> 4 entry (`c1`)."""
    return not (conv3d_tensor_core_route(dtype, Ci, Co) and Co == 4)


class LaunchRoute(NamedTuple):
    """A launch's route on the card (TENSOR_CORES or CUDA_CORES) and
    whether the activation it reads / writes lies channels-last (an entry
    reads the raw (B, D, H, W) volume; the fused last layer writes
    (B, H, W) float32)."""
    route: str
    reads_cl: bool
    writes_cl: bool


class StageRoutes(NamedTuple):
    """The launches of one stage's filter: the 1 -> C entry, each C -> C
    layer, the fused C -> 1 last layer."""
    entry: LaunchRoute
    layer: LaunchRoute
    skip: LaunchRoute


def filter_routes(dtype: torch.dtype, channels: int, D: int) -> StageRoutes:
    """The route and layouts of each launch of a stage's filter of width
    `channels` over D costs a pixel, in `dtype` (float32 or bf16): for
    bf16 at 32, 16, 64 or 8 channels every launch on the tensor cores at
    any D, and every activation channels-last; for bf16 at 4 channels
    every launch on the tensor cores at any D, and every activation
    NCDHW; the CUDA cores and NCDHW otherwise. Each launch reads what the
    one before it writes. Mirrors `use_tc` in csrc/conv3d_bn_relu.cu and
    the bf16 entry of csrc/conv3d_skip_softargmin.cu."""
    if channels < 1 or D < 1:
        raise ValueError(f"a filter of {channels} channels over {D} costs")
    tc = conv3d_tensor_core_route(dtype, channels, channels)
    cl = conv3d_reads_channels_last(dtype, channels, channels)
    entry_tc = conv3d_tensor_core_route(dtype, 1, channels)
    skip_tc = skip_tensor_core_route(dtype, channels)
    return StageRoutes(
        entry=LaunchRoute(TENSOR_CORES if entry_tc else CUDA_CORES, False,
                          cl),
        layer=LaunchRoute(TENSOR_CORES if tc else CUDA_CORES, cl, cl),
        skip=LaunchRoute(TENSOR_CORES if skip_tc else CUDA_CORES, cl, False))


def c8_images(wt: torch.Tensor) -> torch.Tensor:
    """(8, 8, 3, 3, 3) -> the 8 -> 8 route's resident B images: per
    (kd, kh, j) a 16 x 8 K-major slice whose k < 8 are the input channels
    at tap kw = 2j and k >= 8 those at kw = 2j + 1 (zero for kw = 3), as
    (kd, kh, j, k // 8, co, ci) (csrc/tc.cuh)."""
    Co, Ci = wt.shape[:2]
    return F.pad(wt, (0, 1)).reshape(Co, Ci, 3, 3, 2, 2).permute(
        2, 3, 4, 5, 0, 1).contiguous()


def c4_images(wt: torch.Tensor) -> torch.Tensor:
    """(4, 4, 3, 3, 3) -> the 4 -> 4 route's register-resident B slices:
    per (kd, sh), sh = 0 .. 3 a warp's staged row from its first output
    row on, a 16 x 8 slice whose column n = 4e + co is channel co of
    output row 1 - e, holding tap kh = sh - 1 + e (zero where it falls
    outside 0 .. 2); k = 4 kw + ci (zero for kw = 3), K contiguous a
    column, as (kd, sh, e, co, kw, ci): the mma.sync B fragment of lane
    (g, t) is words (slice 8 + g) 8 + t and + 4 (csrc/conv3d_bn_relu.cu,
    `c4`). One pad and one copy: the windows of 2 over kh padded by a zero
    row on each side."""
    w = F.pad(wt.permute(2, 3, 0, 4, 1), (0, 0, 0, 1, 0, 0, 1, 1))
    return w.unfold(1, 2, 1).permute(0, 1, 5, 2, 3, 4).contiguous()


def tc_images(wt: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3), Co = 16, 32 or 64, Ci a multiple of 16 -> the
    16 / 32 / 64-output route's resident B images: per 32-channel output
    half (16 outputs zero-padded to 32; a block holds one half) and
    (ci // 16, tap) a 16 x 32 K-major slice of 8 x 8 core matrices
    (csrc/tc.cuh), as (half, ci // 16, tap, co // 8, ci % 16 // 8, co % 8,
    ci % 8)."""
    Co, Ci = wt.shape[:2]
    wp = F.pad(wt, (0, 0, 0, 0, 0, 0, 0, 0, 0, -Co % 32)) if Co % 32 else wt
    return wp.reshape(-1, 4, 8, Ci // 16, 2, 8, 27).permute(
        0, 3, 6, 1, 4, 2, 5).contiguous()


def skip_tensor_core_route(dtype: torch.dtype, Ci: int) -> bool:
    """Whether `conv3d_skip_softargmin` runs a tensor-core route at any D:
    the wgmma route (`tcr` in csrc/conv3d_skip_softargmin.cu), which reads
    channels-last, at bf16 64, 32 (stage 1), 16 (AnyNet's stage 1) or 8
    (stages 2-3) input channels, the widths whose C -> C layers write
    channels-last; the mma.sync route (`s4`), which reads NCDHW, at bf16
    4 (AnyNet's stages 2-3), as its 4 -> 4 layers write it. Other bf16
    widths and float32 take the CUDA cores (`filter_routes`)."""
    return dtype == torch.bfloat16 and Ci in (4, 8, 16, 32, 64)


def skip_c4_images(wt: torch.Tensor) -> torch.Tensor:
    """(1, 4, 3, 3, 3) -> the 4 -> 1 route's register-resident B slices:
    per sh = 0 .. 3, a warp's staged row from its first output row on, a
    16 x 8 slice whose column n = 4 r + kd holds output row r's tap (kd,
    kh = sh - r) (zero where kh falls outside 0 .. 2, and at kd = 3);
    k = 4 kw + ci (zero for kw = 3), K contiguous a column, as (sh, r, kd,
    kw, ci): the mma.sync B fragment of lane (g, t) is words (sh 8 + g) 8
    + t and + 4 (csrc/conv3d_skip_softargmin.cu, `s4`). One pad and one
    copy: the windows of 2 over kh padded by a zero row on each side,
    taken in reverse (r = 0 reads the lower row of a window)."""
    w = F.pad(wt[0].permute(2, 1, 3, 0), (0, 0, 0, 1, 0, 1, 1, 1))
    return w.unfold(0, 2, 1).flip(-1).permute(0, 4, 1, 2, 3).contiguous()


def skip_images(wt: torch.Tensor) -> torch.Tensor:
    """(1, Ci, 3, 3, 3) -> the skip route's resident B images, one 16 x 8
    K-major slice (csrc/tc.cuh) per (kh, piece) whose column n < 3 holds
    the weights of kd = n (n >= 3 zero). Ci = 16, 32 or 64: pieces (kw,
    16-channel slice kc), k the channel kc * 16 + k, as (kh, kw, kc,
    k // 8, n, k % 8); Ci = 8: pieces j, k < 8 the channels at tap kw = 2j
    and k >= 8 those at kw = 2j + 1 (zero for kw = 3), as (kh, j, k // 8,
    n, ci)."""
    w = wt[0]
    if w.shape[0] != 8:  # (ci, n, kh, kw)
        w = F.pad(w, (0, 0, 0, 0, 0, 5)).reshape(-1, 2, 8, 8, 3, 3)
        return w.permute(4, 5, 0, 1, 3, 2).contiguous()
    w = F.pad(w, (0, 1, 0, 0, 0, 5)).reshape(8, 8, 3, 2, 2)
    return w.permute(2, 3, 4, 1, 0).contiguous()


def conv3d_bn_relu_plain(x: torch.Tensor, wt: torch.Tensor,
                         shift: torch.Tensor) -> torch.Tensor:
    """relu(conv3d(x, wt, padding=1) + shift), float32 arithmetic on the
    compute-dtype operands, result in x's dtype. x: (B, Ci, D, H, W);
    wt: (Co, Ci, 3, 3, 3) in x's dtype; shift: (Co,) float32."""
    y = F.conv3d(x.float(), wt.float(), padding=1)
    return F.relu(y + shift.view(1, -1, 1, 1, 1)).to(x.dtype)


def conv3d_bn_relu(x: torch.Tensor, wt: torch.Tensor, shift: torch.Tensor,
                   channels_last: Optional[bool] = None) -> torch.Tensor:
    """One BN-folded conv3d layer; see `conv3d_bn_relu_plain`. On the card
    the tensor-core routes but `c4` read channels-last, `c4` (bf16 4 -> 4)
    and the CUDA cores NCDHW (x is copied where it lies otherwise; a
    1-channel x lies the same in both); the CUDA cores take any Ci and Co.
    The result lies channels-last where asked (`channels_last`) or, by
    default, where a filter of its width reads it so (`filter_routes`:
    bf16, 32, 16, 64 or 8 channels); the tensor-core routes of 16, 32 and
    64 outputs write nothing else, those of 4 (`c4` and the 1 -> 4 entry)
    nothing but NCDHW."""
    if not on_card(x):
        return conv3d_bn_relu_plain(x, wt, shift)
    return _launch(x, wt, shift, None, channels_last)


def conv3d_entry_plain(vol: torch.Tensor, a0b0: torch.Tensor,
                       wt: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """A stage's entry: layer 0's BN + ReLU on the raw volume, rounded once
    to its dtype, then the 1 -> Co layer, `conv3d_bn_relu_plain`:
    act = relu(vol * a0 + b0) in float32. vol: (B, D, H, W); a0b0: (2,)
    float32, (a0, b0); wt: (Co, 1, 3, 3, 3) in vol's dtype; shift: (Co,)
    float32. Returns (B, Co, D, H, W)."""
    act = F.relu(vol.float() * a0b0[0] + a0b0[1]).to(vol.dtype)
    return conv3d_bn_relu_plain(act[:, None], wt, shift)


def conv3d_entry(vol: torch.Tensor, a0b0: torch.Tensor, wt: torch.Tensor,
                 shift: torch.Tensor) -> torch.Tensor:
    """A stage's entry in one launch; see `conv3d_entry_plain`. On the card
    bf16 at 4, 8, 16, 32 or 64 outputs takes the tensor-core entry
    (`c1` in csrc/conv3d_bn_relu.cu), float32 and every other width the
    CUDA cores, each applying the affine to the values it reads inside the
    volume; a0b0 stays on the device (no host sync). The result lies as
    `conv3d_bn_relu`'s default (`filter_routes`): channels-last at bf16 8,
    16, 32 and 64 outputs, NCDHW otherwise (the 1 -> 4 entry writes
    nothing else)."""
    if not on_card(vol):
        return conv3d_entry_plain(vol, a0b0, wt, shift)
    if vol.dim() != 4:
        raise ValueError(f"vol: shape {tuple(vol.shape)}, expected "
                         f"(B, D, H, W)")
    check(vol, "vol", vol.shape, vol.dtype, vol.device)  # dense
    check(a0b0, "a0b0", (2,), torch.float32, vol.device)
    return _launch(vol[:, None], wt, shift, a0b0, None)


def _launch(x: torch.Tensor, wt: torch.Tensor, shift: torch.Tensor,
            aff: Optional[torch.Tensor],
            channels_last: Optional[bool]) -> torch.Tensor:
    """`conv3d_bn_relu`'s launch on the card, with layer 0's affine `aff`
    ((2,) float32 on x's device) at a 1-channel entry. Launches with one
    input channel count as route "entry", the others on the CUDA cores as
    route "cores"."""
    B, Ci, D, H, W = x.shape
    Co = wt.shape[0]
    tensor_core = conv3d_tensor_core_route(x.dtype, Ci, Co)
    x_cl = conv3d_reads_channels_last(x.dtype, Ci, Co)
    x = in_layout(x, x_cl)
    y_cl = (filter_routes(x.dtype, Co, D).layer.reads_cl
            if channels_last is None else channels_last)
    if not (y_cl or conv3d_writes_ncdhw(x.dtype, Ci, Co)):
        raise ValueError("the tensor-core routes of 16, 32 and 64 outputs "
                         "write channels-last only")
    if y_cl and not conv3d_writes_channels_last(x.dtype, Ci, Co):
        raise ValueError("the tensor-core routes of 4 outputs write NCDHW "
                         "only")
    check(x, "x", (B, Ci, D, H, W), x.dtype, x.device, x_cl)
    check(wt, "wt", (Co, Ci, 3, 3, 3), x.dtype, x.device)
    check(shift, "shift", (Co,), torch.float32, x.device)
    if tensor_core and Ci == 1:
        wk = wt  # each block lays out its B images
    elif tensor_core and Co == 8:
        wk = c8_images(wt)
    elif tensor_core and Co == 4:
        wk = c4_images(wt)
    elif tensor_core:
        wk = tc_images(wt)
    else:  # (Ci, 27, Co)
        wk = wt.permute(1, 2, 3, 4, 0).reshape(Ci, 27, Co).contiguous()
    y = empty((B, Co, D, H, W), x.dtype, x.device, y_cl)
    CONV3D_BN_RELU.launch(
        f"conv3d_bn_relu_{symbol_suffix(x.dtype)}", x.device,
        x.data_ptr(), wk.data_ptr(), shift.data_ptr(),
        None if aff is None else aff.data_ptr(), y.data_ptr(),
        B, Ci, Co, D, H, W, x_cl, y_cl,
        route="entry" if Ci == 1 else None if tensor_core else "cores")
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
    """Fused last layer + skip + soft-argmin; see the plain version. On the
    card it reads the layout of its stage's layers (`filter_routes`:
    channels-last for bf16 at 8, 16, 32 or 64 channels, on the tensor
    cores; NCDHW for bf16 at 4, on the tensor cores, and on the CUDA cores
    at every other width and in float32; x is copied where it lies
    otherwise) and takes any Ci and D. Launches on the CUDA cores count as
    route "cores"."""
    if not on_card(x):
        return conv3d_skip_softargmin_plain(x, wt, vol, start)
    B, Ci, D, H, W = x.shape
    route = filter_routes(x.dtype, Ci, D).skip
    tensor_core = route.route == TENSOR_CORES
    x = in_layout(x, route.reads_cl)
    check(x, "x", (B, Ci, D, H, W), x.dtype, x.device, route.reads_cl)
    check(wt, "wt", (1, Ci, 3, 3, 3), x.dtype, x.device)
    check(vol, "vol", (B, D, H, W), x.dtype, x.device)
    wk = (skip_c4_images(wt) if tensor_core and Ci == 4
          else skip_images(wt) if tensor_core else wt)
    out = torch.empty((B, H, W), dtype=torch.float32, device=x.device)
    CONV3D_SKIP_SOFTARGMIN.launch(
        f"conv3d_skip_softargmin_{symbol_suffix(x.dtype)}", x.device,
        x.data_ptr(), wk.data_ptr(), vol.data_ptr(), out.data_ptr(),
        B, Ci, D, H, W, float(start),
        route=None if tensor_core else "cores")
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
    # Every layer hands on the layout the next one reads: each wrapper's
    # default, from `filter_routes` (channels-last for bf16 at 8, 16, 32
    # or 64 channels, NCDHW otherwise, the tensor cores' 4 channels
    # among them). The entry applies layer 0's BN + ReLU.
    for i in range(n - 1):
        a_next, b_next = affs[i + 1]
        wt = (params[f"BNReLUConv3D_{i}.weight"].float()
              * a_next.view(-1, 1, 1, 1, 1)).to(dtype)
        act = (conv3d_entry(vol, torch.cat(affs[0]), wt, b_next) if i == 0
               else conv3d_bn_relu(act, wt, b_next))
    wt = params[f"BNReLUConv3D_{n - 1}.weight"].to(dtype)
    return conv3d_skip_softargmin(act, wt, vol, start)[..., None]
