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

Every engine runs at any `refine_channels`, as the JAX kernels do. Its
one route rule, `refine_routes` (as `costfilter.filter_routes` is the cost
filters'), gives each launch's route and layouts from (dtype, engine,
width): at bf16 32 channels the tensor-core and narrow routes above; in
float32 the 32-output layers on dense3x3's float32 route (channels-last
in, so the float32 "mxu" entry writes channels-last); at every other
width and in float32 otherwise the CUDA cores (`dwsep3x3`'s tile body
in bf16: its pointwise product on mma.sync, route `refine_rows.MMA`),
each launch asked to write the layout its reader takes (channels-last
only into a narrow output conv, at widths that are multiples of 16), so
no launch copies.

In every engine BatchNorm folds into a per-channel affine applied before
each layer; the two towers run as one 2B batch with two weight groups, the
disparity tower's 1-channel input and entry kernel zero-padded to 3
channels, which is exact; and the head's 64-channel entry reads the two
tower halves without forming the concat.

Under `pallas_mode="layers"` (`_layers_mode`) it mirrors the JAX planar
path instead, through `ops/cuda/refine.py`: each tower runs alone at batch
B with its own weights, the disparity tower on its 1-channel input; the
dw-sep layers pair as `layer_plan` says at the refinement's width (all
pairs at 368x1232, 6 pair launches); the head's entry runs as two
single-input convs, one per tower, each rounded to the compute dtype and
summed in it (in bf16 at 32 channels all of it channels-last in memory,
as the tensor-core routes read it); and the
output conv writes the compute dtype, so the residual is rounded to it
before it becomes float32. The weights are cast to the compute dtype, the
folded BN affines stay float32.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from lwsnet_tpu_torch.config import PALLAS_MODES
from lwsnet_tpu_torch.models.blocks import BatchNorm, PreConvDW, bn_affine
from lwsnet_tpu_torch.models.refinement import (HEAD_DENSE_DILATION,
                                                HEAD_DILATIONS,
                                                TOWER_DILATIONS)
from lwsnet_tpu_torch.ops.cuda.costfilter import CUDA_CORES, TENSOR_CORES
from lwsnet_tpu_torch.ops.cuda.refine import (fused_dense, fused_dwsep,
                                              fused_dwsep2, layer_plan)
from lwsnet_tpu_torch.ops.cuda.refine_rows import (
    F32, chain_layer, chain_tensor_core_route, dense2_layer,
    dense_entry_route, dense_f32_route, dense_layer, dense_output_route,
    dense_tensor_core_route, dwsep2_layer, dwsep_layer, dwsep_route)

ENGINES = ("mxu", "vpu", "chain")
# The refinement's engines by name: the "rows" engines ("vpu" paired and
# unpaired) and the planar path.
ENGINE_NAMES = ("mxu", "vpu-paired", "vpu-unpaired", "chain", "layers")
# dense3x3's narrow routes, named as `build.route_counts()` counts them
ENTRY, OUTPUT = "entry", "output"


class RefineLaunch(NamedTuple):
    """One launch of the refinement on the card: its kernel, its route
    (ENTRY, OUTPUT: dense3x3's narrow routes; `refine_rows.F32`: its
    float32 route; TENSOR_CORES; CUDA_CORES; `refine_rows.MMA`:
    dwsep3x3's bf16 tile body, `dwsep_route`),
    whether the activation it reads / writes lies channels-last, and the
    launches whose outputs it reads (indices; none: the forward's NCHW
    input)."""
    kernel: str
    route: str
    reads_cl: bool
    writes_cl: bool
    feeders: Tuple[int, ...]


def engine_name(mode: str, dw: str, paired: bool) -> str:
    """The ENGINE_NAMES entry of (`pallas_mode`, `rows_dw`,
    `rows_paired`)."""
    if mode == "layers":
        return "layers"
    if dw == "vpu":
        return "vpu-paired" if paired else "vpu-unpaired"
    return dw


def refine_routes(dtype: torch.dtype, engine: str, channels: int,
                  h: int = 368, w: int = 1232) -> Tuple[RefineLaunch, ...]:
    """The refinement's one route rule: each launch of `engine`'s stage-4
    refinement of width `channels` (`refine_channels`) in `dtype`, in the
    order the forward makes them, with its route and layouts, at an h x w
    image (the "layers" path pairs its dw-sep layers by `layer_plan`).

    A route fixes what it reads and writes: dense3x3's narrow entry reads
    NCHW and writes channels-last, its narrow output reads channels-last
    and writes (B, Co, H, W), its float32 route reads channels-last and
    writes what its readers read, the tensor-core routes of `dense3x3`,
    `dwsep3x3` and `chain3x3` (tower: NCHW in) read and write
    channels-last; `dwsep3x3`'s tile body (`refine_rows.MMA` in bf16,
    CUDA_CORES in float32) and the CUDA cores of `chain3x3` read NCHW,
    those of `dense3x3` read channels-last where Ci % 8 == 0 and their
    input lies so. A launch of `dense3x3`'s CUDA cores or of `dwsep3x3`'s
    tile body writes the layout its reader reads, so no launch copies
    (`layout_copies`).
    Mirrors the predicates of ops/cuda/refine_rows.py, as
    `costfilter.filter_routes` does the cost filters'."""
    if engine not in ENGINE_NAMES:
        raise ValueError(f"engine {engine!r}: expected one of "
                         f"{ENGINE_NAMES}")
    c = channels
    # [kernel, route, reads (None: channels-last where every feeder
    # writes it), writes (None: as its readers read), feeders (indices;
    # [] for the forward's NCHW input)]
    specs: List[list] = []

    def add(kernel, route, reads, writes, feeders=None):
        specs.append([kernel, route, reads, writes,
                      [len(specs) - 1] if feeders is None else feeders])
        return len(specs) - 1

    def dense(ci, co, d, inputs=1, groups=1, feeders=None):
        args = (dtype, ci, co, d, inputs, groups)
        if dense_entry_route(*args):
            return add("dense3x3", ENTRY, False, True, feeders)
        if dense_output_route(*args):
            return add("dense3x3", OUTPUT, True, False, feeders)
        if dense_tensor_core_route(*args):
            return add("dense3x3", TENSOR_CORES, True, True, feeders)
        if dense_f32_route(*args):
            return add("dense3x3", F32, True, None, feeders)
        return add("dense3x3", CUDA_CORES, None if ci % 8 == 0 else False,
                   None, feeders)

    def dwsep(dilations, groups=1, feeders=None):
        route = dwsep_route(dtype, (c,) * (len(dilations) + 1), dilations,
                            groups)
        tc = route == TENSOR_CORES
        kernel = "dwsep3x3_pair" if len(dilations) == 2 else "dwsep3x3"
        return add(kernel, route, tc, True if tc else None, feeders)

    if engine == "chain":
        tc = chain_tensor_core_route(dtype, (3,) + (c,) * 4, (c,) * 5,
                                     (1,) + TOWER_DILATIONS, 2)
        add("chain3x3", TENSOR_CORES if tc else CUDA_CORES, False, tc, [])
        dils = (HEAD_DENSE_DILATION,) + HEAD_DILATIONS + (1,)
        tc = chain_tensor_core_route(dtype, (c,) * 6, (c,) * 5 + (1,), dils,
                                     1, True)
        add("chain3x3", TENSOR_CORES if tc else CUDA_CORES, tc, False)
    elif engine == "layers":
        ends = []
        for ci in (3, 1):
            dense(ci, c, 1, feeders=[])
            for ds in layer_plan(h, w, TOWER_DILATIONS, c):
                dwsep(ds)
            ends.append(len(specs) - 1)
        halves = [dense(c, c, HEAD_DENSE_DILATION, feeders=[e])
                  for e in ends]
        for k, ds in enumerate(layer_plan(h, w, HEAD_DILATIONS, c)):
            dwsep(ds, feeders=halves if k == 0 else None)
        dense(c, 1, 1)
    else:
        dense(3, c, 1, groups=2, feeders=[])
        if engine == "mxu":
            for d in TOWER_DILATIONS:
                dense(c, c, d, groups=2)
        else:
            step = 2 if engine == "vpu-paired" else 1
            for i in range(0, len(TOWER_DILATIONS), step):
                dwsep(TOWER_DILATIONS[i:i + step], 2)
        dense(c, c, HEAD_DENSE_DILATION, inputs=2)
        if engine == "mxu":
            for d in HEAD_DILATIONS:
                dense(c, c, d)
        else:
            for i in range(0, len(HEAD_DILATIONS), step):
                dwsep(HEAD_DILATIONS[i:i + step])
        dense(c, 1, 1)

    fixed = [sp[3] for sp in specs]
    reads = [sp[2] if sp[2] is not None else
             bool(sp[4]) and all(fixed[f] is True for f in sp[4])
             for sp in specs]
    out = []
    for i, (kernel, route, _, writes, feeders) in enumerate(specs):
        if writes is None:
            readers = {reads[j] for j, sp in enumerate(specs) if i in sp[4]}
            if len(readers) > 1:
                raise AssertionError(f"launch {i}: readers of two layouts")
            writes = readers.pop() if readers else False
        out.append(RefineLaunch(kernel, route, reads[i], writes,
                                tuple(feeders)))
    return tuple(out)


def layout_copies(launches: Sequence[RefineLaunch]) -> int:
    """The layout copies the wrappers make for `launches`: one for each
    input a launch reads in another layout than its feeder writes (the
    forward's input: NCHW). 0 for every engine, dtype and width of
    `refine_routes`."""
    return sum(L.reads_cl != (launches[f].writes_cl if f >= 0 else False)
               for L in launches for f in (L.feeders or (-1,)))


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

    # Each launch writes the layout the next one reads (`refine_routes`).
    cl = iter([L.writes_cl for L in refine_routes(
        dtype, engine_name(mode, dw, paired), cfg.refine_channels,
        x.shape[2], x.shape[3])])
    y = dense_layer(x, entries, dilation=1, groups=2,
                    channels_last=next(cl))
    if dw == "mxu":
        for (bl, bd), d in zip(tower, TOWER_DILATIONS):
            y = dense_layer(
                y, torch.stack([_compose_dwsep(bl), _compose_dwsep(bd)]),
                dilation=d, groups=2,
                affine=torch.stack([fold_bn(bl.BatchNorm_0),
                                    fold_bn(bd.BatchNorm_0)]),
                channels_last=next(cl))
    elif paired:
        for i in (0, 2):  # pairs (2, 4) and (8, 16)
            y = dwsep2_layer(y, *grouped(i), *grouped(i + 1),
                             dilation1=TOWER_DILATIONS[i],
                             dilation2=TOWER_DILATIONS[i + 1], groups=2,
                             channels_last=next(cl))
    else:
        for i, d in enumerate(TOWER_DILATIONS):
            y = dwsep_layer(y, *grouped(i), dilation=d, groups=2,
                            channels_last=next(cl))

    y = dense2_layer(y, pre.Conv_0.weight, dilation=HEAD_DENSE_DILATION,
                     affine=fold_bn(pre.BatchNorm_0), channels_last=next(cl))
    if dw == "mxu":
        for blk, d in zip(head_dw, HEAD_DILATIONS):
            y = dense_layer(y, _compose_dwsep(blk), dilation=d,
                            affine=fold_bn(blk.BatchNorm_0),
                            channels_last=next(cl))
    elif paired:
        for i in (0, 2):  # pairs (8, 4) and (2, 1)
            y = dwsep2_layer(y, *_dwsep_weights(head_dw[i]),
                             *_dwsep_weights(head_dw[i + 1]),
                             dilation1=HEAD_DILATIONS[i],
                             dilation2=HEAD_DILATIONS[i + 1],
                             channels_last=next(cl))
    else:
        for blk, d in zip(head_dw, HEAD_DILATIONS):
            y = dwsep_layer(y, *_dwsep_weights(blk), dilation=d,
                            channels_last=next(cl))
    y = dense_layer(y, head.out_weight.to(dtype), dilation=1,
                    out_dtype=torch.float32, channels_last=next(cl))
    return y.permute(0, 2, 3, 1)


def _hwio(weight: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3) -> the JAX (3, 3, Ci, Co)."""
    return weight.permute(2, 3, 1, 0)


def _planar_dwsep(block: PreConvDW):
    """(affine (2, C), taps (3, 3, 1, C), pointwise (Co, C)) of a dw-sep
    layer in the JAX planar path's layout."""
    return (fold_bn(block.BatchNorm_0), _hwio(block.dw_weight),
            block.Conv_0.weight[:, :, 0, 0])


def _dwsep_chain(y: torch.Tensor, blocks, dilations, cl) -> torch.Tensor:
    """A dw-sep chain, one launch per entry of `layer_plan` at the
    refinement's width: a pair where the JAX chunk holds the joint halo,
    else a solo; `cl` yields the layout each launch writes."""
    k, c = 0, blocks[0].Conv_0.weight.shape[1]
    for step in layer_plan(y.shape[2], y.shape[3], dilations, c):
        if len(step) == 2:
            y = fused_dwsep2(y, *_planar_dwsep(blocks[k]),
                             *_planar_dwsep(blocks[k + 1]),
                             dilation1=step[0], dilation2=step[1],
                             channels_last=next(cl))
        else:
            y = fused_dwsep(y, *_planar_dwsep(blocks[k]), dilation=step[0],
                            channels_last=next(cl))
        k += len(step)
    return y


def _layers_mode(model, left: torch.Tensor, disp: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The counterpart of the JAX `refine_residual(mode="layers")`."""
    tl, td = model.RefinementTower_0, model.RefinementTower_1
    head = model.RefinementHead_0
    n = len(TOWER_DILATIONS)
    # Each launch writes the layout its reader reads (`refine_routes`).
    cl = iter([L.writes_cl for L in refine_routes(
        dtype, "layers", model.cfg.refine_channels, left.shape[1],
        left.shape[2])])

    def tower(t, x):
        y = fused_dense(x.permute(0, 3, 1, 2).to(dtype).contiguous(),
                        _hwio(t.Conv_0.weight), dilation=1,
                        channels_last=next(cl))
        return _dwsep_chain(y, [getattr(t, f"PreConvDW_{i}")
                                for i in range(n)], TOWER_DILATIONS, cl)

    y_l, y_d = tower(tl, left), tower(td, disp)
    pre = head.PreConv_0
    dense, aff0 = _hwio(pre.Conv_0.weight), fold_bn(pre.BatchNorm_0)
    c = y_l.shape[1]
    y = (fused_dense(y_l, dense[:, :, :c], dilation=HEAD_DENSE_DILATION,
                     affine=aff0[:, :c], channels_last=next(cl))
         + fused_dense(y_d, dense[:, :, c:], dilation=HEAD_DENSE_DILATION,
                       affine=aff0[:, c:], channels_last=next(cl)))
    y = _dwsep_chain(y, [getattr(head, f"PreConvDW_{i}")
                         for i in range(len(HEAD_DILATIONS))],
                     HEAD_DILATIONS, cl)
    y = fused_dense(y, _hwio(head.out_weight), dilation=1,
                    channels_last=next(cl))
    return y.permute(0, 2, 3, 1).float()
