"""Every kernel launch of the forward against the module layer it replaces.

The whole-stage checks (`chip_smoke.py` phase 4, `tools.parity
--fixture`) cannot see a small weight error in one bf16 layer: the
cascade's rounding hides it. This tool records each launch the real
forward makes, without editing the forward: it wraps the layer functions
where the forward looks them up (`conv3d_entry`, `conv3d_bn_relu` and
`conv3d_skip_softargmin` in `ops/cuda/costfilter.py`, which
`filter_soft_argmin` calls; `dense_layer`, `dense2_layer`, `dwsep_layer`,
`dwsep2_layer`, `chain_layer`, `fused_dense`, `fused_dwsep` and
`fused_dwsep2` as `models/refine_kernels.py` imports them). Each call is
one launch. As it returns, the launch's output is held against the
model's own modules on the same input, with unfolded weights, computed
twice: in the launch's dtype with the module path's arithmetic
("module"), and in float64 from a float64 copy of the model ("truth").

  cost filter, launch i < n - 1: BNReLUConv3D_i's conv, then
      BNReLUConv3D_{i+1}.BatchNorm_0 and ReLU (the entry, i = 0, runs
      layer 0's BN-ReLU on the raw volume first);
  cost filter, last launch: the conv, plus the volume, then
      `stereo.soft_argmin` over the stage's bins;
  "mxu" and "vpu": the towers' entry (`Conv_0`, the disparity half on
      channel 0 of its zero-padded input), a tower or head layer
      (`PreConvDW_i`, each tower half on its own weights; a "vpu" pair is
      two), the head entry (`PreConv_0` on the concat), the output (the
      head's `out_weight` conv);
  "chain": a whole stack, the towers (entry and four blocks) or the head;
  "layers": each `fused_*` launch's block or pair; each half of the head
      entry is `PreConv_0`'s BN-ReLU and conv on its 32 channels (the sum
      of the halves is outside any launch).

Bar (chip_smoke.py phase 4's rule, per launch): the launch's mean |delta|
from truth at most MEAN_RATIO x the module reference's, and in float32
its max |delta| at most MAX_RATIO x, or the route's own bars where it
rounds at another point than the module (`ROUTE_BARS`). A bf16 fused last
layer is also held against the kernel's own arithmetic (the conv in
float32 on the same bf16 operands, `_cf_exact`), within EXACT_RATIO. A launch that
has no reference raises (`LookupError`). The cost-filter launches are the
same under every engine: they are held once per dtype and weight set,
under the first engine run, and only matched to their references under
the others.

`--plant ROUTE` scales by 1.01 the weights handed to the first launch of
one route (`ROUTES`, or a cost-filter route of the configuration's
widths), every layer's conv kernel in it (a dw-sep layer's pointwise
weights), on the kernel side only, in bf16 on the seed-0 set: the check
must then fail at that launch and at no other. Without it the sound check
runs under every engine, in bf16 and float32, on both sets.

    python -m lwsnet_tpu_torch.tools.parity_layers [--plant ROUTE] \
        [--height 368 --width 1232] [--out results/PARITY_LAYERS.json] \
        [--device cuda] [--maxdisplist 12 3 3 --channels_3d 4 \
        --layers_3d 4 --growth_rate 4 1 1] [--refine_channels 48]

The four cost-filter flags, as the CLIs take them, set the cost filters'
configuration (`ModelConfig` fields; the shipped one by default); another
configuration's filters get references of their own widths (routes
`cf-entry-C`, `cf-C`, `skip-C` for each stage width C: AnyNet's settings,
`ANYNET`, run `cf-entry-16`, `cf-16`, `skip-16` and the same at 4).
`--refine_channels C` sets the refinement's width (no CLI of the models
takes it: a `ModelConfig` field), whose launches at C != 32 get routes
named with the width (`width_route`: `dense-48`, `dwsep-48`, ...) and the
bars of the shipped route they stand for (`shipped_route`). Another
configuration runs on the seed-0 set alone (the trained weights are the
shipped configuration's).

The sets: "seed0", the seed-0 network with jittered batch norms
(`jitter_batchnorm`, chip_smoke.py phase 4's) on phase 4's
standard-normal pair; "trained_wide", `tools.parity`'s set of that name
(the fixture's trained weights on `wide_pair(0)`), bottom-right cropped
to the size. float32 runs with TF32 off. Runs on the card (raises
without one) unless `--device cpu`, where each wrapper runs its kernel's
plain version. Run it from the repository's root, where the fixture's
weights lie (`tools.parity.FIXTURE`).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

H, W = 368, 1232  # KITTI eval window
# A launch's (chip_smoke.py phase 4: the kernel path's) mean |delta| from
# the float64 truth over the module's; in float32 also its max |delta|.
MEAN_RATIO = 1.1
MAX_RATIO = 2.0
# A route's own (mean, max) ratio bars where its sound launches read over
# MEAN_RATIO or MAX_RATIO, each above the route's own sound readings and
# below a x1.01 weight fault's (CHANGES.md and PERF.md give both):
# * bf16 cost filters at 8 channels (and AnyNet's 16 and 4, `ANYNET`): BN
#   scale folded into the bf16 weights (w * a rounded once, where the
#   module rounds w, then the conv output); 432, 216, 108 or 27 products a
#   voxel do not average the weights' rounding (eight seed-0-like draws at
#   64x128 on the CPU: `cf-16` up to 1.166, `cf-entry-4` 1.186, `cf-4`
#   1.750, each x1.01 fault 2.3 or more);
# * bf16 fused last layer: the conv, skip and soft-argmin in float32 where
#   the module rounds the cost to bf16, so a sound launch reads 0.03-0.64 x
#   the module's distance and a planted fault hides under 1.1 (`skip-16`,
#   AnyNet's stage 1 on the tensor cores: sound 0.14-0.76 over eight
#   seed-0-like draws at 64x128 on the CPU and 0.376 at 368x1232 on the
#   H100, a x1.01 fault 0.948 there);
# * bf16 "chain" head at 48 channels (`--refine_channels 48`, on the
#   CUDA cores): the composed rank-1 kernels rounded once to bf16, where the
#   module rounds the depthwise output, over 432-term sums (eight draws at
#   64x128 on the CPU: up to 1.221; a x1.01 fault 11.8-12.1);
# * float32: the cost filters' entries and 8-channel layers and the dw-sep
#   layers fold BN into float32 weights or affines, and "mxu" and "chain"
#   compose rank-1 kernels into 288-term sums, a rounding the module
#   (exact float32 weights) does not make (`cf-4` up to 1.271 over the
#   eight draws).
ROUTE_BARS = {
    ("bfloat16", "cf-8"): (1.5, MAX_RATIO),
    ("bfloat16", "cf-entry-8"): (1.5, MAX_RATIO),
    ("bfloat16", "cf-16"): (1.5, MAX_RATIO),
    ("bfloat16", "cf-entry-4"): (1.5, MAX_RATIO),
    ("bfloat16", "cf-4"): (2.0, MAX_RATIO),
    ("float32", "cf-4"): (1.4, MAX_RATIO),
    ("bfloat16", "chain-head-48"): (1.5, MAX_RATIO),
    ("bfloat16", "skip-32"): (0.9, MAX_RATIO),
    ("bfloat16", "skip-8"): (0.9, MAX_RATIO),
    ("bfloat16", "skip-16"): (0.85, MAX_RATIO),
    ("float32", "cf-entry-32"): (1.25, MAX_RATIO),
    ("float32", "cf-entry-8"): (1.5, MAX_RATIO),
    ("float32", "cf-8"): (1.4, MAX_RATIO),
    ("float32", "dwsep"): (1.25, MAX_RATIO),
    ("float32", "layers-dwsep-pair"): (1.35, MAX_RATIO),
    ("float32", "dense-32"): (2.5, 3.5),
    ("float32", "chain-tower"): (2.0, MAX_RATIO),
    ("float32", "chain-head"): (1.6, MAX_RATIO)}
PLANT_SCALE = 1.01
# A bf16 fused last layer's mean |delta| from the float64 truth over that
# of its exact reference (`Launch.exact`): the same arithmetic, float32
# products and sums of the same bf16 operands, in another order, so a
# sound launch reads 1 to within the order of the sums. Its module
# reference rounds the cost to bf16, which at 4 channels swamps a x1.01
# weight error (AnyNet's stage-2 `skip-4` reads 0.024 sound and 0.121
# planted against the module at 368x1232, where stage 3 reads 0.457 sound).
EXACT_RATIO = 1.1

# AnyNet's cost-filter settings inside LWSNet: the argparse defaults of
# AnyNet's finetune.py (Wang et al., "Anytime Stereo Image Depth
# Estimation on Mobile Devices", ICRA 2019, github.com/mileyan/AnyNet),
# --maxdisplist 12 3 3 --channels_3d 4 --layers_3d 4 --growth_rate 4 1 1:
# stage widths 16 / 4 / 4 over D = 12 / 5 / 5 costs.
ANYNET = dict(max_disp_list=(12, 3, 3), channels_3d=4, layers_3d=4,
              growth_rate=(4, 1, 1))

# The stage-4 refinement engines as ModelConfig fields; "mxu" is shipped.
ENGINES = {"mxu": dict(rows_dw="mxu"),
           "vpu-paired": dict(rows_dw="vpu", rows_paired=True),
           "vpu-unpaired": dict(rows_dw="vpu", rows_paired=False),
           "chain": dict(rows_dw="chain"),
           "layers": dict(pallas_mode="layers")}
SETS = ("seed0", "trained_wide")

# The cost filters' layer functions (`filter_soft_argmin` calls them).
FILTER_FNS = ("conv3d_entry", "conv3d_bn_relu", "conv3d_skip_softargmin")
# The positional arguments holding the weights a planted fault scales:
# each layer's conv kernel (a dw-sep layer's pointwise weights; a chain's
# list of kernels).
PLANT_ARGS = {"conv3d_entry": (2,), "conv3d_bn_relu": (1,),
              "conv3d_skip_softargmin": (1,), "dense_layer": (1,),
              "dense2_layer": (1,), "dwsep_layer": (3,),
              "dwsep2_layer": (3, 6), "chain_layer": (1,),
              "fused_dense": (1,), "fused_dwsep": (3,),
              "fused_dwsep2": (3, 6)}
# The engine whose forward runs each route first: the planted faults, one
# a route, in the route's first launch.
ROUTES = {
    "cf-entry-32": "mxu", "cf-entry-8": "mxu", "cf-32": "mxu",
    "cf-8": "mxu", "skip-32": "mxu", "skip-8": "mxu",
    "dense-entry": "mxu", "dense-32": "mxu", "dense-output": "mxu",
    "dense-two-input": "mxu", "dwsep": "vpu-unpaired",
    "dwsep-pair": "vpu-paired", "chain-tower": "chain",
    "chain-head": "chain", "layers-entry": "layers",
    "layers-entry-1": "layers", "layers-dwsep-pair": "layers",
    "layers-head-half": "layers", "layers-output": "layers"}


def width_route(route: str, channels: int) -> str:
    """Route `route` of ROUTES (a refinement route, named at the shipped
    width of 32 channels) at refinement width `channels`: itself at 32,
    else named with the width ("dense-32" -> "dense-48", "dwsep" ->
    "dwsep-48")."""
    if channels == 32:
        return route
    return (f"dense-{channels}" if route == "dense-32"
            else f"{route}-{channels}")


def shipped_route(route: str) -> str:
    """The route of ROUTES that `route` of another refinement width stands
    for (`width_route`'s inverse); any other route itself (a cost filter's
    `cf-16` among them). Its bars and engine are the shipped route's."""
    base, _, width = route.rpartition("-")
    if route not in ROUTES and width.isdigit():
        base = "dense-32" if base == "dense" else base
        if base in ROUTES:
            return base
    return route


class Launch(NamedTuple):
    """One expected launch: the layer function the forward calls, its
    route (a key of ROUTES, a cost-filter route of another width, or
    "layers-dwsep" for a solo that 368x1232 does not make), where it
    stands, its input channels, and its module reference ref(model, cast,
    args): `cast` is applied to each input tensor among the launch's
    positional `args`. `exact`: for the fused last layer, a second
    reference in the kernel's own arithmetic (`_cf_exact`), held in bf16
    (EXACT_RATIO). `kernel_route`: the launch's route on the card by dtype
    (`costfilter.filter_routes`, `refine_kernels.refine_routes`), recorded
    with its reading."""
    fn: str
    route: str
    where: str
    channels: int
    ref: Callable
    exact: Optional[Callable] = None
    kernel_route: Optional[Dict[str, str]] = None


def jitter_batchnorm(model, rng: np.random.Generator) -> None:
    """Non-identity BN statistics and affines, so every fold is exercised
    (chip_smoke.py phase 4 draws them from default_rng(3))."""
    from lwsnet_tpu_torch.models.blocks import BatchNorm
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                for t, v in ((m.weight, rng.uniform(0.5, 1.5, c)),
                             (m.bias, rng.normal(0.0, 0.1, c)),
                             (m.running_mean, rng.normal(0.0, 0.1, c)),
                             (m.running_var, rng.uniform(0.5, 1.5, c))):
                    t.copy_(torch.as_tensor(v, dtype=torch.float32))


def float64_copy(model):
    """The model with every parameter, buffer and compute dtype float64."""
    truth = copy.deepcopy(model).double()
    for m in truth.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return truth


# --- module references ------------------------------------------------------

def _filter_layers(model, s):
    f = getattr(model, f"CostFilter3D_{s}")
    return [getattr(f, f"BNReLUConv3D_{k}") for k in range(len(f._modules))]


def _cf_ref(s: int, i: int) -> Callable:
    """Cost filter `s`, launch `i` (0: the entry, on the raw volume)."""
    from lwsnet_tpu_torch.models.blocks import conv3d
    from lwsnet_tpu_torch.ops import stereo

    def ref(m, cast, args):
        layers = _filter_layers(m, s)
        dt, x = layers[i].dtype, cast(args[0])
        y = (layers[0](x[:, None]) if i == 0
             else conv3d(x.to(dt), layers[i].weight.to(dt)))
        if i < len(layers) - 1:
            return F.relu(layers[i + 1].BatchNorm_0(y)).to(dt)
        vol, start = cast(args[2]), args[3]
        cost = (y[:, 0] + vol).permute(0, 2, 3, 1)
        return stereo.soft_argmin(cost, start, start + cost.shape[-1])[..., 0]
    return ref


def _cf_exact(s: int, i: int) -> Callable:
    """Cost filter `s`'s fused last launch `i` as the kernel computes it:
    the conv in float32 on the launch's operands and on the layer's
    weights rounded to the model's dtype, plus the volume, then
    `stereo.soft_argmin` in float32."""
    from lwsnet_tpu_torch.models.blocks import conv3d
    from lwsnet_tpu_torch.ops import stereo

    def ref(m, cast, args):
        layer = _filter_layers(m, s)[i]
        x, vol, start = cast(args[0]), cast(args[2]), args[3]
        y = conv3d(x.float(), layer.weight.to(layer.dtype).float())
        cost = (y[:, 0] + vol.float()).permute(0, 2, 3, 1)
        return stereo.soft_argmin(cost, start, start + cost.shape[-1])[..., 0]
    return ref


def _towers(fn: Callable) -> Callable:
    """A reference on the two tower halves of a 2B batch, each on its
    tower's modules: fn(tower, half, which)."""
    def ref(m, cast, args):
        x = cast(args[0])
        B = x.shape[0] // 2
        return torch.cat([fn(m.RefinementTower_0, x[:B], 0),
                          fn(m.RefinementTower_1, x[B:], 1)], 0)
    return ref


def _run_blocks(mod, x, first: int, count: int):
    """`count` PreConvDW blocks of `mod` from `first` on x."""
    for k in range(first, first + count):
        x = getattr(mod, f"PreConvDW_{k}")(x)
    return x


def _blocks(owner: Callable, first: int, count: int) -> Callable:
    """A reference of `count` PreConvDW blocks from `first` of owner(m)."""
    def ref(m, cast, args):
        return _run_blocks(owner(m), cast(args[0]), first, count)
    return ref


def _head(m):
    return m.RefinementHead_0


def _rows_entry(tower, x, which):
    # the disparity half reads channel 0 of its zero-padded input
    return tower.Conv_0(x if which == 0 else x[:, :1], tower.dtype)


def _head_entry(m, cast, args):
    x = cast(args[0])
    B = x.shape[0] // 2
    return _head(m).PreConv_0(torch.cat([x[:B], x[B:]], 1))


def _head_output(m, cast, args):
    from lwsnet_tpu_torch.models.blocks import conv2d
    head = _head(m)
    return conv2d(cast(args[0]).to(head.dtype), head.out_weight.to(head.dtype),
                  padding=1)


def _chain_head(m, cast, args):
    x = cast(args[0])
    B = x.shape[0] // 2
    return _head(m)(torch.cat([x[:B], x[B:]], 1))


def _layers_entry(which: int) -> Callable:
    def ref(m, cast, args):
        tower = getattr(m, f"RefinementTower_{which}")
        return tower.Conv_0(cast(args[0]), tower.dtype)
    return ref


def _head_half(k: int) -> Callable:
    """Half k of the head entry: PreConv_0's BN-ReLU and conv on its
    channels k*C .. (k+1)*C - 1."""
    from lwsnet_tpu_torch.models.blocks import conv2d

    def ref(m, cast, args):
        pre, dt = _head(m).PreConv_0, _head(m).dtype
        x = cast(args[0])
        c = x.shape[1]
        # the BN of the doubled input holds half k's affine on half k
        act = F.relu(pre.BatchNorm_0(torch.cat([x, x], 1)))
        act = act[:, k * c:(k + 1) * c].to(dt)
        conv = pre.Conv_0
        return conv2d(act, conv.weight[:, k * c:(k + 1) * c].to(dt),
                      conv.stride, conv.padding, conv.dilation)
    return ref


def filter_plan(cfg) -> List[Launch]:
    """The cost filters' launches of stages 1-3, in order; routes named by
    width (`cf-entry-C`, `cf-C`, `skip-C`)."""
    from lwsnet_tpu_torch.ops.cuda.costfilter import filter_routes
    out = []
    n = cfg.layers_3d + 2
    for s in range(3):
        C = cfg.channels_3d * cfg.growth_rate[s]
        D = cfg.max_disp_list[s] if s == 0 else 2 * cfg.max_disp_list[s] - 1
        on_card = [{str(dt).replace("torch.", ""): getattr(
            filter_routes(dt, C, D), kind).route
            for dt in (torch.bfloat16, torch.float32)}
            for kind in ("entry", "layer", "skip")]
        out.append(Launch("conv3d_entry", f"cf-entry-{C}",
                          f"stage {s + 1} layer 0 (1->{C})", 1,
                          _cf_ref(s, 0), kernel_route=on_card[0]))
        out += [Launch("conv3d_bn_relu", f"cf-{C}",
                       f"stage {s + 1} layer {i} ({C}->{C})", C,
                       _cf_ref(s, i), kernel_route=on_card[1])
                for i in range(1, n - 1)]
        out.append(Launch("conv3d_skip_softargmin", f"skip-{C}",
                          f"stage {s + 1} layer {n - 1} ({C}->1) + skip + "
                          f"soft-argmin", C, _cf_ref(s, n - 1),
                          _cf_exact(s, n - 1), on_card[2]))
    return out


def refine_plan(cfg, engine: str, h: int, w: int) -> List[Launch]:
    """The stage-4 launches of `engine` at an h x w image, in order, each
    with its route on the card by dtype from the refinement's route rule
    (`refine_kernels.refine_routes`), which lists the same launches."""
    from lwsnet_tpu_torch.models.refine_kernels import refine_routes
    plan = _stage4_launches(cfg, engine, h, w)
    rules = [refine_routes(dt, engine, cfg.refine_channels, h, w)
             for dt in (torch.bfloat16, torch.float32)]
    if not len(plan) == len(rules[0]) == len(rules[1]):
        raise LookupError(f"{engine}: {len(plan)} references for "
                          f"{len(rules[0])} launches of the route rule")
    return [L._replace(kernel_route={"bfloat16": a.route,
                                     "float32": b.route})
            for L, a, b in zip(plan, *rules)]


def _stage4_launches(cfg, engine: str, h: int, w: int) -> List[Launch]:
    """`refine_plan`'s launches and their module references."""
    from lwsnet_tpu_torch.models.refinement import (HEAD_DILATIONS,
                                                    TOWER_DILATIONS)
    from lwsnet_tpu_torch.ops.cuda.refine import layer_plan

    c = cfg.refine_channels
    nt, nh = len(TOWER_DILATIONS), len(HEAD_DILATIONS)

    def Route(*args):  # a launch whose route is named at width c
        fn, route, *rest = args
        return Launch(fn, width_route(route, c), *rest)

    entry = Route("dense_layer", "dense-entry",
                  f"towers' entry (3->{c} | 1->{c})", 3,
                  _towers(_rows_entry))
    head_entry = Route("dense2_layer", "dense-two-input",
                       f"head entry ({2 * c}->{c})", c, _head_entry)
    output = Route("dense_layer", "dense-output", f"head output ({c}->1)",
                   c, _head_output)

    def where(part, first, count):
        return (f"{part} layers {first}..{first + count - 1}" if count > 1
                else f"{part} layer {first}")

    def tower_step(first, count, fn, route):  # both towers, one 2B batch
        return Route(fn, route, where("tower", first, count), c, _towers(
            lambda t, x, _: _run_blocks(t, x, first, count)))

    def head_step(first, count, fn, route):
        return Route(fn, route, where("head", first, count), c,
                     _blocks(_head, first, count))

    if engine == "chain":
        return [Route("chain_layer", "chain-tower", "towers (entry + 4)", 3,
                      _towers(lambda t, x, which: t(
                          x if which == 0 else x[:, :1]))),
                Route("chain_layer", "chain-head", "head", c, _chain_head)]
    if engine == "layers":
        def chain(step, dilations):
            """The dw-sep launches of `layer_plan`: pairs and solos."""
            out, k = [], 0
            for ds in layer_plan(h, w, dilations, c):
                pair = len(ds) == 2
                out.append(step(
                    k, len(ds), "fused_dwsep2" if pair else "fused_dwsep",
                    "layers-dwsep-pair" if pair else "layers-dwsep"))
                k += len(ds)
            return out

        def tower(which):
            ci = 3 if which == 0 else 1

            def step(first, count, fn, route):
                return Route(fn, route, where(f"tower {which}", first,
                                              count), c, _blocks(
                    lambda m: getattr(m, f"RefinementTower_{which}"),
                    first, count))
            return [Route("fused_dense", "layers-entry" if which == 0
                          else "layers-entry-1",
                          f"tower {which} entry ({ci}->{c})", ci,
                          _layers_entry(which))] + chain(step,
                                                         TOWER_DILATIONS)

        halves = [Route("fused_dense", "layers-head-half",
                        f"head entry half {k} ({c}->{c})", c, _head_half(k))
                  for k in (0, 1)]
        return (tower(0) + tower(1) + halves
                + chain(head_step, HEAD_DILATIONS)
                + [Route("fused_dense", "layers-output",
                         f"head output ({c}->1)", c, _head_output)])
    # "mxu" and "vpu": (layer function, route, layers a launch)
    fn, route, count = {"mxu": ("dense_layer", "dense-32", 1),
                        "vpu-paired": ("dwsep2_layer", "dwsep-pair", 2),
                        "vpu-unpaired": ("dwsep_layer", "dwsep", 1)}[engine]
    return ([entry]
            + [tower_step(i, count, fn, route) for i in range(0, nt, count)]
            + [head_entry]
            + [head_step(i, count, fn, route) for i in range(0, nh, count)]
            + [output])


# --- recording ---------------------------------------------------------------

def distances(got: torch.Tensor, module: torch.Tensor,
              truth: torch.Tensor) -> Dict[str, float]:
    """Mean and max |delta| of the launch and of the module reference from
    the truth, as fractions of the truth's span, and their ratios."""
    truth = truth.double()
    span = float(truth.max() - truth.min())
    if not span > 0:
        raise ValueError("the reference output is constant: ill-posed check")
    e_k = (got.double() - truth).abs()
    e_m = (module.double() - truth).abs()
    row = dict(span=span, kernel_mean=float(e_k.mean()) / span,
               module_mean=float(e_m.mean()) / span,
               kernel_max=float(e_k.max()) / span,
               module_max=float(e_m.max()) / span)

    def ratio(a, b):
        return a / b if b > 0 else (0.0 if a == 0 else float("inf"))
    row["mean_ratio"] = ratio(row["kernel_mean"], row["module_mean"])
    row["max_ratio"] = ratio(row["kernel_max"], row["module_max"])
    row["finite"] = bool(torch.isfinite(got).all())
    return row


def bars(dtype: torch.dtype, route: str):
    """(mean, max) ratio bars of `route` in `dtype`: its ROUTE_BARS entry,
    else its shipped route's (`shipped_route`), else MEAN_RATIO and
    MAX_RATIO; the max bar holds in float32 only."""
    name = str(dtype).replace("torch.", "")
    return ROUTE_BARS.get((name, route), ROUTE_BARS.get(
        (name, shipped_route(route)), (MEAN_RATIO, MAX_RATIO)))


def bar_ok(row: Dict, dtype: torch.dtype) -> bool:
    """chip_smoke.py phase 4's rule for one launch, at its route's bars;
    a bf16 fused last layer also within EXACT_RATIO of its exact
    reference."""
    mean, most = bars(dtype, row["route"])
    return (row["finite"] and row["mean_ratio"] <= mean
            and (dtype != torch.float32 or row["max_ratio"] <= most)
            and row.get("exact_ratio", 0.0) <= EXACT_RATIO)


class Recorder:
    """Stands behind the forward's layer functions (`recording`): each
    call takes the next launch of `plan`, calls the kernel, and, where
    `held` says so, holds its output against the launch's references on
    `model` (the launch's dtype) and `truth` (float64). `plant`: the route
    whose launch `nth` (0: the first) gets its weights scaled by
    PLANT_SCALE."""

    def __init__(self, model, truth, plan: Sequence[Launch],
                 held: Callable[[Launch], bool],
                 plant: Optional[str] = None,
                 log: Callable[[str], None] = print, nth: int = 0):
        self.model, self.truth, self.plan = model, truth, list(plan)
        self.held, self.plant, self.log = held, plant, log
        self.nth = nth
        self.dtype = model.cfg.dtype
        self.rows: List[Dict] = []
        self.launches = 0
        self.plant_seen = 0  # launches of the planted route so far
        self.planted_at: Optional[int] = None

    def call(self, fn: str, original: Callable, args, kwargs):
        i = self.launches
        if i >= len(self.plan) or self.plan[i].fn != fn:
            want = self.plan[i].fn if i < len(self.plan) else "no launch"
            raise LookupError(f"launch {i} ({fn}): no reference (the plan "
                              f"has {want} there)")
        launch = self.plan[i]
        # an entry's volume (B, D, H, W) is its one input channel
        channels = 1 if fn == "conv3d_entry" else args[0].shape[1]
        if channels != launch.channels:
            raise LookupError(f"launch {i} ({fn}, {launch.where}): "
                              f"{channels} input channels, the reference "
                              f"takes {launch.channels}")
        self.launches += 1
        kargs = list(args)
        planted = False
        if launch.route == self.plant:
            planted = self.plant_seen == self.nth
            self.plant_seen += 1
        if planted:
            self.planted_at = i
            for j in PLANT_ARGS[fn]:
                kargs[j] = ([k * PLANT_SCALE for k in kargs[j]]
                            if fn == "chain_layer"
                            else kargs[j] * PLANT_SCALE)
        out = original(*kargs, **kwargs)
        if self.held(launch):
            self.rows.append(self.check(i, launch, args, out, planted))
        return out

    def check(self, i, launch, args, out, planted) -> Dict:
        module = launch.ref(self.model, lambda t: t, args)
        truth = launch.ref(self.truth, lambda t: t.double(), args)
        if not module.shape == truth.shape == out.shape:
            raise ValueError(f"launch {i} ({launch.where}): output "
                             f"{tuple(out.shape)}, references "
                             f"{tuple(module.shape)}, {tuple(truth.shape)}")
        row = dict(index=i, fn=launch.fn, route=launch.route,
                   where=launch.where, shape=list(out.shape),
                   planted=planted, **distances(out, module, truth))
        if launch.kernel_route is not None:
            row["kernel_route"] = launch.kernel_route[
                str(self.dtype).replace("torch.", "")]
        if launch.exact is not None and self.dtype == torch.bfloat16:
            exact = distances(out, launch.exact(self.model, lambda t: t,
                                                args), truth)
            row["exact_mean"] = exact["module_mean"]
            row["exact_ratio"] = exact["mean_ratio"]
        del module, truth
        row["ok"] = bar_ok(row, self.dtype)
        self.log(f"{'ok  ' if row['ok'] else 'MISS'} #{i:2d} "
                 f"{launch.route:18s} {launch.where:38s} "
                 f"{str(tuple(out.shape)):22s} "
                 f"launch {100 * row['kernel_mean']:.4f} % "
                 f"(max {100 * row['kernel_max']:.3f}), module "
                 f"{100 * row['module_mean']:.4f} % "
                 f"(max {100 * row['module_max']:.3f}), ratio "
                 f"{row['mean_ratio']:.3f} (max {row['max_ratio']:.3f})"
                 + (f", exact {row['exact_ratio']:.3f}"
                    if "exact_ratio" in row else "")
                 + (" [planted]" if planted else ""))
        return row


@contextlib.contextmanager
def recording(rec: Recorder):
    """The forward's layer functions wrapped by `rec` inside the block."""
    from lwsnet_tpu_torch.models import refine_kernels
    from lwsnet_tpu_torch.ops.cuda import costfilter

    patched = [(costfilter, n) for n in FILTER_FNS]
    patched += [(refine_kernels, n) for n in (
        "dense_layer", "dense2_layer", "dwsep_layer", "dwsep2_layer",
        "chain_layer", "fused_dense", "fused_dwsep", "fused_dwsep2")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in patched]

    def wrap(name, original):
        def wrapper(*args, **kwargs):
            return rec.call(name, original, args, kwargs)
        return wrapper

    try:
        for mod, n, original in saved:
            setattr(mod, n, wrap(n, original))
        yield rec
    finally:
        for mod, n, original in saved:
            setattr(mod, n, original)


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside, its settings as they were
    after. By default cuDNN may take a non-deterministic algorithm for a
    convolution ahead of the launches, whose inputs then differ in their
    last bits from run to run, and a float32 max ratio, one element's
    error, moves with them ("trained_wide" `dense-32` under "mxu" read
    2.98 and 3.67 in two runs of chip_smoke.py phase 4b on an H100);
    inside, every run reads the same."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


# --- runs --------------------------------------------------------------------

def set_state(name: str):
    """The state dict of weight set `name` (None: the seed-0 network, whose
    batch norms `build` jitters)."""
    from lwsnet_tpu_torch.tools import parity
    if name == "seed0":
        return None
    if name not in SETS:
        raise ValueError(f"set {name!r}: expected one of {SETS}")
    return parity.load_weights(
        os.path.join(os.path.dirname(parity.FIXTURE), parity.WEIGHTS)
        + ":" + parity.WEIGHTS_OF[name])


def set_pair(name: str, h: int, w: int, device) -> List[torch.Tensor]:
    """The (1, h, w, 3) left and right inputs of weight set `name`."""
    from lwsnet_tpu_torch.data import transforms as T
    from lwsnet_tpu_torch.tools import parity
    if name == "seed0":  # chip_smoke.py phase 4's pair
        pair = [np.random.default_rng(k).standard_normal((h, w, 3))
                for k in (1, 2)]
    else:
        pair = [T.bottom_right_crop(x, h, w) for x in parity.set_pair(name)]
    return [torch.as_tensor(np.ascontiguousarray(x)[None],
                            dtype=torch.float32, device=device)
            for x in pair]


def build(engine: str, dtype: str, state, device,
          fields: Optional[Dict] = None):
    """LWSNet under `engine` in `dtype` with `state`, or the seed-0
    network with jittered batch norms; `fields`: further ModelConfig
    fields (e.g. ANYNET)."""
    from lwsnet_tpu_torch import LWSNet, ModelConfig
    model = LWSNet(ModelConfig(compute_dtype=dtype, **ENGINES[engine],
                               **(fields or {})), device=device, seed=0)
    if state is None:
        jitter_batchnorm(model, np.random.default_rng(3))
    else:
        model.load_state_dict(state)
    return model


def run_engine(model, truth, left, right, engine: str, *,
               hold_filters: bool = True, plant: Optional[str] = None,
               log: Callable[[str], None] = print, nth: int = 0) -> Dict:
    """One 4-stage kernel forward of `model` under `engine`, every launch
    recorded, under `cudnn_deterministic`: the cost filters' launches held
    where `hold_filters`, every stage-4 launch held; `plant`'s launch
    `nth` planted (`Recorder`). Returns the held rows, the number of launches,
    each matched to a reference, and, on the card, the launch counts the
    kernels made (set to 0 just before the forward)."""
    from lwsnet_tpu_torch import make_forward
    from lwsnet_tpu_torch.ops.cuda import build as kbuild

    cfg = model.cfg
    h, w = left.shape[1], left.shape[2]
    plan = filter_plan(cfg) + refine_plan(cfg, engine, h, w)
    rec = Recorder(model, truth, plan,
                   lambda L: hold_filters or L.fn not in FILTER_FNS,
                   plant=plant, log=log, nth=nth)
    dev = left.device
    kbuild.reset_launch_counts()
    with recording(rec), cudnn_deterministic():
        outs = make_forward(model, use_pallas=True, device=dev)(left, right)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if rec.launches != len(plan):
        raise LookupError(f"{engine}: {rec.launches} launches, the plan "
                          f"has {len(plan)}")
    return dict(engine=engine, rows=rec.rows, launches=rec.launches,
                held=len(rec.rows),
                kernel_counts=(kbuild.launch_counts() if dev.type == "cuda"
                               else None),
                planted_at=rec.planted_at, outputs=outs)


def check_set(set_name: str, dtype: str, engines: Sequence[str], h: int,
              w: int, device, log: Callable[[str], None] = print,
              fields: Optional[Dict] = None) -> Dict:
    """The sound check of weight set `set_name` in `dtype` under each of
    `engines`: the cost filters held under the first, every stage-4
    launch under each. `fields`: further ModelConfig fields (the seed-0
    set only). Returns {engine: run_engine's result, without the
    outputs}."""
    if fields and set_name != "seed0":
        raise ValueError(f"set {set_name!r} holds the shipped "
                         f"configuration's weights; {fields} runs on "
                         f"\"seed0\" only")
    state = set_state(set_name)
    left, right = set_pair(set_name, h, w, device)
    out, truth = {}, None
    for k, engine in enumerate(engines):
        model = build(engine, dtype, state, device, fields)
        if truth is None:  # every engine's modules hold the same weights
            truth = float64_copy(model)
        log(f"{set_name} {dtype} {engine}:")
        res = run_engine(model, truth, left, right, engine,
                         hold_filters=k == 0, log=log)
        res.pop("outputs")
        out[engine] = res
        del model
    return out


def check_plant(route: str, h: int, w: int, device,
                log: Callable[[str], None] = print,
                fields: Optional[Dict] = None, nth: int = 0,
                dtype: str = "bfloat16") -> Dict:
    """`route`'s launch `nth` (0: the first) planted (weights x
    PLANT_SCALE, kernel side) on the seed-0 set in `dtype` under the
    engine of ROUTES ("mxu" for a cost-filter route of another width),
    every launch held; `fields`: further ModelConfig fields. Returns
    run_engine's result without the outputs, with "caught": the planted
    launch alone missed its bar."""
    engine = ROUTES.get(shipped_route(route), "mxu")
    model = build(engine, dtype, None, device, fields)
    left, right = set_pair("seed0", h, w, device)
    res = run_engine(model, float64_copy(model), left, right, engine,
                     plant=route, log=log, nth=nth)
    res.pop("outputs")
    if res["planted_at"] is None:
        raise LookupError(f"{route}: no launch of the route under {engine}")
    res["missed"] = [r["index"] for r in res["rows"] if not r["ok"]]
    res["caught"] = res["missed"] == [res["planted_at"]]
    return res


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--plant", type=str, default="", help=f"scale the "
                   f"weights of ROUTE's first launch by {PLANT_SCALE} "
                   "(seed-0 set, bf16, ROUTE's engine); the check must fail "
                   "there and nowhere else")
    p.add_argument("--height", type=int, default=H)
    p.add_argument("--width", type=int, default=W)
    p.add_argument("--out", type=str, default="results/PARITY_LAYERS.json")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--maxdisplist", type=int, nargs="+")
    p.add_argument("--channels_3d", type=int)
    p.add_argument("--layers_3d", type=int)
    p.add_argument("--growth_rate", type=int, nargs="+")
    p.add_argument("--refine_channels", type=int)
    args = p.parse_args(argv)

    from lwsnet_tpu_torch.device import resolve_device
    from lwsnet_tpu_torch.tools.parity import tf32_off

    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in (("max_disp_list", args.maxdisplist),
                           ("channels_3d", args.channels_3d),
                           ("layers_3d", args.layers_3d),
                           ("growth_rate", args.growth_rate),
                           ("refine_channels", args.refine_channels))
              if v is not None}
    dev = resolve_device(args.device)
    t0 = time.time()
    result: Dict = {"device": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                    "size": [args.height, args.width], "config": fields}
    with tf32_off():
        if args.plant:
            result["plant"] = check_plant(args.plant, args.height,
                                          args.width, dev, fields=fields)
            ok = result["plant"]["caught"]
        else:
            result["sets"] = {
                f"{s} {d}": check_set(s, d, list(ENGINES), args.height,
                                      args.width, dev, fields=fields)
                for s in (("seed0",) if fields else SETS)
                for d in ("bfloat16", "float32")}
            ok = all(r["ok"] for runs in result["sets"].values()
                     for res in runs.values() for r in res["rows"])
    result["seconds"] = time.time() - t0
    result["pass"] = bool(ok)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"parity_layers: {'PASS' if ok else 'FAIL'} in "
          f"{result['seconds']:.1f} s ({args.out})")
    return result


if __name__ == "__main__":
    raise SystemExit(0 if main()["pass"] else 1)
