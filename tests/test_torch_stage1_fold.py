"""Stage 1's bf16 cost filter against JAX's own Pallas kernel path.

On the fixture's "trained_wide" set the port's bf16 kernel path lies
1.15-1.21 x the module path's distance from JAX's float32 module path,
over `tools.parity.KERNEL_RATIO` (`parity.UNRATIOED`). The cause is stage
1's entry, which folds layer 1's BN scale into bf16 weights
(`ops/cuda/costfilter.filter_soft_argmin`). JAX's Pallas filter
(`lwsnet_tpu/ops/pallas/costfilter.py`: `_aug_weights` multiplies layer
k's weights by layer k+1's folded scale in float32, then casts them to
the compute dtype; `_dgrid_call` feeds them to `_dgrid_kernel`) folds the
same way. Here the three filters run on one stage-1 volume, the port's
float32 module path's on `parity.wide_pair(0)` with the trained weights
(46 x 154 x 24 at 368x1232, spanning about 20 of its 24 bins):

1. JAX's `filter_soft_argmin(..., dtype=bfloat16, interpret=True)`, the
   weights bridged by `convert.to_jax_variables`;
2. the port's `filter_soft_argmin` in bf16 (the kernels' plain versions
   on the CPU);
3. the float32 module filter (`CostFilter3D` + skip + soft-argmin).

Bars: (2)'s mean |delta| from (3) within KERNEL_RATIO of (1)'s, either
way; (2) from (1) at most a quarter of either one's distance from (3);
and (1) from (3) over KERNEL_RATIO x the bf16 module filter's, so the
JAX kernel path misses the ratio on this volume by its own rounding.
Readings (torch 2.13, jax 0.9, CPU): (1) 0.02880, (2) 0.02851 bins from
(3), ratio 0.990; (2) from (1) 0.00435 (0.151 of the nearer); the bf16
module filter 0.02093 from (3), so (1) reads 1.376 x it. Two variants
show where the port rounds: the fold left in float32 on the entry alone
lies 0.02397 from (1), 5.5 x the shipped port's distance (bar 4 x); the
folded BN bias rounded to bf16 as `_aug_weights` rounds its bias column
brings the port to 0.00269 of (1) (0.62 of the shipped distance, bar
0.75): the port keeps that bias in float32, one rounding fewer than JAX.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lwsnet_tpu.ops.pallas import costfilter as JCF
from lwsnet_tpu_torch import ModelConfig
from lwsnet_tpu_torch.convert import to_jax_variables
from lwsnet_tpu_torch.ops import stereo
from lwsnet_tpu_torch.ops.cuda import costfilter as CF
from lwsnet_tpu_torch.tools import parity

WEIGHTS = "tests/torch_fixtures/parity_weights.pt:trained"
LAYERS, CHANNELS = 4, 32  # ModelConfig(): layers_3d, channels_3d x 1


def _mean_delta(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).mean())


def _port_filter(cost, params, stats):
    """The port's bf16 filter (stage 1: start 0), as a flat array."""
    with torch.no_grad():
        out = CF.filter_soft_argmin(cost, params, stats, layers=LAYERS,
                                    channels=CHANNELS, start=0,
                                    dtype=torch.bfloat16)
    return out.float().numpy().reshape(-1)


@pytest.fixture(scope="module")
def stage1():
    """Stage 1's float32 volume and the filters on it, flat, in bins."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sd = parity.load_weights(os.path.join(repo, WEIGHTS))
    m32 = parity.build_model(ModelConfig(compute_dtype="float32"), sd,
                             "cpu").eval()
    left, right = parity.wide_pair(0)
    both = torch.from_numpy(np.stack([left, right])).permute(0, 3, 1, 2)
    with torch.no_grad():
        f = m32.FeatureExtractor_0(both)[0].permute(0, 2, 3, 1)
        D = m32.cfg.max_disp_list[0]
        cost = stereo.build_cost_volume(f[:1], f[1:], D)
        filt = m32.CostFilter3D_0
        ref = stereo.soft_argmin(filt(cost) + cost, 0, D)
        mb = parity.build_model(ModelConfig(compute_dtype="bfloat16"), sd,
                                "cpu").eval()
        cb = cost.to(torch.bfloat16)
        module_bf16 = stereo.soft_argmin(mb.CostFilter3D_0(cb) + cb, 0, D)
    params = dict(filt.named_parameters())
    stats = dict(filt.named_buffers())
    variables = to_jax_variables(sd)
    jax_out = JCF.filter_soft_argmin(
        jnp.asarray(cost.numpy()), variables["params"]["CostFilter3D_0"],
        variables["batch_stats"]["CostFilter3D_0"], layers=LAYERS,
        channels=CHANNELS, start=0, dtype=jnp.bfloat16, interpret=True)
    return dict(cost=cost, params=params, stats=stats, D=D,
                ref=ref.numpy().reshape(-1),
                jax=np.asarray(jax_out).reshape(-1),
                port=_port_filter(cost, params, stats),
                module_bf16=module_bf16.float().numpy().reshape(-1))


def test_stage1_volume_spans_its_guard(stage1):
    """The float32 filter spans more than SPAN_GUARD of stage 1's bins."""
    assert stage1["cost"].shape == (1, 46, 154, 24)
    span_px = float(np.ptp(stage1["ref"])) * 8.0  # bins at 1/8 res
    guard = parity.SPAN_GUARD * parity.bin_range_px(ModelConfig(), 1)
    assert span_px > guard, (span_px, guard)


def test_port_bf16_filter_rounds_as_jax_kernel(stage1):
    jax_d = _mean_delta(stage1["jax"], stage1["ref"])
    port_d = _mean_delta(stage1["port"], stage1["ref"])
    between = _mean_delta(stage1["port"], stage1["jax"])
    print("stage 1 from the float32 module filter: JAX kernel", jax_d,
          "port", port_d, "ratio", port_d / jax_d, "port from JAX", between)
    assert jax_d / parity.KERNEL_RATIO <= port_d \
        <= parity.KERNEL_RATIO * jax_d, (port_d, jax_d)
    assert between <= 0.25 * min(jax_d, port_d), (between, jax_d, port_d)


def test_jax_kernel_path_misses_kernel_ratio_by_its_own_rounding(stage1):
    jax_d = _mean_delta(stage1["jax"], stage1["ref"])
    module_d = _mean_delta(stage1["module_bf16"], stage1["ref"])
    print("JAX kernel", jax_d, "bf16 module filter", module_d,
          "ratio", jax_d / module_d)
    assert jax_d > parity.KERNEL_RATIO * module_d, (jax_d, module_d)


def _float32_fold(stage1):
    """The entry's folded weights kept in float32, activations and output
    rounded to bf16 as before."""
    params, stats = stage1["params"], stage1["stats"]
    a1, _ = CF._fold_bn(params, stats, "BNReLUConv3D_1.BatchNorm_0")
    wt = params["BNReLUConv3D_0.weight"].float() * a1.view(-1, 1, 1, 1, 1)

    def entry(vol, a0b0, _, shift):
        act = F.relu(vol.float() * a0b0[0] + a0b0[1]).to(vol.dtype)
        return CF.conv3d_bn_relu_plain(act.float()[:, None], wt,
                                       shift).to(vol.dtype)
    return {"conv3d_entry": entry}


def _bias_rounded(_):
    """Every layer's folded BN bias rounded to bf16, as `_aug_weights`
    rounds its bias column."""
    entry, layer = CF.conv3d_entry, CF.conv3d_bn_relu
    return {"conv3d_entry": lambda vol, a0b0, wt, shift: entry(
                vol, a0b0, wt, shift.bfloat16().float()),
            "conv3d_bn_relu": lambda x, wt, shift, **kw: layer(
                x, wt, shift.bfloat16().float(), **kw)}


@pytest.mark.parametrize("variant, bar", [
    ("float32_fold", 4.0), ("bias_rounded", 0.75)])
def test_rounding_variants_move_the_port_from_jax(stage1, monkeypatch,
                                                  variant, bar):
    """Against the shipped port's distance from JAX: the fold left in
    float32 lies at least `bar` x as far (JAX folds in bf16); the bias
    rounded to bf16 at most `bar` x as far (JAX rounds it, the port
    does not)."""
    patch = {"float32_fold": _float32_fold,
             "bias_rounded": _bias_rounded}[variant](stage1)
    for name, fn in patch.items():
        monkeypatch.setattr(CF, name, fn)
    got = _port_filter(stage1["cost"], stage1["params"], stage1["stats"])
    shipped = _mean_delta(stage1["port"], stage1["jax"])
    moved = _mean_delta(got, stage1["jax"])
    print(variant, "from JAX", moved, "shipped", shipped,
          "ratio", moved / shipped)
    if variant == "float32_fold":
        assert moved >= bar * shipped, (moved, shipped)
    else:
        assert moved <= bar * shipped, (moved, shipped)
