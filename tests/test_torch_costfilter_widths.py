"""The cost filters at every width and disparity count the JAX kernels take,
on the CPU.

The JAX package's `filter_soft_argmin` builds its layers from any
`channels` and `layers` and takes any D (its folded kernels where
(D + 2) C <= 128, its d-grid kernels otherwise); both CLIs expose the
widths and counts as flags. Here: `costfilter.filter_routes` gives every
(dtype, width, D) a route whose layouts chain from launch to launch with
no copy; the port's `filter_soft_argmin` matches JAX's (Pallas kernels in
interpret mode) at AnyNet's stage shapes (`parity_layers.ANYNET`: widths
16 / 4 / 4 over D = 12 / 5 / 5) and at a wide one (64 channels over
D = 72); and the whole 4-stage forward at AnyNet's settings matches JAX's
kernel path. float32 throughout; the kernels themselves run on the card
(`tests/test_torch_gpu.py`, `chip_smoke.py` phase 14).
"""

import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lwsnet_tpu import LWSNet as JLWSNet  # noqa: E402
from lwsnet_tpu import ModelConfig as JConfig  # noqa: E402
from lwsnet_tpu.inference import make_forward as jmake_forward  # noqa: E402
from lwsnet_tpu.ops.pallas import costfilter as jcf  # noqa: E402
from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward  # noqa: E402
from lwsnet_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                      to_jax_variables)
from lwsnet_tpu_torch.models.blocks import (CostFilter3D,  # noqa: E402
                                            init_params)
from lwsnet_tpu_torch.ops.cuda import costfilter as tcf  # noqa: E402
from lwsnet_tpu_torch.tools.parity_layers import ANYNET  # noqa: E402
from test_torch_model import _span_check, jitter  # noqa: E402

D_COUNTS = (1, 5, 12, 24, 64, 65, 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_width_and_d_has_a_chained_route(dtype):
    """Every (dtype, channels 1-64, D) has a route for each launch, and
    each launch reads the layout the one before it writes: the entry's
    output, each C -> C layer's input and output and the fused last
    layer's input lie alike. The tensor cores take the bf16 entries and
    C -> C layers and the fused last layer at 32, 16, 64, 8 or 4 channels
    (at every D), the CUDA cores everything else; the activations lie
    channels-last where the fused last layer takes the wgmma route (at
    bf16 4 the entry writes and the 4 -> 4 layers read and write NCDHW, as
    the fused last layer's mma.sync route reads it). The
    entries at 4 write nothing but NCDHW, those at 16, 32 and 64 nothing
    but channels-last, at 8 either layout."""
    bf = dtype == torch.bfloat16
    for C in range(1, 65):
        for D in D_COUNTS:
            r = tcf.filter_routes(dtype, C, D)
            for launch in r:
                assert launch.route in (tcf.TENSOR_CORES, tcf.CUDA_CORES)
            assert r.entry.writes_cl == r.layer.reads_cl == \
                r.layer.writes_cl == r.skip.reads_cl, (C, D)
            cl = bf and C in (8, 16, 32, 64)
            tc = bf and C in (4, 8, 16, 32, 64)
            ends = tc
            assert r.layer.reads_cl == cl, (C, D)
            assert (r.entry.route == tcf.TENSOR_CORES) == ends
            assert (r.layer.route == tcf.TENSOR_CORES) == tc
            assert (r.skip.route == tcf.TENSOR_CORES) == tc, (C, D)
            # the per-launch rules of the two kernels agree with it
            assert tcf.conv3d_tensor_core_route(dtype, C, C) == tc
            assert tcf.conv3d_reads_channels_last(dtype, C, C) == cl
            assert tcf.conv3d_tensor_core_route(dtype, 1, C) == ends
            assert tcf.conv3d_writes_ncdhw(dtype, 1, C) == (
                not ends or C in (4, 8)), (C, D)
            assert tcf.conv3d_writes_channels_last(dtype, 1, C) == (
                not ends or C != 4), (C, D)
            assert tcf.skip_tensor_core_route(dtype, C) == tc
    with pytest.raises(ValueError):
        tcf.filter_routes(dtype, 0, 5)
    with pytest.raises(ValueError):
        tcf.filter_routes(dtype, 4, 0)


@pytest.mark.parametrize("B,H,W,D,layers,C,start", [
    (1, 8, 12, 12, 4, 16, 0),    # AnyNet's stage 1: JAX's d-grid kernels
    (1, 8, 12, 5, 4, 4, -2),     # its stages 2-3: JAX's folded kernels
    (1, 8, 12, 72, 4, 64, 0),    # wide: stage 1 at channels_3d 16, D = 72
])
def test_filter_soft_argmin_widths_match_jax(B, H, W, D, layers, C, start):
    """The port's filter + skip + soft-argmin (each kernel's plain version)
    against the JAX package's `filter_soft_argmin` in interpret mode on
    the same jittered weights, at atol 2e-4 / rtol 1e-3, the JAX test's
    tolerance (tests/test_pallas_costfilter.py)."""
    rng = np.random.default_rng(D * 100 + C)
    cost = rng.standard_normal((B, H, W, D)).astype(np.float32)
    port = CostFilter3D(layers, C)
    init_params(port, torch.Generator().manual_seed(0))
    variables = jitter(to_jax_variables(port.state_dict()), rng)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    want = jax.jit(functools.partial(
        jcf.filter_soft_argmin, layers=layers, channels=C, start=start,
        dtype=jnp.float32, interpret=True))(
        jnp.asarray(cost), variables["params"], variables["batch_stats"])
    got = tcf.filter_soft_argmin(
        torch.from_numpy(cost), dict(port.named_parameters()),
        dict(port.named_buffers()), layers=layers, channels=C, start=start,
        dtype=torch.float32)
    assert got.shape == (B, H, W, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-3)


def test_forward_at_anynet_settings_matches_jax():
    """The 4-stage forward at AnyNet's cost-filter settings at 64x128: the
    port's `make_forward(device="cpu")` (each kernel's plain version)
    against JAX's `make_forward` with its Pallas kernels in interpret
    mode, on the same jittered weights carried across by
    `convert.from_jax_variables`, at the whole-model bar of
    tests/test_torch_inference.py (`_span_check`)."""
    rng = np.random.default_rng(0)
    left, right = (rng.standard_normal((1, 64, 128, 3)).astype(np.float32)
                   for _ in range(2))
    model = LWSNet(ModelConfig(compute_dtype="float32", **ANYNET),
                   device="cpu")
    variables = jitter(to_jax_variables(model.state_dict()),
                       np.random.default_rng(1))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    jmodel = JLWSNet(JConfig(compute_dtype="float32", **ANYNET))
    want = jax.jit(jmake_forward(jmodel, use_pallas=True, interpret=True))(
        variables, jnp.asarray(left), jnp.asarray(right))
    got = make_forward(model, device="cpu")(torch.from_numpy(left),
                                            torch.from_numpy(right))
    assert [tuple(g.shape) for g in got] == [(1, 64, 128, 1)] * 4
    _span_check(got, want)
