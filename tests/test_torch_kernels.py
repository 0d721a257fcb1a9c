"""The port's kernel functions against the JAX package's Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version, which is
what the CUDA kernel computes; the JAX side runs its Pallas kernels in
interpret mode, as the JAX package's own tests do. float32 throughout
(TF32 does not arise on the CPU). The CUDA kernels themselves are held
against the plain versions on the card by `tests/test_torch_gpu.py` and by
`chip_smoke.py`.
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

from lwsnet_tpu.models import refine_pallas  # noqa: E402
from lwsnet_tpu.ops.pallas import costfilter as jcf  # noqa: E402
from lwsnet_tpu.ops.pallas import refine_rows as jrr  # noqa: E402
from lwsnet_tpu_torch import LWSNet, ModelConfig  # noqa: E402
from lwsnet_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                      to_jax_variables)
from lwsnet_tpu_torch.models.blocks import (CostFilter3D,  # noqa: E402
                                            init_params)
from lwsnet_tpu_torch.models.refine_kernels import refine_residual  # noqa
from lwsnet_tpu_torch.ops.cuda import costfilter as tcf  # noqa: E402
from lwsnet_tpu_torch.ops.cuda import refine_rows as trr  # noqa: E402
from test_torch_model import jitter  # noqa: E402

f32 = jnp.float32


@pytest.mark.parametrize("case", [
    # (B, H, W, D, layers, channels, start): the cases of
    # tests/test_pallas_costfilter.py, both JAX formulations
    (2, 8, 12, 6, 2, 8, 0),     # folded-D
    (1, 6, 10, 9, 1, 4, -4),    # folded-D, residual bins
    (1, 8, 12, 6, 2, 24, 0),    # d-grid
    (1, 16, 24, 24, 4, 32, 0),  # d-grid at the stage-1 config
])
def test_filter_soft_argmin(case):
    B, H, W, D, layers, channels, start = case
    rng = np.random.default_rng(7)
    cost = rng.standard_normal((B, H, W, D)).astype(np.float32)
    port = CostFilter3D(layers, channels)
    init_params(port, torch.Generator().manual_seed(0))
    variables = jitter(to_jax_variables(port.state_dict()), rng)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    want = jax.jit(functools.partial(
        jcf.filter_soft_argmin, layers=layers, channels=channels,
        start=start, dtype=f32, interpret=True))(
        jnp.asarray(cost), variables["params"], variables["batch_stats"])

    got = tcf.filter_soft_argmin(
        torch.from_numpy(cost), dict(port.named_parameters()),
        dict(port.named_buffers()), layers=layers, channels=channels,
        start=start, dtype=torch.float32)
    assert got.shape == (B, H, W, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-3)


H2, W2 = 40, 96


def _rand_affine(rng, G, C):
    return np.stack([rng.uniform(0.5, 1.5, (G, C)),
                     rng.normal(0, 0.5, (G, C))], 1).astype(np.float32)


def _oihw(k):
    """([G,] 3, 3, Ci, Co) HWIO -> ([G,] Co, Ci, 3, 3)."""
    axes = (0, 4, 3, 1, 2) if k.ndim == 5 else (3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, axes)))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1,
                                                                  2))))


def _from_port(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("ci,co,d,affine,groups", [
    (3, 32, 1, False, 2),   # grouped tower entry
    (8, 8, 2, True, 2),     # grouped tower layer
    (8, 8, 16, True, 2),    # grouped tower layer, widest dilation
    (8, 8, 4, True, 1),     # head layer
    (8, 1, 1, False, 1),    # output conv
])
def test_dense_layer(ci, co, d, affine, groups):
    rng = np.random.default_rng(ci * 100 + d)
    x = rng.standard_normal((2, H2, W2, ci)).astype(np.float32)
    shape = (3, 3, ci, co) if groups == 1 else (groups, 3, 3, ci, co)
    kernel = (rng.standard_normal(shape) / np.sqrt(9 * ci)).astype(
        np.float32)
    aff = _rand_affine(rng, groups, ci) if affine else None
    if aff is not None and groups == 1:
        aff = aff[0]
    S, NR = jrr.canvas_geom(H2, W2)
    want = jrr.from_canvas(jrr.dense_layer(
        jrr.to_canvas(jnp.asarray(x), S, NR, f32), jnp.asarray(kernel),
        dilation=d, S=S, NR=NR,
        affine=None if aff is None else jnp.asarray(aff), groups=groups,
        interpret=True), H2, W2, S, NR, co)
    got = trr.dense_layer(
        _nchw(x), _oihw(kernel), dilation=d,
        affine=None if aff is None else torch.from_numpy(aff),
        groups=groups)
    np.testing.assert_allclose(_from_port(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_dense2_layer():
    ci, co, d = 8, 8, 8
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, H2, W2, ci)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 2 * ci, co)) / np.sqrt(18 * ci)
              ).astype(np.float32)
    aff = _rand_affine(rng, 1, 2 * ci)[0]
    S, NR = jrr.canvas_geom(H2, W2)
    want = jrr.from_canvas(jrr.dense2_layer(
        jrr.to_canvas(jnp.asarray(x), S, NR, f32), jnp.asarray(kernel),
        dilation=d, S=S, NR=NR, affine=jnp.asarray(aff), interpret=True),
        H2, W2, S, NR, co)
    got = trr.dense2_layer(_nchw(x), _oihw(kernel), dilation=d,
                           affine=torch.from_numpy(aff))
    assert got.shape == (1, co, H2, W2)
    np.testing.assert_allclose(_from_port(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


ENGINES = {"mxu": ("mxu", True), "vpu-paired": ("vpu", True),
           "vpu-unpaired": ("vpu", False), "chain": ("chain", True)}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_refine_residual(engine):
    """The whole stage-4 kernel path (rows, each engine) at 48x96."""
    dw, paired = ENGINES[engine]
    H, W = 48, 96
    rng = np.random.default_rng(11)
    model = LWSNet(ModelConfig(compute_dtype="float32", rows_dw=dw,
                               rows_paired=paired), device="cpu")
    variables = jitter(to_jax_variables(model.state_dict()), rng)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    disp = rng.uniform(0, 20, (1, H, W, 1)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        refine_pallas.refine_residual, dtype=f32, interpret=True,
        mode="rows", dw=dw, paired=paired))(variables, jnp.asarray(left),
                                            jnp.asarray(disp)))
    with torch.no_grad():
        got = refine_residual(model, torch.from_numpy(left),
                              torch.from_numpy(disp)).numpy()
    assert got.shape == (1, H, W, 1)
    span = np.abs(want).max() + 1.0
    assert np.abs(got - want).max() < 1e-4 * span


@pytest.mark.parametrize("where", ["config", "call"])
def test_unknown_pallas_mode_raises(where):
    """Only "rows" and "layers" exist, in the config and per call."""
    if where == "config":
        with pytest.raises(ValueError, match="pallas_mode"):
            ModelConfig(pallas_mode="planar")
        return
    model = LWSNet(ModelConfig(compute_dtype="float32"), device="cpu")
    x = torch.zeros(1, 16, 16, 3)
    with pytest.raises(ValueError, match="pallas_mode"):
        refine_residual(model, x, torch.zeros(1, 16, 16, 1), mode="planar")


def test_unknown_engine_raises():
    model = LWSNet(ModelConfig(compute_dtype="float32", rows_dw="tpu"),
                   device="cpu")
    x = torch.zeros(1, 16, 16, 3)
    with pytest.raises(ValueError, match="rows_dw"):
        refine_residual(model, x, torch.zeros(1, 16, 16, 1))


def test_wrappers_take_no_other_device():
    """A wrapper runs its plain version only for a CPU tensor."""
    x = torch.empty(1, 1, 3, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tcf.conv3d_bn_relu(x, torch.empty(8, 1, 3, 3, 3, device="meta"),
                           torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        trr.dense3x3(torch.empty(1, 3, 8, 8, device="meta"),
                     torch.empty(1, 8, 3, 3, 3, device="meta"), dilation=1)
    meta = torch.empty(1, 8, 8, 8, device="meta")
    w = torch.empty(1, 8, 3, 3, device="meta")
    pw = torch.empty(1, 8, 8, device="meta")
    aff = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        trr.dwsep(meta, w, pw, dilation=1, affine=aff)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        trr.dwsep2(meta, w, pw, w, pw, dilation1=1, dilation2=2,
                   affine1=aff, affine2=aff)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        trr.chain(meta, [torch.empty(1, 8, 8, 3, 3, device="meta")], [None],
                  dilations=(1,))

