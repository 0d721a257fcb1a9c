"""The port's planar "layers" refinement path against the JAX package.

`fused_dense`, `fused_dwsep`, `fused_dwsep2` and `layer_plan` of
`lwsnet_tpu_torch.ops.cuda.refine` run their kernels' plain PyTorch
versions on the CPU; the JAX side runs the planar Pallas kernels of
`lwsnet_tpu.ops.pallas.refine` on a layer canvas in interpret mode, as
`tests/test_pallas_refine.py` runs them, at that file's bar (atol and rtol
1e-4). Then the whole `pallas_mode="layers"` refinement and the 4-stage
forward against the JAX layers path on bridged, BN-jittered weights. The
rows microbench's probe is held against the JAX `bkernel` body. float32
throughout, on inputs made from a numpy seed.
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
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from lwsnet_tpu import LWSNet as JLWSNet  # noqa: E402
from lwsnet_tpu import ModelConfig as JConfig  # noqa: E402
from lwsnet_tpu.inference import make_forward as jmake_forward  # noqa: E402
from lwsnet_tpu.models import refine_pallas  # noqa: E402
from lwsnet_tpu.ops.pallas import refine as K  # noqa: E402
from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward  # noqa: E402
from lwsnet_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                      to_jax_variables)
from lwsnet_tpu_torch.models.refine_kernels import refine_residual  # noqa
from lwsnet_tpu_torch.ops.cuda import probe  # noqa: E402
from lwsnet_tpu_torch.ops.cuda import refine as T  # noqa: E402
from lwsnet_tpu_torch.tools import microbench_rows  # noqa: E402
from lwsnet_tpu_torch.utils import timing  # noqa: E402
from test_torch_model import _span_check, jitter, setup  # noqa: E402,F401

f32 = jnp.float32
H, W = 48, 96


def _affine(rng, c):
    return np.stack([rng.uniform(0.5, 1.5, c),
                     rng.normal(0, 0.5, c)]).astype(np.float32)


def _dwsep_weights(rng, c, co):
    """(affine (2, c), taps (3, 3, 1, c) HWIO, pointwise (co, c))."""
    return (_affine(rng, c),
            (rng.standard_normal((3, 3, 1, c)) / 3).astype(np.float32),
            (rng.standard_normal((co, c)) / np.sqrt(c)).astype(np.float32))


def _jax_planar(fn, x, chunk, *args, **kw):
    """Run a planar Pallas layer on the canvas of NHWC x, in interpret
    mode; NHWC out."""
    xc = K.layer_canvas(jnp.transpose(jnp.asarray(x), (0, 3, 1, 2)), chunk)
    out = fn(xc, *[jnp.asarray(a) for a in args], chunk=chunk, h_real=H,
             w_real=W, interpret=True, **kw)
    return np.asarray(jnp.transpose(K.layer_uncanvas(out, chunk, H, W),
                                    (0, 2, 3, 1)))


def _port(fn, x, *args, **kw):
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    args = [None if a is None else torch.from_numpy(a) for a in args]
    return fn(x, *args, **kw).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("ci,co,d,affine", [
    (3, 32, 1, False),   # left tower entry: the im2col stack body
    (1, 32, 1, False),   # disparity tower entry, 1 channel
    (32, 16, 8, True),   # head half: the per-tap body, with affine
    (32, 1, 1, False),   # output conv: the Co = 1 body
])
def test_fused_dense(ci, co, d, affine):
    rng = np.random.default_rng(ci * 100 + co)
    x = rng.standard_normal((1, H, W, ci)).astype(np.float32)
    kern = (rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci)).astype(
        np.float32)
    aff = _affine(rng, ci) if affine else None
    want = _jax_planar(K.fused_dense, x, 16, kern, dilation=d,
                       affine=None if aff is None else jnp.asarray(aff))
    got = _port(T.fused_dense, x, kern, dilation=d,
                affine=None if aff is None else torch.from_numpy(aff))
    assert got.shape == (1, H, W, co)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d", [8, 16])
def test_fused_dwsep(d):
    """The solo layers of the wide-image split."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((1, H, W, 32)).astype(np.float32)
    w = _dwsep_weights(rng, 32, 32)
    want = _jax_planar(K.fused_dwsep, x, 16, *w, dilation=d)
    got = _port(T.fused_dwsep, x, *w, dilation=d)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d1,d2", [(2, 4), (8, 16), (8, 4), (2, 1)])
def test_fused_dwsep2(d1, d2):
    """The four pairs of the towers and the head."""
    rng = np.random.default_rng(100 * d1 + d2)
    x = rng.standard_normal((1, H, W, 32)).astype(np.float32)
    w1, w2 = _dwsep_weights(rng, 32, 32), _dwsep_weights(rng, 32, 32)
    want = _jax_planar(K.fused_dwsep2, x, 32, *w1, *w2, dilation1=d1,
                       dilation2=d2)
    got = _port(T.fused_dwsep2, x, *w1, *w2, dilation1=d1, dilation2=d2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _jax_plan(h, w, dilations, monkeypatch):
    """The launches the JAX `_dwsep_chain` makes at h x w, recorded."""
    steps = []

    def pair(y, *args, dilation1, dilation2, **kw):
        steps.append((dilation1, dilation2))
        return y

    def solo(y, *args, dilation, **kw):
        steps.append((dilation,))
        return y

    monkeypatch.setattr(K, "fused_dwsep2", pair)
    monkeypatch.setattr(K, "fused_dwsep", solo)
    chunk = K.pick_layer_chunk(h, w, 32)
    none = [None] * len(dilations)
    refine_pallas._dwsep_chain(None, none, none, none, dilations, chunk, h,
                               w, True)
    return tuple(steps)


@pytest.mark.parametrize("h,w", [(368, 1232), (96, 3712), (48, 96),
                                 (48, 7424)])
def test_layer_plan(h, w, monkeypatch):
    """The port pairs the layers the JAX package pairs, and refuses the
    widths it refuses."""
    for dils in (refine_pallas.TOWER_DILATIONS,
                 refine_pallas.HEAD_DILATIONS):
        try:
            want = _jax_plan(h, w, dils, monkeypatch)
        except ValueError:
            with pytest.raises(ValueError, match="no layer chunk"):
                T.layer_plan(h, w, dils, 32)
            continue
        assert T.layer_plan(h, w, dils, 32) == want
    if (h, w) == (368, 1232):
        assert T.layer_plan(h, w, (2, 4, 8, 16), 32) == ((2, 4), (8, 16))
    if (h, w) == (96, 3712):
        assert T.layer_plan(h, w, (2, 4, 8, 16), 32) == ((2, 4), (8,), (16,))


def test_refine_residual_layers():
    """The whole layers refinement at 48x96 against the JAX layers path."""
    rng = np.random.default_rng(12)
    model = LWSNet(ModelConfig(compute_dtype="float32",
                               pallas_mode="layers"), device="cpu")
    variables = jitter(to_jax_variables(model.state_dict()), rng)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    disp = rng.uniform(0, 20, (1, H, W, 1)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        refine_pallas.refine_residual, dtype=f32, interpret=True,
        mode="layers"))(variables, jnp.asarray(left), jnp.asarray(disp)))
    with torch.no_grad():
        got = refine_residual(model, torch.from_numpy(left),
                              torch.from_numpy(disp))
    assert got.shape == (1, H, W, 1) and got.dtype == torch.float32
    span = np.abs(want).max() + 1.0
    assert np.abs(got.numpy() - want).max() < 1e-4 * span


def test_forward_layers_matches_jax(setup):  # noqa: F811
    """The 4-stage forward under pallas_mode="layers" against the JAX
    kernel path of the same configuration, on the same bridged weights."""
    _, variables, model, left, right = setup
    kw = dict(compute_dtype="float32", pallas_mode="layers")
    want = jax.jit(jmake_forward(JLWSNet(JConfig(**kw)), use_pallas=True,
                                 interpret=True))(
        variables, jnp.asarray(left), jnp.asarray(right))
    port = LWSNet(ModelConfig(**kw), device="cpu")
    port.load_state_dict(model.state_dict(), strict=True)
    got = make_forward(port, device="cpu")(torch.from_numpy(left),
                                           torch.from_numpy(right))
    _span_check(got, want)


def test_lane_broadcast_plain_matches_bkernel():
    """`lane_broadcast_plain` against the microbench's probe body, copied
    from `examples/microbench_rows.py` (it is defined inside `main`)."""
    def bkernel(v_ref, o_ref):
        o_ref[:] = jnp.broadcast_to(v_ref[:], o_ref.shape)

    v = np.random.default_rng(4).standard_normal((32, 1)).astype(np.float32)
    for jdt, tdt in ((f32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = pl.pallas_call(
            bkernel, out_shape=jax.ShapeDtypeStruct((32, 1024), jdt),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True)(jnp.asarray(v, jdt))
        vt = torch.from_numpy(v).to(tdt)
        for fn in (probe.lane_broadcast_plain, probe.lane_broadcast):
            got = fn(vt, 1024)
            assert got.shape == (32, 1024) and got.dtype == tdt
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


def test_probe_and_microbench_need_a_card(monkeypatch):
    """Without a card the microbench and the timing raise, and the probe's
    wrapper runs its plain version only for a CPU tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        microbench_rows.main([])
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        timing.device_time(lambda: None)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        probe.lane_broadcast(torch.empty(32, 1, device="meta"), 1024)
