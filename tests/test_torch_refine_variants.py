"""The port's "vpu" and "chain" refinement layers against the JAX package.

`dwsep_layer`, `dwsep2_layer` and `chain_layer` of
`lwsnet_tpu_torch.ops.cuda.refine_rows` run their plain PyTorch versions
on the CPU (what the CUDA kernels compute); the JAX side runs the
row-canvas Pallas kernels of `lwsnet_tpu.ops.pallas.refine_rows` in
interpret mode, as `tests/test_pallas_refine.py` runs them. float32
throughout, on inputs made from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwsnet_tpu.ops.pallas import refine_rows as jrr
from lwsnet_tpu_torch.ops.cuda import refine_rows as trr

f32 = jnp.float32
H2, W2, C = 40, 96, 8


def _affine(rng, C):
    return np.stack([rng.uniform(0.5, 1.5, C),
                     rng.normal(0, 0.5, C)]).astype(np.float32)


def _dwsep_weights(rng, G, C, Co):
    """G sets of (affine (2, C), dwk (3, 3, 1, C) HWIO, pwk (Co, C))."""
    sets = [(_affine(rng, C),
             (rng.standard_normal((3, 3, 1, C)) / 3).astype(np.float32),
             (rng.standard_normal((Co, C)) / np.sqrt(C)).astype(np.float32))
            for _ in range(G)]
    return [np.stack(w) if G > 1 else w[0] for w in zip(*sets)]


def _port_dwk(dwk):
    """([G,] 3, 3, 1, C) HWIO -> the port's ([G,] C, 1, 3, 3)."""
    axes = (0, 4, 3, 1, 2) if dwk.ndim == 5 else (3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(np.transpose(dwk, axes)))


def _port(aff, dwk, pwk):
    return torch.from_numpy(aff), _port_dwk(dwk), torch.from_numpy(pwk)


def _oihw(k):
    """([G,] 3, 3, Ci, Co) HWIO -> ([G,] Co, Ci, 3, 3)."""
    axes = (0, 4, 3, 1, 2) if k.ndim == 5 else (3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, axes)))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1,
                                                                  2))))


def _from_port(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("groups,d", [(2, 2), (2, 16), (1, 1)])
def test_dwsep_layer(groups, d):
    rng = np.random.default_rng(10 * groups + d)
    x = rng.standard_normal((2, H2, W2, C)).astype(np.float32)
    w = _dwsep_weights(rng, groups, C, C)
    S, NR = jrr.canvas_geom(H2, W2)
    want = jrr.from_canvas(jrr.dwsep_layer(
        jrr.to_canvas(jnp.asarray(x), S, NR, f32),
        *[jnp.asarray(v) for v in w], dilation=d, S=S, NR=NR, groups=groups,
        interpret=True), H2, W2, S, NR, C)
    got = trr.dwsep_layer(_nchw(x), *_port(*w), dilation=d, groups=groups)
    assert got.shape == (2, C, H2, W2)
    np.testing.assert_allclose(_from_port(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("d1,d2,groups", [(2, 4, 2), (8, 16, 2), (8, 4, 1),
                                          (2, 1, 1)])
def test_dwsep2_layer(d1, d2, groups):
    """The four pairs of the refinement, tower pairs with two weight
    groups; the bar is the JAX pair test's own."""
    rng = np.random.default_rng(100 * d1 + d2)
    x = rng.standard_normal((2, H2, W2, C)).astype(np.float32)
    w1 = _dwsep_weights(rng, groups, C, C)
    w2 = _dwsep_weights(rng, groups, C, C)
    S, NR = jrr.canvas_geom(H2, W2, unit=jrr.PAIR_UNIT)
    want = jrr.from_canvas(jrr.dwsep2_layer(
        jrr.to_canvas(jnp.asarray(x), S, NR, f32),
        *[jnp.asarray(v) for v in w1 + w2], dilation1=d1, dilation2=d2,
        S=S, NR=NR, groups=groups, interpret=True), H2, W2, S, NR, C)
    got = trr.dwsep2_layer(_nchw(x), *_port(*w1), *_port(*w2),
                           dilation1=d1, dilation2=d2, groups=groups)
    np.testing.assert_allclose(_from_port(got), np.asarray(want), atol=1e-3,
                               rtol=1e-3)


def _dense_kernel(rng, shape):
    """A He-scaled HWIO kernel of `shape` (..., 3, 3, Ci, Co)."""
    return (rng.standard_normal(shape) * np.sqrt(2 / (9 * shape[-2]))
            ).astype(np.float32)


@pytest.mark.parametrize("stack", ["tower", "head"])
def test_chain_layer(stack):
    """The tower stack (entry 3->C, then 4 layers, two weight groups) and
    the head (two-input entry, 4 layers, C->1 with a float32 output) as
    one chain each."""
    rng = np.random.default_rng(5 if stack == "tower" else 6)
    if stack == "tower":
        dils, G, ci0, two = (1, 2, 4, 8, 16), 2, 3, False
        shapes = [(G, 3, 3, ci0, C)] + [(G, 3, 3, C, C)] * 4
        affs = [None] + [np.stack([_affine(rng, C) for _ in range(G)])
                         for _ in range(4)]
        x = rng.standard_normal((2, H2, W2, ci0)).astype(np.float32)
    else:
        dils, G, ci0, two = (8, 8, 4, 2, 1, 1), 1, C, True
        shapes = [(3, 3, 2 * C, C)] + [(3, 3, C, C)] * 4 + [(3, 3, C, 1)]
        affs = [_affine(rng, 2 * C)] + [_affine(rng, C) for _ in range(4)] \
            + [None]
        x = rng.standard_normal((2, H2, W2, C)).astype(np.float32)
    kernels = [_dense_kernel(rng, s) for s in shapes]
    S, NR = jrr.canvas_geom(H2, W2, unit=96)
    co = shapes[-1][-1]
    want = np.asarray(jrr.from_canvas(jrr.chain_layer(
        jrr.to_canvas(jnp.asarray(x), S, NR, f32),
        [jnp.asarray(k) for k in kernels],
        [None if a is None else jnp.asarray(a) for a in affs],
        dilations=dils, S=S, NR=NR, groups=G, two_input=two,
        out_dtype=f32, interpret=True), H2, W2, S, NR, co))
    got = trr.chain_layer(
        _nchw(x), [_oihw(k) for k in kernels],
        [None if a is None else torch.from_numpy(a) for a in affs],
        dilations=dils, groups=G, two_input=two, out_dtype=torch.float32)
    assert got.shape == (2 // (2 if two else 1), co, H2, W2)
    assert got.dtype == torch.float32
    span = want.max() - want.min()
    assert np.abs(_from_port(got) - want).max() < 1e-4 * span
