"""The port's stereo ops (`lwsnet_tpu_torch.ops.stereo`) against the JAX
package's (`lwsnet_tpu.ops.stereo`), float32 on the CPU, atol 1e-5.

Inputs are seeded numpy arrays handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwsnet_tpu.ops import stereo as jstereo
from lwsnet_tpu_torch.ops import stereo as tstereo

ATOL = 1e-5


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def _feats(rng, shape=(2, 5, 17, 4)):
    return rng.standard_normal(shape).astype(np.float32)


def _disp(rng, shape, lo, hi):
    """Fractional disparities in [lo, hi): includes taps past both edges
    and pixels where only one of the two bilinear taps is inside."""
    return rng.uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("disp_ndim", [3, 4])
def test_horizontal_warp(disp_ndim):
    rng = np.random.default_rng(0)
    feat = _feats(rng)
    disp = _disp(rng, (2, 5, 17), -3.0, 20.0)
    if disp_ndim == 4:
        disp = disp[..., None]
    fj, ft = _both(feat)
    dj, dt = _both(disp)
    _close(tstereo.horizontal_warp(ft, dt), jstereo.horizontal_warp(fj, dj))


@pytest.mark.parametrize("max_disp", [1, 6, 24])
def test_build_cost_volume(max_disp):
    rng = np.random.default_rng(1)
    fl, fr = _feats(rng), _feats(rng)
    (lj, lt), (rj, rt) = _both(fl), _both(fr)
    got = tstereo.build_cost_volume(lt, rt, max_disp)
    assert got.shape == (2, 5, 17, max_disp)
    _close(got, jstereo.build_cost_volume(lj, rj, max_disp))


@pytest.mark.parametrize("max_disp,stride", [(5, 1), (3, 2)])
def test_build_residual_volume(max_disp, stride):
    rng = np.random.default_rng(2)
    fl, fr = _feats(rng), _feats(rng)
    # From -6 (taps past the right edge after the offsets) to 25 (past the
    # left edge of a 17-wide map).
    disp = _disp(rng, (2, 5, 17, 1), -6.0, 25.0)
    (lj, lt), (rj, rt), (dj, dt) = _both(fl), _both(fr), _both(disp)
    got = tstereo.build_residual_volume(lt, rt, dt, max_disp, stride)
    assert got.shape == (2, 5, 17, 2 * max_disp - 1)
    _close(got, jstereo.build_residual_volume(lj, rj, dj, max_disp, stride))


@pytest.mark.parametrize("start,end,stride", [(0, 24, 1), (-4, 5, 1),
                                              (-2, 3, 2)])
def test_soft_argmin(start, end, stride):
    rng = np.random.default_rng(3)
    cost = (rng.standard_normal((2, 5, 7, end - start)) * 3).astype(
        np.float32)
    cj, ct = _both(cost)
    got = tstereo.soft_argmin(ct, start, end, stride)
    assert got.shape == (2, 5, 7, 1) and got.dtype == torch.float32
    _close(got, jstereo.soft_argmin(cj, start, end, stride))


@pytest.mark.parametrize("src,dst", [
    ((8, 12), (64, 96)),    # 8x upscale (stage-1 disparity to full res)
    ((32, 48), (64, 96)),   # 2x upscale
    ((64, 96), (32, 48)),   # 2x downscale (warp flow to 1/2 res)
    ((64, 96), (16, 24)),   # 4x downscale
    ((64, 96), (8, 12)),    # 8x downscale
    ((10, 14), (23, 9)),    # uneven, one axis each way
])
def test_resize_bilinear(src, dst):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2,) + src + (2,)) * 3).astype(np.float32)
    xj, xt = _both(x)
    got = tstereo.resize_bilinear(xt, *dst)
    assert got.shape == (2,) + dst + (2,)
    _close(got, jstereo.resize_bilinear(xj, *dst))


def test_resize_bilinear_keeps_dtype_and_identity():
    x = torch.randn(1, 4, 6, 1, generator=torch.Generator().manual_seed(0))
    assert tstereo.resize_bilinear(x, 4, 6) is x
    assert tstereo.resize_bilinear(x.bfloat16(), 8, 12).dtype == \
        torch.bfloat16
