"""The 8 -> 8 tensor-core route of `conv3d_bn_relu` (stages 2-3), on the CPU.

The route runs only on the card (`tests/test_torch_gpu.py` holds it against
its plain version there). Here: its routing and output-layout rules, the B
images the wrapper lays out for it, a numpy emulation of its K-loop over
staged channels-last rows, tile by tile as the kernel walks them, against
`conv3d_bn_relu_plain`, and the stage-2/3 filter with the layouts the card
hands from layer to layer against the JAX package's `filter_soft_argmin`
(Pallas kernels in interpret mode). float32 throughout.
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

from lwsnet_tpu.ops.pallas import costfilter as jcf  # noqa: E402
from lwsnet_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                      to_jax_variables)
from lwsnet_tpu_torch.models.blocks import (CostFilter3D,  # noqa: E402
                                            init_params)
from lwsnet_tpu_torch.ops.cuda import build  # noqa: E402
from lwsnet_tpu_torch.ops.cuda import costfilter as tcf  # noqa: E402
from test_torch_model import jitter  # noqa: E402

CL3 = torch.channels_last_3d
# The route's tile and staged rows (csrc/conv3d_bn_relu.cu, namespace c8).
TD, TH, TW, LP = 3, 4, 64, 72


def _operands(rng, B, D, H, W):
    x = np.maximum(rng.standard_normal((B, 8, D, H, W)), 0).astype(np.float32)
    wt = (rng.standard_normal((8, 8, 3, 3, 3)) / np.sqrt(27 * 8)).astype(
        np.float32)
    shift = rng.normal(0, 0.1, 8).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(shift)


@pytest.mark.parametrize("dtype,ci,co,ncdhw", [
    (torch.bfloat16, 8, 8, True),      # stages 2-3: either layout
    (torch.bfloat16, 32, 32, False),   # stage 1: channels-last only
    (torch.bfloat16, 1, 8, True),      # the stage-2/3 entries: either
    (torch.float32, 8, 8, True),
    (torch.float32, 32, 32, True),
])
def test_conv3d_writes_ncdhw_rule(dtype, ci, co, ncdhw):
    assert tcf.conv3d_writes_ncdhw(dtype, ci, co) == ncdhw


def test_c8_images_unpack_to_the_weights():
    """Slice (kd, kh, j) is 256 bytes: element (k, n) at (k // 8) * 128 +
    n * 16 + (k % 8) * 2, k < 8 the input channels at tap kw = 2j, k >= 8
    those at kw = 2j + 1, zero at kw = 3."""
    rng = np.random.default_rng(0)
    wt = torch.from_numpy(rng.standard_normal((8, 8, 3, 3, 3)).astype(
        np.float32))
    flat = tcf.c8_images(wt).reshape(-1)
    assert flat.numel() == 9 * 2 * 128  # 4.6 KB of bf16 on the card
    k, n = np.meshgrid(np.arange(16), np.arange(8), indexing="ij")
    back = torch.zeros(8, 8, 3, 3, 4)
    for kd in range(3):
        for kh in range(3):
            for j in range(2):
                s = (kd * 3 + kh) * 2 + j
                b = flat[s * 128 + (k // 8) * 64 + n * 8 + k % 8]  # (k, n)
                for half in range(2):
                    back[:, :, kd, kh, 2 * j + half] = \
                        b[8 * half:8 * half + 8].T
    assert torch.equal(back[..., :3], wt)
    assert torch.equal(back[..., 3], torch.zeros(8, 8, 3, 3))


def _emulate(x, wt, shift):
    """The kernel's arithmetic in numpy float32: per (b, d0, h0, w0) tile
    the (TD + 2) x (TH + 2) staged rows of LP channels-last pixels from
    w0 - 1 (zeros outside the volume); per staged row and j = 0, 1 the A
    tile of 64 pixels whose k < 8 are pixel p + 2j's channels and k >= 8
    pixel p + 2j + 1's, times B slice (kd, kh, j) into each output row
    that reads the staged row; relu(acc + shift) on the volume only."""
    B, _, D, H, W = x.shape
    xc = x.permute(0, 2, 3, 4, 1).numpy()  # channels-last
    img = tcf.c8_images(wt).reshape(9, 2, 2, 8, 8).numpy()
    bs = img.transpose(0, 1, 2, 4, 3).reshape(9, 2, 16, 8)  # (kd kh, j, k, n)
    y = np.zeros((B, D, H, W, 8), np.float32)
    p = np.arange(TW)
    for b in range(B):
        for d0 in range(0, D, TD):
            for h0 in range(0, H, TH):
                for w0 in range(0, W, TW):
                    acc = np.zeros((TD, TH, TW, 8), np.float32)
                    for sd in range(TD + 2):
                        for sh in range(TH + 2):
                            dd, hh = d0 - 1 + sd, h0 - 1 + sh
                            row = np.zeros((LP, 8), np.float32)
                            if 0 <= dd < D and 0 <= hh < H:
                                ws = np.arange(w0 - 1, w0 - 1 + LP)
                                ok = (ws >= 0) & (ws < W)
                                row[ok] = xc[b, dd, hh, ws[ok]]
                            for j in range(2):
                                a = np.concatenate(
                                    [row[p + 2 * j], row[p + 2 * j + 1]], 1)
                                for od in range(TD):
                                    for oh in range(TH):
                                        kd, kh = sd - od, sh - oh
                                        if 0 <= kd <= 2 and 0 <= kh <= 2:
                                            acc[od, oh] += a @ bs[kd * 3 + kh,
                                                                  j]
                    out = np.maximum(acc + shift.numpy(), 0)
                    nd, nh = min(TD, D - d0), min(TH, H - h0)
                    nw = min(TW, W - w0)
                    y[b, d0:d0 + nd, h0:h0 + nh, w0:w0 + nw] = \
                        out[:nd, :nh, :nw]
    return torch.from_numpy(y).permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("B,D,H,W", [
    (2, 7, 11, 37),   # ragged in D, H and W
    (1, 9, 6, 70),    # D = 9 as stages 2-3, two W tiles
])
def test_c8_k_loop_emulation_matches_plain(B, D, H, W):
    x, wt, shift = _operands(np.random.default_rng(B + D), B, D, H, W)
    want = tcf.conv3d_bn_relu_plain(x, wt, shift)
    np.testing.assert_allclose(_emulate(x, wt, shift).numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_filter_soft_argmin_c8_layouts_match_jax(monkeypatch):
    """The stage-2/3 filter (four mid layers of 8 channels, D = 9, residual
    bins from -4), each layer handing its output on in the layout the bf16
    route writes on the card: the 1 -> 8 entry (conv3d_entry, layer 0's BN
    inside) and every 8 -> 8 layer channels-last, which
    conv3d_skip_softargmin's route reads. The result matches the JAX
    package's."""
    B, H, W, D, layers, channels, start = 1, 6, 10, 9, 4, 8, -4
    rng = np.random.default_rng(11)
    cost = rng.standard_normal((B, H, W, D)).astype(np.float32)
    port = CostFilter3D(layers, channels)
    init_params(port, torch.Generator().manual_seed(0))
    variables = jitter(to_jax_variables(port.state_dict()), rng)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    want = jax.jit(functools.partial(
        jcf.filter_soft_argmin, layers=layers, channels=channels,
        start=start, dtype=jnp.float32, interpret=True))(
        jnp.asarray(cost), variables["params"], variables["batch_stats"])

    seen = []
    plain_layer, plain_last = tcf.conv3d_bn_relu, tcf.conv3d_skip_softargmin
    plain_entry = tcf.conv3d_entry

    def entry(vol, a0b0, wt, shift):
        co = wt.shape[0]
        out_cl = tcf.conv3d_tensor_core_route(torch.bfloat16, co, co)
        seen.append(("entry", co, out_cl))
        y = plain_entry(vol, a0b0, wt, shift)
        return y.contiguous(memory_format=CL3) if out_cl else y

    def layer(x, wt, shift, channels_last=None):
        ci, co = x.shape[1], wt.shape[0]
        out_cl = (tcf.conv3d_tensor_core_route(torch.bfloat16, co, co)
                  if channels_last is None else channels_last)
        seen.append((ci, co, build.lies_channels_last(x), out_cl))
        y = plain_layer(x, wt, shift)
        return y.contiguous(memory_format=CL3) if out_cl else y

    def last(x, wt, vol, start):
        seen.append(("skip", build.lies_channels_last(x)))
        return plain_last(x, wt, vol, start)

    monkeypatch.setattr(tcf, "conv3d_entry", entry)
    monkeypatch.setattr(tcf, "conv3d_bn_relu", layer)
    monkeypatch.setattr(tcf, "conv3d_skip_softargmin", last)
    got = tcf.filter_soft_argmin(
        torch.from_numpy(cost), dict(port.named_parameters()),
        dict(port.named_buffers()), layers=layers, channels=channels,
        start=start, dtype=torch.float32)
    assert seen == [("entry", 8, True)] + [(8, 8, True, True)] * 4 + [
        ("skip", True)]
    assert got.shape == (B, H, W, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-3)
