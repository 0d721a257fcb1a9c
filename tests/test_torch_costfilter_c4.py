"""The 4 -> 4 tensor-core route of `conv3d_bn_relu` (AnyNet's stages 2-3),
on the CPU.

The route runs only on the card (`tests/test_torch_gpu.py` holds it against
its plain version there). Here: its routing and layout rules, the B slices
the wrapper lays out for it, a numpy emulation of its tile walk (the
staging threads' loads into channels-last rows, each lane's A and B
fragment words of mma.m16n8k16, one K = 16 slice a staged row reused by
every output depth that reads it, the warp's two output rows on N, and
each lane's masked stores) against `conv3d_bn_relu_plain`, and the
stage-2/3 filter at 4 channels with the layouts the card hands from launch
to launch against the JAX package's `filter_soft_argmin` (Pallas kernels
in interpret mode). float32 throughout.
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

# The route's tile, staged rows and block (csrc/stage4.cuh, shared with
# the fused last layer's 4-channel route).
TD, TH, TW, PX, THREADS = 5, 4, 64, 68, 256
SH = TH + 2
SROWS, RI = (TD + 2) * SH, ((TD + 2) * SH + 7) // 8
BF = torch.bfloat16


@pytest.mark.parametrize("dtype,ci,co,tc,reads_cl,ncdhw,cl_out", [
    (BF, 4, 4, True, False, True, False),      # c4: NCDHW in and out
    (BF, 8, 8, True, True, True, True),        # c8: either layout out
    (BF, 1, 4, True, False, True, False),      # the 1 -> 4 entry: c1, NCDHW
    (BF, 3, 3, False, False, True, True),
    (BF, 4, 8, False, False, True, True),
    (BF, 8, 4, False, False, True, True),
    (torch.float32, 4, 4, False, False, True, True),
])
def test_c4_route_rule(dtype, ci, co, tc, reads_cl, ncdhw, cl_out):
    assert tcf.conv3d_tensor_core_route(dtype, ci, co) == tc
    assert tcf.conv3d_reads_channels_last(dtype, ci, co) == reads_cl
    assert tcf.conv3d_writes_ncdhw(dtype, ci, co) == ncdhw
    assert tcf.conv3d_writes_channels_last(dtype, ci, co) == cl_out


def test_c4_images_unpack_to_the_weights():
    """Slice (kd, sh) is 256 bytes: element (k, n) at n * 32 + k * 2, n =
    4 e + co (output row r = 1 - e), k = 4 kw + ci, holding tap kh = sh -
    r: every weight is back in place, once for each of the two output
    rows; the kw = 3 rows and the taps outside kh = 0 .. 2 are zero."""
    rng = np.random.default_rng(0)
    wt = torch.from_numpy(rng.standard_normal((4, 4, 3, 3, 3)).astype(
        np.float32))
    flat = tcf.c4_images(wt).reshape(-1)
    assert flat.numel() == 12 * 128  # 3 KB of bf16 on the card
    back = torch.zeros(2, 4, 4, 3, 3, 4)  # (r, co, ci, kd, kh, kw)
    for kd in range(3):
        for sh in range(4):
            for n in range(8):
                e, co = divmod(n, 4)
                r = 1 - e
                col = flat[((kd * 4 + sh) * 8 + n) * 16:][:16]
                if 0 <= sh - r <= 2:
                    for k in range(16):
                        back[r, co, k % 4, kd, sh - r, k // 4] = col[k]
                else:
                    assert not col.any()
    for r in range(2):
        assert torch.equal(back[r, ..., :3], wt)
        assert not back[r, ..., 3].any()


def _words(a):
    """A float32 array of even length as its 2-element 'words' (the
    kernel's 32-bit shared and global loads of two bf16 values)."""
    return a.reshape(-1, 2)


def _emulate(x, wt, shift):
    """The kernel's walk in numpy float32: per (b, d0, h0, w0) tile the
    staging threads' pixel pairs into SROWS rows of PX channels-last voxels
    from pixel w0 - 2 (zeros outside the volume); warp (pb, rg)'s A
    fragment of each of its 4 staged rows a depth, from each lane's words
    (row g pixel 2g, row g + 8 pixel 2g + 1), times the B fragment words
    of `c4_images` (slice kd * 4 + sh) into the accumulator of each output
    depth that reads the row, from the shift; each lane's relu'd pixel
    pair of its output row and two channels to y where inside it."""
    B, _, D, H, W = x.shape
    xn = x.numpy()
    bw = _words(tcf.c4_images(wt).numpy().reshape(-1))
    g, t = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    # B of slice i as (k, n): b0 = word (i 8 + g) 8 + t -> k = 2t + {0, 1},
    # n = g; b1 = that word + 4 -> k + 8
    bs = np.zeros((12, 16, 8), np.float32)
    for i in range(12):
        for half in range(2):
            w = bw[(i * 8 + g) * 8 + t + 4 * half]  # (8, 4, 2)
            for e in range(2):
                bs[i, 8 * half + 2 * t + e, g] = w[..., e]
    sh8 = np.tile(shift.numpy(), 2)  # column n = 4 e + co
    y = np.full((B, 4, D, H, W), np.nan, np.float32)
    tiles = [(b, d0, h0, w0) for b in range(B) for d0 in range(0, D, TD)
             for h0 in range(0, H, TH) for w0 in range(0, W, TW)]
    for b, d0, h0, w0 in tiles:
        stage = np.full((SROWS, PX, 4), np.nan, np.float32)

        def pair(r, k):
            dd, hh = d0 - 1 + r // SH, h0 - 1 + r % SH
            out = np.zeros((2, 4), np.float32)
            for e in range(2):
                w = w0 - 2 + 2 * k + e
                if 0 <= dd < D and 0 <= hh < H and 0 <= w < W:
                    out[e] = xn[b, :, dd, hh, w]
            stage[r, 2 * k:2 * k + 2] = out

        for tid in range(THREADS):
            k, q = tid % 32, tid // 32
            for i in range(RI):
                if q + 8 * i < SROWS:
                    pair(q + 8 * i, k)
            if tid < 2 * SROWS:
                pair(tid // 2, 32 + tid % 2)
        assert not np.isnan(stage).any()
        for warp in range(THREADS // 32):
            pb, rg = warp % 4, warp // 4
            acc = np.broadcast_to(sh8, (TD, 16, 8)).copy()
            aoff = 2 * (pb * 16 + 2 * g + 1) + t  # (8, 4): lane (g, t)
            for sd in range(TD + 2):
                for s2 in range(4):
                    words = _words(stage[sd * SH + 2 * rg + s2].reshape(-1))
                    a = np.zeros((16, 16), np.float32)
                    for e in range(2):
                        a[g, 2 * t + e] = words[aoff, e]
                        a[g + 8, 2 * t + e] = words[aoff + 2, e]
                        a[g, 2 * t + 8 + e] = words[aoff + 4, e]
                        a[g + 8, 2 * t + 8 + e] = words[aoff + 6, e]
                    for od in range(TD):
                        kd = sd - od
                        if 0 <= kd <= 2:
                            acc[od] += a @ bs[kd * 4 + s2]
            out = np.maximum(acc, 0)
            for lg in range(8):
                for lt in range(4):
                    co, h = 2 * (lt % 2), h0 + 2 * rg + 1 - lt // 2
                    w = w0 + pb * 16 + 2 * lg
                    for od in range(min(TD, D - d0)):
                        for c in range(2):
                            for e in range(2):
                                if h < H and w + e < W:
                                    y[b, co + c, d0 + od, h, w + e] = \
                                        out[od, lg + 8 * e, 2 * lt + c]
    assert not np.isnan(y).any()
    return torch.from_numpy(y)


@pytest.mark.parametrize("B,D,H,W", [
    (2, 7, 11, 37),   # ragged in D, H and W (W odd: 2-byte loads)
    (1, 5, 6, 70),    # D = 5 as AnyNet's stages 2-3, two W tiles
    (1, 5, 9, 130),   # three W tiles, W even, H ragged
    (2, 12, 5, 64),   # three depth tiles, one whole W tile
])
def test_c4_tile_walk_emulation_matches_plain(B, D, H, W):
    rng = np.random.default_rng(B + D + W)
    x = torch.from_numpy(np.maximum(rng.standard_normal(
        (B, 4, D, H, W)), 0).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((4, 4, 3, 3, 3))
                           / np.sqrt(27 * 4)).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0, 0.1, 4).astype(np.float32))
    want = tcf.conv3d_bn_relu_plain(x, wt, shift)
    np.testing.assert_allclose(_emulate(x, wt, shift).numpy(),
                               want.numpy(), atol=1e-5, rtol=1e-5)


def test_filter_soft_argmin_c4_layouts_match_jax(monkeypatch):
    """AnyNet's stage-2/3 filter (four mid layers of 4 channels, D = 5,
    residual bins from -2), each launch handing on the layout the bf16
    routes use on the card (`filter_routes`): the 1 -> 4 entry (the
    tensor cores, `c1`) writes NCDHW, every 4 -> 4 layer (the tensor
    cores, `c4`) reads and writes it, and the fused last layer (the tensor
    cores, `s4`) reads it. The result matches the JAX package's."""
    B, H, W, D, layers, channels, start = 1, 6, 10, 5, 4, 4, -2
    rng = np.random.default_rng(12)
    cost = rng.standard_normal((B, H, W, D)).astype(np.float32)
    port = CostFilter3D(layers, channels)
    init_params(port, torch.Generator().manual_seed(0))
    variables = jitter(to_jax_variables(port.state_dict()), rng)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    want = jax.jit(functools.partial(
        jcf.filter_soft_argmin, layers=layers, channels=channels,
        start=start, dtype=jnp.float32, interpret=True))(
        jnp.asarray(cost), variables["params"], variables["batch_stats"])

    routes = tcf.filter_routes(BF, channels, D)
    assert routes.layer.route == tcf.TENSOR_CORES
    assert routes.entry.route == tcf.TENSOR_CORES
    assert routes.skip.route == tcf.TENSOR_CORES
    seen = []
    plain_entry, plain_layer = tcf.conv3d_entry, tcf.conv3d_bn_relu
    plain_last = tcf.conv3d_skip_softargmin

    def entry(vol, a0b0, wt, shift):
        seen.append(("entry", wt.shape[0], routes.entry.writes_cl))
        return plain_entry(vol, a0b0, wt, shift)

    def layer(x, wt, shift, channels_last=None):
        ci, co = x.shape[1], wt.shape[0]
        route = tcf.conv3d_tensor_core_route(BF, ci, co)
        seen.append((ci, co, route, build.lies_channels_last(x),
                     tcf.conv3d_reads_channels_last(BF, ci, co),
                     routes.layer.writes_cl))
        return plain_layer(x, wt, shift)

    def last(x, wt, vol, start):
        seen.append(("skip", build.lies_channels_last(x),
                     routes.skip.reads_cl))
        return plain_last(x, wt, vol, start)

    monkeypatch.setattr(tcf, "conv3d_entry", entry)
    monkeypatch.setattr(tcf, "conv3d_bn_relu", layer)
    monkeypatch.setattr(tcf, "conv3d_skip_softargmin", last)
    got = tcf.filter_soft_argmin(
        torch.from_numpy(cost), dict(port.named_parameters()),
        dict(port.named_buffers()), layers=layers, channels=channels,
        start=start, dtype=torch.float32)
    assert seen == [("entry", 4, False)] + [
        (4, 4, True, False, False, False)] * 4 + [("skip", False, False)]
    assert got.shape == (B, H, W, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-3)
