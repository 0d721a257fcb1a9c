"""The tensor-core route of `conv3d_skip_softargmin` (bf16, Ci 64, 32, 16 or
8, any D), on the CPU.

The route runs only on the card (`tests/test_torch_gpu.py` and
`chip_smoke.py` hold it against its plain version there). Here: which
dtype and width take it, the B images the wrapper lays out for it, a numpy
emulation of its walk (tile by tile and plane by plane: the kd-split
products over staged channels-last rows with the taps in N, the
three-plane sums, the skip, the two-pass softmax of each chunk of up to 64
costs folded into a running one) against `conv3d_skip_softargmin_plain`,
and the stage-1 and stage-2/3 filters and AnyNet's stage 1 and a 64-channel
filter over D = 72 with the layouts the card hands from layer to layer,
the last layer through that emulation, against the JAX package's
`filter_soft_argmin` (Pallas kernels in interpret mode). float32
throughout.
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
# The route's tile (csrc/conv3d_skip_softargmin.cu, namespace tcr): TW
# output pixels from w0, TM staged pixels a product row, costs a chunk the
# owner folds at once (D_CHUNK); by width, LP staged pixels a row from
# w0 - 1, TH output rows a tile, KP products a staged row (one a
# 16-channel slice at Ci >= 16), the 16 x 8 images as laid out a kh
# (PIECES) and the columns of a product an output row (PER_ROW).
TW, TM, D_CHUNK = 62, 64, 64
LP = {64: 64, 32: 64, 16: 64, 8: 72}
TH = {64: 1, 32: 1, 16: 1, 8: 2}
KP = {64: 4, 32: 2, 16: 1, 8: 1}
PIECES = {64: 12, 32: 6, 16: 3, 8: 2}
PER_ROW = {64: 9, 32: 9, 16: 9, 8: 6}


@pytest.mark.parametrize("dtype,ci,route", [
    (torch.bfloat16, 32, True),    # stage 1
    (torch.bfloat16, 8, True),     # stages 2-3
    (torch.bfloat16, 16, True),    # AnyNet's stage 1
    (torch.bfloat16, 64, True),    # a 64-channel filter
    (torch.bfloat16, 4, True),     # AnyNet's stages 2-3 (`s4`, NCDHW)
    (torch.float32, 32, False),    # the CUDA cores, NCDHW
    (torch.float32, 8, False),
])
def test_skip_tensor_core_route_rule(dtype, ci, route):
    assert tcf.skip_tensor_core_route(dtype, ci) == route


def _slices(wt):
    """The wrapper's B images as (slice, k, n) matrices: element (k, n) of
    a 256-byte slice at (k // 8) * 128 + n * 16 + (k % 8) * 2 bytes."""
    img = tcf.skip_images(torch.as_tensor(wt)).reshape(-1, 2, 8, 8)
    return img.numpy().transpose(0, 1, 3, 2).reshape(-1, 16, 8)


@pytest.mark.parametrize("ci", [32, 8, 16, 64])
def test_skip_images_unpack_to_the_weights(ci):
    """Slice kh * PIECES + piece holds, in column n < 3, the weights of
    kd = n at row kh: Ci = 16, 32 or 64, piece (kw, kc) and k the channel
    kc * 16 + k; Ci = 8, piece j, k < 8 the channels at tap kw = 2j and
    k >= 8 those at kw = 2j + 1 (zero for kw = 3). Columns 3-7 are
    zero."""
    rng = np.random.default_rng(ci)
    wt = rng.standard_normal((1, ci, 3, 3, 3)).astype(np.float32)
    bs = _slices(wt)
    # 9.2 / 4.6 / 2.3 / 1.5 KB of bf16 at Ci = 64 / 32 / 16 / 8
    assert bs.shape == (3 * PIECES[ci], 16, 8)
    assert not bs[:, :, 3:].any()
    back = np.zeros((ci, 3, 3, 4), np.float32)  # (ci, kd, kh, kw)
    for kh in range(3):
        for pc in range(PIECES[ci]):
            b = bs[kh * PIECES[ci] + pc, :, :3]  # (k, kd)
            if ci != 8:
                kw, kc = divmod(pc, KP[ci])
                back[16 * kc:16 * kc + 16, :, kh, kw] = b
            else:
                back[:, :, kh, 2 * pc] = b[:8]
                back[:, :, kh, 2 * pc + 1] = b[8:]
    np.testing.assert_array_equal(back[..., :3], wt[0])
    assert not back[..., 3].any()


def _source_slice(C, sh, kc, n):
    """The kernel's `source_slice`: the image whose column kd = n % 3
    fills column n of staged row sh's product kc, or -1 (zero)."""
    o, m = divmod(n, PER_ROW[C])
    kh = sh - o
    if o >= TH[C] or not 0 <= kh <= 2:
        return -1
    return kh * 2 + m // 3 if C == 8 else kh * PIECES[C] + m // 3 * KP[C] + kc


def _packed(bs, C):
    """B as the block multiplies it: per (staged row, product) a 16 x N
    slice, N the used columns rounded up to 8."""
    ncols = TH[C] * PER_ROW[C]
    n_pad = (ncols + 7) // 8 * 8
    out = np.zeros(((TH[C] + 2) * KP[C], 16, n_pad), np.float32)
    for i in range(out.shape[0]):
        for n in range(n_pad):
            src = _source_slice(C, i // KP[C], i % KP[C], n)
            if src >= 0:
                out[i, :, n] = bs[src, :, n % 3]
    return out


def _fold(c, bins):
    """The owner's soft-argmin of costs c (..., D) in chunks of D_CHUNK:
    each chunk's least cost, then its sums of exp(least - cost) and of that
    times the bin in order of d, folded into the running ones, both
    rescaled to the lesser least cost."""
    run = None
    for d0 in range(0, c.shape[-1], D_CHUNK):
        ck = c[..., d0:d0 + D_CHUNK]
        m = ck.min(-1)
        den = np.zeros_like(m)
        num = np.zeros_like(m)
        for k in range(ck.shape[-1]):
            e = np.exp(m - ck[..., k])
            den = den + e
            num = num + e * bins[d0 + k]
        if run is None:
            run = m, den, num
        else:
            rm, rden, rnum = run
            mm = np.minimum(rm, m)
            s_run, s_new = np.exp(mm - rm), np.exp(mm - m)
            run = mm, rden * s_run + den * s_new, rnum * s_run + num * s_new
    return run[2] / run[1]


def _emulate(x, wt, vol, start):
    """The route's arithmetic in numpy float32. Per (b, h0, w0) tile of
    TH rows x TW pixels: per plane d' the TH + 2 staged rows of LP
    channels-last pixels from w0 - 1 (zeros outside the volume); one
    product per (staged row, product kc) of its TM pixels from pixel 0
    (Ci >= 16: channels kc * 16 .. kc * 16 + 15; Ci = 8: pixels m and
    m + 1) with the packed B; output pixel q of row o sums its kd columns
    over the taps (rows q + kw; Ci = 8: q and q + 2), cost[d' + 1] += kd
    0, cost[d'] += kd 1, cost[d' - 1] += kd 2; then the volume added and
    the chunks folded (`_fold`)."""
    x, wt, vol = (t.detach() for t in (x, wt, vol))
    B, C, D, H, W = x.shape
    th = TH[C]
    xc = x.permute(0, 2, 3, 4, 1).numpy()
    v = vol.float().numpy()
    pk = _packed(_slices(wt.numpy()), C)
    out = np.zeros((B, H, W), np.float32)
    m = np.arange(TM)
    q = np.arange(TW)
    bins = np.arange(start, start + D, dtype=np.float32)
    for b in range(B):
        for h0 in range(0, H, th):
            for w0 in range(0, W, TW):
                costs = np.zeros((th, D, TW), np.float32)
                ws = np.arange(w0 - 1, w0 - 1 + LP[C])
                ok = (ws >= 0) & (ws < W)
                for dp in range(D):
                    rows = np.zeros((th + 2, LP[C], C), np.float32)
                    for r in range(th + 2):
                        hh = h0 - 1 + r
                        if 0 <= hh < H:
                            rows[r, ok] = xc[b, dp, hh, ws[ok]]
                    P = 0
                    for i in range(pk.shape[0]):
                        sh, kc = divmod(i, KP[C])
                        a = (np.concatenate([rows[sh, m], rows[sh, m + 1]], 1)
                             if C == 8 else rows[sh, m, 16 * kc:16 * kc + 16])
                        P = P + a @ pk[i]
                    for o in range(th):
                        if C == 8:
                            kd = [P[q, o * 6 + k] + P[q + 2, o * 6 + 3 + k]
                                  for k in range(3)]
                        else:
                            kd = [P[q, o * 9 + k] + P[q + 1, o * 9 + 3 + k]
                                  + P[q + 2, o * 9 + 6 + k] for k in range(3)]
                        if dp + 1 < D:
                            costs[o, dp + 1] += kd[0]
                        costs[o, dp] += kd[1]
                        if dp > 0:
                            costs[o, dp - 1] += kd[2]
                nh, nw = min(th, H - h0), min(TW, W - w0)
                c = costs[:nh, :, :nw] + v[b, :, h0:h0 + nh,
                                           w0:w0 + nw].transpose(1, 0, 2)
                out[b, h0:h0 + nh, w0:w0 + nw] = _fold(
                    c.transpose(0, 2, 1), bins)
    return torch.from_numpy(out)


def _operands(rng, B, C, D, H, W):
    x = np.maximum(rng.standard_normal((B, C, D, H, W)), 0)
    wt = rng.standard_normal((1, C, 3, 3, 3)) * np.sqrt(2 / (27 * C))
    vol = rng.standard_normal((B, D, H, W)) * 2
    return (torch.from_numpy(a.astype(np.float32)) for a in (x, wt, vol))


@pytest.mark.parametrize("B,C,D,H,W,start", [
    (1, 32, 24, 1, 70, 0),     # stage 1: D = 24, two W tiles, ragged
    (2, 32, 24, 2, 37, -4),
    (1, 8, 9, 1, 70, -4),      # stages 2-3: D = 9; H = 1 < TH = 2
    (2, 8, 9, 2, 126, 0),      # three W tiles, the last of 2 pixels
    (1, 16, 12, 2, 70, 0),     # AnyNet's stage 1: D = 12
    (1, 16, 72, 1, 126, -3),   # past D = 64: a chunk of 64, one of 8
    (2, 16, 65, 1, 70, 0),     # a last chunk of one cost
    (1, 16, 129, 1, 70, -64),  # three chunks
    (1, 64, 12, 1, 70, 0),     # 64 channels: four products a staged row
    (1, 64, 72, 2, 70, 0),     # the wide filter's D
    (2, 64, 65, 1, 70, -32),
    (1, 64, 129, 1, 126, 0),
])
def test_skip_walk_emulation_matches_plain(B, C, D, H, W, start):
    """atol 1e-4 / rtol 1e-5 on outputs in bin units up to D - 1: float32
    sums in another order (per staged row, per tap, per kd, then the
    skip; past 64 costs chunk by chunk, rescaled) than the plain conv's
    and softmax's."""
    x, wt, vol = _operands(np.random.default_rng(C + D + H), B, C, D, H, W)
    want = tcf.conv3d_skip_softargmin_plain(x, wt, vol, start)
    got = _emulate(x, wt, vol, start)
    assert got.shape == want.shape == (B, H, W)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("D,channels,start", [
    (24, 32, 0),    # stage 1: the d-grid formulation in JAX
    (9, 8, -4),     # stages 2-3: the folded one, residual bins
    (12, 16, 0),    # AnyNet's stage 1
    (72, 64, 0),    # a 64-channel filter past D = 64: two chunks
])
def test_filter_soft_argmin_card_hand_over_matches_jax(monkeypatch, D,
                                                       channels, start):
    """A stage filter (four mid layers), each layer (the entry, layer 0's
    BN inside, then conv3d_bn_relu) handing its output on in the layout the
    bf16 routes write on the card: every layer channels-last, which the
    last layer's route reads with no copy; the last layer through the
    emulation of its walk. The result matches the
    JAX package's at atol 2e-4 / rtol 1e-3, the bar of the port's filter
    tests."""
    B, H, W, layers = 1, 5, 9, 4
    rng = np.random.default_rng(D)
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
    plain_layer, plain_entry = tcf.conv3d_bn_relu, tcf.conv3d_entry

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
        seen.append(("skip", tcf.skip_tensor_core_route(
            torch.bfloat16, x.shape[1]), build.lies_channels_last(x)))
        return _emulate(x, wt, vol, start)

    monkeypatch.setattr(tcf, "conv3d_entry", entry)
    monkeypatch.setattr(tcf, "conv3d_bn_relu", layer)
    monkeypatch.setattr(tcf, "conv3d_skip_softargmin", last)
    got = tcf.filter_soft_argmin(
        torch.from_numpy(cost), dict(port.named_parameters()),
        dict(port.named_buffers()), layers=layers, channels=channels,
        start=start, dtype=torch.float32)
    C = channels
    assert seen == [("entry", C, True)] + [(C, C, True, True)] * 4 + [
        ("skip", True, True)]
    assert got.shape == (B, H, W, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-3)
