"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card and nvcc and skips elsewhere. The file
imports torch and the port only, so it also runs where JAX is not
installed; `--noconftest` keeps pytest from loading the JAX test setup:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \
        tests/test_torch_gpu.py

Shapes are small and ragged (no dimension a multiple of a block's tile),
so the kernels' edge masks are exercised. float32 runs with TF32 off at
atol 2e-4 / rtol 1e-3; bf16 outputs of one layer may differ from the plain
version by one rounding step, so they run at atol 1e-2 / rtol 1e-2, and
bf16 outputs of several fused layers at the mean bar of `_check`.
"""

import pytest
import torch

from lwsnet_tpu_torch.ops.cuda import build
from lwsnet_tpu_torch.ops.cuda import costfilter as tcf
from lwsnet_tpu_torch.ops.cuda import probe
from lwsnet_tpu_torch.ops.cuda import refine_rows as trr
from lwsnet_tpu_torch.tools.parity_layers import ENGINES

pytestmark = pytest.mark.gpu


@pytest.fixture
def rnd():
    """Seeded random CUDA tensors; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(0)

    def make(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to("cuda", dtype)

    return make


def test_kernels_match_plain_on_card(rnd):
    """float32, the CUDA-core routes, and each launch counted."""
    build.reset_launch_counts()
    x = rnd(1, 8, 9, 12, 20).relu()
    w, shift = rnd(8, 8, 3, 3, 3) * 0.2, rnd(8)
    torch.testing.assert_close(tcf.conv3d_bn_relu(x, w, shift),
                               tcf.conv3d_bn_relu_plain(x, w, shift),
                               atol=2e-4, rtol=1e-3)
    w1, vol = rnd(1, 8, 3, 3, 3) * 0.2, rnd(1, 9, 12, 20)
    torch.testing.assert_close(
        tcf.conv3d_skip_softargmin(x, w1, vol, -4),
        tcf.conv3d_skip_softargmin_plain(x, w1, vol, -4),
        atol=2e-4, rtol=1e-3)
    xs, ws = rnd(2, 32, 20, 40), rnd(2, 32, 32, 3, 3) * 0.1
    aff = torch.stack([rnd(2, 32).abs() + 0.5, rnd(2, 32)], 1)
    torch.testing.assert_close(
        trr.dense3x3(xs, ws, dilation=4, affine=aff, x2=xs, wt2=ws,
                     affine2=aff),
        trr.dense3x3_plain(xs, ws, dilation=4, affine=aff, x2=xs, wt2=ws,
                           affine2=aff), atol=2e-4, rtol=1e-3)
    torch.cuda.synchronize()
    assert build.launch_counts() == {
        "conv3d_bn_relu": 1, "conv3d_skip_softargmin": 1, "dense3x3": 1,
        "dwsep3x3": 0, "dwsep3x3_pair": 0, "chain3x3": 0,
        "lane_broadcast": 0, "dense3x3[dual]": 1, "chain3x3[dual]": 0}


@pytest.mark.parametrize("d", [1, 16])
def test_tensor_core_routes_match_plain_on_card(rnd, d):
    """bf16 32->32 layers (the WMMA routes), grouped, two-input and with a
    float32 output, at widths that leave a partial tile."""
    bf = torch.bfloat16
    x = rnd(1, 32, 5, 7, 70, dtype=bf).relu()
    w, shift = (rnd(32, 32, 3, 3, 3) * 0.05).to(bf), rnd(32)
    torch.testing.assert_close(tcf.conv3d_bn_relu(x, w, shift),
                               tcf.conv3d_bn_relu_plain(x, w, shift),
                               atol=1e-2, rtol=1e-2)
    xs = rnd(2, 32, 9, 150, dtype=bf)
    ws = (rnd(2, 32, 32, 3, 3) * 0.06).to(bf)
    aff = torch.stack([rnd(2, 32).abs() + 0.5, rnd(2, 32)], 1)
    for kw in (dict(affine=aff),
               dict(affine=aff[:1], x2=xs, wt2=ws[:1], affine2=aff[1:]),
               dict(out_dtype=torch.float32)):
        wt = ws[:1] if "x2" in kw else ws
        torch.testing.assert_close(
            trr.dense3x3(xs, wt, dilation=d, **kw),
            trr.dense3x3_plain(xs, wt, dilation=d, **kw),
            atol=1e-2, rtol=1e-2)


def _channels_last(x, on):
    """x in channels-last memory (4-D or 5-D) when `on`, else as it is."""
    if not on:
        return x
    fmt = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
    return x.contiguous(memory_format=fmt)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("d", [1, 16])
def test_dense3x3_wgmma_route_ragged_on_card(rnd, d, channels_last):
    """The wgmma route of dense3x3 at ragged shapes: W = 75 (a 64-pixel
    tile and a partial one), H = 37 (not a multiple of R * d = 4d), two
    weight groups at B = 2, the two-input form, a float32 output and the
    16-channel slab (Ci = 16, 48); input NCHW (one counted copy each) or
    channels-last. The result lies channels-last."""
    bf = torch.bfloat16
    build.reset_launch_counts()
    x = _channels_last(rnd(2, 32, 37, 75, dtype=bf), channels_last)
    ws = (rnd(2, 32, 32, 3, 3) * 0.06).to(bf)
    aff = torch.stack([rnd(2, 32).abs() + 0.5, rnd(2, 32)], 1)
    cases = [(x, ws, dict(affine=aff)),
             (x[:1], ws[:1], dict(affine=aff[:1], x2=x[1:], wt2=ws[1:],
                                  affine2=aff[1:])),
             (x, ws, dict(out_dtype=torch.float32))]
    for ci in (16, 48):
        xc = _channels_last(rnd(1, ci, 37, 75, dtype=bf), channels_last)
        wc = (rnd(1, 32, ci, 3, 3) * (2 / (9 * ci)) ** 0.5).to(bf)
        ac = torch.stack([rnd(1, ci).abs() + 0.5, rnd(1, ci)], 1)
        cases.append((xc, wc, dict(affine=ac)))
    for xi, wt, kw in cases:
        got = trr.dense3x3(xi, wt, dilation=d, **kw)
        assert got.shape == (xi.shape[0], 32, 37, 75)
        assert got.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(
            got, trr.dense3x3_plain(xi, wt, dilation=d, **kw),
            atol=1e-2, rtol=1e-2)
    torch.cuda.synchronize()
    assert build.launch_counts()["dense3x3"] == 5
    copies = 0 if channels_last else 6  # x, x[:1], x[1:], x (f32), 2 slabs
    assert build.LAYOUT_COPIES["to channels-last"] == copies


@pytest.mark.parametrize("channels_last", [False, True])
def test_conv3d_wgmma_route_ragged_on_card(rnd, channels_last):
    """The wgmma route of conv3d_bn_relu at B = 2, D = 7, H = 11, W = 37
    (no dimension a multiple of its 2 x 2 x 64 tile), Ci = 32 and 16, from
    NCDHW or channels-last-3d input; the result lies channels-last-3d, and
    the fused last layer reads it."""
    bf = torch.bfloat16
    for ci in (32, 16):
        x = _channels_last(rnd(2, ci, 7, 11, 37, dtype=bf).relu(),
                           channels_last)
        w = (rnd(32, ci, 3, 3, 3) * (2 / (27 * ci)) ** 0.5).to(bf)
        shift = rnd(32) * 0.1
        got = tcf.conv3d_bn_relu(x, w, shift)
        assert got.shape == (2, 32, 7, 11, 37)
        assert got.is_contiguous(memory_format=torch.channels_last_3d)
        torch.testing.assert_close(got, tcf.conv3d_bn_relu_plain(x, w, shift),
                                   atol=1e-2, rtol=1e-2)
    w1 = (rnd(1, 32, 3, 3, 3) * 0.05).to(bf)
    vol = rnd(2, 7, 11, 37, dtype=bf)
    _check(tcf.conv3d_skip_softargmin(got, w1, vol, -3),
           tcf.conv3d_skip_softargmin_plain(got, w1, vol, -3), bf)


@pytest.mark.parametrize("out_cl", [True, False])
@pytest.mark.parametrize("shape", [(2, 7, 11, 37), (1, 9, 12, 70)])
def test_conv3d_c8_route_on_card(rnd, shape, out_cl):
    """The 8 -> 8 tensor-core route of conv3d_bn_relu (stages 2-3) at a
    ragged shape (no dimension a multiple of its 3 x 4 x 64 tile) and at
    D = 9, from channels-last-3d input, writing channels-last (the inner
    layers) or NCDHW (a stage's last layer, for the fused skip layer):
    every element within two bf16 rounding steps of the plain version;
    no layout copy, one launch each."""
    bf = torch.bfloat16
    B, D, H, W = shape
    build.reset_launch_counts()
    x = _channels_last(rnd(B, 8, D, H, W, dtype=bf).relu(), True)
    w = (rnd(8, 8, 3, 3, 3) * (2 / 216) ** 0.5).to(bf)
    shift = rnd(8) * 0.1
    got = tcf.conv3d_bn_relu(x, w, shift, channels_last=out_cl)
    torch.cuda.synchronize()
    assert got.shape == (B, 8, D, H, W)
    assert build.lies_channels_last(got) == out_cl
    assert got.is_contiguous() != out_cl
    _assert_two_steps(got, tcf.conv3d_bn_relu_plain(x, w, shift))
    assert build.launch_counts()["conv3d_bn_relu"] == 1
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 0}


@pytest.mark.parametrize("last_ncdhw", [False, True])
def test_conv3d_c8_stage_on_card(rnd, last_ncdhw):
    """A stage-2/3 filter's layers: the 1 -> 8 entry (no affine) on its
    tensor-core route writing channels-last, four 8 -> 8 layers on the
    tensor cores, then conv3d_skip_softargmin's tensor-core route; each layer against its
    plain version from the same input. As the path runs them (every layer
    channels-last, no layout copy), and with the last 8 -> 8 layer writing
    NCDHW, which the skip layer copies once to channels-last."""
    bf = torch.bfloat16
    build.reset_launch_counts()
    act = rnd(1, 1, 9, 13, 70, dtype=bf).relu()
    w = (rnd(8, 1, 3, 3, 3) * (2 / 27) ** 0.5).to(bf)
    shift = rnd(8) * 0.1
    y = tcf.conv3d_bn_relu(act, w, shift)
    assert build.lies_channels_last(y)
    torch.testing.assert_close(y, tcf.conv3d_bn_relu_plain(act, w, shift),
                               atol=1e-2, rtol=1e-2)
    for last in (False, False, False, last_ncdhw):
        w = (rnd(8, 8, 3, 3, 3) * (2 / 216) ** 0.5).to(bf)
        shift = rnd(8) * 0.1
        out = tcf.conv3d_bn_relu(y, w, shift,
                                 channels_last=False if last else None)
        assert build.lies_channels_last(out) != last
        _assert_two_steps(out, tcf.conv3d_bn_relu_plain(y, w, shift))
        y = out
    assert y.is_contiguous() == last_ncdhw
    w1 = (rnd(1, 8, 3, 3, 3) * 0.1).to(bf)
    vol = rnd(1, 9, 13, 70, dtype=bf)
    _assert_two_steps(tcf.conv3d_skip_softargmin(y, w1, vol, -4),
                      tcf.conv3d_skip_softargmin_plain(y, w1, vol, -4))
    torch.cuda.synchronize()
    counts = {k: v for k, v in build.launch_counts().items() if v}
    assert counts == {"conv3d_bn_relu": 5, "conv3d_skip_softargmin": 1}
    assert build.LAYOUT_COPIES == {"to channels-last": int(last_ncdhw),
                                   "to contiguous": 0}


def _entry_operands(rnd, B, Co, D, H, W, dtype):
    """A stage entry's vol, (a0, b0) with b0 > 0 (so relu(b0) > 0 and a
    padding that took the affine would show), wt and shift."""
    vol = rnd(B, D, H, W).to(dtype)
    a0b0 = torch.stack([rnd(1)[0].abs() + 0.5, rnd(1)[0].abs() + 0.2])
    wt = (rnd(Co, 1, 3, 3, 3) * (2 / 27) ** 0.5).to(dtype)
    return vol, a0b0, wt, rnd(Co) * 0.1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (1, 32, 24, 46, 154),   # stage 1 of the 368x1232 forward
    (1, 8, 9, 92, 308),     # stage 2
    (1, 8, 9, 184, 616),    # stage 3
    (2, 8, 7, 11, 37),      # ragged: no dimension a multiple of 3 x 4 x 64
    (2, 32, 7, 11, 37),
])
def test_conv3d_entry_route_on_card(rnd, shape, dtype):
    """A stage's entry, layer 0's BN + ReLU fused (conv3d_entry): bf16 on
    the tensor-core entry route, within two rounding steps of
    conv3d_entry_plain and channels-last; float32 on the CUDA cores, atol
    2e-4 / rtol 1e-3, NCDHW. One launch each, counted as the "entry"
    route, no layout copy."""
    B, Co, D, H, W = shape
    vol, a0b0, wt, shift = _entry_operands(rnd, B, Co, D, H, W, dtype)
    assert tcf.conv3d_tensor_core_route(dtype, 1, Co) == (
        dtype == torch.bfloat16)
    build.reset_launch_counts()
    got = tcf.conv3d_entry(vol, a0b0, wt, shift)
    torch.cuda.synchronize()
    assert build.launch_counts()["conv3d_bn_relu"] == 1
    assert build.route_counts()["conv3d_bn_relu[entry]"] == 1
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 0}
    want = tcf.conv3d_entry_plain(vol, a0b0, wt, shift)
    assert got.shape == want.shape == (B, Co, D, H, W)
    if dtype == torch.bfloat16:
        assert build.lies_channels_last(got)
        _assert_two_steps(got, want)
    else:
        assert got.is_contiguous()
        torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)


def test_conv3d_entry_makes_no_host_sync_on_card(rnd):
    """conv3d_entry keeps (a0, b0) on the device: neither route makes the
    host wait for the card (torch's sync debug mode raises on a sync)."""
    calls = [_entry_operands(rnd, 1, co, 9, 20, 70, dt)
             for co, dt in ((8, torch.bfloat16), (32, torch.bfloat16),
                            (8, torch.float32))]
    for args in calls:  # builds and loads the library first
        tcf.conv3d_entry(*args)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for args in calls:
            tcf.conv3d_entry(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert build.route_counts() == {"conv3d_bn_relu[entry]": 3}


def test_conv3d_entry_ncdhw_out_on_card(rnd):
    """The bf16 1 -> 8 entry writes NCDHW where asked (conv3d_bn_relu with
    channels_last=False, no affine), and the 1 -> 32 one refuses it."""
    bf = torch.bfloat16
    x = rnd(2, 1, 7, 11, 37, dtype=bf).relu()
    w = (rnd(8, 1, 3, 3, 3) * (2 / 27) ** 0.5).to(bf)
    shift = rnd(8) * 0.1
    build.reset_launch_counts()
    got = tcf.conv3d_bn_relu(x, w, shift, channels_last=False)
    torch.cuda.synchronize()
    assert got.is_contiguous() and not build.lies_channels_last(got)
    _assert_two_steps(got, tcf.conv3d_bn_relu_plain(x, w, shift))
    assert build.route_counts() == {"conv3d_bn_relu[entry]": 1}
    with pytest.raises(ValueError, match="channels-last only"):
        tcf.conv3d_bn_relu(x, rnd(32, 1, 3, 3, 3).to(bf), rnd(32),
                           channels_last=False)


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape", [
    (1, 32, 24, 46, 154, 0),    # stage 1 of the 368x1232 forward
    (1, 8, 9, 92, 308, -4),     # stage 2
    (1, 8, 9, 184, 616, -4),    # stage 3
    (2, 32, 24, 3, 70, -4),     # ragged: W = 70, H = 3
    (2, 8, 9, 5, 37, 0),        # ragged: H = 5 (TH = 2), W = 37
])
def test_skip_softargmin_wgmma_route_on_card(rnd, shape, channels_last):
    """The tensor-core route of conv3d_skip_softargmin at the path's three
    shapes and at ragged ones, from channels-last input (no layout copy)
    or NCDHW (one counted copy): within two bf16 rounding steps of the
    plain version (`_assert_two_steps`), and, since both sum float32 from
    the same bf16 operands, within atol 1e-3 / rtol 1e-4 of it."""
    B, C, D, H, W, start = shape
    bf = torch.bfloat16
    assert tcf.skip_tensor_core_route(bf, C)
    x = _channels_last(rnd(B, C, D, H, W, dtype=bf).relu(), channels_last)
    wt = (rnd(1, C, 3, 3, 3) * (2 / (27 * C)) ** 0.5).to(bf)
    vol = (rnd(B, D, H, W) * 2).to(bf)
    build.reset_launch_counts()
    got = tcf.conv3d_skip_softargmin(x, wt, vol, start)
    torch.cuda.synchronize()
    assert build.launch_counts()["conv3d_skip_softargmin"] == 1
    assert build.LAYOUT_COPIES == {
        "to channels-last": 0 if channels_last else 1, "to contiguous": 0}
    want = tcf.conv3d_skip_softargmin_plain(x, wt, vol, start)
    assert got.shape == (B, H, W) and got.dtype == torch.float32
    _assert_two_steps(got, want)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


def test_skip_softargmin_off_the_tensor_cores_on_card(rnd):
    """float32 stays on the CUDA cores, which read NCDHW: a channels-last
    input is copied once to the default layout. bf16 at a width the route
    does not take raises."""
    build.reset_launch_counts()
    x = _channels_last(rnd(1, 32, 24, 5, 70).relu(), True)
    wt, vol = rnd(1, 32, 3, 3, 3) * 0.05, rnd(1, 24, 5, 70)
    assert not tcf.skip_tensor_core_route(torch.float32, 32)
    torch.testing.assert_close(
        tcf.conv3d_skip_softargmin(x, wt, vol, 0),
        tcf.conv3d_skip_softargmin_plain(x, wt, vol, 0), atol=2e-4,
        rtol=1e-3)
    torch.cuda.synchronize()
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 1}
    xb = rnd(1, 16, 9, 5, 70, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="8 or 32 input channels"):
        tcf.conv3d_skip_softargmin(
            xb, rnd(1, 16, 3, 3, 3, dtype=torch.bfloat16),
            rnd(1, 9, 5, 70, dtype=torch.bfloat16), 0)
    assert build.launch_counts()["conv3d_skip_softargmin"] == 1


def test_conv3d_float32_c8_on_cuda_cores_on_card(rnd):
    """float32 8 -> 8 layers stay on the CUDA cores, which read NCDHW: a
    channels-last input is copied once, and the result lies NCDHW unless
    channels-last is asked for."""
    build.reset_launch_counts()
    x = rnd(1, 8, 9, 12, 20).relu()
    w, shift = rnd(8, 8, 3, 3, 3) * 0.2, rnd(8)
    assert not tcf.conv3d_tensor_core_route(torch.float32, 8, 8)
    want = tcf.conv3d_bn_relu_plain(x, w, shift)
    got = tcf.conv3d_bn_relu(_channels_last(x, True), w, shift)
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)
    got = tcf.conv3d_bn_relu(x, w, shift, channels_last=True)
    assert build.lies_channels_last(got)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)
    torch.cuda.synchronize()
    assert build.launch_counts()["conv3d_bn_relu"] == 2
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 1}


def test_conv3d_32_route_refuses_ncdhw_out_on_card(rnd):
    """The 32-channel tensor-core route writes channels-last only."""
    x = _channels_last(rnd(1, 32, 3, 4, 70, dtype=torch.bfloat16), True)
    w = rnd(32, 32, 3, 3, 3).to(torch.bfloat16)
    with pytest.raises(ValueError, match="channels-last only"):
        tcf.conv3d_bn_relu(x, w, rnd(32), channels_last=False)


def test_channels_last_cuda_core_routes_on_card(rnd):
    """Channels-last input (no layout copy) and channels-last output where
    asked, against the plain versions: the bf16 3 -> 32 entry (the
    narrow-entry route: NCHW in, channels-last out) and 32 -> 1 output conv
    (the narrow-output route: channels-last in); the same two shapes in
    float32 and a float32 32 -> 32 layer, which stay on the CUDA-core
    tiles (the entry writing channels-last where asked, the output reading
    it); and the 1 -> 32 entry of conv3d_bn_relu (its tensor-core route,
    no affine)."""
    build.reset_launch_counts()
    for dt in (torch.bfloat16, torch.float32):
        x3 = rnd(2, 3, 29, 70, dtype=dt)
        we = (rnd(2, 32, 3, 3, 3) * 0.2).to(dt)
        y = trr.dense3x3(x3, we, dilation=1, channels_last=True)
        assert y.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(y, trr.dense3x3_plain(x3, we, dilation=1),
                                   atol=1e-2, rtol=1e-2)
        wo = (rnd(2, 1, 32, 3, 3) * 0.1).to(dt)
        torch.testing.assert_close(
            trr.dense3x3(y, wo, dilation=1, out_dtype=torch.float32),
            trr.dense3x3_plain(y, wo, dilation=1, out_dtype=torch.float32),
            atol=1e-2, rtol=1e-2)
    assert build.route_counts() == {"dense3x3[entry]": 1,
                                    "dense3x3[output]": 1}
    xf = _channels_last(rnd(2, 32, 29, 70), True)
    wf = rnd(2, 32, 32, 3, 3) * 0.06
    torch.testing.assert_close(trr.dense3x3(xf, wf, dilation=2),
                               trr.dense3x3_plain(xf, wf, dilation=2),
                               atol=2e-4, rtol=1e-3)
    xv = rnd(1, 1, 6, 9, 40, dtype=torch.bfloat16).relu()
    wv = (rnd(32, 1, 3, 3, 3) * 0.3).to(torch.bfloat16)
    sv = rnd(32) * 0.1
    got = tcf.conv3d_bn_relu(xv, wv, sv)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    torch.testing.assert_close(got, tcf.conv3d_bn_relu_plain(xv, wv, sv),
                               atol=1e-2, rtol=1e-2)
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 0}


def _check(got, want, dtype):
    """float32: atol 2e-4 / rtol 1e-3. bf16, where one rounding step in a
    staged intermediate spreads through the next layer: mean |delta| below
    2 % of the plain output's span, the bar of chip_smoke.py."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    span = (want.max() - want.min()).item()
    assert (got - want).abs().mean().item() < 0.02 * span


def _dwsep_operands(rnd, G, C, Co, dtype):
    dw = (rnd(G, C, 3, 3) * 0.3).to(dtype)
    pw = (rnd(G, Co, C) * 0.2).to(dtype)
    aff = torch.stack([rnd(G, C).abs() + 0.5, rnd(G, C)], 1)
    return dw, pw, aff


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dwsep_kernels_match_plain_on_card(rnd, dtype):
    """The solo and pair dw-sep kernels, two weight groups, the widest
    pair (8, 16), on a ragged 37 x 75 plane; each launch counted (bf16 on
    the tensor-core route, from NCHW input)."""
    build.reset_launch_counts()
    x = rnd(2, 32, 37, 75, dtype=dtype)
    dw, pw, aff = _dwsep_operands(rnd, 2, 32, 32, dtype)
    for d in (1, 16):
        _check(trr.dwsep(x, dw, pw, dilation=d, affine=aff),
               trr.dwsep_plain(x, dw, pw, dilation=d, affine=aff), dtype)
    dw2, pw2, aff2 = _dwsep_operands(rnd, 2, 32, 32, dtype)
    for d1, d2 in ((8, 16), (2, 1)):
        kw = dict(dilation1=d1, dilation2=d2, affine1=aff, affine2=aff2)
        _check(trr.dwsep2(x, dw, pw, dw2, pw2, **kw),
               trr.dwsep2_plain(x, dw, pw, dw2, pw2, **kw), dtype)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert (counts["dwsep3x3"], counts["dwsep3x3_pair"]) == (2, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_kernel_matches_plain_on_card(rnd, dtype):
    """The tower chain (3 -> 32 entry, two weight groups) and the head chain
    (two-input entry, 32 -> 1 float32 output) on a ragged 29 x 150 plane."""
    build.reset_launch_counts()

    def w(G, co, ci):
        return (rnd(G, co, ci, 3, 3) * (2 / (9 * ci)) ** 0.5).to(dtype)

    def a(G, c):
        return torch.stack([rnd(G, c).abs() + 0.5, rnd(G, c) * 0.1], 1)

    x = rnd(2, 3, 29, 150, dtype=dtype)
    wts = [w(2, 32, 3)] + [w(2, 32, 32) for _ in range(4)]
    affs = [None] + [a(2, 32) for _ in range(4)]
    kw = dict(dilations=(1, 2, 4, 8, 16))
    tower = trr.chain(x, wts, affs, **kw)
    _check(tower, trr.chain_plain(x, wts, affs, **kw), dtype)
    wts = [w(1, 32, 32) for _ in range(5)] + [w(1, 1, 32)]
    affs = [a(1, 32) for _ in range(5)] + [None]
    kw = dict(dilations=(8, 8, 4, 2, 1, 1), x2=tower[1:], wt2=w(1, 32, 32),
              aff2=a(1, 32), out_dtype=torch.float32)
    head = trr.chain(tower[:1], wts, affs, **kw)
    assert head.dtype == torch.float32 and head.shape == (1, 1, 29, 150)
    _check(head, trr.chain_plain(tower[:1], wts, affs, **kw), dtype)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert (counts["chain3x3"], counts["chain3x3[dual]"]) == (2, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layers_dense_shapes_match_plain_on_card(rnd, dtype):
    """The dense3x3 shapes of the planar "layers" path at batch 1, one
    weight set: the 1- and 3-channel tower entries, a head half (32 -> 32,
    d = 8, with affine) and the 32 -> 1 output conv in the compute dtype.
    bf16 runs the entries on the narrow-entry route, the head half on the
    32-output tensor-core route and the output on the narrow-output route;
    float32 runs all four on the CUDA-core tiles (the entries' channel loop
    with a 1-channel tail)."""
    build.reset_launch_counts()
    for ci, co, d, aff in ((1, 32, 1, False), (3, 32, 1, False),
                           (32, 32, 8, True), (32, 1, 1, False)):
        x = rnd(1, ci, 37, 75, dtype=dtype)
        wt = (rnd(1, co, ci, 3, 3) * (2 / (9 * ci)) ** 0.5).to(dtype)
        kw = dict(dilation=d)
        if aff:
            kw["affine"] = torch.stack([rnd(1, ci).abs() + 0.5,
                                        rnd(1, ci)], 1)
        got = trr.dense3x3(x, wt, **kw)
        assert got.dtype == dtype and got.shape == (1, co, 37, 75)
        _check(got, trr.dense3x3_plain(x, wt, **kw), dtype)
    torch.cuda.synchronize()
    assert build.launch_counts()["dense3x3"] == 4
    assert build.route_counts() == (
        {"dense3x3[entry]": 2, "dense3x3[output]": 1}
        if dtype == torch.bfloat16 else {})


@pytest.mark.parametrize("d", [1, 16])
@pytest.mark.parametrize("ci,B,G", [(3, 2, 2), (1, 1, 1), (3, 1, 1),
                                    (2, 2, 1)])
def test_dense_entry_route_on_card(rnd, ci, B, G, d):
    """The narrow-entry route of dense3x3 (the refinement's 3 -> 32 and
    1 -> 32 tower entries) at ragged planes (W = 75 and 70: a 64-pixel
    tile and a partial one; H = 37 and 29: odd, no multiple of R * d),
    one and two weight groups: NCHW in as it lies, channels-last out, no
    layout copy. bf16 out (with and without an affine) within two rounding
    steps of the plain version; float32 out at atol 2e-4 / rtol 1e-3 (the
    same exact products, summed in another order)."""
    bf = torch.bfloat16
    assert trr.dense_entry_route(bf, ci, 32, d, 1, G)
    build.reset_launch_counts()
    for H, W in ((37, 75), (29, 70)):
        x = rnd(B, ci, H, W, dtype=bf)
        wt = (rnd(G, 32, ci, 3, 3) * (2 / (9 * ci)) ** 0.5).to(bf)
        aff = torch.stack([rnd(G, ci).abs() + 0.5, rnd(G, ci)], 1)
        for kw in ({}, dict(affine=aff)):
            got = trr.dense3x3(x, wt, dilation=d, **kw)
            assert got.shape == (B, 32, H, W) and got.dtype == bf
            assert got.is_contiguous(memory_format=torch.channels_last)
            _assert_two_steps(got, trr.dense3x3_plain(x, wt, dilation=d,
                                                      **kw))
        got = trr.dense3x3(x, wt, dilation=d, out_dtype=torch.float32)
        assert got.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(
            got, trr.dense3x3_plain(x, wt, dilation=d,
                                    out_dtype=torch.float32),
            atol=2e-4, rtol=1e-3)
    torch.cuda.synchronize()
    assert build.launch_counts()["dense3x3"] == 6
    assert build.route_counts() == {"dense3x3[entry]": 6}
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 0}


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("co,B,G,d", [(1, 1, 1, 1), (8, 2, 2, 16),
                                      (1, 2, 2, 4), (3, 1, 1, 1)])
def test_dense_output_route_on_card(rnd, co, B, G, d, channels_last):
    """The narrow-output route of dense3x3 (the refinement's 32 -> 1
    output conv; m64n8k16, the weights zero-padded to 8 outputs) at ragged
    planes (37 x 75, 11 x 37), one and two weight groups, from
    channels-last input (no copy) or NCHW (one counted copy a call):
    (B, Co, H, W) out, float32 at atol 2e-4 / rtol 1e-3, bf16 within two
    rounding steps; with an affine too. Asking it for channels-last
    output raises where Co > 1."""
    bf = torch.bfloat16
    assert trr.dense_output_route(bf, 32, co, d, 1, G)
    build.reset_launch_counts()
    calls = 0
    for H, W in ((37, 75), (11, 37)):
        x = _channels_last(rnd(B, 32, H, W, dtype=bf), channels_last)
        wt = (rnd(G, co, 32, 3, 3) * (2 / 288) ** 0.5).to(bf)
        aff = torch.stack([rnd(G, 32).abs() + 0.5, rnd(G, 32)], 1)
        for out in (torch.float32, bf):
            for kw in ({}, dict(affine=aff)):
                got = trr.dense3x3(x, wt, dilation=d, out_dtype=out, **kw)
                calls += 1
                assert got.shape == (B, co, H, W) and got.dtype == out
                assert got.is_contiguous()
                want = trr.dense3x3_plain(x, wt, dilation=d, out_dtype=out,
                                          **kw)
                if out == torch.float32:
                    torch.testing.assert_close(got, want, atol=2e-4,
                                               rtol=1e-3)
                else:
                    _assert_two_steps(got, want)
    torch.cuda.synchronize()
    assert build.route_counts() == {"dense3x3[output]": calls}
    assert build.LAYOUT_COPIES == {
        "to channels-last": 0 if channels_last else calls,
        "to contiguous": 0}
    if co > 1:
        with pytest.raises(ValueError, match="narrow-output route"):
            trr.dense3x3(x, wt, dilation=d, channels_last=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dwsep_one_group_matches_plain_on_card(rnd, dtype):
    """The dw-sep kernels as the "layers" path runs them, batch 1 and one
    weight set: the (8, 16) pair, whose intermediate fills 196 KB of
    shared memory, and the solo layers of the wide-image split."""
    build.reset_launch_counts()
    x = rnd(1, 32, 37, 75, dtype=dtype)
    dw, pw, aff = _dwsep_operands(rnd, 1, 32, 32, dtype)
    dw2, pw2, aff2 = _dwsep_operands(rnd, 1, 32, 32, dtype)
    kw = dict(dilation1=8, dilation2=16, affine1=aff, affine2=aff2)
    _check(trr.dwsep2(x, dw, pw, dw2, pw2, **kw),
           trr.dwsep2_plain(x, dw, pw, dw2, pw2, **kw), dtype)
    for d in (8, 16):
        _check(trr.dwsep(x, dw, pw, dilation=d, affine=aff),
               trr.dwsep_plain(x, dw, pw, dilation=d, affine=aff), dtype)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert (counts["dwsep3x3"], counts["dwsep3x3_pair"]) == (2, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_broadcast_matches_plain_on_card(rnd, dtype):
    """The probe's (C, 1) -> (C, N) broadcast, exact, at the microbench's
    N = 1024 (16-byte stores) and a ragged N = 1000 (element stores)."""
    build.reset_launch_counts()
    v = rnd(32, 1, dtype=dtype)
    for n in (1024, 1000):
        assert torch.equal(probe.lane_broadcast(v, n),
                           probe.lane_broadcast_plain(v, n))
    torch.cuda.synchronize()
    assert build.launch_counts()["lane_broadcast"] == 2


def _assert_two_steps(got, want):
    """bf16 within two rounding steps of the plain version: every element
    within 2 bf16 ulps of the plain value (2 * 2**-8 relative) plus 2e-2
    of the output's largest magnitude for sums that cancel."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    tol = 2 * 2.0 ** -8 * want.abs() + 2e-2 * want.abs().max()
    bad = ((got - want).abs() > tol).sum().item()
    assert bad == 0, f"{bad} elements beyond two rounding steps"


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("d", [1, 16])
def test_dwsep_wgmma_route_ragged_on_card(rnd, d, channels_last):
    """The tensor-core route of dwsep3x3 (solo and pair) at ragged shapes:
    W = 75 (a 64-pixel tile and a partial one) and 37, H = 37 and 11 (not
    multiples of R * d = 4d), two weight groups at B = 2, C = 16 -> 32
    (C != Co), from NCHW (one counted copy a call) or channels-last
    input; the result lies channels-last."""
    bf = torch.bfloat16
    assert trr.dwsep_tensor_core_route(bf, (32, 32), (d,), 2)
    assert trr.dwsep_tensor_core_route(bf, (16, 32, 32), (d, 17 - d), 2)
    build.reset_launch_counts()
    calls = 0
    for (B, G, H, W) in ((2, 2, 37, 75), (1, 1, 11, 37)):
        for C in (32, 16):
            x = _channels_last(rnd(B, C, H, W, dtype=bf), channels_last)
            dw, pw, aff = _dwsep_operands(rnd, G, C, 32, bf)
            got = trr.dwsep(x, dw, pw, dilation=d, affine=aff)
            assert got.is_contiguous(memory_format=torch.channels_last)
            _assert_two_steps(got, trr.dwsep_plain(x, dw, pw, dilation=d,
                                                   affine=aff))
            dw2, pw2, aff2 = _dwsep_operands(rnd, G, 32, 32, bf)
            kw = dict(dilation1=17 - d, dilation2=d, affine1=aff,
                      affine2=aff2)
            got = trr.dwsep2(x, dw, pw, dw2, pw2, **kw)
            assert got.is_contiguous(memory_format=torch.channels_last)
            _check(got, trr.dwsep2_plain(x, dw, pw, dw2, pw2, **kw), bf)
            calls += 1
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert (counts["dwsep3x3"], counts["dwsep3x3_pair"]) == (calls, calls)
    assert build.LAYOUT_COPIES == {
        "to channels-last": 0 if channels_last else 2 * calls,
        "to contiguous": 0}


@pytest.mark.parametrize("d1,d2,G", [(2, 4, 2), (8, 16, 2), (8, 4, 1),
                                     (2, 1, 1)])
def test_dwsep_pair_shapes_of_the_path_on_card(rnd, d1, d2, G):
    """Every pair shape of the refinement paths (the towers' (2, 4) and
    (8, 16) with two weight groups at B = 2, the head's (8, 4) and (2, 1)
    at B = 1), channels-last, against two plain solo layers; and the solo
    layers of the same dilations."""
    bf = torch.bfloat16
    build.reset_launch_counts()
    x = _channels_last(rnd(G, 32, 45, 150, dtype=bf), True)
    dw, pw, aff = _dwsep_operands(rnd, G, 32, 32, bf)
    dw2, pw2, aff2 = _dwsep_operands(rnd, G, 32, 32, bf)
    kw = dict(dilation1=d1, dilation2=d2, affine1=aff, affine2=aff2)
    _check(trr.dwsep2(x, dw, pw, dw2, pw2, **kw),
           trr.dwsep2_plain(x, dw, pw, dw2, pw2, **kw), bf)
    for d, (w, p, a) in ((d1, (dw, pw, aff)), (d2, (dw2, pw2, aff2))):
        _assert_two_steps(trr.dwsep(x, w, p, dilation=d, affine=a),
                          trr.dwsep_plain(x, w, p, dilation=d, affine=a))
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert (counts["dwsep3x3"], counts["dwsep3x3_pair"]) == (2, 1)
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 0}


def test_dwsep_cuda_core_route_off_the_tensor_cores_on_card(rnd):
    """bf16 shapes the tensor-core route does not take (Co = 8, C = 24,
    d = 17) run on the CUDA cores from NCHW: a channels-last input is
    copied once, the result lies in the default layout."""
    bf = torch.bfloat16
    build.reset_launch_counts()
    for C, Co, d in ((32, 8, 2), (24, 32, 1), (32, 32, 17)):
        assert not trr.dwsep_tensor_core_route(bf, (C, Co), (d,), 1)
        x = _channels_last(rnd(1, C, 21, 40, dtype=bf), True)
        dw, pw, aff = _dwsep_operands(rnd, 1, C, Co, bf)
        got = trr.dwsep(x, dw, pw, dilation=d, affine=aff)
        assert got.is_contiguous()
        _assert_two_steps(got, trr.dwsep_plain(x, dw, pw, dilation=d,
                                               affine=aff))
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 3}


@pytest.mark.parametrize("fields,want", [
    (dict(rows_dw="vpu", rows_paired=True),
     {"dense3x3": 3, "dense3x3[dual]": 1, "dwsep3x3_pair": 4}),
    (dict(rows_dw="vpu", rows_paired=False),
     {"dense3x3": 3, "dense3x3[dual]": 1, "dwsep3x3": 8}),
    (dict(pallas_mode="layers"), {"dense3x3": 5, "dwsep3x3_pair": 6}),
    (dict(rows_dw="chain"), {"chain3x3": 2, "chain3x3[dual]": 1}),
])
def test_refinement_layout_copies_on_card(rnd, fields, want):
    """The bf16 stage-4 refinement under "vpu" (paired, unpaired), "layers"
    and "chain" makes no layout copy: the entries write channels-last, and
    every later layer reads it; launch counts as a forward's (one
    `chain3x3` launch per stack). Nor does the whole 4-stage forward: every
    cost filter layer, the fused last one too, reads channels-last."""
    import numpy as np
    from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward
    from lwsnet_tpu_torch.models.refine_kernels import refine_residual
    # the narrow entries and the output conv on their routes, but "chain"
    routes = {} if fields.get("rows_dw") == "chain" else {
        "dense3x3[entry]": 2 if "pallas_mode" in fields else 1,
        "dense3x3[output]": 1}
    rng = np.random.default_rng(0)
    left = torch.as_tensor(rng.standard_normal((1, 48, 160, 3)),
                           dtype=torch.float32, device="cuda")
    disp = torch.as_tensor(rng.uniform(0, 20, (1, 48, 160, 1)),
                           dtype=torch.float32, device="cuda")
    model = LWSNet(ModelConfig(compute_dtype="bfloat16", **fields),
                   device="cuda", seed=0)
    build.reset_launch_counts()
    with torch.inference_mode():
        got = refine_residual(model, left, disp)
    torch.cuda.synchronize()
    assert got.shape == (1, 48, 160, 1) and torch.isfinite(got).all()
    counts = {k: v for k, v in build.launch_counts().items() if v}
    assert counts == want
    assert build.route_counts() == routes
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 0}
    left, right = (torch.as_tensor(rng.standard_normal((1, 64, 96, 3)),
                                   dtype=torch.float32, device="cuda")
                   for _ in range(2))
    build.reset_launch_counts()
    with torch.inference_mode():
        outs = make_forward(model, device="cuda")(left, right)
    torch.cuda.synchronize()
    assert len(outs) == 4
    assert all(torch.isfinite(o).all() for o in outs)
    counts = {k: v for k, v in build.launch_counts().items() if v}
    assert counts == dict(want, conv3d_bn_relu=15, conv3d_skip_softargmin=3)
    # and the three cost filters' entries on theirs
    assert build.route_counts() == dict(routes, **{"conv3d_bn_relu[entry]": 3})
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 0}


def _chain_operands(rnd, dtype):
    """The tower stack (3 -> 32 entry, four 32 -> 32 layers, two weight
    groups) and the head stack (two-input 32 -> 32 entry, four 32 -> 32
    layers, 32 -> 1), at the refinement's dilations:
    ((wts, affs, dils), (wts, affs, dils, wt2, aff2))."""
    def w(G, co, ci, fan=None):
        return (rnd(G, co, ci, 3, 3) * (2 / (9 * (fan or ci))) ** 0.5).to(
            dtype)

    def a(G, c):
        return torch.stack([rnd(G, c).abs() + 0.5, rnd(G, c) * 0.1], 1)

    tower = ([w(2, 32, 3)] + [w(2, 32, 32) for _ in range(4)],
             [None] + [a(2, 32) for _ in range(4)], (1, 2, 4, 8, 16))
    head = ([w(1, 32, 32, 64)] + [w(1, 32, 32) for _ in range(4)]
            + [w(1, 1, 32)], [a(1, 32) for _ in range(5)] + [None],
            (8, 8, 4, 2, 1, 1), w(1, 32, 32, 64), a(1, 32))
    return tower, head


@pytest.mark.parametrize("channels_last", [False, True])
def test_chain_wgmma_route_ragged_on_card(rnd, channels_last):
    """The tensor-core route of chain3x3 at ragged planes (29 x 150, 11 x
    75: no multiple of the 64-pixel tile, nor of R * d = 4d), every
    dilation of both stacks: the tower (3 -> 32 entry from NCHW as one
    K = 32 product, two weight groups) writes channels-last, the head
    (two-input entry, 32 -> 1 float32 output on m64n8k16) reads its
    halves. Inputs in either layout (one counted copy each where the route
    reads the other); one launch per stack; within two bf16 rounding steps
    of `chain_plain`."""
    bf = torch.bfloat16
    build.reset_launch_counts()
    planes = ((29, 150), (11, 75))
    for H, W in planes:
        (tw, ta, td), (hw, ha, hd, w2, a2) = _chain_operands(rnd, bf)
        assert trr.chain_tensor_core_route(bf, [3] + [32] * 4, [32] * 5, td,
                                           2)
        assert trr.chain_tensor_core_route(bf, [32] * 6, [32] * 5 + [1], hd,
                                           1, True)
        x = _channels_last(rnd(2, 3, H, W, dtype=bf), channels_last)
        tower = trr.chain(x, tw, ta, dilations=td)
        assert tower.shape == (2, 32, H, W)
        assert tower.is_contiguous(memory_format=torch.channels_last)
        _assert_two_steps(tower, trr.chain_plain(x, tw, ta, dilations=td))
        hx = tower if channels_last else tower.contiguous()
        kw = dict(dilations=hd, x2=hx[1:], wt2=w2, aff2=a2,
                  out_dtype=torch.float32)
        head = trr.chain(hx[:1], hw, ha, **kw)
        assert head.dtype == torch.float32 and head.shape == (1, 1, H, W)
        _assert_two_steps(head, trr.chain_plain(hx[:1], hw, ha, **kw))
    torch.cuda.synchronize()
    counts = build.launch_counts()
    n = len(planes)
    assert (counts["chain3x3"], counts["chain3x3[dual]"]) == (2 * n, n)
    # the entry reads NCHW, the head's tensor-core entry channels-last
    assert build.LAYOUT_COPIES == (
        {"to channels-last": 0, "to contiguous": n} if channels_last
        else {"to channels-last": 2 * n, "to contiguous": 0})


def test_chain_off_the_tensor_cores_on_card(rnd):
    """bf16 stacks the tensor-core route does not take (a dilation of 17, a
    16-channel layer) run on the first design, NCHW throughout: a
    channels-last input is copied once, the result lies in the default
    layout."""
    bf = torch.bfloat16
    build.reset_launch_counts()
    (tw, ta, _), _ = _chain_operands(rnd, bf)
    w16 = (rnd(2, 16, 32, 3, 3) * (2 / 288) ** 0.5).to(bf)
    w_in16 = (rnd(2, 32, 16, 3, 3) * (2 / 144) ** 0.5).to(bf)
    a16 = torch.stack([rnd(2, 16).abs() + 0.5, rnd(2, 16) * 0.1], 1)
    stacks = [(tw[:3], ta[:3], (1, 17, 2)),
              ([tw[0], w16, w_in16], [None, ta[1], a16], (1, 2, 4))]
    for wts, affs, dils in stacks:
        assert not trr.chain_tensor_core_route(
            bf, [w.shape[2] for w in wts], [w.shape[1] for w in wts], dils, 2)
        x = _channels_last(rnd(2, 3, 21, 40, dtype=bf), True)
        got = trr.chain(x, wts, affs, dilations=dils)
        assert got.is_contiguous()
        _check(got, trr.chain_plain(x, wts, affs, dilations=dils), bf)
    torch.cuda.synchronize()
    assert build.launch_counts()["chain3x3"] == 2
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 2}


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_chain_narrow_outputs_on_card(rnd, out_dtype):
    """Stacks ending in 1, 3 or 8 outputs (m64n8k16, the B images padded to
    8) at a ragged 37 x 75 plane, two weight groups at batch 2: every
    output channel in the (B, Co, H, W) result, within two bf16 rounding
    steps of `chain_plain`."""
    bf = torch.bfloat16
    build.reset_launch_counts()
    x = _channels_last(rnd(2, 32, 37, 75, dtype=bf), True)
    for co in (1, 3, 8):
        wts = [(rnd(2, 32, 32, 3, 3) * (2 / 288) ** 0.5).to(bf),
               (rnd(2, co, 32, 3, 3) * (2 / 288) ** 0.5).to(bf)]
        affs = [torch.stack([rnd(2, 32).abs() + 0.5, rnd(2, 32) * 0.1], 1)
                for _ in range(2)]
        assert trr.chain_tensor_core_route(bf, [32, 32], [32, co], (4, 1), 2)
        kw = dict(dilations=(4, 1), out_dtype=out_dtype)
        got = trr.chain(x, wts, affs, **kw)
        assert got.shape == (2, co, 37, 75) and got.dtype == out_dtype
        assert got.is_contiguous()
        _assert_two_steps(got, trr.chain_plain(x, wts, affs, **kw))
    torch.cuda.synchronize()
    assert build.launch_counts()["chain3x3"] == 3
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 0}


# -- training on the card ------------------------------------------------------

def _train_batch(shape, seed=0):
    """left, right, and sparse ground truth (a third valid, 1-150 px), as
    `chip_smoke.card_vs_cpu_step` draws them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    batch = [rng.standard_normal(shape + (3,)),
             rng.standard_normal(shape + (3,)),
             rng.uniform(1.0, 150.0, shape)]
    batch[2][rng.uniform(size=shape) > 1 / 3] = 0.0
    return batch


def test_train_step_card_matches_cpu(rnd):
    """One float32 train step (TF32 off) of the full-width model, batch 2
    at 128x256, from the same seed-0 weights on the card and on the CPU:
    loss and stage losses rtol 1e-4; grad_norm rtol 1e-3; the whole
    gradient's cosine >= 0.997 and each tensor's >= 0.95, but a tensor
    below 1e-6 of the global norm (zero to float32) within that of the
    CPU's; BN running statistics rtol 1e-4 (atol 1e-6): the bars of
    `chip_smoke.card_vs_cpu_step`, which gives the readings they sit
    between. cuDNN's and gather's backward sum in another order than the
    CPU's: on this batch the CPU's own float32 gradient, with the left
    image scaled by 1 + 1e-7, moves to cosine 0.9989 whole and 0.985 in a
    tensor."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step
    tcfg = TrainConfig(mask_min_disp=0.0)
    batch = _train_batch((2, 128, 256))
    out = {}
    for dev in ("cuda", "cpu"):
        st = create_train_state(ModelConfig(compute_dtype="float32"), tcfg,
                                seed=0, device=dev)
        st, aux = make_train_step(tcfg, 1)(st, *[
            torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in batch])
        out[dev] = (aux, {n: p.grad.double().cpu()
                          for n, p in st.model.named_parameters()},
                    {n: b.double().cpu()
                     for n, b in st.model.named_buffers()})
    (ga, gg, gs), (ca, cg, cs) = out["cuda"], out["cpu"]
    torch.testing.assert_close(ga["loss"].cpu(), ca["loss"], rtol=1e-4,
                               atol=0)
    torch.testing.assert_close(ga["stage_losses"].cpu(),
                               ca["stage_losses"], rtol=1e-4, atol=0)
    torch.testing.assert_close(ga["grad_norm"].cpu(), ca["grad_norm"],
                               rtol=1e-3, atol=0)
    floor = 1e-6 * float(ca["grad_norm"])
    above = [n for n in gg if float(cg[n].norm()) >= floor]
    for n in gg:
        if n not in above:
            assert float((gg[n] - cg[n]).norm()) <= floor, n
            continue
        cos = (gg[n] * cg[n]).sum() / (gg[n].norm() * cg[n].norm())
        assert cos >= 0.95, (n, float(cos))
    a, b = (torch.cat([g[n].reshape(-1) for n in above]) for g in (gg, cg))
    assert (a * b).sum() / (a.norm() * b.norm()) >= 0.997
    for n, b in gs.items():
        torch.testing.assert_close(b, cs[n], rtol=1e-4, atol=1e-6, msg=n)


def test_train_loss_falls_on_card(rnd):
    """Ten bf16 train steps of the full-width model on one fixed batch
    (2 at 64x128, the module path): every step finite, the loss falls."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.ops.cuda import build as kbuild
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step
    tcfg = TrainConfig(lr=1e-3, mask_min_disp=0.0)
    st = create_train_state(ModelConfig(), tcfg, seed=0, device="cuda")
    step = make_train_step(tcfg, 1)
    batch = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
             for a in _train_batch((2, 64, 128), seed=1)]
    kbuild.reset_launch_counts()
    losses = []
    for _ in range(10):
        st, aux = step(st, *batch)
        assert aux["finite"] == 1.0
        losses.append(float(aux["loss"]))
    assert losses[-1] < losses[0], losses
    assert st.updates == 10
    assert not any(kbuild.launch_counts().values())  # no Hopper kernel


# -- data-parallel training and the infer CLI on the card ---------------------

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_nccl_world_one_step_matches_single_on_card(rnd, monkeypatch):
    """One float32 train step (TF32 off) of the full-width model, batch 2
    at 128x256, from the seed-0 state: under an NCCL process group of one
    process (`parallel.mesh`, from a launcher's environment) against no
    group. Every collective is an identity at world size 1, so the counts
    show that the distributed path ran; loss rel 1e-6, grad_norm rel
    1e-5. Both steps run under deterministic algorithms: by default the
    backward (atomic adds in the warp's and the resize's gradients,
    cuDNN's algorithm choice) moves grad_norm by 1.2e-5 to 3.9e-5 from
    run to run on an H100."""
    import os
    import torch.distributed as dist
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.parallel import mesh
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step
    tcfg = TrainConfig(mask_min_disp=0.0)
    batch = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
             for a in _train_batch((2, 128, 256))]

    def step():
        st = create_train_state(ModelConfig(compute_dtype="float32"), tcfg,
                                seed=0, device="cuda")
        return make_train_step(tcfg, 1)(st, *batch)[1]

    cudnn = torch.backends.cudnn
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG",
                       os.environ.get("CUBLAS_WORKSPACE_CONFIG", ":4096:8"))
    monkeypatch.setattr(cudnn, "deterministic", True)
    monkeypatch.setattr(cudnn, "benchmark", False)
    torch.use_deterministic_algorithms(True)
    try:
        single = step()
    finally:
        torch.use_deterministic_algorithms(False)
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    assert mesh.maybe_initialize_distributed("cuda")
    try:
        assert dist.get_backend() == "nccl"
        assert mesh.process_device("cuda") == torch.device("cuda", 0)
        mesh.reset_collective_counts()
        torch.use_deterministic_algorithms(True)
        ddp = step()
        counts = mesh.collective_counts()
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    assert counts["batch_norm"] > 0, counts
    assert (counts["loss_count"], counts["gradients"], counts["loss"]) == \
        (1, 1, 1), counts
    for k, rtol in (("loss", 1e-6), ("grad_norm", 1e-5)):
        torch.testing.assert_close(ddp[k], single[k], rtol=rtol, atol=0)


def test_infer_cli_launches_the_kernels_on_card(rnd, tmp_path):
    """`cli.infer` on random weights over one 375x1242 frame in bf16:
    four PNGs, finite 368x1232 maps, and the "mxu" forward's launches
    (conv3d_bn_relu 15, conv3d_skip_softargmin 3, dense3x3 11 of which 1
    two-input) for each of the engine's two forwards (a warm-up, then
    the timed one)."""
    import numpy as np
    from lwsnet_tpu_torch.cli import infer
    from lwsnet_tpu_torch.data.png import write_png
    rng = np.random.default_rng(0)
    for d in ("image_2", "image_3"):
        (tmp_path / d).mkdir()
    img = rng.integers(0, 256, (375, 1242, 3), dtype=np.uint8)
    write_png(str(tmp_path / "image_2" / "000000_10.png"), img)
    write_png(str(tmp_path / "image_3" / "000000_10.png"),
              np.roll(img, -9, axis=1))
    build.reset_launch_counts()
    zero = build.launch_counts()
    (frame,) = infer.run(["--img_path", str(tmp_path), "--save_path",
                          str(tmp_path / "out"), "--random_weights"])
    torch.cuda.synchronize()
    want = dict.fromkeys(zero, 0)
    want.update({"conv3d_bn_relu": 30, "conv3d_skip_softargmin": 6,
                 "dense3x3": 22, "dense3x3[dual]": 2})
    assert build.launch_counts() == want
    for s, d in enumerate(frame["disparities"]):
        assert d.shape == (368, 1232) and np.isfinite(d).all(), s
        assert (tmp_path / "out" / f"000000_10_stage{s + 1}.png").is_file()


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_parity_fixture_on_card(rnd, engine):
    """Both paths at 368x1232 against the JAX float32 fixture
    (`tests/torch_fixtures/`, no JAX needed) on each of its sets, in
    float32 and bf16, at `tools.parity`'s fixture bars."""
    import os
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.tools import parity
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), parity.FIXTURE)
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig(compute_dtype=dtype, **ENGINES[engine])
        res = parity.check_fixture(path, cfg, torch.device("cuda"))
        for name, st in res.items():
            assert st["pass"], (dtype, name, [
                (row["stage"], row["bars"]) for row in st["stages"]])


def test_parity_kernels_on_card(rnd, tmp_path):
    """`tools.parity_kernels` on the fixture's trained weights: the
    refinement residual and each stage's filter + soft-argmin on peaked
    volumes within 0.1 % (float32) / 2 % (bf16) of the module path."""
    import os
    from lwsnet_tpu_torch.tools import parity, parity_kernels
    weights = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), os.path.dirname(parity.FIXTURE),
        parity.WEIGHTS)
    res = parity_kernels.main(["--ckpt", weights + ":trained", "--out",
                               str(tmp_path / "parity_kernels.json")])
    assert res["pass"], res["checks"]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_every_launch_meets_its_module_layer_on_card(rnd, engine):
    """`tools.parity_layers` at 368x1232 on the seed-0 network with
    jittered batch norms, in bf16 and float32: every launch of the
    engine's forward matched to its module reference and within its bar,
    and the kernels launched as `chip_smoke.want_counts` says."""
    import chip_smoke
    from lwsnet_tpu_torch.tools import parity_layers as PL
    from lwsnet_tpu_torch.tools.parity import tf32_off
    for dtype in ("bfloat16", "float32"):
        with tf32_off():
            res = PL.check_set("seed0", dtype, [engine], PL.H, PL.W,
                               torch.device("cuda"), log=lambda _: None)
        res = res[engine]
        assert res["held"] == res["launches"] == len(res["rows"])
        assert [r for r in res["rows"] if not r["ok"]] == [], dtype
        assert res["kernel_counts"] == chip_smoke.want_counts(
            engine, res["kernel_counts"]), dtype


def test_planted_launch_fault_is_caught_on_card(rnd):
    """A x1.01 error in the weights of stage 2's first 8->8 layer, on the
    kernel side, in bf16: the per-launch check misses that launch and no
    other."""
    from lwsnet_tpu_torch.tools import parity_layers as PL
    from lwsnet_tpu_torch.tools.parity import tf32_off
    with tf32_off():
        res = PL.check_plant("cf-8", PL.H, PL.W, torch.device("cuda"),
                             log=lambda _: None)
    assert res["planted_at"] == 7 and res["missed"] == [7]


def test_launch_readings_repeat_on_card(rnd):
    """`tools.parity_layers`' sound check of "trained_wide" in float32
    under "mxu", twice in one process: every launch's distances equal in
    both (its launches run under `cudnn_deterministic`; by default a
    float32 max ratio moved between runs of phase 4b)."""
    from lwsnet_tpu_torch.tools import parity_layers as PL
    from lwsnet_tpu_torch.tools.parity import tf32_off
    keys = ("kernel_mean", "module_mean", "kernel_max", "module_max")
    runs = []
    for _ in range(2):
        with tf32_off():
            res = PL.check_set("trained_wide", "float32", ["mxu"], PL.H,
                               PL.W, torch.device("cuda"),
                               log=lambda _: None)
        runs.append([[r[k] for k in keys] for r in res["mxu"]["rows"]])
    assert len(runs[0]) == 29 and runs[0] == runs[1]


@pytest.fixture
def two_cards(tmp_path):
    """Phase 13's weights and data at 64x128 (batch 2), and the one
    process's `dryrun_ddp.layout_child` record on card 0; skips with
    fewer than 2 cards."""
    from lwsnet_tpu_torch.tools import dryrun_ddp
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    work = str(tmp_path)
    halo, n_bn = dryrun_ddp.write_layout_weights(work)
    dryrun_ddp.write_layout_data(f"{work}/b2.npz", 2, (64, 128), (64, 128))
    dryrun_ddp.layout_child(0, 1, work, "b2", "cuda")
    return dict(work=work, single=dryrun_ddp.layout_records(work, "b2", 1)[0],
                halo=halo, n_bn=n_bn)


@pytest.mark.parametrize("spatial", [1, 2], ids=["2x1", "1x2"])
def test_two_card_step_matches_one_process_on_card(two_cards, spatial):
    """Two processes, one a card under NCCL, as 2 x 1 (data-parallel) or
    1 x 2 (row shards), against one process on card 0: the float64 step
    and eval at phase 11's bars, the collectives by purpose, bf16
    replicas bit-identical after 3 steps (`dryrun_ddp.layout_failures`,
    chip_smoke.py phase 13 at 64x128)."""
    import torch.distributed as dist
    from lwsnet_tpu_torch.tools import dryrun_ddp
    work = two_cards["work"]
    dryrun_ddp.spawn(dryrun_ddp.layout_child, 2, (work, "b2", "cuda"),
                     300.0, work, device="cuda", spatial=spatial)
    assert not dist.is_initialized()
    readings, fails = dryrun_ddp.layout_failures(
        dryrun_ddp.layout_records(work, "b2", 2), two_cards["single"],
        two_cards["halo"], two_cards["n_bn"])
    print(readings)
    assert not fails, fails
