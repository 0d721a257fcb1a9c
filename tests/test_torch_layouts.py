"""Memory layouts in the port, on the CPU.

On the card the tensor-core routes of `dense3x3`, `dwsep3x3`, `chain3x3`
and `conv3d_bn_relu` read and write channels-last memory under the logical
(B, C, H, W) / (B, C, D, H, W) shapes. Here the wrappers run their plain
versions, so these tests hold what the layout must not change: a
channels-last input gives the result of its contiguous twin, at the same
logical shape. They also pin the routing rules that decide which layout a
kernel takes (the tensor-core routes channels-last only), and
`build.in_layout`, which makes and counts the one copy a wrapper makes for
a tensor in a layout its kernel does not read.
"""

import numpy as np
import pytest
import torch

from lwsnet_tpu_torch import LWSNet, ModelConfig
from lwsnet_tpu_torch.models.blocks import CostFilter3D, init_params
from lwsnet_tpu_torch.models.refine_kernels import refine_residual
from lwsnet_tpu_torch.ops.cuda import build
from lwsnet_tpu_torch.ops.cuda import costfilter as tcf
from lwsnet_tpu_torch.ops.cuda import refine as trf
from lwsnet_tpu_torch.ops.cuda import refine_rows as trr

CL, CL3 = torch.channels_last, torch.channels_last_3d


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


def _affine(rng, *lead, c):
    return torch.from_numpy(np.stack(
        [rng.uniform(0.5, 1.5, lead + (c,)), rng.normal(0, 0.5, lead + (c,))],
        len(lead)).astype(np.float32))


@pytest.mark.parametrize("ci,co,d,affine,groups", [
    (3, 32, 1, False, 2),    # the "mxu" tower entry, asked for channels-last
    (32, 32, 4, True, 2),    # a grouped tower layer
    (32, 32, 16, True, 1),   # a head layer at the widest dilation
    (32, 1, 1, False, 1),    # the output conv
])
def test_dense_layer_channels_last_input(ci, co, d, affine, groups):
    rng = np.random.default_rng(ci + d)
    x = _rand(rng, 2, ci, 19, 37)
    lead = (groups,) if groups > 1 else ()
    kernel = _rand(rng, *lead, co, ci, 3, 3, scale=(9 * ci) ** -0.5)
    aff = _affine(rng, *lead, c=ci) if affine else None
    kw = dict(dilation=d, affine=aff, groups=groups)
    want = trr.dense_layer(x, kernel, **kw)
    got = trr.dense_layer(x.contiguous(memory_format=CL), kernel,
                          channels_last=True, **kw)
    assert got.shape == want.shape == (2, co, 19, 37)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_dense2_layer_channels_last_input():
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 32, 19, 37)
    kernel = _rand(rng, 32, 64, 3, 3, scale=(9 * 64) ** -0.5)
    aff = _affine(rng, c=64)
    want = trr.dense2_layer(x, kernel, dilation=8, affine=aff)
    got = trr.dense2_layer(x.contiguous(memory_format=CL), kernel,
                           dilation=8, affine=aff)
    assert got.shape == want.shape == (1, 32, 19, 37)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_filter_soft_argmin_channels_last_input(dtype):
    """The stage-1 filter (4 mid layers of 32 channels) on a cost volume
    laid out channels-last in memory."""
    B, H, W, D, layers, channels = 1, 6, 11, 8, 4, 32
    rng = np.random.default_rng(9)
    cost = _rand(rng, B, H, W, D)
    port = CostFilter3D(layers, channels)
    init_params(port, torch.Generator().manual_seed(0))
    params, stats = dict(port.named_parameters()), dict(port.named_buffers())
    kw = dict(layers=layers, channels=channels, start=0, dtype=dtype)
    with torch.no_grad():
        want = tcf.filter_soft_argmin(cost, params, stats, **kw)
        got = tcf.filter_soft_argmin(cost.contiguous(memory_format=CL),
                                     params, stats, **kw)
    assert got.shape == want.shape == (B, H, W, 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_conv3d_bn_relu_channels_last_input():
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 32, 5, 6, 9).relu()
    wt = _rand(rng, 32, 32, 3, 3, 3, scale=(27 * 32) ** -0.5)
    shift = _rand(rng, 32, scale=0.1)
    want = tcf.conv3d_bn_relu(x, wt, shift)
    got = tcf.conv3d_bn_relu(x.contiguous(memory_format=CL3), wt, shift)
    assert got.shape == want.shape == (2, 32, 5, 6, 9)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_tensor_core_route_rules():
    """Which shapes the wgmma routes take (and so read channels-last);
    the rest goes to the CUDA-core routes, never to a plain version."""
    bf, f32 = torch.bfloat16, torch.float32
    route = trr.dense_tensor_core_route
    assert route(bf, 32, 32, 1) and route(bf, 32, 32, 16)
    assert route(bf, 32, 32, 8, inputs=2)     # the head entry
    assert route(bf, 16, 32, 2) and route(bf, 48, 32, 2)
    assert not route(f32, 32, 32, 1)
    assert not route(bf, 3, 32, 1)            # the tower entry
    assert not route(bf, 32, 1, 1)            # the output conv
    assert not route(bf, 32, 32, 17)          # beyond the staged halo
    assert route(bf, 32, 32, 2, groups=2)     # the towers' two sets
    assert not route(bf, 96, 32, 1, inputs=2)  # weights too large to stay
    assert not route(bf, 64, 32, 1, inputs=2, groups=2)
    assert tcf.conv3d_tensor_core_route(bf, 32, 32)
    assert tcf.conv3d_tensor_core_route(bf, 16, 32)
    assert tcf.conv3d_tensor_core_route(bf, 8, 8)   # stages 2-3's 8 -> 8
    assert tcf.conv3d_tensor_core_route(bf, 1, 32)  # the stage-1 entry
    assert tcf.conv3d_tensor_core_route(bf, 1, 8)   # stages 2-3's entries
    assert tcf.conv3d_tensor_core_route(bf, 1, 16)  # AnyNet's stage-1 entry
    for args in ((f32, 1, 32), (f32, 32, 32), (bf, 64, 32), (bf, 1, 3),
                 (f32, 8, 8), (bf, 8, 1), (f32, 1, 8), (f32, 1, 16)):
        assert not tcf.conv3d_tensor_core_route(*args)


def test_in_layout_copies_once_and_counts():
    build.reset_launch_counts()
    x = torch.randn(2, 32, 5, 7)
    y = build.in_layout(x, True)
    assert y.is_contiguous(memory_format=CL) and not y.is_contiguous()
    assert torch.equal(y, x)
    assert build.in_layout(y, True) is y
    assert build.in_layout(x, False) is x
    z = build.in_layout(y, False)
    assert z.is_contiguous() and torch.equal(z, x)
    assert build.LAYOUT_COPIES == {"to channels-last": 1, "to contiguous": 1}
    one = torch.randn(2, 1, 5, 7)  # one channel: the two layouts coincide
    assert build.in_layout(one, True) is one
    assert build.lies_channels_last(y) and not build.lies_channels_last(x)
    assert not build.lies_channels_last(one)
    v = torch.randn(1, 32, 3, 4, 5).contiguous(memory_format=CL3)
    assert build.in_layout(v, True) is v
    e = build.empty((1, 32, 3, 4, 5), torch.bfloat16, torch.device("cpu"),
                    True)
    assert e.is_contiguous(memory_format=CL3) and e.shape == (1, 32, 3, 4, 5)
    build.reset_launch_counts()
    assert build.LAYOUT_COPIES == {"to channels-last": 0, "to contiguous": 0}


def _dwsep_set(rng, *lead, c, co):
    """(affine ([G,] 2, C), depthwise ([G,] C, 1, 3, 3), pointwise
    ([G,] Co, C)) as `dwsep_layer` takes them."""
    return (_affine(rng, *lead, c=c),
            _rand(rng, *lead, c, 1, 3, 3, scale=0.3),
            _rand(rng, *lead, co, c, scale=c ** -0.5))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("d", [1, 16])
def test_dwsep_layer_channels_last_input(groups, d):
    rng = np.random.default_rng(20 + groups + d)
    x = _rand(rng, 2, 32, 19, 37)
    lead = (groups,) if groups > 1 else ()
    w = _dwsep_set(rng, *lead, c=32, co=32)
    want = trr.dwsep_layer(x, *w, dilation=d, groups=groups)
    got = trr.dwsep_layer(x.contiguous(memory_format=CL), *w, dilation=d,
                          groups=groups)
    assert got.shape == want.shape == (2, 32, 19, 37)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("d1,d2", [(16, 1), (1, 16)])
def test_dwsep2_layer_channels_last_input(groups, d1, d2):
    rng = np.random.default_rng(30 + groups + d1)
    x = _rand(rng, 2, 16, 19, 37)  # C = 16 -> 32 -> 32
    lead = (groups,) if groups > 1 else ()
    w1 = _dwsep_set(rng, *lead, c=16, co=32)
    w2 = _dwsep_set(rng, *lead, c=32, co=32)
    kw = dict(dilation1=d1, dilation2=d2, groups=groups)
    want = trr.dwsep2_layer(x, *w1, *w2, **kw)
    got = trr.dwsep2_layer(x.contiguous(memory_format=CL), *w1, *w2, **kw)
    assert got.shape == want.shape == (2, 32, 19, 37)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _planar_set(rng, c, co):
    """(affine (2, C), taps (3, 3, 1, C), pointwise (Co, C)) as
    `fused_dwsep` takes them."""
    return (_affine(rng, c=c), _rand(rng, 3, 3, 1, c, scale=0.3),
            _rand(rng, co, c, scale=c ** -0.5))


@pytest.mark.parametrize("d", [1, 16])
def test_fused_dwsep_channels_last_input(d):
    rng = np.random.default_rng(40 + d)
    x = _rand(rng, 1, 32, 23, 41)
    w = _planar_set(rng, 32, 32)
    want = trf.fused_dwsep(x, *w, dilation=d)
    got = trf.fused_dwsep(x.contiguous(memory_format=CL), *w, dilation=d)
    assert got.shape == want.shape == (1, 32, 23, 41)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d1,d2", [(16, 1), (1, 16)])
def test_fused_dwsep2_channels_last_input(d1, d2):
    rng = np.random.default_rng(50 + d1)
    x = _rand(rng, 1, 32, 23, 41)
    w1, w2 = _planar_set(rng, 32, 32), _planar_set(rng, 32, 32)
    kw = dict(dilation1=d1, dilation2=d2)
    want = trf.fused_dwsep2(x, *w1, *w2, **kw)
    got = trf.fused_dwsep2(x.contiguous(memory_format=CL), *w1, *w2, **kw)
    assert got.shape == want.shape == (1, 32, 23, 41)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_fused_dense_channels_last_flag():
    """`channels_last` asks the card for a channels-last result; it never
    changes the values (here the plain version runs)."""
    rng = np.random.default_rng(60)
    x = _rand(rng, 1, 3, 19, 37)
    k = _rand(rng, 3, 3, 3, 32, scale=0.2)
    torch.testing.assert_close(
        trf.fused_dense(x, k, dilation=1, channels_last=True),
        trf.fused_dense(x, k, dilation=1), atol=0, rtol=0)


def test_dwsep_tensor_core_route_rule():
    """Which dw-sep shapes take the wgmma route (and so read and write
    channels-last): bf16, C 16 or 32, a 32-channel intermediate, 32
    outputs, 1 <= d <= 16, at most two weight groups."""
    bf, f32 = torch.bfloat16, torch.float32
    route = trr.dwsep_tensor_core_route
    for d in (1, 2, 4, 8, 16):
        assert route(bf, (32, 32), (d,), 2)           # "vpu" tower solo
        assert route(bf, (32, 32), (d,))              # head, "layers"
    for d1, d2 in ((2, 4), (8, 16), (8, 4), (2, 1)):  # every path pair
        assert route(bf, (32, 32, 32), (d1, d2), 2)
        assert route(bf, (32, 32, 32), (d1, d2))
    assert route(bf, (16, 32), (3,)) and route(bf, (16, 32, 32), (1, 16))
    assert not route(f32, (32, 32), (2,))             # float32: CUDA cores
    assert not route(bf, (32, 16), (2,))              # Co != 32
    assert not route(bf, (24, 32), (2,))              # C not 16 or 32
    assert not route(bf, (8, 32), (2,))
    assert not route(bf, (32, 16, 32), (2, 4))        # intermediate != 32
    assert not route(bf, (32, 32), (17,))             # beyond the halo
    assert not route(bf, (32, 32, 32), (17, 1))
    assert not route(bf, (32, 32), (0,))
    assert not route(bf, (32, 32), (2,), groups=3)    # weights resident
    assert not route(bf, (32, 32, 32), (2,))          # one dilation a layer


@pytest.fixture(scope="module")
def refine_inputs():
    rng = np.random.default_rng(70)
    left = torch.from_numpy(
        rng.standard_normal((1, 24, 40, 3)).astype(np.float32))
    disp = torch.from_numpy(
        rng.uniform(0, 20, (1, 24, 40, 1)).astype(np.float32))
    return left, disp


@pytest.mark.parametrize("fields", [
    dict(rows_dw="vpu", rows_paired=True),
    dict(rows_dw="vpu", rows_paired=False),
    dict(pallas_mode="layers"),
])
def test_refine_residual_channels_last_inputs(refine_inputs, fields):
    """The stage-4 residual under "vpu" (paired, unpaired) and "layers" is
    unchanged when its (B, H, W, C) inputs lie channels-last, i.e. as
    NCHW memory viewed as NHWC, so that every layer downstream sees the
    other layout."""
    left, disp = refine_inputs
    model = LWSNet(ModelConfig(compute_dtype="float32", **fields),
                   device="cpu")

    def nchw_memory(t):
        return t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)

    with torch.no_grad():
        want = refine_residual(model, left, disp)
        got = refine_residual(model, nchw_memory(left), nchw_memory(disp))
    assert got.shape == want.shape == (1, 24, 40, 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _chain_stack(rng, stack, d):
    """(x, kernels, affines, chain_layer keywords) of a small tower (3 ->
    32 entry, two weight groups) or head (two-input entry, 32 -> 1 float32
    output), interior dilation d."""
    if stack == "tower":
        x = _rand(rng, 2, 3, 19, 37)
        kernels = [_rand(rng, 2, 32, 3, 3, 3, scale=27 ** -0.5)] + [
            _rand(rng, 2, 32, 32, 3, 3, scale=288 ** -0.5) for _ in range(2)]
        affines = [None, _affine(rng, 2, c=32), _affine(rng, 2, c=32)]
        return x, kernels, affines, dict(dilations=(1, d, 2), groups=2)
    x = _rand(rng, 2, 32, 19, 37)
    kernels = [_rand(rng, 32, 64, 3, 3, scale=576 ** -0.5),
               _rand(rng, 32, 32, 3, 3, scale=288 ** -0.5),
               _rand(rng, 1, 32, 3, 3, scale=288 ** -0.5)]
    affines = [_affine(rng, c=64), _affine(rng, c=32), None]
    return x, kernels, affines, dict(dilations=(d, d, 1), two_input=True,
                                     out_dtype=torch.float32)


@pytest.mark.parametrize("stack", ["tower", "head"])
@pytest.mark.parametrize("d", [1, 16])
def test_chain_layer_channels_last_input(stack, d):
    """`chain_layer` on a channels-last input gives its contiguous twin's
    result: the tower's 3-channel input, and the head's two halves read
    from a channels-last tower output (`x[:B]`, `x[B:]`)."""
    rng = np.random.default_rng(80 + d)
    x, kernels, affines, kw = _chain_stack(rng, stack, d)
    want = trr.chain_layer(x, kernels, affines, **kw)
    got = trr.chain_layer(x.contiguous(memory_format=CL), kernels, affines,
                          **kw)
    shape = (2, 32, 19, 37) if stack == "tower" else (1, 1, 19, 37)
    assert got.shape == want.shape == shape
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_chain_tensor_core_route_rule():
    """Which stacks `chain3x3` runs on its tensor-core route (channels-last
    scratch, wgmma): bf16, every layer on dense3x3's tensor-core shapes
    with whole 32-channel input slabs, 32 outputs or at most 8 in the last
    layer, but a narrow entry of at most 3 channels first."""
    bf, f32 = torch.bfloat16, torch.float32
    route = trr.chain_tensor_core_route
    tower = ([3] + [32] * 4, [32] * 5, (1, 2, 4, 8, 16))
    head = ([32] * 6, [32] * 5 + [1], (8, 8, 4, 2, 1, 1))
    assert route(bf, *tower, groups=2)
    assert route(bf, *head, two_input=True)
    assert route(bf, [1] + [32] * 4, [32] * 5, tower[2])   # a 1-channel one
    assert not route(bf, [4] + [32] * 4, [32] * 5, tower[2])  # 36 taps
    assert not route(f32, *tower, groups=2)              # float32
    assert not route(f32, *head, two_input=True)
    assert not route(bf, [3, 32, 16, 32], [32, 16, 32, 32], (1, 2, 4, 8),
                     groups=2)                           # Co != 32 inside
    assert not route(bf, [3, 32, 32], [32, 32, 32], (1, 17, 2),
                     groups=2)                           # d > 16
    assert not route(bf, *head[:2], (8, 8, 4, 2, 32, 1), two_input=True)
    assert not route(bf, *tower, groups=5)               # G * Ci > 128
    assert not route(bf, [96, 32, 32], [32, 32, 1], (8, 4, 1),
                     two_input=True)                     # 2 x 96 > 128
    assert not route(bf, [16, 32], [32, 32], (1, 2))     # a 16-channel slab
    assert route(bf, [3, 32], [32, 1], (1, 1))           # entry + output
    assert route(bf, [32, 32], [32, 8], (1, 1))          # 8 outputs
    assert not route(bf, [32, 32], [32, 16], (1, 1))     # 16 outputs
    assert not route(bf, [32, 32, 32], [32, 1, 32], (1, 1, 1))  # inside
    assert not route(bf, [32] * 9, [32] * 9, (1,) * 9)   # over 8 layers
    assert not route(bf, [32], [32], (1,))               # one layer


@pytest.mark.parametrize("where", ["inputs", "tower"])
def test_refine_residual_chain_channels_last(refine_inputs, monkeypatch,
                                             where):
    """The stage-4 residual under "chain" is unchanged when its (B, H, W,
    C) inputs lie as NCHW memory ("inputs"), and when the tower's output
    lies channels-last, as the tensor-core route writes it on the card
    ("tower"), so that the head reads both halves in that layout."""
    left, disp = refine_inputs
    model = LWSNet(ModelConfig(compute_dtype="float32", rows_dw="chain"),
                   device="cpu")
    with torch.no_grad():
        want = refine_residual(model, left, disp)
    if where == "inputs":
        left, disp = (t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                      for t in (left, disp))
    else:
        chain, laid = trr.chain, []

        def channels_last_out(x, *args, **kw):
            y = chain(x, *args, **kw).contiguous(memory_format=CL)
            laid.append(build.lies_channels_last(y))
            return y

        monkeypatch.setattr(trr, "chain", channels_last_out)
    with torch.no_grad():
        got = refine_residual(model, left, disp)
    assert got.shape == want.shape == (1, 24, 40, 1)
    if where == "inputs":
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        return
    assert laid == [True, False]  # the tower's; the head's has 1 channel
    # The CPU convolutions of the six head layers take another algorithm,
    # and so another float32 summation order, for channels-last input; on
    # this residual (span about 250) that moves the result by tens of
    # float32 steps, hence 2e-6 of the span.
    span = (want.max() - want.min()).item()
    torch.testing.assert_close(got, want, atol=2e-6 * span, rtol=1e-5)
