"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card and nvcc and skips elsewhere. The file
imports torch and the port only, so it also runs where JAX is not
installed; `--noconftest` keeps pytest from loading the JAX test setup:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \
        tests/test_torch_gpu.py

Shapes are small and ragged (no dimension a multiple of a block's tile),
so the kernels' edge masks are exercised. float32 runs with TF32 off at
atol 2e-4 / rtol 1e-3; bf16 outputs may differ from the plain version by
one rounding step, so bf16 runs at atol 1e-2 / rtol 1e-2.
"""

import pytest
import torch

from lwsnet_tpu_torch.ops.cuda import build
from lwsnet_tpu_torch.ops.cuda import costfilter as tcf
from lwsnet_tpu_torch.ops.cuda import refine_rows as trr

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
        "dense3x3[dual]": 1}


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
