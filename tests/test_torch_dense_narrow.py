"""The narrow routes of `dense3x3` on the CPU: the refinement's entry
(Ci x 9 <= 32 taps -> 32 outputs) and its output (32 -> Co <= 8).

On the card the entry runs as one K = 32 product over a pixel's taps
(`csrc/dense3x3_entry.cuh`) and the output as `dense3x3_tc.cuh`'s body on
wgmma m64n8k16; each block lays out its B images from the weights as the
wrapper hands them, the images `_entry_images` and
`_wgmma_images(_pad_outputs(...))` give. The CUDA kernels cannot run
here, so these tests pin what surrounds them: the route rules (which
shapes each takes, mirrored from the C++ `use` functions); the blocks'
weight layouts, mirrored from the kernels' index arithmetic, against
those images; and the images, by an emulation of each route's product in
torch that reads them as the kernel reads them, held against
`dense3x3_plain` and against the JAX planar kernel
(`lwsnet_tpu.ops.pallas.refine.fused_dense`, interpret mode). float32,
inputs from a numpy seed, atol 2e-4 / rtol 1e-3 (the emulations sum the
same products in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lwsnet_tpu.ops.pallas import refine as K
from lwsnet_tpu_torch.ops.cuda import refine as trf
from lwsnet_tpu_torch.ops.cuda import refine_rows as trr

BF, F32 = torch.bfloat16, torch.float32
TOL = dict(atol=2e-4, rtol=1e-3)


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


def _affine(rng, G, c):
    return torch.from_numpy(np.stack(
        [rng.uniform(0.5, 1.5, (G, c)), rng.normal(0, 0.5, (G, c))],
        1).astype(np.float32))


def _taps(x, d):
    """(B, C, H, W) -> (B, H, W, C, 9): each pixel's 3x3 taps at dilation
    d, tap = ky * 3 + kx, zero outside the image."""
    H, W = x.shape[2:]
    xp = F.pad(x, (d, d, d, d))
    return torch.stack([xp[:, :, ky * d:ky * d + H, kx * d:kx * d + W]
                        for ky in range(3) for kx in range(3)],
                       -1).permute(0, 2, 3, 1, 4)


def _groups(y_of_g, B, G):
    """Batch b with weight set b // (B // G)."""
    per = B // G
    return torch.cat([y_of_g(g, slice(g * per, (g + 1) * per))
                      for g in range(G)], 0)


def _unpack_images(images, C):
    """B images (G, C/16, co // 8, c % 16 // 8, co % 8, c % 8) (as
    `_pw_images` lays them) -> (G, C, 32): [g, k, co]."""
    G = images.shape[0]
    return images.reshape(G, C // 16, 4, 2, 8, 8).permute(
        0, 1, 3, 5, 2, 4).reshape(G, C, 32)


def entry_emulation(x, wt, d, affine=None):
    """The narrow-entry route's product: each pixel's K = ci * 9 + tap
    values (the activation inside the image, zero outside and beyond
    Ci * 9), zero-padded to 16 (Ci = 1, one wgmma) or 32 (two), times the
    unpacked `_entry_images`. x: (B, Ci, H, W); wt: (G, 32, Ci, 3, 3).
    Returns (B, 32, H, W) float32."""
    B, Ci = x.shape[:2]
    G = wt.shape[0]
    k_used = 16 if Ci * 9 <= 16 else 32
    b = _unpack_images(trr._entry_images(wt), 32)
    assert b.shape == (G, 32, 32)
    assert not b[:, Ci * 9:].any()  # the padded taps are zero

    def one(g, rows):
        xg = x[rows]
        if affine is not None:
            xg = F.relu(xg * affine[g, 0].view(1, -1, 1, 1)
                        + affine[g, 1].view(1, -1, 1, 1))
        a = _taps(xg, d).reshape(*xg.shape[:1], *x.shape[2:], Ci * 9)
        a = F.pad(a, (0, k_used - Ci * 9))
        return (a @ b[g, :k_used]).permute(0, 3, 1, 2)

    return _groups(one, B, G)


def output_emulation(x, wt, d, affine=None):
    """The narrow-output route's product: per (16-channel chunk, tap) one
    m64n8k16 slice, A the chunk's 16 channels at the tap, B the 16 x 8
    image of `_wgmma_images(_pad_outputs(wt))`, summed over chunks and
    taps; the first Co of the 8 outputs kept. x: (B, Ci, H, W);
    wt: (G, Co, Ci, 3, 3), Co <= 8. Returns (B, Co, H, W) float32."""
    B, Ci = x.shape[:2]
    G, Co = wt.shape[:2]
    img = trr._wgmma_images(trr._pad_outputs(wt))
    # (G, Ci/16, 9, co // 8, ci % 16 // 8, co % 8, ci % 8) -> [g, s, t, k, n]
    assert img.shape == (G, Ci // 16, 9, 1, 2, 8, 8)
    bs = img[:, :, :, 0].permute(0, 1, 2, 3, 5, 4).reshape(G, Ci // 16, 9,
                                                            16, 8)

    def one(g, rows):
        xg = x[rows]
        if affine is not None:
            xg = F.relu(xg * affine[g, 0].view(1, -1, 1, 1)
                        + affine[g, 1].view(1, -1, 1, 1))
        taps = _taps(xg, d)  # (b, H, W, Ci, 9)
        y = 0
        for s in range(Ci // 16):
            for t in range(9):
                y = y + taps[..., s * 16:(s + 1) * 16, t] @ bs[g, s, t]
        return y[..., :Co].permute(0, 3, 1, 2)

    return _groups(one, B, G)


def entry_block_images(wt):
    """The B images a narrow-entry block lays out from wt (G, 32, Ci, 3, 3)
    (`dense3x3_entry_kernel`), as 16-bit words: element (k, co) of slice
    g * 2 + k // 16 at word (co // 8) 128 + (k % 16 // 8) 64 + (co % 8) 8
    + k % 8 of the slice's 512, wt[g, co, k] (k = ci * 9 + tap) for
    k < Ci * 9, else zero."""
    G, _, Ci = wt.shape[:3]
    g, co, k = torch.meshgrid(torch.arange(G), torch.arange(32),
                              torch.arange(32), indexing="ij")
    pos = ((g * 2 + k // 16) * 512 + co // 8 * 128 + k % 16 // 8 * 64
           + co % 8 * 8 + k % 8)
    val = torch.where(k < Ci * 9, wt.reshape(G, 32, Ci * 9)[
        g, co, k.clamp(max=Ci * 9 - 1)], 0)
    out = torch.full((G * 2 * 512,), float("nan"), dtype=wt.dtype)
    out[pos.flatten()] = val.flatten()
    return out


def narrow_block_images(wt):
    """The B images a narrow-output block lays out from wt
    (G, Co, Ci, 3, 3) (`layout_narrow_weights` in csrc/dense3x3_tc.cuh), as
    16-bit words: element (k = ci % 16, n = co) of slice
    (g * Ci / 16 + ci / 16) * 9 + tap at word (k / 8) 64 + n 8 + k % 8 of
    the slice's 128, wt[g, n, ci, tap] for n < Co, else zero."""
    G, Co, Ci = wt.shape[:3]
    g, n, ci, tap = torch.meshgrid(torch.arange(G), torch.arange(8),
                                   torch.arange(Ci), torch.arange(9),
                                   indexing="ij")
    pos = (((g * (Ci // 16) + ci // 16) * 9 + tap) * 128
           + ci % 16 // 8 * 64 + n * 8 + ci % 8)
    val = torch.where(n < Co, wt.reshape(G, Co, Ci, 9)[
        g, n.clamp(max=Co - 1), ci, tap], 0)
    out = torch.full((G * Ci // 16 * 9 * 128,), float("nan"),
                     dtype=wt.dtype)
    out[pos.flatten()] = val.flatten()
    return out


@pytest.mark.parametrize("ci,G", [(3, 2), (3, 1), (2, 2), (1, 1)])
def test_entry_block_layout_is_entry_images(ci, G):
    """Every word of the entry blocks' B images, and the same as the
    chain's entry images (`_entry_images`), exactly."""
    wt = _rand(np.random.default_rng(ci), G, 32, ci, 3, 3)
    got = entry_block_images(wt)
    assert not got.isnan().any()
    assert torch.equal(got, trr._entry_images(wt).flatten())


@pytest.mark.parametrize("co,ci,G", [(1, 32, 1), (1, 32, 2), (3, 16, 1),
                                     (8, 48, 2)])
def test_output_block_layout_is_padded_images(co, ci, G):
    """Every word of the narrow-output blocks' B images, and the same as
    the 32-output route's images of the weights zero-padded to 8 outputs
    (`_wgmma_images(_pad_outputs(...))`, the chain's last layer's),
    exactly."""
    wt = _rand(np.random.default_rng(co + ci), G, co, ci, 3, 3)
    got = narrow_block_images(wt)
    assert not got.isnan().any()
    assert torch.equal(got,
                       trr._wgmma_images(trr._pad_outputs(wt)).flatten())


@pytest.mark.parametrize("ci,groups", [(3, 2), (3, 1), (1, 1), (1, 2),
                                       (2, 1)])
def test_entry_route_takes_the_entries(ci, groups):
    """The "mxu" / "vpu" tower entry (3 -> 32, two groups), the "layers"
    entries (3 -> 32 and 1 -> 32, one group), and 2 -> 32, at every
    dilation the staged rows hold; none is a 32-output tensor-core or
    narrow-output layer."""
    for d in (1, 2, 16):
        assert trr.dense_entry_route(BF, ci, 32, d, 1, groups)
        assert not trr.dense_tensor_core_route(BF, ci, 32, d, 1, groups)
        assert not trr.dense_output_route(BF, ci, 32, d, 1, groups)


@pytest.mark.parametrize("args", [
    (BF, 4, 32, 1, 1, 1),    # Ci = 4: 36 taps, more than one K = 32 product
    (BF, 3, 16, 1, 1, 1),    # Co = 16
    (BF, 3, 1, 1, 1, 1),     # Co = 1
    (F32, 3, 32, 1, 1, 2),   # float32 stays on the CUDA cores
    (BF, 3, 32, 17, 1, 1),   # d = 17: beyond the staged rows
    (BF, 3, 32, 0, 1, 1),
    (BF, 3, 32, 1, 2, 1),    # two inputs
    (BF, 3, 32, 1, 1, 3),    # three weight groups
])
def test_entry_route_refuses(args):
    assert not trr.dense_entry_route(*args)


@pytest.mark.parametrize("co,groups,d", [(1, 1, 1), (1, 2, 1), (8, 1, 16),
                                         (3, 2, 4)])
def test_output_route_takes_the_outputs(co, groups, d):
    """The refinement's 32 -> 1 output (every path; the out dtype is the
    wrapper's, bf16 or float32) and other widths up to 8; 16- and
    48-channel inputs too."""
    for ci in (32, 16, 48):
        assert trr.dense_output_route(BF, ci, co, d, 1, groups)
        assert not trr.dense_tensor_core_route(BF, ci, co, d, 1, groups)
        assert not trr.dense_entry_route(BF, ci, co, d, 1, groups)


@pytest.mark.parametrize("args", [
    (BF, 32, 16, 1, 1, 1),   # Co = 16
    (BF, 32, 32, 1, 1, 1),   # the 32-output route's
    (F32, 32, 1, 1, 1, 1),   # float32 stays on the CUDA cores
    (BF, 32, 1, 17, 1, 1),   # d = 17
    (BF, 32, 1, 1, 2, 1),    # two inputs
    (BF, 24, 1, 1, 1, 1),    # not whole 16-channel chunks
    (BF, 3, 1, 1, 1, 1),
    (BF, 96, 1, 1, 1, 2),    # weights beyond the resident 128 channels
    (BF, 32, 0, 1, 1, 1),
])
def test_output_route_refuses(args):
    assert not trr.dense_output_route(*args)


def test_routes_of_the_paths():
    """Every narrow dense3x3 launch of the bf16 paths takes a narrow route
    (the "layers" entries at batch 1 with one group, the "mxu" / "vpu"
    entry at 2B with two), and no 32-output layer does."""
    for ci, G in ((3, 2), (3, 1), (1, 1)):
        assert trr.dense_entry_route(BF, ci, 32, 1, 1, G)
    assert trr.dense_output_route(BF, 32, 1, 1, 1, 1)
    for d in (1, 2, 4, 8, 16):
        assert trr.dense_tensor_core_route(BF, 32, 32, d, 1, 2)
        assert not trr.dense_entry_route(BF, 32, 32, d, 1, 2)
        assert not trr.dense_output_route(BF, 32, 32, d, 1, 2)
    assert not trr.dense_output_route(BF, 32, 32, 8, 2, 1)  # head entry


@pytest.mark.parametrize("ci,G,d,affine", [
    (3, 2, 1, False),   # the "mxu" / "vpu" tower entry
    (3, 1, 1, False),   # "layers" left entry
    (1, 1, 1, False),   # "layers" disparity entry: one K = 16 product
    (2, 2, 5, True),    # 18 taps, an affine, an odd dilation
    (3, 1, 16, False),  # the widest dilation
])
def test_entry_emulation_matches_plain(ci, G, d, affine):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, ci, 29, 70)
    wt = _rand(rng, G, 32, ci, 3, 3, scale=(2 / (9 * ci)) ** 0.5)
    aff = _affine(rng, G, ci) if affine else None
    want = trr.dense3x3_plain(x, wt, dilation=d, affine=aff)
    got = entry_emulation(x, wt, d, aff)
    assert got.shape == want.shape == (2, 32, 29, 70)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("co,G,d,affine", [
    (1, 1, 1, False),   # the refinement's output conv
    (1, 2, 1, False),
    (8, 1, 16, True),   # the widest route, with an affine
    (3, 2, 4, False),
])
@pytest.mark.parametrize("out_dtype", [F32, BF])
def test_output_emulation_matches_plain(co, G, d, affine, out_dtype):
    """Co outputs kept of the 8 the zero-padded B images give; the result
    cast to the out dtype as the epilogue casts it."""
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 32, 29, 70)
    wt = _rand(rng, G, co, 32, 3, 3, scale=(2 / 288) ** 0.5)
    aff = _affine(rng, G, 32) if affine else None
    want = trr.dense3x3_plain(x, wt, dilation=d, affine=aff,
                              out_dtype=out_dtype)
    got = output_emulation(x, wt, d, aff).to(out_dtype)
    assert got.shape == want.shape == (2, co, 29, 70)
    if out_dtype == F32:
        torch.testing.assert_close(got, want, **TOL)
    else:  # one bf16 rounding of sums that agree to float32 order
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                                   rtol=2 * 2.0 ** -8)


def _jax_dense(x, kern, d, chunk=16):
    """JAX's planar `fused_dense` (interpret mode) on NCHW x and an HWIO
    kernel; NCHW out."""
    H, W = x.shape[2:]
    xc = K.layer_canvas(jnp.asarray(x.numpy()), chunk)
    out = K.fused_dense(xc, jnp.asarray(kern.numpy()), dilation=d,
                        chunk=chunk, h_real=H, w_real=W, interpret=True)
    return torch.from_numpy(np.array(K.layer_uncanvas(out, chunk, H, W)))


@pytest.mark.parametrize("ci,co", [(3, 32), (1, 32), (32, 1)])
def test_emulations_match_jax_fused_dense(ci, co):
    """The "layers" path's narrow launches (`refine.fused_dense`: the JAX
    im2col stack body for the entries, the Co = 1 body for the output), as
    each narrow route computes them, against the JAX kernel."""
    rng = np.random.default_rng(ci + co)
    x = _rand(rng, 1, ci, 48, 96)
    kern = _rand(rng, 3, 3, ci, co, scale=(9 * ci) ** -0.5)
    wt = trf._dense_weight(kern, F32)
    got = (entry_emulation if co == 32 else output_emulation)(x, wt, 1)
    torch.testing.assert_close(got, _jax_dense(x, kern, 1), atol=1e-4,
                               rtol=1e-4)
