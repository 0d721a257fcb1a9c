"""The 4 -> 1 tensor-core route of `conv3d_skip_softargmin` (bf16, Ci = 4,
AnyNet's stages 2-3, any D), on the CPU.

The route runs only on the card (`tests/test_torch_gpu.py` and
`chip_smoke.py` hold it against its plain version there). Here: its
routing and layout rule, the B slices the wrapper lays out for it, the
staging threads' cover of a tile's rows, a numpy emulation of its walk
(each column of tiles over its depth tiles: the staged channels-last rows,
each lane's A and B fragment words of mma.m16n8k16, one product a staged
row with (output row, kd) on N, the lane pairs' exchange of kd terms, the
skip, and each depth tile's two-pass soft-argmin folded into a running
one) against `conv3d_skip_softargmin_plain`, and AnyNet's stage-2/3 filter
with the last layer through that emulation against the JAX package's
`filter_soft_argmin` (its `_folded_last_kernel` in interpret mode);
float32 throughout. Last, a x1.01 weight error planted in stage 3's
fused last layer alone (`skip-4`'s second launch; phase 14 of
chip_smoke.py plants both) caught there alone by its exact reference.
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
from lwsnet_tpu_torch.tools import parity_layers as PL  # noqa: E402
from lwsnet_tpu_torch.tools.parity import tf32_off  # noqa: E402
from test_torch_model import jitter  # noqa: E402

# The route's tile, staged rows and block (csrc/stage4.cuh, shared with
# conv3d_bn_relu's 4 -> 4 route).
TD, TH, TW, PX, THREADS = 5, 4, 64, 68, 256
SH = TH + 2
SROWS, RI = (TD + 2) * SH, ((TD + 2) * SH + 7) // 8
BF = torch.bfloat16


@pytest.mark.parametrize("dtype,ci,tc,reads_cl", [
    (BF, 4, True, False),              # s4: NCDHW, as `c4` writes it
    (BF, 8, True, True),               # tcr: channels-last
    (BF, 3, False, False),             # the CUDA cores
    (torch.float32, 4, False, False),
])
def test_skip_c4_route_rule(dtype, ci, tc, reads_cl):
    """bf16 at 4 channels takes the tensor cores at every D, reading the
    NCDHW that its stage's entry and 4 -> 4 layers write, so no launch of
    the stage copies."""
    assert tcf.skip_tensor_core_route(dtype, ci) == tc
    for D in (1, 5, 7, 65, 129):
        r = tcf.filter_routes(dtype, ci, D)
        assert r.skip == ((tcf.TENSOR_CORES if tc else tcf.CUDA_CORES),
                          reads_cl, False)
        assert r.layer.writes_cl == r.skip.reads_cl == reads_cl


def _slices():
    """`skip_c4_images` of random weights as (sh, k, n) matrices: slice sh
    is 256 bytes, element (k, n) at n * 32 + k * 2."""
    rng = np.random.default_rng(4)
    wt = torch.from_numpy(rng.standard_normal((1, 4, 3, 3, 3)).astype(
        np.float32))
    flat = tcf.skip_c4_images(wt).reshape(4, 8, 16)  # (sh, n, k)
    return wt, flat.permute(0, 2, 1).numpy()


def test_skip_c4_images_unpack_to_the_weights():
    """Slice sh's column n = 4 r + kd holds output row r's tap (kd, kh =
    sh - r), k = 4 kw + ci: every weight is back in place, once for each
    of the two output rows; kd = 3, kw = 3 and the taps outside kh = 0 ..
    2 are zero."""
    wt, bs = _slices()
    assert tcf.skip_c4_images(wt).numel() == 4 * 128  # 1 KB of bf16
    back = np.zeros((2, 4, 4, 3, 4), np.float32)  # (r, ci, kd, kh, kw)
    for sh in range(4):
        for n in range(8):
            r, kd = divmod(n, 4)
            col = bs[sh, :, n]
            if kd < 3 and 0 <= sh - r <= 2:
                for k in range(16):
                    back[r, k % 4, kd, sh - r, k // 4] = col[k]
            else:
                assert not col.any(), (sh, n)
    for r in range(2):
        np.testing.assert_array_equal(back[r, :, :3, :, :3], wt[0].numpy())
        assert not back[r, ..., 3].any() and not back[r, :, 3].any()


def test_skip_c4_staging_covers_every_pair_once():
    """The staging threads' pixel pairs (thread t: pair t % 32 of rows
    t / 32 + 8i, i < RI, and below 2 SROWS pair 32 + t % 2 of row t / 2)
    are each of the 42 rows' 34 pairs exactly once."""
    seen = []
    for tid in range(THREADS):
        k, q = tid % 32, tid // 32
        seen += [(q + 8 * i, k) for i in range(RI) if q + 8 * i < SROWS]
        if tid < 2 * SROWS:
            seen.append((tid // 2, 32 + tid % 2))
    assert sorted(seen) == [(r, k) for r in range(SROWS)
                            for k in range(PX // 2)]


def _b_fragments(wt):
    """Each lane's B fragment words of `skip_c4_images(wt)` as (sh, k, n):
    lane (g, t) holds b0 = word (sh 8 + g) 8 + t (k = 2t, 2t + 1 of
    column g) and b1 = that word + 4 (k + 8)."""
    words = tcf.skip_c4_images(wt).numpy().reshape(-1, 2)
    g, t = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    bs = np.zeros((4, 16, 8), np.float32)
    for sh in range(4):
        for half in range(2):
            w = words[(sh * 8 + g) * 8 + t + 4 * half]  # (8, 4, 2)
            for e in range(2):
                bs[sh, 8 * half + 2 * t + e, g] = w[..., e]
    return bs


def _emulate(x, wt, vol, start):
    """The kernel's walk in numpy float32: per column (b, h0, w0) and
    depth tile d0 the staged rows of PX channels-last voxels from pixel
    w0 - 2 (zeros outside the volume); warp (pb, rg)'s A fragment of each
    of its 4 staged rows a staged depth from each lane's words (row g
    pixel 2g, row g + 8 pixel 2g + 1), times the B fragment of that row,
    summed over the rows into P; lane (g, t)'s accumulator words of P
    exchanged with lane t ^ 1 into its own pixel's kd terms, each added to
    output depth sd - kd; then the volume, the tile's two-pass soft-argmin
    and the fold into the running one, written after the column's last
    depth tile where inside the output."""
    x, wt, vol = (t.detach() for t in (x, wt, vol))
    B, _, D, H, W = x.shape
    xp = np.pad(x.numpy(), ((0, 0), (0, 0), (1, TD + 1), (1, TH + 1),
                            (2, TW + 2)))
    v = vol.numpy()
    bs = _b_fragments(wt)
    g, t = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    odd = t % 2 == 1
    out = np.full((B, H, W), np.nan, np.float32)
    for b in range(B):
        for h0 in range(0, H, TH):
            for w0 in range(0, W, TW):
                run = {}
                for d0 in range(0, D, TD):
                    # stage[r, j, c]: depth d0 - 1 + r // SH, row h0 - 1 +
                    # r % SH, pixel w0 - 2 + j
                    stage = np.stack([
                        xp[b, :, d0 + r // SH, h0 + r % SH,
                           w0:w0 + PX].T for r in range(SROWS)])
                    words = stage.reshape(SROWS, 2 * PX, 2)
                    dn = min(TD, D - d0)
                    for warp in range(THREADS // 32):
                        pb, rg = warp % 4, warp // 4
                        aoff = 2 * (pb * 16 + 2 * g + 1) + t  # (8, 4)
                        cost = np.zeros((TD, 8, 4), np.float32)
                        for sd in range(TD + 2):
                            P = np.zeros((16, 8), np.float32)
                            for sh in range(4):
                                wr = words[sd * SH + 2 * rg + sh]
                                a = np.zeros((16, 16), np.float32)
                                for e in range(2):
                                    a[g, 2 * t + e] = wr[aoff, e]
                                    a[g + 8, 2 * t + e] = wr[aoff + 2, e]
                                    a[g, 2 * t + 8 + e] = wr[aoff + 4, e]
                                    a[g + 8, 2 * t + 8 + e] = wr[aoff + 6, e]
                                P += a @ bs[sh]
                            c0, c1 = P[g, 2 * t], P[g, 2 * t + 1]
                            c2, c3 = P[g + 8, 2 * t], P[g + 8, 2 * t + 1]
                            r1 = np.where(odd, c0, c2)[g, t ^ 1]
                            r2 = c3[g, t ^ 1]
                            k = (np.where(odd, r1, c0), np.where(odd, r2, c1),
                                 np.where(odd, c2, r1))
                            for kd in range(3):
                                if 0 <= sd - kd < TD:
                                    cost[sd - kd] += k[kd]
                        orow, opix = 2 * rg + t // 2, pb * 16 + 2 * g + t % 2
                        h, w = h0 + orow, w0 + opix
                        inside = (h < H) & (w < W)
                        for od in range(dn):
                            cost[od] += np.where(inside, v[
                                b, d0 + od, np.minimum(h, H - 1),
                                np.minimum(w, W - 1)], 0)
                        m = cost[0].copy()
                        for od in range(1, dn):
                            m = np.minimum(m, cost[od])
                        den = np.zeros_like(m)
                        num = np.zeros_like(m)
                        for od in range(dn):
                            e = np.exp(m - cost[od])
                            den = den + e
                            num = num + e * np.float32(start + d0 + od)
                        if d0 == 0:
                            run[warp] = m, den, num
                        else:
                            rm, rden, rnum = run[warp]
                            mm = np.minimum(rm, m)
                            s_run, s_new = np.exp(mm - rm), np.exp(mm - m)
                            run[warp] = (mm, rden * s_run + den * s_new,
                                         rnum * s_run + num * s_new)
                        if d0 + TD >= D:
                            _, den, num = run[warp]
                            out[b, h[inside], w[inside]] = (num / den)[inside]
    assert not np.isnan(out).any()
    return torch.from_numpy(out)


@pytest.mark.parametrize("B,D,H,W,start", [
    (1, 5, 8, 70, -2),     # D = 5 as AnyNet's stages 2-3, two W tiles
    (2, 5, 6, 37, -2),     # B = 2, odd W (2-byte loads), H ragged
    (1, 7, 5, 37, 0),      # two depth tiles, the second of 2 depths
    (1, 65, 3, 20, -32),   # thirteen depth tiles, the last of one depth
])
def test_skip_c4_walk_emulation_matches_plain(B, D, H, W, start):
    """atol 1e-4 / rtol 1e-5 on outputs in bin units: float32 sums in
    another order (per staged row, per staged depth, then the skip; past
    TD costs depth tile by depth tile, rescaled) than the plain conv's
    and softmax's."""
    rng = np.random.default_rng(D + H + W)
    x = torch.from_numpy(np.maximum(rng.standard_normal(
        (B, 4, D, H, W)), 0).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((1, 4, 3, 3, 3))
                           * np.sqrt(2 / 108)).astype(np.float32))
    vol = torch.from_numpy((rng.standard_normal((B, D, H, W)) * 2).astype(
        np.float32))
    want = tcf.conv3d_skip_softargmin_plain(x, wt, vol, start)
    got = _emulate(x, wt, vol, start)
    assert got.shape == want.shape == (B, H, W)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("D", [5, 7])
def test_filter_soft_argmin_skip_c4_matches_jax(monkeypatch, D):
    """AnyNet's stage-2/3 filter (four mid layers of 4 channels, residual
    bins), each launch handing on the layout the bf16 routes use on the
    card: NCDHW from the entry through the 4 -> 4 layers to the fused last
    layer, whose tensor-core route reads it with no copy; the last layer
    through the emulation of its walk. The result matches the JAX
    package's, whose folded formulation ends in `_folded_last_kernel`
    ((D + 2) * 4 <= 128), at atol 2e-4 / rtol 1e-3, the bar of the port's
    filter tests."""
    B, H, W, layers, channels, start = 1, 6, 11, 4, 4, -(D // 2)
    assert (D + 2) * channels <= 128  # JAX's folded kernels
    rng = np.random.default_rng(40 + D)
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

    def last(x, wt, vol, start):
        seen.append((tcf.filter_routes(BF, x.shape[1], D).skip,
                     build.lies_channels_last(x)))
        return _emulate(x, wt, vol, start)

    monkeypatch.setattr(tcf, "conv3d_skip_softargmin", last)
    got = tcf.filter_soft_argmin(
        torch.from_numpy(cost), dict(port.named_parameters()),
        dict(port.named_buffers()), layers=layers, channels=channels,
        start=start, dtype=torch.float32)
    assert seen == [((tcf.TENSOR_CORES, False, False), False)]
    assert got.shape == (B, H, W, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-3)


def test_planted_skip_c4_stage3_fails_at_its_launch_only():
    """At AnyNet's settings (`PL.ANYNET`) a x1.01 error in the weights of
    stage 3's fused last layer (`skip-4`'s second launch, #17; the first,
    stage 2's, is #11), on the kernel side, in bf16 on the seed-0 set at
    64 x 128: that launch misses its exact reference's bar (EXACT_RATIO)
    and every other launch meets its own."""
    with tf32_off():
        res = PL.check_plant("skip-4", 64, 128, torch.device("cpu"),
                             log=lambda _: None, fields=PL.ANYNET, nth=1)
    assert res["planted_at"] == 17
    assert res["missed"] == [17] and res["caught"]
    row = next(r for r in res["rows"] if r["index"] == 17)
    assert row["planted"] and row["route"] == "skip-4"
    assert row["exact_ratio"] > PL.EXACT_RATIO
