"""The cost filters' 1 -> C entries (`conv3d_entry`), on the CPU.

On the card a bf16 stage's entry at 4, 8, 16, 32 or 64 outputs is one
launch (`c1` in `csrc/conv3d_bn_relu.cu`): it stages the raw volume,
applies layer 0's BN + ReLU to the values inside the volume (zero
outside: the conv's padding comes after the activation), and multiplies
the taps of G output rows a product group, k = (kd (G + 2) + sh) 3 + kw,
as the K of wgmma slices against B images that each block lays out from
the weights, the G rows x Co outputs on N. The kernel cannot run here, so
these tests pin what surrounds it: the plain version against the two
steps it fuses, bit for bit; the port's `filter_soft_argmin` against the
JAX package's (Pallas kernels in interpret mode) with layer 0's BN shift
b0 > 0, where a padding that took the affine would be wrong; the blocks'
weight layout, mirrored from the kernel's index arithmetic, against the
weights; and a torch emulation of the kernel's staging and K indexing
against the plain version. float32 unless stated, inputs from a numpy
seed.
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
import torch.nn.functional as F  # noqa: E402

from lwsnet_tpu.ops.pallas import costfilter as jcf  # noqa: E402
from lwsnet_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                      to_jax_variables)
from lwsnet_tpu_torch.models.blocks import (CostFilter3D,  # noqa: E402
                                            bn_affine, init_params)
from lwsnet_tpu_torch.ops.cuda import costfilter as tcf  # noqa: E402
from test_torch_model import jitter  # noqa: E402

# The route's tile, staged rows and their pitch (csrc/conv3d_bn_relu.cu,
# namespace c1): 74, or 82 at 4 outputs, whose A rows are pixel pairs.
TD, TH, TW, P, P_PAIRS, THREADS = 3, 4, 64, 74, 82, 128
SD, SH, SW = TD + 2, TH + 2, TW + 2
WIDTHS = [4, 8, 16, 32, 64]


def _operands(rng, B, D, H, W, Co, dtype=torch.float32, b0=0.4):
    """vol (B, D, H, W), a0b0 (2,) float32 with a0 > 0 and the given b0,
    wt (Co, 1, 3, 3, 3) and shift (Co,) float32."""
    vol = torch.from_numpy(rng.standard_normal((B, D, H, W)).astype(
        np.float32)).to(dtype)
    a0b0 = torch.tensor([rng.uniform(0.5, 1.5), b0], dtype=torch.float32)
    wt = torch.from_numpy((rng.standard_normal((Co, 1, 3, 3, 3))
                           / np.sqrt(27)).astype(np.float32)).to(dtype)
    shift = torch.from_numpy(rng.normal(0, 0.1, Co).astype(np.float32))
    return vol, a0b0, wt, shift


@pytest.mark.parametrize("Co", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_entry_plain_equals_the_two_steps(dtype, Co):
    """conv3d_entry_plain is exactly what the filter computed before the
    fusion: relu(vol * a0 + b0) rounded once to the dtype, then
    conv3d_bn_relu_plain; and conv3d_entry runs it on the CPU."""
    vol, a0b0, wt, shift = _operands(np.random.default_rng(Co), 2, 5, 7, 13,
                                     Co, dtype)
    a0, b0 = a0b0[:1], a0b0[1:]
    act = F.relu(vol.float() * a0 + b0).to(dtype)[:, None]
    want = tcf.conv3d_bn_relu_plain(act, wt, shift)
    got = tcf.conv3d_entry_plain(vol, a0b0, wt, shift)
    assert got.dtype == dtype and got.shape == (2, Co, 5, 7, 13)
    assert torch.equal(got, want)
    assert torch.equal(tcf.conv3d_entry(vol, a0b0, wt, shift), want)


@pytest.mark.parametrize("B,H,W,D,layers,channels,start", [
    (1, 6, 10, 24, 2, 32, 0),   # stage-1 class: the JAX d-grid path
    (1, 6, 10, 9, 2, 8, -4),    # stage-2/3 class: the folded path
])
def test_filter_soft_argmin_matches_jax_with_positive_b0(B, H, W, D, layers,
                                                         channels, start):
    """The port's filter on the CPU (the entry's plain version) against the
    JAX package's, on weights bridged by convert.py, with layer 0's BN
    shift b0 > 0 (bias 0.6, running mean -0.3): relu(b0) > 0, so a
    padding that took the affine would differ, as the last check shows."""
    rng = np.random.default_rng(D + channels)
    cost = rng.standard_normal((B, H, W, D)).astype(np.float32)
    port = CostFilter3D(layers, channels)
    init_params(port, torch.Generator().manual_seed(0))
    variables = jitter(to_jax_variables(port.state_dict()), rng)
    variables["params"]["BNReLUConv3D_0"]["BatchNorm_0"]["bias"][:] = 0.6
    variables["batch_stats"]["BNReLUConv3D_0"]["BatchNorm_0"]["mean"][:] = \
        -0.3
    port.load_state_dict(from_jax_variables(variables), strict=True)
    params, stats = dict(port.named_parameters()), dict(port.named_buffers())
    pre = "BNReLUConv3D_0.BatchNorm_0"
    a0, b0 = bn_affine(params[f"{pre}.weight"], params[f"{pre}.bias"],
                       stats[f"{pre}.running_mean"],
                       stats[f"{pre}.running_var"])
    assert float(b0.detach()) > 0.6
    want = np.asarray(jax.jit(functools.partial(
        jcf.filter_soft_argmin, layers=layers, channels=channels,
        start=start, dtype=jnp.float32, interpret=True))(
        jnp.asarray(cost), variables["params"], variables["batch_stats"]))
    kw = dict(layers=layers, channels=channels, start=start,
              dtype=torch.float32)
    with torch.no_grad():
        got = tcf.filter_soft_argmin(torch.from_numpy(cost), params, stats,
                                     **kw)
    assert got.shape == (B, H, W, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)

    def padded_affine(vol, a0b0, wt, shift):
        """The wrong rule: the affine applied to the zero padding too."""
        act = F.relu(F.pad(vol, (1, 1, 1, 1, 1, 1)) * a0b0[0] + a0b0[1])
        return F.relu(F.conv3d(act[:, None], wt) + shift.view(1, -1, 1, 1, 1))

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcf, "conv3d_entry", padded_affine)
        wrong = tcf.filter_soft_argmin(torch.from_numpy(cost), params, stats,
                                       **kw)
    assert np.abs(wrong.numpy() - want).max() > 1e-2


def _shape(Co):
    """The route's product groups (`c1::Shape`): G output rows a group (1
    at 64 outputs, 2 at 32, 4 at 16, 8 and 4), N = G Co columns, KT =
    9 (G + 2) staged values a pixel in KC slices of 16 (27 in 2 at 64)."""
    G = {64: 1, 32: 2}.get(Co, 4)
    KT = 9 * (G + 2)
    return G, G * Co, KT, (KT + 15) // 16


def _pitch(Co):
    """The staged rows' pitch, elements."""
    return P_PAIRS if Co == 4 else P


def _pixel(Co, w, lane, half):
    """The pixel of A's row 16w + lane // 4 + 8 half that lane `lane` of
    warp w loads: that row's pixel, or at 4 outputs (A's rows in pairs)
    pixel 16w + 2 (lane // 4) + half."""
    if Co == 4:
        return w * 16 + 2 * (lane // 4) + half
    return w * 16 + lane // 4 + 8 * half


def _block_images(wt):
    """The entry kernel's B images as its blocks write them, in uint16
    element units: thread t writes column n = t % N (= r Co + co) of the
    16-byte rows of 8 k from k0 = 8 kr for kr = t // N, + 128 // N, ...,
    at byte kr // 2 * SLICE + n // 8 * 256 + kr % 2 * 128 + n % 8 * 16:
    for k = (kd (G + 2) + sh) 3 + kw, wt[co, kd, sh - r, kw] where k < KT
    and 0 <= sh - r <= 2, else 0."""
    Co = wt.shape[0]
    G, N, KT, KC = _shape(Co)
    flat = wt.reshape(Co, 27)
    slice_bytes = 16 * N * 2
    img = torch.full((KC * slice_bytes // 2,), float("nan"))
    written = set()
    for t in range(THREADS):
        n = t % N
        r, co = n // Co, n % Co
        for kr in range(2 * KC):
            if kr % (THREADS // N) != t // N:
                continue
            assert (kr, n) not in written
            written.add((kr, n))
            at = (kr // 2 * slice_bytes + n // 8 * 256 + kr % 2 * 128
                  + n % 8 * 16) // 2
            for j in range(8):
                k = 8 * kr + j
                sh = k // 3 % (G + 2)
                img[at + j] = (flat[co, k // (3 * (G + 2)) * 9 + sh * 3
                                    + k % 3 - 3 * r]
                               if k < KT and 0 <= sh - r <= 2 else 0.0)
    assert len(written) == 2 * KC * N
    return img


def _b_matrix(img, N):
    """(16 KC, N) B read from the images as wgmma reads K-major slices
    without swizzle (csrc/tc.cuh): core matrix (n // 8, k // 8) of slice
    k // 16 at (n // 8) * 256 + (k % 16 // 8) * 128 bytes, a core row (one
    n) 16 bytes of 8 consecutive k."""
    slice_el = 16 * N
    K = img.numel() // slice_el * 16
    b = torch.empty(K, N)
    for k in range(K):
        for n in range(N):
            b[k, n] = img[k // 16 * slice_el + n // 8 * 128
                          + k % 16 // 8 * 64 + n % 8 * 8 + k % 8]
    return b


@pytest.mark.parametrize("Co", WIDTHS)
def test_entry_images_unpack_to_the_weights(Co):
    """The blocks' B images hold, for output row r of a group and staged
    row sh, the weights of tap kh = sh - r: column (r, co) of rows k =
    (kd (G + 2) + sh) 3 + kw is wt[co, kd, sh - r, kw] where 0 <= sh - r
    <= 2 and zero elsewhere, zero beyond KT; every element is written
    once."""
    wt = torch.from_numpy(np.random.default_rng(Co).standard_normal(
        (Co, 1, 3, 3, 3)).astype(np.float32))
    G, N, KT, KC = _shape(Co)
    img = _block_images(wt)
    # 2 KB at 4, 4 KB at 8, 8 KB at 16, 6 KB at 32, 4 KB at 64
    assert img.numel() * 2 == KC * 16 * N * 2
    assert not torch.isnan(img).any()
    b = _b_matrix(img, N).reshape(KC * 16, G, Co)
    want = torch.zeros(KC * 16, G, Co)
    w = wt[:, 0].permute(1, 2, 3, 0)  # (kd, kh, kw, co)
    for r in range(G):
        for kd in range(3):
            for kh in range(3):
                for kw in range(3):
                    want[(kd * (G + 2) + kh + r) * 3 + kw, r] = w[kd, kh, kw]
    assert torch.equal(b, want)


def _staged_cells():
    """(row, column) of every value a tile stages, from the threads as the
    kernel hands them out: thread t takes column t % 64 + 1 of rows 0-14
    (t < 64) or 15-29, and threads below 60 the halo column 0 (even t) or
    65 (odd) of row t // 2. Each of the 30 x 66 cells is one thread's."""
    cells = []
    for t in range(THREADS):
        half = 0 if t < TW else SD * SH // 2
        cells += [(half + i, t % TW + 1) for i in range(SD * SH // 2)]
        if t < 2 * SD * SH:
            cells.append((t // 2, SW - 1 if t % 2 else 0))
    assert sorted(cells) == [(r, c) for r in range(SD * SH)
                             for c in range(SW)]
    return torch.tensor(cells).T


def _a_offsets(Co, pitch=None):
    """(64, 16 KC) offsets into a staged buffer, for group 0, at which the
    wgmma register A of thread (warp w, lane l) reads its rows m = 16w +
    l // 4 (+ 8) at columns k = kc * 16 + j // 2 * 8 + 2 (l % 4) + j % 2:
    pixel(m) + kd * plane + sh * pitch + kw of k = (kd (G + 2) + sh) 3 +
    kw (`_pixel`), and -1 (a zero) for k >= KT. Each (m, k) is one
    thread's, once."""
    G, _, KT, KC = _shape(Co)
    pitch = _pitch(Co) if pitch is None else pitch
    plane = SH * pitch
    amap = torch.full((64, 16 * KC), -2, dtype=torch.long)
    for t in range(THREADS):
        w, lane = t // 32, t % 32
        q = lane % 4
        for kc in range(KC):
            for i in range(4):  # row half i % 2, k pair i // 2
                m, p = w * 16 + lane // 4 + 8 * (i % 2), _pixel(Co, w, lane,
                                                                i % 2)
                for j in (i // 2 * 2, i // 2 * 2 + 1):
                    k = kc * 16 + j // 2 * 8 + 2 * q + j % 2
                    assert amap[m, k] == -2
                    amap[m, k] = (p + k // (3 * (G + 2)) * plane
                                  + k // 3 % (G + 2) * pitch + k % 3
                                  if k < KT else -1)
    assert (amap != -2).all()
    return amap


def _group_base(Co, g, pitch=None):
    """Group g's first staged element: depth od = g // (TH / G), rows from
    oh0 = g % (TH / G) * G."""
    G = _shape(Co)[0]
    pitch = _pitch(Co) if pitch is None else pitch
    return g // (TH // G) * SH * pitch + g % (TH // G) * G * pitch


def _stores(Co):
    """The epilogue's writes of a group's accumulator, lane by lane as the
    kernel makes them: (m, n, pixel, row, channel) for accumulator row m
    (A's row), column n, to y's pixel w0 + pixel, row oh0 + row. Lane (g,
    q) of warp w holds rows 16w + g (+ 8) at columns 8j + 2q (+ 1). At 4
    outputs (NCDHW) it writes, per (j, e), column 8j + 2q + e of both its
    rows as one pixel pair, 16w + 2g and + 1 (A's rows in pairs), row 2j +
    q // 2, channel 2 (q % 2) + e; at 16, 32 and 64 a quad transpose hands
    it the 8 columns n = 32c + 8q .. of its row in block c, which it writes
    to row n // Co, channels n % Co .. of pixel 16w + g (+ 8); at 8 the
    stmatrix box puts column 8r + co at row r, channel co. Every (m, n)
    is written once."""
    _, N, _, _ = _shape(Co)
    out = []
    for w in range(4):
        for lane in range(32):
            g, q = lane // 4, lane % 4
            if Co == 4:
                for j in range(2):
                    for e in range(2):
                        for half in range(2):
                            m = 16 * w + g + 8 * half
                            pixel = _pixel(Co, w, lane, half)
                            assert pixel == 16 * w + 2 * g + half
                            out.append((m, 8 * j + 2 * q + e, pixel,
                                        2 * j + q // 2, 2 * (q % 2) + e))
            elif Co >= 16:
                for c in range(N // 32):
                    for half in range(2):
                        m = 16 * w + g + 8 * half
                        n = 32 * c + 8 * q
                        out += [(m, n + i, m, n // Co, n % Co + i)
                                for i in range(8)]
            else:
                for half in range(2):
                    m = 16 * w + g + 8 * half
                    out += [(m, n, m, n // Co, n % Co)
                            for n in range(N) if n % 8 // 2 == q]
    mn = sorted((m, n) for m, n, *_ in out)
    assert mn == [(m, n) for m in range(64) for n in range(N)]
    return torch.tensor(out).T


def _emulate(vol, a0b0, wt, shift):
    """The entry kernel's arithmetic in torch float32, tile by tile as its
    blocks walk them: the staged values (`_staged_cells`: row r is depth
    d0 - 1 + r // 6, image row h0 - 1 + r % 6; column c pixel w0 - 1 + c)
    into a buffer of the route's pitch, the activation inside the volume
    and 0 outside; per product group (G output rows of one depth, none at
    a depth beyond D) the register A read at `_a_offsets` from the
    group's base on, times the blocks' B images, whose columns are the
    group's rows x the output channels, from the shift of each column's
    channel on; relu, and the lanes' writes (`_stores`) to y, masked to
    the volume. Returns y and how often each element was written."""
    B, D, H, W = vol.shape
    Co = wt.shape[0]
    G, N, _, _ = _shape(Co)
    pitch = _pitch(Co)
    b_img = _b_matrix(_block_images(wt), N)
    amap = _a_offsets(Co)
    m, n, px, row, ch = _stores(Co)
    col_shift = shift[torch.arange(N) % Co]
    act = F.relu(vol.float() * a0b0[0] + a0b0[1]).to(vol.dtype).float()
    y = torch.full((B, Co, D, H, W), float("nan"))
    count = torch.zeros((B, Co, D, H, W), dtype=torch.long)
    r, c = _staged_cells()
    for b in range(B):
        for d0 in range(0, D, TD):
            for h0 in range(0, H, TH):
                for w0 in range(0, W, TW):
                    dd, hh, ww = d0 - 1 + r // SH, h0 - 1 + r % SH, w0 - 1 + c
                    inside = ((dd >= 0) & (dd < D) & (hh >= 0) & (hh < H)
                              & (ww >= 0) & (ww < W))
                    v = act[b, dd.clamp(0, D - 1), hh.clamp(0, H - 1),
                            ww.clamp(0, W - 1)]
                    s = torch.full((SD * SH * pitch,), float("nan"))
                    s[r * pitch + c] = torch.where(inside, v, torch.zeros(()))
                    for g in range(TD * TH // G):
                        dz = d0 + g // (TH // G)
                        if dz >= D:
                            continue
                        a = torch.where(
                            amap >= 0,
                            s[_group_base(Co, g) + amap.clamp(min=0)],
                            torch.zeros(()))
                        out = F.relu(a @ b_img + col_shift)  # (64, N)
                        h = h0 + g % (TH // G) * G + row
                        wp = w0 + px
                        ok = (h < H) & (wp < W)
                        y[b, ch[ok], dz, h[ok], wp[ok]] = out[m[ok], n[ok]]
                        count[b, ch[ok], dz, h[ok], wp[ok]] += 1
    return y, count


@pytest.mark.parametrize("B,D,H,W", [
    (2, 7, 11, 37),   # ragged: no dimension a multiple of the 3 x 4 x 64 tile
    (1, 5, 9, 70),    # AnyNet's D = 5: two depth tiles, the sixth depth idle
])
@pytest.mark.parametrize("Co", WIDTHS)
def test_entry_k_emulation_matches_plain(Co, B, D, H, W):
    """At a ragged shape and at D = 5, with b0 > 0, the emulation
    reproduces conv3d_entry_plain: every A element comes from the staged
    buffer (no NaN left), every output element is written once (at 4
    outputs by the lanes' pixel-pair stores of NCDHW rows), and the
    padding stays zero after the activation."""
    vol, a0b0, wt, shift = _operands(np.random.default_rng(7 + Co + D), B,
                                     D, H, W, Co)
    want = tcf.conv3d_entry_plain(vol, a0b0, wt, shift)
    got, count = _emulate(vol, a0b0, wt, shift)
    assert not torch.isnan(got).any()
    assert (count == 1).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def a_read_wavefronts(Co, pitch):
    """Shared-memory wavefronts per warp-wide A read of the entry kernel,
    averaged over its reads of every group of a tile and 4 warps, for
    staged rows `pitch` elements apart (SH rows a depth plane): a read
    takes as many wavefronts as the most distinct 4-byte words that its
    lanes address in one of the 32 banks (lanes reading one word share
    it; lanes of k >= KT read nothing)."""
    G = _shape(Co)[0]
    amap = _a_offsets(Co, pitch)
    total = n = 0
    for g in range(TD * TH // G):
        base = _group_base(Co, g, pitch)
        for w in range(4):
            for kc in range(amap.shape[1] // 16):
                for i in range(4):
                    for jj in range(2):
                        banks = {}
                        for lane in range(32):
                            m = w * 16 + lane // 4 + 8 * (i % 2)
                            k = kc * 16 + i // 2 * 8 + 2 * (lane % 4) + jj
                            if amap[m, k] < 0:
                                continue
                            word = (base + int(amap[m, k])) // 2
                            banks.setdefault(word % 32, set()).add(word)
                        if banks:
                            total += max(len(v) for v in banks.values())
                            n += 1
    return total / n


@pytest.mark.parametrize("Co,at72", [(4, 2.57), (8, 2.0), (16, 2.0),
                                     (32, 1.9), (64, 1.75)])
def test_entry_pitch_spreads_a_reads_over_the_banks(Co, at72):
    """At the route's pitch (74; 82 at 4 outputs, whose A rows pair
    pixels and meet 2 wavefronts a read at 74) no A read meets a bank
    conflict; at 72, the next multiple of 8, they would average 1.75-2.6
    wavefronts."""
    assert a_read_wavefronts(Co, _pitch(Co)) == 1.0
    assert a_read_wavefronts(Co, 72) == pytest.approx(at72, abs=0.05)
    if Co == 4:
        assert a_read_wavefronts(Co, P) == 2.0
