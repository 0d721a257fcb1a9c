"""dense3x3's float32 route on the CPU: float32 with 32 outputs,
Ci % 8 == 0, d <= 16, one or two inputs, G <= 2 (`csrc/dense3x3_f32.cuh`).

On the card the route stages channels-last input rows by TMA (R = 4
output rows d apart by 64 pixels a tile, R + 2 staged rows of 64 + 2d
pixels, zeros outside the image), applies the pre-activation once per
staged element inside the image only, and sums a lane's 8 pixels x 8
outputs in float32 FMAs: over the inputs, slabs of 16 (or 8) channels,
groups of 8 channels, taps, then channels. The CUDA kernel cannot run here,
so these tests pin what surrounds it: the route rule (mirrored from the
C++ `use`), the shared-memory plan of every shape it takes (a ring of
more stages than a tile has jobs, here and on the bf16 route that shares
it), the bank groups of its shared reads, and a float32 torch emulation
of the tile walk in that order, held against `dense3x3_plain` and against
the JAX package's Pallas `dense_layer` / `dense2_layer` in interpret mode,
at atol 2e-4 / rtol 1e-3 (the emulation sums the same float32 products in
another order). A x1.01 float32 fault planted at the route's first
launch is caught there alone.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwsnet_tpu.ops.pallas import refine_rows as jrr
from lwsnet_tpu_torch.models import refine_kernels as RK
from lwsnet_tpu_torch.ops.cuda import refine_rows as trr
from lwsnet_tpu_torch.tools import parity_layers as PL
from lwsnet_tpu_torch.tools.parity import tf32_off

F32, BF = torch.float32, torch.bfloat16
TOL = dict(atol=2e-4, rtol=1e-3)
R, TW = 4, 64  # a tile's output rows (d apart) and pixels
SMEM_MAX, MIN_STAGES, MAX_STAGES = 232448, 2, 8


def test_route_rule():
    """float32 x 32 outputs x whole 8-channel slabs x d <= 16 x one or two
    inputs x G <= 2 with resident weights and a ring of more stages than a
    tile has jobs; never bf16, the 3 -> 32 entry or the 32 -> 1 output."""
    route = trr.dense_f32_route
    for ci in (8, 16, 24, 32, 64):
        for nin in (1, 2):
            for g in (1, 2):
                for d in (1, 2, 8, 16):
                    sc = 16 if ci % 16 == 0 else 8
                    want = (ci * nin * g <= 128
                            and _stages(sc, d, ci, nin, g) > 0)
                    assert route(F32, ci, 32, d, nin, g) == want
                    assert not route(BF, ci, 32, d, nin, g)
    assert not route(F32, 3, 32, 1, 1, 2)   # the towers' entry
    assert not route(F32, 1, 32, 1, 1, 1)   # "layers"' 1-channel entry
    assert not route(F32, 32, 1, 1, 1, 1)   # the output conv
    assert not route(F32, 32, 16, 1, 1, 1)
    assert not route(F32, 20, 32, 1, 1, 1)  # not a whole slab of 8
    assert not route(F32, 32, 32, 17, 1, 1)
    assert not route(F32, 32, 32, 1, 1, 3)
    # the shipped float32 "mxu" forward: 8 layers and the head entry on it,
    # the entry writing channels-last for it, no layout copy on any engine
    launches = RK.refine_routes(F32, "mxu", 32)
    assert [L.route for L in launches] == (
        [RK.CUDA_CORES] + [trr.F32] * 9 + [RK.CUDA_CORES])
    assert launches[0].writes_cl and all(L.reads_cl for L in launches[1:10])
    for engine in RK.ENGINE_NAMES:
        assert RK.layout_copies(RK.refine_routes(F32, engine, 32)) == 0
    assert all(L.route != trr.F32 for L in RK.refine_routes(BF, "mxu", 32))


def _row_pixels(d):
    return (TW + 2 * d + 7) // 8 * 8


def _stages(sc, d, ci, nin, g, eb=4, min_stages=MIN_STAGES, n_out=32):
    """`dense_f32::stages` (eb = 4) or `dense_tc::stages` (eb = 2, 4
    stages at least, B images of 16-channel chunks): the ring's stages
    beside the resident weights and affines; 0 where the launch refuses
    the shape, with fewer than `min_stages` or no more than a tile's jobs
    (inputs x slabs of sc channels)."""
    weights = ci * 9 * 32 * 4 if eb == 4 else ci // 16 * 9 * 16 * n_out * 2
    fixed = g * nin * (weights + 2 * ci * 4) + 512
    n = min((SMEM_MAX - fixed - 1024) // ((R + 2) * _row_pixels(d) * sc * eb),
            MAX_STAGES)
    return 0 if n < min_stages or n <= nin * ci // sc else n


def _lap_waits_hold(S, jobs, tiles):
    """The two product groups' waits on the ring, played out: group m % 2
    takes tile m's jobs n = m * jobs .. in turn, and waits on the stage of
    job n (n % S) for its lap n // S by parity. The wait is sound if the
    stage's previous lap (job n - S) was read by the group before, in its
    own earlier jobs or before one of them (the activating warps finish
    jobs in order), so that the parity cannot name a lap still open."""
    for m in range(tiles):
        read = [n for k in range(m % 2, m, 2)
                for n in range(k * jobs, (k + 1) * jobs)]
        for jb in range(jobs):
            n = m * jobs + jb
            if n >= S and max(read, default=-1) < n - S:
                return False
            read.append(n)
    return True


def test_every_shape_of_the_route_fits():
    """Every shape the rule admits gets at least MIN_STAGES stages and more
    stages than a tile has jobs, so that the product groups' waits by
    parity are sound (played out by `_lap_waits_hold`); shapes where the
    ring holds no more are refused (two inputs past d = 8, 64 channels
    past d = 8, 128 channels); the shipped ones get 4 (tower, d = 16) to 7
    (head, d = 1)."""
    admitted = refused = 0
    for ci in range(8, 129, 8):
        sc = 16 if ci % 16 == 0 else 8
        for nin in (1, 2):
            for g in (1, 2):
                for d in range(1, 17):
                    S, jobs = _stages(sc, d, ci, nin, g), nin * ci // sc
                    if trr.dense_f32_route(F32, ci, 32, d, nin, g):
                        assert S >= MIN_STAGES and S > jobs
                        assert _lap_waits_hold(S, jobs, 6)
                        assert trr.ring_stages(4, ci, d, nin, g) == S
                        admitted += 1
                    elif ci * nin * g <= 128:
                        assert S == 0
                        refused += 1
    assert admitted and refused
    for S in range(2, 9):
        for jobs in range(1, 9):
            assert _lap_waits_hold(S, jobs, 6) == (S > jobs)
    for args in ((32, 9, 2, 1), (32, 16, 2, 1), (64, 9, 1, 1),
                 (64, 16, 1, 1), (128, 1, 1, 1), (32, 1, 2, 2)):
        assert not trr.dense_f32_route(F32, args[0], 32, *args[1:])
    assert _stages(16, 16, 32, 1, 2) == 4
    assert _stages(16, 8, 32, 2, 1) == 5
    assert _stages(16, 1, 32, 1, 1) == 7


def test_bf16_ring_holds_more_stages_than_jobs():
    """The bf16 tensor-core route shares the ring and its waits: every
    shape `dense_tensor_core_route` admits (and so every narrow output
    and `chain` layer) has at least 4 stages and more than a tile's jobs;
    64 channels with two inputs and 128 channels past d = 8 are refused;
    the shipped 32-channel layers keep theirs."""
    for ci in range(16, 129, 16):
        sc = 32 if ci % 32 == 0 else 16
        for nin in (1, 2):
            for g in (1, 2):
                for d in range(1, 17):
                    S = _stages(sc, d, ci, nin, g, eb=2, min_stages=4)
                    ok = trr.dense_tensor_core_route(BF, ci, 32, d, nin, g)
                    assert ok == (ci * nin * g <= 128 and S > 0)
                    assert trr.ring_stages(2, ci, d, nin, g) == S
                    if ok:
                        assert S > nin * ci // sc
    for args in ((64, 9, 2, 1), (128, 9, 1, 1), (128, 16, 1, 1)):
        assert not trr.dense_tensor_core_route(BF, args[0], 32, *args[1:])
        assert not trr.dense_output_route(BF, args[0], 1, *args[1:])
    for d in (1, 2, 4, 8, 16):
        assert trr.dense_tensor_core_route(BF, 32, 32, d, 1, 2)
        assert trr.dense_tensor_core_route(BF, 32, 32, d, 2, 1)


def _chunk_offset(sc, p, c):
    """Byte offset of 4-channel chunk c of pixel p in a staged row: TMA's
    64-byte (16 channels) or 32-byte (8) swizzle."""
    cpp = sc // 4
    return p * sc * 4 + ((c ^ ((p // (8 // cpp)) % cpp)) << 4)


@pytest.mark.parametrize("sc", [16, 8])
def test_shared_reads_are_free_of_bank_conflicts(sc):
    """A product's activation load: the eight lanes p of a warp read pixel
    p + kx * d + 8j, chunk c, of one staged row: eight distinct 16-byte
    bank groups at every dilation, tap and chunk, and the chunk's swizzle
    the same for every j (the kernel computes it once a tap). Its weight
    loads: four addresses a warp, 32 bytes apart, distinct bank groups."""
    for d in range(1, 17):
        for kx in range(3):
            q0 = kx * d
            for c in range(sc // 4):
                for j in range(8):
                    groups = {_chunk_offset(sc, q0 + p + 8 * j, c) % 128 // 16
                              for p in range(8)}
                    assert len(groups) == 8
                    assert (_chunk_offset(sc, q0 + 8 * j, c)
                            - _chunk_offset(sc, q0, c)) == 8 * j * sc * 4
    assert len({(32 * q + 16 * h) % 128 // 16 for q in range(4)
                for h in range(2)}) == 8


@pytest.mark.parametrize("sc", [16, 8])
def test_activating_threads_cover_each_chunk_once(sc):
    """`activate_job`: activating thread w of ACTIVATORS (96) keeps chunk
    w % CPP of pixels w // CPP + k * (96 // CPP), k < KP, of each staged
    row: every chunk of the 64 + 2d pixels a row holds exactly once at
    every dilation, and a warp's 32 loads of 16 bytes within four
    128-byte lines."""
    activators, cpp = 96, sc // 4
    pxs = activators // cpp
    kp = -(-(TW + 32) // pxs)
    for d in range(1, 17):
        npx = TW + 2 * d
        seen = [(w // cpp + k * pxs, w % cpp) for w in range(activators)
                for k in range(kp) if w // cpp + k * pxs < npx]
        assert sorted(seen) == [(q, c) for q in range(npx)
                                for c in range(cpp)]
    for k in range(kp):
        for warp in range(activators // 32):
            lines = {_chunk_offset(sc, w // cpp + k * pxs, w % cpp) // 128
                     for w in range(32 * warp, 32 * warp + 32)}
            assert len(lines) <= 32 * 16 // 128


def _tiles(B, H, W, d):
    """(b, c, k, w0) of every tile, in the kernels' order."""
    nk, ncx = math.ceil(math.ceil(H / d) / R), math.ceil(W / TW)
    out = []
    for t in range(B * d * nk * ncx):
        w0, t = t % ncx * TW, t // ncx
        k, t = t % nk, t // nk
        out.append((t // d, t % d, k, w0))
    return out


def emulate(x, wt, *, dilation, affine=None, x2=None, wt2=None,
            affine2=None):
    """The route's arithmetic in the kernel's order, float32: per tile its
    R + 2 staged rows (image rows c + (kR + r - 1)d, columns w0 - d on;
    zeros outside the image, relu(v * a + s) inside), then per input,
    slab, 8-channel group, tap (ky, kx) and channel one multiply-add into
    every output of
    the tile's R rows x 64 pixels x 32 outputs; the rows and columns
    beyond the image masked at the store. x, x2: (B, Ci, H, W); wt, wt2:
    (G, 32, Ci, 3, 3); affine, affine2: (G, 2, Ci). Returns (B, 32, H, W)
    and the number of times each output was written."""
    d = dilation
    B, Ci, H, W = x.shape
    G = wt.shape[0]
    tiles = _tiles(B, H, W, d)
    T, P = len(tiles), _row_pixels(d)
    b_of = torch.tensor([t[0] for t in tiles])
    rows = torch.tensor([[c + (k * R + r - 1) * d for r in range(R + 2)]
                         for _, c, k, _ in tiles])             # (T, R + 2)
    cols = torch.tensor([[w0 - d + q for q in range(P)]
                         for _, _, _, w0 in tiles])            # (T, P)
    inside = (((rows >= 0) & (rows < H))[:, :, None]
              & ((cols >= 0) & (cols < W))[:, None, :])        # (T, R+2, P)
    ri, ci_ = rows.clamp(0, H - 1), cols.clamp(0, W - 1)
    g_of = b_of // (B // G)
    acc = torch.zeros(T, R, TW, 32)
    for xi, wi, ai in ((x, wt, affine), (x2, wt2, affine2)):
        if xi is None:
            continue
        xl = xi.permute(0, 2, 3, 1)                           # channels-last
        staged = xl[b_of[:, None, None], ri[:, :, None], ci_[:, None, :]]
        if ai is not None:
            a, s = ai[g_of, 0][:, None, None], ai[g_of, 1][:, None, None]
            staged = torch.where(inside[..., None],
                                 torch.relu(staged * a + s), staged)
        staged = torch.where(inside[..., None], staged, 0.0)  # TMA's zeros
        wl = trr._relayout(wi)[g_of]                          # (T, Ci, 9, 32)
        for c8 in range(0, Ci, 8):            # slabs, groups of 8 channels
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                win = staged[:, ky:ky + R, kx * d:kx * d + TW]
                for c in range(c8, c8 + 8):
                    acc += win[..., c, None] * wl[:, None, None, c, tap]
    y = torch.zeros(B, 32, H, W)
    written = torch.zeros(B, H, W, dtype=torch.int64)
    for t, (b, c, k, w0) in enumerate(tiles):
        for o in range(R):
            h = c + (k * R + o) * d
            n = min(TW, W - w0)
            if h < H and n > 0:
                y[b, :, h, w0:w0 + n] = acc[t, o, :n].T
                written[b, h, w0:w0 + n] += 1
    return y, written


def _operands(seed, B, G, Ci, H, W, nin, aff):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    def affine():
        return torch.from_numpy(np.stack(
            [rng.uniform(0.5, 1.5, (G, Ci)), rng.normal(0, 0.5, (G, Ci))],
            1).astype(np.float32)) if aff else None

    kw = {}
    x = t(B, Ci, H, W)
    wt = t(G, 32, Ci, 3, 3, scale=(2 / (9 * Ci * nin)) ** 0.5)
    kw["affine"] = affine()
    if nin == 2:
        kw.update(x2=t(B, Ci, H, W),
                  wt2=t(G, 32, Ci, 3, 3, scale=(2 / (18 * Ci)) ** 0.5),
                  affine2=affine())
    return x, wt, kw


# (B, G, Ci, d, H, W, inputs, affine): each dilation of the path, two
# weight groups, the two-input form, one, two and three slabs, planes no
# tile divides (W past one 64-pixel tile, H not a multiple of R x d)
CASES = [(2, 2, 32, 1, 9, 75, 1, True),
         (2, 2, 32, 2, 13, 75, 1, True),
         (1, 1, 32, 8, 11, 70, 2, True),
         (1, 1, 16, 16, 19, 40, 1, False),
         (2, 1, 24, 2, 7, 130, 1, True)]


@pytest.mark.parametrize("case", CASES, ids=[
    f"B{c[0]}-G{c[1]}-C{c[2]}-d{c[3]}-{c[4]}x{c[5]}-in{c[6]}"
    f"{'-aff' if c[7] else ''}" for c in CASES])
def test_emulation_matches_plain_and_jax(case):
    """The emulation, every output written once, against `dense3x3_plain`
    (the wrapper's CPU version) and the JAX Pallas kernel in interpret
    mode (`dense_layer`, grouped; `dense2_layer` for two inputs)."""
    B, G, Ci, d, H, W, nin, aff = case
    x, wt, kw = _operands(sum(case[:6]), B, G, Ci, H, W, nin, aff)
    got, written = emulate(x, wt, dilation=d, **kw)
    assert bool((written == 1).all())
    torch.testing.assert_close(
        got, trr.dense3x3_plain(x, wt, dilation=d, **kw), **TOL)
    S, NR = jrr.canvas_geom(H, W)

    def canvas(t):
        return jrr.to_canvas(jnp.asarray(t.permute(0, 2, 3, 1).numpy()), S,
                             NR, jnp.float32)

    hwio = wt.permute(0, 3, 4, 2, 1).numpy()  # (G, 3, 3, Ci, 32)
    if nin == 1:
        affine = kw["affine"]
        want = jax.jit(functools.partial(
            jrr.dense_layer, dilation=d, S=S, NR=NR, groups=G,
            interpret=True))(
            canvas(x), jnp.asarray(hwio if G > 1 else hwio[0]),
            affine=None if affine is None else jnp.asarray(
                affine.numpy() if G > 1 else affine[0].numpy()))
    else:
        both = np.concatenate([hwio[0], kw["wt2"].permute(
            0, 3, 4, 2, 1).numpy()[0]], 2)          # (3, 3, 2Ci, 32)
        aff2 = torch.cat([kw["affine"][0], kw["affine2"][0]], 1)
        want = jax.jit(functools.partial(
            jrr.dense2_layer, dilation=d, S=S, NR=NR, interpret=True))(
            canvas(torch.cat([x, kw["x2"]], 0)), jnp.asarray(both),
            affine=jnp.asarray(aff2.numpy()))
    want = np.asarray(jrr.from_canvas(want, H, W, S, NR, 32))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_planted_float32_fault_is_caught_at_the_route():
    """A x1.01 error in the weights of the float32 route's first launch
    (`dense-32`, the towers' d = 2 layer under "mxu"), kernel side, in
    float32 on the seed-0 set at 64 x 128: that launch alone misses its
    route's bars (`ROUTE_BARS`, float32 `dense-32`: 2.5, max 3.5)."""
    with tf32_off():
        res = PL.check_plant("dense-32", 64, 128, torch.device("cpu"),
                             log=lambda _: None, dtype="float32")
    at = res["planted_at"]
    planted = [r for r in res["rows"] if r["planted"]]
    assert [r["index"] for r in planted] == [at]
    assert planted[0]["route"] == "dense-32"
    assert planted[0]["mean_ratio"] > PL.bars(F32, "dense-32")[0]
    assert res["missed"] == [at] and res["caught"]
