"""The bf16 composed-kernel routes at 20 channels against JAX's own kernels.

At `refine_channels` 20 the "mxu" and "chain" engines compose each dw-sep
layer into one dense 3x3 kernel, k[co, ci] = dw[ci] * pw[co, ci], formed
in float32 and rounded once to bf16 (`refine_kernels._compose_dwsep`),
where the module path rounds the depthwise output instead. With 20 input
channels a sum averages the weights' rounding over 180 products, and a
launch's mean |delta| from float64 can exceed MEAN_RATIO (1.1) x the
module layer's on some weight draws. JAX's own kernel path composes the
same way (`lwsnet_tpu/models/refine_pallas.py::_compose_dwsep`, cast once
inside `dense_layer` / `chain_layer`) and rounds the folded BN affine to
bf16 too. Here each launch of the port's forward (the kernels' plain
versions, 64x128, the seed-0 input pair) is recorded by
`tools.parity_layers`, and JAX's `dense_layer` ("mxu", reaching
`_dense_kernel`) or `chain_layer` ("chain", reaching `_chain_kernel`) runs
in interpret mode on the same bf16 input with the same network's weights
(`convert.to_jax_variables`). Both are held against the same module layer
and float64 truth.

Draws: sixteen seed-0-like networks, seeds 0-7 with batch norms jittered
from default_rng(3) and (5) (seeds 0-3 are the eight draws of
`test_torch_parity_layers.py::test_filter_bars_hold_over_weight_draws`).
Readings (torch 2.13, jax 0.9, CPU, one thread), mean |delta| from float64
over the module layer's:

  route            port max (draw)     JAX kernel max (draw)   port > 1.1
  dense-20         1.046 (s3 j5)       1.521 (s6 j5)           none
  chain-tower-20   1.273 (s6 j5)       1.412 (s7 j5)           3 draws
  chain-head-20    1.221 (s5 j3)       1.462 (s0 j5)           2 draws

Where the port misses 1.1 (seed 4 j3 tower 1.101, JAX 1.256; seed 6 j5
tower 1.273, JAX 1.293; seed 7 j5 tower 1.109, JAX 1.412; seed 5 j3 head
1.221, JAX 1.146; seed 7 j5 head 1.143, JAX 1.188) JAX's kernel misses it
too, and the port lies at most 1.066 x JAX's distance from float64 (seed 5
j3 head). So the excess is the composition's known rounding, not a fault
of the port; `ROUTE_BARS` keeps 1.1 and the card's phase 14 runs the
seed-0 draw. A planted x1.01 weight fault in the port's first chain-tower
launch reads 5.73 x the module layer and 4.43 x JAX's kernel distance,
so the bars below see a fault of that size. The file takes about 30 s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwsnet_tpu.models import refine_pallas as RP
from lwsnet_tpu.ops.pallas import refine_rows as jrr
from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward
from lwsnet_tpu_torch.convert import to_jax_variables
from lwsnet_tpu_torch.tools import parity_layers as PL
from lwsnet_tpu_torch.tools.parity import KERNEL_RATIO, tf32_off

CPU = torch.device("cpu")
H, W, C = 64, 128, 20
DRAWS = [(seed, jitter) for seed in range(8) for jitter in (3, 5)]
ROUTES = ("dense-20", "chain-tower-20", "chain-head-20")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Kept(PL.Recorder):
    """A Recorder that keeps each held launch's input, output and
    references."""

    def check(self, i, launch, args, out, planted):
        row = super().check(i, launch, args, out, planted)
        with torch.inference_mode():
            row.update(x=args[0], out=out,
                       module=launch.ref(self.model, lambda t: t, args),
                       truth=launch.ref(self.truth, lambda t: t.double(),
                                        args))
        return row


@functools.lru_cache(None)
def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, interpret=True, **kw))


def _canvas(x):
    """A launch's (B, C, H, W) bf16 input as the JAX row canvas."""
    S, NR = jrr.canvas_geom(H, W, unit=96)
    nhwc = jnp.asarray(x.permute(0, 2, 3, 1).float().numpy())
    return jrr.to_canvas(nhwc.astype(jnp.bfloat16), S, NR, jnp.bfloat16), S, NR


def _back(y, S, NR, channels):
    return torch.from_numpy(np.array(jrr.from_canvas(
        y, H, W, S, NR, channels).astype(jnp.float32)).transpose(0, 3, 1, 2))


def _jax_launches(model, engine):
    """{stage-4 launch index: JAX's kernel on that launch's input}, for
    the composed dw-sep launches of `engine`, with JAX's own weights as
    its `_rows_mode` forms them (composed in float32)."""
    v = to_jax_variables(model.state_dict())
    p, s, f32 = v["params"], v["batch_stats"], jnp.float32
    el, al, kl, pl_ = RP._tower_weights(p["RefinementTower_0"],
                                        s["RefinementTower_0"], f32)
    ed, ad, kd, pd_ = RP._tower_weights(p["RefinementTower_1"],
                                        s["RefinementTower_1"], f32)
    aff0, dense, affs, dwks, pwks, out_k = RP._head_weights(
        p["RefinementHead_0"], s["RefinementHead_0"], f32)
    tower_k = [jnp.stack([RP._compose_dwsep(kl[i], pl_[i]),
                          RP._compose_dwsep(kd[i], pd_[i])])
               for i in range(len(RP.TOWER_DILATIONS))]
    tower_a = [jnp.stack([al[i], ad[i]])
               for i in range(len(RP.TOWER_DILATIONS))]
    head_k = [RP._compose_dwsep(dwks[i], pwks[i])
              for i in range(len(RP.HEAD_DILATIONS))]

    def dense_layer(kernel, affine, d, groups):
        def run(x):
            y, S, NR = _canvas(x)
            return _back(_jit(jrr.dense_layer, dilation=d, S=S, NR=NR,
                              groups=groups)(y, kernel, affine=affine),
                         S, NR, C)
        return run

    if engine == "mxu":  # launch 0: the entry, 5: the head entry
        out = {1 + i: dense_layer(tower_k[i], tower_a[i], d, 2)
               for i, d in enumerate(RP.TOWER_DILATIONS)}
        out.update({6 + i: dense_layer(head_k[i], affs[i], d, 1)
                    for i, d in enumerate(RP.HEAD_DILATIONS)})
        return out
    entries = jnp.stack([el, jnp.pad(ed, ((0, 0), (0, 0), (0, 2), (0, 0)))])

    def tower(x):
        y, S, NR = _canvas(x)
        return _back(_jit(jrr.chain_layer,
                          dilations=(1,) + RP.TOWER_DILATIONS, S=S, NR=NR,
                          groups=2)(y, [entries] + tower_k,
                                    [None] + tower_a), S, NR, C)

    def head(x):
        y, S, NR = _canvas(x)
        return _back(_jit(jrr.chain_layer,
                          dilations=(RP.HEAD_DENSE_DILATION,)
                          + RP.HEAD_DILATIONS + (1,), S=S, NR=NR,
                          two_input=True, out_dtype=jnp.float32)(
            y, [dense] + head_k + [out_k], [aff0] + list(affs) + [None]),
            S, NR, 1)
    return {0: tower, 1: head}


def _readings(engine, seed, jitter, plant=None):
    """Each composed launch of `engine` on one draw: the port's and JAX's
    kernel distances from float64, as PL.distances gives them."""
    model = LWSNet(ModelConfig(compute_dtype="bfloat16", refine_channels=C,
                               **PL.ENGINES[engine]), device=CPU, seed=seed)
    PL.jitter_batchnorm(model, np.random.default_rng(jitter))
    left, right = PL.set_pair("seed0", H, W, CPU)
    plan = PL.filter_plan(model.cfg) + PL.refine_plan(model.cfg, engine, H, W)
    rec = _Kept(model, PL.float64_copy(model), plan,
                lambda L: L.fn not in PL.FILTER_FNS, plant=plant,
                log=lambda _: None)
    with tf32_off(), PL.recording(rec), torch.inference_mode():
        make_forward(model, use_pallas=True, device=CPU)(left, right)
    out = []
    for k, fn in _jax_launches(model, engine).items():
        row = rec.rows[k]
        jax_out = fn(row["x"])
        jax_row = PL.distances(jax_out, row["module"], row["truth"])
        out.append(dict(route=row["route"], draw=(seed, jitter),
                        where=row["where"], planted=row["planted"],
                        port=row["mean_ratio"], jax=jax_row["mean_ratio"],
                        port_mean=row["kernel_mean"],
                        jax_mean=jax_row["kernel_mean"]))
    return out


@pytest.fixture(scope="module")
def readings():
    rows = [r for engine in ("mxu", "chain") for seed, jitter in DRAWS
            for r in _readings(engine, seed, jitter)]
    for r in rows:
        print(f"{r['route']:15s} s{r['draw'][0]} j{r['draw'][1]} "
              f"{r['where']:20s} port {r['port']:.3f} jax {r['jax']:.3f} "
              f"port/jax {r['port_mean'] / r['jax_mean']:.3f}")
    return rows


def test_every_composed_launch_is_read(readings):
    """Eight "mxu" dw-sep launches and the two chain stacks a draw."""
    assert [r["route"] for r in readings].count("dense-20") == 8 * len(DRAWS)
    for route in ROUTES[1:]:
        assert [r["route"] for r in readings].count(route) == len(DRAWS)


def test_jax_kernel_path_misses_the_bar_at_20_channels(readings):
    """JAX's own composed kernels read over MEAN_RATIO on some draws of
    every route: the bar's miss is the composition's rounding."""
    for route in ROUTES:
        worst = max(r["jax"] for r in readings if r["route"] == route)
        assert worst > PL.MEAN_RATIO, (route, worst)


def test_port_misses_only_where_jax_kernel_misses(readings):
    """Wherever the port's launch reads over MEAN_RATIO, JAX's kernel on
    the same input reads over it too, and the port lies within
    KERNEL_RATIO of JAX's distance from float64; over the draws each
    route's worst port reading lies within KERNEL_RATIO of JAX's worst."""
    for r in readings:
        if r["port"] > PL.MEAN_RATIO:
            assert r["jax"] > PL.MEAN_RATIO, r
            assert r["port_mean"] <= KERNEL_RATIO * r["jax_mean"], r
    for route in ROUTES:
        port = max(r["port"] for r in readings if r["route"] == route)
        jax_worst = max(r["jax"] for r in readings if r["route"] == route)
        assert port <= KERNEL_RATIO * jax_worst, (route, port, jax_worst)


def test_planted_fault_is_far_from_jax_kernel():
    """A x1.01 fault in the port's first chain-tower launch (seed 6,
    jitter 5, the port's worst sound draw) misses both bars above."""
    row = next(r for r in _readings("chain", 6, 5, plant="chain-tower-20")
               if r["planted"])
    print("planted", row)
    assert row["port"] > PL.MEAN_RATIO and row["jax"] <= row["port"]
    assert row["port_mean"] > KERNEL_RATIO * row["jax_mean"], row
