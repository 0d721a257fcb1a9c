"""The port's training path against the JAX package, on the CPU at float32.

Losses, metrics, the learning-rate schedule, batch norm in training mode,
the He-normal initializer, and the train and stat steps of
`lwsnet_tpu_torch.training` against `lwsnet_tpu.training` on the same
seeded numpy inputs and the same weights (JAX `create_train_state`,
bridged by `convert.from_jax_variables`). Full-width
`ModelConfig(compute_dtype="float32")` at 32x64, batch 4, the geometry of
tests/test_training.py.

Each train step starts both packages from the same state (the port's,
bridged back with `convert.to_jax_variables`), so a step is compared on
its own. The optimizer is checked exactly: a shadow optax state fed the
port's own gradients must land on the port's parameters and Adam moments.
JAX's gradient is read back from its first Adam moment. The network's
float32 gradient moves with the order of summation, most on a first step
from the identity batch-norm statistics. Each bar below sits between the
largest reading of these tests on a sound port and the reading of a
planted fault (the port patched at run time: one stage's loss gradient
1 % off, the whole gradient 1 % off, the batch mean's gradient dropped
in train-mode batch norm, the running variance updated with the unbiased
variance, the warp's gradient to the disparity dropped; PERF.md):
- grad_norm, rtol 2e-3 in batch-statistics mode (sound 9.5e-4 at most
  over the steps below; the whole gradient 1 % off reads 1.0e-2, one
  stage's 2.3e-3) and 1e-2 frozen (sound 6.1e-3, where a 1 % fault is
  lost in the noise); rtol 1e-4 on an unclipped step after a first one
  (sound 1.9e-5; 1.8e-3 for the stage fault);
- the whole gradient's cosine >= 0.9996 (sound 1 - 1.0e-4 at most;
  dropping the warp's gradient reads 1 - 1.4e-3) and each tensor's >=
  0.998 (sound 0.99954 at least; the warp fault 0.989);
- on the unclipped step, |g - g_jax| / |g_jax| <= 5e-4 (sound 1.3e-4; the
  stage fault 1.8e-3), which Adam's update after an unclipped step
  depends on through the gradient's size;
- batch-norm statistics, rtol 1e-4 with atol 1e-5 (sound 0.50 of that
  bar; the unbiased running variance reads 4.5 of it).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from flax import linen as fnn  # noqa: E402

from lwsnet_tpu import LWSNet as JLWSNet  # noqa: E402
from lwsnet_tpu import ModelConfig as JConfig  # noqa: E402
from lwsnet_tpu import TrainConfig as JTrainConfig  # noqa: E402
from lwsnet_tpu.training import losses as jlosses  # noqa: E402
from lwsnet_tpu.training import metrics as jmetrics  # noqa: E402
from lwsnet_tpu.training.state import (TrainState as JState,  # noqa: E402
                                       create_train_state as jcreate,
                                       make_lr_schedule as jschedule,
                                       make_optimizer as joptimizer)
from lwsnet_tpu.training.steps import (make_stat_step as jstat,  # noqa
                                       make_train_step as jtrain)
from lwsnet_tpu_torch import LWSNet, ModelConfig  # noqa: E402
from lwsnet_tpu_torch.config import TrainConfig  # noqa: E402
from lwsnet_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                      to_jax_variables)
from lwsnet_tpu_torch.models import blocks  # noqa: E402
from lwsnet_tpu_torch.training import losses, metrics  # noqa: E402
from lwsnet_tpu_torch.training.state import (create_train_state,  # noqa
                                             make_lr_schedule, param_count)
from lwsnet_tpu_torch.training.steps import (make_stat_step,  # noqa: E402
                                             make_train_step)

H, W, B = 32, 64, 4
CFG = ModelConfig(compute_dtype="float32")
RECIPES = {"pretrain": dict(mask_max_disp=192.0),
           "finetune": dict(mask_min_disp=0.0)}
# The milestone at update 2 (one step an epoch) makes the learning rate of
# an update (indexed by applied updates) differ from aux["lr"] (indexed by
# steps) once a step has been skipped.
STEP_KW = dict(lr=5e-4, mask_max_disp=192.0, lr_milestones=(2,),
               lr_gamma=0.5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers, and
    torch on every core in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, 3)).astype(np.float32),
            rng.standard_normal((B, H, W, 3)).astype(np.float32),
            rng.uniform(1.0, 100.0, (B, H, W)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def jax_init():
    """JAX `create_train_state` of the full-width float32 model."""
    return jcreate(JLWSNet(JConfig(compute_dtype="float32")),
                   JTrainConfig(**STEP_KW), jax.random.PRNGKey(0), (H, W),
                   steps_per_epoch=1)


def _port_state(jstate, kw=STEP_KW):
    st = create_train_state(CFG, TrainConfig(**kw), device="cpu")
    st.model.load_state_dict(from_jax_variables(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}),
        strict=True)
    return st


# -- losses and metrics ------------------------------------------------------

@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_losses_and_metrics_match_jax(recipe):
    rng = np.random.default_rng(3)
    outs = [rng.uniform(-5, 200, (B, H, W, 1)).astype(np.float32)
            for _ in range(4)]
    gt = rng.uniform(-1, 230, (B, H, W)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.3] = 0.0  # sparse KITTI-style GT
    kw = RECIPES[recipe]
    bounds = dict(min_disp=kw.get("mask_min_disp", float("-inf")),
                  max_disp=kw.get("mask_max_disp", float("inf")))
    w = (0.25, 0.5, 1.0, 1.0)
    jt, js = jlosses.staged_loss([jnp.asarray(o) for o in outs],
                                 jnp.asarray(gt), w, **bounds)
    pt, ps = losses.staged_loss(_t(*outs), _t(gt)[0], w, **bounds)
    # atol 1e-6, and rtol 1e-5 for values near 74 whose float32 spacing is
    # 7.6e-6: the two reduce 8192 terms in different orders
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    for fn, jfn in ((metrics.epe, jmetrics.epe),
                    (metrics.d1_error, jmetrics.d1_error)):
        for o in outs[:2]:
            want = float(jfn(jnp.asarray(o), jnp.asarray(gt), 192.0))
            got = float(fn(_t(o)[0], _t(gt)[0], 192.0))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # empty masks: D1 divides by 1e-9, EPE by max(count, 1)
    none = np.full((1, 4, 4), 500.0, np.float32)
    assert float(metrics.d1_error(*_t(none, none))) == 0.0
    assert float(metrics.epe(*_t(none, none))) == 0.0
    meter = metrics.AverageMeter()
    for v in (1.0, 2.0, 6.0):
        meter.update(v)
    assert (meter.val, meter.avg, meter.count) == (6.0, 3.0, 3)


# -- schedule ------------------------------------------------------------------

@pytest.mark.parametrize("kw,spe", [
    (dict(lr=5e-4, lr_milestones=(200, 400), lr_gamma=0.1), 10),
    (dict(lr=5e-4), 10),
    (dict(lr=4e-4, warmup_steps=16), 10),
    (dict(lr=4e-4, warmup_steps=16, lr_milestones=(5,), lr_gamma=0.5), 10),
    (dict(lr=3e-4, warmup_steps=7, lr_milestones=(1, 2, 2), lr_gamma=0.3),
     3)])
def test_lr_schedule_matches_optax(kw, spe):
    want = jschedule(JTrainConfig(**kw), spe)
    got = make_lr_schedule(TrainConfig(**kw), spe)
    for step in (0, 1, 2, 3, 5, 7, 8, 9, 15, 16, 17, 30, 66, 80, 1999, 2000,
                 2016, 3999, 4000, 4016, 10 ** 6):
        assert got(step) == float(want(step)), (kw, step)


# -- batch norm and initialization ----------------------------------------

def test_batchnorm_train_mode_matches_flax():
    """One batch norm in training mode: output, its gradient and the
    running update against Flax nn.BatchNorm(momentum=0.9), float32."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 5, 7, 8)) * 3 + 1).astype(np.float32)
    up = rng.standard_normal((6, 5, 7, 8)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def f(v, x):
        y, mut = bn.apply(v, x, mutable=["batch_stats"])
        return jnp.sum(y * up), (y, mut["batch_stats"])

    (_, (jy, jstats)), (jgv, jgx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables, x)

    m = blocks.BatchNorm(8)
    with torch.no_grad():
        for t, v in ((m.weight, scale), (m.bias, bias),
                     (m.running_mean, mean0), (m.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    m.train()
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))
                          ).requires_grad_()
    y = m(xt)
    (y * torch.from_numpy(np.ascontiguousarray(
        up.transpose(0, 3, 1, 2)))).sum().backward()
    nhwc = lambda t: t.detach().numpy().transpose(0, 2, 3, 1)  # noqa: E731
    np.testing.assert_allclose(nhwc(y), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(m.weight.grad.numpy(),
                               np.asarray(jgv["params"]["scale"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(jstats["mean"]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(),
                               np.asarray(jstats["var"]), rtol=1e-5)
    m.eval()  # eval mode reads the running statistics, which stay
    before = m.running_var.clone()
    m(xt.detach())
    assert torch.equal(m.running_var, before)


def test_init_matches_jax_he_normal():
    """Every conv weight of the port's seeded init is He-normal truncated
    at 2 sigma, as `nn.initializers.he_normal()` draws it: the bound
    holds on the model's own draw, and per layer shape the sample std of
    many draws lies within 3 % of JAX's at the same shape."""
    model = LWSNet(CFG, device="cpu", seed=0)
    he = jax.nn.initializers.he_normal()
    shapes = {}
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, blocks.BatchNorm):
                continue
            fan = blocks.fan_in(module, p)
            bound = 2.0 * np.sqrt(2.0 / fan) / 0.8796
            assert float(p.abs().max()) <= bound, (name, p.shape)
            shapes[(tuple(p.shape), fan)] = p
    gen = torch.Generator().manual_seed(1)
    for i, ((shape, fan), p) in enumerate(sorted(shapes.items())):
        reps = max(1, 200_000 // p.numel())
        port = torch.cat([blocks.he_normal(shape, fan, gen).reshape(-1)
                          for _ in range(reps)]).numpy()
        # (fan_in, outputs) in the Flax layout, the draws side by side
        jshape = (fan, reps * (p.numel() // fan))
        ref = np.asarray(he(jax.random.PRNGKey(i), jshape, jnp.float32))
        assert np.abs(port).max() <= 2.0 * np.sqrt(2.0 / fan) / 0.8796
        assert abs(port.std() / ref.std() - 1.0) < 0.03, (shape, fan)
        assert abs(port.std() / np.sqrt(2.0 / fan) - 1.0) < 0.03


# -- train and stat steps -------------------------------------------------

def _jax_state(st, opt_state):
    """The port's state as a JAX TrainState with the given optax state."""
    var = to_jax_variables(st.model.state_dict())
    return JState(step=jnp.asarray(st.step, jnp.int32),
                  params=var["params"], batch_stats=var["batch_stats"],
                  opt_state=opt_state)


def _named(st, which):
    """Parameters, their `.grad`s or Adam moments by state-dict name."""
    out = {}
    for name, p in st.model.named_parameters():
        if which == "param":
            out[name] = p.detach()
        elif which == "grad":
            out[name] = p.grad
        else:
            out[name] = st.optimizer.state[p][which]
    return out


def _tree(named):
    return to_jax_variables(named)["params"]


def _stats(st):
    return {k: v.clone() for k, v in st.model.named_buffers()}


def _grad_cosines(port, ref, floor):
    """The whole gradient's cosine and the least per-tensor cosine over
    tensors above `floor` (float64)."""
    names = [n for n in port if float(ref[n].norm()) > floor]
    a, b = (torch.cat([g[n].double().reshape(-1) for n in names])
            for g in (port, ref))
    per = min(float((port[n].double() * ref[n].double()).sum()
                    / (port[n].double().norm() * ref[n].double().norm()))
              for n in names)
    return float((a * b).sum() / (a.norm() * b.norm())), per


class _Steps:
    """The port's state beside a shadow optax state fed the port's own
    gradients; `run` takes one step of each package from the port's
    state and holds them to each other."""

    def __init__(self, jax_init, bn_mode, grad_clip_norm=5.0):
        kw = dict(STEP_KW, bn_mode=bn_mode, grad_clip_norm=grad_clip_norm)
        jcfg, self.cfg = JTrainConfig(**kw), TrainConfig(**kw)
        self.jstep = jtrain(JLWSNet(JConfig(compute_dtype="float32")), jcfg,
                            1, donate=False)
        self.tx = joptimizer(jcfg, 1)
        self.st = _port_state(jax_init, kw)
        self.step = make_train_step(self.cfg, 1)
        self.shadow = (jax_init.params, jax_init.opt_state)

    def run(self, l, r, g, grad_norm_rtol=2e-3, grad_rtol=None):
        """One step of each; `grad_rtol`, where given, bounds the port's
        gradient's distance from JAX's relative to JAX's norm (a step that
        is not clipped)."""
        st, cfg = self.st, self.cfg
        jin = _jax_state(st, self.shadow[1])
        jout, jaux = self.jstep(jin, l, r, g)
        jax.block_until_ready(jout)
        params0, stats0 = _named(st, "param"), _stats(st)
        moments0 = ({n: t.clone() for n, t in _named(st, "exp_avg").items()}
                    if st.updates else {})
        st, aux = self.step(st, *_t(l, r, g))

        assert aux["finite"] == float(jaux["finite"])
        assert aux["lr"] == float(jaux["lr"])
        stats = _stats(st)
        if not aux["finite"]:  # nothing moves but the step count
            for n, p in _named(st, "param").items():
                assert torch.equal(p, params0[n]), n
            for n, t in (_named(st, "exp_avg") if moments0 else {}).items():
                assert torch.equal(t, moments0[n]), n
            for n, t in stats.items():
                assert torch.equal(t, stats0[n]), n
            return aux
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(aux["stage_losses"].numpy(),
                                   np.asarray(jaux["stage_losses"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(aux["grad_norm"]),
                                   float(jaux["grad_norm"]),
                                   rtol=grad_norm_rtol)
        clipped = float(aux["grad_norm"]) > cfg.grad_clip_norm
        assert clipped == (grad_rtol is None)
        want = from_jax_variables({"params": {},
                                   "batch_stats": jout.batch_stats})
        for n, t in stats.items():
            if cfg.bn_mode == "frozen":
                assert torch.equal(t, stats0[n]), n
            np.testing.assert_allclose(t.numpy(), want[n].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=n)
        # JAX's clipped gradient from its first moment: mu' = 0.9 mu + 0.1 g
        mu0, mu1 = (from_jax_variables({"params": s.opt_state[1][0].mu,
                                        "batch_stats": {}})
                    for s in (jin, jout))
        ref = {n: (mu1[n].double() - 0.9 * mu0[n].double()) / 0.1
               for n in mu1}
        whole, least = _grad_cosines(_named(st, "grad"), ref, 1e-6 * min(
            cfg.grad_clip_norm, float(aux["grad_norm"])))
        assert whole >= 0.9996 and least >= 0.998, (whole, least)
        if grad_rtol is not None:
            a, b = (torch.cat([d[n].double().reshape(-1) for n in ref])
                    for d in (_named(st, "grad"), ref))
            err = float((a - b).norm() / b.norm())
            assert err <= grad_rtol, err

        # the shadow optax state takes the port's gradient before the clip
        scale = max(1.0, float(aux["grad_norm"]) / cfg.grad_clip_norm)
        grads = _tree({n: t * scale for n, t in _named(st, "grad").items()})
        updates, opt = self.tx.update(grads, self.shadow[1], self.shadow[0])
        self.shadow = (optax.apply_updates(self.shadow[0], updates), opt)
        # moments: rtol 1e-4, as the clip scales by two float32 global
        # norms of 178k terms summed in different orders
        atol = {"param": 1e-5, "exp_avg": 1e-7, "exp_avg_sq": 1e-10}
        for which, tree in (("param", self.shadow[0]),
                            ("exp_avg", opt[1][0].mu),
                            ("exp_avg_sq", opt[1][0].nu)):
            want = from_jax_variables({"params": tree, "batch_stats": {}})
            for n, t in _named(st, which).items():
                np.testing.assert_allclose(
                    t.numpy(), want[n].numpy(), atol=atol[which],
                    rtol=1e-5 if which == "param" else 1e-4,
                    err_msg=f"{which} {n}")
        assert int(opt[1][0].count) == st.updates
        return aux


@pytest.mark.parametrize("bn_mode", ["batch", "frozen"])
def test_train_step_matches_jax(jax_init, bn_mode):
    """The first step from JAX's `create_train_state`: loss, stage losses,
    lr, the gradient (JAX's recovered from its Adam moment: the whole
    gradient's cosine >= 0.9996, each tensor's >= 0.998), grad_norm
    (rtol 2e-3 with batch statistics, 1e-2 frozen) and the batch-norm
    statistics against JAX's step; the parameters and Adam moments
    against optax fed the port's gradient."""
    steps = _Steps(jax_init, bn_mode)
    steps.run(*_batch(0), grad_norm_rtol=2e-3 if bn_mode == "batch"
              else 1e-2)
    assert steps.st.step == steps.st.updates == 1


def test_unclipped_step_matches_jax(jax_init):
    """With the clip out of reach (grad_clip_norm 1e6): a first step, then
    one on another batch whose gradient must match JAX's in size and
    direction, |g - g_jax| <= 5e-4 |g_jax|, with grad_norm at rtol 1e-4.
    Adam's second update weighs the two gradients by their sizes, so the
    parameters and moments (against optax fed the port's gradients)
    depend on them."""
    steps = _Steps(jax_init, "batch", grad_clip_norm=1e6)
    steps.run(*_batch(0), grad_rtol=1e-2)
    steps.run(*_batch(2), grad_norm_rtol=1e-4, grad_rtol=5e-4)
    assert steps.st.step == steps.st.updates == 2


def test_further_steps_match_jax(jax_init):
    """After a first step: a non-finite one (nothing moves but the step
    count, and the update count that indexes the schedule stays), a
    clipped one, whose update still takes lr(1) while aux reports lr(2)
    from the step count, and the step after, each from the same state in
    both packages and held as the first. Batch-statistics mode: with its
    identity running statistics the frozen network's float32 gradient
    norm already moves 6.1e-3 from JAX's at the first step, ten times the
    batch-mode one."""
    steps = _Steps(jax_init, "batch")
    l0, r0, g0 = _batch(0)
    bad = l0.copy()
    bad[0, 0, 0, 0] = np.nan
    l2, r2, g2 = _batch(2)
    steps.run(l0, r0, g0)
    aux = steps.run(bad, r0, g0)
    assert aux["finite"] == 0.0 and (steps.st.step, steps.st.updates) == (2, 1)
    aux = steps.run(l2, r2, g2 * 3.0)
    assert aux["lr"] == float(np.float32(2.5e-4)) and steps.st.updates == 2
    steps.run(l0, r0, g0)
    assert (steps.st.step, steps.st.updates) == (4, 3)


def test_stat_step_matches_jax(jax_init):
    """One forward in batch-statistics mode: the running statistics
    against `make_stat_step`, the parameters untouched."""
    st = _port_state(jax_init)
    params0 = {n: p.clone() for n, p in _named(st, "param").items()}
    l, r, _ = _batch(5)
    jout = jax.jit(jstat(JLWSNet(JConfig(compute_dtype="float32"))))(
        jax_init, l, r)
    st = make_stat_step()(st, *_t(l, r))
    want = from_jax_variables({"params": {}, "batch_stats": jout.batch_stats})
    for n, t in st.model.named_buffers():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    for n, p in _named(st, "param").items():
        assert torch.equal(p, params0[n]), n
    assert not st.model.training
    assert param_count(st) == sum(
        int(x.size) for x in jax.tree.leaves(jax_init.params))


def test_train_step_rejects_unknown_bn_mode():
    with pytest.raises(ValueError, match="bn_mode"):
        make_train_step(TrainConfig(bn_mode="sync"), 1)


def test_bf16_train_steps_have_finite_gradients():
    """bf16 steps of the full-width model on the CPU stay finite. oneDNN's
    bf16 depthwise weight gradient from channels-last input returned
    garbage of order 1e33 (torch 2.13), which the dw-sep blocks now avoid
    by handing the depthwise conv NCHW input."""
    st = create_train_state(ModelConfig(), TrainConfig(mask_max_disp=192.0),
                            device="cpu")
    step = make_train_step(TrainConfig(mask_max_disp=192.0), 1)
    for seed in range(2):
        st, aux = step(st, *_t(*(a[:2] for a in _batch(seed))))
        assert aux["finite"] == 1.0, seed
        assert float(aux["grad_norm"]) < 1e4, float(aux["grad_norm"])
