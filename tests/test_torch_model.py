"""The port's model modules and weight bridge against the JAX package.

JAX variables (random init, batch norms jittered so every fold is
exercised) go through `lwsnet_tpu_torch.convert.from_jax_variables` into
the port; both packages get the same seeded numpy inputs. float32 on the
CPU, where TF32 does not arise.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lwsnet_tpu import LWSNet as JLWSNet  # noqa: E402
from lwsnet_tpu import ModelConfig as JConfig  # noqa: E402
from lwsnet_tpu.convert import paddle_to_flax  # noqa: E402
from lwsnet_tpu.models.feature import FeatureExtractor as JFeature  # noqa
from lwsnet_tpu.models.refinement import (RefinementHead as JHead,  # noqa
                                          RefinementTower as JTower)
from lwsnet_tpu.models.blocks import CostFilter3D as JCostFilter  # noqa
from lwsnet_tpu_torch import LWSNet, ModelConfig  # noqa: E402
from lwsnet_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                      load_reference_checkpoint,
                                      to_jax_variables)

H, W = 64, 96


def jitter(variables, rng):
    """Random BN scale/bias/mean/var across the whole tree (numpy)."""
    def walk(tree, bn):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k.startswith("BatchNorm_"))
                continue
            v = np.asarray(v, np.float32)
            if bn and k in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif bn and k in ("bias", "mean"):
                v = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            out[k] = v
        return out
    return {g: walk(variables[g], False) for g in ("params", "batch_stats")}


def _images(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, H, W, 3)).astype(np.float32),
            rng.standard_normal((1, H, W, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def setup():
    """JAX variables drawn through the port (seeded He-normal weights,
    jittered batch norms) and loaded into a port model; the JAX tree's
    structure is checked against `LWSNet.init` in the round-trip test."""
    left, right = _images(0)
    model = LWSNet(ModelConfig(compute_dtype="float32"), device="cpu")
    variables = jitter(to_jax_variables(model.state_dict()),
                       np.random.default_rng(1))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return JLWSNet(JConfig(compute_dtype="float32")), variables, model, \
        left, right


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"].get(name, {})}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1,
                                                                  2))))


def _close(got_nchw, want_nhwc, atol=1e-4, rtol=1e-4):
    got = got_nchw.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want_nhwc), atol=atol,
                               rtol=rtol)


def test_bridge_round_trip(setup):
    """Every leaf of the JAX tree maps to one port entry and back."""
    jmodel, variables, model, left, right = setup
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                              jnp.asarray(left), jnp.asarray(right))
    flat_shapes = jax.tree_util.tree_flatten_with_path(abstract)[0]
    flat_a = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    assert {p for p, _ in flat_shapes} == set(flat_a)
    for path, leaf in flat_shapes:
        assert flat_a[path].shape == leaf.shape, path
    sd = from_jax_variables(variables)
    assert len(sd) == len(flat_a) == len(model.state_dict())
    flat_b = dict(jax.tree_util.tree_flatten_with_path(
        to_jax_variables(sd))[0])
    assert flat_b.keys() == flat_a.keys()
    for path, leaf in flat_a.items():
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_bridge_rejects_unknown_keys(setup):
    _, variables, model, _, _ = setup
    bad = jitter(variables, np.random.default_rng(0))
    bad["params"]["CostFilter3D_0"]["BNReLUConv3D_0"]["rogue"] = \
        np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unknown JAX leaf"):
        from_jax_variables(bad)
    sd = from_jax_variables(variables)
    sd["RefinementHead_0.rogue"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict(sd, strict=True)
    with pytest.raises(ValueError, match="unknown port key"):
        to_jax_variables({"FeatureExtractor_0.Conv_0.rogue": torch.zeros(1)})


def test_feature_extractor(setup):
    _, variables, model, left, right = setup
    both = np.concatenate([left, right])
    want = JFeature(8, dtype=jnp.float32).apply(
        _sub(variables, "FeatureExtractor_0"), jnp.asarray(both), False)
    with torch.no_grad():
        got = model.FeatureExtractor_0(_nchw(both))
    assert len(got) == 3
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("scale", [0, 1, 2])
def test_cost_filter(setup, scale):
    _, variables, model, _, _ = setup
    D = (24, 9, 9)[scale]
    channels = (32, 8, 8)[scale]
    cost = (np.random.default_rng(scale).standard_normal(
        (1, 8 * 2 ** scale, 12 * 2 ** scale, D)) * 2).astype(np.float32)
    want = JCostFilter(4, channels, dtype=jnp.float32).apply(
        _sub(variables, f"CostFilter3D_{scale}"), jnp.asarray(cost), False)
    with torch.no_grad():
        got = getattr(model, f"CostFilter3D_{scale}")(torch.from_numpy(cost))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("tower,ci", [(0, 3), (1, 1)])
def test_refinement_tower(setup, tower, ci):
    _, variables, model, _, _ = setup
    x = np.random.default_rng(10 + tower).standard_normal(
        (1, H, W, ci)).astype(np.float32)
    want = JTower(32, dtype=jnp.float32).apply(
        _sub(variables, f"RefinementTower_{tower}"), jnp.asarray(x), False)
    with torch.no_grad():
        got = getattr(model, f"RefinementTower_{tower}")(_nchw(x))
    _close(got, want)


def test_refinement_head(setup):
    _, variables, model, _, _ = setup
    x = np.random.default_rng(12).standard_normal(
        (1, H, W, 64)).astype(np.float32)
    want = JHead(32, dtype=jnp.float32).apply(
        _sub(variables, "RefinementHead_0"), jnp.asarray(x), False)
    with torch.no_grad():
        got = model.RefinementHead_0(_nchw(x))
    _close(got, want, atol=1e-4 * (1 + np.abs(np.asarray(want)).max()))


def _span_check(got, want):
    """The whole-model bar of tests/test_reference_parity.py: max |delta|
    below 2e-3 x (max |reference| + 1), per stage."""
    assert len(got) == len(want)
    for s, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, s
        span = np.abs(w).max() + 1.0
        err = np.abs(g - w).max()
        assert err < 2e-3 * span, f"stage {s + 1}: {err:.3g} vs {span:.3g}"


def test_lwsnet_module_path(setup):
    jmodel, variables, model, left, right = setup
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        variables, jnp.asarray(left), jnp.asarray(right))
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right))
    _span_check(got, want)


def test_pdparams_path(tmp_path):
    """A Paddle-style state dict loads through the port's own reader and
    name map into the same state dict as the JAX converter + bridge, and
    the port then reproduces the reference oracle."""
    from test_reference_parity import _randomized_oracle
    from torch_oracle import to_paddle_state_dict

    oracle = _randomized_oracle()
    sd = to_paddle_state_dict(oracle)
    path = str(tmp_path / "model.pdparams")
    with open(path, "wb") as f:
        pickle.dump(sd, f, protocol=2)
    got_sd = load_reference_checkpoint(path)
    want_sd = from_jax_variables(paddle_to_flax(sd))
    assert got_sd.keys() == want_sd.keys()
    for k in got_sd:
        torch.testing.assert_close(got_sd[k], want_sd[k], rtol=0, atol=0)

    model = LWSNet(ModelConfig(compute_dtype="float32"), device="cpu")
    model.load_state_dict(got_sd, strict=True)
    left, right = _images(5)
    with torch.no_grad():
        want = oracle(_nchw(left), _nchw(right))
        got = model(torch.from_numpy(left), torch.from_numpy(right))
    _span_check(got, [w.permute(0, 2, 3, 1).numpy() for w in want])
