"""The port on trained weights: the committed Orbax checkpoint
`artifacts/overfit_ckpt_kitti`, restored through the JAX package's
`CheckpointManager` and bridged with `convert.from_jax_variables`.

The stage-4 kernel path of every refinement engine and the whole 4-stage
kernel forward are held against the JAX package at 48x96 in float32 on
the CPU, where each kernel wrapper runs its plain version. The checkpoint
is only read.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwsnet_tpu import LWSNet as JLWSNet
from lwsnet_tpu import ModelConfig as JConfig
from lwsnet_tpu import TrainConfig
from lwsnet_tpu.models import refine_pallas
from lwsnet_tpu.training.checkpoint import CheckpointManager
from lwsnet_tpu.training.state import create_train_state
from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward
from lwsnet_tpu_torch.convert import from_jax_variables
from lwsnet_tpu_torch.models.refine_kernels import refine_residual

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "overfit_ckpt_kitti")
H, W = 48, 96


@pytest.fixture(scope="module")
def trained():
    """(JAX variables, the port's state dict) of the trained checkpoint."""
    state = create_train_state(JLWSNet(JConfig()), TrainConfig(),
                               jax.random.PRNGKey(0), (64, 128))
    restored, _ = CheckpointManager(CKPT).restore(state)
    assert restored is not None, CKPT
    variables = jax.tree_util.tree_map(
        lambda v: np.array(v, np.float32),
        {"params": restored.params, "batch_stats": restored.batch_stats})
    return variables, from_jax_variables(variables)


def _port(state_dict, **cfg):
    model = LWSNet(ModelConfig(compute_dtype="float32", **cfg),
                   device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.mark.parametrize("dw,paired", [("mxu", True), ("vpu", True),
                                       ("vpu", False), ("chain", True)])
def test_trained_refine_residual(trained, dw, paired):
    variables, sd = trained
    rng = np.random.default_rng(21)
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    disp = rng.uniform(0, 20, (1, H, W, 1)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        refine_pallas.refine_residual, dtype=jnp.float32, interpret=True,
        mode="rows", dw=dw, paired=paired))(variables, jnp.asarray(left),
                                            jnp.asarray(disp)))
    model = _port(sd, rows_dw=dw, rows_paired=paired)
    with torch.no_grad():
        got = refine_residual(model, torch.from_numpy(left),
                              torch.from_numpy(disp)).numpy()
    span = np.abs(want).max() + 1.0
    assert np.abs(got - want).max() < 1e-4 * span


def test_trained_forward(trained):
    """The 4-stage kernel forward against `LWSNet.apply`; the bar of
    `_span_check` in tests/test_torch_model.py."""
    variables, sd = trained
    rng = np.random.default_rng(22)
    left, right = (rng.standard_normal((1, H, W, 3)).astype(np.float32)
                   for _ in range(2))
    jmodel = JLWSNet(JConfig(compute_dtype="float32"))
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        variables, jnp.asarray(left), jnp.asarray(right))
    got = make_forward(_port(sd), use_pallas=True, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    assert len(got) == len(want) == 4
    for s, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (1, H, W, 1), s
        span = np.abs(w).max() + 1.0
        assert np.abs(g - w).max() < 2e-3 * span, s
