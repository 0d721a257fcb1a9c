"""The JAX reference the port is held to at the shipped geometry.

Runs the JAX package's float32 module path (`LWSNet.apply`,
`train=False`, matmul precision "highest") at 368x1232, batch 1, on three
sets (a weight set on an input pair), and writes what the card (which has
no JAX) reads:

  tests/torch_fixtures/parity_368x1232.npz   every stage's output at every
                                             STRIDE-th row and column, per
                                             set, with the seeds and stride
  tests/torch_fixtures/parity_weights.pt     both weight sets as the port's
                                             state dicts ({"random",
                                             "trained"})

The sets: "random", the port's seed-0 `LWSNet(ModelConfig(compute_dtype=
"float32"))` bridged by `convert.to_jax_variables`, on
`tools.parity.random_pair(0)` (standard normal); "trained", the committed
Orbax checkpoint `artifacts/overfit_ckpt_kitti` through
`convert.from_jax_variables`, on `tools.parity.fixture_pair(0)`;
"trained_wide", the same weights on `tools.parity.wide_pair(0)`, whose
stages span their bins (`tools.parity.GUARDED`). Each set's weights are
`tools.parity.WEIGHTS_OF[set]`.

    python tests/torch_parity_fixture.py

needs JAX, so it runs where the CPU tests run, never on the card.
`tests/test_torch_parity.py` regenerates the outputs and holds the
committed file to them.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from lwsnet_tpu_torch.tools import parity  # noqa: E402

CKPT = os.path.join(REPO, "artifacts", "overfit_ckpt_kitti")
OUT_DIR = os.path.join(REPO, "tests", "torch_fixtures")
NPZ = os.path.join(OUT_DIR, "parity_368x1232.npz")
WEIGHTS = os.path.join(OUT_DIR, parity.WEIGHTS)
STRIDE = 4
SEED = 0


def trained_state_dict():
    """The Orbax checkpoint restored by the JAX package, as the port's
    state dict."""
    from lwsnet_tpu import LWSNet, ModelConfig, TrainConfig
    from lwsnet_tpu.training.checkpoint import CheckpointManager
    from lwsnet_tpu.training.state import create_train_state
    from lwsnet_tpu_torch.convert import from_jax_variables

    state = create_train_state(LWSNet(ModelConfig()), TrainConfig(),
                               jax.random.PRNGKey(0), (64, 128))
    restored, _ = CheckpointManager(CKPT).restore(state)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {CKPT}")
    return from_jax_variables(jax.tree_util.tree_map(
        lambda v: np.array(v, np.float32),
        {"params": restored.params, "batch_stats": restored.batch_stats}))


def random_state_dict():
    """The port's seed-0 float32 network."""
    from lwsnet_tpu_torch import LWSNet, ModelConfig

    return LWSNet(ModelConfig(compute_dtype="float32"), device="cpu",
                  seed=SEED).state_dict()


def jax_stages(state_dict, left: np.ndarray, right: np.ndarray):
    """The JAX float32 module path's four (H, W) stage outputs for one
    (H, W, 3) pair, on the port's state dict bridged to JAX."""
    import jax.numpy as jnp

    from lwsnet_tpu import LWSNet, ModelConfig
    from lwsnet_tpu_torch.convert import to_jax_variables

    model = LWSNet(ModelConfig(compute_dtype="float32"))
    with jax.default_matmul_precision("highest"):
        outs = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False))(
            to_jax_variables(state_dict), jnp.asarray(left[None]),
            jnp.asarray(right[None]))
        return [np.asarray(o[0, :, :, 0], np.float32) for o in outs]


def build(weights=None):
    """({weight set: state dict}, {npz key: array}) of the fixture;
    `weights` ({weight set: state dict}) in place of the sets' own."""
    weights = weights or {"random": random_state_dict(),
                          "trained": trained_state_dict()}
    arrays = {"stride": np.int64(STRIDE),
              "random_weight_seed": np.int64(SEED)}
    for name in parity.SETS:
        arrays[f"{name}_input_seed"] = np.int64(SEED)
        for s, out in enumerate(jax_stages(weights[parity.WEIGHTS_OF[name]],
                                           *parity.set_pair(name, SEED))):
            arrays[f"{name}_stage{s + 1}"] = np.ascontiguousarray(
                out[::STRIDE, ::STRIDE])
    return weights, arrays


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    weights, arrays = build()
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez_compressed(NPZ, **arrays)
    torch.save({k: {n: t.contiguous() for n, t in sd.items()}
                for k, sd in weights.items()}, WEIGHTS)
    for path in (NPZ, WEIGHTS):
        print(f"wrote {os.path.relpath(path, REPO)}: "
              f"{os.path.getsize(path) / 1e6:.3f} MB")
    from lwsnet_tpu_torch import ModelConfig

    guards = [parity.SPAN_GUARD * parity.bin_range_px(ModelConfig(), s)
              for s in range(1, 5)]
    for name in parity.SETS:
        spans = [float(np.ptp(arrays[f"{name}_stage{s}"]))
                 for s in range(1, 5)]
        print(f"{name}: stage spans {[round(x, 3) for x in spans]} px "
              f"(span guard {guards} px, "
              f"{'held' if name in parity.GUARDED else 'not held'})")


if __name__ == "__main__":
    main()
