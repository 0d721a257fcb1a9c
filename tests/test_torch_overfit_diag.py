"""`tools.overfit_diag` against the JAX tool's `examples/overfit_diag.py`.

Both tools' `run_config` train one float32 configuration with frozen batch
norm primed by two forwards (`prime=2`) for 4 steps over the same two
batches of 2 synthetic pairs at 32x64 (the port's `build_batches`), from
the same initial weights (JAX's `create_train_state`, bridged into the
port's by patching its `create_train_state`). Both tools run at that
size through their module constants `H`, `W`, and the JAX tool's
`DIAG_CHUNK` scan length, patched here; the example itself is not
edited.

Held against JAX at lr 0, where every step leaves the primed state as it
is: the per-step losses, the stage-4 loss and EPE in both batch-norm
modes, the re-estimated ("restat") EPE and the recheck step's losses
within one unit of the digit the JAX tool rounds to (3 or 4) plus 1e-5 of
the value; `max_gnorm` at the frozen-BN grad_norm bar of
tests/test_torch_training.py (rtol 1e-2). At lr 1e-3 only the step before
the first update is comparable: the float32 trajectory of this
configuration is chaotic. Scaling the port's left images by 1 + 1e-7
moves its own third loss from 46.773 to 26.871 and its last from 38.123
to 36.214 (torch 2.13, `run_config` twice); the JAX tool's reads 28.895
and 26.869 there. So at lr 1e-3 the port's run is held to JAX's first
loss and to finite telemetry. Readings at lr 0 (torch 2.13): every
rounded value equal but `last_loss`, `min_loss` and `step_loss_recheck`,
one unit of the 4th digit apart; `max_gnorm` 3501.2 against 3501.18.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from lwsnet_tpu import LWSNet as JLWSNet
from lwsnet_tpu import ModelConfig as JConfig
from lwsnet_tpu import TrainConfig as JTrainConfig
from lwsnet_tpu.training.state import create_train_state as jcreate
from lwsnet_tpu_torch.convert import from_jax_variables
from lwsnet_tpu_torch.data.png import write_png
from lwsnet_tpu_torch.tools import overfit_diag
from lwsnet_tpu_torch.training import state as state_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(dtype="float32", lr=1e-3, milestones=(), bn="frozen", prime=2)
STILL = dict(SPEC, lr=0.0)
STEPS, PAIRS, BATCH, H, W = 4, 4, 2, 32, 64
# key -> digits the JAX tool rounds it to
KEYS = {"first_loss": 3, "last_loss": 4, "min_loss": 4,
        "final_epe_eval": 4, "final_epe_train": 4, "final_loss4_eval": 4,
        "final_loss4_train": 4, "epe_eval_restat": 4,
        "step_loss_recheck": 4}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_examples_overfit_diag",
        os.path.join(REPO, "examples", "overfit_diag.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, want, digits):
    return abs(got - want) <= 10.0 ** -digits + 1e-5 * abs(want)


@pytest.fixture(scope="module")
def runs():
    """The JAX tool's and the port's results at lr 0, and the port's at
    lr 1e-3, on the same batches and initial weights."""
    src = np.random.default_rng(3).random((48, 140, 3)).astype(np.float32)
    jtool = _jax_tool()
    assert jtool.CONFIGS == overfit_diag.CONFIGS
    jstate = jcreate(JLWSNet(JConfig(compute_dtype="float32")),
                     JTrainConfig(), jax.random.PRNGKey(0), (H, W),
                     steps_per_epoch=PAIRS // BATCH)
    weights = from_jax_variables({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats})
    create = state_lib.create_train_state

    def from_jax(*args, **kw):
        """The port's initial state holding JAX's initial weights."""
        st = create(*args, **kw)
        st.model.load_state_dict(weights, strict=True)
        return st

    with pytest.MonkeyPatch.context() as mp:
        for tool in (jtool, overfit_diag):
            mp.setattr(tool, "H", H)
            mp.setattr(tool, "W", W)
        mp.setenv("DIAG_CHUNK", str(STEPS))
        mp.setattr(state_lib, "create_train_state", from_jax)
        batches = overfit_diag.build_batches(src, PAIRS, BATCH)
        assert batches[0].shape == (PAIRS // BATCH, BATCH, H, W, 3)
        want = jtool.run_config("f32_frozen", STILL, batches, STEPS, [])
        port = {lr: overfit_diag.run_config(
            "f32_frozen", dict(SPEC, lr=lr), batches, STEPS, [],
            device="cpu") for lr in (0.0, SPEC["lr"])}
    return want, port


def test_run_config_matches_jax_at_lr_0(runs):
    want, port = runs
    got = port[0.0]
    assert got.keys() == want.keys()
    assert got["steps"] == want["steps"] == STEPS
    for key, digits in KEYS.items():
        print(key, got[key], want[key])
        assert _close(got[key], want[key], digits), key
    for key, digits in (("loss_last_10", 3), ("final_stage_losses", 4),
                        ("step_stage_recheck", 4)):
        assert len(got[key]) == len(want[key]), key
        assert all(_close(a, b, digits)
                   for a, b in zip(got[key], want[key])), key
    print("max_gnorm", got["max_gnorm"], want["max_gnorm"])
    assert abs(got["max_gnorm"] / want["max_gnorm"] - 1.0) <= 1e-2


def test_run_config_trains_at_lr_1e_3(runs):
    want, port = runs
    got = port[SPEC["lr"]]
    assert _close(got["first_loss"], want["first_loss"], 3)
    assert got["last_loss"] != got["first_loss"]
    for key in KEYS:
        assert np.isfinite(got[key]), key
    assert np.all(np.isfinite(got["loss_last_10"]))


def test_main_on_cpu(tmp_path, monkeypatch):
    """The command line end to end at 32x64 (the module's H, W patched):
    one result per configuration, written as the JSON it returns."""
    monkeypatch.setattr(overfit_diag, "H", H)
    monkeypatch.setattr(overfit_diag, "W", W)
    src = str(tmp_path / "source.png")
    write_png(src, np.random.default_rng(4).integers(
        0, 256, (48, 140, 3), dtype=np.uint8))
    out = str(tmp_path / "diag.json")
    res = overfit_diag.main(["--source", src, "--configs", "f32", "primed",
                             "--steps", "2", "--pairs", "2", "--batch", "1",
                             "--device", "cpu", "--out", out])
    with open(out) as f:
        assert json.load(f) == res
    assert [r["config"] for r in res] == ["f32", "primed"]
    assert all(np.isfinite(r["last_loss"]) and r["steps"] == 2 for r in res)


def test_source_is_required():
    with pytest.raises(SystemExit) as e:
        overfit_diag.main(["--steps", "1"])
    assert e.value.code == 2
