"""The port's Trainer, checkpoints and finetune CLI on the CPU.

`lwsnet_tpu_torch.training.loop.Trainer` on a synthetic KITTI-style corpus
(mirrors tests/test_trainer.py): `fit` learns, keeps its best checkpoint
with the live lr, and a fresh Trainer resumes from it. Its `evaluate` and
exact precise BN against the JAX Trainer on the same weights; the
finetune CLI end to end with `--device cpu` (mirrors tests/test_cli.py);
and the device rule: without a card the entry points raise unless asked
for the CPU.
"""

import logging
import math
import os

import jax
import numpy as np
import pytest
import torch

from lwsnet_tpu import ModelConfig as JConfig
from lwsnet_tpu import TrainConfig as JTrainConfig
from lwsnet_tpu.data.kitti2015 import StereoIndex as JIndex
from lwsnet_tpu.data.pipeline import StereoPipeline as JPipeline
from lwsnet_tpu.data.png import write_png
from lwsnet_tpu.training.loop import Trainer as JTrainer
from lwsnet_tpu.training.loop import TrainerConfig as JTrainerConfig
from lwsnet_tpu_torch import ModelConfig
from lwsnet_tpu_torch.cli import finetune
from lwsnet_tpu_torch.config import TrainConfig
from lwsnet_tpu_torch.convert import from_jax_variables
from lwsnet_tpu_torch.data.kitti2015 import StereoIndex
from lwsnet_tpu_torch.data.pipeline import StereoPipeline
from lwsnet_tpu_torch.training.checkpoint import CheckpointManager
from lwsnet_tpu_torch.training.loop import Trainer, TrainerConfig
from lwsnet_tpu_torch.training.state import create_train_state

H, W = 64, 96
CROP = (32, 64)
N_EXAMPLES = 16  # batch 8: the JAX Trainer's 8-device CPU mesh divides it
LOG = logging.getLogger("test_torch_trainer")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers, and
    torch on every core in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Flat synthetic corpus: right = left shifted 3 px, dense GT."""
    root = str(tmp_path_factory.mktemp("corpus"))
    rng = np.random.default_rng(0)
    paths = ([], [], [])
    for i in range(N_EXAMPLES):
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        disp = rng.uniform(3.0, 40.0, (H, W)).astype(np.float32)
        for lst, name, arr in zip(paths, "lrd", (
                img, np.roll(img, -3, axis=1),
                (disp * 256).astype(np.uint16))):
            p = os.path.join(root, f"{name}_{i}.png")
            write_png(p, arr)
            lst.append(p)
    return paths


def _trainer(paths, save_path, training_stats=True, **train_kw):
    kw = dict(lr=1e-3, epochs=2, train_batch_size=8, eval_batch_size=8,
              mask_min_disp=0.0, save_path=save_path, log_every=1)
    kw.update(train_kw)
    idx = StereoIndex(*paths)
    train = StereoPipeline(idx, 8, training=training_stats, crop=CROP,
                           num_workers=2)
    evaluate = StereoPipeline(idx, 8, training=False, crop=CROP,
                              num_workers=2)
    return Trainer(TrainerConfig(model=ModelConfig(compute_dtype="float32"),
                                 train=TrainConfig(**kw), eval_metric="epe"),
                   train, evaluate, LOG, device="cpu")


def _jax_trainer(paths, save_path, training_stats=True, **train_kw):
    kw = dict(lr=1e-3, epochs=2, train_batch_size=8, eval_batch_size=8,
              mask_min_disp=0.0, save_path=save_path, log_every=1)
    kw.update(train_kw)
    idx = JIndex(*paths)
    train = JPipeline(idx, 8, training=training_stats, crop=CROP, kitti=True,
                      num_workers=2)
    evaluate = JPipeline(idx, 8, training=False, crop=CROP, kitti=True,
                         num_workers=2)
    return JTrainer(JTrainerConfig(model=JConfig(compute_dtype="float32"),
                                   train=JTrainConfig(**kw),
                                   eval_metric="epe"),
                    train, evaluate, LOG)


def test_fit_learns_checkpoints_and_resumes(corpus, tmp_path):
    save = str(tmp_path / "run")
    trainer = _trainer(corpus, save, lr_milestones=(1,))
    assert trainer.steps_per_epoch == 2
    error = trainer.fit(epochs=2)

    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert all(h["finite"] == 1.0 for h in trainer.history)
    assert losses[-1] < losses[0], losses
    assert math.isfinite(error) and error == trainer.last_error
    assert trainer.state.step == trainer.state.updates == 4
    # the milestone at epoch 1 decays at update 2; last_lr is the live value
    np.testing.assert_allclose(trainer.last_lr, 1e-4, rtol=1e-6)

    ckpt = CheckpointManager(save)
    assert ckpt.exists() and os.path.exists(ckpt.meta_path)
    trainer2 = _trainer(corpus, save, lr_milestones=(1,))
    fresh = trainer2.init_state().model.FeatureExtractor_0.ConvBN_0 \
        .Conv_0.weight.detach().clone()
    assert trainer2.resume()
    assert trainer2.start_epoch >= 1
    assert trainer2.best_error == trainer.best_error
    restored = trainer2.state.model.FeatureExtractor_0.ConvBN_0.Conv_0.weight
    assert not torch.equal(fresh, restored)  # trained params were loaded
    assert trainer2.state.step >= trainer.steps_per_epoch
    assert len(trainer2.state.optimizer.state) > 0  # Adam moments too

    # params-only bootstrap: weights and BN statistics, a fresh optimizer
    trainer3 = _trainer(corpus, str(tmp_path / "other"))
    trainer3.init_state()
    assert trainer3.load_pretrained(save)
    assert torch.equal(trainer3.state.model.state_dict()[
        "FeatureExtractor_0.ConvBN_0.Conv_0.weight"], restored)
    assert trainer3.state.step == 0 and not trainer3.state.optimizer.state
    assert not trainer3.load_pretrained(str(tmp_path / "none"))
    assert CheckpointManager(str(tmp_path / "none")).restore(
        trainer3.state) == (None, {})


@pytest.fixture(scope="module")
def jax_trainer(corpus, tmp_path_factory):
    """A JAX Trainer with its initial state; eval-mode stat batches make
    precise BN deterministic."""
    t = _jax_trainer(corpus, str(tmp_path_factory.mktemp("jax")),
                     training_stats=False, bn_reestimate_batches=2,
                     bn_reestimate_exact=True)
    t.init_state()
    return t


def test_evaluate_matches_jax_trainer(corpus, tmp_path, jax_trainer):
    trainer = _trainer(corpus, str(tmp_path / "eval"))
    trainer.init_state()
    trainer.state.model.load_state_dict(from_jax_variables(
        jax.device_get(jax_trainer.state.variables)), strict=True)
    np.testing.assert_allclose(trainer.evaluate(), jax_trainer.evaluate(),
                               rtol=1e-5)  # EPE
    # D1 counts pixels beyond a 3 px threshold, and a pixel whose error
    # sits within float32 noise of it flips: ten of the 32768 may
    trainer.tcfg.eval_metric = jax_trainer.tcfg.eval_metric = "d1"
    got, want = trainer.evaluate(), jax_trainer.evaluate()
    jax_trainer.tcfg.eval_metric = "epe"
    assert abs(got - want) <= 10 / (N_EXAMPLES * CROP[0] * CROP[1]), \
        (got, want)


@pytest.mark.parametrize("exact", [True, False])
def test_precise_bn_matches_jax_trainer(corpus, tmp_path, jax_trainer,
                                        exact):
    """`reestimate_bn` from the same weights and statistics: the exact
    moment average and the EWMA stat steps against the JAX Trainer's."""
    import dataclasses
    trainer = _trainer(corpus, str(tmp_path / "bn"), training_stats=False,
                       bn_reestimate_batches=2, bn_reestimate_exact=exact)
    trainer.init_state()
    trainer.state.model.load_state_dict(from_jax_variables(
        jax.device_get(jax_trainer.state.variables)), strict=True)
    start, tcfg = jax_trainer.state, jax_trainer.tcfg.train
    jax_trainer.tcfg.train = dataclasses.replace(
        tcfg, bn_reestimate_exact=exact)
    jax_trainer.reestimate_bn(0)
    want = from_jax_variables(jax.device_get(jax_trainer.state.variables))
    jax_trainer.state, jax_trainer.tcfg.train = start, tcfg
    trainer.reestimate_bn(0)
    for name, t in trainer.state.model.named_buffers():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    if exact:
        before = {n: t.clone()
                  for n, t in trainer.state.model.named_buffers()}
        trainer.reestimate_bn(7)  # idempotent: the stats are the params'
        for name, t in trainer.state.model.named_buffers():
            np.testing.assert_allclose(t.numpy(), before[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


def _kitti_tree(root, n=12, h=40, w=72):
    rng = np.random.default_rng(0)
    for d in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(root / d)
    for i in range(n):
        name = f"{i:06d}_10.png"
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        write_png(str(root / "image_2" / name), img)
        write_png(str(root / "image_3" / name), np.roll(img, -3, axis=1))
        disp = rng.uniform(3.0, 40.0, (h, w))
        write_png(str(root / "disp_occ_0" / name),
                  (disp * 256).astype(np.uint16))
    split = root / "val.txt"
    split.write_text("".join(f"{i}\n" for i in range(4)))
    return str(root), str(split)


def test_finetune_cli_trains_resumes_and_evaluates(tmp_path):
    root, split = _kitti_tree(tmp_path / "kitti")
    save = str(tmp_path / "ckpt")
    common = ["--datapath", root, "--val_set", split, "--pretrained", "",
              "--train_batch_size", "4", "--test_batch_size", "4",
              "--save_path", save, "--crop_height", "32", "--crop_width",
              "64", "--eval_height", "32", "--eval_width", "64",
              "--compute_dtype", "float32", "--num_workers", "2",
              "--device", "cpu"]
    trainer = finetune.run(["--epoch", "1"] + common)
    assert 0.0 <= trainer.last_error <= 1.0  # D1 is a rate
    assert len(trainer.history) == 2  # 8 train frames, batch 4
    assert CheckpointManager(save).exists()

    resumed = finetune.run(["--epoch", "2", "--resume"] + common)
    assert resumed.start_epoch == 1 and len(resumed.history) == 2
    assert resumed.history[0]["epoch"] == 1
    assert resumed.state.step == 4

    err = finetune.main(["--evaluate", "--resume"] + common)
    assert np.isfinite(err) and 0.0 <= err <= 1.0


def test_training_entry_points_need_a_card_unless_told(corpus, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        create_train_state(ModelConfig(compute_dtype="float32"),
                           TrainConfig())
    idx = StereoIndex(*corpus)
    pipe = StereoPipeline(idx, 8, training=True, crop=CROP)
    cfg = TrainerConfig(model=ModelConfig(compute_dtype="float32"),
                        train=TrainConfig(save_path=str(tmp_path / "r")))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        Trainer(cfg, pipe, pipe, LOG)
    root, split = _kitti_tree(tmp_path / "kitti")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        finetune.main(["--datapath", root, "--val_set", split,
                       "--pretrained", "", "--save_path",
                       str(tmp_path / "c")])
    assert create_train_state(ModelConfig(compute_dtype="float32"),
                              TrainConfig(), device="cpu").step == 0
