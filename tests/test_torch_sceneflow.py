"""The port's SceneFlow data path and pretrain Trainer against the JAX
package's, on the CPU at float32.

PFM read / write both ways against the JAX codec (gray and RGB, little-
and big-endian); `index_sceneflow` on a layout with every subset (monkaa,
FlyingThings TRAIN / TEST A-B-C, driving 15mm and 35mm), with the
reference's duplicated 15mm split and without; the SceneFlow branch of
`StereoPipeline` batch for batch bit-identical to the JAX pipeline,
training and eval (the 544-from-540 padded window, here 32 rows from 28),
at one and two processes; and a one-epoch pretrain `Trainer` (EPE with
the row offset 4) against the JAX Trainer on the same weights.
"""

import logging
import os

import numpy as np
import pytest
import torch

from lwsnet_tpu import ModelConfig as JConfig
from lwsnet_tpu import TrainConfig as JTrainConfig
from lwsnet_tpu.data import pfm as jpfm
from lwsnet_tpu.data import sceneflow as jsceneflow
from lwsnet_tpu.data import transforms as JT
from lwsnet_tpu.data.pipeline import StereoPipeline as JPipeline
from lwsnet_tpu.data.png import write_png
from lwsnet_tpu.training.loop import Trainer as JTrainer
from lwsnet_tpu.training.loop import TrainerConfig as JTrainerConfig
from lwsnet_tpu_torch import ModelConfig
from lwsnet_tpu_torch.config import TrainConfig
from lwsnet_tpu_torch.convert import to_jax_variables
from lwsnet_tpu_torch.data import pfm, sceneflow
from lwsnet_tpu_torch.data import transforms as T
from lwsnet_tpu_torch.data.pipeline import StereoPipeline
from lwsnet_tpu_torch.training.checkpoint import CheckpointManager
from lwsnet_tpu_torch.training.loop import Trainer, TrainerConfig

H, W = 40, 72          # train frames
TEST_H = 28            # test frames: the eval window has 4 rows more
CROP = (32, 64)
LOG = logging.getLogger("test_torch_sceneflow")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- PFM ----------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3])
def test_pfm_round_trips_against_jax(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (5, 7) if channels == 1 else (5, 7, 3)
    data = rng.uniform(-50, 250, shape).astype(np.float32)
    port, ref = str(tmp_path / "port.pfm"), str(tmp_path / "jax.pfm")
    pfm.write_pfm(port, data, scale=2.0)
    jpfm.write_pfm(ref, data, scale=2.0)
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert open(port, "rb").read(2) == (b"Pf" if channels == 1 else b"PF")
    for path in (port, ref):
        got, scale = pfm.read_pfm(path)
        want, jscale = jpfm.read_pfm(path)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, data)
        assert scale == jscale == 2.0 and got.dtype == np.float32
    # big-endian: a positive scale, '>f4' rows, bottom row first
    big = str(tmp_path / "big.pfm")
    with open(big, "wb") as f:
        f.write((b"Pf" if channels == 1 else b"PF") + b"\n")
        f.write(f"{shape[1]} {shape[0]}\n3.5\n".encode())
        np.flipud(data).astype(">f4").tofile(f)
    got, scale = pfm.read_pfm(big)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, jpfm.read_pfm(big)[0])
    assert scale == 3.5


def test_pfm_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.pfm"
    bad.write_bytes(b"P6\n2 2\n-1\n")
    for read in (pfm.read_pfm, jpfm.read_pfm):
        with pytest.raises(ValueError, match="not a PFM"):
            read(str(bad))
    short = tmp_path / "short.pfm"
    short.write_bytes(b"Pf\n2 2\n-1\n" + b"\0" * 8)
    with pytest.raises(ValueError, match="truncated"):
        pfm.read_pfm(str(short))
    with pytest.raises(ValueError, match="unsupported"):
        pfm.write_pfm(str(tmp_path / "x.pfm"), np.zeros((2, 2, 2)))


# -- index --------------------------------------------------------------------

def _frames(img_dir, disp_dir, n, h, w, rng):
    for sub in ("left", "right"):
        os.makedirs(os.path.join(img_dir, sub), exist_ok=True)
    os.makedirs(os.path.join(disp_dir, "left"), exist_ok=True)
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        write_png(os.path.join(img_dir, "left", f"{i:04d}.png"), img)
        write_png(os.path.join(img_dir, "right", f"{i:04d}.png"),
                  np.roll(img, -3, axis=1))
        disp = rng.uniform(1.0, 60.0, (h, w)).astype(np.float32)
        disp[rng.uniform(size=(h, w)) < 0.1] = 250.0  # past maxdisp
        jpfm.write_pfm(os.path.join(disp_dir, "left", f"{i:04d}.pfm"), disp)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """monkaa (train: 5 + 4 frames at 40x72) and FlyingThings TEST/A
    (test: 5 frames at 28x64)."""
    root = str(tmp_path_factory.mktemp("sceneflow"))
    rng = np.random.default_rng(0)
    for scene, n in (("sceneA", 5), ("sceneB", 4)):
        _frames(os.path.join(root, "monkaa_frames_cleanpass", scene),
                os.path.join(root, "monkaa_disparity", scene), n, H, W, rng)
    _frames(os.path.join(root, "frames_cleanpass", "TEST", "A", "0000"),
            os.path.join(root, "frames_disparity", "TEST", "A", "0000"), 5,
            TEST_H, 64, rng)
    return root


def _lists(*indexes):
    return [(i.left, i.right, i.disp) for i in indexes]


def test_index_matches_jax(tmp_path):
    """Every subset; empty files stand for the frames, the index reads
    names only."""
    root = tmp_path / "sf"

    def touch(img_dir, disp_dir, names):
        for sub in ("left", "right"):
            os.makedirs(root / img_dir / sub, exist_ok=True)
        os.makedirs(root / disp_dir / "left", exist_ok=True)
        for n in names:
            for sub in ("left", "right"):
                (root / img_dir / sub / n).write_bytes(b"")
        (root / img_dir / "left" / "notes.txt").write_bytes(b"")

    touch("monkaa_frames_cleanpass/a_rain", "monkaa_disparity/a_rain",
          ["0001.png", "0000.png"])
    touch("monkaa_frames_cleanpass/b_tree", "monkaa_disparity/b_tree",
          ["0000.png"])
    for split in ("TRAIN", "TEST"):
        for sub in ("A", "B", "C"):
            for seq in ("0000", "0001"):
                touch(f"frames_cleanpass/{split}/{sub}/{seq}",
                      f"frames_disparity/{split}/{sub}/{seq}",
                      ["0006.png", "0007.png"])
    for focal in ("15mm_focallength", "35mm_focallength"):
        for direction in ("scene_backwards", "scene_forwards"):
            for speed in ("fast", "slow"):
                touch(f"driving_frames_cleanpass/{focal}/{direction}/{speed}",
                      f"driving_disparity/{focal}/{direction}/{speed}",
                      ["0001.png"])
    for compat in (False, True):
        got = sceneflow.index_sceneflow(str(root), compat)
        want = jsceneflow.index_sceneflow(str(root), compat)
        assert _lists(*got) == _lists(*want)
        # monkaa 3 + TRAIN 12 + driving 8 (compat: 15mm twice)
        assert (len(got[0]), len(got[1])) == (23, 12)
    assert got[0].disp[0].endswith("monkaa_disparity/a_rain/left/0000.pfm")
    assert sum("35mm" in p for p in got[0].left) == 0
    assert sum("35mm" in p for p in sceneflow.index_sceneflow(
        str(root) + "/")[0].left) == 4


# -- transforms and pipeline -------------------------------------------------

def test_transforms_match_jax(corpus):
    train, test = sceneflow.index_sceneflow(corpus)
    for path in (train.disp[0], test.disp[1]):
        np.testing.assert_array_equal(T.load_disparity_sceneflow(path),
                                      JT.load_disparity_sceneflow(path))
    img = T.load_image(test.left[0])
    np.testing.assert_array_equal(img, JT.load_image(test.left[0]))
    got = T.bottom_right_crop(img, 32, 64, pad_if_short=True)
    np.testing.assert_array_equal(
        got, JT.bottom_right_crop(img, 32, 64, pad_if_short=True))
    assert got.shape == (32, 64, 3) and not got[:4].any()
    np.testing.assert_array_equal(got[4:], img)
    with pytest.raises(ValueError, match="smaller than crop"):
        T.bottom_right_crop(img, 32, 64)


@pytest.mark.parametrize("process_count", [1, 2])
@pytest.mark.parametrize("training", [True, False])
def test_batches_bit_identical_to_jax(corpus, training, process_count):
    train, test = sceneflow.index_sceneflow(corpus)
    idx = train if training else test
    crop = CROP
    for pi in range(process_count):
        kw = dict(training=training, crop=crop, kitti=False, seed=3,
                  num_workers=2, process_index=pi,
                  process_count=process_count)
        port = StereoPipeline(idx, 2, **kw)
        ref = JPipeline(idx, 2, **kw)
        assert port.batches_per_epoch() == ref.batches_per_epoch() > 0
        for epoch in ((0, 1) if training else (0,)):
            got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want) == port.batches_per_epoch()
            for a, b in zip(got, want):
                for f in ("left", "right", "disparity", "valid"):
                    x, y = getattr(a, f), getattr(b, f)
                    assert x.dtype == y.dtype == np.float32
                    np.testing.assert_array_equal(x, y, err_msg=f)
        if not training:
            # the eval window pads 4 rows; the ground truth stays 28 rows
            assert got[0].left.shape == (2, 32, 64, 3)
            assert got[0].disparity.shape == (2, TEST_H, 64)
            assert got[-1].valid.sum() < 2  # the last batch is padded


# -- pretrain Trainer ---------------------------------------------------------

def _pipes(corpus, pipeline_cls, train_batch, eval_batch):
    train, test = sceneflow.index_sceneflow(corpus)
    return (pipeline_cls(train, train_batch, training=True, crop=CROP,
                         kitti=False, num_workers=2),
            pipeline_cls(test, eval_batch, training=False, crop=CROP,
                         kitti=False, num_workers=2))


def _train_kw(save):
    return dict(lr=1e-3, epochs=1, train_batch_size=4, eval_batch_size=8,
                mask_max_disp=192.0, save_path=save, log_every=1)


def test_pretrain_trainer_matches_jax(corpus, tmp_path):
    """One epoch of the pretrain Trainer (batch 4 of the 9 monkaa frames:
    2 steps): finite steps, a best-only checkpoint with its metadata, and
    `evaluate` (EPE over the test split, the prediction's top 4 rows
    dropped) equal to `last_error`. Then the trained weights in the JAX
    Trainer: its EPE against the port's at rtol 1e-5, the bar of
    tests/test_torch_trainer.py (reading 9.2e-8; on the random initial
    weights, whose stage 4 spans 723 px, float32 noise alone reads
    1.1e-5), and D1 within ten flipped pixels of the 5 x 28 x 64."""
    save = str(tmp_path / "pre")
    tcfg = TrainerConfig(model=ModelConfig(compute_dtype="float32"),
                         train=TrainConfig(**_train_kw(save)),
                         eval_metric="epe", sceneflow_row_offset=4)
    trainer = Trainer(tcfg, *_pipes(corpus, StereoPipeline, 4, 8), LOG,
                      device="cpu")
    error = trainer.fit()
    assert len(trainer.history) == 2
    assert all(h["finite"] == 1.0 for h in trainer.history)
    assert np.isfinite(error) and error == trainer.last_error
    assert CheckpointManager(save).exists()

    jtrainer = JTrainer(
        JTrainerConfig(model=JConfig(compute_dtype="float32"),
                       train=JTrainConfig(**_train_kw(str(tmp_path / "j"))),
                       eval_metric="epe", sceneflow_row_offset=4),
        *_pipes(corpus, JPipeline, 8, 8), LOG)
    jtrainer.init_state()
    var = to_jax_variables(trainer.state.model.state_dict())
    jtrainer.state = jtrainer.state.replace(
        params=var["params"], batch_stats=var["batch_stats"])
    np.testing.assert_allclose(trainer.evaluate(), jtrainer.evaluate(),
                               rtol=1e-5)
    trainer.tcfg.eval_metric = jtrainer.tcfg.eval_metric = "d1"
    got, want = trainer.evaluate(), jtrainer.evaluate()
    assert abs(got - want) <= 10 / (5 * TEST_H * 64), (got, want)
