"""The port's CLI entry points end to end on the CPU, mirroring
tests/test_cli.py: `cli.pretrain` on a SceneFlow slice, `cli.finetune`
from the pretrained checkpoint, and `cli.infer` in batch and single-pair
mode, whose disparities are held against the JAX package's
`InferenceEngine` on the same weights (bridged by `convert`) at the
whole-model bar of tests/test_torch_model.py. Geometry is shrunk through
the CLIs' own flags; every run passes `--device cpu`.
"""

import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lwsnet_tpu import ModelConfig as JConfig  # noqa: E402
from lwsnet_tpu.inference import InferenceEngine as JEngine  # noqa: E402
from lwsnet_tpu_torch import LWSNet, ModelConfig  # noqa: E402
from lwsnet_tpu_torch.cli import finetune, infer, pretrain  # noqa: E402
from lwsnet_tpu_torch.convert import to_jax_variables  # noqa: E402
from lwsnet_tpu_torch.data.pfm import write_pfm  # noqa: E402
from lwsnet_tpu_torch.data.png import write_png  # noqa: E402
from lwsnet_tpu_torch.training.checkpoint import CheckpointManager  # noqa
from lwsnet_tpu_torch.training.loop import Trainer  # noqa: E402
from test_torch_model import _span_check  # noqa: E402

H, W = 40, 72
CROP = ["--crop_height", "32", "--crop_width", "64"]
EVAL = ["--eval_height", "32", "--eval_width", "64"]
INFER = ["--compute_dtype", "float32", "--device", "cpu"]
FAST = INFER + ["--num_workers", "2"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_pair(rng, lp, rp, h=H, w=W):
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    write_png(lp, img)
    write_png(rp, np.roll(img, -3, axis=1))
    return rng.uniform(3.0, 40.0, (h, w)).astype(np.float32)


@pytest.fixture(scope="module")
def sceneflow_root(tmp_path_factory):
    """A monkaa scene (train, 8 frames) and a frames_cleanpass/TEST
    sequence (test, 8 frames of 28 rows: the eval window is 4 rows taller,
    as 544 is of SceneFlow's 540)."""
    root = tmp_path_factory.mktemp("sceneflow")
    rng = np.random.default_rng(1)

    def fill(img_dir, disp_dir, n, h, w):
        for sub in ("left", "right"):
            os.makedirs(os.path.join(img_dir, sub), exist_ok=True)
        os.makedirs(os.path.join(disp_dir, "left"), exist_ok=True)
        for i in range(n):
            disp = _write_pair(
                rng, os.path.join(img_dir, "left", f"{i:04d}.png"),
                os.path.join(img_dir, "right", f"{i:04d}.png"), h, w)
            write_pfm(os.path.join(disp_dir, "left", f"{i:04d}.pfm"), disp)

    fill(str(root / "monkaa_frames_cleanpass" / "sceneA"),
         str(root / "monkaa_disparity" / "sceneA"), 8, H, W)
    fill(str(root / "frames_cleanpass" / "TEST" / "A" / "0000"),
         str(root / "frames_disparity" / "TEST" / "A" / "0000"), 8, 28, 64)
    return str(root)


@pytest.fixture(scope="module")
def pretrained(sceneflow_root, tmp_path_factory):
    """`cli.pretrain.run` for one epoch; its checkpoint directory."""
    save = str(tmp_path_factory.mktemp("pretrained"))
    trainer = pretrain.run(
        ["--datapath", sceneflow_root, "--epoch", "1",
         "--train_batch_size", "8", "--test_batch_size", "8",
         "--save_path", save] + CROP + EVAL + FAST)
    return save, trainer


def test_pretrain_main(pretrained, sceneflow_root, tmp_path):
    save, trainer = pretrained
    assert np.isfinite(trainer.last_error)  # EPE
    assert len(trainer.history) == 1 and trainer.history[0]["finite"] == 1.0
    assert trainer.tcfg.eval_metric == "epe"
    assert trainer.tcfg.sceneflow_row_offset == 4
    assert trainer.tcfg.train.mask_max_disp == 192.0
    assert CheckpointManager(save).exists()
    err = pretrain.main(
        ["--datapath", sceneflow_root, "--epoch", "1",
         "--save_path", str(tmp_path / "again")] + CROP + EVAL + FAST)
    assert np.isfinite(err)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """KITTI2015 `training/`: 12 frames, a split file naming 4."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    for d in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(root / d)
    for i in range(12):
        name = f"{i:06d}_10.png"
        disp = _write_pair(rng, str(root / "image_2" / name),
                           str(root / "image_3" / name))
        write_png(str(root / "disp_occ_0" / name),
                  (disp * 256).astype(np.uint16))
    split = root / "val.txt"
    split.write_text("".join(f"{i}\n" for i in range(4)))
    return str(root), str(split)


def test_finetune_from_pretrained(pretrained, kitti_root, tmp_path,
                                  monkeypatch):
    """`cli.finetune --pretrained <pretrain dir>`: the parameters and
    statistics before the first step are the checkpoint's, exactly; then
    one epoch trains and saves."""
    save, _ = pretrained
    want = torch.load(CheckpointManager(save).path,
                      weights_only=True)["model"]
    first = {}
    train_epoch = Trainer.train_epoch

    def spy(self, epoch):
        first.setdefault("state", {k: v.clone() for k, v in
                                   self.state.model.state_dict().items()})
        return train_epoch(self, epoch)

    monkeypatch.setattr(Trainer, "train_epoch", spy)
    root, split = kitti_root
    out = str(tmp_path / "ft")
    trainer = finetune.run(
        ["--datapath", root, "--val_set", split, "--pretrained", save,
         "--epoch", "1", "--train_batch_size", "4", "--test_batch_size",
         "4", "--save_path", out] + CROP + EVAL + FAST)
    assert first["state"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(first["state"][k], v), k
    assert len(trainer.history) == 2 and 0.0 <= trainer.last_error <= 1.0
    assert CheckpointManager(out).exists()
    assert not torch.equal(trainer.state.model.state_dict()[
        "FeatureExtractor_0.ConvBN_0.Conv_0.weight"],
        want["FeatureExtractor_0.ConvBN_0.Conv_0.weight"])


@pytest.fixture(scope="module")
def testing_root(tmp_path_factory):
    """KITTI `testing/` (no ground truth): 2 frames."""
    root = tmp_path_factory.mktemp("testing")
    rng = np.random.default_rng(2)
    for d in ("image_2", "image_3"):
        os.makedirs(root / d)
    for i in range(2):
        name = f"{i:06d}_10.png"
        _write_pair(rng, str(root / "image_2" / name),
                    str(root / "image_3" / name))
    return str(root)


def _jax_disparities(state_dict, left, right):
    """JAX's `InferenceEngine` (XLA path) on the bridged weights."""
    engine = JEngine(JConfig(compute_dtype="float32", use_pallas=False),
                     to_jax_variables(state_dict), eval_height=32,
                     eval_width=64)
    disps, _ = engine.infer_files(left, right, num_stages=4)
    return disps


def test_infer_main_batch(testing_root, tmp_path):
    """Random weights (the port's seed-0 init), the kernel path's plain
    versions: four PNGs a frame, each frame against JAX."""
    out = str(tmp_path / "out")
    frames = infer.run(["--img_path", testing_root, "--save_path", out,
                        "--random_weights"] + EVAL + INFER)
    assert [f["name"] for f in frames] == ["000000_10", "000001_10"]
    for i in range(2):
        for s in range(1, 5):
            assert os.path.isfile(
                os.path.join(out, f"{i:06d}_10_stage{s}.png"))
    state = LWSNet(ModelConfig(compute_dtype="float32"), device="cpu",
                   seed=0).state_dict()
    for f in frames:
        want = _jax_disparities(
            state, f["left"], f["left"].replace("image_2", "image_3"))
        _span_check([torch.from_numpy(d) for d in f["disparities"]], want)
        assert f["seconds"] > 0 and f["host_seconds"] >= f["seconds"]
    assert infer.main(["--img_path", testing_root, "--save_path", out,
                       "--random_weights", "--no_pallas"] + EVAL + INFER) \
        is None


def test_infer_main_single_pair(testing_root, pretrained, tmp_path):
    """`--left_img` with its sibling right_test.png and `--model` the
    pretrained checkpoint: {1..4}.png, against JAX on the restored
    weights."""
    save, _ = pretrained
    left = os.path.join(testing_root, "image_2", "000000_10.png")
    right = os.path.join(testing_root, "image_2", "right_test.png")
    shutil.copy(os.path.join(testing_root, "image_3", "000000_10.png"),
                right)
    out = str(tmp_path / "single")
    (frame,) = infer.run(["--left_img", left, "--save_path", out,
                          "--model", save] + EVAL + INFER)
    for s in range(1, 5):
        assert os.path.isfile(os.path.join(out, f"{s}.png"))
    want = _jax_disparities(torch.load(CheckpointManager(save).path,
                                       weights_only=True)["model"],
                            left, right)
    _span_check([torch.from_numpy(d) for d in frame["disparities"]], want)
    with pytest.raises(SystemExit, match="no checkpoint"):
        infer.run(["--left_img", left, "--save_path", out, "--model",
                   str(tmp_path / "none")] + EVAL + INFER)


def test_cli_entry_points_need_a_card_unless_told(sceneflow_root,
                                                  testing_root, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        pretrain.main(["--datapath", sceneflow_root, "--save_path",
                       str(tmp_path / "p")])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        infer.main(["--img_path", testing_root, "--random_weights",
                    "--save_path", str(tmp_path / "i")])
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        pretrain.main(["--datapath", sceneflow_root, "--save_path",
                       str(tmp_path / "p")])
