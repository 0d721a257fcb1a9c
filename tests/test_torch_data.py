"""The port's KITTI2015 data path against the JAX package's.

Indexing, the transforms and `StereoPipeline` of `lwsnet_tpu_torch.data`
against `lwsnet_tpu.data` on one synthetic corpus (PNG frames and uint16
disparity maps written from a seed): the batches of every epoch are
bit-identical, training and eval; per-process slices are disjoint; every
process runs the same number of batches; the last eval batch is padded.
Mirrors tests/test_data.py and tests/test_native.py for KITTI.
"""

import os
import subprocess
import tempfile

import numpy as np
import pytest

from lwsnet_tpu.data import kitti2015 as jkitti
from lwsnet_tpu.data import pipeline as jpipeline
from lwsnet_tpu.data import transforms as JT
from lwsnet_tpu.data.png import write_png
from lwsnet_tpu_torch.data import kitti2015, native, pipeline
from lwsnet_tpu_torch.data import transforms as T

H, W = 48, 100
N = 7


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """KITTI `training/` layout with N frames; sparse GT, 0 = none."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    for d in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(root / d)
    for i in range(N):
        name = f"{i:06d}_10.png"
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        write_png(str(root / "image_2" / name), img)
        write_png(str(root / "image_3" / name), np.roll(img, -3, axis=1))
        disp = rng.uniform(1.0, 150.0, (H, W))
        disp[rng.uniform(size=(H, W)) < 0.6] = 0.0
        write_png(str(root / "disp_occ_0" / name),
                  (disp * 256).astype(np.uint16))
        # a non-_10 frame, which the index ignores
        write_png(str(root / "image_2" / f"{i:06d}_11.png"), img)
    split = root / "val.txt"
    split.write_text("1\n4\n")
    return str(root), str(split)


def _lists(*indexes):
    return [(i.left, i.right, i.disp) for i in indexes]


def test_index_matches_jax(corpus, tmp_path):
    root, split = corpus
    got = kitti2015.index_kitti2015(root, split_file=split)
    want = jkitti.index_kitti2015(root, split_file=split)
    assert _lists(*got) == _lists(*want)
    assert len(got[1]) == 2 and len(got[0]) == N - 2
    tree = tmp_path / "full"
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(tree / sub)
        for i in range(200):
            open(tree / sub / f"{i:06d}_10.png", "w").close()
    got = kitti2015.index_kitti2015(str(tree))
    assert _lists(*got) == _lists(*jkitti.index_kitti2015(str(tree)))
    assert len(got[1]) == 40 and len(got[0]) == 160
    assert os.path.basename(got[1].left[0]) == "000013_10.png"
    assert (_lists(kitti2015.index_kitti2015_testing(root))
            == _lists(jkitti.index_kitti2015_testing(root)))


def _pipes(root, split, training, bs, crop, **kw):
    t_idx, v_idx = kitti2015.index_kitti2015(root, split_file=split)
    idx = t_idx if training else v_idx
    return (pipeline.StereoPipeline(idx, bs, training=training, crop=crop,
                                    kitti=True, num_workers=2, **kw),
            jpipeline.StereoPipeline(idx, bs, training=training, crop=crop,
                                     kitti=True, num_workers=2, **kw))


@pytest.mark.parametrize("training,bs,crop", [(True, 2, (32, 64)),
                                              (False, 3, (48, 96))])
def test_batches_bit_identical_to_jax(corpus, training, bs, crop):
    root, split = corpus
    port, ref = _pipes(root, None if training else split, training, bs,
                       crop, seed=3)
    assert port.batches_per_epoch() == ref.batches_per_epoch()
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == port.batches_per_epoch() > 0
        for a, b in zip(got, want):
            for f in ("left", "right", "disparity", "valid"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype == np.float32
                np.testing.assert_array_equal(x, y, err_msg=f)
    if training:  # the shuffle and crops change with the epoch
        first = [b.left for b in port.epoch(0)]
        assert not np.array_equal(first[0], list(port.epoch(1))[0].left)
    else:  # 2 val frames, batch 3: one padded row
        b = got[-1]
        assert b.valid.tolist() == [1.0, 1.0, 0.0]
        assert b.left.shape == (3, 48, 96, 3)


def test_process_slices_disjoint(corpus):
    root, _ = corpus
    idx, _ = kitti2015.index_kitti2015(root)
    seen = []
    for pi in range(2):
        pipe = pipeline.StereoPipeline(idx, 1, training=True, crop=(32, 64),
                                       seed=3, process_index=pi,
                                       process_count=2)
        seen.append(set(pipe._epoch_order(0).tolist()))
    assert seen[0].isdisjoint(seen[1])
    assert len(seen[0] | seen[1]) == len(idx)


@pytest.mark.parametrize("training,bs", [(False, 2), (True, 1), (False, 1)])
def test_lockstep_batch_counts(corpus, training, bs):
    """7 examples over 3 processes: slices of 3, 2, 2; every process runs
    the same number of batches, and eval covers each example once."""
    root, _ = corpus
    idx, _ = kitti2015.index_kitti2015(root, split_file=os.devnull)
    counts, total_valid = [], 0.0
    for pi in range(3):
        pipe = pipeline.StereoPipeline(idx, bs, training=training,
                                       crop=(32, 64), seed=5,
                                       process_index=pi, process_count=3,
                                       num_workers=2)
        batches = list(pipe.epoch(0))
        assert len(batches) == pipe.batches_per_epoch()
        counts.append(len(batches))
        total_valid += sum(float(b.valid.sum()) for b in batches)
        for b in batches:
            assert b.left.shape == (bs, 32, 64, 3)
    assert len(set(counts)) == 1, counts
    if not training:
        assert total_valid == len(idx)


@pytest.fixture(scope="module")
def native_library():
    """native/libstereoload.so, built here when it is missing (as
    tests/test_native.py builds it), so the test below does not depend on
    which worker ran that file first. The library is made in a temporary
    directory and renamed into place, so a process that loads it never
    sees a half-written file. Skips only when the toolchain is missing."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = os.path.join(repo, "native", "libstereoload.so")
    if not os.path.exists(lib):
        with tempfile.TemporaryDirectory(
                dir=os.path.join(repo, "native")) as tmp:
            try:
                subprocess.run(
                    ["make", "-C", os.path.join(repo, "native"),
                     f"OUT={os.path.join(tmp, 'libstereoload.so')}"],
                    check=True, capture_output=True)
            except (subprocess.CalledProcessError, OSError) as e:
                pytest.skip(f"native toolchain unavailable: {e}")
            os.replace(os.path.join(tmp, "libstereoload.so"), lib)
    if not native.available():
        pytest.skip("native library failed to load")


def test_native_and_numpy_routes_agree(corpus, monkeypatch, native_library):
    """The native fused crop / normalize and the numpy path give the same
    batch (the decode is exact; normalization within 1e-6)."""
    root, split = corpus
    pipe, _ = _pipes(root, split, False, 2, (48, 96))
    fast = list(pipe.epoch(0))
    monkeypatch.setattr(native, "available", lambda: False)
    slow = list(pipe.epoch(0))
    for a, b in zip(fast, slow):
        np.testing.assert_allclose(a.left, b.left, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.right, b.right, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a.disparity, b.disparity)
    img = T.decode_image_u8(os.path.join(root, "image_2", "000000_10.png"))
    np.testing.assert_array_equal(
        img, JT.decode_image_u8(os.path.join(root, "image_2",
                                             "000000_10.png")))


def test_transforms_match_jax(corpus):
    root, _ = corpus
    path = os.path.join(root, "disp_occ_0", "000002_10.png")
    np.testing.assert_array_equal(T.load_disparity_kitti(path),
                                  JT.load_disparity_kitti(path))
    np.testing.assert_array_equal(
        T.load_crop_disparity_kitti(path, 5, 7, 20, 30),
        JT.load_crop_disparity_kitti(path, 5, 7, 20, 30))
    img = T.decode_image_u8(os.path.join(root, "image_3", "000002_10.png"))
    np.testing.assert_array_equal(T.crop_normalize(img, 3, 4, 16, 24),
                                  JT.crop_normalize(img, 3, 4, 16, 24))
    rng = np.random.default_rng(9)
    a = rng.uniform(size=(H, W, 3)).astype(np.float32)
    d = rng.uniform(size=(H, W)).astype(np.float32)
    got = T.random_crop(a, a, d, 20, 30, np.random.default_rng(1))
    want = JT.random_crop(a, a, d, 20, 30, np.random.default_rng(1))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_sceneflow_pipeline_not_ported(corpus):
    """`kitti=False` no longer raises: the SceneFlow branch reads a
    GT-free index (zero disparity) as the JAX one does, padding the eval
    window's top rows (tests/test_torch_sceneflow.py holds the branch
    with PFM ground truth)."""
    root, _ = corpus
    t_idx, _ = kitti2015.index_kitti2015(root, split_file=os.devnull)
    idx = kitti2015.StereoIndex(t_idx.left, t_idx.right, [])
    port = pipeline.StereoPipeline(idx, 2, training=False, crop=(H + 4, W),
                                   kitti=False, num_workers=2)
    ref = jpipeline.StereoPipeline(idx, 2, training=False, crop=(H + 4, W),
                                   kitti=False, num_workers=2)
    got, want = list(port.epoch(0)), list(ref.epoch(0))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for f in ("left", "right", "disparity", "valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert got[0].left.shape == (2, H + 4, W, 3)
    assert not got[0].disparity.any() and got[0].disparity.shape == (2, H, W)
