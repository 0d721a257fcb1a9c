"""The port's inference entry points (`lwsnet_tpu_torch.inference`) against
the JAX package, on the CPU in float32 (TF32 does not arise on the CPU).

`make_forward(..., use_pallas=True, device="cpu")` runs the kernel path's
glue with each kernel's plain version; the JAX side is `LWSNet.apply`.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lwsnet_tpu_torch import (InferenceEngine, LWSNet,  # noqa: E402
                              ModelConfig, make_forward)
from lwsnet_tpu_torch.data import png  # noqa: E402
from lwsnet_tpu_torch.inference import save_disparity_png  # noqa: E402
from test_torch_model import _span_check, setup  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ModelConfig(compute_dtype="float32")


def test_kernel_path_matches_jax(setup):  # noqa: F811
    jmodel, variables, model, left, right = setup
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        variables, jnp.asarray(left), jnp.asarray(right))
    got = make_forward(model, use_pallas=True, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    _span_check(got, want)


def test_stage_prefixes(setup):  # noqa: F811
    _, _, model, left, right = setup
    l, r = torch.from_numpy(left), torch.from_numpy(right)
    full = make_forward(model, num_stages=4, device="cpu")(l, r)
    for stages in (1, 2, 3):
        got = make_forward(model, num_stages=stages, device="cpu")(l, r)
        assert len(got) == stages
        for g, f in zip(got, full):
            torch.testing.assert_close(g, f, atol=1e-6, rtol=0)


def test_engine_answers_requests(setup, tmp_path):  # noqa: F811
    _, _, model, _, _ = setup
    engine = InferenceEngine(CFG, model.state_dict(), eval_height=64,
                             eval_width=96, device="cpu")
    answers = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        images = [rng.uniform(0, 1, (70, 100, 3)).astype(np.float32)
                  for _ in range(2)]
        l, r = engine.preprocess(*images)
        assert l.shape == (1, 64, 96, 3) and l.device.type == "cpu"
        outs = engine(l, r)
        assert len(outs) == 4
        for o in outs:
            assert o.shape == (1, 64, 96) and np.isfinite(o).all()
        answers.append(outs)
    assert not np.allclose(answers[0][3], answers[1][3])
    assert len(engine(l, r, num_stages=2)) == 2

    paths = []
    for i in range(2):
        img = np.random.default_rng(10 + i).integers(0, 256, (64, 96, 3))
        paths.append(str(tmp_path / f"{i}.png"))
        png.write_png(paths[-1], img.astype(np.uint8))
    disps, seconds = engine.infer_files(*paths, num_stages=3)
    assert len(disps) == 3 and seconds > 0
    assert all(d.shape == (64, 96) for d in disps)

    save_disparity_png(str(tmp_path / "c.png"), disps[-1])
    assert png.read_png(str(tmp_path / "c.png")).shape == (64, 96, 3)
    save_disparity_png(str(tmp_path / "k.png"), disps[-1], colormap=False)
    raw = png.read_png(str(tmp_path / "k.png"))
    assert raw.dtype == np.uint16
    np.testing.assert_array_equal(
        raw, (np.clip(disps[-1], 0, 255) * 256.0).astype(np.uint16))


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no card and no device given, nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        LWSNet(CFG)
    model = LWSNet(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        make_forward(model)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        InferenceEngine(CFG, model.state_dict())


def test_import_loads_no_jax():
    """Importing the port and every submodule loads no JAX module and
    nothing of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lwsnet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'lwsnet_tpu_torch.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'lwsnet_tpu')]\n"
        "print(len(names), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 15
    assert bad.strip() == "[]", bad
