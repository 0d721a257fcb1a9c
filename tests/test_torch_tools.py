"""The port's tools (`lwsnet_tpu_torch.tools`) on the CPU.

* `overfit_proof.synth_pair` equals the JAX tool's bit for bit from the
  same generator state;
* the microbenches' formulations match `torch.nn.functional` and
  `jax.lax` convolutions at their small shapes;
* a `torch.profiler` trace of a forward holds the four stage ranges on
  both paths (`LWSNet.forward`'s `record_function` ranges);
* every tool answers `--help`, and every timing tool raises on the CPU;
* `golden_pair_inference`, `scaling_sweep --cpu` and a miniature
  `overfit_proof` + `cpu_truth_eval` run on the CPU (the miniature at a
  reduced crop, set by the module's constants).
"""

import importlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward
from lwsnet_tpu_torch.data.png import write_png
from lwsnet_tpu_torch.tools import (aot_warm, cpu_truth_eval,
                                    golden_pair_inference, microbench_3d,
                                    microbench_refine, overfit_proof,
                                    profile_forward, scaling_sweep)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("aot_warm", "cpu_truth_eval", "golden_pair_inference",
         "bench", "microbench_3d", "microbench_refine", "overfit_diag",
         "overfit_proof", "parity", "parity_kernels", "parity_layers",
         "profile_forward", "scaling_sweep")
CPU = torch.device("cpu")


def _jax_tool(name):
    """A script of the JAX package's examples/ as a module (its top level
    imports numpy only)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_synth_pair_matches_jax():
    jtool = _jax_tool("overfit_proof")
    h, w, m = jtool.H, jtool.W, jtool.MARGIN
    assert (overfit_proof.H, overfit_proof.W, overfit_proof.MARGIN) == \
        (h, w, m)
    strip = np.random.default_rng(7).random((h, w + m, 3)).astype(np.float32)
    for amp in (3.0, 8.0):
        a, b = np.random.default_rng(11), np.random.default_rng(11)
        got = overfit_proof.synth_pair(strip, a, amp)
        want = jtool.synth_pair(strip, b, amp)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and np.array_equal(g, x)
        assert a.random() == b.random()  # the same draws were taken


def test_microbench_refine_formulations():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(microbench_refine.EQUIV_SHAPE).astype(np.float32)
    k = rng.standard_normal((x.shape[1], 1, 3, 3)).astype(np.float32)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    errs = microbench_refine.check_equivalence(CPU)
    assert all(e < microbench_refine.EQUIV_BAR for e in errs.values())
    for d in microbench_refine.EQUIV_DILATIONS:
        want = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x.transpose(0, 2, 3, 1)),
            jnp.asarray(k.transpose(2, 3, 1, 0)), (1, 1), [(d, d), (d, d)],
            rhs_dilation=(d, d), feature_group_count=x.shape[1],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST)).transpose(0, 3, 1, 2)
        for fn in (microbench_refine.dwconv, microbench_refine.dw_shiftadd):
            np.testing.assert_allclose(fn(xt, kt, d).numpy(), want,
                                       rtol=1e-4, atol=1e-4)
    k11 = rng.standard_normal((4, x.shape[1], 1, 1)).astype(np.float32)
    np.testing.assert_allclose(
        microbench_refine.conv(xt, torch.from_numpy(k11)).numpy(),
        np.einsum("bchw,oc->bohw", x, k11[:, :, 0, 0]), rtol=1e-4, atol=1e-4)


def test_microbench_3d_formulations():
    errs = microbench_3d.check_equivalence(CPU)
    assert all(e < microbench_3d.EQUIV_BAR for e in errs.values())
    rng = np.random.default_rng(1)
    x = rng.standard_normal(microbench_3d.SMALL).astype(np.float32)
    C = x.shape[1]
    k = rng.standard_normal((C, C, 3, 3, 3)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)),
        jnp.asarray(k.transpose(2, 3, 4, 1, 0)), (1, 1, 1), [(1, 1)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=jax.lax.Precision.HIGHEST)).transpose(0, 4, 1, 2, 3)
    for fn in microbench_3d.IMPLS.values():
        np.testing.assert_allclose(
            fn(torch.from_numpy(x), torch.from_numpy(k)).numpy(), want,
            rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kernels", [True, False])
def test_trace_has_stage_ranges(tmp_path, kernels):
    from torch.profiler import ProfilerActivity, profile

    model = LWSNet(ModelConfig(compute_dtype="float32"), device="cpu")
    fwd = make_forward(model, use_pallas=kernels, device="cpu")
    left, right = (torch.randn(1, 64, 128, 3) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fwd(left, right)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ranges = profile_forward.trace_ranges(path)
    assert sorted(ranges) == sorted(profile_forward.STAGE_RANGES)
    assert all(v == [] for v in ranges.values())  # no device kernels here


@pytest.mark.parametrize("name", TOOLS)
def test_tools_answer_help(name, capsys):
    tool = importlib.import_module(f"lwsnet_tpu_torch.tools.{name}")
    with pytest.raises(SystemExit) as e:
        tool.main(["--help"])
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out


@pytest.mark.parametrize("tool,argv", [
    (profile_forward, []), (microbench_refine, []), (microbench_3d, []),
    (scaling_sweep, ["--devices", "1"]), (aot_warm, [])])
def test_timing_tools_raise_on_cpu(tool, argv):
    """No card (and no nvcc for aot_warm): no host-clock fallback."""
    with pytest.raises(RuntimeError):
        tool.main(argv)


def test_golden_pair_inference_on_cpu(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (375, 1242, 3), dtype=np.uint8)
    left, right = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(left, img, compress_level=1)
    write_png(right, np.roll(img, -9, axis=1), compress_level=1)
    out = tmp_path / "out"
    res = golden_pair_inference.main(["--left", left, "--right", right,
                                      "--out", str(out), "--device", "cpu"])
    assert res["ok"]
    assert sorted(os.listdir(out)) == ["1.png", "2.png", "3.png", "4.png"]
    assert [st["shape"] for st in res["stages"]] == [[368, 1232]] * 4


def test_scaling_sweep_on_cpu(tmp_path):
    out = tmp_path / "sweep.json"
    scaling_sweep.main(["--cpu", "--devices", "1", "2", "--height", "64",
                        "--width", "128", "--per-device-batch", "1",
                        "--iters", "1", "--out", str(out)])
    got = json.loads(out.read_text())
    want = json.loads(open(os.path.join(REPO, "scaling_sweep.json")).read())
    assert set(want) <= set(got)
    assert got["backend"] == "cpu" and got["mode"] == "weak"
    assert [p["devices"] for p in got["points"]] == [1, 2]
    assert all(np.isfinite(p["step_ms"]) and p["step_ms"] > 0
               for p in got["points"])
    assert list(got["efficiency_pct"]) == ["2"]


@pytest.fixture
def one_thread():
    """torch on one thread: at these tiny shapes each op is a parallel
    region of microseconds, which the threads of other busy processes on
    the same cores stretch many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_overfit_proof_and_cpu_truth_eval_miniature(tmp_path, monkeypatch,
                                                    one_thread):
    monkeypatch.setattr(overfit_proof, "H", 32)
    monkeypatch.setattr(overfit_proof, "W", 64)
    rng = np.random.default_rng(5)
    src = str(tmp_path / "src.png")
    write_png(src, rng.integers(0, 256, (48, 160, 3), dtype=np.uint8))
    work, out = tmp_path / "work", tmp_path / "proof.json"
    res = overfit_proof.main([
        "--regimes", "kitti_mask", "sceneflow_mask", "--pairs", "4",
        "--epochs", "1", "--tail-epochs", "2", "--tail-seg-epochs", "1",
        "--batch", "2", "--tail-batch", "2", "--source", src,
        "--workdir", str(work), "--out", str(out), "--device", "cpu"])
    written = json.loads(out.read_text())
    assert [r["mask_regime"] for r in written["runs"]] == [
        "kitti_mask", "sceneflow_mask"]
    for run in written["runs"]:
        assert run["steps"] == 2 + 2 * 2  # phase A, then two segments
        assert len(run["tail_segment_bests_epe_px"]) == 2
        for key in ("initial_epe_px", "final_epe_px", "best_epe_px",
                    "first_loss", "last_loss"):
            assert np.isfinite(run[key]), key
    assert res["pass"] == overfit_proof.passed(written["runs"])
    truth = cpu_truth_eval.main(["--ckpt", written["runs"][0]["best_ckpt"],
                                 "--workdir", str(work), "--pairs", "4",
                                 "--device", "cpu",
                                 "--out", str(tmp_path / "truth.json")])
    assert truth["device"] == "cpu" and truth["pairs"] == 4
    assert np.isfinite(truth["cpu_f32_stage4_epe_px"])
    assert truth["per_pair_max"] >= truth["cpu_f32_stage4_epe_px"]
