"""The port against the JAX package at the shipped geometry, 368x1232.

`tests/torch_fixtures/` holds the JAX float32 module path's four stage
outputs at every 4th pixel, on three sets (the port's seed-0 network on a
standard-normal pair; the committed trained checkpoint on
`tools.parity.fixture_pair(0)` and on `tools.parity.wide_pair(0)`), and
both weight sets as the port's state dicts
(`tests/torch_parity_fixture.py` writes them). The card reads them there
(`chip_smoke.py` phase 10, `tools.parity --fixture`); here:

* the JAX reference regenerated from those weights equals the committed
  outputs (rtol 1e-5), and the committed weights are the port's seed-0
  network and the Orbax checkpoint bridged by `from_jax_variables`,
  exactly: a stale fixture fails here;
* the port's module path and kernel path (the kernels' plain versions on
  the CPU) meet the fixture at phase 10's float32 and bf16 bars on every
  set, and planted weight errors fail those bars;
* `tools.parity` and `tools.parity_kernels` run through `main` at 64x128.
"""

import json
import os

import numpy as np
import pytest
import torch

from lwsnet_tpu_torch import ModelConfig
from lwsnet_tpu_torch.data.png import write_png
from lwsnet_tpu_torch.tools import parity, parity_kernels

import torch_parity_fixture as fixture_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, parity.FIXTURE)


@pytest.fixture(scope="module")
def committed():
    """(the committed npz as a dict, the committed weight sets)."""
    fx = dict(np.load(NPZ))
    weights = torch.load(os.path.join(os.path.dirname(NPZ), parity.WEIGHTS),
                         weights_only=True)
    return fx, weights


def test_committed_weights_are_the_sets(committed):
    _, weights = committed
    assert sorted(weights) == sorted(set(parity.WEIGHTS_OF.values()))
    assert sorted(parity.WEIGHTS_OF) == sorted(parity.SETS)
    for name, want in (("random", fixture_lib.random_state_dict()),
                       ("trained", fixture_lib.trained_state_dict())):
        got = weights[name]
        assert sorted(got) == sorted(want), name
        for k, v in want.items():
            assert torch.equal(got[k], v), (name, k)


def test_fixture_matches_regenerated_jax(committed):
    fx, weights = committed
    _, arrays = fixture_lib.build(weights)
    assert sorted(arrays) == sorted(fx)
    assert int(fx["stride"]) == 4
    for key, want in arrays.items():
        got = fx[key]
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if key.endswith(tuple(f"stage{s}" for s in range(1, 5))):
            assert got.shape == (92, 308), key
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=key)


def test_wide_pair_spans_the_bins(committed):
    """`wide_pair`'s right view is its left shifted along the row by the
    row's disparity (170 px on the bottom row, where it is whole), and on
    each guarded set every JAX stage spans more than SPAN_GUARD of its bin
    range (46 / 8 / 4 / 4 px)."""
    left, right = parity.wide_pair(0)
    d = int(parity.WIDE_DISP[1])
    np.testing.assert_array_equal(right[-1, :-d], left[-1, d:])
    fx, _ = committed
    assert set(parity.GUARDED) == {"random", "trained_wide"}
    for name in parity.GUARDED:
        for s in range(1, 5):
            guard = parity.SPAN_GUARD * parity.bin_range_px(ModelConfig(), s)
            assert np.ptp(fx[f"{name}_stage{s}"]) > guard, (name, s)


@pytest.mark.parametrize("name", parity.SETS)
def test_port_paths_meet_fixture(name):
    """Both paths in float32 at phase 10's bars: mean |delta| < 0.1 % of
    the fixture stage's span, the kernel path's at most 1.1 x the module
    path's (or 0.01 % of span)."""
    cfg = ModelConfig(compute_dtype="float32")
    res = parity.check_fixture(NPZ, cfg, torch.device("cpu"),
                               sets=(name,))[name]
    for row in res["stages"]:
        for path in ("kernels", "module"):
            st = row[path]
            assert st["finite"], (row["stage"], path)
            assert st["mean_abs_delta"] < 1e-3 * row["fixture_span"], \
                (row["stage"], path, st)
        assert row["bars"]["mean"] and row["bars"]["kernel_vs_module"], row


def test_parity_tool_runs(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (64, 128, 3), dtype=np.uint8)
    left, right = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(left, img)
    write_png(right, np.roll(img, -5, axis=1))
    out = tmp_path / "parity.json"
    res = parity.main(["--left_img", left, "--right_img", right,
                       "--dtype", "float32", "--ckpt",
                       os.path.join(os.path.dirname(NPZ),
                                    parity.WEIGHTS) + ":trained",
                       "--device", "cpu", "--out", str(out)])
    written = json.loads(out.read_text())
    assert written["pass"] is True and res["pass"] is True
    assert [s["stage"] for s in written["stages"]] == [1, 2, 3, 4]
    assert all(s["finite"] and s["ok"] for s in written["stages"])


def test_parity_kernels_tool_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(parity_kernels, "H", 64)
    monkeypatch.setattr(parity_kernels, "W", 128)
    out = tmp_path / "parity_kernels.json"
    parity_kernels.main(["--device", "cpu", "--out", str(out)])
    written = json.loads(out.read_text())
    assert written["pass"] is True
    assert sorted({c["check"] for c in written["checks"]}) == [
        "costfilter_stage1", "costfilter_stage2", "costfilter_stage3",
        "refinement_residual"]
    assert sorted({c["dtype"] for c in written["checks"]}) == [
        "bfloat16", "float32"]


def plant_kernel_fault(monkeypatch, fault, scale):
    """Scale one layer's weights by `scale` on the kernel path alone:
    stage 2's third cost-filter layer ("stage2_filter") or the head's
    second pointwise conv ("refinement")."""
    from lwsnet_tpu_torch.models import lwsnet as L

    filt, refine = L.filter_soft_argmin, L.refine_residual

    def faulty_filter(cost, params, stats, **kw):
        if fault == "stage2_filter" and kw["start"] != 0 and \
                cost.shape[1] == 92:
            params = dict(params)
            params["BNReLUConv3D_2.weight"] = \
                params["BNReLUConv3D_2.weight"] * scale
        return filt(cost, params, stats, **kw)

    def faulty_refine(model, left, disp, **kw):
        w = model.RefinementHead_0.PreConvDW_1.Conv_0.weight
        s = scale if fault == "refinement" else 1.0
        with torch.no_grad():
            w.mul_(s)
        try:
            return refine(model, left, disp, **kw)
        finally:
            with torch.no_grad():
                w.div_(s)

    monkeypatch.setattr(L, "filter_soft_argmin", faulty_filter)
    monkeypatch.setattr(L, "refine_residual", faulty_refine)


@pytest.mark.parametrize("fault", ["stage2_filter", "refinement"])
def test_fixture_bars_catch_planted_faults(fault, monkeypatch):
    """A 1 % error in one layer's weights on the kernel path alone (stage
    2's third cost-filter layer, or the head's second pointwise conv)
    fails the float32 bars from the stage it enters on, on the trained
    set, while the module path stays within them."""
    plant_kernel_fault(monkeypatch, fault, 1.01)
    res = parity.check_fixture(NPZ, ModelConfig(compute_dtype="float32"),
                               torch.device("cpu"), sets=("trained",))
    stages = res["trained"]["stages"]
    first = 2 if fault == "stage2_filter" else 4
    for row in stages:
        assert row["module"]["mean_abs_delta"] < \
            1e-3 * row["fixture_span"], row["stage"]
        assert row["ok"] == (row["stage"] < first), (row["stage"],
                                                     row["bars"])
    assert not res["trained"]["pass"]


@pytest.mark.parametrize("name", parity.SETS)
def test_port_paths_meet_fixture_bf16(name):
    """Both paths in bf16 at phase 10's fixed bars: mean |delta| < 2 % of
    the fixture stage's span (4.55 % at random stage 4), the kernel
    path's at most 1.1 x the module path's (or 0.1 % of span), except on
    the sets of `parity.UNRATIOED`."""
    res = parity.check_fixture(NPZ, ModelConfig(compute_dtype="bfloat16"),
                               torch.device("cpu"), sets=(name,))[name]
    for row in res["stages"]:
        bar = parity.mean_bar("bfloat16", name, row["stage"])
        assert row["mean_bar_pct"] == 100.0 * bar
        for path in ("kernels", "module"):
            assert row[path]["mean_abs_delta"] < bar * row["fixture_span"], \
                (row["stage"], path, row[path])
        unheld = ("bfloat16", name) in parity.UNRATIOED
        assert (row["bars"]["kernel_vs_module"] is None) == unheld, row
        assert row["ok"], row
    assert res["pass"]


def test_wide_kernel_ratio_comes_from_the_stage1_entry_fold(monkeypatch):
    """On "trained_wide" the bf16 kernel path reads 1.15-1.21 x the module
    path's distance from JAX, over KERNEL_RATIO (`parity.UNRATIOED`). The
    cause is stage 1's entry, which folds the next BN scale into bf16
    weights: with those weights left in float32 on the kernel path alone
    (the activations still rounded to bf16, the output too), every stage
    comes within KERNEL_RATIO of the module path."""
    import torch.nn.functional as F
    from lwsnet_tpu_torch.models import lwsnet as L
    from lwsnet_tpu_torch.ops.cuda import costfilter as CF

    filt, entry = L.filter_soft_argmin, CF.conv3d_entry

    def float32_fold(cost, params, stats, **kw):
        if kw["start"] != 0:  # stages 2-3 as they are
            return filt(cost, params, stats, **kw)
        a1, _ = CF._fold_bn(params, stats, "BNReLUConv3D_1.BatchNorm_0")
        wt = params["BNReLUConv3D_0.weight"].float() * a1.view(-1, 1, 1, 1, 1)

        def entry32(vol, a0b0, _, shift):
            act = F.relu(vol.float() * a0b0[0] + a0b0[1]).to(vol.dtype)
            return CF.conv3d_bn_relu_plain(act.float()[:, None], wt,
                                           shift).to(vol.dtype)
        monkeypatch.setattr(CF, "conv3d_entry", entry32)
        try:
            return filt(cost, params, stats, **kw)
        finally:
            monkeypatch.setattr(CF, "conv3d_entry", entry)

    monkeypatch.setattr(L, "filter_soft_argmin", float32_fold)
    assert ("bfloat16", "trained_wide") in parity.UNRATIOED
    res = parity.check_fixture(NPZ, ModelConfig(compute_dtype="bfloat16"),
                               torch.device("cpu"),
                               sets=("trained_wide",))["trained_wide"]
    for row in res["stages"]:
        km = row["kernels"]["mean_abs_delta"]
        mm = row["module"]["mean_abs_delta"]
        assert km <= parity.KERNEL_RATIO * mm, (row["stage"], km / mm)


@pytest.mark.parametrize("fault", ["shared_refinement",
                                   "kernels_stage2_filter"])
def test_bf16_bars_catch_planted_faults(fault, monkeypatch):
    """The bf16 bars against a x1.05 error in one layer's weights. On
    both paths in the head's second pointwise conv, random set: stage 4
    fails its 4.55 % mean bar (both paths read 4.61-4.63 %, sound
    4.44-4.48 %). On the kernel path alone in stage 2's third filter
    layer, trained set: stage 2 fails the kernel path's 0.1 % floor
    (0.178 %, sound 0.069 %) and the later stages its 1.1 x ratio, while
    the module path stays within every bar."""
    cfg = ModelConfig(compute_dtype="bfloat16")
    if fault == "shared_refinement":
        key = "RefinementHead_0.PreConvDW_1.Conv_0.weight"
        build = parity.build_model

        def faulty_build(cfg, state_dict, device):
            state_dict = dict(state_dict)
            state_dict[key] = state_dict[key] * 1.05
            return build(cfg, state_dict, device)

        monkeypatch.setattr(parity, "build_model", faulty_build)
        name, first = "random", 4
    else:
        plant_kernel_fault(monkeypatch, "stage2_filter", 1.05)
        name, first = "trained", 2
    res = parity.check_fixture(NPZ, cfg, torch.device("cpu"),
                               sets=(name,))[name]
    for row in res["stages"]:
        assert row["ok"] == (row["stage"] < first), (row["stage"],
                                                     row["bars"])
        if fault == "shared_refinement" and row["stage"] == 4:
            assert row["bars"]["mean"] is False
            assert row["bars"]["kernel_vs_module"], row
        if fault == "kernels_stage2_filter":
            bar = parity.mean_bar("bfloat16", name, row["stage"])
            assert row["module"]["mean_abs_delta"] < \
                bar * row["fixture_span"], row["stage"]
            if row["stage"] >= first:
                assert row["bars"]["kernel_vs_module"] is False, row
    assert not res["pass"]
