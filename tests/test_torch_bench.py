"""The port's bench (`lwsnet_tpu_torch.tools.bench`) on the CPU.

* without a card it raises, and writes no detail;
* its inputs, baselines and recipe step counts are the JAX bench's
  (`bench.py` at the repository root, loaded as a file: its top level
  imports numpy only), and its analytic FLOP count is the JAX package's;
* its timing logic, under a scripted timer and clock passed in as
  arguments: the loop sizing, the cheap and skip rules of the budget, the
  two-round monotonicity fixed point with violations recorded from the
  final times, the module path and the train-step projections.
"""

import importlib.util
import inspect
import math
import os

import numpy as np
import pytest

from lwsnet_tpu_torch import ModelConfig
from lwsnet_tpu_torch.tools import bench
from lwsnet_tpu_torch.utils.flops import forward_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Script:
    """A timer: each call to fn takes the next of its scripted seconds a
    call (the last repeats) and moves the clock on by `cost[fn]` seconds
    (default: the calls' own time, warm-up included)."""

    def __init__(self, clock, secs, cost=None):
        self.clock, self.secs, self.cost = clock, dict(secs), cost or {}
        self.calls = []

    def __call__(self, fn, iters, repeats):
        self.calls.append((fn, iters, repeats))
        seq = self.secs[fn]
        sec = seq.pop(0) if len(seq) > 1 else seq[0]
        self.clock.t += self.cost.get(fn, (3 + iters * repeats) * sec)
        return sec

    def of(self, fn):
        return [c[1:] for c in self.calls if c[0] == fn]


def _stages(clock, secs, budget_s=1000.0, cost=None, peak=1e12):
    timer = Script(clock, {f"s{k}": v for k, v in secs.items()}, cost)
    detail = {}
    stage_sec = bench.time_forwards(lambda k: f"s{k}", timer,
                                    bench.Budget(budget_s, 0.0, clock),
                                    detail, 2e9, peak)
    return timer, detail, stage_sec


def test_raises_without_a_card(tmp_path):
    path = tmp_path / "detail.json"
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--detail", str(path)])
    assert not path.exists()


def test_inputs_and_baselines_are_the_jax_bench(jbench):
    assert (bench.BASELINE_FPS, bench.BASELINE_PRETRAIN_H,
            bench.BASELINE_FINETUNE_H) == (
        jbench.BASELINE_FPS, jbench.BASELINE_PRETRAIN_H,
        jbench.BASELINE_FINETUNE_H) == (10.0, 18.0, 2.8)
    src = inspect.getsource(jbench.main)
    assert f"h, w, batch = {bench.H}, {bench.W}, {bench.BATCH}" in src
    assert "rng = np.random.default_rng(0)" in src
    assert f"th, tw = {bench.TRAIN_H}, {bench.TRAIN_W}" in src
    rng = np.random.default_rng(0)
    # bench.py:114-116, then the first recipe's batch (bench.py:234-238)
    want = [np.asarray(rng.standard_normal((1, 368, 1232, 3)), np.float32)
            for _ in range(2)]
    want += [np.asarray(rng.standard_normal((8, 256, 512, 3)), np.float32)
             for _ in range(2)]
    want.append(np.asarray(rng.uniform(1.0, 100.0, (8, 256, 512)),
                           np.float32))
    rng = np.random.default_rng(0)
    got = list(bench.inputs(rng)) + list(bench.train_inputs(rng, 8))
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)
    assert bench.METRIC != "4stage_inference_fps_368x1232"


def test_recipe_step_counts():
    assert [(n, b, s) for n, b, s, _ in bench.RECIPES] == [
        ("pretrain", 8, 44310), ("finetune", 4, 12000)]
    assert [h for *_, h in bench.RECIPES] == [18.0, 2.8]


def test_forward_flops_are_the_jax_count():
    from lwsnet_tpu import ModelConfig as JConfig
    from lwsnet_tpu.utils.flops import forward_flops as jflops
    for k in (1, 2, 3, 4):
        assert forward_flops(ModelConfig(), 368, 1232, 1, k) == jflops(
            JConfig(), 368, 1232, batch=1, num_stages=k)
    assert bench.PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989e12


@pytest.mark.parametrize("sec,min_loop_s,cheap,calls", [
    (0.003, 0.25, False, [(10, 3), (84, 3)]),
    (0.003, 0.5, False, [(10, 3), (167, 3)]),
    (0.03, 0.25, False, [(10, 3)]),
    (0.003, 0.25, True, [(16, 1)]),
])
def test_loop_sizing(sec, min_loop_s, cheap, calls):
    timer = Script(Clock(), {"f": [sec]})
    assert bench.measure("f", timer, min_loop_s, cheap) == sec
    assert timer.of("f") == calls


def test_ample_budget_measures_every_stage():
    timer, detail, stage_sec = _stages(
        Clock(), {1: [0.05], 2: [0.06], 3: [0.07], 4: [0.08]})
    assert [c[0] for c in timer.calls] == ["s4", "s1", "s2", "s3"]
    assert detail["per_stage_monotonicity"] == "ok"
    assert {k: detail[f"stage{k}_fps"] for k in (1, 2, 3, 4)} == {
        1: 20.0, 2: 16.67, 3: 14.29, 4: 12.5}
    assert detail["mfu_pct"] == round(100 * 2e9 / 0.08 / 1e12, 3)
    assert detail["stage_ms"] == {k: 1e3 * stage_sec[k] for k in stage_sec}
    assert not [k for k in detail if "note" in k or "skipped" in k]


def test_no_peak_gives_no_mfu():
    _, detail, _ = _stages(Clock(), {k: [0.05 * k] for k in (1, 2, 3, 4)},
                           peak=None)
    assert "mfu_pct" not in detail and detail["stage4_fps"] == 5.0


def test_monotonicity_reaches_its_fixed_point_in_two_rounds():
    """Round 1 finds stage 3 under stage 2 and measures both again; the
    new stage 2 falls under stage 1, so round 2 measures 1 and 2 again,
    at the longer loop; the final times agree."""
    timer, detail, stage_sec = _stages(Clock(), {
        1: [0.07, 0.055], 2: [0.12, 0.06, 0.08], 3: [0.11, 0.115],
        4: [0.15]})
    assert [c[0] for c in timer.calls] == [
        "s4", "s1", "s2", "s3", "s2", "s3", "s1", "s2"]
    assert timer.of("s2")[1:] == [(10, 3), (10, 3)]  # 0.5 s at 10 calls
    assert detail["per_stage_monotonicity"] == "ok"
    assert stage_sec == {1: 0.055, 2: 0.08, 3: 0.115, 4: 0.15}


def test_persistent_violation_is_recorded_not_raised():
    timer, detail, _ = _stages(Clock(), {
        1: [0.05], 2: [0.09], 3: [0.08], 4: [0.10]})
    assert [c[0] for c in timer.calls].count("s3") == 3  # two rounds
    assert detail["per_stage_monotonicity"] == [
        "stage3 faster than stage2"]


def test_remeasured_stage4_updates_the_headline():
    _, detail, _ = _stages(Clock(), {1: [0.05], 2: [0.06], 3: [0.08],
                                     4: [0.07, 0.10]})
    assert detail["per_stage_monotonicity"] == "ok"
    assert detail["stage4_fps"] == 10.0
    assert detail["mfu_pct"] == round(100 * 2e9 / 0.10 / 1e12, 3)


def test_tight_budget_degrades_then_skips():
    """100 s: the headline leaves 55 s, so stages 1 and 2 take the cheap
    estimate (20 s each), stage 3 is skipped at 15 s left, no stage is
    measured again, and the module path and train steps are skipped."""
    clock = Clock()
    timer, detail, _ = _stages(clock, {1: [0.03], 2: [0.05], 3: [0.04],
                                       4: [0.06]}, budget_s=100.0,
                               cost={"s4": 45.0, "s1": 20.0, "s2": 20.0})
    assert timer.calls == [("s4", 10, 3), ("s1", 16, 1), ("s2", 16, 1)]
    assert detail["stage1_note"] == detail["stage2_note"] == \
        "single-loop low-budget estimate"
    assert "stage3_fps" not in detail and "stage3_skipped" in detail
    assert detail["per_stage_monotonicity"] == "ok"
    budget = bench.Budget(100.0, 0.0, clock)
    bench.time_module_path("m", timer, budget, detail)
    bench.time_train(lambda b: pytest.fail("no train step"), timer, budget,
                     detail)
    assert "module_path_skipped" in detail
    assert "train_step_skipped" in detail


def test_module_path_cheap_under_60s():
    clock = Clock()
    timer, detail = Script(clock, {"m": [0.02]}), {}
    bench.time_module_path("m", timer, bench.Budget(50.0, 0.0, clock),
                           detail)
    assert timer.calls == [("m", 16, 1)]
    assert detail["stage4_fps_no_pallas"] == 50.0
    assert "stage4_no_pallas_note" in detail


def test_train_steps_project_the_recipes(monkeypatch):
    monkeypatch.delenv("BENCH_SKIP_TRAIN", raising=False)
    clock, made = Clock(), []
    timer = Script(clock, {8: [0.15], 4: [0.1]})
    detail = {}
    bench.time_train(lambda b: made.append(b) or b, timer,
                     bench.Budget(1000.0, 0.0, clock), detail)
    assert made == [8, 4] and timer.calls == [(8, 10, 3), (4, 10, 3)]
    assert detail["train_step_ms_256x512_b8"] == 150.0
    assert detail["train_step_ms_256x512_b4"] == 100.0
    for name, sec, steps, base in (("pretrain", 0.15, 44310, 18.0),
                                   ("finetune", 0.1, 12000, 2.8)):
        hours = steps * sec / 3600
        assert detail[f"{name}_projection_h"] == round(hours, 2)
        assert detail[f"{name}_projection_vs_baseline"] == round(
            base / hours, 1)
    assert not [k for k in detail if "note" in k or "skipped" in k]


def test_train_steps_cheap_then_skipped(monkeypatch):
    """65 s left: the pretrain step takes the cheap estimate (under 70 s),
    which leaves 20 s, under the 25 s the finetune step needs."""
    monkeypatch.delenv("BENCH_SKIP_TRAIN", raising=False)
    clock, made = Clock(), []
    timer = Script(clock, {8: [0.15]}, cost={8: 45.0})
    detail = {}
    bench.time_train(lambda b: made.append(b) or b, timer,
                     bench.Budget(65.0, 0.0, clock), detail)
    assert made == [8] and timer.calls == [(8, 16, 1)]
    assert "pretrain_step_note" in detail
    assert "finetune_step_skipped" in detail
    assert math.isclose(detail["pretrain_projection_h"],
                        round(44310 * 0.15 / 3600, 2))


def test_skip_train_from_the_environment(monkeypatch):
    monkeypatch.setenv("BENCH_SKIP_TRAIN", "1")
    detail = {}
    bench.time_train(lambda b: pytest.fail("no train step"),
                     Script(Clock(), {}), bench.Budget(1000.0, 0.0, Clock()),
                     detail)
    assert detail == {"train_step_skipped": "budget or BENCH_SKIP_TRAIN"}


def test_busy_ms_is_the_union_of_kernel_intervals():
    from lwsnet_tpu_torch.utils.timing import busy_ms
    spans = [(0.0, 1000.0, "a"), (500.0, 1500.0, "b"), (3000.0, 3500.0, "c"),
             (3100.0, 3200.0, "d")]
    assert busy_ms(spans, 2) == (1500.0 + 500.0) / 2 / 1e3
    assert busy_ms([], 5) == 0.0
