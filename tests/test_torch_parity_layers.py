"""Every kernel launch of the forward against the module layer it replaces.

`lwsnet_tpu_torch.tools.parity_layers` at 64x128 (full widths) on the
CPU, where each kernel wrapper runs its plain version: under each engine,
in bf16 and float32, on both weight sets, every launch of the forward has
a module reference and meets its bar (chip_smoke.py phase 4's rule per
launch: mean |delta| from the float64 truth at most 1.1 x the module
reference's, float32 max at most 2 x, or the route's own bar in
`ROUTE_BARS`); the launches match `chip_smoke.want_counts`; recording
leaves the forward's outputs bit for bit; and a x1.01 weight error planted
in one route's first launch fails that launch and no other. The card runs
the same check at 368x1232 (`chip_smoke.py` phase 4b,
`tests/test_torch_gpu.py`).
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward
from lwsnet_tpu_torch.ops.cuda import build as kbuild
from lwsnet_tpu_torch.tools import parity_layers as PL
from lwsnet_tpu_torch.tools.parity import tf32_off

H, W = 64, 128
CPU = torch.device("cpu")
DTYPES = ("bfloat16", "float32")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module's many small convolutions: beside
    the other test workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sound():
    """{(set, dtype): check_set's result under every engine}."""
    with tf32_off():
        return {(s, d): PL.check_set(s, d, list(PL.ENGINES), H, W, CPU,
                                     log=lambda _: None)
                for s in PL.SETS for d in DTYPES}


@pytest.mark.parametrize("engine", list(PL.ENGINES))
def test_every_launch_has_a_reference(sound, engine):
    """Each engine's launches, each matched to a reference, are as many as
    the launch counts of `chip_smoke.want_counts` (a "[dual]" launch is one
    of its kernel's); the cost filters' launches are held under the first
    engine only."""
    want = chip_smoke.want_counts(engine, kbuild.launch_counts())
    for (s, d), runs in sound.items():
        res = runs[engine]
        assert res["launches"] == sum(
            v for k, v in want.items() if "[" not in k), (s, d)
        held = res["launches"] - (0 if engine == "mxu" else 18)
        assert res["held"] == len(res["rows"]) == held, (s, d)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("set_name", PL.SETS)
@pytest.mark.parametrize("engine", list(PL.ENGINES))
def test_sound_launches_meet_their_bar(sound, engine, set_name, dtype):
    rows = sound[(set_name, dtype)][engine]["rows"]
    assert rows
    for row in rows:
        mean_bar, max_bar = PL.bars(getattr(torch, dtype), row["route"])
        assert row["finite"], row
        assert row["mean_ratio"] <= mean_bar, row
        if dtype == "float32":
            assert row["max_ratio"] <= max_bar, row
        assert row["ok"], row


@pytest.mark.parametrize("dtype", DTYPES)
def test_filter_bars_hold_over_weight_draws(dtype):
    """The cost filters' launches meet their bars on eight seed-0-like
    networks (seeds 0-3, batch norms jittered from default_rng(3) and
    (5)) under "mxu": the 8-channel routes' own bars in `ROUTE_BARS` are
    set above these readings, which move with the weight draw."""
    left, right = PL.set_pair("seed0", H, W, CPU)
    for seed in range(4):
        for jitter in (3, 5):
            model = LWSNet(ModelConfig(compute_dtype=dtype), device=CPU,
                           seed=seed)
            PL.jitter_batchnorm(model, np.random.default_rng(jitter))
            with tf32_off():
                res = PL.run_engine(model, PL.float64_copy(model), left,
                                    right, "mxu", log=lambda _: None)
            rows = [r for r in res["rows"] if r["fn"] in PL.FILTER_FNS]
            assert len(rows) == 18
            for row in rows:
                assert row["ok"], (seed, jitter, row)


@pytest.mark.parametrize("engine", list(PL.ENGINES))
def test_recording_leaves_the_outputs_bit_for_bit(engine):
    for dtype in DTYPES:
        model = PL.build(engine, dtype, None, CPU)
        left, right = PL.set_pair("seed0", H, W, CPU)
        plain = make_forward(model, use_pallas=True, device=CPU)(left, right)
        rec = PL.run_engine(model, PL.float64_copy(model), left, right,
                            engine, log=lambda _: None)
        assert len(rec["outputs"]) == len(plain) == 4
        for a, b in zip(rec["outputs"], plain):
            assert torch.equal(a, b), (engine, dtype)


def test_launches_are_held_under_deterministic_cudnn(monkeypatch):
    """Each launch runs and is held with cuDNN's deterministic algorithms
    on (so its input reads the same in every run on the card), and the
    settings are as they were after."""
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    seen = []
    check = PL.Recorder.check

    def spy(self, *args):
        seen.append((cudnn.deterministic, cudnn.benchmark))
        return check(self, *args)

    monkeypatch.setattr(PL.Recorder, "check", spy)
    model = PL.build("mxu", "float32", None, CPU)
    left, right = PL.set_pair("seed0", H, W, CPU)
    PL.run_engine(model, PL.float64_copy(model), left, right, "mxu",
                  log=lambda _: None)
    assert seen and set(seen) == {(True, False)}
    assert (cudnn.deterministic, cudnn.benchmark) == before


def test_a_launch_without_reference_raises():
    """A launch the plan does not hold raises LookupError."""
    model = PL.build("mxu", "float32", None, CPU)
    left, right = PL.set_pair("seed0", H, W, CPU)
    plan = PL.filter_plan(model.cfg)[:-1]  # stage 3's last launch dropped
    rec = PL.Recorder(model, PL.float64_copy(model), plan, lambda _: False)
    with pytest.raises(LookupError, match="no reference"):
        with PL.recording(rec):
            make_forward(model, num_stages=3, use_pallas=True,
                         device=CPU)(left, right)


@pytest.mark.parametrize("route", list(PL.ROUTES))
def test_planted_route_fails_at_its_launch_only(route):
    """A x1.01 error in the weights of the route's first launch, on the
    kernel side, in bf16 on the seed-0 set: that launch misses its bar and
    every other launch meets it."""
    with tf32_off():
        res = PL.check_plant(route, H, W, CPU, log=lambda _: None)
    at = res["planted_at"]
    assert at is not None
    planted = [r for r in res["rows"] if r["planted"]]
    assert [r["index"] for r in planted] == [at]
    assert planted[0]["route"] == route and not planted[0]["ok"]
    assert res["missed"] == [at] and res["caught"]


def test_tool_main_writes_its_verdict(tmp_path):
    out = tmp_path / "layers.json"
    res = PL.main(["--device", "cpu", "--height", str(H), "--width", str(W),
                   "--plant", "chain-head", "--out", str(out)])
    written = json.loads(out.read_text())
    assert res["pass"] is True and written["pass"] is True
    assert written["plant"]["missed"] == [19]


@pytest.fixture(scope="module")
def anynet_sound():
    """{dtype: check_set's result under "mxu"} at AnyNet's cost-filter
    settings (`PL.ANYNET`, the seed-0 set)."""
    with tf32_off():
        return {d: PL.check_set("seed0", d, ["mxu"], H, W, CPU,
                                log=lambda _: None, fields=PL.ANYNET)["mxu"]
                for d in DTYPES}


@pytest.mark.parametrize("dtype", DTYPES)
def test_anynet_launches_meet_their_bar(anynet_sound, dtype):
    """At AnyNet's settings every launch has a reference of its own width
    (routes cf-entry-16, cf-16, skip-16, cf-entry-4, cf-4, skip-4), on
    the card on the tensor cores in bf16 and on the CUDA cores in
    float32, and meets its bar; in bf16
    the fused last layers read their exact reference (the kernel's own
    arithmetic) to within the order of the sums."""
    res = anynet_sound[dtype]
    assert res["launches"] == res["held"] == 29
    routes = [r["route"] for r in res["rows"][:18]]
    assert routes == (["cf-entry-16"] + ["cf-16"] * 4 + ["skip-16"]
                      + (["cf-entry-4"] + ["cf-4"] * 4 + ["skip-4"]) * 2)
    # each on its route on the card (`filter_routes`): in bf16 every
    # launch of the three filters on the tensor cores
    tc = "tensor cores" if dtype == "bfloat16" else "CUDA cores"
    assert [r["kernel_route"] for r in res["rows"][:18]] == [tc] * 18
    for row in res["rows"]:
        assert row["ok"], row
        if dtype == "bfloat16" and row["route"].startswith("skip"):
            assert abs(row["exact_ratio"] - 1) < 1e-3, row
        else:
            assert "exact_ratio" not in row


@pytest.mark.parametrize("route", ["cf-4", "skip-4"])
def test_planted_anynet_route_fails_at_its_launch_only(route, tmp_path):
    """A x1.01 error in the weights of the first launch of a route that
    only AnyNet's settings run, through the tool's flags: that launch
    misses its bar and no other (`skip-4` by its exact reference: its
    module reference rounds the cost to bf16, which hides the fault)."""
    out = tmp_path / "layers.json"
    res = PL.main(["--device", "cpu", "--height", str(H), "--width", str(W),
                   "--plant", route, "--out", str(out), "--maxdisplist",
                   "12", "3", "3", "--channels_3d", "4", "--layers_3d", "4",
                   "--growth_rate", "4", "1", "1"])
    assert res["pass"] is True and res["config"] == PL.ANYNET
    plant = res["plant"]
    at = plant["planted_at"]
    assert at == {"cf-4": 7, "skip-4": 11}[route]
    assert plant["missed"] == [at]
    row = next(r for r in plant["rows"] if r["index"] == at)
    if route == "skip-4":
        assert row["mean_ratio"] <= 1.1 < row["exact_ratio"]
