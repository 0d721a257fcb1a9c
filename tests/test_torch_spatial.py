"""Row-sharded (data x spatial) training of the port on the CPU.

Gloo processes (`lwsnet_tpu_torch.tools.dryrun_ddp.spawn`, laid out by
`MeshConfig(spatial_parallel=2)`) each hold their rows of every image of
their data slice, at 64x128 in float32 with the full-width model, the
pretrain recipe's loss and the weights JAX's `create_train_state` draws.
They are held against:

* the port's single-process step on the whole batch, at 1x2 (batch 2)
  and 2x2 (batch 4), with 49 halo exchanges forward and 47 backward: the
  bars of tests/test_torch_distributed.py (loss rel 1e-5, BN statistics
  rtol 1e-4 / atol 1e-6, each gradient tensor's cosine >= 0.9999), all
  of them in float64 compute (`ModelConfig(compute_dtype="float64")`),
  loss and statistics in float32. At this geometry the float32 gradient
  moves past the tensor bar with the order of summation alone: the
  accepted data-parallel split of the same batch (`dryrun_ddp.run_step`
  at spatial 1) reads 36 of 128 tensors under 0.9999 at 2 processes
  (least 0.99837) and 7 of 122 at 4 (least 0.99937), where the row
  shards read 1 of 128 (least 0.99990) and 1 of 122 (0.99974); in
  float64 both splits agree with one process to 1e-14;
* JAX's train step on a 2x2 CPU mesh (`spatial_parallel=2`, GSPMD's
  halos), from the same state: the data-parallel slice's JAX bars;
* at 1x4 on 32x64 images (shards of 8 rows, 1 at 1/8 resolution; the
  towers' dilation-16 halos come from two shards away), in float64
  compute with float64 ground truth: the eval step's EPE and D1 sums on
  the initial weights and then the train step, against one process:
  loss rel <= 1e-12, every gradient tensor's cosine >= 1 - 1e-10, the
  sums rel <= 1e-12, and as many halo exchanges as
  `LWSNet.halo_exchanges()` says (readings: loss rel 0.0, least cosine
  1 - 1.5e-14, EPE 1.5e-16, D1 0.0);
* at 88 rows, shards of 48 and 40 rows: the BN statistics of the single
  process (batch norm sums over unequal shards);
* a `Trainer(mesh_cfg=MeshConfig(spatial_parallel=2))` epoch: its train
  step's loss and gradient norm against the single-process Trainer's, its
  exact precise BN against the single process's on the same trained
  weights, and its SceneFlow eval (544-row images, 540-row ground truth,
  `sceneflow_row_offset=4`, which falls in the top shard only) against
  the single process's and JAX's eval step on the same weights: EPE sums
  rtol 1e-5, D1 sums within 1e-2 (a few pixels at the 3 px threshold),
  weight 2, not 4.

The batch's top and bottom rows differ in their image statistics and
mask counts. Two planted faults miss their bars (tests/
torch_spatial_child.py). Readings (torch 2.13, this geometry): 1x2
against one process, float32 loss rel 0.0, BN statistics 0.104 of the
bar, whole gradient cosine 1 - 1.0e-5; float64 least tensor cosine
1 - 1.3e-14; 2x2, float32 loss rel 0.0, statistics 0.087, whole
1 - 9.4e-6; float64 least 1 - 1.2e-14; 48/40 shards, loss rel 1.1e-7,
statistics 0.117 of the bar. Against the JAX 2x2 mesh: loss rel 0.0,
grad_norm 5.9e-4, cosine 1 - 1.4e-5 whole and 0.99984 least; its eval
sums within 7e-8 (EPE) and equal (D1). Zero halos at the seams: loss
rel 0.114, statistics 3.0e4 of the bar, 125 of 128 tensors under 0.9999
(least -0.93). Per-shard EPE division: the headline EPE 0.028 off the
single process's (bar 1e-5). The Trainer's train step: loss rel 0.0,
grad_norm 7.5e-4 (bar 2e-3, the data-parallel slice's JAX bar).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import torch_spatial_child as child  # noqa: E402
from lwsnet_tpu import LWSNet as JLWSNet  # noqa: E402
from lwsnet_tpu import MeshConfig as JMeshConfig  # noqa: E402
from lwsnet_tpu import ModelConfig as JConfig  # noqa: E402
from lwsnet_tpu import TrainConfig as JTrainConfig  # noqa: E402
from lwsnet_tpu.training.state import create_train_state as jcreate  # noqa
from lwsnet_tpu.training.steps import make_eval_step as jeval  # noqa: E402
from lwsnet_tpu_torch import LWSNet, ModelConfig  # noqa: E402
from lwsnet_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                      to_jax_variables)
from lwsnet_tpu_torch.tools import dryrun_ddp  # noqa: E402
from lwsnet_tpu_torch.utils import timing  # noqa: E402
from test_torch_distributed import (KW, _against_single,  # noqa: E402
                                    _meets_single_bars,
                                    check_against_jax_mesh)

H, W = 64, 128
EVAL_H, EVAL_W, GT_H = 544, 64, 540
TIMEOUT = 180.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(rng, b, h, w):
    """Images whose bottom half has other statistics than the top, and
    ground truth whose bottom half lies mostly past the mask's 192."""
    l, r = (rng.standard_normal((b, h, w, 3)).astype(np.float32)
            for _ in range(2))
    l[:, h // 2:] = 2.0 * l[:, h // 2:] + 0.5
    r[:, h // 2:] = 2.0 * r[:, h // 2:] + 0.5
    g = rng.uniform(1.0, 100.0, (b, h, w)).astype(np.float32)
    g[:, h // 2:][rng.uniform(size=(b, h - h // 2, w)) < 0.6] = 300.0
    return l, r, g


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's initial state, bridged to a state-dict file, and the data:
    batches of 4 at 64 rows and 2 at 88, and a SceneFlow eval batch."""
    tmp = tmp_path_factory.mktemp("spatial")
    jstate = jcreate(JLWSNet(JConfig(compute_dtype="float32")),
                     JTrainConfig(**KW), jax.random.PRNGKey(0), (H, W),
                     steps_per_epoch=1)
    sd = from_jax_variables({"params": jstate.params,
                             "batch_stats": jstate.batch_stats})
    path = str(tmp / "state.pt")
    torch.save(sd, path)
    rng = np.random.default_rng(12)
    l4, r4, g4 = _images(rng, 4, H, W)
    l88, r88, g88 = _images(rng, 2, 88, W)
    el, er, _ = _images(rng, 2, EVAL_H, EVAL_W)
    eg = rng.uniform(1.0, 60.0, (2, GT_H, EVAL_W)).astype(np.float32)
    eg[rng.uniform(size=eg.shape) < 0.2] = 250.0
    rng32 = np.random.default_rng(32)
    l32, r32, g32 = _images(rng32, 2, 32, 64)
    el32, er32, eg32 = _images(rng32, 2, 32, 64)
    data = dict(l=l4[:2], r=r4[:2], g=g4[:2], l88=l88, r88=r88, g88=g88,
                el=el, er=er, eg=eg, ev=np.ones(2, np.float32),
                l32=l32, r32=r32, g32=g32, el32=el32, er32=er32,
                eg32=eg32.astype(np.float64))  # float64 metric sums
    data_path = str(tmp / "data.npz")
    np.savez(data_path, **data)
    return dict(jstate=jstate, sd=sd, path=path, data=data,
                data_path=data_path, batch4={"l": l4, "r": r4, "g": g4},
                tmp=tmp)


@pytest.fixture(scope="module")
def one_by_two(setup):
    """Rank 0's and rank 1's records of `child.spatial_child` at 1x2."""
    tmp = setup["tmp"]
    dryrun_ddp.spawn(child.spatial_child, 2,
                     (setup["path"], setup["data_path"], KW, str(tmp)),
                     TIMEOUT, str(tmp), spatial=2)
    return [torch.load(str(tmp / f"spatial{r}.pt"), weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def two_by_two(setup):
    """Each process's {dtype: record} of one step at 2x2 on batch 4."""
    return dryrun_ddp.run_step(4, setup["batch4"], setup["path"], KW,
                               TIMEOUT, str(setup["tmp"]),
                               target=child.steps_child, spatial=2)


@pytest.fixture(scope="module")
def one_by_four(setup):
    """Each process's record of `child.quad_child` at 1x4 (32 rows)."""
    tmp = setup["tmp"]
    dryrun_ddp.spawn(child.quad_child, 4,
                     (setup["path"], setup["data_path"], KW, str(tmp)),
                     TIMEOUT, str(tmp), spatial=4)
    return [torch.load(str(tmp / f"quad{r}.pt"), weights_only=False)
            for r in range(4)]


@pytest.fixture(scope="module")
def single(setup):
    """The single-process step on a named batch, in a dtype, once."""
    d, done = setup["data"], {}
    batches = {"b2": {k: d[k] for k in "lrg"}, "b4": setup["batch4"],
               "b88": {k: d[k + "88"] for k in "lrg"}}

    def get(name, dtype="float32"):
        if (name, dtype) not in done:
            done[name, dtype] = child.step_record(
                setup["path"], batches[name], KW, dtype)
        return done[name, dtype]

    return get


def _check_step(records, single, dtype, what):
    """Every process's step equal; the halo, batch-norm and step
    collectives counted; the single-process bars (all of them in float64,
    loss and statistics in float32)."""
    for rec in records[1:]:
        for key in ("grads", "params", "buffers"):
            for n, t in rec[key].items():
                assert torch.equal(t, records[0][key][n]), (key, n)
    n_bn = sum(1 for n in single["buffers"] if n.endswith("mean"))
    halo = LWSNet(ModelConfig(compute_dtype=dtype), device="cpu"
                  ).halo_exchanges()
    assert records[0]["counts"] == {
        "halo": halo["forward"] + halo["backward"], "batch_norm": n_bn,
        "loss_count": 1, "gradients": 1, "loss": 1}
    r = _against_single(records[0], single)
    print(what, dtype, "vs one process:", r)
    assert r["loss"] <= 1e-5 and r["stats"] <= 1.0, r
    if dtype == "float64":
        assert _meets_single_bars(r), r


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_one_by_two_step_matches_single_process(one_by_two, single, dtype):
    key = {"float32": "step", "float64": "step64"}[dtype]
    _check_step([r[key] for r in one_by_two], single("b2", dtype), dtype,
                "1x2")


def test_one_by_four_step_and_eval_match_single_process(setup, one_by_four):
    """4 shards of 8 rows, whose dilation-16 towers read two shards away:
    the float64 step and eval equal one process's."""
    d = setup["data"]
    want = child.step_record(
        setup["path"], {k: d[k + "32"] for k in "lrg"}, KW, "float64",
        {k: d["e" + k + "32"] for k in "lrg"})
    for rec in one_by_four[1:]:
        for key in ("grads", "params", "buffers", "eval"):
            for n, t in rec[key].items():
                assert torch.equal(t, one_by_four[0][key][n]), (key, n)
    got = one_by_four[0]
    halo = LWSNet(ModelConfig(compute_dtype="float64"), device="cpu"
                  ).halo_exchanges()
    assert got["counts"]["halo"] == halo["forward"] + halo["backward"]
    loss = abs(float(got["aux"]["loss"]) / float(want["aux"]["loss"]) - 1)
    cos = {n: float((a.double() * want["grads"][n].double()).sum()
                    / (a.double().norm() * want["grads"][n].double().norm()))
           for n, a in got["grads"].items()}
    evals = {k: float(((got["eval"][k] - want["eval"][k]).abs()
                       / want["eval"][k].abs()).max()) for k in ("epe", "d1")}
    print("1x4 vs one process: loss rel", loss, "least cosine 1 -",
          1 - min(cos.values()), "eval rel", evals)
    assert loss <= 1e-12
    assert min(cos.values()) >= 1 - 1e-10, min(cos, key=cos.get)
    assert max(evals.values()) <= 1e-12, evals
    assert float(got["eval"]["weight"]) == 2.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_two_by_two_step_matches_single_process(two_by_two, single, dtype):
    _check_step([r[dtype] for r in two_by_two], single("b4", dtype), dtype,
                "2x2")


def test_two_by_two_step_matches_jax_spatial_mesh(setup, two_by_two):
    check_against_jax_mesh(setup["jstate"], setup["batch4"],
                           two_by_two[0]["float32"],
                           JMeshConfig(spatial_parallel=2), 4)


def test_unequal_shards_give_global_batch_norm(one_by_two, single):
    """88 rows split 48/40: the statistics of the whole batch."""
    r0 = one_by_two[0]
    assert r0["rows"] == (0, 48) and one_by_two[1]["rows"] == (48, 88)
    r = _against_single(r0["step88"], single("b88"))
    print("48/40 shards vs one process:", r)
    assert r["stats"] <= 1.0 and r["loss"] <= 1e-5, r


def test_planted_zero_halo_misses_the_bars(one_by_two, single):
    r = _against_single(one_by_two[0]["zero_halo"], single("b2"))
    print("zero halos:", r)
    assert not _meets_single_bars(r), r


@pytest.fixture(scope="module")
def single_fit(setup, one_by_two):
    """The single-process Trainer: its train step from the same state,
    then precise BN and the eval from the sharded run's trained
    weights."""
    t = child.trainer(setup["path"], setup["data"])
    t.train_epoch(0)
    history = t.history
    t.state.model.load_state_dict(one_by_two[0]["fit"]["trained"])
    t.history = []
    t.train_epoch = lambda epoch: None
    return dict(child.fit_record(t), history=history)


def test_trainer_trains_and_stat_steps_like_one_process(one_by_two,
                                                        single_fit):
    got, want = one_by_two[0]["fit"], single_fit
    assert one_by_two[1]["fit"]["history"] == got["history"]
    (a,), (b,) = got["history"], want["history"]
    assert abs(a["loss"] / b["loss"] - 1.0) <= 1e-5, (a, b)
    assert abs(a["grad_norm"] / b["grad_norm"] - 1.0) <= 2e-3, (a, b)
    for n, t in got["state"].items():
        if "running" in n:
            torch.testing.assert_close(t, want["state"][n], rtol=1e-4,
                                       atol=1e-6, msg=n)


def test_sceneflow_eval_matches_one_process_and_jax(one_by_two,
                                                    single_fit, setup):
    got = one_by_two[0]["fit"]
    assert float(got["sums"]["weight"]) == 2.0
    for k in ("epe", "d1", "weight"):
        assert torch.equal(got["sums"][k], one_by_two[1]["fit"]["sums"][k])
    want = single_fit["sums"]
    np.testing.assert_allclose(got["sums"]["epe"], want["epe"], rtol=1e-5)
    np.testing.assert_allclose(got["sums"]["d1"], want["d1"], atol=1e-2)
    assert abs(got["epe"] / single_fit["epe"] - 1.0) <= 1e-5
    d = setup["data"]
    variables = to_jax_variables(got["state"])
    step = jax.jit(jeval(JLWSNet(JConfig(compute_dtype="float32")),
                         max_disp=192.0, sceneflow_row_offset=4))
    jstate = setup["jstate"].replace(params=variables["params"],
                                     batch_stats=variables["batch_stats"])
    out = step(jstate, d["el"], d["er"], d["eg"], d["ev"])
    print("eval sums: sharded", {k: v.tolist() for k, v in
                                 got["sums"].items()},
          "JAX", {k: np.asarray(v).tolist() for k, v in out.items()})
    np.testing.assert_allclose(got["sums"]["epe"], np.asarray(out["epe"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["sums"]["d1"], np.asarray(out["d1"]),
                               atol=1e-2)
    assert float(out["weight"]) == 2.0


def test_planted_shard_epe_misses_the_bar(one_by_two, single_fit):
    gap = abs(one_by_two[0]["shard_epe"] / single_fit["epe"] - 1.0)
    print("per-shard EPE division: EPE rel", gap)
    assert gap > 1e-5


def test_dryrun_tool_spatial():
    """`python -m lwsnet_tpu_torch.tools.dryrun_ddp --processes 4
    --spatial 2`: the 2x2 loss within 1e-2 of the data-parallel one."""
    out = dryrun_ddp.main(["--processes", "4", "--spatial", "2", "--device",
                           "cpu"])
    assert out["spatial_gap"] < 1e-2


# --- chip_smoke.py phase 13's layouts, over gloo at 32x64 -------------------
# `dryrun_ddp.layout_child` and `layout_failures`, which phase 13 runs one
# process a card under NCCL at 256x512 (eval 368x1232), here on the CPU.
LAYOUT_HW = (32, 64)


@pytest.fixture(scope="module")
def layout_work(tmp_path_factory):
    """Phase 13's weights (seeded, jittered batch norms), its data at
    32x64 for batches 2 and 4, the one process's record at each batch
    (at batch 2 with the float32 step and eval that phase 11 adds), and
    the layouts' records as the tests run them."""
    work = str(tmp_path_factory.mktemp("layouts"))
    halo, n_bn = dryrun_ddp.write_layout_weights(work)
    single = {}
    for b in (2, 4):
        dryrun_ddp.write_layout_data(os.path.join(work, f"b{b}.npz"), b,
                                     LAYOUT_HW, LAYOUT_HW)
        dryrun_ddp.layout_child(0, 1, work, f"b{b}", float32=b == 2)
        single[b] = dryrun_ddp.layout_records(work, f"b{b}", 1)[0]
    return dict(work=work, single=single, halo=halo, n_bn=n_bn, records={})


def _layout(layout_work, dp, sp):
    """(records, one process's record) of layout dp x sp, run once; 1 x 2
    with phase 11's float32 step and eval."""
    b = chip_smoke.multicard_batch(dp, sp)
    if (dp, sp) not in layout_work["records"]:
        dryrun_ddp.spawn(dryrun_ddp.layout_child, dp * sp,
                         (layout_work["work"], f"b{b}", "cpu", False, False,
                          (dp, sp) == (1, 2)), TIMEOUT,
                         layout_work["work"], spatial=sp)
        layout_work["records"][dp, sp] = dryrun_ddp.layout_records(
            layout_work["work"], f"b{b}", dp * sp)
    return layout_work["records"][dp, sp], layout_work["single"][b]


@pytest.mark.parametrize("layout", [(2, 1), (1, 2), (2, 2)],
                         ids=lambda lay: f"{lay[0]}x{lay[1]}")
def test_card_layout_child_matches_one_process(layout_work, layout):
    """Phase 13's child as 2 x 1, 1 x 2 and 2 x 2 (batch 4) over gloo:
    the float64 step and eval equal one process's at phase 11's bars, the
    collectives by purpose, bf16 replicas bit-identical after 3 steps
    (`dryrun_ddp.layout_failures`). Readings: loss rel 0.0 (2 x 2
    1.2e-7), least tensor cosine 1 - 6e-14 or closer, eval gaps <= 1.5e-7
    (float32 sums of the float64 forward), bf16 difference 0.0."""
    assert layout in chip_smoke.MULTI_LAYOUTS
    records, single = _layout(layout_work, *layout)
    readings, fails = dryrun_ddp.layout_failures(
        records, single, layout_work["halo"], layout_work["n_bn"])
    print(readings)
    assert not fails, fails
    assert readings["counts"]["step"].get("halo", 0) == (
        96 if layout[1] > 1 else 0)
    assert [r["rows"] for r in records] == [
        (0, 32) if layout[1] == 1 else ((0, 16), (16, 32))[r % 2]
        for r in range(len(records))]
    assert ("float32" in readings) == (layout == (1, 2))


def _plant(records, single, fault):
    """Copies of a 1 x 2 layout's records with one fault planted."""
    import copy
    records = copy.deepcopy(records)
    first = records[0]
    name = "FeatureExtractor_0.ConvBN_0.Conv_0.weight"
    if fault == "gradient":      # 2 % of its norm off one tensor's direction
        for r in records:
            g = r["step"]["grads"][name]
            r["step"]["grads"][name] = g + 0.02 * g.norm() * torch.randn(
                g.shape, generator=torch.Generator().manual_seed(0),
                dtype=g.dtype) / g.numel() ** 0.5
    elif fault == "statistics":  # a BN mean off by 1e-3 of its value
        for r in records:
            key = next(n for n in r["step"]["buffers"]
                       if n.endswith("running_mean"))
            r["step"]["buffers"][key] = r["step"]["buffers"][key] * 1.001
    elif fault == "replica":     # one process's bf16 parameter one step off
        p = records[-1]["bf16"]["params"][name]
        records[-1]["bf16"]["params"][name] = torch.nextafter(
            p, torch.full_like(p, float("inf")))
    elif fault == "halo_count":  # one halo exchange missing
        first["step"]["counts"] = dict(first["step"]["counts"],
                                       halo=first["step"]["counts"]["halo"]
                                       - 1)
    elif fault == "eval":        # one EPE sum off by 1e-4
        for r in records:
            r["eval"]["epe"] = r["eval"]["epe"] * (1.0 + 1e-4)
    elif fault == "gradient_scale":  # gradients summed, not averaged
        for r in records:
            r["step"]["grad_norm"] *= 2.0
    elif fault == "float32_statistics":  # phase 11's float32 step's BN
        for r in records:
            key = next(n for n in r["step_float32"]["buffers"]
                       if n.endswith("running_var"))
            r["step_float32"]["buffers"][key] = \
                r["step_float32"]["buffers"][key] * 1.001
    return records


# Each planted fault and the start of the failure that must report it.
CAUGHT_BY = {"gradient": "float64 step: 1 gradient tensors",
             "statistics": "float64 step: loss rel 0",
             "replica": "bf16 steps: parameters",
             "halo_count": "step collectives",
             "eval": "float64 eval: gaps",
             "gradient_scale": "float64 step: loss rel 0.0, grad_norm rel 1",
             "float32_statistics": "float32 step and eval"}


@pytest.mark.parametrize("fault", list(CAUGHT_BY))
def test_layout_bars_catch_planted_faults(layout_work, fault):
    """`layout_failures` reports each fault planted in the 1 x 2 records
    by the bar meant for it."""
    records, single = _layout(layout_work, 1, 2)
    _, fails = dryrun_ddp.layout_failures(
        _plant(records, single, fault), single, layout_work["halo"],
        layout_work["n_bn"])
    print(fault, fails)
    assert any(f.startswith(CAUGHT_BY[fault]) for f in fails), fails


def test_multicard_phase_needs_four_cards_under_only(monkeypatch, capsys):
    """`chip_smoke.py --only multicard` on one card fails; without
    `--only` phase 13 says it was not run and records so."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(timing, "card", lambda: "card, 700.00 W")
    for flags in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flags, "allow_tf32", flags.allow_tf32)
    monkeypatch.chdir(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with pytest.raises(chip_smoke.PhaseError, match="needs 4 cards"):
        chip_smoke.main(["--only", "multicard"])
    assert '"ok"' not in capsys.readouterr().out
    assert chip_smoke.multicard_phase("card", "unused") == {
        "cards": 1, "run": False}
    assert "[13] multi-card phase: 1 card visible, needs 2 or more: not " \
        "run" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        chip_smoke.main(["--only", "everything"])


def test_dryrun_tool_device_flag(monkeypatch):
    """`dryrun_ddp --device cuda` raises without a card before it starts
    a process; the card is the default, so it raises without the flag
    too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        dryrun_ddp.main(["--processes", "2", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        dryrun_ddp.main(["--processes", "2"])
    with pytest.raises(SystemExit):
        dryrun_ddp.main(["--device", "tpu"])
