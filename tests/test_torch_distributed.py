"""Data-parallel training of the port over `torch.distributed` on the CPU.

Two gloo processes (`lwsnet_tpu_torch.tools.dryrun_ddp.spawn`, each on one
torch thread, joined within 120 s and killed past it) each take their half
of a batch of 4 at 32x64 (float32, the full-width model, the pretrain
recipe's loss) and take one train step. They are held against:

* the JAX package's train step on a 2-device CPU mesh (pjit: global batch
  norm, the global masked loss, reduced gradients), from the same state:
  loss and stage losses rtol 1e-5, grad_norm rtol 2e-3, the BN running
  statistics rtol 1e-4 / atol 1e-5, the gradient (JAX's read back from
  its first Adam moment) at cosine >= 0.9996 whole and >= 0.998 a tensor,
  and the parameters and Adam moments after the step against optax fed
  the port's gradient: the one-step bars of tests/test_torch_training.py;
* the port's single-process step on the concatenated batch: loss rel
  1e-5, BN statistics rtol 1e-4 (atol 1e-6), each gradient tensor's
  cosine >= 0.9999.

The batch's halves differ in their image statistics and in their mask
counts (the second half has most of its ground truth past the pretrain
mask's 192), so the planted faults, process-local BN statistics and a
per-process loss denominator (tests/torch_ddp_child.py), each miss these
bars. Readings against the single-process step (torch 2.13, this
geometry): sound, loss rel 7.1e-8, BN statistics 0.032 of the bar, least
tensor cosine 1 - 3.5e-6 (whole 1 - 9e-10); local BN, loss rel 0.14,
statistics 9.7e3 of the bar, 136 of 138 tensors under 0.9999 (whole
0.16); the per-process denominator, loss rel 1.3e-5, 136 tensors under
0.9999 (whole 0.90). Against the JAX mesh: loss rel 1.4e-7, grad_norm
7.5e-4, cosine 1 - 9.7e-6 whole and 1 - 4.3e-5 least. The children import
no JAX.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_ddp_child  # noqa: E402
from lwsnet_tpu import LWSNet as JLWSNet  # noqa: E402
from lwsnet_tpu import MeshConfig as JMeshConfig  # noqa: E402
from lwsnet_tpu import ModelConfig as JConfig  # noqa: E402
from lwsnet_tpu import TrainConfig as JTrainConfig  # noqa: E402
from lwsnet_tpu.data.png import write_png  # noqa: E402
from lwsnet_tpu.data.kitti2015 import StereoIndex as JIndex  # noqa: E402
from lwsnet_tpu.data.pipeline import StereoPipeline as JPipeline  # noqa
from lwsnet_tpu.parallel import mesh as jmesh  # noqa: E402
from lwsnet_tpu.training.state import create_train_state as jcreate  # noqa
from lwsnet_tpu.training.state import make_optimizer as joptimizer  # noqa
from lwsnet_tpu.training.steps import make_eval_step as jeval  # noqa: E402
from lwsnet_tpu.training.steps import make_train_step as jtrain  # noqa
from lwsnet_tpu_torch import ModelConfig  # noqa: E402
from lwsnet_tpu_torch.config import MeshConfig, TrainConfig  # noqa: E402
from lwsnet_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                      to_jax_variables)
from lwsnet_tpu_torch.parallel import mesh  # noqa: E402
from lwsnet_tpu_torch.tools import dryrun_ddp  # noqa: E402
from lwsnet_tpu_torch.training.state import create_train_state  # noqa
from lwsnet_tpu_torch.training.steps import make_train_step  # noqa: E402

B, H, W = 4, 32, 64
KW = dict(lr=5e-4, mask_max_disp=192.0)
TIMEOUT = 120.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    """Halves with other image statistics and other mask counts."""
    rng = np.random.default_rng(11)
    l, r = (rng.standard_normal((B, H, W, 3)).astype(np.float32)
            for _ in range(2))
    l[2:] = 2.0 * l[2:] + 0.5
    r[2:] = 2.0 * r[2:] + 0.5
    g = rng.uniform(1.0, 100.0, (B, H, W)).astype(np.float32)
    g[2:][rng.uniform(size=(2, H, W)) < 0.6] = 300.0
    return {"l": l, "r": r, "g": g}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX `create_train_state`, its weights bridged to a state-dict file
    the children load, and the batch."""
    tmp = tmp_path_factory.mktemp("ddp")
    jstate = jcreate(JLWSNet(JConfig(compute_dtype="float32")),
                     JTrainConfig(**KW), jax.random.PRNGKey(0), (H, W),
                     steps_per_epoch=1)
    sd = from_jax_variables({"params": jstate.params,
                             "batch_stats": jstate.batch_stats})
    path = str(tmp / "state.pt")
    torch.save(sd, path)
    return jstate, sd, path, _batch(), tmp


def _two_processes(setup, fault=None):
    _, _, path, batch, tmp = setup
    if fault is None:
        return dryrun_ddp.run_step(2, batch, path, KW, TIMEOUT, str(tmp))
    return dryrun_ddp.run_step(2, batch, path, KW, TIMEOUT, str(tmp),
                               target=torch_ddp_child.faulty_step_child,
                               extra=(fault,))


@pytest.fixture(scope="module")
def ddp(setup):
    return _two_processes(setup)


@pytest.fixture(scope="module")
def single(setup):
    """The port's step on the whole batch in this process."""
    _, sd, _, batch, _ = setup
    cfg = TrainConfig(**KW)
    st = create_train_state(ModelConfig(compute_dtype="float32"), cfg,
                            device="cpu")
    st.model.load_state_dict(sd, strict=True)
    st, aux = make_train_step(cfg, 1)(
        st, *[torch.from_numpy(batch[k]) for k in ("l", "r", "g")])
    return dict(aux=aux,
                grads={n: p.grad.clone()
                       for n, p in st.model.named_parameters()},
                buffers={n: b.clone() for n, b in st.model.named_buffers()})


def _cosines(a, b, floor):
    """(whole cosine, {tensor: cosine}) over the tensors of `b` whose norm
    is above `floor`, in float64."""
    names = [n for n in b if float(b[n].norm()) > floor]
    per = {n: float((a[n].double() * b[n].double()).sum()
                    / (a[n].double().norm() * b[n].double().norm()))
           for n in names}
    x, y = (torch.cat([d[n].double().reshape(-1) for n in names])
            for d in (a, b))
    return float((x * y).sum() / (x.norm() * y.norm())), per


def _against_single(rank0, single):
    """Readings of a two-process step against the single-process one: the
    loss's relative distance, the BN statistics' worst distance in units
    of the bar (rtol 1e-4, atol 1e-6), the least tensor cosine, and the
    whole gradient's cosine and the tensors under 0.9999 for the record."""
    a, s = rank0["aux"], single["aux"]
    floor = 1e-6 * float(s["grad_norm"])
    whole, per = _cosines(rank0["grads"], single["grads"], floor)
    stats = max(float(((b - single["buffers"][n]).abs()
                       / (1e-4 * single["buffers"][n].abs() + 1e-6)).max())
                for n, b in rank0["buffers"].items())
    return dict(loss=abs(float(a["loss"]) / float(s["loss"]) - 1.0),
                stats=stats, min_cosine=min(per.values()), cosine=whole,
                tensors_under=sum(c < 0.9999 for c in per.values()),
                tensors=len(per))


def _meets_single_bars(r):
    return r["loss"] <= 1e-5 and r["stats"] <= 1.0 and \
        r["min_cosine"] >= 0.9999


def test_processes_agree_and_ran_the_collectives(ddp):
    """Both processes end the step with the same parameters, moments and
    statistics, bit for bit, and report the same global loss; each ran one
    collective per train-mode batch norm, the mask count, the gradients
    and the reported loss."""
    r0, r1 = ddp
    for what in ("params", "exp_avg", "exp_avg_sq", "buffers", "grads"):
        for n, t in r0[what].items():
            assert torch.equal(t, r1[what][n]), (what, n)
    assert torch.equal(r0["aux"]["loss"], r1["aux"]["loss"])
    assert r0["counts"] == r1["counts"]
    n_bn = sum(1 for n in r0["buffers"] if n.endswith("running_mean"))
    assert r0["counts"] == {"batch_norm": n_bn, "loss_count": 1,
                            "gradients": 1, "loss": 1}


def test_two_process_step_matches_single_process(ddp, single):
    """Against the single-process step on the concatenated batch."""
    r = _against_single(ddp[0], single)
    print("two processes vs one:", r)
    assert _meets_single_bars(r), r


@pytest.mark.parametrize("fault", ["local_bn", "local_count"])
def test_planted_faults_miss_the_bars(setup, single, fault):
    """Process-local BN statistics, or a per-process loss denominator
    with averaged gradients, miss the single-process bars."""
    r = _against_single(_two_processes(setup, fault)[0], single)
    print(fault, r)
    assert not _meets_single_bars(r), r


def check_against_jax_mesh(jstate, batch, r0, mcfg, n):
    """Rank 0's record of a step against JAX's train step on an n-device
    CPU mesh laid out as `mcfg`, from the same state, and its update
    against optax fed the port's gradient: loss and stage losses rtol
    1e-5, grad_norm rtol 2e-3, BN statistics rtol 1e-4 / atol 1e-5,
    gradient cosine >= 0.9996 whole and >= 0.998 a tensor."""
    jm = jmesh.make_mesh(mcfg, devices=jax.devices()[:n])
    jcfg = JTrainConfig(**KW)
    sharded = jmesh.shard_batch(jm, batch, mcfg)
    jout, jaux = jtrain(JLWSNet(JConfig(compute_dtype="float32")), jcfg, 1,
                        donate=False)(jmesh.replicate_state(jm, jstate),
                                      sharded["l"], sharded["r"],
                                      sharded["g"])
    jax.block_until_ready(jout)
    aux = r0["aux"]
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(aux["stage_losses"].numpy(),
                               np.asarray(jaux["stage_losses"]), rtol=1e-5)
    np.testing.assert_allclose(float(aux["grad_norm"]),
                               float(jaux["grad_norm"]), rtol=2e-3)
    want = from_jax_variables({"params": {},
                               "batch_stats": jax.device_get(
                                   jout.batch_stats)})
    for n_, t in r0["buffers"].items():
        np.testing.assert_allclose(t.numpy(), want[n_].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n_)
    # JAX's clipped gradient from its first moment (zero before the step)
    ref = {k: t.double() / 0.1 for k, t in from_jax_variables(
        {"params": jax.device_get(jout.opt_state[1][0].mu),
         "batch_stats": {}}).items()}
    clip = min(5.0, float(aux["grad_norm"]))
    whole, per = _cosines(r0["grads"], ref, 1e-6 * clip)
    print("processes vs JAX mesh", mcfg, ": loss", float(aux["loss"]),
          float(jaux["loss"]), "grad_norm", float(aux["grad_norm"]),
          float(jaux["grad_norm"]), "cosine", whole, min(per.values()))
    assert whole >= 0.9996 and min(per.values()) >= 0.998
    # optax fed the port's gradient before the clip lands on its update
    scale = max(1.0, float(aux["grad_norm"]) / 5.0)
    grads = to_jax_variables({k: g * scale for k, g in r0["grads"].items()}
                             )["params"]
    tx = joptimizer(jcfg, 1)
    updates, opt = tx.update(grads, jstate.opt_state, jstate.params)
    params = optax.apply_updates(jstate.params, updates)
    atol = {"params": 1e-5, "exp_avg": 1e-7, "exp_avg_sq": 1e-10}
    for which, tree in (("params", params), ("exp_avg", opt[1][0].mu),
                        ("exp_avg_sq", opt[1][0].nu)):
        want = from_jax_variables({"params": tree, "batch_stats": {}})
        for k, t in r0[which].items():
            np.testing.assert_allclose(
                t.numpy(), want[k].numpy(), atol=atol[which],
                rtol=1e-5 if which == "params" else 1e-4,
                err_msg=f"{which} {k}")


def test_two_process_step_matches_jax_mesh(setup, ddp):
    """Against JAX's train step on a 2-device CPU mesh from the same
    state, and the update against optax fed the port's gradient."""
    jstate, _, _, batch, _ = setup
    check_against_jax_mesh(jstate, batch, ddp[0], JMeshConfig(), 2)


@pytest.fixture(scope="module")
def eval_corpus(tmp_path_factory):
    """Five KITTI-style frames: slices of 3 and 2 over two processes, at
    batch 2 two batches each, the last of process 0 half padding and the
    last of process 1 all padding."""
    root = tmp_path_factory.mktemp("evalcorpus")
    rng = np.random.default_rng(5)
    paths = {"left": [], "right": [], "disp": []}
    for i in range(5):
        img = rng.integers(0, 255, (40, 72, 3), dtype=np.uint8)
        disp = rng.uniform(1.0, 60.0, (40, 72))
        disp[rng.uniform(size=disp.shape) < 0.5] = 0.0
        for key, arr in (("left", img), ("right", np.roll(img, -3, axis=1)),
                         ("disp", (disp * 256).astype(np.uint16))):
            p = str(root / f"{key}_{i}.png")
            write_png(p, arr)
            paths[key].append(p)
    spec = str(root / "corpus.json")
    with open(spec, "w") as f:
        json.dump(paths, f)
    return paths, spec


def test_two_process_eval_matches_jax(setup, eval_corpus, tmp_path):
    """Two processes evaluate their slices: each process's `valid`
    vectors are the JAX pipeline's at process_count 2, the eval sums
    (reduced over the processes) and weight 5 match JAX's eval step over
    the whole split (EPE rtol 1e-5; D1, a sum of five frames' rates,
    within ten flipped pixels, 1e-2), and so do `Trainer.evaluate`'s EPE
    (rtol 1e-5) and D1 (their mean, 2e-3)."""
    jstate, _, path, _, _ = setup
    paths, spec = eval_corpus
    dryrun_ddp.spawn(torch_ddp_child.eval_child, 2,
                     (path, spec, 2, str(tmp_path)), TIMEOUT, str(tmp_path))
    ranks = [torch.load(str(tmp_path / f"eval{r}.pt"), weights_only=False)
             for r in range(2)]
    jidx = JIndex(paths["left"], paths["right"], paths["disp"])
    for rank, rec in enumerate(ranks):
        want = [b.valid for b in JPipeline(
            jidx, 2, training=False, crop=(32, 64), kitti=True,
            num_workers=1, process_index=rank, process_count=2).epoch(0)]
        np.testing.assert_array_equal(rec["valid"], np.stack(want))
        # one collective an eval step: the loop here, then two evaluates
        assert rec["counts"]["eval"] == 3 * len(want)
    assert ranks[0]["valid"].tolist() == [[1.0, 1.0], [1.0, 0.0]]
    assert ranks[1]["valid"].tolist() == [[1.0, 1.0], [0.0, 0.0]]
    got = {k: sum(s[k] for s in ranks[0]["steps"])
           for k in ("epe", "d1", "weight")}
    assert float(got["weight"]) == 5.0
    step = jax.jit(jeval(JLWSNet(JConfig(compute_dtype="float32"))))
    want = {"epe": 0.0, "d1": 0.0, "weight": 0.0}
    for b in JPipeline(jidx, 5, training=False, crop=(32, 64), kitti=True,
                       num_workers=1).epoch(0):
        out = step(jstate, b.left, b.right, b.disparity, b.valid)
        for k in want:
            want[k] = want[k] + np.asarray(out[k])
    # D1 counts pixels past a 3 px threshold, and a pixel within float32
    # noise of it flips (1e-3 of a frame's ~1000 valid pixels): ten may
    np.testing.assert_allclose(got["epe"], want["epe"], rtol=1e-5)
    np.testing.assert_allclose(got["d1"], want["d1"], rtol=0, atol=1e-2)
    for rec in ranks:
        np.testing.assert_allclose(rec["headline"]["epe"],
                                   want["epe"][-1] / 5.0, rtol=1e-5)
        assert abs(rec["headline"]["d1"] - want["d1"][-1] / 5.0) <= 2e-3


def test_two_process_precise_bn_reads_global_statistics(setup, eval_corpus,
                                                         tmp_path):
    """Exact precise BN over one stat batch: two processes with two
    examples each end with the running statistics of the single-process
    Trainer over the four (rtol 1e-4, atol 1e-6), the same on both."""
    _, sd, path, _, _ = setup
    paths, spec = eval_corpus
    dryrun_ddp.spawn(torch_ddp_child.precise_bn_child, 2,
                     (path, spec, 2, str(tmp_path)), TIMEOUT, str(tmp_path))
    got = [torch.load(str(tmp_path / f"bn{r}.pt")) for r in range(2)]
    single = torch_ddp_child._trainer(0, 1, path, spec, 4, str(tmp_path),
                                      bn_reestimate_batches=1,
                                      bn_reestimate_exact=True)
    single.reestimate_bn(0)
    for n, b in single.state.model.named_buffers():
        assert torch.equal(got[0][n], got[1][n]), n
        torch.testing.assert_close(got[0][n], b, rtol=1e-4, atol=1e-6,
                                   msg=n)
        if n.endswith("running_var"):
            assert not torch.equal(b, sd[n]), n  # the pass moved them


def test_dryrun_tool():
    """`python -m lwsnet_tpu_torch.tools.dryrun_ddp`: two processes'
    loss equals the single process's."""
    out = dryrun_ddp.main(["--processes", "2", "--device", "cpu"])
    assert abs(out["loss"] - out["single_loss"]) <= 1e-5 * out["single_loss"]


def test_spawn_kills_processes_past_its_time_limit(tmp_path):
    with pytest.raises(TimeoutError, match="killed"):
        dryrun_ddp.spawn(torch_ddp_child.hang, 2, (), 5.0, str(tmp_path))


def test_no_process_group_without_a_launcher(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not mesh.maybe_initialize_distributed("cpu")
    assert not mesh.is_distributed()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.process_device("cpu") == torch.device("cpu")
    t = torch.ones(3)
    assert mesh.all_reduce_(t, "eval") is t and mesh.collective_counts() \
        .get("eval", 0) == 0
    with pytest.raises(ValueError, match="does not divide the world"):
        mesh.maybe_initialize_distributed(
            "cpu", mesh_cfg=MeshConfig(spatial_parallel=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        mesh.maybe_initialize_distributed()
