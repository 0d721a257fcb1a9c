"""Dryrun of data-parallel and data x spatial training, on the CPU over
gloo or on the cards over NCCL.

The port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`: N processes under one process group
each take their slice of one float32 train step of the full-width model
at 32x64 on one global batch of N examples, and the loss they report
must match a single-process step on the whole batch, with every process
holding the same parameters and batch-norm statistics afterwards. With
`--spatial S` the same N processes then run the step again as N/S data
slices x S row shards (halo exchanges at every shard edge), and its loss
must lie within 1e-2 x max(1, |loss|) of the data-parallel one, as the
JAX dryrun asks. `--device cuda` runs process r on card r under NCCL
(TF32 off; the single-process step on card 0); the default is gloo
processes on the CPU.

    python -m lwsnet_tpu_torch.tools.dryrun_ddp [--processes N] \
        [--spatial S] [--device cpu|cuda]

`spawn` starts such processes for any module-level target (the tests,
`tools.scaling_sweep` and `chip_smoke.py`'s layouts on the cards under
NCCL, and its two row shards on one card under gloo): each rendezvouses
through a file, lays the group out as `spatial` row shards, runs on one
torch thread and is joined within a time limit, after which every
process still running is killed and `spawn` raises.

`layout_child` is one process of a data x spatial layout (or the one
process it is held against): a float64 train step and eval step, then
bf16 steps, and on a card their time, peak memory and a profiler window;
`layout_failures` holds a layout's records against the one process's.
"""

from __future__ import annotations

import argparse
import contextlib
import multiprocessing as mp
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

H, W = 32, 64
TRAIN_KW = dict(mask_max_disp=192.0)


def _child(target: Callable, rank: int, world: int, init_method: str,
           args: Sequence, device: str, spatial: int,
           backend: Optional[str]) -> None:
    import torch.distributed as dist

    from lwsnet_tpu_torch.config import MeshConfig
    from lwsnet_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    mesh.maybe_initialize_distributed(
        device, init_method=init_method,
        mesh_cfg=MeshConfig(spatial_parallel=spatial), backend=backend)
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(target: Callable, world: int, args: Sequence = (),
          timeout: float = 120.0, rendezvous_dir: Optional[str] = None,
          device: str = "cpu", spatial: int = 1,
          backend: Optional[str] = None) -> None:
    """Run target(rank, world, *args) in `world` fresh processes under one
    group (rendezvous file in `rendezvous_dir`, default a new temporary
    directory) laid out as `spatial` row shards (`MeshConfig`): gloo on
    the CPU, or NCCL with `device="cuda"`, process r on card r; a
    `device` with an index puts every process on that card, which takes
    `backend="gloo"` (NCCL refuses two processes on one card). Waits at
    most `timeout` seconds for all of them: then kills those still
    running and raises TimeoutError; raises RuntimeError if any exited
    with another code than 0."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_child,
                             args=(target, rank, world, init, tuple(args),
                                   device, spatial, backend))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
            for p in hung:
                p.join()
    if hung:
        raise TimeoutError(f"{len(hung)} of {world} processes still ran "
                           f"after {timeout} s and were killed")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"process exit codes {codes}")


def local_part(batch: Dict[str, np.ndarray], keys: Sequence[str]
               ) -> List[torch.Tensor]:
    """This process's part of a global batch: the contiguous examples of
    its data slice, and its rows (`mesh.row_range`) of each image."""
    from lwsnet_tpu_torch.parallel import mesh

    per = len(batch[keys[0]]) // mesh.data_count()
    d = mesh.data_index()
    r0, r1 = mesh.row_range(batch[keys[0]].shape[1])
    return [torch.from_numpy(np.ascontiguousarray(
        batch[k][d * per:(d + 1) * per, r0:r1])) for k in keys]


def train_step_child(rank: int, world: int, batch_path: str,
                     state_path: str, train_kw: Dict, out_dir: str,
                     device: str = "cpu") -> None:
    """One float32 train step of process `rank` on its part of the global
    batch in `batch_path` (npz: l, r, g; `local_part`), from the state
    dict in `state_path` ("" for the seed-0 init), on this process's
    `device` (`mesh.process_device`; TF32 off on a card). Saves to
    `<out_dir>/rank<rank>.pt` the step's aux, the gradients the update
    used, the parameters, Adam's moments, the buffers (all on the CPU)
    and the collective counts."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.parallel import mesh
    from lwsnet_tpu_torch.tools.parity import tf32_off
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step

    dev = mesh.process_device(device)
    batch = np.load(batch_path)
    cfg = TrainConfig(**train_kw)
    st = create_train_state(ModelConfig(compute_dtype="float32"), cfg,
                            seed=0, device=dev)
    if state_path:
        st.model.load_state_dict(torch.load(state_path), strict=True)
    mesh.reset_collective_counts()
    with tf32_off():
        st, aux = make_train_step(cfg, 1)(
            st, *[t.to(dev) for t in local_part(batch, "lrg")])
    named = list(st.model.named_parameters())

    def host(t):
        return t.detach().to("cpu", copy=True)

    torch.save(dict(
        aux={k: (host(v) if torch.is_tensor(v) else v)
             for k, v in aux.items()},
        grads={n: host(p.grad) for n, p in named},
        params={n: host(p) for n, p in named},
        exp_avg={n: host(st.optimizer.state[p]["exp_avg"])
                 for n, p in named},
        exp_avg_sq={n: host(st.optimizer.state[p]["exp_avg_sq"])
                    for n, p in named},
        buffers={n: host(b) for n, b in st.model.named_buffers()},
        counts=mesh.collective_counts()),
        os.path.join(out_dir, f"rank{rank}.pt"))


def run_step(world: int, batch: Dict[str, np.ndarray], state_path: str = "",
             train_kw: Dict = TRAIN_KW, timeout: float = 120.0,
             workdir: Optional[str] = None, target: Callable = None,
             extra: Sequence = (), spatial: int = 1,
             device: str = "cpu") -> list:
    """`train_step_child` (or `target`, called with `extra` before the
    usual arguments, `device` last) in `world` processes laid out as
    `spatial` row shards on `device` (`spawn`), on `batch`; returns each
    rank's saved record."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        batch_path = os.path.join(tmp, "batch.npz")
        np.savez(batch_path, **batch)
        spawn(target or train_step_child, world,
              tuple(extra) + (batch_path, state_path, dict(train_kw), tmp,
                              device),
              timeout, tmp, device=device, spatial=spatial)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(world)]


@contextlib.contextmanager
def deterministic_algorithms():
    """TF32 off and deterministic algorithms inside (an op that has none
    raises), the settings as they were after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (torch.are_deterministic_algorithms_enabled(),
             cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             matmul.allow_tf32)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         matmul.allow_tf32) = saved[1:]


# bf16 train steps of `layout_child` before its processes' parameters and
# statistics are compared bit for bit.
LAYOUT_BF16_STEPS = 3


def write_layout_weights(work: str) -> Tuple[Dict[str, int], int]:
    """`layout_child`'s weights, `<work>/weights.pt`: the seed-0 network
    with jittered batch-norm statistics and affines
    (`parity_layers.jitter_batchnorm`, seed 3), as chip_smoke.py's phases
    4 and 11 draw them. Returns its halo exchanges
    (`LWSNet.halo_exchanges`) and its batch-norm count, the arguments of
    `layout_failures`."""
    from lwsnet_tpu_torch import LWSNet, ModelConfig
    from lwsnet_tpu_torch.models.blocks import BatchNorm
    from lwsnet_tpu_torch.tools.parity_layers import jitter_batchnorm

    model = LWSNet(ModelConfig(compute_dtype="float32"), device="cpu")
    jitter_batchnorm(model, np.random.default_rng(3))
    torch.save(model.state_dict(), os.path.join(work, "weights.pt"))
    return model.halo_exchanges(), sum(isinstance(m, BatchNorm)
                                       for m in model.modules())


def write_layout_data(path: str, batch: int, train_hw: Sequence[int],
                      eval_hw: Sequence[int], seed: int = 11) -> None:
    """`layout_child`'s data, from a seed, as an npz: a train batch (l, r,
    g: standard-normal images, ground truth 1-250 px) and an eval batch
    (el, er, eg with 30 % of its pixels 0, ev all valid) of `batch`
    examples at `train_hw` and `eval_hw`, float32."""
    rng = np.random.default_rng(seed)
    h, w = train_hw
    eh, ew = eval_hw
    eg = rng.uniform(1.0, 150.0, (batch, eh, ew)).astype(np.float32)
    eg[rng.uniform(size=eg.shape) < 0.3] = 0.0
    np.savez(path,
             l=rng.standard_normal((batch, h, w, 3)).astype(np.float32),
             r=rng.standard_normal((batch, h, w, 3)).astype(np.float32),
             g=rng.uniform(1.0, 250.0, (batch, h, w)).astype(np.float32),
             el=rng.standard_normal((batch, eh, ew, 3)).astype(np.float32),
             er=rng.standard_normal((batch, eh, ew, 3)).astype(np.float32),
             eg=eg, ev=np.ones(batch, np.float32))


def _profile_split(spans: list, reps: int) -> Dict[str, float]:
    """Device ms a step from a profiler window's kernel spans: busy (their
    union), the NCCL kernels' (all-gathers and all-reduces apart) and the
    other kernels'; NCCL kernels a step."""
    from lwsnet_tpu_torch.utils.timing import busy_ms

    nccl = [s for s in spans if "nccl" in s[2].lower()]
    gather = [s for s in nccl if "allgather" in s[2].lower()]
    reduce_ = [s for s in nccl if "allreduce" in s[2].lower()]
    return dict(busy_ms=busy_ms(spans, reps), nccl_ms=busy_ms(nccl, reps),
                all_gather_ms=busy_ms(gather, reps),
                all_reduce_ms=busy_ms(reduce_, reps),
                other_ms=busy_ms([s for s in spans if s not in nccl], reps),
                nccl_kernels=len(nccl) / reps)


def layout_child(rank: int, world: int, work: str, name: str,
                 device: str = "cpu", timed: bool = False,
                 profile: bool = False, float32: bool = False) -> None:
    """Process `rank` of `world` laid out as the process group's data x
    spatial grid (with `world` 1 and no group: the one process it is held
    against), on its part (`local_part`) of `<work>/<name>.npz`
    (`write_layout_data`) from `<work>/weights.pt`
    (`write_layout_weights`), on this process's `device`
    (`mesh.process_device`):

    * one float64 train step and the float64 eval step on the eval batch,
      deterministic algorithms and TF32 off: loss, grad_norm, gradients,
      BN statistics, the eval sums, and each one's collective counts;
      with `float32`, the same step and eval in float32 compute first
      (`step_float32`, `eval_float32`);
    * LAYOUT_BF16_STEPS bf16 train steps from the same weights:
      collective counts, then the parameters and buffers; the losses of
      every bf16 step;
    * on a card with `timed`: the bf16 step's device ms over 5 more steps
      (CUDA events, after one) and the process's peak memory over them;
      with `profile`, process 0's torch.profiler window over 3 more steps
      (`_profile_split`; every process runs them);
    * the kernel launches of all of it (the module path launches none).

    Saves the record, on the CPU, to `<work>/<name>_<world>_<rank>.pt`."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.parallel import mesh
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import (make_eval_step,
                                                 make_train_step)

    dev = mesh.process_device(device)
    card = dev.type == "cuda"
    base = torch.cuda.memory_allocated(dev) if card else 0
    data = dict(np.load(os.path.join(work, f"{name}.npz")))
    weights = torch.load(os.path.join(work, "weights.pt"))
    tcfg = TrainConfig(**TRAIN_KW)
    launches = build.launch_counts()

    def state(dtype):
        st = create_train_state(ModelConfig(compute_dtype=dtype), tcfg,
                                device=dev)
        st.model.load_state_dict(weights)
        return st

    def host(tensors):
        return {n: t.detach().to("cpu", copy=True) for n, t in tensors}

    batch = [t.to(dev) for t in local_part(data, "lrg")]
    per = len(data["ev"]) // mesh.data_count()
    d = mesh.data_index()
    ev = [t.to(dev) for t in local_part(data, ["el", "er", "eg"])] + [
        torch.from_numpy(data["ev"][d * per:(d + 1) * per]).to(dev)]
    out = dict(layout=(mesh.data_count(), mesh.spatial_count()),
               rows=mesh.row_range(data["l"].shape[1]),
               eval_rows=mesh.row_range(data["el"].shape[1]))
    with deterministic_algorithms():
        for dtype in ("float32", "float64") if float32 else ("float64",):
            tail = "" if dtype == "float64" else "_" + dtype
            st = state(dtype)
            mesh.reset_collective_counts()
            st, aux = make_train_step(tcfg, 1)(st, *batch)
            out["step" + tail] = dict(
                loss=float(aux["loss"]), grad_norm=float(aux["grad_norm"]),
                counts=mesh.collective_counts(),
                grads=host((n, p.grad)
                           for n, p in st.model.named_parameters()),
                buffers=host(st.model.named_buffers()))
            st = state(dtype)
            mesh.reset_collective_counts()
            res = make_eval_step(TRAIN_KW["mask_max_disp"])(st, *ev)
            out["eval" + tail] = dict(host(res.items()),
                                      counts=mesh.collective_counts())
    del st
    st = state("bfloat16")
    step = make_train_step(tcfg, 1)
    losses = []

    def bf16_step():
        nonlocal st
        st, aux = step(st, *batch)
        losses.append(float(aux["loss"]))

    mesh.reset_collective_counts()
    for _ in range(LAYOUT_BF16_STEPS):
        bf16_step()
    out["bf16"] = dict(counts=mesh.collective_counts(),
                       params=host(st.model.named_parameters()),
                       buffers=host(st.model.named_buffers()))
    if card and timed:
        from lwsnet_tpu_torch.utils.timing import event_times
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out["bf16"]["ms"] = event_times(bf16_step, reps=5, warmup=1)
        out["bf16"]["peak_bytes"] = \
            torch.cuda.max_memory_allocated(dev) - base
    if card and profile:
        from lwsnet_tpu_torch.utils.timing import profile_window
        if rank == 0:
            wall_ms, spans = profile_window(bf16_step, reps=3)
            out["profile"] = dict(_profile_split(spans, 3), wall_ms=wall_ms)
        else:
            for _ in range(4):  # profile_window's warm call and its 3
                bf16_step()
            torch.cuda.synchronize(dev)
    out["bf16"]["losses"] = losses
    out["launches"] = {k: n - launches[k]
                       for k, n in build.launch_counts().items()}
    torch.save(out, os.path.join(work, f"{name}_{world}_{rank}.pt"))


def layout_records(work: str, name: str, world: int) -> list:
    """Every process's record of `layout_child` at `world` processes."""
    return [torch.load(os.path.join(work, f"{name}_{world}_{r}.pt"))
            for r in range(world)]


def _rel(a, b) -> float:
    return abs(a / b - 1.0) if b else abs(a)


def _stats(got: dict, want: dict) -> float:
    """The largest BN-statistics gap of two step records, in units of
    rtol 1e-4 / atol 1e-6."""
    return max(float(((t - want["buffers"][n]).abs()
                      / (1e-4 * want["buffers"][n].abs() + 1e-6)).max())
               for n, t in got["buffers"].items())


def _cosines(got: dict, want: dict) -> Dict[str, float]:
    """Each gradient tensor's cosine to one process's, over the tensors
    whose norm there is at least 1e-6 x its grad_norm."""
    cos = {}
    for n, g in got["grads"].items():
        g, h = g.double(), want["grads"][n].double()
        if float(h.norm()) >= 1e-6 * want["grad_norm"]:
            cos[n] = float((g * h).sum() / (g.norm() * h.norm()))
    return cos


def _gaps(got: dict, want: dict) -> Dict[str, float]:
    """The largest relative gap of two eval records' EPE and D1 sums."""
    return {k: float(((got[k] - want[k]).abs()
                      / want[k].abs().clamp_min(1e-30)).max())
            for k in ("epe", "d1")}


def layout_failures(records: list, single: dict, halo: Dict[str, int],
                    batch_norms: int) -> Tuple[Dict, List[str]]:
    """`layout_child`'s records of one layout against the one process's
    record on the same data: (readings, the bars they miss). Bars:

    * every process ends each step with the same gradients and
      statistics and each eval with the same sums, bit for bit;
    * (a) the float64 step against one process: loss and grad_norm rel
      <= 1e-5, BN statistics within rtol 1e-4 / atol 1e-6, every
      gradient tensor whose norm is at least 1e-6 x grad_norm at cosine
      >= 0.9999; the float64 eval's EPE and D1 sums within rel 1e-5, the
      weight equal; where the records hold the float32 step and eval,
      its loss rel <= 1e-5, its statistics at the same bar and its eval
      weight equal (float32's cosines and eval gaps move with the order
      of summation alone, and are read);
    * (b) the collectives of each step by purpose: per train step one a
      batch norm (`batch_norms`), the mask count, the gradients and the
      loss, and under row sharding halo["forward"] + halo["backward"]
      halo exchanges (`LWSNet.halo_exchanges`); the eval one "eval", and
      under row sharding halo["forward"] exchanges and one "eval_shards";
      the bf16 steps LAYOUT_BF16_STEPS x the train step's;
    * (c) after the bf16 steps every process's parameters and buffers
      bit-identical (the largest difference is read);
    * finite bf16 losses, and no kernel launch."""
    fails = []
    first = records[0]
    dp, sp = first["layout"]
    tails = [t for t in ("", "_float32") if "step" + t in first]
    for r in records[1:]:
        for tail in tails:
            for key in ("grads", "buffers"):
                if not all(torch.equal(t, first["step" + tail][key][n])
                           for n, t in r["step" + tail][key].items()):
                    fails.append(f"step{tail}: the processes' {key} differ")
            if not all(torch.equal(t, first["eval" + tail][k])
                       for k, t in r["eval" + tail].items()
                       if k != "counts"):
                fails.append(f"eval{tail}: the processes' sums differ")
    step, want = first["step"], single["step"]
    cos = _cosines(step, want)
    least = min(cos, key=cos.get)
    stats = _stats(step, want)
    got_e, want_e = first["eval"], single["eval"]
    gaps = _gaps(got_e, want_e)
    biggest = 0.0
    for r in records[1:]:
        for key in ("params", "buffers"):
            for n, t in r["bf16"][key].items():
                biggest = max(biggest, float((t.double() - first["bf16"][
                    key][n].double()).abs().max()))
    readings = dict(layout=f"{dp} x {sp}",
                    loss_rel=_rel(step["loss"], want["loss"]),
                    grad_norm_rel=_rel(step["grad_norm"], want["grad_norm"]),
                    stats=stats, min_cosine=cos[least], least_tensor=least,
                    tensors_under=sum(c < 0.9999 for c in cos.values()),
                    eval_gaps=gaps, weight=float(got_e["weight"]),
                    bf16_max_diff=biggest,
                    counts={k: first[k]["counts"]
                            for k in ("step", "eval", "bf16")})
    if readings["loss_rel"] > 1e-5 or readings["grad_norm_rel"] > 1e-5 \
            or stats > 1.0:
        fails.append(f"float64 step: loss rel {readings['loss_rel']}, "
                     f"grad_norm rel {readings['grad_norm_rel']}, BN "
                     f"statistics {stats} of the bar")
    if readings["tensors_under"]:
        fails.append(f"float64 step: {readings['tensors_under']} gradient "
                     f"tensors under cosine 0.9999 (least {cos[least]}, "
                     f"{least})")
    if max(gaps.values()) > 1e-5 or \
            float(got_e["weight"]) != float(want_e["weight"]):
        fails.append(f"float64 eval: gaps {gaps}, weight "
                     f"{float(got_e['weight'])}")
    if "_float32" in tails:
        s32, w32 = first["step_float32"], single["step_float32"]
        e32, we32 = first["eval_float32"], single["eval_float32"]
        readings["float32"] = dict(
            loss_rel=_rel(s32["loss"], w32["loss"]),
            grad_norm_rel=_rel(s32["grad_norm"], w32["grad_norm"]),
            stats=_stats(s32, w32),
            min_cosine=min(_cosines(s32, w32).values()),
            eval_gaps=_gaps(e32, we32), weight=float(e32["weight"]))
        r32 = readings["float32"]
        if r32["loss_rel"] > 1e-5 or r32["stats"] > 1.0 or \
                r32["weight"] != float(we32["weight"]):
            fails.append(f"float32 step and eval: {r32}")
        readings["counts"].update(step_float32=s32["counts"],
                                  eval_float32=e32["counts"])
    train = {"batch_norm": batch_norms, "loss_count": 1, "gradients": 1,
             "loss": 1}
    evals = {"eval": 1}
    if sp > 1:
        train["halo"] = halo["forward"] + halo["backward"]
        evals.update(halo=halo["forward"], eval_shards=1)
    want_counts = dict(bf16={k: LAYOUT_BF16_STEPS * v
                             for k, v in train.items()})
    for tail in tails:
        want_counts.update({"step" + tail: train, "eval" + tail: evals})
    for r in records:
        for key, counts in want_counts.items():
            if r[key]["counts"] != counts:
                fails.append(f"{key} collectives {r[key]['counts']} != "
                             f"{counts}")
        if not np.isfinite(r["bf16"]["losses"]).all():
            fails.append(f"bf16 losses {r['bf16']['losses']}")
        if any(r["launches"].values()):
            fails.append(f"training launched kernels: {r['launches']}")
    if biggest:
        fails.append(f"bf16 steps: parameters or statistics differ between "
                     f"processes by up to {biggest}")
    return readings, fails


def _agree(ranks: list) -> None:
    for r in ranks[1:]:
        for what in ("params", "buffers"):
            for k, v in r[what].items():
                if not torch.equal(v, ranks[0][what][k]):
                    raise AssertionError(f"{what} {k} differs between "
                                         f"processes")


def dryrun(n: int, timeout: float = 120.0, spatial: int = 1,
           device: str = "cpu") -> Dict[str, float]:
    """The N-process step against the single-process one (loss rel 1e-5;
    every process's parameters and statistics equal); with `spatial` > 1
    also the N-process data x spatial step against the data-parallel one
    (within 1e-2 x max(1, |loss|)). On `device`: gloo processes on the
    CPU, or process r on card r under NCCL and the single-process step on
    card 0, TF32 off (`spawn`). Returns the losses."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.device import resolve_device
    from lwsnet_tpu_torch.tools.parity import tf32_off
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    batch = {"l": rng.standard_normal((n, H, W, 3)).astype(np.float32),
             "r": rng.standard_normal((n, H, W, 3)).astype(np.float32),
             "g": rng.uniform(1.0, 100.0, (n, H, W)).astype(np.float32)}
    ranks = run_step(n, batch, timeout=timeout, device=device)
    _agree(ranks)
    cfg = TrainConfig(**TRAIN_KW)
    st = create_train_state(ModelConfig(compute_dtype="float32"), cfg,
                            seed=0, device=dev)
    with tf32_off():
        _, aux = make_train_step(cfg, 1)(
            st, *[torch.from_numpy(batch[k]).to(dev)
                  for k in ("l", "r", "g")])
    loss, single = float(ranks[0]["aux"]["loss"]), float(aux["loss"])
    if not (np.isfinite(loss) and abs(loss - single) <= 1e-5 * abs(single)):
        raise AssertionError(f"{n}-process loss {loss} != single-process "
                             f"loss {single}")
    print(f"dryrun_ddp({n}): ok, loss={loss:.6f}, single-process "
          f"loss={single:.6f}, collectives {ranks[0]['counts']}")
    out = {"loss": loss, "single_loss": single}
    if spatial == 1:
        return out
    sp_ranks = run_step(n, batch, timeout=timeout, spatial=spatial,
                        device=device)
    _agree(sp_ranks)
    loss_sp = float(sp_ranks[0]["aux"]["loss"])
    gap = abs(loss_sp - loss) / max(1.0, abs(loss))
    if not (np.isfinite(loss_sp) and gap < 1e-2):
        raise AssertionError(f"{n // spatial} x {spatial} data x spatial "
                             f"loss {loss_sp} != data-parallel loss {loss}")
    print(f"dryrun_ddp({n}, spatial {spatial}): ok, data-parallel "
          f"loss={loss:.6f}, {n // spatial} x {spatial} data x spatial "
          f"loss={loss_sp:.6f}, gap {gap:.3e} of max(1, |loss|) (bar "
          f"1e-2), collectives {sp_ranks[0]['counts']}")
    return dict(out, spatial_loss=loss_sp, spatial_gap=gap)


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--spatial", type=int, default=1,
                   help="also run the step as processes/S data slices x S "
                        "row shards")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                   help="gloo processes on the CPU, or one process a card "
                        "under NCCL")
    args = p.parse_args(argv)
    return dryrun(args.processes, args.timeout, args.spatial, args.device)


if __name__ == "__main__":
    main()
