"""CPU dryrun of data-parallel and data x spatial training over gloo.

The port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`: N CPU processes under a gloo process
group each take their slice of one float32 train step of the full-width
model at 32x64 on one global batch of N examples, and the loss they
report must match a single-process step on the whole batch, with every
process holding the same parameters and batch-norm statistics
afterwards. With `--spatial S` the same N processes then run the step
again as N/S data slices x S row shards (halo exchanges at every shard
edge), and its loss must lie within 1e-2 x max(1, |loss|) of the
data-parallel one, as the JAX dryrun asks.

    python -m lwsnet_tpu_torch.tools.dryrun_ddp [--processes N] [--spatial S]

`spawn` starts such processes for any module-level target (the tests,
`tools.scaling_sweep` on the card under NCCL, and `chip_smoke.py`'s
two row shards on one card under gloo): each rendezvouses through a file,
lays the group out as `spatial` row shards, runs on one torch thread and
is joined within a time limit, after which every process still running
is killed and `spawn` raises.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

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
                     state_path: str, train_kw: Dict, out_dir: str) -> None:
    """One float32 train step of process `rank` on its part of the global
    batch in `batch_path` (npz: l, r, g; `local_part`), from the state
    dict in `state_path` ("" for the seed-0 init). Saves to
    `<out_dir>/rank<rank>.pt` the step's aux, the gradients the update used,
    the parameters, Adam's moments, the buffers and the collective
    counts."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.parallel import mesh
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step

    batch = np.load(batch_path)
    cfg = TrainConfig(**train_kw)
    st = create_train_state(ModelConfig(compute_dtype="float32"), cfg,
                            seed=0, device="cpu")
    if state_path:
        st.model.load_state_dict(torch.load(state_path), strict=True)
    mesh.reset_collective_counts()
    st, aux = make_train_step(cfg, 1)(st, *local_part(batch, "lrg"))
    named = list(st.model.named_parameters())
    torch.save(dict(
        aux={k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in aux.items()},
        grads={n: p.grad.clone() for n, p in named},
        params={n: p.detach().clone() for n, p in named},
        exp_avg={n: st.optimizer.state[p]["exp_avg"].clone()
                 for n, p in named},
        exp_avg_sq={n: st.optimizer.state[p]["exp_avg_sq"].clone()
                    for n, p in named},
        buffers={n: b.clone() for n, b in st.model.named_buffers()},
        counts=mesh.collective_counts()),
        os.path.join(out_dir, f"rank{rank}.pt"))


def run_step(world: int, batch: Dict[str, np.ndarray], state_path: str = "",
             train_kw: Dict = TRAIN_KW, timeout: float = 120.0,
             workdir: Optional[str] = None, target: Callable = None,
             extra: Sequence = (), spatial: int = 1) -> list:
    """`train_step_child` (or `target`, called with `extra` before the
    usual arguments) in `world` processes laid out as `spatial` row
    shards, on `batch`; returns each rank's saved record."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        batch_path = os.path.join(tmp, "batch.npz")
        np.savez(batch_path, **batch)
        spawn(target or train_step_child, world,
              tuple(extra) + (batch_path, state_path, dict(train_kw), tmp),
              timeout, tmp, spatial=spatial)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(world)]


def _agree(ranks: list) -> None:
    for r in ranks[1:]:
        for what in ("params", "buffers"):
            for k, v in r[what].items():
                if not torch.equal(v, ranks[0][what][k]):
                    raise AssertionError(f"{what} {k} differs between "
                                         f"processes")


def dryrun(n: int, timeout: float = 120.0, spatial: int = 1
           ) -> Dict[str, float]:
    """The N-process step against the single-process one (loss rel 1e-5;
    every process's parameters and statistics equal); with `spatial` > 1
    also the N-process data x spatial step against the data-parallel one
    (within 1e-2 x max(1, |loss|)). Returns the losses."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step

    rng = np.random.default_rng(0)
    batch = {"l": rng.standard_normal((n, H, W, 3)).astype(np.float32),
             "r": rng.standard_normal((n, H, W, 3)).astype(np.float32),
             "g": rng.uniform(1.0, 100.0, (n, H, W)).astype(np.float32)}
    ranks = run_step(n, batch, timeout=timeout)
    _agree(ranks)
    cfg = TrainConfig(**TRAIN_KW)
    st = create_train_state(ModelConfig(compute_dtype="float32"), cfg,
                            seed=0, device="cpu")
    _, aux = make_train_step(cfg, 1)(
        st, *[torch.from_numpy(batch[k]) for k in ("l", "r", "g")])
    loss, single = float(ranks[0]["aux"]["loss"]), float(aux["loss"])
    if not (np.isfinite(loss) and abs(loss - single) <= 1e-5 * abs(single)):
        raise AssertionError(f"{n}-process loss {loss} != single-process "
                             f"loss {single}")
    print(f"dryrun_ddp({n}): ok, loss={loss:.6f}, single-process "
          f"loss={single:.6f}, collectives {ranks[0]['counts']}")
    out = {"loss": loss, "single_loss": single}
    if spatial == 1:
        return out
    sp_ranks = run_step(n, batch, timeout=timeout, spatial=spatial)
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
    args = p.parse_args(argv)
    return dryrun(args.processes, args.timeout, args.spatial)


if __name__ == "__main__":
    main()
