"""CPU dryrun of data-parallel training over gloo.

The port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip` (its data part): N CPU processes under a
gloo process group each take their slice of one float32 train step of the
full-width model at 32x64 on one global batch of N examples, and the loss
they report must match a single-process step on the whole batch, with
every process holding the same parameters and batch-norm statistics
afterwards.

    python -m lwsnet_tpu_torch.tools.dryrun_ddp [--processes N]

`spawn` starts such processes for any module-level target (the tests and
`tools.scaling_sweep` use it, the latter on the card under NCCL): each
rendezvouses through a file, runs on one torch thread and is joined
within a time limit, after which every process still running is
killed and `spawn` raises.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

H, W = 32, 64
TRAIN_KW = dict(mask_max_disp=192.0)


def _child(target: Callable, rank: int, world: int, init_method: str,
           args: Sequence, device: str) -> None:
    import torch.distributed as dist

    from lwsnet_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    mesh.maybe_initialize_distributed(device, init_method=init_method)
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(target: Callable, world: int, args: Sequence = (),
          timeout: float = 120.0, rendezvous_dir: Optional[str] = None,
          device: str = "cpu") -> None:
    """Run target(rank, world, *args) in `world` fresh processes under one
    group (rendezvous file in `rendezvous_dir`, default a new temporary
    directory): gloo on the CPU, or NCCL with `device="cuda"`, process r
    on card r. Waits at most `timeout` seconds for all of them:
    then kills those still running and raises TimeoutError; raises
    RuntimeError if any exited with another code than 0."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_child,
                             args=(target, rank, world, init, tuple(args),
                                   device))
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


def train_step_child(rank: int, world: int, batch_path: str,
                     state_path: str, train_kw: Dict, out_dir: str) -> None:
    """One float32 train step of process `rank` on its contiguous slice of
    the global batch in `batch_path` (npz: l, r, g), from the state dict in
    `state_path` ("" for the seed-0 init). Saves to
    `<out_dir>/rank<rank>.pt` the step's aux, the gradients the update used,
    the parameters, Adam's moments, the buffers and the collective
    counts."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.parallel import mesh
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step

    batch = np.load(batch_path)
    per = len(batch["l"]) // world
    part = slice(rank * per, (rank + 1) * per)
    cfg = TrainConfig(**train_kw)
    st = create_train_state(ModelConfig(compute_dtype="float32"), cfg,
                            seed=0, device="cpu")
    if state_path:
        st.model.load_state_dict(torch.load(state_path), strict=True)
    mesh.reset_collective_counts()
    st, aux = make_train_step(cfg, 1)(
        st, *[torch.from_numpy(batch[k][part]) for k in ("l", "r", "g")])
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
             extra: Sequence = ()) -> list:
    """`train_step_child` (or `target`, called with `extra` before the
    usual arguments) in `world` processes on `batch`; returns each rank's
    saved record."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        batch_path = os.path.join(tmp, "batch.npz")
        np.savez(batch_path, **batch)
        spawn(target or train_step_child, world,
              tuple(extra) + (batch_path, state_path, dict(train_kw), tmp),
              timeout, tmp)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(world)]


def dryrun(n: int, timeout: float = 120.0) -> Dict[str, float]:
    """The N-process step against the single-process one (loss rel 1e-5;
    every process's parameters and statistics equal). Returns the losses."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step

    rng = np.random.default_rng(0)
    batch = {"l": rng.standard_normal((n, H, W, 3)).astype(np.float32),
             "r": rng.standard_normal((n, H, W, 3)).astype(np.float32),
             "g": rng.uniform(1.0, 100.0, (n, H, W)).astype(np.float32)}
    ranks = run_step(n, batch, timeout=timeout)
    for r in ranks[1:]:
        for what in ("params", "buffers"):
            for k, v in r[what].items():
                if not torch.equal(v, ranks[0][what][k]):
                    raise AssertionError(f"{what} {k} differs between "
                                         f"processes")
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
    return {"loss": loss, "single_loss": single}


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--timeout", type=float, default=120.0)
    args = p.parse_args(argv)
    return dryrun(args.processes, args.timeout)


if __name__ == "__main__":
    main()
