"""Data-parallel training over `torch.distributed`.

The port's counterpart of the JAX package's `parallel/mesh.py`, data part.
Under pjit the JAX train step gets three things from the partitioner:
batch-norm statistics over the global batch, the loss normalized by the
global mask count, and gradients and eval sums reduced over every device.
The port makes them by hand with the collectives below. Each is called by
the module that needs it (`models/blocks.BatchNorm`, `training/losses`,
`training/steps`) and does nothing while no process group is initialized,
so one process runs the single-process arithmetic unchanged.

Launch one process per card under `torchrun`, which sets WORLD_SIZE,
RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    torchrun --nproc_per_node=N -m lwsnet_tpu_torch.cli.pretrain ...

Process p trains on `cuda:LOCAL_RANK` and reads the slice
`order[p::N]` of each epoch (`data/pipeline.py`).

`collective_counts()` counts the collectives by purpose since the last
`reset_collective_counts()`: at world size 1 every collective is an
identity, and the counts show that the distributed path ran.

The JAX package's row sharding (`MeshConfig.spatial_parallel`, image rows
on a `spatial` axis with GSPMD's halo exchanges) is not ported: more than
one row shard raises.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from lwsnet_tpu_torch.config import MeshConfig
from lwsnet_tpu_torch.device import resolve_device

# Collectives run by purpose: "batch_norm" (one per train-mode BN
# forward), "loss_count", "loss", "gradients", "eval", "barrier".
_COUNTS: Dict[str, int] = {}


def collective_counts() -> Dict[str, int]:
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _count(what: str) -> None:
    _COUNTS[what] = _COUNTS.get(what, 0) + 1


def check_mesh(cfg: MeshConfig) -> None:
    """Raises for a layout the port does not run: row sharding."""
    if cfg.spatial_parallel > 1:
        raise NotImplementedError(
            f"MeshConfig.spatial_parallel={cfg.spatial_parallel}: the "
            f"port shards the batch only; row sharding is not ported")


def is_distributed() -> bool:
    """True while a default process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def maybe_initialize_distributed(device="cuda", init_method: str = "env://",
                                 mesh_cfg: MeshConfig = MeshConfig()
                                 ) -> bool:
    """Initialize the default process group when the launcher's
    environment names one (WORLD_SIZE, RANK, LOCAL_RANK; MASTER_ADDR and
    MASTER_PORT for the default `env://` rendezvous); a no-op without
    WORLD_SIZE or when a group is already up. NCCL for a CUDA `device`
    (raises without a card), gloo for the CPU. Returns whether a group is
    initialized."""
    check_mesh(mesh_cfg)
    if is_distributed():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return True


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_device(device="cuda") -> torch.device:
    """This process's device: `cuda:LOCAL_RANK` for a CUDA `device` given
    without an index under a process group, else `device` itself."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and is_distributed():
        return torch.device("cuda", local_rank())
    return dev


def all_reduce_(t: torch.Tensor, what: str) -> torch.Tensor:
    """Sum `t` over the processes in place, outside autograd."""
    if is_distributed():
        _count(what)
        dist.all_reduce(t)
    return t


def all_reduce_autograd(t: torch.Tensor, what: str) -> torch.Tensor:
    """The sum of `t` over the processes; its backward sums the incoming
    gradients over the processes too, so each process's input receives
    the share of every process's loss (torch.distributed.nn)."""
    if not is_distributed():
        return t
    from torch.distributed.nn.functional import all_reduce
    _count(what)
    return all_reduce(t)


def all_reduce_flat_(tensors: Sequence[torch.Tensor], what: str) -> None:
    """Sum tensors of one dtype and device over the processes in place,
    in one collective over their flat concatenation."""
    if not is_distributed():
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, what)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def barrier() -> None:
    if is_distributed():
        _count("barrier")
        dist.barrier()
