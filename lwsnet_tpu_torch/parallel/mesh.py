"""Data x spatial training over `torch.distributed`.

The port's counterpart of the JAX package's `parallel/mesh.py`. Under pjit
the JAX train step gets from the partitioner batch-norm statistics over the
global batch, the loss normalized by the global mask count, gradients and
eval sums reduced over every device, and, on a `spatial` mesh axis, the
convolutions' halo rows. The port makes them by hand with the collectives
below and `parallel/halo.py`. Each is called by the module that needs it
(`models/blocks`, `ops/stereo`, `training/losses`, `training/steps`) and
does nothing while no process group is initialized, so one process runs
the single-process arithmetic unchanged.

Launch one process per card under `torchrun`, which sets WORLD_SIZE,
RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    torchrun --nproc_per_node=N -m lwsnet_tpu_torch.cli.pretrain ...

**Layout** (`MeshConfig`, set by `maybe_initialize_distributed` or
`set_layout`, which `Trainer(mesh_cfg=...)` calls): the world's ranks form
a `data_parallel` x `spatial_parallel` grid, rank = d * sp + s, as the JAX
mesh reshapes its device list to (dp, sp). Process (d, s) reads the data
slice `order[d::dp]` of each epoch (`data/pipeline.py`) and the image rows
`row_range(H)` of each batch: shard boundaries fall on multiples of 8 rows,
so every level of the 1/8 pyramid splits on whole rows, and the shards
are as even as that allows, larger first (368 rows at 4 shards: 96, 96,
88, 88). The `sp` processes of one data slice form a spatial group
(`spatial_group`), over which the halo rows travel. With
`spatial_parallel == 1` there is no spatial group and every process holds
whole images, as before row sharding.

`collective_counts()` counts the collectives by purpose since the last
`reset_collective_counts()`: at world size 1 every collective is an
identity, and the counts show that the distributed path ran.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from lwsnet_tpu_torch.config import MeshConfig
from lwsnet_tpu_torch.device import resolve_device

# Collectives run by purpose: "batch_norm" (one per train-mode BN
# forward), "loss_count", "loss", "gradients", "eval", "barrier"; under row
# sharding also "halo" (one per halo exchange, forward or backward) and
# "eval_shards" (an eval step's per-example sums over the spatial group).
_COUNTS: Dict[str, int] = {}

ROW_ALIGN = 8  # shard boundaries: multiples of the pyramid's 1/8


@dataclass(frozen=True)
class _Layout:
    """The data x spatial grid of one process group."""

    world: object                 # the default group it was made for
    data: int
    spatial: int
    group: Optional[object]       # this process's spatial group


_LAYOUT: Optional[_Layout] = None


def collective_counts() -> Dict[str, int]:
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _count(what: str) -> None:
    _COUNTS[what] = _COUNTS.get(what, 0) + 1


def check_mesh(cfg: MeshConfig, world: int) -> Tuple[int, int]:
    """(data_parallel, spatial_parallel) of `cfg` over `world` processes;
    raises ValueError for a layout the world cannot hold."""
    sp = cfg.spatial_parallel
    if sp < 1 or world % sp:
        raise ValueError(f"MeshConfig.spatial_parallel={sp} does not "
                         f"divide the world of {world} processes")
    dp = world // sp
    if cfg.data_parallel not in (-1, dp):
        raise ValueError(f"MeshConfig data_parallel={cfg.data_parallel} x "
                         f"spatial_parallel={sp} != {world} processes")
    return dp, sp


def is_distributed() -> bool:
    """True while a default process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def maybe_initialize_distributed(device="cuda", init_method: str = "env://",
                                 mesh_cfg: MeshConfig = MeshConfig(),
                                 backend: Optional[str] = None) -> bool:
    """Initialize the default process group when the launcher's
    environment names one (WORLD_SIZE, RANK, LOCAL_RANK; MASTER_ADDR and
    MASTER_PORT for the default `env://` rendezvous), then lay it out as
    `mesh_cfg` says (`set_layout`); a no-op without WORLD_SIZE, and no new
    group when one is already up. `backend` defaults to NCCL for a CUDA
    `device` (raises without a card) and gloo for the CPU; a CUDA process
    runs on `device`'s index, or on LOCAL_RANK's card for a `device`
    without one. Raises ValueError for a layout the world cannot hold.
    Returns whether a group is initialized."""
    if not is_distributed():
        world = int(os.environ.get("WORLD_SIZE", 1))
        check_mesh(mesh_cfg, world)
        if "WORLD_SIZE" not in os.environ:
            return False
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else local_rank())
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method, rank=int(os.environ["RANK"]),
            world_size=world)
    set_layout(mesh_cfg)
    return True


def set_layout(cfg: MeshConfig) -> None:
    """Lay the process group out as `cfg`'s data x spatial grid (without a
    group: check that one process holds it). Every process calls it with
    the same `cfg`: it makes the spatial groups, each process taking part
    in making every one, in the same order."""
    global _LAYOUT
    dp, sp = check_mesh(cfg, process_count())
    if not is_distributed():
        return
    world = dist.group.WORLD
    if _LAYOUT is not None and _LAYOUT.world is world and (
            _LAYOUT.data, _LAYOUT.spatial) == (dp, sp):
        return
    group = None
    if sp > 1:
        for d in range(dp):
            g = dist.new_group(list(range(d * sp, (d + 1) * sp)))
            if d == dist.get_rank() // sp:
                group = g
    _LAYOUT = _Layout(world, dp, sp, group)


def _layout() -> Optional[_Layout]:
    """The layout of the live default group, or None (all data)."""
    if _LAYOUT is not None and is_distributed() and \
            _LAYOUT.world is dist.group.WORLD:
        return _LAYOUT
    return None


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def spatial_count() -> int:
    """Row shards per image: the layout's spatial_parallel (1 without a
    group or a spatial layout)."""
    lay = _layout()
    return lay.spatial if lay is not None else 1


def spatial_index() -> int:
    """This process's row shard, 0 at the top."""
    return process_index() % spatial_count()


def data_count() -> int:
    """Data slices: the layout's data_parallel (the world without a
    spatial layout)."""
    return process_count() // spatial_count()


def data_index() -> int:
    """This process's data slice."""
    return process_index() // spatial_count()


def spatial_group():
    """This process's spatial group (None without row sharding)."""
    lay = _layout()
    return lay.group if lay is not None else None


def shard_rows(height: int, shards: int) -> List[int]:
    """Row counts of `shards` shards of `height` rows: boundaries on
    multiples of ROW_ALIGN, as even as that allows, larger first."""
    if height % ROW_ALIGN:
        raise ValueError(f"{height} rows: row sharding needs a multiple of "
                         f"{ROW_ALIGN}")
    blocks = height // ROW_ALIGN
    if blocks < shards:
        raise ValueError(f"{height} rows cannot make {shards} shards of "
                         f"at least {ROW_ALIGN} rows")
    q, rem = divmod(blocks, shards)
    return [ROW_ALIGN * (q + (s < rem)) for s in range(shards)]


def row_range(height: int) -> Tuple[int, int]:
    """This process's rows [r0, r1) of an image `height` rows tall."""
    n = spatial_count()
    if n == 1:
        return 0, height
    sizes = shard_rows(height, n)
    s = spatial_index()
    r0 = sum(sizes[:s])
    return r0, r0 + sizes[s]


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


def all_reduce_spatial_(t: torch.Tensor, what: str) -> torch.Tensor:
    """Sum `t` over this process's spatial group in place, outside
    autograd; a no-op without row sharding."""
    if spatial_count() > 1:
        _count(what)
        dist.all_reduce(t, group=spatial_group())
    return t


def all_gather_spatial(t: torch.Tensor, what: str) -> List[torch.Tensor]:
    """`t` of every process of the spatial group, in row order, outside
    autograd. Every process passes a tensor of one shape and dtype."""
    _count(what)
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(spatial_count())]
    dist.all_gather(out, t, group=spatial_group())
    return out


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
