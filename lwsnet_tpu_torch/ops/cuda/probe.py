"""The rows microbench's probe kernel on the card.

Counterpart of `bkernel` in the JAX package's `examples/microbench_rows.py`:
a (C, 1) column broadcast to (C, N). `lane_broadcast` launches the
`lane_broadcast` CUDA kernel for a CUDA tensor and runs
`lane_broadcast_plain`, beside it here, for a CPU tensor.
"""

from __future__ import annotations

import torch

from lwsnet_tpu_torch.ops.cuda.build import (LANE_BROADCAST, check, on_card,
                                             symbol_suffix)


def lane_broadcast_plain(v: torch.Tensor, n: int) -> torch.Tensor:
    """(C, 1) -> (C, n), every row its column's value."""
    return v.expand(v.shape[0], n).contiguous()


def lane_broadcast(v: torch.Tensor, n: int) -> torch.Tensor:
    """The lane_broadcast kernel; arguments as `lane_broadcast_plain`."""
    if not on_card(v):
        return lane_broadcast_plain(v, n)
    C = v.shape[0]
    check(v, "v", (C, 1), v.dtype, v.device)
    y = torch.empty((C, n), dtype=v.dtype, device=v.device)
    LANE_BROADCAST.launch(f"lane_broadcast_{symbol_suffix(v.dtype)}",
                          v.device, v.data_ptr(), y.data_ptr(), C, n)
    return y
