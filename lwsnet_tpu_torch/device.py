"""Device selection shared by the port's entry points.

Entry points default to the card. Without one they raise: nothing carries
on quietly on the CPU. Callers that mean the CPU (the tests) say so.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`; raises if it names CUDA and no card is
    present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lwsnet_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
