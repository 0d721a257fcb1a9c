"""Device timing on the card with CUDA events.

Counterpart of the JAX package's `utils/timing.py`. That module was built
for a TPU behind a high-latency link, where a host clock measures dispatch
round trips; it loops the op inside one compiled program and differences
two loop lengths. On a local card a pair of CUDA events around the launches
measures the device time directly, after a warm-up that takes the kernel
builds, cuDNN plans and allocator growth out of the reading.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable, List

import torch


def card() -> str:
    """The first card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them: every time is kept beside it, since a card set below its
    maximum power runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA card; "
                           "torch.cuda.is_available() is False")


def event_times(fn: Callable[[], object], reps: int = 20,
                warmup: int = 3) -> List[float]:
    """Device milliseconds of each of `reps` runs of fn(), each between its
    own pair of CUDA events, after `warmup` runs; sorted."""
    _require_card()
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for begin, end in pairs:
        begin.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(begin.elapsed_time(end) for begin, end in pairs)


def event_ms(fn: Callable[[], object]) -> float:
    """Median of `event_times`."""
    return statistics.median(event_times(fn))


def device_time(fn: Callable[[], object], iters: int = 10, warmup: int = 3,
                repeats: int = 3) -> float:
    """Per-call device seconds of fn(): `repeats` runs of `iters`
    back-to-back calls, each run between one pair of CUDA events, after
    `warmup` calls; the fastest run over `iters`. Host stalls only ever
    make a run slower, so the minimum is the robust estimate."""
    _require_card()
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(max(1, repeats)):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, begin.elapsed_time(end))
    return best / iters / 1e3
