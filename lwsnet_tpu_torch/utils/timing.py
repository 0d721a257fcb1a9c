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
import time
from typing import Callable, List, Tuple

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
    """Seconds a call of fn() at the pace of back-to-back calls: `repeats`
    runs of `iters` calls, each run between one pair of CUDA events, after
    `warmup` calls; the fastest run over `iters`. Host stalls only ever
    make a run slower, so the minimum is the robust estimate. The events
    wait for the launches, so where fn() spends longer on the host than
    its kernels take on the device (the 4-stage forward does), this reads
    the host's pace, not device time alone: `profile_window` and
    `busy_ms` give that."""
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


def profile_window(fn: Callable[[], object], reps: int = 5
                   ) -> Tuple[float, List[Tuple[float, float, str]]]:
    """One torch.profiler window (CPU and CUDA activity) over `reps` calls
    of fn(), after one warm call: (host-clock ms a call, [(start us, end
    us, name)] of the device kernels, sorted). The device rows of
    `record_function` ranges (`LWSNet.forward`'s stage ranges) are not
    kernels and are left out: each spans its stage's idle gaps too. The
    list is empty when the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _require_card()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation)
    return wall_ms, spans


def busy_ms(spans: List[Tuple[float, float, str]], reps: int) -> float:
    """Device-busy ms a call: the union of the (sorted) kernel intervals
    of `spans` over `reps` calls."""
    busy, end = 0.0, float("-inf")
    for s, e, _ in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy / reps / 1e3
