"""Data-parallel scaling sweep: train-step time and frames/s against the
process count.

Counterpart of the JAX package's `examples/scaling_sweep.py`: the full
train step (`training.steps.make_train_step`, pretrain mask) over 1..N
processes of one `torch.distributed` group, one device each, started by
`tools.dryrun_ddp.spawn` (NCCL on the cards; gloo on the CPU with
`--cpu`). The global batch grows with the processes (weak scaling) or
stays at `--global-batch` (strong scaling); the JSON has the JAX tool's
keys and efficiency rule (BASELINE.md: >= 85 % at 2+ hosts):

    python -m lwsnet_tpu_torch.tools.scaling_sweep --devices 1 2 4 8 \
        [--cpu] [--height 256 --width 512 --per-device-batch 4] \
        [--iters 8] [--global-batch 0] [--out results/scaling_sweep.json]

Each point: one warm-up step, then `--iters` steps timed on the host
clock of process 0, the loss fetched (a synchronisation) after the last.
On the card in bf16; with `--cpu` in float32, each process on one thread
of this host's shared cores. A process count above the cards present is
not run: one card runs only `--devices 1` and the sweep says so, rather
than putting two processes on one card. Without `--cpu` it needs a card
and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

POINT_TIMEOUT_S = 600.0  # each point's processes, start-up included


def step_child(rank: int, world: int, batch: int, h: int, w: int,
               iters: int, device: str, out_dir: str) -> None:
    """`iters` timed train steps of this process's slice of a seeded global
    batch of `batch`, after one warm-up step; process 0 writes
    {"step_s", "loss"} to `out_dir`/point.json."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.parallel import mesh
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_train_step

    dev = mesh.process_device(device)
    cfg = TrainConfig(train_batch_size=batch, mask_max_disp=192.0)
    model_cfg = ModelConfig(
        compute_dtype="float32" if dev.type == "cpu" else "bfloat16")
    state = create_train_state(model_cfg, cfg, seed=0, device=dev)
    step = make_train_step(cfg, steps_per_epoch=100)
    rng = np.random.default_rng(0)
    data = {"l": rng.standard_normal((batch, h, w, 3)),
            "r": rng.standard_normal((batch, h, w, 3)),
            "g": rng.uniform(1, 100, (batch, h, w))}
    per = batch // world
    l, r, g = (torch.as_tensor(data[k][rank * per:(rank + 1) * per],
                               dtype=torch.float32, device=dev)
               for k in ("l", "r", "g"))
    state, aux = step(state, l, r, g)  # warm-up: cuDNN plans, allocator
    float(aux["loss"])
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, aux = step(state, l, r, g)
    loss = float(aux["loss"])  # waits for the last step
    dt = (time.perf_counter() - t0) / iters
    if rank == 0:
        with open(os.path.join(out_dir, "point.json"), "w") as f:
            json.dump({"step_s": dt, "loss": loss}, f)


def efficiency(results, strong: bool, shared_cores: bool
               ) -> Dict[int, float]:
    """Per process count past the first, ideal / measured step time in %.
    The ideal: real devices, strong: base x n0 / n (the work splits);
    real devices, weak: flat; shared cores, strong: flat (total work
    constant); shared cores, weak: base x n / n0 (n x the work, same
    host)."""
    effs = {}
    base_n, base_dt, _ = results[0]
    for n, dt, _ in results[1:]:
        if strong:
            ideal = base_dt if shared_cores else base_dt * base_n / n
        else:
            ideal = base_dt * n / base_n if shared_cores else base_dt
        effs[n] = round(ideal / dt * 100.0, 1)
    return effs


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--cpu", action="store_true",
                   help="gloo processes on this host's CPU cores")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--per-device-batch", type=int, default=4)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--out", type=str,
                   default="results/scaling_sweep.json")
    p.add_argument("--global-batch", type=int, default=0,
                   help="fixed global batch -> STRONG scaling")
    args = p.parse_args(argv)

    from lwsnet_tpu_torch.tools.dryrun_ddp import spawn

    device = "cpu" if args.cpu else "cuda"
    if args.cpu:
        avail = os.cpu_count() or 1
    elif torch.cuda.is_available():
        avail = torch.cuda.device_count()
    else:
        raise RuntimeError("scaling_sweep runs on the cards (NCCL) and "
                           "none is present; pass --cpu for gloo "
                           "processes on the CPU")
    sizes = [d for d in args.devices if d <= avail]
    skipped = [d for d in args.devices if d > avail]
    backend = "cpu" if args.cpu else "cuda"
    print(f"# devices available: {avail} ({backend}); sweeping {sizes}")
    if skipped:
        print(f"# not run: {skipped} processes need as many "
              f"{'cores' if args.cpu else 'cards'}; {avail} present")

    h, w = args.height, args.width
    results = []
    for n in sizes:
        batch = args.global_batch or n * args.per_device_batch
        if batch % n:
            raise ValueError(f"global batch {batch} does not split over "
                             f"{n} processes")
        with tempfile.TemporaryDirectory() as tmp:
            spawn(step_child, n, (batch, h, w, args.iters, device, tmp),
                  timeout=POINT_TIMEOUT_S, device=device)
            with open(os.path.join(tmp, "point.json")) as f:
                point = json.load(f)
        dt = point["step_s"]
        results.append((n, dt, batch / dt))
        print(f"devices={n:2d} global_batch={batch:3d} "
              f"step={dt * 1000:8.2f} ms  {batch / dt:8.1f} frames/s")

    mode = "strong" if args.global_batch else "weak"
    shared_cores = args.cpu
    effs = {}
    if len(results) > 1:
        effs = efficiency(results, bool(args.global_batch), shared_cores)
        print(f"\n# {mode}-scaling efficiency vs smallest group:")
        for n, eff in effs.items():
            print(f"devices={n:2d}: {eff:6.1f} %")
    if shared_cores:
        note = ("gloo processes on one host's shared cores: this validates "
                "the data-parallel step and bounds its collective overhead, "
                "but is NOT a card-scaling measurement. "
                + ("Strong: total work constant, ideal step time flat."
                   if args.global_batch else
                   "Weak: n x the work on fixed cores, ideal step time "
                   "linear in n."))
    else:
        note = f"real-device {mode} scaling (NCCL)"
    if skipped:
        note += (f"; process counts {skipped} not run: only {avail} "
                 f"device(s) present")
    result = {
        "backend": backend,
        "device": (torch.cuda.get_device_name(0) if not args.cpu else "cpu"),
        "mode": mode,
        "note": note,
        "height": h, "width": w,
        "global_batch": args.global_batch or None,
        "per_device_batch": args.per_device_batch,
        "points": [{"devices": n, "step_ms": dt * 1000,
                    "frames_per_s": fps} for n, dt, fps in results],
        "efficiency_pct": effs,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
