"""Per-stage and per-component device time of the 4-stage forward at
368x1232.

Counterpart of the JAX package's `examples/profile_forward.py`, on the
card (it raises without one). On the seed-0 network in bf16, batch 1, from
CUDA events (`utils.timing.device_time`: the fastest of 3 runs of 10
calls, over 10), beside the card's name and power limit:

  * the kernel path (`make_forward`) at num_stages = 1..4, each with its
    increment over the one before, then the module path the same way;
  * the components alone: the feature extractor on the 2B batch, each
    scale's volume (full at scale 0, residual after), each scale's cost
    filter (the module's cuDNN convs, and the Hopper kernels' filter +
    skip + soft-argmin), the two refinement towers and the head (modules),
    and `refine_residual` on the kernels;
  * the analytic conv GFLOPs of each stage count (`utils.flops`) and what
    each forward's time makes of them.

    python -m lwsnet_tpu_torch.tools.profile_forward [--trace DIR]

`--trace DIR` also writes one warm 4-stage kernel forward as a
`torch.profiler` Chrome trace (CPU and CUDA activity),
DIR/forward_trace.json; the forward's per-stage ranges (`stage1` ..
`stage3`, `stage4_refinement`) group the launches, and `trace_ranges`
lists the kernels each range launched.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

H, W = 368, 1232
STAGE_RANGES = ("stage1", "stage2", "stage3", "stage4_refinement")


def trace_ranges(path: str) -> Dict[str, List[str]]:
    """{range: names of the device kernels launched inside it} for each of
    STAGE_RANGES found in the Chrome trace at `path`. A kernel belongs to
    a range when the runtime call that launched it (matched by its
    correlation id) lies inside the range's interval on the host thread
    that ran the range, or when the kernel lies inside the range's
    interval on the device (the profiler's `gpu_user_annotation`)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    host = [e for e in spans if e.get("cat") == "user_annotation"
            and e["name"] in STAGE_RANGES]
    device = [e for e in spans if e.get("cat") == "gpu_user_annotation"
              and e["name"] in STAGE_RANGES]
    kernels = [e for e in spans if e.get("cat") == "kernel"]
    launch = {e["args"]["correlation"]: e for e in spans
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}

    def inside(t, r, tid=None):
        return (r["ts"] <= t <= r["ts"] + r["dur"]
                and (tid is None or r.get("tid") == tid))

    out: Dict[str, set] = {r["name"]: set() for r in host + device}
    for k in kernels:
        call = launch.get(k.get("args", {}).get("correlation"))
        for r in host:
            if call is not None and inside(call["ts"], r, call.get("tid")):
                out[r["name"]].add(k["name"])
        for r in device:
            if inside(k["ts"], r):
                out[r["name"]].add(k["name"])
    return {name: sorted(v) for name, v in out.items()}


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace", type=str, default="",
                   help="directory for a torch.profiler trace of the "
                        "4-stage kernel forward")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_forward times the forward on the card; "
                           "torch.cuda.is_available() is False")

    from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward
    from lwsnet_tpu_torch.models.refine_kernels import refine_residual
    from lwsnet_tpu_torch.ops import stereo
    from lwsnet_tpu_torch.ops.cuda.costfilter import filter_soft_argmin
    from lwsnet_tpu_torch.utils.flops import forward_flops
    from lwsnet_tpu_torch.utils.timing import card, device_time

    dev = torch.device("cuda")
    cfg = ModelConfig()
    dt = cfg.dtype
    model = LWSNet(cfg, device=dev)
    rng = np.random.default_rng(0)
    left, right = (torch.as_tensor(rng.standard_normal((1, H, W, 3)),
                                   dtype=torch.float32, device=dev)
                   for _ in range(2))
    smi = card()
    print(f"card: {smi}; seed-0 network, {cfg.compute_dtype}, batch 1, "
          f"{H}x{W}")
    report: Dict = {"card": smi, "forward_ms": {}, "components_ms": {},
                    "gflops": {}}

    def t(fn) -> float:
        with torch.inference_mode():
            return device_time(fn, iters=10) * 1e3

    for path, kernels in (("kernels", True), ("module", False)):
        prev, rows = 0.0, {}
        for k in range(1, 5):
            fwd = make_forward(model, num_stages=k, use_pallas=kernels,
                               device=dev)
            ms = t(lambda: fwd(left, right))
            gflops = forward_flops(cfg, H, W, 1, k) / 1e9
            report["gflops"][k] = gflops
            rows[k] = {"ms": ms, "increment_ms": ms - prev}
            print(f"{path:7s} forward stages=1..{k}: {ms:8.3f} ms "
                  f"(+{ms - prev:7.3f}); {gflops:.2f} GFLOP, "
                  f"{gflops / ms:.2f} TFLOP/s")
            prev = ms
        report["forward_ms"][path] = rows
        if kernels and args.trace:
            report["trace"] = _trace(make_forward(model, num_stages=4,
                                                  device=dev),
                                     left, right, args.trace)

    comp = report["components_ms"]

    def say(label: str, ms: float) -> None:
        comp[label] = ms
        print(f"{label}: {ms:8.3f} ms")

    with torch.inference_mode():
        fe = model.FeatureExtractor_0
        both = torch.cat([left, right], 0).permute(0, 3, 1, 2).to(dt)
        say("feature extraction (2B batch)", t(lambda: fe(both)))
        feats = [f.permute(0, 2, 3, 1) for f in fe(both)]
        for scale, D in enumerate(cfg.max_disp_list):
            fl, fr = feats[scale][:1], feats[scale][1:]
            fh, fw, fc = fl.shape[1], fl.shape[2], fl.shape[3]
            if scale == 0:
                say(f"scale{scale} full volume   ({fh}x{fw}x{fc}, D={D})",
                    t(lambda: stereo.build_cost_volume(fl, fr, D)))
                nd, start = D, 0
            else:
                disp = torch.full((1, fh, fw), 3.0, device=dev)
                say(f"scale{scale} resid volume  ({fh}x{fw}x{fc}, D={D})",
                    t(lambda: stereo.build_residual_volume(fl, fr, disp, D)))
                nd, start = 2 * D - 1, -D + 1
            vol = torch.zeros((1, fh, fw, nd), dtype=dt, device=dev)
            filt = getattr(model, f"CostFilter3D_{scale}")
            C = cfg.channels_3d * cfg.growth_rate[scale]
            say(f"scale{scale} 3D filter     (D={nd}, {fh}x{fw}, C={C}), "
                f"module", t(lambda: filt(vol)))
            params, stats = (dict(filt.named_parameters()),
                             dict(filt.named_buffers()))
            say(f"scale{scale} 3D filter + skip + soft-argmin, kernels",
                t(lambda: filter_soft_argmin(
                    vol, params, stats, layers=cfg.layers_3d, channels=C,
                    start=start, dtype=dt)))
        img = left.permute(0, 3, 1, 2).to(dt)
        say("refinement tower (RGB, full res)",
            t(lambda: model.RefinementTower_0(img)))
        dfull = torch.zeros((1, 1, H, W), dtype=dt, device=dev)
        say("refinement tower (disp, full res)",
            t(lambda: model.RefinementTower_1(dfull)))
        cat = torch.zeros((1, 2 * cfg.refine_channels, H, W), dtype=dt,
                          device=dev)
        say("refinement head (full res)",
            t(lambda: model.RefinementHead_0(cat)))
        dnhwc = torch.zeros((1, H, W, 1), device=dev)
        say(f"refine_residual, kernels ({cfg.rows_dw})",
            t(lambda: refine_residual(model, left, dnhwc)))
    return report


def _trace(fwd, left, right, directory: str) -> Dict:
    """One warm 4-stage forward under torch.profiler (CPU and CUDA),
    written to `directory`/forward_trace.json; {path, ranges}."""
    from torch.profiler import ProfilerActivity, profile

    fwd(left, right)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd(left, right)
        torch.cuda.synchronize()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "forward_trace.json")
    prof.export_chrome_trace(path)
    ranges = trace_ranges(path)
    print(f"wrote the torch.profiler trace to {path}")
    for name in STAGE_RANGES:
        print(f"  {name}: {len(ranges.get(name, []))} kernel name(s): "
              f"{', '.join(n[:60] for n in ranges.get(name, []))}")
    return {"path": path, "ranges": ranges}


if __name__ == "__main__":
    main()
