#!/usr/bin/env python3
"""Each port kernel alone on one GPU, at every shape its paths give it.

Run from the repository root on a machine with a card:

    python3 kernel_device_times.py [--package-root DIR] [--nchw]
                                   [--forwards] [--configs] [--widths]
                                   [--dtype {bfloat16,float32}]
                                   [--json PATH]

For every kernel call of `chip_smoke.py` (phases 3 and 6: the 368x1232
batch-1 bf16 forward under each refinement path, every dw-sep solo and
pair shape among them, the "layers" refinement at 96x3712; at each stage
the entry, the C->C layers and the fused last layer, each on its own) it
builds the
same seeded operands and prints the device time of the kernel alone,
from one torch.profiler window over 10 calls after a warm-up
(`chip_smoke.kernel_device_ms`, which runs a window again where the
profiler dropped most of its kernels): without the wrapper's host time,
which a pair of events around one call also counts, and without the
wrappers' layout copies and weight re-layouts, which are separate
kernels. Each `chain3x3` stack is also timed cut after its first k layers,
k = 2 .. n (the same operands, the cut layer writing the compute dtype):
the step from k - 1 to k layers is layer k's time in the launch, its grid
barrier and set-up included, to hold beside the same layer's `dense3x3`
launch alone.

--forwards also profiles the 368x1232 batch-1 bf16
4-stage forward (`make_forward`, seeded random weights) under each engine
of `chip_smoke.PROFILED` over one torch.profiler window of 5 forwards
(`chip_smoke.device_profile`): its device busy time, the union of kernel
intervals.

Then it lists the narrow launches on their own, each with its wrapper's
host time a call (`chip_smoke.host_us`): dense3x3's "mxu" / "vpu" tower
entry (3->32, G = 2) and 32->1 float32 output, and the "layers" entries
(3->32, 1->32) and 32->1 bf16 output; and the three cost filters'
entries of conv3d_bn_relu (1->32, 1->8, 1->8; in a checkout from before
the fused entry, the layer alone on the activated volume). Last, each
stage's entry and its first C->C layer in one call (`entry_pairs`): the
C->C layer reads what the entry just wrote, as in the forward, so the
pair's time shows what the entry's stores cost the next layer.

--configs times, in place of the shipped path's calls, the cost filters'
launches of `chip_smoke.py` phase 14e (`chip_smoke.timed_calls`:
AnyNet's settings, the 64-channel filter over D = 72 and the fused last
layer past D = 64 at 32 and 8 channels, each input in the layout its
tree's `filter_routes` gives), and --widths the "vpu" engines' dw-sep
launches of a 368x1232 forward at each of `chip_smoke.DWSEP_WIDTHS` (48,
20, 64), with each kernel's sum over a forward's launches; each as phase
14e times it (`chip_smoke.timing_rows`): the device time beside that of
its cuDNN call (one conv2d of the composed kernel, or for a dw-sep pair
one such conv a layer), events, the plain version and the bound.

--dtype float32 times, in place of all that, each launch group of the
shipped "mxu" forward (`chip_smoke.main_path_calls` in float32: rows 1a-5
of PERF.md's kernel table, 15 / 3 / 11 launches, each input in the layout
its tree's route rules give the float32 path) as phase 14e times a call
(`chip_smoke.timing_rows` in float32: the kernel alone on the device,
events, the plain version, the same cuDNN conv in float32 with TF32 off,
and the bound at float32's CUDA-core rate `chip_smoke.PEAK_FP32` or the
bytes), with each group's sum over a forward and its share of the bound;
with --forwards also the device busy of the float32 4-stage "mxu" forward
on the kernel path and on the module path. The default, bfloat16, prints
what it printed before the option.

--package-root DIR imports `lwsnet_tpu_torch` from another checkout (for
instance the parent commit unpacked with `git archive`), so two trees can
be compared on one card in one run (this checkout's `chip_smoke.py`
drives both: it is loaded after DIR heads the import path, so its own
imports of the package find DIR's); --nchw hands every kernel NCHW
operands (and leaves each layer's output layout to the wrapper), as a
checkout without channels-last routes needs (a checkout whose
conv3d_skip_softargmin reads NCDHW, for one). Exits 1
without CUDA.
"""

import argparse
import importlib.util
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package-root", default=None)
    ap.add_argument("--nchw", action="store_true")
    ap.add_argument("--forwards", action="store_true")
    ap.add_argument("--configs", action="store_true")
    ap.add_argument("--widths", action="store_true")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_device_times: no CUDA card", file=sys.stderr)
        return 1
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    # this checkout's chip_smoke.py, whose imports of the package resolve
    # through the path above
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import lwsnet_tpu_torch
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.utils.timing import card

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ModelConfig()
    calls = (cs.main_path_calls(cfg) + cs.variant_calls(cfg)
             + cs.layers_calls(cfg))
    rows = []
    root = os.path.dirname(lwsnet_tpu_torch.__file__)
    print(f"card: {card()}; package {root}")
    if args.configs or args.widths:
        return config_times(cs, args, dev)
    if args.dtype == "float32":
        return float32_times(cs, args, dev)
    for i, (kernel, label, p, n, engine) in enumerate(calls):
        if args.nchw:
            p = {k: v for k, v in p.items()
                 if k not in ("cl", "cl_out", "ncdhw_out")}
        c = cs.make_call(kernel, p, torch.bfloat16,
                         np.random.default_rng(2000 + i), dev)
        ms = cs.kernel_device_ms(c["kernel"], cs.KERNEL_NAMES[kernel])
        layer = None
        if kernel == "dense3x3" and (p["Ci"] * 9 <= 32 or p["Co"] <= 8):
            layer = "entry" if p["Co"] == 32 else "output"
        if kernel == "conv3d_bn_relu" and p.get("entry"):
            layer = "entry"
        row = dict(kernel=kernel, label=label, engine=engine, launches=n,
                   device_ms=ms, narrow=layer,
                   host_us=cs.host_us(c["kernel"]) if layer else None)
        del c
        rows.append(row)
        print(f"{kernel} [{label}] x{n} ({engine}): "
              f"{'not measured' if ms is None else f'{ms:.4f} ms'}")
    for r in rows:
        if r["narrow"]:
            ms = r["device_ms"]
            print(f"narrow {r['kernel']} {r['narrow']} [{r['label']}] "
                  f"x{r['launches']} "
                  f"({r['engine']}): "
                  f"{'not measured' if ms is None else f'{ms:.4f} ms'}, "
                  f"wrapper host {r['host_us']:.1f} us a call")
    prefixes = []
    for i, (kernel, label, p, n, engine) in enumerate(calls):
        if kernel != "chain3x3":
            continue
        if args.nchw:
            p = {k: v for k, v in p.items() if k != "cl"}
        layers = len(p["dils"])
        for k in range(2, layers + 1):
            cut = dict(p, dils=p["dils"][:k], aff=p["aff"][:k])
            if k < layers:
                cut.update(co_last=p["C"], f32_out=False)
            c = cs.make_call(kernel, cut, torch.bfloat16,
                             np.random.default_rng(2000 + i), dev)
            ms = cs.kernel_device_ms(c["kernel"], cs.KERNEL_NAMES[kernel])
            del c
            prefixes.append(dict(label=label, layers=k, device_ms=ms))
            print(f"{kernel} [{label}] first {k} of {layers} layers: "
                  f"{'not measured' if ms is None else f'{ms:.4f} ms'}")
    pairs = entry_pairs(cs, cfg, dev)
    forwards = {}
    if args.forwards:
        from lwsnet_tpu_torch import LWSNet, make_forward
        rng = np.random.default_rng(1)
        left, right = (torch.as_tensor(rng.standard_normal((1, cs.H, cs.W, 3)),
                                       dtype=torch.float32, device=dev)
                       for _ in range(2))
        for engine in cs.PROFILED:
            model = LWSNet(ModelConfig(**cs.ENGINES[engine]), device=dev,
                           seed=0)
            cs.jitter_batchnorm(model, np.random.default_rng(3))
            fwd = make_forward(model, device=dev)
            prof = cs.device_profile(lambda: fwd(left, right))
            forwards[engine] = prof
            print(f"4-stage {engine} forward: " + (
                "device busy not measured" if prof is None else
                f"device busy {prof['busy_ms']:.4f} ms, of which the port's "
                f"kernels {prof['port_kernels_ms']:.4f} ms"))
            del model, fwd
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card(), rows=rows, forwards=forwards,
                           chain_prefixes=prefixes, entry_pairs=pairs), f,
                      indent=1)
    return 0


def config_times(cs, args, dev):
    """--configs / --widths: the chosen calls of phase 14e, each kernel
    alone on the device beside its cuDNN call(s), with events, the plain
    version and the bound (`chip_smoke.timing_rows`)."""
    from lwsnet_tpu_torch.tools.parity_layers import ANYNET
    from lwsnet_tpu_torch.utils.timing import card
    from lwsnet_tpu_torch import ModelConfig
    calls = [(i, c) for i, c in cs.timed_calls(cs.config_calls(ANYNET))
             if args.configs and c[0] in cs.FILTER_KERNELS]
    if args.widths:  # the "vpu" engines' dw-sep launches at each width
        dwsep = [(k, label, p, n, f"width {w} {engine}")
                 for w in cs.DWSEP_WIDTHS
                 for k, label, p, n, engine in cs.variant_calls(
                     ModelConfig(refine_channels=w))
                 if k.startswith("dwsep") and "vpu" in engine]
        calls += list(enumerate(dwsep, 5000))
    rows = cs.timing_rows(calls, dev, card(), "kdt", 4000)
    for (_, c), r in zip(calls, rows):
        r["engine"] = c[4]
    # a forward's launches of each kernel at each width, summed
    totals = {}
    for r in rows:
        if r["engine"] and r["engine"].startswith("width"):
            key = f"{r['kernel']} {r['engine']}"
            t = totals.setdefault(key, dict(launches=0, device_ms=0.0,
                                            library_device_ms=0.0))
            t["launches"] += r["launches"]
            for k in ("device_ms", "library_device_ms"):
                t[k] = (None if t[k] is None or r[k] is None
                        else t[k] + r[k] * r["launches"])
    for key, t in totals.items():
        print(f"total {key}: {t['launches']} launches, " + ", ".join(
            "not measured" if v is None else f"{v:.4f} ms" for v in (
                t["device_ms"], t["library_device_ms"]))
            + f" (kernel, cuDNN) ({card()})")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card(), rows=rows, totals=totals), f,
                      indent=1)
    return 0


def float32_times(cs, args, dev):
    """--dtype float32: each launch group of the float32 "mxu" forward as
    `chip_smoke.timing_rows` times it, with its launches' sum and bound
    share; with --forwards the float32 4-stage forward's device busy on
    the kernel and the module path (`chip_smoke.device_profile`)."""
    import numpy as np
    import torch
    from lwsnet_tpu_torch import LWSNet, ModelConfig, make_forward
    from lwsnet_tpu_torch.tools.parity import tf32_off
    from lwsnet_tpu_torch.utils.timing import card
    smi = card()
    calls = list(enumerate(cs.main_path_calls(ModelConfig(), torch.float32)))
    rows = cs.timing_rows(calls, dev, smi, "kdt f32", 2000, torch.float32,
                          nchw=True)
    for r in rows:
        n, ms, bound = r["launches"], r["device_ms"], r["bound_ms"]
        lib, lib_nchw = r["library_device_ms"], r["library_nchw_device_ms"]
        print(f"float32 {r['kernel']} [{r['label']}] ({r['route']}) x{n} a "
              f"forward: device " + (
                  "not measured" if ms is None else
                  f"{ms * n:.4f} ms, {100 * bound / ms:.1f} % of its bound")
              + f", bound {bound * n:.4f} ms ({r['bound_by']}), cuDNN "
              + ("not measured" if lib is None else f"{lib * n:.4f} ms")
              + ("" if lib_nchw is None else
                 f" (on NCHW copies {lib_nchw * n:.4f} ms)")
              + f", events {r['ms'] * n:.4f} ms, plain "
              f"{r['plain_ms'] * n:.4f} ms ({smi})")
    forwards = {}
    if args.forwards:
        rng = np.random.default_rng(1)
        left, right = (torch.as_tensor(rng.standard_normal((1, cs.H, cs.W, 3)),
                                       dtype=torch.float32, device=dev)
                       for _ in range(2))
        model = LWSNet(ModelConfig(compute_dtype="float32"), device=dev,
                       seed=0)
        cs.jitter_batchnorm(model, np.random.default_rng(3))
        with tf32_off():
            for path, pallas in (("kernel", True), ("module", False)):
                fwd = make_forward(model, use_pallas=pallas, device=dev)
                prof = cs.device_profile(lambda: fwd(left, right))
                forwards[path] = prof
                print(f"4-stage float32 mxu forward, {path} path: " + (
                    "device busy not measured" if prof is None else
                    f"device busy {prof['busy_ms']:.4f} ms, of which the "
                    f"port's kernels {prof['port_kernels_ms']:.4f} ms") +
                    f" ({smi})")
        del model
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, dtype="float32", rows=rows,
                           forwards=forwards), f, indent=1)
    return 0


def entry_pairs(cs, cfg, dev):
    """Each stage's entry and its first C->C layer in one call, the layer
    reading the entry's output: [{label, device_ms}], the two kernels'
    device time a call (`chip_smoke.kernel_device_ms` over both)."""
    import numpy as np
    import torch
    from lwsnet_tpu_torch.ops.cuda import costfilter as CF
    convs = [c for c in cs.main_path_calls(cfg) if c[0] == "conv3d_bn_relu"]
    out = []
    for i, (entry, layer) in enumerate(zip(convs[0::2], convs[1::2])):
        rng = np.random.default_rng(3000 + i)
        first = cs.make_call(entry[0], entry[2], torch.bfloat16, rng,
                             dev)["kernel"]
        C = layer[2]["Co"]
        wt = torch.as_tensor(rng.standard_normal((C, C, 3, 3, 3))
                             * np.sqrt(2 / (27 * C)), dtype=torch.float32)
        wt = wt.to(dev, torch.bfloat16)
        shift = torch.as_tensor(rng.normal(0, 0.1, C), dtype=torch.float32,
                                device=dev)
        ms = cs.kernel_device_ms(
            lambda: CF.conv3d_bn_relu(first(), wt, shift),
            cs.KERNEL_NAMES["conv3d_bn_relu"])
        label = f"{entry[1]} + {layer[1]}"
        out.append(dict(label=label, device_ms=ms))
        print(f"entry pair [{label}]: "
              f"{'not measured' if ms is None else f'{ms:.4f} ms'}")
    return out


if __name__ == "__main__":
    sys.exit(main())
