#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`lwsnet_tpu_torch`) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the Hopper kernels from `lwsnet_tpu_torch/csrc/` and drives the
port's main path, the 368x1232 batch-1 bf16 4-stage inference forward, on
seeded random weights. Phases, in order; any failure exits non-zero:

  1. the card's name and power limit;
  2. build every kernel (nvcc, sm_90a) and print ptxas register / shared
     memory lines;
  3. every kernel against its plain PyTorch version at each shape the main
     path gives it, in float32 (TF32 off; atol 2e-4, rtol 1e-3) and bf16
     (mean |delta| < 2 % of the plain output's span);
  4. the full forward through `make_forward` (kernels) against the module
     path on the card: bf16 per-stage mean |delta| < 2 % of span, float32
     max |delta| < 1e-3 x span; the launch counters of the bf16 kernel run
     must be conv3d_bn_relu 15, conv3d_skip_softargmin 3, dense3x3 11
     (1 of them two-input);
  5. `InferenceEngine` answers 4 seeded requests at num_stages 1..4, with
     per-stage latency from CUDA events after a warm-up, and one
     torch.profiler window gives the 4-stage forward's device busy share;
  6. each kernel timed at its main-path shapes beside its plain version and
     one cuDNN call, and its bound from bytes and operations.

Without CUDA it exits 1 and prints no result. Details of the run are also
written to chiprun_out/chip_smoke.json.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H, W = 368, 1232          # KITTI eval window
PEAK_BF16 = 989e12        # H100 SXM dense tensor-core FLOP/s (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def jitter_batchnorm(model, rng):
    """Non-identity BN statistics and affines, so every fold is exercised."""
    import torch
    from lwsnet_tpu_torch.models.blocks import BatchNorm
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                for t, v in ((m.weight, rng.uniform(0.5, 1.5, c)),
                             (m.bias, rng.normal(0.0, 0.1, c)),
                             (m.running_mean, rng.normal(0.0, 0.1, c)),
                             (m.running_var, rng.uniform(0.5, 1.5, c))):
                    t.copy_(torch.as_tensor(v, dtype=torch.float32))


def event_times(fn, reps=20, warmup=3):
    """Device milliseconds of each of `reps` runs of fn(), each between its
    own pair of CUDA events, after `warmup` runs."""
    import torch
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


def event_ms(fn):
    """Median of `event_times`."""
    return statistics.median(event_times(fn))


PORT_KERNELS = ("conv3d_bn_relu", "skip_softargmin", "dense3x3")


def device_profile(fn, reps=5):
    """One torch.profiler window over `reps` runs of fn(), after a warm-up.
    Returns per-run host-clock ms, device-busy ms (the union of kernel
    intervals), the port's kernels' ms, and the five costliest other
    kernels; None when the profiler recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    port, other = 0.0, {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        if any(k in name for k in PORT_KERNELS):
            port += e - s
        else:
            other[name] = other.get(name, 0.0) + e - s
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    return dict(wall_ms=wall_us / reps / 1e3, busy_ms=busy / reps / 1e3,
                port_kernels_ms=port / reps / 1e3,
                other_kernels_ms=sum(other.values()) / reps / 1e3,
                top_other=[(n[:80], t / reps / 1e3) for n, t in top])


# --- the kernels' main-path calls ------------------------------------------

def main_path_calls(cfg):
    """Every distinct kernel call of the 368x1232 batch-1 forward:
    (kernel, label, shape dict, launches per forward)."""
    calls = []
    for s in range(3):
        h, w = H // 8 * 2 ** s, W // 8 * 2 ** s
        D = cfg.max_disp_list[s] if s == 0 else 2 * cfg.max_disp_list[s] - 1
        C = cfg.channels_3d * cfg.growth_rate[s]
        geo = dict(B=1, D=D, H=h, W=w)
        calls.append(("conv3d_bn_relu", f"stage{s + 1} 1->{C}",
                      dict(geo, Ci=1, Co=C), 1))
        calls.append(("conv3d_bn_relu", f"stage{s + 1} {C}->{C}",
                      dict(geo, Ci=C, Co=C), cfg.layers_3d))
        calls.append(("conv3d_skip_softargmin", f"stage{s + 1} {C}->1",
                      dict(geo, Ci=C, start=0 if s == 0 else
                           -cfg.max_disp_list[s] + 1), 1))
    c = cfg.refine_channels
    geo = dict(H=H, W=W)
    calls.append(("dense3x3", "tower entry 3->32 G=2",
                  dict(geo, B=2, G=2, Ci=3, Co=c, d=1, aff=False), 1))
    for d in (2, 4, 8, 16):
        calls.append(("dense3x3", f"tower 32->32 d={d} G=2",
                      dict(geo, B=2, G=2, Ci=c, Co=c, d=d, aff=True), 1))
    calls.append(("dense3x3", "head entry 2x32->32 d=8 (dual)",
                  dict(geo, B=1, G=1, Ci=c, Co=c, d=8, aff=True, dual=True),
                  1))
    for d in (8, 4, 2, 1):
        calls.append(("dense3x3", f"head 32->32 d={d}",
                      dict(geo, B=1, G=1, Ci=c, Co=c, d=d, aff=True), 1))
    calls.append(("dense3x3", "out 32->1 f32 out",
                  dict(geo, B=1, G=1, Ci=c, Co=1, d=1, aff=False,
                       f32_out=True), 1))
    return calls


def make_call(kernel, p, dtype, rng, dev):
    """(kernel fn, plain fn, library fn, bytes, operations) on seeded random
    operands for one main-path call."""
    import torch
    import torch.nn.functional as F
    from lwsnet_tpu_torch.ops.cuda import costfilter as CF
    from lwsnet_tpu_torch.ops.cuda import refine_rows as RR

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=torch.float32).to(dev, dt)

    es = torch.tensor([], dtype=dtype).element_size()
    if kernel == "conv3d_bn_relu":
        B, Ci, Co, D, h, w = (p[k] for k in ("B", "Ci", "Co", "D", "H", "W"))
        x = t(np.maximum(rng.standard_normal((B, Ci, D, h, w)), 0))
        wt = t(rng.standard_normal((Co, Ci, 3, 3, 3)) * np.sqrt(2 / (27 * Ci)))
        shift = t(rng.normal(0, 0.1, Co), torch.float32)
        n_in = B * Ci * D * h * w
        n_out = B * Co * D * h * w
        return (lambda: CF.conv3d_bn_relu(x, wt, shift),
                lambda: CF.conv3d_bn_relu_plain(x, wt, shift),
                lambda: F.conv3d(x, wt, padding=1),
                (n_in + n_out + wt.numel()) * es + 4 * Co,
                2 * 27 * Ci * n_out)
    if kernel == "conv3d_skip_softargmin":
        B, Ci, D, h, w = (p[k] for k in ("B", "Ci", "D", "H", "W"))
        x = t(np.maximum(rng.standard_normal((B, Ci, D, h, w)), 0))
        wt = t(rng.standard_normal((1, Ci, 3, 3, 3)) * np.sqrt(2 / (27 * Ci)))
        vol = t(rng.standard_normal((B, D, h, w)) * 2)
        start = p["start"]
        n_vox = B * D * h * w
        return (lambda: CF.conv3d_skip_softargmin(x, wt, vol, start),
                lambda: CF.conv3d_skip_softargmin_plain(x, wt, vol, start),
                lambda: F.conv3d(x, wt, padding=1),
                (B * Ci * D * h * w + n_vox + wt.numel()) * es + 4 * B * h * w,
                2 * 27 * Ci * n_vox + 5 * n_vox)
    B, G, Ci, Co, d, h, w = (p[k] for k in ("B", "G", "Ci", "Co", "d", "H",
                                            "W"))
    dual = p.get("dual", False)
    out_dt = torch.float32 if p.get("f32_out") else dtype
    x = t(rng.standard_normal((B, Ci, h, w)))
    wt = t(rng.standard_normal((G, Co, Ci, 3, 3)) * np.sqrt(2 / (9 * Ci)))
    aff = None
    if p["aff"]:
        aff = t(np.stack([rng.uniform(0.5, 1.5, (G, Ci)),
                          rng.normal(0, 0.5, (G, Ci))], 1), torch.float32)
    kw = dict(dilation=d, affine=aff, out_dtype=out_dt)
    if dual:
        x2 = t(rng.standard_normal((B, Ci, h, w)))
        wt2 = t(rng.standard_normal((G, Co, Ci, 3, 3)) * np.sqrt(2 / (9 * Ci)))
        aff2 = t(np.stack([rng.uniform(0.5, 1.5, (G, Ci)),
                           rng.normal(0, 0.5, (G, Ci))], 1), torch.float32)
        kw.update(x2=x2, wt2=wt2, affine2=aff2)
        both = torch.cat([x, x2], 1)  # yardstick operand, built once
        wcat = torch.cat([wt[0], wt2[0]], 1)
        library = lambda: F.conv2d(both, wcat, padding=d, dilation=d)  # noqa
    elif G > 1:
        xg = x.reshape(B // G, G * Ci, h, w)
        wg = wt.reshape(G * Co, Ci, 3, 3)
        library = lambda: F.conv2d(xg, wg, padding=d, dilation=d,  # noqa
                                   groups=G)
    else:
        library = lambda: F.conv2d(x, wt[0], padding=d, dilation=d)  # noqa
    n_in = (2 if dual else 1) * B * Ci * h * w
    n_out = B * Co * h * w
    out_es = torch.tensor([], dtype=out_dt).element_size()
    return (lambda: RR.dense3x3(x, wt, **kw),
            lambda: RR.dense3x3_plain(x, wt, **kw),
            library,
            (n_in + (2 if dual else 1) * wt.numel()) * es + n_out * out_es,
            2 * 9 * Ci * n_out * (2 if dual else 1))


def check_close(got, want, dtype, what):
    """Phase-3 bar; returns (max |delta|, span)."""
    import torch
    got, want = got.float(), want.float()
    require(torch.isfinite(got).all().item(), f"{what}: non-finite output")
    delta = (got - want).abs()
    span = (want.max() - want.min()).item()
    require(span >= 1e-3, f"{what}: span {span:.3g} < 1e-3, ill-posed check")
    if dtype == torch.float32:
        bad = (delta > 2e-4 + 1e-3 * want.abs()).sum().item()
        require(bad == 0, f"{what}: {bad} elements outside atol 2e-4 / rtol "
                f"1e-3 (max |delta| {delta.max().item():.3g})")
    else:
        mean = delta.mean().item()
        require(mean < 0.02 * span, f"{what}: mean |delta| {mean:.3g} >= 2% "
                f"of span {span:.3g}")
    return delta.max().item(), span


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import lwsnet_tpu_torch  # noqa: F401  (fails outside the repository)
    from lwsnet_tpu_torch import InferenceEngine, LWSNet, ModelConfig
    from lwsnet_tpu_torch import make_forward
    from lwsnet_tpu_torch.ops.cuda import build

    dev = torch.device("cuda")
    report = {}
    t_start = time.time()

    # 1. the card
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {smi}")
    print(f"[1] torch.cuda.get_device_name(0): {name}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    report["card"] = smi
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[1] TF32 off for cuDNN and matmul: float32 checks and yardsticks "
          "run in full float32")

    # 2. build
    t0 = time.time()
    logs = build.build_all()
    print(f"[2] kernels built in {time.time() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                print(f"[2] {src}: {line.strip()}")

    cfg = ModelConfig()
    calls = main_path_calls(cfg)

    # 3. kernels against their plain versions
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (kernel, label, p, _) in enumerate(calls):
            rng = np.random.default_rng(1000 + i)
            k_fn, plain_fn, _, _, _ = make_call(kernel, p, dtype, rng, dev)
            got = k_fn()
            want = plain_fn()
            torch.cuda.synchronize()
            what = f"{kernel} [{label}] {str(dtype)[6:]}"
            err, span = check_close(got, want, dtype, what)
            checks.setdefault(kernel, {})[(label, str(dtype)[6:])] = err
            print(f"[3] ok {what}: max |delta| {err:.3g}, span {span:.4g}")
    build.reset_launch_counts()

    # 4. the whole forward, kernels vs module path
    left_np = np.random.default_rng(1).standard_normal((1, H, W, 3))
    right_np = np.random.default_rng(2).standard_normal((1, H, W, 3))
    counts = None
    forward_report = {}
    for dt in ("bfloat16", "float32"):
        cfg_dt = ModelConfig(compute_dtype=dt)
        model = LWSNet(cfg_dt, device=dev, seed=0)
        jitter_batchnorm(model, np.random.default_rng(3))
        left = torch.as_tensor(left_np, dtype=torch.float32, device=dev)
        right = torch.as_tensor(right_np, dtype=torch.float32, device=dev)
        plain = make_forward(model, use_pallas=False, device=dev)(left, right)
        fwd = make_forward(model, use_pallas=True, device=dev)
        build.reset_launch_counts()
        got = fwd(left, right)
        torch.cuda.synchronize()
        if dt == "bfloat16":
            counts = build.launch_counts()
        rows = []
        for s, (a, b) in enumerate(zip(plain, got)):
            require(tuple(b.shape) == (1, H, W, 1), f"stage {s + 1} shape")
            require(torch.isfinite(b).all().item(), f"stage {s + 1} finite")
            span = (a.max() - a.min()).item() + 1.0
            delta = (a - b).abs()
            mean, mx = delta.mean().item(), delta.max().item()
            rows.append(dict(stage=s + 1, span=span, mean_abs=mean,
                             max_abs=mx))
            print(f"[4] {dt} stage {s + 1}: span {span:.4g}, mean |delta| "
                  f"{mean:.4g} ({100 * mean / span:.3f} %), max |delta| "
                  f"{mx:.4g} ({100 * mx / span:.3f} %)")
            if dt == "bfloat16":
                require(mean < 0.02 * span, f"bf16 stage {s + 1}: mean "
                        f"|delta| >= 2% of span")
            else:
                require(mx < 1e-3 * span, f"f32 stage {s + 1}: max |delta| "
                        f">= 1e-3 x span")
        forward_report[dt] = rows
        del model, plain, got
    print(f"[4] launch counts of the bf16 kernel forward: {counts}")
    want_counts = {"conv3d_bn_relu": 15, "conv3d_skip_softargmin": 3,
                   "dense3x3": 11, "dense3x3[dual]": 1}
    require(counts == want_counts, f"launch counts {counts} != {want_counts}")
    report["forward"] = forward_report
    report["launch_counts"] = counts

    # 5. the inference engine: 4 seeded requests, num_stages 1..4
    model = LWSNet(cfg, device="cpu", seed=0)
    jitter_batchnorm(model, np.random.default_rng(3))
    engine = InferenceEngine(cfg, model.state_dict(), device=dev)
    latency = {}
    for req in range(4):
        rng = np.random.default_rng(100 + req)
        l_img = rng.uniform(0, 1, (375, 1242, 3)).astype(np.float32)
        r_img = rng.uniform(0, 1, (375, 1242, 3)).astype(np.float32)
        l, r = engine.preprocess(l_img, r_img)
        full = engine(l, r, num_stages=4)
        for stages in (1, 2, 3, 4):
            outs = engine(l, r, num_stages=stages)
            require(len(outs) == stages, "stage count")
            for s, o in enumerate(outs):
                require(o.shape == (1, H, W) and np.isfinite(o).all(),
                        f"request {req} stages {stages}: stage {s + 1}")
                span = float(full[s].max() - full[s].min()) + 1.0
                require(np.abs(o - full[s]).mean() < 1e-3 * span,
                        f"request {req}: stages={stages} is not a prefix")
    l, r = engine.preprocess(l_img, r_img)
    for stages in (1, 2, 3, 4):
        fwd = make_forward(engine.model, num_stages=stages, device=dev)
        plain = make_forward(engine.model, num_stages=stages,
                             use_pallas=False, device=dev)
        kt, pt = event_times(lambda: fwd(l, r)), event_times(
            lambda: plain(l, r))
        latency[stages] = dict(
            kernels_ms=statistics.median(kt), kernels_max_ms=kt[-1],
            plain_ms=statistics.median(pt), plain_max_ms=pt[-1],
            samples=len(kt))
        print(f"[5] num_stages={stages}: kernel path median "
              f"{latency[stages]['kernels_ms']:.3f} ms (max {kt[-1]:.3f}), "
              f"module path median {latency[stages]['plain_ms']:.3f} ms "
              f"(max {pt[-1]:.3f}) over {len(kt)} 368x1232 bf16 batch-1 "
              f"forwards ({smi})")
    print("[5] InferenceEngine answered 4 requests at num_stages 1..4")
    report["latency_ms"] = latency
    fwd = make_forward(engine.model, num_stages=4, device=dev)
    prof = device_profile(lambda: fwd(l, r))
    report["profile_4_stages"] = prof
    if prof is None:
        print("[5] device busy share: not measured (the profiler recorded "
              "no device activity)")
    else:
        print(f"[5] profiled 4-stage kernel forward: host clock "
              f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} "
              f"ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %), of "
              f"which the port's kernels {prof['port_kernels_ms']:.3f} ms "
              f"and other kernels {prof['other_kernels_ms']:.3f} ms")
        for n, t in prof["top_other"]:
            print(f"[5]   other kernel {t:.3f} ms: {n}")
    del engine, model

    # 6. kernel times at the main-path shapes
    per_shape = []
    totals = {}
    for i, (kernel, label, p, n) in enumerate(calls):
        rng = np.random.default_rng(2000 + i)
        k_fn, plain_fn, lib_fn, nbytes, ops = make_call(
            kernel, p, torch.bfloat16, rng, dev)
        ms = event_ms(k_fn)
        plain_ms = event_ms(plain_fn)
        lib_ms = event_ms(lib_fn)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_BF16 * 1e3
        row = dict(kernel=kernel, label=label, launches=n, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                   operations=ops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        per_shape.append(row)
        tot = totals.setdefault(kernel, dict(ms=0.0, plain_ms=0.0,
                                             library_ms=0.0, bytes_ms=0.0,
                                             ops_ms=0.0, bound_ms=0.0))
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[k] += n * row[k]
        tot["bytes_ms" if row["bound_by"] == "bytes" else "ops_ms"] += \
            n * row["bound_ms"]
        print(f"[6] {kernel} [{label}] x{n}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, cuDNN {lib_ms:.4f} ms, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    report["per_shape"] = per_shape

    replaces = {
        "conv3d_bn_relu": "lwsnet_tpu/ops/pallas/costfilter.py:138 "
                          "(_dgrid_kernel); lwsnet_tpu/ops/pallas/"
                          "costfilter.py:345 (_folded_kernel)",
        "conv3d_skip_softargmin": "lwsnet_tpu/ops/pallas/costfilter.py:382 "
                                  "(_folded_last_kernel)",
        "dense3x3": "lwsnet_tpu/ops/pallas/refine_rows.py:243 "
                    "(_dense_kernel); lwsnet_tpu/ops/pallas/"
                    "refine_rows.py:271 (_dense2_kernel)",
    }
    line = []
    for k in build.KERNELS:
        tot = totals[k.name]
        line.append(dict(
            name=k.name, route="cuda", source=k.source,
            replaces=replaces[k.name], launches=counts[k.name],
            max_abs_err=max(v for (_, d), v in checks[k.name].items()
                            if d == "bfloat16"),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                      else "operations"),
            library_ms=tot["library_ms"]))
    report["kernels"] = line
    report["seconds"] = time.time() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"[6] per forward (ms are launches x per-launch time; "
          f"bound from {PEAK_BF16 / 1e12:.0f} TFLOP/s bf16 and "
          f"{PEAK_BYTES / 1e12:.2f} TB/s)")
    print(f"card: {smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
