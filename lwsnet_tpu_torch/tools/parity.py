"""Kernel path against module path on one pair, and against JAX's outputs.

Counterpart of the JAX package's `examples/parity_tpu.py`: the 4-stage
forward through the Hopper kernels (`make_forward`, `use_pallas=True`)
and through the plain module path (the training path, the correctness
oracle) on one stereo pair, with per-stage finite flags, span, max and
mean |delta| and a PASS verdict, written as JSON:

    python -m lwsnet_tpu_torch.tools.parity [--dtype bfloat16] \
        [--ckpt DIR] [--left_img L --right_img R] \
        [--rows_dw mxu|vpu|chain] [--unpaired] [--pallas_mode rows|layers] \
        [--fixture tests/torch_fixtures/parity_368x1232.npz] \
        [--out results/PARITY.json] [--device cuda]

PASS: every stage finite on both paths, and mean |delta| < 2 % of the
module path's span (0.1 % in float32, TF32 off).

Without `--left_img` the pair is `fixture_pair(0)`: a seeded smooth
texture through `overfit_proof.synth_pair`, cropped to 368x1232; the JAX
tool's default pair, the reference's golden pair, is not in the
repository. `wide_pair(0)`, a ground plane whose disparity runs from 10
to 170 px down the rows over a texture of 16-pixel blocks, is the input
of the fixture's "trained_wide" set. Without `--ckpt`: the seed-0
random network. `--ckpt` takes a checkpoint directory of the port, or a
weights file with a set after a colon
(`tests/torch_fixtures/parity_weights.pt:trained`).

`--fixture` also holds each stage of each path, at the fixture's strided
pixels, against the JAX package's float32 module path on each of the
fixture's sets, each a weight set on an input pair
(`tests/torch_parity_fixture.py` writes it; `FIXTURE_BARS`, `STAGE_BARS`
and `KERNEL_FLOORS` give the fixed bars). It replaces the pair and
weights options. Runs on the card (raises without one) unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

H, W = 368, 1232  # KITTI eval window
SRC_H, SRC_W = 375, 1242  # KITTI frame
FIXTURE = os.path.join("tests", "torch_fixtures", "parity_368x1232.npz")
WEIGHTS = "parity_weights.pt"  # beside the fixture
SETS = ("random", "trained", "trained_wide")
# The weights file's state dict of each set: the "trained_wide" set runs
# the trained weights on `wide_pair`.
WEIGHTS_OF = {"random": "random", "trained": "trained",
              "trained_wide": "trained"}
# Bars against the JAX fixture, per stage (`check_fixture`), all fixed:
# each path's mean |delta| below FIXTURE_BARS[dtype] of the fixture
# stage's span, or below STAGE_BARS[(dtype, set, stage)] where that is
# given; the kernel path's mean |delta| at most KERNEL_RATIO x the module
# path's, or KERNEL_FLOORS[dtype] x span (not held in UNRATIOED); on the
# GUARDED sets the fixture
# stage spanning more than SPAN_GUARD of its bin range (`bin_range_px`).
FIXTURE_BARS = {"float32": 1e-3, "bfloat16": 2e-2}
# The seed-0 network amplifies bf16 rounding to 4.44-4.48 % of span at
# stage 4 on both paths; a x1.05 error in one refinement-head layer reads
# 4.61-4.63 % there (`tests/test_torch_parity.py`).
STAGE_BARS = {("bfloat16", "random", 4): 4.55e-2}
KERNEL_RATIO = 1.1
# On `wide_pair` the trained network's bf16 kernel path lies 1.15-1.21 x
# the module path's distance from JAX at every stage under every engine,
# above KERNEL_RATIO and the floor, while every launch meets its module
# layer (`tools.parity_layers`): stage 1's entry folds the next BN scale
# into bf16 weights, and with them in float32 the ratio falls within
# KERNEL_RATIO (`tests/test_torch_parity.py`). JAX's own Pallas filter
# folds the same way (`_aug_weights`) and lies as far from the float32
# filter on this stage-1 volume, 1.38 x the bf16 module filter: the gap
# is the kernel formulation's rounding, not a port fault
# (`tests/test_torch_stage1_fold.py`). No set-level ratio bar separates
# that rounding from a x1.05 fault in stage 2's filter (1.24-1.28 x), so
# the set is held in bf16 to its mean bars and the span guard.
UNRATIOED = (("bfloat16", "trained_wide"),)
# bf16 rounding alone puts the kernel path at 0.069 % of span against the
# module path's 0.056 % at trained stage 2; a x1.05 error in one of stage
# 2's filter layers on the kernel path alone reads 0.178 % there.
KERNEL_FLOORS = {"float32": 1e-4, "bfloat16": 1e-3}
SPAN_GUARD = 0.25
# The trained network's stage 1 sits near 16 px on `fixture_pair` and on a
# ground plane over `smooth_texture`: only `wide_pair`'s set spans its bins.
GUARDED = ("random", "trained_wide")


def mean_bar(dtype: str, name: str, stage: int) -> float:
    """The fixed mean |delta| bar, as a fraction of the fixture's span,
    of weight set `name`'s stage `stage` (1-4) in `dtype`."""
    return STAGE_BARS.get((dtype, name, stage), FIXTURE_BARS[dtype])


@contextlib.contextmanager
def tf32_off():
    """Full float32 in cuDNN and matmuls inside the block (the card's
    counterpart of JAX's "highest" matmul precision); the flags as they
    were after it."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = False
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def smooth_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w, 3) float32 in [0, 1]: three octaves (cells of 64, 16 and 4
    pixels) of bilinearly interpolated uniform noise."""
    img = np.zeros((h, w, 3), np.float32)
    for cell, weight in ((64, 0.5), (16, 0.3), (4, 0.2)):
        grid = rng.random((h // cell + 2, w // cell + 2, 3)).astype(
            np.float32)
        ys = np.arange(h, dtype=np.float32) / cell
        xs = np.arange(w, dtype=np.float32) / cell
        y0, x0 = ys.astype(np.int64), xs.astype(np.int64)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
        bot = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
        img += weight * (top * (1 - fy) + bot * fy)
    return img


def fixture_pair(seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right), each (H, W, 3) float32 and ImageNet-normalized: a
    `smooth_texture` strip of SRC_H x (SRC_W + MARGIN) through
    `overfit_proof.synth_pair` (disparities 18-34 px), bottom-right
    cropped to H x W. numpy only, from one generator seeded `seed`."""
    from lwsnet_tpu_torch.data import transforms as T
    from lwsnet_tpu_torch.tools.overfit_proof import MARGIN, synth_pair

    rng = np.random.default_rng(seed)
    left, right, _ = synth_pair(
        smooth_texture(rng, SRC_H, SRC_W + MARGIN), rng)
    return tuple(np.ascontiguousarray(
        T.normalize(T.bottom_right_crop(img, H, W)), np.float32)
        for img in (left, right))


WIDE_DISP = (10.0, 170.0)  # wide_pair's disparity at the top, bottom row
WIDE_MARGIN = 192           # wide_pair's source columns beyond the frame
WIDE_CELL = 16              # block_texture's cell in wide_pair, pixels


def block_texture(rng: np.random.Generator, h: int, w: int,
                  cell: int) -> np.ndarray:
    """(h, w, 3) float32: grey cells of `cell` x `cell` pixels, each 0 or 1
    with even odds."""
    grid = (rng.random((h // cell + 1, w // cell + 1)) < 0.5).astype(
        np.float32)
    img = np.repeat(np.repeat(grid, cell, 0), cell, 1)[:h, :w]
    return np.repeat(img[:, :, None], 3, 2)


def wide_pair(seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right), each (H, W, 3) float32 and ImageNet-normalized: a
    ground plane, whose disparity d(y) depends on the row alone, rising
    linearly from WIDE_DISP[0] at the top source row to WIDE_DISP[1] at the
    bottom, so the right view is exact, with no occlusion:
    right[y, u] = source[y, u + d(y)] by linear interpolation along the
    row, left = source[:, :SRC_W]. The source is a `block_texture` of
    SRC_H x (SRC_W + WIDE_MARGIN) with `overfit_proof.synth_pair`'s noise
    (0.6 texture + 0.4 noise averaged with its neighbours above and to the
    left); both views are bottom-right cropped to H x W. numpy only, from
    one generator seeded `seed`."""
    from lwsnet_tpu_torch.data import transforms as T

    rng = np.random.default_rng(seed)
    src = block_texture(rng, SRC_H, SRC_W + WIDE_MARGIN, WIDE_CELL)
    noise = rng.random(src.shape).astype(np.float32)
    noise = (noise + np.roll(noise, 1, 0) + np.roll(noise, 1, 1)) / 3.0
    src = np.clip(0.6 * src + 0.4 * noise, 0.0, 1.0)
    lo, hi = WIDE_DISP
    d = lo + (hi - lo) * np.arange(SRC_H, dtype=np.float64) / (SRC_H - 1)
    x = np.arange(SRC_W)[None, :] + d[:, None]
    i0 = np.floor(x).astype(np.int64)
    w1 = (x - i0).astype(np.float32)[..., None]
    rows = np.arange(SRC_H)[:, None]
    right = src[rows, i0] * (1 - w1) + src[rows, i0 + 1] * w1
    return tuple(np.ascontiguousarray(
        T.normalize(T.bottom_right_crop(img, H, W)), np.float32)
        for img in (src[:, :SRC_W], right))


def set_pair(name: str, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The input pair of the fixture's weight set `name`."""
    return {"random": random_pair, "trained": fixture_pair,
            "trained_wide": wide_pair}[name](seed)


def random_pair(seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right), each (H, W, 3) float32 standard normal, left drawn
    first from `numpy.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((H, W, 3)).astype(np.float32)
                 for _ in range(2))


def bin_range_px(cfg, stage: int) -> float:
    """The disparity range, in full-res pixels, of stage `stage` (1-4)'s
    soft-argmin bins: stage 1 searches [0, D1) at 1/8 res, stages 2-3
    offsets [-(D - 1), D - 1] at 1/4 and 1/2 res; stage 4 has no bins and
    takes stage 3's."""
    scale = min(stage, 3) - 1
    D = cfg.max_disp_list[scale]
    bins = D - 1 if scale == 0 else 2 * (D - 1)
    return float(bins * (8 >> scale))


def load_weights(spec: str) -> Optional[Dict[str, torch.Tensor]]:
    """The state dict `spec` names: None for "" (the seed-0 network), a
    checkpoint directory of the port, or `FILE:SET`, a set of a weights
    file that maps set names to state dicts (the fixture's)."""
    if not spec:
        return None
    if os.path.isdir(spec):
        path = os.path.join(spec, "checkpoint")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint in {spec}")
        return torch.load(path, map_location="cpu",
                          weights_only=True)["model"]
    path, _, name = spec.rpartition(":")
    if not path or not os.path.isfile(path):
        raise FileNotFoundError(f"{spec}: neither a checkpoint directory "
                                f"nor FILE:SET")
    return torch.load(path, map_location="cpu", weights_only=True)[name]


def delta_stats(ref: np.ndarray, got: np.ndarray) -> Dict[str, float]:
    """Span of `ref` and max / mean |got - ref|, in float64."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    span = float(ref.max() - ref.min()) + 1e-9
    d = np.abs(got - ref)
    return {"span": span, "max_abs_delta": float(d.max()),
            "mean_abs_delta": float(d.mean()),
            "mean_delta_pct_of_span": 100.0 * float(d.mean()) / span,
            "finite": bool(np.isfinite(got).all() and np.isfinite(ref).all())}


def build_model(cfg, state_dict, device):
    from lwsnet_tpu_torch import LWSNet

    model = LWSNet(cfg, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def run_paths(model, left: np.ndarray, right: np.ndarray, device
              ) -> Tuple[List[np.ndarray], List[np.ndarray], Dict]:
    """Both 4-stage forwards on one (H, W, 3) pair: (kernel path stages,
    module path stages) as (H, W) float32 arrays, and the kernel
    forward's launch counts (the counters set to 0 just before it)."""
    from lwsnet_tpu_torch import make_forward
    from lwsnet_tpu_torch.ops.cuda import build

    l, r = (torch.as_tensor(x[None], device=device) for x in (left, right))
    build.reset_launch_counts()
    kern = make_forward(model, num_stages=4, use_pallas=True,
                        device=device)(l, r)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts = build.launch_counts()
    plain = make_forward(model, num_stages=4, use_pallas=False,
                         device=device)(l, r)
    return ([o[0, :, :, 0].cpu().numpy() for o in kern],
            [o[0, :, :, 0].cpu().numpy() for o in plain], counts)


def check_fixture(path: str, cfg, device, sets=SETS) -> Dict:
    """Each stage of both paths against the JAX fixture at `path`, on each
    of its weight sets in `sets` with that set's input, at
    the fixed bars above."""
    fx = np.load(path)
    stride = int(fx["stride"])
    weights = torch.load(os.path.join(os.path.dirname(path), WEIGHTS),
                         map_location="cpu", weights_only=True)
    dtype = cfg.compute_dtype
    out = {}
    for name in sets:
        seed = int(fx[f"{name}_input_seed"])
        kern, plain, counts = run_paths(
            build_model(cfg, weights[WEIGHTS_OF[name]], device),
            *set_pair(name, seed), device)
        stages = []
        for s in range(4):
            ref = fx[f"{name}_stage{s + 1}"]
            k = delta_stats(ref, kern[s][::stride, ::stride])
            m = delta_stats(ref, plain[s][::stride, ::stride])
            span, guard = k["span"], SPAN_GUARD * bin_range_px(cfg, s + 1)
            km, mm = k["mean_abs_delta"], m["mean_abs_delta"]
            bar = mean_bar(dtype, name, s + 1)
            # None: not held on this set (UNRATIOED, GUARDED)
            bars = {
                "finite": k["finite"] and m["finite"],
                "mean": max(km, mm) < bar * span,
                "kernel_vs_module": None if (dtype, name) in UNRATIOED
                else km <= max(KERNEL_RATIO * mm,
                               KERNEL_FLOORS[dtype] * span),
                "span_guard": span > guard if name in GUARDED else None}
            stages.append({"stage": s + 1, "fixture_span": span,
                           "mean_bar_pct": 100.0 * bar,
                           "span_guard_px": guard, "kernels": k, "module": m,
                           "bars": bars,
                           "ok": all(v for v in bars.values()
                                     if v is not None)})
        out[name] = {"input_seed": seed, "launches": counts,
                     "stages": stages,
                     "pass": all(st["ok"] for st in stages)}
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, default="results/PARITY.json")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--left_img", type=str, default="")
    p.add_argument("--right_img", type=str, default="",
                   help="explicit stereo pair, used at its native size (no "
                        "crop); trained weights need an in-distribution "
                        "pair for a conditioned comparison")
    p.add_argument("--ckpt", type=str, default="",
                   help="a checkpoint directory of the port, or FILE:SET")
    p.add_argument("--rows_dw", type=str, default="mxu",
                   choices=["mxu", "vpu", "chain"])
    p.add_argument("--unpaired", action="store_true",
                   help='with --rows_dw vpu: one dw-sep layer a launch')
    p.add_argument("--pallas_mode", type=str, default="rows",
                   choices=["rows", "layers"])
    p.add_argument("--fixture", type=str, default="",
                   help=f"JAX fixture to hold both paths to, e.g. "
                        f"{FIXTURE}")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    cfg = ModelConfig(compute_dtype=args.dtype, rows_dw=args.rows_dw,
                      rows_paired=not args.unpaired,
                      pallas_mode=args.pallas_mode)
    result = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "compute_dtype": args.dtype,
        "pallas_mode": cfg.pallas_mode,
        "rows_dw": cfg.rows_dw,
        "rows_paired": cfg.rows_paired,
    }
    with tf32_off():  # float32 in full; bf16 convs do not use TF32
        _run(args, cfg, dev, result)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1, allow_nan=False)
    print(json.dumps(result, allow_nan=False))
    return result


def _run(args, cfg, dev, result: Dict) -> None:
    """`main`'s checks; fills `result`, its verdict under "pass"."""
    from lwsnet_tpu_torch.data import transforms as T

    bar = FIXTURE_BARS[args.dtype]  # the JAX tool's bars too
    if args.fixture:
        result["fixture"] = args.fixture
        wider = [f"{n} stage {st}: {b * 100:g}%"
                 for (d, n, st), b in STAGE_BARS.items() if d == args.dtype]
        unheld = [n for d, n in UNRATIOED if d == args.dtype]
        result["bars"] = (
            f"per stage at the fixture's pixels: each path's mean |delta| "
            f"< {bar * 100:g}% of the fixture's span"
            + (f" ({'; '.join(wider)})" if wider else "")
            + f"; kernel path mean |delta| <= max({KERNEL_RATIO} x the "
            f"module path's, {KERNEL_FLOORS[args.dtype] * 100:g}% of span)"
            + (f" (not on the {', '.join(unheld)} set)" if unheld else "")
            + "; "
            f"on the {', '.join(GUARDED)} sets the fixture span > "
            f"{SPAN_GUARD * 100:g}% of the stage's bin range")
        result["sets"] = check_fixture(args.fixture, cfg, dev)
        ok = all(s["pass"] for s in result["sets"].values())
    else:
        if args.left_img:
            left = T.normalize(T.load_image(args.left_img))
            right = T.normalize(T.load_image(args.right_img
                                             or args.left_img))
            result["input"] = f"{args.left_img} (native size)"
        else:
            left, right = fixture_pair(0)
            result["input"] = "fixture_pair(0), 368x1232"
        result["weights"] = args.ckpt or "random-init (seed 0)"
        kern, plain, counts = run_paths(
            build_model(cfg, load_weights(args.ckpt), dev),
            np.asarray(left, np.float32), np.asarray(right, np.float32),
            dev)
        stages, ok = [], True
        for s, (a, b) in enumerate(zip(plain, kern)):
            st = delta_stats(a, b)
            stage_ok = st["finite"] and st["mean_abs_delta"] < bar * st["span"]
            ok &= stage_ok
            stages.append({
                "stage": s + 1, "finite": st["finite"],
                "module_span": round(st["span"], 4),
                "max_abs_delta": round(st["max_abs_delta"], 4),
                "mean_abs_delta": round(st["mean_abs_delta"], 5),
                "mean_delta_pct_of_span": round(
                    st["mean_delta_pct_of_span"], 3),
                "ok": bool(stage_ok)})
        result["launches"] = counts
        result["bar"] = (f"mean |delta| < {bar * 100:g}% of the module "
                         f"path's span per stage")
        result["stages"] = stages
    result["pass"] = bool(ok)


if __name__ == "__main__":
    raise SystemExit(0 if main()["pass"] else 1)
